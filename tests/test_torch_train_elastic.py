"""The port's grid step against its own one-rank step, and the elastic
restore, on the CPU (no jax).

* A step of ``make_train_step(cfg, opt_cfg, mesh)`` on a ``(2, 2)`` and a
  ``(1, 4)`` grid equals the one-rank step on the same weights and batch,
  for yi-6b's and granite-moe's smoke configs in f32.  Capacity factor
  ``E / k`` makes every shard's capacity cover all its assignments, so no
  MoE drop depends on how the batch is split.
* The counterpart of ``tests/test_train.py``'s elastic restore: a one-rank
  checkpoint restores onto ``(2, 2)``, each rank holding its blocks of the
  saved arrays; a ``(2, 2)`` checkpoint restores onto ``(1, 4)`` and onto
  one rank, and each continues to the uninterrupted ``(2, 2)`` run's
  parameters.
* A leaf's copies agree bit for bit: every rank that holds the same block
  of a leaf (a leaf replicated over the model axis, or not split over the
  data axis) holds the same bytes after the grid's steps, parameters and
  AdamW moments alike.  The step takes it so (``dense_grad_block``) and
  nothing averages the copies.
* A grid whose model axis holds one rank and whose data axis holds more
  is refused for an MoE config (there the reference routes the global
  batch; the port would route each data rank's rows).

One ``spawn_world`` of 4 CPU ranks runs every grid case.  Tolerances: 1e-5
relative (loss, grad norm, rel L2 a parameter; f32 sums in other orders);
restored blocks exactly.
"""
import dataclasses
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.launch.mesh import make_grid_mesh, spawn_world
from repro_torch.models.config import ShapeConfig
from repro_torch.models.transformer import init_params, param_tensors
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.parallel import sharding as shd
from repro_torch.train import loop as tloop
from repro_torch.train.loop import Trainer, TrainerConfig

OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=8)
SHAPE = ShapeConfig("tiny", "train", seq_len=32, global_batch=4)
CASES = [(a, g) for a in ("yi-6b", "granite-moe-1b-a400m") for g in ((2, 2), (1, 4))]
AXES = ("data", "model")


def _cfg(arch):
    cfg = dataclasses.replace(registry.get_smoke_config(arch), dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    return cfg


def _batch(cfg):
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab, (4, 32), generator=g)
    return {"tokens": tok, "labels": torch.cat([tok[:, 1:], torch.full((4, 1), -1)], 1)}


def _params(cfg):
    return init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _tcfg(directory, steps, every):
    return TrainerConfig(steps=steps, ckpt_every=every, ckpt_dir=directory, seed=3)


def _gathered(tr):
    return [shd.gather_full(t, s, tr.mesh) for t, s in zip(param_tensors(tr.params),
                                                           tr.specs)]


def _copies(tree, specs, mesh) -> dict:
    """Each leaf's block on this rank, keyed by the block it is (its index
    on the axes of each dim)."""
    return {name: (tuple(mesh.axis_index(shd.spec_axes(e)) for e in spec), t.clone())
            for (name, t), spec in zip(shd.flat_names(tree), specs)}


def _rank(world_mesh, one_rank_dir, grid_dir):
    out = {}
    for arch, grid in CASES:
        cfg = _cfg(arch)
        mesh = make_grid_mesh(grid, AXES, device="cpu")
        full = _params(cfg)
        specs = tloop.tree_specs(full, tloop.grid_specs(cfg, mesh))
        blocks = tloop.unflatten(full, [shd.local_block(t, s, mesh).clone()
                                        for t, s in zip(param_tensors(full), specs)])
        step = tloop.make_train_step(cfg, OPT, mesh, q_chunk=16, loss_chunk=16)
        blocks, _, m = step(blocks, init_state(blocks, OPT),
                            tloop.local_rows(_batch(cfg), mesh))
        out[arch, grid] = (float(m["loss"]), float(m["grad_norm"]),
                           [shd.gather_full(t, s, mesh)
                            for t, s in zip(param_tensors(blocks), specs)])
        out["copies", arch, grid] = _copies(blocks, specs, mesh)
    cfg = _cfg("granite-moe-1b-a400m")
    g22 = make_grid_mesh((2, 2), AXES, device="cpu")
    # a one-rank checkpoint onto (2, 2)
    tr = Trainer(cfg, SHAPE, OPT, _tcfg(one_rank_dir, 8, 0), mesh=g22)
    out["restored"] = tr.try_restore()
    out["blocks"] = {n: t.clone() for n, t in shd.flat_names(tr.params)}
    out["mu"] = {n: t.clone() for n, t in shd.flat_names(tr.opt_state["mu"])}
    out["step"], out["pipeline"] = int(tr.opt_state["step"]), tr.pipeline.step
    out["coords"] = g22.coords
    # (2, 2) to step 2 with a checkpoint, then on to step 4 uninterrupted
    tr = Trainer(cfg, SHAPE, OPT, _tcfg(grid_dir, 2, 2), mesh=g22)
    tr.run(2)
    tr.tcfg = dataclasses.replace(tr.tcfg, ckpt_every=0)
    out["losses"] = [m["loss"] for m in tr.run(4)]
    out["uninterrupted"] = _gathered(tr)
    out["copies", "trainer"] = {
        f"{tree}/{k}": v for tree, t in (("params", tr.params), ("mu", tr.opt_state["mu"]),
                                         ("nu", tr.opt_state["nu"]))
        for k, v in _copies(t, tr.specs, g22).items()}
    # the (2, 2) checkpoint onto (1, 4), on to step 4
    g14 = make_grid_mesh((1, 4), AXES, device="cpu")
    tr = Trainer(cfg, SHAPE, OPT, _tcfg(grid_dir, 4, 0), mesh=g14)
    out["restored14"] = tr.try_restore()
    tr.run(4)
    out["resumed14"] = _gathered(tr)
    return out


@pytest.fixture(scope="module")
def world():
    one_rank_dir, grid_dir = tempfile.mkdtemp(), tempfile.mkdtemp()
    cfg = _cfg("granite-moe-1b-a400m")
    tr = Trainer(cfg, SHAPE, OPT, _tcfg(one_rank_dir, 2, 2), device="cpu")
    tr.run(2)
    ranks = spawn_world(_rank, 4, device="cpu", timeout_s=300,
                        args=(one_rank_dir, grid_dir))
    return tr, ranks, grid_dir


def _rel(a, b) -> float:
    a, b = (np.asarray(t.detach(), np.float64) for t in (a, b))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("arch,grid", CASES, ids=[f"{a}-{g[0]}x{g[1]}" for a, g in CASES])
def test_grid_step_equals_the_one_rank_step(arch, grid, world):
    _, ranks, _ = world
    cfg = _cfg(arch)
    params = _params(cfg)
    step = tloop.make_train_step(cfg, OPT, q_chunk=16, loss_chunk=16)
    params, _, m = step(params, init_state(params, OPT), _batch(cfg))
    want = param_tensors(params)
    for r in ranks:
        loss, gnorm, got = r[arch, grid]
        assert abs(loss - float(m["loss"])) <= 1e-5 * float(m["loss"])
        assert abs(gnorm - float(m["grad_norm"])) <= 1e-5 * float(m["grad_norm"])
        for a, b in zip(got, want):
            assert _rel(a, b) < 1e-5


def _block(full, name, coords):
    """Rank ``coords``' block of ``full`` on a (2, 2) grid."""
    mesh = shd.AbstractGrid((2, 2), AXES)
    out = full
    for dim, entry in enumerate(shd.param_spec(mesh, name, full.shape)):
        axes = shd.spec_axes(entry)
        if axes:
            size = out.shape[dim] // shd.axis_size(mesh, axes)
            idx = coords[0] if axes == ("data",) else coords[1]
            out = out.narrow(dim, idx * size, size)
    return out


def test_one_rank_checkpoint_restores_onto_the_grid_as_blocks(world):
    """Parameters and AdamW moments: each rank's blocks of the saved arrays."""
    tr, ranks, _ = world
    saved = dict(shd.flat_names(tr.params))
    saved_mu = dict(shd.flat_names(tr.opt_state["mu"]))
    for r in ranks:
        assert r["restored"] and r["step"] == 2 and r["pipeline"] == 2
        for name, block in r["blocks"].items():
            assert torch.equal(block, _block(saved[name], name, r["coords"])), name
            assert torch.equal(r["mu"][name], _block(saved_mu[name], name, r["coords"]))


def test_grid_checkpoint_restores_elsewhere_and_continues(world):
    """Onto (1, 4) in the ranks and onto one rank here; both continue to
    step 4 at the uninterrupted (2, 2) run's parameters."""
    _, ranks, grid_dir = world
    cfg = _cfg("granite-moe-1b-a400m")
    want = ranks[0]["uninterrupted"]
    assert ranks[0]["losses"][-1] < ranks[0]["losses"][0]
    for r in ranks:
        assert r["restored14"]
        for a, b in zip(r["resumed14"], want):
            assert _rel(a, b) < 1e-5
    one = Trainer(cfg, SHAPE, OPT, _tcfg(grid_dir, 4, 0), device="cpu")
    assert one.try_restore() and int(one.opt_state["step"]) == 2
    one.run(4)
    for a, b in zip(param_tensors(one.params), want):
        assert _rel(a, b) < 1e-5


def _assert_copies_agree(ranks, key):
    held = {}
    for r in ranks:
        for name, (block, t) in r[key].items():
            held.setdefault((name, block), []).append((r["coords"], t))
    shared = [k for k, v in held.items() if len(v) > 1]
    assert shared                                   # norms at least are copies
    for k in shared:
        (c0, t0), *rest = held[k]
        for c, t in rest:
            assert torch.equal(t, t0), (k, c0, c)


@pytest.mark.parametrize("case", [("copies",) + c for c in CASES] + [("copies", "trainer")],
                         ids=[f"{a}-{g[0]}x{g[1]}" for a, g in CASES] + ["trainer-4-steps"])
def test_copies_of_a_leaf_agree_bit_for_bit(case, world):
    _, ranks, _ = world
    _assert_copies_agree(ranks, case)


@pytest.mark.parametrize("grid", [(4, 1), (2, 1), (1, 4), (2, 2), (1, 1)],
                         ids=lambda g: f"{g[0]}x{g[1]}")
def test_moe_on_a_grid_of_one_model_rank_is_refused(grid):
    cfg = _cfg("granite-moe-1b-a400m")
    mesh = shd.AbstractGrid(grid, AXES)
    if grid[1] == 1 and grid[0] > 1:
        with pytest.raises(NotImplementedError, match="global batch"):
            tloop.make_train_step(cfg, OPT, mesh)
    else:
        tloop.make_train_step(cfg, OPT, mesh)
    tloop.make_train_step(_cfg("yi-6b"), OPT, mesh)     # no experts: any grid
