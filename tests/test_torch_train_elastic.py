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
* MoE on a grid whose model axis holds one rank and whose data axis holds
  more routes the global batch, as the reference does there: granite-moe
  at its own capacity factor (1.25, where tokens drop) takes two steps on
  ``(4, 1)``, ``(2, 1)``, ``(1, 4)``, ``(2, 2)`` and one rank, each held to
  the reference's ``Trainer`` on a mesh of that shape (a subprocess on 4
  forced host devices, as in ``test_torch_train_parallel.py``).

One ``spawn_world`` of 4 CPU ranks runs every grid case of four ranks (a
world of 2 the ``(2, 1)`` grid).  Tolerances: 1e-5 relative (loss, grad
norm, rel L2 a parameter; f32 sums in other orders); restored blocks
exactly.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.launch.mesh import make_grid_mesh, spawn_world
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ShapeConfig
from repro_torch.models.convert import params_from_jax
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


ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
GRIDS = [(4, 1), (2, 1), (1, 4), (2, 2), (1, 1)]
_REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import dataclasses, tempfile
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs import registry
    from repro.models.config import ShapeConfig
    from repro.optim.adamw import AdamWConfig
    from repro.train.loop import Trainer, TrainerConfig
    cfg = dataclasses.replace(registry.get_smoke_config("granite-moe-1b-a400m"),
                              dtype="float32")
    name = lambda path: "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                                 for k in path)
    tok = np.random.default_rng(1).integers(0, cfg.vocab, (4, 32)).astype(np.int32)
    batch = {"tokens": tok,
             "labels": np.concatenate([tok[:, 1:], np.full((4, 1), -1, np.int32)], 1)}
    out = {f"batch/{k}": v for k, v in batch.items()}
    for grid in %r:
        mesh = Mesh(np.array(jax.devices()[:grid[0] * grid[1]]).reshape(grid),
                    ("data", "model"))
        tr = Trainer(cfg, ShapeConfig("tiny", "train", seq_len=32, global_batch=4),
                     AdamWConfig(lr=1e-3, eps=1e-6, warmup_steps=1, total_steps=8),
                     TrainerConfig(steps=2, ckpt_every=0, ckpt_dir=tempfile.mkdtemp()),
                     mesh=mesh)
        key = f"{grid[0]}x{grid[1]}"
        if grid == (1, 1):
            for path, leaf in jax.tree_util.tree_flatten_with_path(tr.params)[0]:
                out["p0/" + name(path)] = np.asarray(leaf)
        for i in range(2):
            tr.params, tr.opt_state, m = tr._step_fn(
                tr.params, tr.opt_state, {k: jnp.asarray(v) for k, v in batch.items()})
            out[f"{key}/loss{i}"] = float(m["loss"])
            out[f"{key}/gnorm{i}"] = float(m["grad_norm"])
            if i == 0:
                for path, leaf in jax.tree_util.tree_flatten_with_path(tr.params)[0]:
                    out[f"{key}/p1/" + name(path)] = np.array(leaf)  # a copy: donated
    np.savez(sys.argv[1], **out)
""" % (GRIDS,))


# the MoE grids' optimizer: AdamW's eps at 1e-6, above the f32 rounding of
# lm_head's gradient elements near 0 (about 1e-9 absolute: sums of terms of
# about 1e-5 that cancel), which its division by sqrt(v) + eps otherwise
# lifts to a few 1e-5 of the update between two orders of the same sums
MOE_OPT = AdamWConfig(lr=1e-3, eps=1e-6, warmup_steps=1, total_steps=8)


def _moe_cfg():
    """granite-moe's smoke config at its own capacity factor: tokens drop."""
    return dataclasses.replace(registry.get_smoke_config("granite-moe-1b-a400m"),
                               dtype="float32")


def _moe_steps(grid, ref_path):
    """Two steps of granite-moe on ``grid`` from the reference's initial
    parameters: (losses, grad norms, every parameter whole after the first
    step, assignments dropped in the first step's forward, every layer's
    routing)."""
    with np.load(ref_path) as z:
        ref = {k: z[k] for k in z.files}
    cfg = _moe_cfg()
    mesh = (make_grid_mesh(grid, AXES, device="cpu") if grid != (1, 1)
            else tloop.one_rank_grid("cpu"))
    full = params_from_jax(tloop._nest({k[3:]: v for k, v in ref.items()
                                        if k.startswith("p0/")}), cfg, "cpu")
    specs = tloop.tree_specs(full, tloop.grid_specs(cfg, mesh))
    params = tloop.unflatten(full, [shd.local_block(t, s, mesh).clone()
                                    for t, s in zip(param_tensors(full), specs)])
    batch = tloop.local_rows({k: torch.from_numpy(ref[f"batch/{k}"]).long()
                              for k in ("tokens", "labels")}, mesh)
    dropped = []
    route = moe_mod.route

    def counting(*args, **kw):
        out = route(*args, **kw)
        dropped.append(int((~out[3]).sum()))
        return out
    step = tloop.make_train_step(cfg, MOE_OPT, mesh)
    state = init_state(params, MOE_OPT)
    losses, norms = [], []
    for i in range(2):
        moe_mod.route = counting if i == 0 else route
        try:
            params, state, m = step(params, state, batch)
        finally:
            moe_mod.route = route
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if i == 0:
            after = [shd.gather_full(t, s, mesh).clone()     # the step writes in place
                     for t, s in zip(param_tensors(params), specs)]
    return losses, norms, after, sum(dropped[:cfg.num_layers])


def _moe_world(world_mesh, grids, ref_path):
    return {g: _moe_steps(g, ref_path) for g in grids}


@pytest.fixture(scope="module")
def moe_grids(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("moe_grids") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _REF, path], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as z:
        ref = {k: z[k] for k in z.files}
    four = [g for g in GRIDS if g[0] * g[1] == 4]
    got = {g: [r[g] for r in spawn_world(_moe_world, 4, device="cpu", timeout_s=300,
                                         args=(four, path))] for g in four}
    got[(2, 1)] = [r[(2, 1)] for r in spawn_world(_moe_world, 2, device="cpu",
                                                  timeout_s=300, args=([(2, 1)], path))]
    got[(1, 1)] = [_moe_steps((1, 1), path)]
    return ref, got


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_moe_on_a_grid_of_one_model_rank_matches_the_reference(grid, moe_grids):
    """Every grid runs, and each rank's two steps equal the reference's on
    a mesh of the same shape: the losses and grad norms of both, the
    parameters after the first (``MOE_OPT``).  Where the model axis holds one rank, the
    data ranks route the global batch: assignments drop (the ranks' counts
    add up to the one rank's), and the steps still match."""
    ref, got = moe_grids
    cfg = _moe_cfg()
    key = f"{grid[0]}x{grid[1]}"
    want = param_tensors(params_from_jax(tloop._nest(
        {k[len(key) + 4:]: v for k, v in ref.items() if k.startswith(f"{key}/p1/")}),
        cfg, "cpu"))
    for losses, norms, params, _ in got[grid]:
        for i in range(2):
            assert abs(losses[i] - ref[f"{key}/loss{i}"]) <= 1e-5 * abs(ref[f"{key}/loss{i}"])
            assert abs(norms[i] - ref[f"{key}/gnorm{i}"]) <= 1e-5 * abs(ref[f"{key}/gnorm{i}"])
        for a, b in zip(params, want):
            assert _rel(a, torch.from_numpy(np.asarray(b))) < 1e-5
    if grid[1] == 1:
        drops = [r[3] for r in got[grid]]
        assert sum(drops) == got[(1, 1)][0][3] > 0, drops
