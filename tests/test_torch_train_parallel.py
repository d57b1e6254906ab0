"""The port's training on a grid of ranks against the reference's sharded
``Trainer``, on the CPU.

The reference runs once, in a subprocess on 4 forced host devices as a
``Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))`` (Auto
axes; see ``test_torch_moe_parallel.py``): its ``Trainer(mesh=)`` on
granite-moe's smoke config in f32, at the config's own capacity factor
(1.25: the MoE layer drops per shard), takes two steps of its jitted
sharded step on one fixed batch of 4 x 32 tokens.  It reports each step's
loss and grad norm, every parameter before and after, each device's shard
of four leaves, and ``refresh_expert_placement``'s counts and expert
permutation after the steps.

The port runs once, in a ``spawn_world`` of 4 CPU ranks as a ``(2, 2)``
grid: the reference's parameters (``convert.params_from_jax``) cut into
each rank's blocks, the same batch, two steps of ``make_train_step(cfg,
opt_cfg, mesh)``, then a ``Trainer(mesh=)`` holding the reference's
trained parameters refreshes the expert placement.

A reference checkpoint (the reference ``Trainer``'s ``save`` of its
initial parameters) is also restored onto the grid by
``Trainer.restore_reference``.

Tolerances: the losses, grad norms and parameters within 1e-5 relative
(rel L2 a leaf; the same f32 arithmetic with sums in other orders, and
routing decided the same way on continuous random weights); the blocks,
the counts and the permutation exactly.
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

from repro_torch.analysis.schedule import verify_schedules
from repro_torch.configs import registry
from repro_torch.launch.mesh import make_grid_mesh, spawn_world
from repro_torch.models.config import ShapeConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import param_tensors
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.parallel import sharding as shd
from repro_torch.train import loop as tloop

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SHARDED = ("embed", "groups/0/0/attn/w_q", "groups/0/0/moe/experts_gate",
           "groups/0/0/attn/w_o")

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
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    shape = ShapeConfig("tiny", "train", seq_len=32, global_batch=4)
    tr = Trainer(cfg, shape, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4),
                 TrainerConfig(steps=2, ckpt_every=0, ckpt_dir=sys.argv[2]),
                 mesh=mesh)
    tr.save(0)
    tr.ckpt.wait()
    name = lambda path: "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                                 for k in path)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tr.params)[0]:
        out["p0/" + name(path)] = np.asarray(leaf)
        if name(path) in %r:
            for sh in leaf.addressable_shards:
                out[f"shard/{name(path)}/{sh.device.id}"] = np.asarray(
                    [[s.start or 0, leaf.shape[d] if s.stop is None else s.stop]
                     for d, s in enumerate(sh.index)])
    tok = np.random.default_rng(1).integers(0, cfg.vocab, (4, 32)).astype(np.int32)
    batch = {"tokens": tok,
             "labels": np.concatenate([tok[:, 1:], np.full((4, 1), -1, np.int32)], 1)}
    out.update({f"batch/{k}": v for k, v in batch.items()})
    for i in range(2):
        tr.params, tr.opt_state, m = tr._step_fn(
            tr.params, tr.opt_state, {k: jnp.asarray(v) for k, v in batch.items()})
        out[f"loss{i}"], out[f"gnorm{i}"] = float(m["loss"]), float(m["grad_norm"])
    for path, leaf in jax.tree_util.tree_flatten_with_path(tr.params)[0]:
        out["p2/" + name(path)] = np.asarray(leaf)
    counts = tr.refresh_expert_placement({k: jnp.asarray(v) for k, v in batch.items()})
    out["counts"], out["assignment"] = np.asarray(counts), np.asarray(tr.expert_assignment)
    np.savez(sys.argv[1], **out)
""" % (SHARDED,))

OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
SHAPE = ShapeConfig("tiny", "train", seq_len=32, global_batch=4)


def _cfg():
    return dataclasses.replace(registry.get_smoke_config("granite-moe-1b-a400m"),
                               dtype="float32")


def _tree(ref, prefix, cfg):
    """The port's parameters from the reference's arrays under ``prefix``."""
    flat = {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}
    return params_from_jax(tloop._nest(flat), cfg, "cpu")


def _rank(world_mesh, ref_path, ref_ckpt):
    mesh = make_grid_mesh((2, 2), ("data", "model"), device="cpu")
    with np.load(ref_path) as z:
        ref = {k: z[k] for k in z.files}
    cfg = _cfg()
    full = _tree(ref, "p0/", cfg)
    specs = tloop.tree_specs(full, tloop.grid_specs(cfg, mesh))
    blocks = tloop.unflatten(full, [shd.local_block(t, s, mesh).clone()
                                    for t, s in zip(param_tensors(full), specs)])
    res = {"coords": mesh.coords, "rank": mesh.rank,
           "blocks": {n: b.clone() for (n, _), b in zip(shd.flat_names(full),
                                                         param_tensors(blocks))
                      if n in ("embed", "layers/0/attn/w_q", "layers/0/moe/experts_gate",
                               "layers/0/attn/w_o")}}
    batch = {k: torch.from_numpy(ref[f"batch/{k}"]).long() for k in ("tokens", "labels")}
    step = tloop.make_train_step(cfg, OPT, mesh)
    state = init_state(blocks, OPT)
    for i in range(2):
        blocks, state, m = step(blocks, state, tloop.local_rows(batch, mesh))
        res[f"loss{i}"], res[f"gnorm{i}"] = float(m["loss"]), float(m["grad_norm"])
    res["p2"] = [shd.gather_full(t, s, mesh) for t, s in zip(param_tensors(blocks), specs)]
    res["log"] = list(mesh.log.events)
    # the expert placement of the reference's trained parameters
    tr = tloop.Trainer(cfg, SHAPE, OPT, tloop.TrainerConfig(
        steps=2, ckpt_every=0, ckpt_dir=tempfile.mkdtemp()), mesh=mesh)
    trained = dict(shd.flat_names(_tree(ref, "p2/", cfg)))
    for (n, t), s in zip(shd.flat_names(tr.params), tr.specs):
        t.copy_(shd.local_block(trained[n], s, mesh))
    res["counts"] = tr.refresh_expert_placement(tloop.local_rows(batch, mesh))
    res["assignment"] = tr.expert_assignment
    # the reference's own checkpoint of its initial parameters, onto the grid
    tr = tloop.Trainer(cfg, SHAPE, OPT, tloop.TrainerConfig(
        steps=2, ckpt_every=0, ckpt_dir=tempfile.mkdtemp()), mesh=mesh)
    res["restored_reference"] = tr.restore_reference(ref_ckpt)
    res["reference_blocks"] = {n: t.clone() for n, t in shd.flat_names(tr.params)}
    return res


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_parallel")
    path, ckpt = str(tmp / "ref.npz"), str(tmp / "ref_ckpt")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _REF, path, ckpt], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as z:
        ref = {k: z[k] for k in z.files}
    return ref, spawn_world(_rank, 4, device="cpu", timeout_s=300, args=(path, ckpt))


def _rel(a, b) -> float:
    a = np.asarray(a.detach() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_sharded_step_matches_the_reference_sharded_step(worlds):
    """Two steps: loss and grad norm each step, every parameter after."""
    ref, ranks = worlds
    want = param_tensors(_tree(ref, "p2/", _cfg()))
    names = [n for n, _ in shd.flat_names(_tree(ref, "p0/", _cfg()))]
    for r in ranks:
        for i in range(2):
            assert abs(r[f"loss{i}"] - ref[f"loss{i}"]) <= 1e-5 * abs(ref[f"loss{i}"])
            assert abs(r[f"gnorm{i}"] - ref[f"gnorm{i}"]) <= 1e-5 * abs(ref[f"gnorm{i}"])
        for name, got, w in zip(names, r["p2"], want):
            assert _rel(got, w) < 1e-5, (r["rank"], name, _rel(got, w))
    assert ranks[0]["loss1"] < ranks[0]["loss0"]


def test_rank_blocks_equal_the_reference_device_shards(worlds):
    """Rank ``r``'s block of each leaf is the reference's device-``r``
    shard (layer 0 of the stacked group: its layer dim is whole)."""
    ref, ranks = worlds
    port = {"embed": "embed", "groups/0/0/attn/w_q": "layers/0/attn/w_q",
            "groups/0/0/moe/experts_gate": "layers/0/moe/experts_gate",
            "groups/0/0/attn/w_o": "layers/0/attn/w_o"}
    for r in ranks:
        for rname, pname in port.items():
            idx = ref[f"shard/{rname}/{r['rank']}"]
            full = ref["p0/" + rname]
            if rname.startswith("groups"):
                full, idx = full[0], idx[1:]
            want = full[tuple(slice(a, b) for a, b in idx)]
            assert np.array_equal(r["blocks"][pname].numpy(), want), (pname, r["rank"])


def test_refresh_expert_placement_equals_the_reference(worlds):
    """Counts over the global batch and the cost-model permutation on the
    model axis of 2."""
    ref, ranks = worlds
    for r in ranks:
        assert np.array_equal(r["counts"], ref["counts"])
        assert np.array_equal(r["assignment"], ref["assignment"])


def test_sharded_step_schedules_verify(worlds):
    _, ranks = worlds
    rep = verify_schedules([r["log"] for r in ranks], label="train step")
    assert rep.ok, rep.diff_text()


def test_reference_checkpoint_restores_onto_the_grid(worlds):
    """``restore_reference`` on a grid: the reference ``Trainer``'s own
    checkpoint (its sharded initial parameters, written whole) lands as
    each rank's blocks of them, matched by name (the converted tree orders
    its leaves otherwise than ``init_params``)."""
    ref, ranks = worlds
    want = dict(shd.flat_names(_tree(ref, "p0/", _cfg())))
    mesh = shd.AbstractGrid((2, 2), ("data", "model"))
    for r in ranks:
        assert r["restored_reference"]
        for name, block in r["reference_blocks"].items():
            full = want[name]
            spec = shd.param_spec(mesh, name, full.shape)
            for d, entry in enumerate(spec):
                axes = shd.spec_axes(entry)
                if axes:
                    size = full.shape[d] // shd.axis_size(mesh, axes)
                    idx = r["coords"][0] if axes == ("data",) else r["coords"][1]
                    full = full.narrow(d, idx * size, size)
            assert torch.equal(block, full), name
