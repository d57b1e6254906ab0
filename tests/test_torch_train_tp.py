"""Training in the reference's tensor-parallel layout, and the
``save_block_out`` remat policy, against the reference's sharded step on
the CPU.

The reference runs once, in a subprocess on 4 forced host devices (as in
``test_torch_train_parallel.py``): its ``Trainer`` takes two steps of its
jitted step on one fixed batch of 4 x 32 tokens, in f32, for

* ``yi-2x2``: Yi-6B's smoke config (8 query heads, 2 KV heads) on a
  ``(data 2, model 2)`` mesh: heads, FFN hidden dim and vocab over
  ``model``, each layer's weights gathered over ``data``;
* ``granite-2x2-sbo``: granite-moe's smoke config on ``(2, 2)`` at its own
  capacity factor (1.25) under ``remat_policy="save_block_out"``;
* ``yi-1-sbo``: Yi-6B's smoke config on one device under
  ``save_block_out``.

The port runs the grid cases in one ``spawn_world`` of 4 CPU ranks
(``make_train_step(cfg, opt_cfg, mesh)`` on the reference's initial
parameters cut into each rank's blocks) and the one-device case here.
Tolerances as ``test_torch_train_parallel.py``'s: losses, grad norms and
every parameter after the steps within 1e-5 relative.

Also here: the grid step's memory.  ``PeakTracker`` on a fake ``(2, 2)``
grid sees at most one layer's dense weights gathered at the peak of a
step (each layer gathers them inside its checkpoint), where gathering
them for the whole step held every layer's.
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
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_grid_mesh, spawn_world
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import init_params, param_tensors
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.parallel import sharding as shd
from repro_torch.train import loop as tloop

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CASES = {"yi-2x2": ("yi-6b", (2, 2), "full"),
         "granite-2x2-sbo": ("granite-moe-1b-a400m", (2, 2), "save_block_out"),
         "yi-1-sbo": ("yi-6b", None, "save_block_out")}

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
    name = lambda path: "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                                 for k in path)
    out = {}
    for key, (arch, grid, policy) in %r.items():
        cfg = dataclasses.replace(registry.get_smoke_config(arch), dtype="float32",
                                  remat_policy=policy)
        mesh = None if grid is None else Mesh(
            np.array(jax.devices()[:grid[0] * grid[1]]).reshape(grid), ("data", "model"))
        tr = Trainer(cfg, ShapeConfig("tiny", "train", seq_len=32, global_batch=4),
                     AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4),
                     TrainerConfig(steps=2, ckpt_every=0, ckpt_dir=tempfile.mkdtemp()),
                     mesh=mesh)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tr.params)[0]:
            out[f"{key}/p0/" + name(path)] = np.asarray(leaf)
        tok = np.random.default_rng(1).integers(0, cfg.vocab, (4, 32)).astype(np.int32)
        batch = {"tokens": tok,
                 "labels": np.concatenate([tok[:, 1:], np.full((4, 1), -1, np.int32)], 1)}
        out.update({f"{key}/batch/{k}": v for k, v in batch.items()})
        for i in range(2):
            tr.params, tr.opt_state, m = tr._step_fn(
                tr.params, tr.opt_state, {k: jnp.asarray(v) for k, v in batch.items()})
            out[f"{key}/loss{i}"] = float(m["loss"])
            out[f"{key}/gnorm{i}"] = float(m["grad_norm"])
        for path, leaf in jax.tree_util.tree_flatten_with_path(tr.params)[0]:
            out[f"{key}/p2/" + name(path)] = np.asarray(leaf)
    np.savez(sys.argv[1], **out)
""" % (CASES,))
OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)


def _cfg(key):
    arch, _, policy = CASES[key]
    return dataclasses.replace(registry.get_smoke_config(arch), dtype="float32",
                               remat_policy=policy)


def _tree(ref, prefix, cfg):
    flat = {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}
    return params_from_jax(tloop._nest(flat), cfg, "cpu")


def _steps(key, ref, mesh):
    """Two steps of the port from the reference's initial parameters:
    (losses, grad norms, every parameter gathered whole)."""
    cfg = _cfg(key)
    full = _tree(ref, f"{key}/p0/", cfg)
    specs = tloop.tree_specs(full, tloop.grid_specs(cfg, mesh))
    params = tloop.unflatten(full, [shd.local_block(t, s, mesh).clone()
                                    for t, s in zip(param_tensors(full), specs)])
    batch = {k: torch.from_numpy(ref[f"{key}/batch/{k}"]).long() for k in ("tokens", "labels")}
    step = tloop.make_train_step(cfg, OPT, mesh)
    state = init_state(params, OPT)
    losses, norms = [], []
    for _ in range(2):
        params, state, m = step(params, state, tloop.local_rows(batch, mesh))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, [shd.gather_full(t, s, mesh)
                           for t, s in zip(param_tensors(params), specs)]


def _rank(world_mesh, ref_path):
    with np.load(ref_path) as z:
        ref = {k: z[k] for k in z.files}
    out = {}
    for key, (_, grid, _) in CASES.items():
        if grid is not None:
            out[key] = _steps(key, ref, make_grid_mesh(grid, ("data", "model"), device="cpu"))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("train_tp") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _REF, path], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as z:
        ref = {k: z[k] for k in z.files}
    ranks = spawn_world(_rank, 4, device="cpu", timeout_s=300, args=(path,))
    one = {key: _steps(key, ref, tloop.one_rank_grid("cpu"))
           for key, (_, grid, _) in CASES.items() if grid is None}
    return ref, ranks, one


def _rel(a, b) -> float:
    a = np.asarray(a.detach() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("key", list(CASES))
def test_step_matches_the_reference_step(key, runs):
    """Two steps: loss and grad norm each step, every parameter after."""
    ref, ranks, one = runs
    cfg = _cfg(key)
    want = param_tensors(_tree(ref, f"{key}/p2/", cfg))
    names = [n for n, _ in shd.flat_names(_tree(ref, f"{key}/p0/", cfg))]
    got_all = [r[key] for r in ranks] if key not in one else [one[key]]
    for losses, norms, params in got_all:
        for i in range(2):
            assert abs(losses[i] - ref[f"{key}/loss{i}"]) <= 1e-5 * abs(ref[f"{key}/loss{i}"])
            assert abs(norms[i] - ref[f"{key}/gnorm{i}"]) <= 1e-5 * abs(ref[f"{key}/gnorm{i}"])
        for name, got, w in zip(names, params, want):
            assert _rel(got, w) < 1e-5, (key, name, _rel(got, w))
        assert losses[1] < losses[0]


def _peak_cfg():
    """Yi-6B's smoke config widened, deep and fed a tiny batch, so that the
    weights outweigh every activation."""
    return dataclasses.replace(registry.get_smoke_config("yi-6b"), dtype="float32",
                               d_model=256, d_ff=512, num_layers=8, vocab=256)


def _layer_bytes(cfg) -> int:
    full = init_params(cfg, torch.Generator(), "meta")
    return sum(t.numel() * t.element_size() for t in param_tensors(full["layers"][0]))


def test_peak_holds_one_layer_of_gathered_weights():
    """At the peak of a train step on the fake (2, 2) grid, the gathers'
    outputs (``cat``, the all-gather's concatenation) hold no more than one
    layer's dense weights whole; the step's temporaries are less than two
    layers' weights above those of a step with half the layers."""
    cfg = _peak_cfg()
    res = {n: dr.run_lm_cell("yi-6b", "train_4k", False, grid=(2, 2), batch=4, seq_len=8,
                             cfg=dataclasses.replace(cfg, num_layers=n))
           for n in (4, 8)}
    layer = _layer_bytes(cfg)
    for n, r in res.items():
        at_peak = r["memory_analysis"]["temp_at_peak_by_op"]
        assert at_peak.get("cat", 0) <= layer, (n, at_peak, layer)
    grow = res[8]["memory_analysis"]["temp_bytes"] - res[4]["memory_analysis"]["temp_bytes"]
    assert grow < 2 * layer, (grow, layer)
