"""The production dry run (``launch/dryrun.py``) against the reference's, on
the CPU: jax runs in-process on an ``AbstractMesh`` (no devices) where only
shardings are read, and on one device where a smoke cell is lowered.

* ``input_specs``, the cell list with its skips and ``train_memory_plan``
  equal the reference's for all 40 cells.
* One rank's argument bytes, from the specs alone (no step traced), equal
  the sum over leaves of the reference's ``NamedSharding(mesh, spec).
  shard_shape(shape)`` bytes on ``(16, 16)`` and ``(2, 16, 16)`` for every
  architecture: optimizer state, batch and caches byte for byte, the
  parameters element for element (the reference keeps f32 master weights,
  the port each leaf in the dtype its forward reads).  The exceptions are
  named: a decode cell's ``pos`` is a host int in the port (4 bytes less),
  and the hybrid's two single-layer groups, whose leaves the reference's
  ``param_spec`` reads one dim off (ROADMAP Queue 3, kept divergence):
  there the reference's bytes are those of the same leaf stacked, and its
  own differ.
* The traced FLOPs of a smoke prefill cell lie within 5% of the reference's
  ``analyze_hlo`` of the same cell lowered on one device, those of a smoke
  train cell within 10%.
* The fake ``(2, 2)`` trace of a smoke granite-moe train step logs rank 0's
  events of a real 4-rank gloo run of the same step: kind, shape, dtype,
  axes, group, in order.
* The FMM cell runs on a fake world of 8 ranks.
* ``PeakTracker``'s peak on a hand-worked sequence, the same on real and
  fake tensors.
"""
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import registry
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_grid_mesh, spawn_world
from repro_torch.launch.trace_analysis import PeakTracker
from repro_torch.models import transformer as tt
from repro_torch.models.config import SHAPES
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.parallel import sharding as shd
from repro_torch.serve import grid as sg
from repro_torch.train import loop as tloop

ARCHS = registry.lm_archs()
GRIDS = {"16x16": ((16, 16), ("data", "model")),
         "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def jdr():
    """The reference's dry run.  Its import sets ``XLA_FLAGS`` to 512 host
    devices for the process; the value is put back before jax starts a
    backend, so that nothing else in this process sees it."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun


def _dtype_name(d) -> str:
    return str(np.dtype(d)) if not isinstance(d, torch.dtype) else str(d).removeprefix("torch.")


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cells_specs_and_plans_equal_the_reference(arch, shape, jdr):
    from repro.configs import registry as jreg
    from repro.models import config as jconfig
    assert list(jreg.lm_archs()) == list(ARCHS) and list(jconfig.SHAPES) == list(SHAPES)
    cfg, jcfg = registry.get_config(arch), jreg.get_config(arch)
    s, js = SHAPES[shape], jconfig.SHAPES[shape]
    assert dr.shape_applicable(cfg, s) == jconfig.shape_applicable(jcfg, js)
    want = {k: (tuple(v.shape), _dtype_name(v.dtype)) for k, v in jdr.input_specs(jcfg, js).items()}
    got = {k: (tuple(sh), _dtype_name(d)) for k, (sh, d) in dr.input_specs(cfg, s).items()}
    assert got == want
    plan, jplan = dr.train_memory_plan(cfg), jdr.train_memory_plan(jcfg)
    assert plan["num_microbatches"] == jplan["num_microbatches"]
    assert _dtype_name(plan["state_dtype"]) == _dtype_name(jplan["state_dtype"])


def _shard_elems(sharding, shape) -> int:
    return int(np.prod(sharding.shard_shape(tuple(shape)), dtype=np.int64))


def _stacked_elems(mesh, name, shape, jshd) -> int:
    """The reference's shard of a leaf of a one-repeat group, read as the
    same leaf stacked (the spec its own ``param_spec`` gives a stacked
    layer)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    spec = jshd.param_spec(mesh, name, (1,) + tuple(shape))
    return _shard_elems(NamedSharding(mesh, P(*tuple(spec)[1:])), shape)


@functools.lru_cache(maxsize=None)
def _reference_leaves(arch: str) -> tuple:
    """(name, shape) of every leaf of the reference's full parameters."""
    import jax
    from repro.configs import registry as jreg
    from repro.models.transformer import init_params
    params = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), jreg.get_config(arch)))
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return tuple(("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path),
                  tuple(leaf.shape)) for path, leaf in flat)


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_the_reference_shards(arch, grid, jdr):
    import jax
    from jax.sharding import AbstractMesh, NamedSharding
    from repro.configs import registry as jreg
    from repro.models import config as jconfig
    from repro.models.transformer import _scan_groups, layer_kinds
    from repro.parallel import sharding as jshd
    dims, axes = GRIDS[grid]
    mesh = AbstractMesh(dims, axes)
    probe = shd.AbstractGrid(dims, axes)
    cfg, jcfg = registry.get_config(arch), jreg.get_config(arch)
    # the reference's parameters (its dry run's abstract_params): elements a
    # rank, and the named leaves
    singles = {f"groups/{gi}" for gi, (_, reps) in enumerate(_scan_groups(layer_kinds(jcfg)))
               if reps == 1}
    elems = own = 0
    diverged = []
    for name, shape in _reference_leaves(arch):
        leaf = jax.ShapeDtypeStruct(shape, np.float32)
        mine = _shard_elems(NamedSharding(mesh, jshd.param_spec(mesh, name, leaf.shape)),
                            leaf.shape)
        own += mine
        if any(name.startswith(g + "/") for g in singles) and len(leaf.shape) >= 2:
            fixed = _stacked_elems(mesh, name, leaf.shape, jshd)
            if fixed != mine:
                diverged.append(name)
            mine = fixed
        elems += mine
    if cfg.family == "hybrid":
        assert diverged and all(n.startswith(tuple(g + "/" for g in singles)) for n in diverged)
        assert own != elems
    else:
        assert not diverged
    full = tt.init_params(cfg, torch.Generator(), "meta")
    by_name = tloop.grid_specs(cfg, probe)
    got = sum(int(np.prod(shd.block_shape(probe, by_name[n], tuple(t.shape))))
              for n, t in shd.flat_names(full))
    assert got == elems
    for shape_name in SHAPES:
        s, js = SHAPES[shape_name], jconfig.SHAPES[shape_name]
        if not dr.shape_applicable(cfg, s)[0]:
            continue
        parts = dr.argument_bytes(cfg, s, probe)
        specs = jdr.input_specs(jcfg, js)
        bsh = jdr.batch_shardings(mesh, specs)
        batch = sum(_shard_elems(bsh[k], v.shape) * np.dtype(v.dtype).itemsize
                    for k, v in specs.items())
        if s.kind == "decode":
            batch -= 4                                  # pos: a host int in the port
        assert parts["batch"] == batch, shape_name
        if s.kind == "train":
            plan = jdr.train_memory_plan(jcfg)
            isz = np.dtype(plan["state_dtype"]).itemsize
            assert parts["opt"] == 2 * elems * isz + 4
            assert parts["caches"] == 0
        else:
            caches = jdr.abstract_cache(jcfg, js.global_batch, js.seq_len)
            csh = jdr.cache_shardings(mesh, jcfg, caches)
            want = sum(_shard_elems(sh, c.shape) * np.dtype(c.dtype).itemsize
                       for sh, c in zip(jax.tree.leaves(csh), jax.tree.leaves(caches)))
            assert parts["caches"] == want, shape_name
            assert parts["opt"] == 0
        assert parts["params"] == sum(
            int(np.prod(shd.block_shape(probe, by_name[n], tuple(t.shape)))) * t.element_size()
            for n, t in shd.flat_names(full))


def _smoke(arch, dtype="float32"):
    from repro.configs import registry as jreg
    return (dataclasses.replace(registry.get_smoke_config(arch), dtype=dtype),
            dataclasses.replace(jreg.get_smoke_config(arch), dtype=dtype))


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_prefill_and_train_flops_match_the_reference(jdr):
    import functools
    import jax
    import jax.numpy as jnp
    from repro.launch.hlo_analysis import analyze_hlo
    from repro.models import transformer as jt
    from repro.optim.adamw import AdamWConfig as JAdamW
    from repro.serve.engine import prefill_step
    from repro.train.loop import make_train_step
    cfg, jcfg = _smoke("yi-6b")
    params = jt.init_params(jax.random.PRNGKey(0), jcfg)
    B, T = 2, 64
    tokens = jnp.zeros((B, T), jnp.int32)
    pre = jax.jit(functools.partial(prefill_step, cfg=jcfg, mesh=None, q_chunk=512))
    want = analyze_hlo(pre.lower(params, tokens, jt.init_cache(jcfg, B, T)).compile()
                       .as_text())["flops"]
    got = dr.run_lm_cell("yi-6b", "prefill_32k", False, grid=(1, 1), batch=B, seq_len=T,
                         cfg=cfg)["hlo_analysis"]["flops"]
    assert _rel(got, want) < 0.05, (got, want)
    step = jax.jit(make_train_step(jcfg, None, JAdamW(total_steps=1000)))
    opt = jdr.abstract_opt_state(params)
    batch = {"tokens": tokens, "labels": tokens}
    want = analyze_hlo(step.lower(params, opt, batch).compile().as_text())["flops"]
    got = dr.run_lm_cell("yi-6b", "train_4k", False, grid=(1, 1), batch=B, seq_len=T,
                         cfg=cfg)["hlo_analysis"]["flops"]
    assert _rel(got, want) < 0.10, (got, want)


def _granite():
    return dataclasses.replace(registry.get_smoke_config("granite-moe-1b-a400m"), dtype="float32")


def _real_rank(world):
    """Rank r's events of the dry run's train step of smoke granite-moe on a
    real (2, 2) grid of gloo ranks: the same blocks, state, rows and step."""
    grid = make_grid_mesh((2, 2), ("data", "model"), device="cpu")
    cfg = _granite()
    params = sg.param_blocks(tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
                             cfg, grid)
    opt_cfg = AdamWConfig(total_steps=1000)
    batch = {k: sg.local_rows(torch.zeros((4, 32), dtype=torch.int32), grid).clone()
             for k in ("tokens", "labels")}
    step = tloop.make_train_step(cfg, opt_cfg, grid, num_microbatches=1, q_chunk=512)
    mark = len(grid.log)
    step(params, init_state(params, opt_cfg), batch)
    return [e.to_json() for e in grid.log.since(mark)]


def test_fake_grid_trace_logs_the_real_ranks_events():
    from repro_torch.launch.mesh import MeshEvent
    res = dr.run_lm_cell("granite-moe-1b-a400m", "train_4k", False, grid=(2, 2), batch=4,
                         seq_len=32, cfg=_granite(), events=True)
    fake = [MeshEvent.from_json(e) for e in res["events"]]
    real = [MeshEvent.from_json(e) for e in spawn_world(_real_rank, 4, device="cpu")[0]]
    assert len(fake) == len(real) > 0
    for i, (a, b) in enumerate(zip(fake, real)):
        assert a == b, (i, a.brief(), b.brief())
    assert res["collectives"]["count"] == len(real)
    assert res["memory_analysis"]["temp_bytes"] > 0
    assert res["num_chips"] == 4 and res["fits"]["ok"]


def test_fmm_cell_on_a_fake_world_of_eight():
    """The FMM cell runs, and leaves no fake operator in the FMM's caches:
    a real evaluation at the same order afterwards gives real tensors."""
    from repro_torch.core.fmm import fmm_velocity
    from repro_torch.core.quadtree import build_tree
    res = dr.run_fmm_cell(False, level=5, slots=2, p=8, world=8)
    rng = np.random.default_rng(0)
    tree, _ = build_tree(rng.uniform(0.1, 0.9, (64, 2)), rng.normal(size=64), level=3,
                         sigma=0.02, slots=8, device="cpu")
    w = fmm_velocity(tree, 8, device="cpu")
    assert np.isfinite(w.numpy()).all()
    assert res["mesh"] == "8flat" and res["num_chips"] == 8
    assert res["collectives"]["count"] > 0 and res["collectives"]["total_bytes"] > 0
    assert res["hlo_analysis"]["flops"] > 0 and res["fits"]["ok"]
    mem = res["memory_analysis"]
    n = 32 * 32 * 2
    assert mem["argument_bytes"] == n * (8 + 8 + 1)
    assert mem["temp_bytes"] > 0 and mem["generated_code_bytes"] is None


def _worked(x):
    a = x * 2                   # +4096 -> 4096
    b = a.view(-1)              # a view: nothing
    c = a + 1                   # +4096 -> 8192
    del a, b                    # a freed -> 4096
    d = torch.empty(2048)       # +8192 -> 12288 (the peak)
    c.add_(1)                   # in place: nothing
    del d                       # -> 4096
    return c.sum()              # +4 -> 4100, c freed on return -> 4


def test_peak_tracker_on_a_worked_sequence_real_and_fake():
    x = torch.ones(1024)
    with PeakTracker((x,)) as real:
        y = _worked(x)
    with FakeTensorMode():
        xf = torch.empty(1024)
        with PeakTracker((xf,)) as fake:
            yf = _worked(xf)
    assert y.shape == yf.shape == ()
    for tr in (real, fake):
        assert tr.peak == 12288 and tr.live == 4
        assert tr.at_peak == {"add": 4096, "empty": 8192}


def test_perf_flags_reach_the_model(monkeypatch):
    """``--score-dtype bfloat16`` keeps the attention's score blocks in bf16
    (fewer temporary bytes), ``--attn-impl skip_core`` drops them (the
    reference's stand-in for a flash kernel), and ``--remat-policy
    save_block_out`` keeps each attention layer's residual after its
    attention block through the backward (more temporary bytes); ``main``
    hands the flag to the cell."""
    cfg = dataclasses.replace(registry.get_smoke_config("yi-6b"), dtype="float32")
    temp = {}
    for name, over in (("f32", None), ("bf16", {"score_dtype": "bfloat16"}),
                       ("skip", {"attn_impl": "skip_core"})):
        res = dr.run_lm_cell("yi-6b", "prefill_32k", False, grid=(1, 1), batch=2,
                             seq_len=256, cfg=cfg, overrides=over)
        temp[name] = (res["memory_analysis"]["temp_bytes"], res["hlo_analysis"]["flops"])
    assert temp["bf16"][0] < temp["f32"][0] and temp["bf16"][1] == temp["f32"][1]
    assert temp["skip"][0] < temp["bf16"][0] and temp["skip"][1] < temp["f32"][1]
    deep = dataclasses.replace(cfg, num_layers=8, vocab=256)     # activations dominate
    train = {policy: dr.run_lm_cell("yi-6b", "train_4k", False, grid=(1, 1), batch=4,
                                    seq_len=256, cfg=deep,
                                    overrides={"remat_policy": policy, "q_chunk": 64})
             ["memory_analysis"] for policy in ("full", "save_block_out")}
    assert train["save_block_out"]["temp_bytes"] > train["full"]["temp_bytes"]
    # the saved sums h + attn_out, one an attention layer
    saved = train["save_block_out"]["temp_at_peak_by_op"].get("add", 0)
    assert saved - train["full"]["temp_at_peak_by_op"].get("add", 0) >= 7 * 4 * 256 * 128 * 4
    seen = []
    monkeypatch.setattr(dr, "run_lm_cell", lambda *a, **kw: seen.append(kw["overrides"]) or {
        "arch": a[0], "shape": a[1], "skipped": "stub"})
    assert dr.main(["--arch", "yi-6b", "--shape", "train_4k", "--remat-policy",
                    "save_block_out"]) == 0
    assert seen == [{"remat_policy": "save_block_out"}]
