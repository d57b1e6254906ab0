"""The port's sharded driver (``repro_torch.core.parallel_fmm``) against the
reference's, on the CPU.

The reference runs once, in a subprocess on 8 forced host devices
(``use_kernels=False``, its jnp route), and writes its results; the port
runs once, in a ``spawn_world`` of 6 CPU ranks over gloo (the 4-part plans
on a group of ranks 0-3).  Both read the same trees and plans, written by
this module with the port's ``build_tree`` and planner.  Each case below is
a test of its own that reads from those two runs.

Inputs: 3000 uniform particles (numpy seed 0), level 5, p = 12, sigma
0.02; Laplace charges on the same points, and a probe grid of passive
targets for the tracer.  Results agree within 1e-5 rel L2; the packed,
halo'd and prefetched buffers agree bit for bit, and so do the port's
``pipeline`` orders.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import equations as teq
from repro_torch.core import fmm as tfmm
from repro_torch.core import parallel_fmm as tpf
from repro_torch.core.cost_model import ModelParams
from repro_torch.core.faults import FaultSpec
from repro_torch.core.plan import BlockPlan, SlabPlan, plan_from_counts, uniform_plan
from repro_torch.core.quadtree import build_tree, tree_from_numpy
from repro_torch.launch.mesh import Pending, RankMesh, make_group_mesh, spawn_world

ROOT = Path(__file__).resolve().parents[1]
LEVEL, P, SIGMA, N = 5, 12, 0.02, 3000
TOL = 1e-5
GRIDS = ("4x1", "1x4", "2x2", "2x3")          # the halo tests' rank grids
EVALS = {"vortex-uniform": ("vortex", "uniform"),
         "vortex-model": ("vortex", "model"),
         "vortex-model2x2": ("vortex", "model2x2"),
         "vortex-slab_unequal": ("vortex", "slab_unequal"),
         "vortex-block2x2": ("vortex", "block2x2"),
         "vortex-block2x3": ("vortex", "block2x3"),
         "laplace-slab_unequal": ("laplace", "slab_unequal"),
         "laplace-block2x3": ("laplace", "block2x3"),
         "tracer-uniform": ("tracer", "uniform"),
         "tracer-block2x2": ("tracer", "block2x2")}
PREFETCH = ("slab_unequal", "block2x2")
FAULTS = {"halo_nan": ("slab_unequal", ("halo_nan", 1, 1)),
          "tile_corrupt": ("block2x2", ("tile_corrupt", 1, 3))}
ORDERS = [(True, True), (True, False), (False, True), (False, False)]


def _plan_spec(plan):
    if isinstance(plan, SlabPlan):
        return ["slab", plan.level, list(plan.row0), list(plan.rows)]
    return ["block", plan.level, list(plan.row0), list(plan.rows),
            list(plan.col0), list(plan.cols)]


def _plan_of(spec):
    kind, level, *bands = spec
    bands = [tuple(b) for b in bands]
    return SlabPlan(level, *bands) if kind == "slab" else BlockPlan(level, *bands)


def _write_inputs(d: Path) -> None:
    rng = np.random.default_rng(0)
    pos = rng.uniform(0.02, 0.98, size=(N, 2))
    gamma = rng.normal(size=N)
    src, index = build_tree(pos, gamma, level=LEVEL, sigma=SIGMA, device="cpu")
    lap, _ = build_tree(pos, gamma, level=LEVEL, sigma=SIGMA, device="cpu",
                        charge_scale=teq.LAPLACE.charge_scale)
    side = (np.arange(40) + 0.5) / 40
    probes = np.stack(np.meshgrid(side, side), axis=-1).reshape(-1, 2)
    tgt, _ = build_tree(probes, np.zeros(len(probes)), level=LEVEL, sigma=SIGMA,
                        device="cpu")
    arrays = {"level": np.int64(LEVEL),
              "me": (rng.normal(size=(32, 32, 3))
                     + 1j * rng.normal(size=(32, 32, 3))).astype(np.complex64)}
    for prefix, t in (("", src), ("lap_", lap), ("tgt_", tgt)):
        arrays.update({prefix + "z": t.z.numpy(), prefix + "q": t.q.numpy(),
                       prefix + "mask": t.mask.numpy()})
    np.savez(d / "inputs.npz", **arrays)
    # the model plans of a uniform draw are the uniform ones at this size;
    # unequal tiles come from the explicit plans
    params = ModelParams(level=LEVEL, cut=4, p=P, slots=src.slots)
    plans = {"uniform": uniform_plan(LEVEL, 4),
             "model": plan_from_counts(index.counts, params, 4),
             "model2x2": plan_from_counts(index.counts, params, 4, grid=(2, 2)),
             "slab_unequal": SlabPlan(LEVEL, (0, 6, 14, 24), (6, 8, 10, 8)),
             "block2x2": BlockPlan(LEVEL, (0, 12), (12, 20), (0, 18), (18, 14)),
             "block2x3": BlockPlan(LEVEL, (0, 14), (14, 18), (0, 10, 22),
                                   (10, 12, 10)),
             "1x4": BlockPlan(LEVEL, (0,), (32,), (0, 8, 16, 24), (8, 8, 8, 8))}
    grids = {"4x1": "slab_unequal", "1x4": "1x4", "2x2": "block2x2", "2x3": "block2x3"}
    (d / "plans.json").write_text(json.dumps(
        {"plans": {k: _plan_spec(v) for k, v in plans.items()}, "grids": grids,
         "evals": EVALS, "prefetch": PREFETCH, "faults": FAULTS}))


_REFERENCE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.core import equations as eqs
    from repro.core import parallel_fmm as pf
    from repro.core.faults import FaultSpec
    from repro.core.plan import BlockPlan, SlabPlan
    from repro.core.quadtree import Tree

    d = sys.argv[1]
    inp = np.load(os.path.join(d, "inputs.npz"))
    spec = json.load(open(os.path.join(d, "plans.json")))
    L, p, sigma = int(inp["level"]), int(sys.argv[2]), float(sys.argv[3])

    def plan_of(s):
        kind, level, *bands = s
        bands = [tuple(b) for b in bands]
        return SlabPlan(level, *bands) if kind == "slab" else BlockPlan(level, *bands)

    def tree(prefix):
        return Tree(z=jnp.asarray(inp[prefix + "z"]), q=jnp.asarray(inp[prefix + "q"]),
                    mask=jnp.asarray(inp[prefix + "mask"]), level=L, sigma=sigma)

    def mesh(n):
        return Mesh(np.array(jax.devices()[:n]), ("data",))

    plans = {k: plan_of(v) for k, v in spec["plans"].items()}
    src, lap, tgt = tree(""), tree("lap_"), tree("tgt_")
    out = {}
    for planes, q_real in ((5, False), (4, True)):
        pk = pf._pack_particles(src.z, src.q, src.mask, q_real)
        out[f"pack{planes}"] = pk
        for k, v in zip("zqm", pf._unpack_particles(pk, jnp.complex64, q_real)):
            out[f"unpack{planes}_{k}"] = v

    def halo_global(x, plan, w):
        block = plan.as_block() if isinstance(plan, SlabPlan) else plan
        Pr, Pc = block.grid
        src_r, src_c, valid = block.gather_index()
        v = jnp.asarray(valid).reshape(valid.shape + (1,) * (x.ndim - 2))
        x_sh = jnp.where(v, x[src_r, src_c], 0)

        def body(xt):
            di = jax.lax.axis_index("data")
            dev = np.arange(Pr * Pc)
            rows = jnp.asarray(np.asarray(block.rows, np.int32)[dev // Pc])[di]
            cols = jnp.asarray(np.asarray(block.cols, np.int32)[dev % Pc])[di]
            return pf._tile_halo(xt, w, rows, cols, "data", (Pr, Pc))
        sp = P("data", *([None] * (x.ndim - 1)))
        return jax.jit(pf._shard_map(body, mesh=mesh(block.nparts), in_specs=(sp,),
                                     out_specs=sp))(x_sh)

    for g, name in spec["grids"].items():
        out[f"halo_{g}_1"] = halo_global(out["pack5"], plans[name], 1)
        out[f"halo_{g}_2"] = halo_global(jnp.asarray(inp["me"]), plans[name], 2)
    for key, (eqname, pname) in spec["evals"].items():
        plan = plans[pname]
        out["eval_" + key] = pf.parallel_fmm_evaluate(
            lap if eqname == "laplace" else src, p, mesh(plan.nparts), plan=plan,
            eq=eqs.get_equation(eqname), targets=tgt if eqname == "tracer" else None)
    for pname in spec["prefetch"]:
        plan = plans[pname]
        out["prefetch_" + pname] = pf.parallel_fmm_p2p_prefetch(
            src, mesh=mesh(plan.nparts), plan=plan)
    for key, (pname, (site, step, dev)) in spec["faults"].items():
        plan = plans[pname]
        _, out["health_" + key] = pf.parallel_fmm_evaluate(
            src, p, mesh(plan.nparts), plan=plan, with_health=True,
            faults=(FaultSpec(site, step=step, device=dev),))
    out["none_vortex"] = pf.parallel_fmm_evaluate(src, p, None)
    one = BlockPlan(L, (0,), (1 << L,), (0,), (1 << L,))
    out["none_laplace"] = pf.parallel_fmm_evaluate(lap, p, None, plan=one, eq=eqs.LAPLACE)
    np.savez(os.path.join(d, "ref.npz"), **{k: np.asarray(v) for k, v in out.items()})
    print("OK")
""")


def _trees(inp):
    return {name: tree_from_numpy(inp[prefix + "z"], inp[prefix + "q"],
                                  inp[prefix + "mask"], LEVEL, SIGMA, device="cpu")
            for name, prefix in (("src", ""), ("lap", "lap_"), ("tgt", "tgt_"))}


def _rank_world(mesh, d):
    """Every case of the port on this rank; returns {name: array}."""
    d = Path(d)
    inp = np.load(d / "inputs.npz")
    spec = json.loads((d / "plans.json").read_text())
    plans = {k: _plan_of(v) for k, v in spec["plans"].items()}
    trees = _trees(inp)
    me = torch.as_tensor(inp["me"])
    four = make_group_mesh(range(4), device="cpu")
    out = {}
    # the 4-part plans on ranks 0-3 first, then the 6-part ones on all six
    for nparts in (4, mesh.size):
        m = four if nparts == 4 else mesh
        if m is None:
            continue

        def mine(name):
            return plans[name].nparts == nparts

        for g, name in spec["grids"].items():
            if not mine(name):
                continue
            block = plans[name].as_block() if isinstance(plans[name], SlabPlan) \
                else plans[name]
            ident = tpf._is_identity(block, nparts, 1 << LEVEL)
            _, rows, _, cols = tpf._tile_extents(block, m.rank)
            src = trees["src"]
            tiles = [tpf._my_tile(a, block, m.rank, ident, fill=f)
                     for a, f in ((src.z, 0), (src.q, 0), (src.mask, False))]
            packed = tpf._pack_particles(*tiles)
            out[f"halo_{g}_1"] = tpf._tile_halo(packed, 1, rows, cols, m,
                                                block.grid).wait()
            out[f"halo_{g}_2"] = tpf._tile_halo(
                tpf._my_tile(me, block, m.rank, ident), 2, rows, cols, m,
                block.grid).wait()
        for key, (eqname, pname) in spec["evals"].items():
            if not mine(pname):
                continue
            for ov, pipe in ORDERS:
                out[f"eval_{key}_{ov}_{pipe}"] = tpf.parallel_fmm_evaluate(
                    trees["lap" if eqname == "laplace" else "src"], P, m,
                    plan=plans[pname], overlap=ov, pipeline=pipe,
                    eq=teq.get_equation(eqname),
                    targets=trees["tgt"] if eqname == "tracer" else None)
        for pname in spec["prefetch"]:
            if not mine(pname):
                continue
            pre = tpf.parallel_fmm_p2p_prefetch(trees["src"], m, plans[pname])
            out["prefetch_" + pname] = pre.wait()
            out["eval_prefetched_" + pname] = tpf.parallel_fmm_velocity(
                trees["src"], P, m, plans[pname], p2p_halo=pre)
            out["eval_inline_" + pname] = tpf.parallel_fmm_velocity(
                trees["src"], P, m, plans[pname])
        for key, (pname, (site, step, dev)) in spec["faults"].items():
            if not mine(pname):
                continue
            _, out["health_" + key] = tpf.parallel_fmm_evaluate(
                trees["src"], P, m, plan=plans[pname], with_health=True,
                faults=(FaultSpec(site, step=step, device=dev),))
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel_fmm")
    _write_inputs(d)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE, str(d), str(P),
                            str(SIGMA)], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        port = spawn_world(_rank_world, 6, device="cpu", timeout_s=300,
                           args=(str(d),))
        stdout, stderr = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, stdout + stderr
    with np.load(d / "ref.npz") as z:
        reference = {k: z[k] for k in z.files}
    plans = {k: _plan_of(v)
             for k, v in json.loads((d / "plans.json").read_text())["plans"].items()}
    return {"ref": reference, "port": port, "plans": plans, "dir": d}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("planes", [5, 4])
def test_pack_and_unpack_are_bit_for_bit(runs, planes):
    ref = runs["ref"]
    inp = np.load(runs["dir"] / "inputs.npz")
    z, q, m = (torch.as_tensor(inp[k]) for k in ("z", "q", "mask"))
    pk = tpf._pack_particles(z, q, m, planes == 4)
    np.testing.assert_array_equal(pk.numpy(), ref[f"pack{planes}"])
    for k, v in zip("zqm", tpf._unpack_particles(pk, planes == 4)):
        np.testing.assert_array_equal(v.numpy(), ref[f"unpack{planes}_{k}"])
    zz, qq, mm = tpf._unpack_particles(pk, planes == 4)
    assert torch.equal(zz, z) and torch.equal(mm, m)
    want_q = torch.complex(q.real, torch.zeros_like(q.real)) if planes == 4 else q
    assert torch.equal(qq, want_q)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("width", [1, 2])
def test_tile_halo_is_bit_for_bit(runs, grid, width):
    ref = runs["ref"][f"halo_{grid}_{width}"]
    bufs = [r[f"halo_{grid}_{width}"] for r in runs["port"]
            if f"halo_{grid}_{width}" in r]
    pr, pc = map(int, grid.split("x"))
    assert len(bufs) == pr * pc
    rows = ref.shape[0] // len(bufs)
    for rank, buf in enumerate(bufs):
        np.testing.assert_array_equal(buf, ref[rank * rows:(rank + 1) * rows])


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "monolithic"])
@pytest.mark.parametrize("key", list(EVALS))
def test_evaluate_matches_reference(runs, key, overlap):
    want = runs["ref"]["eval_" + key]
    got = runs["port"][0][f"eval_{key}_{overlap}_True"]
    assert got.shape == want.shape
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "monolithic"])
@pytest.mark.parametrize("key", list(EVALS))
def test_pipeline_is_bit_for_bit(runs, key, overlap):
    for r in runs["port"]:
        if f"eval_{key}_{overlap}_True" in r:
            np.testing.assert_array_equal(r[f"eval_{key}_{overlap}_True"],
                                          r[f"eval_{key}_{overlap}_False"])


def test_every_rank_returns_the_same_result(runs):
    port = runs["port"]
    keys = [k for k in port[0] if k.startswith("eval_") or k.startswith("health_")]
    assert len(keys) > 30
    for k in keys:
        holders = [r[k] for r in port if k in r]
        assert len(holders) in (4, 6)
        for h in holders[1:]:
            np.testing.assert_array_equal(h, holders[0])


@pytest.mark.parametrize("plan", PREFETCH)
def test_prefetched_buffer_matches_reference(runs, plan):
    ref = runs["ref"]["prefetch_" + plan]
    block = runs["plans"][plan]
    rows = (block.rows_max + 2)
    for rank, r in enumerate(runs["port"][:block.nparts]):
        np.testing.assert_array_equal(r["prefetch_" + plan],
                                      ref[rank * rows:(rank + 1) * rows])


@pytest.mark.parametrize("plan", PREFETCH)
def test_prefetched_evaluation_is_bit_for_bit(runs, plan):
    for r in runs["port"][:runs["plans"][plan].nparts]:
        np.testing.assert_array_equal(r["eval_prefetched_" + plan],
                                      r["eval_inline_" + plan])


@pytest.mark.parametrize("fault", list(FAULTS))
def test_health_word_under_a_fault_matches_reference(runs, fault):
    want = runs["ref"]["health_" + fault]
    got = runs["port"][0]["health_" + fault]
    np.testing.assert_array_equal(got, want)
    assert want.any()


@pytest.mark.parametrize("eqname", ["vortex", "laplace"])
def test_mesh_none_matches_one_device_reference(runs, eqname):
    trees = _trees(np.load(runs["dir"] / "inputs.npz"))
    if eqname == "vortex":
        got = tpf.parallel_fmm_evaluate(trees["src"], P, None, device="cpu")
    else:
        one = BlockPlan(LEVEL, (0,), (32,), (0,), (32,))
        got = tpf.parallel_fmm_evaluate(trees["lap"], P, None, plan=one,
                                        eq=teq.LAPLACE, device="cpu")
    assert _rel(got.numpy(), runs["ref"]["none_" + eqname]) < TOL


def test_sharded_result_matches_the_serial_driver(runs):
    """The port's 2x3 block result against the port's own serial driver."""
    trees = _trees(np.load(runs["dir"] / "inputs.npz"))
    serial = tfmm.fmm_velocity(trees["src"], P, device="cpu").numpy()
    assert _rel(runs["port"][0]["eval_vortex-block2x3_True_True"], serial) < TOL


def _tile_inputs(rmax, cmax, w, trail, seed):
    rng = np.random.default_rng(seed)
    shape = lambda r, c: (r, c) + trail  # noqa: E731
    local = (rng.normal(size=shape(rmax, cmax))
             + 1j * rng.normal(size=shape(rmax, cmax))).astype(np.complex64)
    buf = (rng.normal(size=shape(rmax + 2 * w, cmax + 2 * w))
           + 1j * rng.normal(size=shape(rmax + 2 * w, cmax + 2 * w))).astype(np.complex64)
    return local, buf


@pytest.mark.parametrize("rmax,cmax,rv,cv", [(8, 12, 6, 12), (4, 16, 4, 14),
                                             (16, 4, 12, 4)])
def test_m2l_tile_overlapped_matches_reference(rmax, cmax, rv, cv):
    import jax.numpy as jnp
    from repro.core import fmm as jfmm
    local, buf = _tile_inputs(rmax, cmax, 2, (P,), 3)
    want = jfmm.m2l_tile_overlapped(jfmm.m2l_slab_fn(P), jnp.asarray(local),
                                    jnp.asarray(buf), 4, rv, cv)
    got = tfmm.m2l_tile_overlapped(tfmm.m2l_slab_fn(P), torch.as_tensor(local),
                                   lambda: torch.as_tensor(buf), 4, rv, cv)
    assert _rel(got.numpy(), np.asarray(want)) < TOL


@pytest.mark.parametrize("passive", [False, True])
def test_p2p_tile_overlapped_matches_reference(passive):
    import jax.numpy as jnp
    from repro.core import fmm as jfmm
    rng = np.random.default_rng(4)
    rmax, cmax, s, rv, cv = 6, 8, 3, 4, 8
    z = ((rng.uniform(size=(rmax + 2, cmax + 2, s))
          + 1j * rng.uniform(size=(rmax + 2, cmax + 2, s))) / 8).astype(np.complex64)
    q = (rng.normal(size=z.shape) + 0j).astype(np.complex64)
    m = rng.uniform(size=z.shape) < 0.7
    zl, ql, ml = (a[1:-1, 1:-1].copy() for a in (z, q, m))
    zt = mt = None
    if passive:
        zt = ((rng.uniform(size=(rmax, cmax, 2))
               + 1j * rng.uniform(size=(rmax, cmax, 2))) / 8).astype(np.complex64)
        mt = np.ones(zt.shape, bool)
    want = jfmm.p2p_tile_overlapped(
        jfmm.p2p_slab_fn(), *(jnp.asarray(a) for a in (zl, ql, ml, z, q, m)), rv, cv,
        SIGMA, z_tgt=None if zt is None else jnp.asarray(zt))
    T = torch.as_tensor
    got = tfmm.p2p_tile_overlapped(
        tfmm.p2p_slab_fn(), T(zl), T(ql), T(ml), (T(z), T(q), T(m)), rv, cv, SIGMA,
        z_tgt=None if zt is None else T(zt), mask_tgt=None if mt is None else T(mt))
    live = (ml if mt is None else mt)[:rv, :cv]
    w = np.asarray(want)[:rv, :cv][live]
    assert _rel(got.numpy()[:rv, :cv][live], w) < TOL


def test_parallel_evaluate_keeps_the_reference_errors():
    rng = np.random.default_rng(0)
    pos, gamma = rng.uniform(0.05, 0.95, (200, 2)), rng.normal(size=200)
    tree, _ = build_tree(pos, gamma, level=3, sigma=SIGMA, device="cpu")
    shallow, _ = build_tree(pos, gamma, level=1, sigma=SIGMA, device="cpu")
    with pytest.raises(ValueError, match="level >= 2"):
        tpf.parallel_fmm_evaluate(shallow, 6, device="cpu")
    with pytest.raises(ValueError, match="requires a targets tree"):
        tpf.parallel_fmm_evaluate(tree, 6, eq=teq.TRACER, device="cpu")
    with pytest.raises(ValueError, match="plan level"):
        tpf.parallel_fmm_evaluate(tree, 6, plan=uniform_plan(4, 1), device="cpu")
    with pytest.raises(ValueError, match="bands for 1 devices"):
        tpf.parallel_fmm_evaluate(tree, 6, plan=uniform_plan(3, 2), device="cpu")
    with pytest.raises(ValueError, match="p2p_halo shape"):
        tpf.parallel_fmm_evaluate(tree, 6, device="cpu",
                                  p2p_halo=torch.zeros((3, 3, 5, tree.slots)))


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "monolithic"])
@pytest.mark.parametrize("plan", [uniform_plan(LEVEL, 1), uniform_plan(LEVEL, 4),
                                  BlockPlan(LEVEL, (0, 12), (12, 20), (0, 18), (18, 14))],
                         ids=["one-part", "slab4", "block2x2"])
def test_kernel_launches_counts_the_slab_calls(monkeypatch, plan, overlap):
    """``kernel_launches`` against the M2L and P2P calls one evaluation
    makes on rank 0, replayed alone: its messages are zeros, which the
    count does not see."""
    calls = {"p2p": 0, "m2l": 0}

    def counted(kind, make):
        def factory(*a, **k):
            fn = make(*a, **k)

            def call(*args, **kwargs):
                calls[kind] += 1
                return fn(*args, **kwargs)
            return call
        return factory
    for name, kind in (("m2l_slab_fn", "m2l"), ("m2l_grid_fn", "m2l"),
                       ("p2p_slab_fn", "p2p")):
        monkeypatch.setattr(tfmm, name, counted(kind, getattr(tfmm, name)))

    class Alone(RankMesh):
        def exchange(self, sends, recvs):
            return Pending([], lambda: [torch.zeros(s, dtype=d) for _, s, d in recvs],
                           [])

        def all_gather(self, t):
            return Pending([], lambda: t.expand((self.size,) + tuple(t.shape)), [])
    rng = np.random.default_rng(5)
    pos, gamma = rng.uniform(0.02, 0.98, (400, 2)), rng.normal(size=400)
    tree, _ = build_tree(pos, gamma, level=LEVEL, sigma=SIGMA, device="cpu")
    alone = Alone(group=None, axis="data", size=plan.nparts, rank=0,
                  device=torch.device("cpu"))
    tpf.parallel_fmm_velocity(tree, 6, alone, plan, overlap=overlap)
    assert calls == tpf.kernel_launches(plan, overlap)


def test_kernel_launches_at_the_paper_s_level():
    """The uniform 4-part slab at level 10 cuts at level 3: 36 M2L calls
    (the root tree's 2, level 4's four rims, five a level 5..10) and 5 P2P."""
    assert tpf.kernel_launches(uniform_plan(10, 4)) == {"p2p": 5, "m2l": 36}
    assert tpf.kernel_launches(uniform_plan(10, 4), overlap=False) == \
        {"p2p": 1, "m2l": 9}


def test_rank_mesh_is_a_frozen_hashable_record():
    from dataclasses import FrozenInstanceError
    from repro_torch.launch.mesh import make_local_mesh
    a, b = make_local_mesh(device="cpu"), make_local_mesh(device="cpu")
    assert a == b and hash(a) == hash(b) and a.shape == {"data": 1}
    assert not a.staged and a.group is None
    with pytest.raises(FrozenInstanceError):
        a.rank = 1
