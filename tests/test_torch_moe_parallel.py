"""The port's expert parallelism (``models/moe.py``'s grid path) and
``compressed_psum_mean`` against the reference's sharded outputs, on the
CPU.

The reference runs once, in a subprocess on 4 forced host devices as a
``Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))``.  Its
axes are Auto; ``jax.make_mesh`` would give Explicit ones, under which the
reference's gather raises.  It computes, on granite-moe's smoke config in
f32: ``moe_layer`` with and without the mesh at the config's capacity
factor (drops per shard) and at 4.0 (none); the layer and its gradient of
``sum(out**2)`` with the 16-bit and the int8 (q8) gather; and
``compressed_psum_mean`` inside ``shard_map`` over ``data``.  The port runs
once, in a ``spawn_world`` of 4 CPU ranks as a ``(2, 2)`` grid, on the
reference's weights and inputs; each rank holds its blocks and its data
rank's rows, and its results are held to its blocks of the reference's.

Tolerances: the layer's output and gradients within 1e-5 rel L2 (the same
f32 arithmetic, sums in another order; routing and drops are decided the
same way, on continuous random inputs with no ties), the int8 codes and
so the q8 path within the same 1e-5, ``compressed_psum_mean`` within 1e-6
(its new error within 1e-6 of its input's norm: see the test).
The planted fault (``copy_to_model`` without its backward sum) must move
the router's gradient by more than 1e-2.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.launch.mesh import make_grid_mesh, spawn_world
from repro_torch.models import moe as tm
from repro_torch.optim import adamw as topt
from repro_torch.parallel import sharding as shd

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
NAMES = ("router", "experts_gate", "experts_in", "experts_out")

_REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import dataclasses
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.configs import registry
    from repro.models import moe
    from repro.optim import adamw
    cfg = dataclasses.replace(registry.get_smoke_config("granite-moe-1b-a400m"),
                              dtype="float32")
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    rng = np.random.default_rng(0)
    p = jax.tree.map(np.asarray, moe.init_moe(jax.random.PRNGKey(1), cfg))
    x = rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32)
    out = {f"p_{k}": v for k, v in p.items()}
    out["x"] = x
    for tag, cf in (("cf", cfg.moe.capacity_factor), ("free", 4.0)):
        c = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
        out[f"single_{tag}"] = np.asarray(moe.moe_layer(p, x, c, None))
        out[f"mesh_{tag}"] = np.asarray(
            jax.jit(lambda p, x: moe.moe_layer(p, x, c, mesh))(p, x))
    for bits in (16, 8):
        c = dataclasses.replace(cfg, moe_gather_bits=bits)
        f = lambda p, x: jnp.sum(moe.moe_layer(p, x, c, mesh) ** 2)
        out[f"out{bits}"] = np.asarray(
            jax.jit(lambda p, x: moe.moe_layer(p, x, c, mesh))(p, x))
        gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(p, x)
        out[f"gx{bits}"] = np.asarray(gx)
        for k, v in gp.items():
            out[f"g{bits}_{k}"] = np.asarray(v)
    g = {"a": rng.standard_normal((6, 5)).astype(np.float32),
         "b": rng.standard_normal((4, 3, 2)).astype(np.float32)}
    e = {k: 0.01 * rng.standard_normal(v.shape).astype(np.float32) for k, v in g.items()}
    fn = jax.shard_map(lambda g, e: adamw.compressed_psum_mean(g, e, "data"),
                       mesh=mesh, in_specs=(P("data"), P("data")),
                       out_specs=(P("data"), P("data")))
    mg, me = jax.jit(fn)(g, e)
    for k in g:
        out[f"cg_{k}"], out[f"ce_{k}"] = g[k], e[k]
        out[f"cmean_{k}"], out[f"cerr_{k}"] = np.asarray(mg[k]), np.asarray(me[k])
    np.savez(sys.argv[1], **out)
""")


def _cfg(cf=None, bits=16):
    cfg = dataclasses.replace(registry.get_smoke_config("granite-moe-1b-a400m"),
                              dtype="float32", moe_gather_bits=bits)
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    return cfg


def _blocks(ref, mesh, cfg):
    """This rank's blocks of the reference's MoE weights."""
    out = {}
    for k in NAMES:
        full = torch.from_numpy(ref[f"p_{k}"])
        out[k] = shd.local_block(full, shd.param_spec(mesh, k, full.shape), mesh).clone()
    return out


def _grads(p, x, cfg, mesh):
    """The layer's output and the gradients of ``sum(out**2)`` over the
    global batch: ``x``'s (this rank's rows), the router's (summed over the
    data axis here, as the train step's gather does) and the experts'
    blocks."""
    live = {k: v.detach().requires_grad_() for k, v in p.items()}
    xl = x.detach().requires_grad_()
    out = tm.moe_layer(live, xl, cfg, mesh)
    torch.autograd.backward((out ** 2).sum())
    g = {k: v.grad for k, v in live.items()}
    g["router"] = mesh.all_reduce_sum(g["router"], ("data",))
    return out.detach(), xl.grad, g


def _rank(world_mesh, ref_path):
    mesh = make_grid_mesh((2, 2), ("data", "model"), device="cpu")
    with np.load(ref_path) as z:
        ref = {k: z[k] for k in z.files}
    p = _blocks(ref, mesh, _cfg())
    x = shd.local_block(torch.from_numpy(ref["x"]), shd.batch_spec(mesh, 3), mesh)
    res = {"coords": mesh.coords}
    for tag, cf in (("cf", None), ("free", 4.0)):
        res[f"mesh_{tag}"] = tm.moe_layer(p, x, _cfg(cf), mesh)
    for bits in (16, 8):
        out, gx, g = _grads(p, x, _cfg(bits=bits), mesh)
        res[f"out{bits}"], res[f"gx{bits}"] = out, gx
        res.update({f"g{bits}_{k}": v for k, v in g.items()})
    # the planted fault: copy_to_model without its backward sum
    good = tm.copy_to_model
    tm.copy_to_model = lambda t, m: t
    try:
        res["fault_router"] = _grads(p, x, _cfg(), mesh)[2]["router"]
    finally:
        tm.copy_to_model = good
    spec = shd.batch_spec(mesh)
    g = {k: shd.local_block(torch.from_numpy(ref[f"cg_{k}"]), spec, mesh) for k in ("a", "b")}
    e = {k: shd.local_block(torch.from_numpy(ref[f"ce_{k}"]), spec, mesh) for k in ("a", "b")}
    mean, err = topt.compressed_psum_mean(g, e, mesh, "data")
    res.update({f"cmean_{k}": v for k, v in mean.items()})
    res.update({f"cerr_{k}": v for k, v in err.items()})
    res["log"] = list(mesh.log.events)
    return res


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """(the reference's arrays, each port rank's results)."""
    path = str(tmp_path_factory.mktemp("moe_parallel") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _REF, path], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as z:
        ref = {k: z[k] for k in z.files}
    return ref, spawn_world(_rank, 4, device="cpu", timeout_s=300, args=(path,))


def _rel(a, b) -> float:
    a = np.asarray(a.detach() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _block_of(ref_full, name, coords):
    """Rank ``coords``' block of a reference array (``name`` picks the spec)."""
    mesh = shd.AbstractGrid((2, 2), ("data", "model"))
    t = torch.from_numpy(ref_full)
    if name in NAMES:
        spec = shd.param_spec(mesh, name, t.shape)
    elif name == "router_grad":
        spec = (None, None)
    else:
        spec = shd.batch_spec(mesh, t.dim())
    out = t
    for d, entry in enumerate(spec):
        axes = shd.spec_axes(entry)
        if not axes:
            continue
        n = shd.axis_size(mesh, axes)
        size = out.shape[d] // n
        idx = coords[0] if axes == ("data",) else coords[1]
        out = out.narrow(d, idx * size, size)
    return out.numpy()


@pytest.mark.parametrize("tag", ["cf", "free"])
def test_moe_layer_on_the_grid_matches_the_reference_ep_output(worlds, tag):
    """Capacity per shard, drops included (the config's factor 1.25), and
    with nothing dropped (4.0); at 1.25 the sharded reference differs from
    its one-device path, and the port follows the sharded one."""
    ref, ranks = worlds
    for r in ranks:
        want = _block_of(ref[f"mesh_{tag}"], "x", r["coords"])
        assert _rel(r[f"mesh_{tag}"], want) < 1e-5, (tag, r["coords"])
    if tag == "cf":
        assert _rel(ref["mesh_cf"], ref["single_cf"]) > 1e-3


@pytest.mark.parametrize("bits", [16, 8])
def test_moe_gather_output_and_gradients_match_the_reference(worlds, bits):
    """The 16-bit and the int8 gather: the output, the gradient of x (this
    rank's rows), the router's and the experts' blocks."""
    ref, ranks = worlds
    for r in ranks:
        c = r["coords"]
        assert _rel(r[f"out{bits}"], _block_of(ref[f"out{bits}"], "x", c)) < 1e-5
        assert _rel(r[f"gx{bits}"], _block_of(ref[f"gx{bits}"], "x", c)) < 1e-5
        for k in NAMES:
            got = r[f"g{bits}_{k}"]
            want = _block_of(ref[f"g{bits}_{k}"], "router_grad" if k == "router" else k, c)
            assert got.shape == want.shape and _rel(got, want) < 1e-5, (bits, k, c)
    if bits == 8:
        assert _rel(ref["out8"], ref["out16"]) > 1e-4      # the codes are in play


def test_planted_fault_without_the_backward_sum_is_caught(worlds):
    ref, ranks = worlds
    for r in ranks:
        want = _block_of(ref["g16_router"], "router_grad", r["coords"])
        assert _rel(r["fault_router"], want) > 1e-2


def test_compressed_psum_mean_matches_the_reference(worlds):
    """The mean within 1e-6 rel L2.  The new error, ``g + e - g_hat``, is a
    difference of near-equal numbers, and XLA contracts ``q * scale`` and
    the subtraction into one fused multiply-add on the CPU where the port
    rounds the product first: it is held within 1e-6 of the norm of
    ``g + e``, the scale its rounding lives on."""
    ref, ranks = worlds
    for r in ranks:
        for k in ("a", "b"):
            c = r["coords"]
            want = _block_of(ref[f"cmean_{k}"], "x", c)
            assert _rel(r[f"cmean_{k}"], want) < 1e-6, (k, c)
            g32 = _block_of(ref[f"cg_{k}"] + ref[f"ce_{k}"], "x", c)
            diff = r[f"cerr_{k}"].numpy() - _block_of(ref[f"cerr_{k}"], "x", c)
            assert np.linalg.norm(diff) < 1e-6 * np.linalg.norm(g32), (k, c)


def test_moe_grid_logs_verify_and_name_their_groups(worlds):
    """Every collective of the MoE path runs over one named axis of the
    grid; the four ranks' logs verify against each other."""
    from repro_torch.analysis.schedule import verify_schedules
    _, ranks = worlds
    logs = [r["log"] for r in ranks]
    rep = verify_schedules(logs, label="moe grid")
    assert rep.ok, rep.diff_text()
    kinds = {(e.kind, e.axes) for e in logs[0]}
    assert {("all_gather", ("data",)), ("all_reduce_sum", ("model",)),
            ("reduce_scatter", ("data",))} <= kinds
