"""The port's sharding rules (``parallel/sharding.py``) against the
reference's, and the grid of ranks (``launch/mesh.py:GridMesh``) that
holds their blocks, on the CPU.

The rules are compared on every leaf of every registered architecture's
smoke config, on ``(2, 2)``, ``(1, 4)``, ``(4, 1)`` and ``(2, 4)`` grids:
the reference's ``param_spec`` on an ``AbstractMesh`` (no devices, no
subprocess), the port's on an ``AbstractGrid``.  A ``PartitionSpec``
writes a one-axis tuple as the axis' name; entries are compared as tuples
of axes.  The reference's layers sit in scanned groups, the port's in a
flat list (``layers/<i>/...``, no leading layer dim): a layer of a group
of one repeat keeps no leading dim in the reference, where its
``"groups"`` rule still strips one, so there the port's spec is compared
with the reference's for the same leaf stacked.

The grid's collectives run in one ``spawn_world`` of 4 CPU ranks, on each
grid, against numpy; their schedule logs verify, and a log with two
collectives swapped on one rank, or two groups' collectives in opposite
orders on two ranks, does not.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.analysis.schedule import verify_schedules
from repro_torch.configs import registry
from repro_torch.launch.mesh import make_grid_mesh, spawn_world
from repro_torch.models import moe
from repro_torch.models.convert import scan_groups
from repro_torch.models.transformer import init_params, layer_kinds
from repro_torch.parallel import sharding as shd

GRIDS = [(2, 2), (1, 4), (4, 1), (2, 4)]
AXES = ("data", "model")


def _axes(spec) -> tuple:
    return tuple(shd.spec_axes(e) for e in spec)


@pytest.fixture(scope="module")
def reference():
    import jax
    from jax.sharding import AbstractMesh
    from repro.configs import registry as jreg
    from repro.models import moe as jmoe
    from repro.models import transformer as jt
    from repro.parallel import sharding as jshd
    out = {}
    for arch in registry.lm_archs():
        cfg = jreg.get_smoke_config(arch)
        shapes = jax.eval_shape(lambda: jt.init_params(jax.random.PRNGKey(0), cfg))
        flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
        leaves = [("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path),
                   tuple(leaf.shape)) for path, leaf in flat]
        for grid in GRIDS:
            mesh = AbstractMesh(grid, AXES)
            out[arch, grid] = [(n, s, _axes(jshd.param_spec(mesh, n, s))) for n, s in leaves]
            if grid == (2, 2):
                out[arch, "stacked"] = {n: _axes(jshd.param_spec(mesh, n, (1,) + s))[1:]
                                        for n, s in leaves}
        for grid in GRIDS:
            mesh = AbstractMesh(grid, AXES)
            out["specs", grid] = (
                _axes(jshd.batch_spec(mesh)), _axes(jshd.batch_spec(mesh, 3)),
                _axes(jshd.activation_spec(mesh)),
                [_axes(jshd.kv_cache_spec(mesh, h, b)) for h in (1, 2, 8) for b in (1, 4)])
            out["moe", grid] = {k: _axes(v) for k, v in jmoe.moe_param_specs(mesh).items()}
    return out


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("arch", registry.lm_archs())
def test_param_spec_equals_the_reference(arch, grid, reference):
    mesh = shd.AbstractGrid(grid, AXES)
    ref = reference[arch, grid]
    # the rule itself, on the reference's own names and shapes
    for name, shape, want in ref:
        assert _axes(shd.param_spec(mesh, name, shape)) == want, (name, shape)
    # the port's leaves against the reference's leaves they were made from
    cfg = registry.get_smoke_config(arch)
    port = dict(zip((n for n, _ in shd.flat_names(init_params(cfg, torch.Generator(),
                                                              "meta"))),
                    shd.param_specs(mesh, init_params(cfg, torch.Generator(), "meta"))))
    layer = 0
    by_name = {n: (s, w) for n, s, w in ref}
    for g, (pat, reps) in enumerate(scan_groups(layer_kinds(cfg))):
        for r in range(reps):
            for j in range(len(pat)):
                prefix = f"groups/{g}/{j}/"
                for name, (shape, want) in by_name.items():
                    if not name.startswith(prefix):
                        continue
                    mine = f"layers/{layer + j}/" + name[len(prefix):]
                    if reps > 1:
                        want = want[1:]                   # the stacked layer dim
                    elif grid == (2, 2):
                        want = reference[arch, "stacked"][name]
                    else:
                        continue
                    assert _axes(port[mine]) == want, (mine, want)
            layer += len(pat)
    for name in ("embed", "lm_head", "final_norm", "patch_proj"):
        if name in by_name:
            assert _axes(port[name]) == by_name[name][1], name


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_batch_activation_and_kv_cache_specs_equal_the_reference(grid, reference):
    mesh = shd.AbstractGrid(grid, AXES)
    got = (_axes(shd.batch_spec(mesh)), _axes(shd.batch_spec(mesh, 3)),
           _axes(shd.activation_spec(mesh)),
           [_axes(shd.kv_cache_spec(mesh, h, b)) for h in (1, 2, 8) for b in (1, 4)])
    assert got == reference["specs", grid]


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_moe_param_specs_equal_the_reference(grid, reference):
    """The EP-only view; where the experts' dim 1 splits over the data axis
    ``param_spec`` stores them otherwise, and ``moe_layer`` reads that."""
    mesh = shd.AbstractGrid(grid, AXES)
    got = {k: _axes(v) for k, v in moe.moe_param_specs(mesh).items()}
    assert got == reference["moe", grid]
    stored = shd.normalize_spec(shd.param_spec(mesh, "experts_gate", (8, 16, 4)), mesh)
    ep = shd.normalize_spec(moe.moe_param_specs(mesh)["experts_gate"], mesh)
    assert (stored == ep) == (grid[0] == 1)


def test_constrain_passes_blocks_and_refuses_the_rest():
    mesh = shd.AbstractGrid((2, 2), AXES)
    x = torch.zeros(2, 3, 8)
    assert shd.constrain(x, mesh, shd.activation_spec(mesh), (4, 3, 8)) is x
    with pytest.raises(ValueError):
        shd.constrain(x, mesh, shd.activation_spec(mesh), (2, 3, 8))
    one = shd.AbstractGrid((1, 1), AXES)
    assert shd.constrain(x, one, ("data", None, None), (99,)) is x


# ---------------------------------------------------------------------------
# the grid's collectives on 4 CPU ranks
# ---------------------------------------------------------------------------


def _data(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rank(world_mesh):
    out = {}
    for grid in ((2, 2), (1, 4), (4, 1)):
        mesh = make_grid_mesh(grid, AXES, device="cpu")
        me = torch.from_numpy(_data((4, 6), 100 + mesh.rank))
        res = {"coords": mesh.coords}
        for axes in (("data",), ("model",), ("data", "model"), ("model", "data")):
            key = "+".join(axes)
            res["sum " + key] = mesh.all_reduce_sum(me, axes)
            res["gather " + key] = mesh.all_gather(me, axes, dim=1)
            res["scatter " + key] = mesh.reduce_scatter(me, axes, dim=0)
        full = torch.from_numpy(_data((8, 12), 7))
        spec = (("data",), "model")
        block = shd.local_block(full, spec, mesh)
        res["roundtrip"] = bool(torch.equal(shd.gather_full(block, spec, mesh), full))
        res["log"] = list(mesh.log.events)
        out[grid] = res
    return out


@pytest.fixture(scope="module")
def grid_world():
    return spawn_world(_rank, 4, device="cpu", timeout_s=300)


def _members(coords, grid, axes):
    """Global ranks of the group over ``axes`` through ``coords``, in the
    axes' order (the first major)."""
    out = []
    sizes = dict(zip(AXES, grid))
    n = int(np.prod([sizes[a] for a in axes]))
    for idx in range(n):
        c = list(coords)
        for a in reversed(axes):
            c[AXES.index(a)] = idx % sizes[a]
            idx //= sizes[a]
        out.append(c[0] * grid[1] + c[1])
    return out


@pytest.mark.parametrize("grid", [(2, 2), (1, 4), (4, 1)], ids=lambda g: f"{g[0]}x{g[1]}")
def test_grid_collectives_equal_numpy(grid, grid_world):
    for res in (w[grid] for w in grid_world):
        c = res["coords"]
        for axes in (("data",), ("model",), ("data", "model"), ("model", "data")):
            key = "+".join(axes)
            parts = [_data((4, 6), 100 + m) for m in _members(c, grid, axes)]
            idx = _members(c, grid, axes).index(c[0] * grid[1] + c[1])
            np.testing.assert_allclose(res["sum " + key].numpy(), np.sum(parts, axis=0),
                                       rtol=1e-6, atol=1e-6)
            assert np.array_equal(res["gather " + key].numpy(), np.concatenate(parts, 1))
            blocks = np.split(np.sum(parts, axis=0), len(parts), axis=0)
            np.testing.assert_allclose(res["scatter " + key].numpy(), blocks[idx],
                                       rtol=1e-6, atol=1e-6)
        assert res["roundtrip"]


@pytest.mark.parametrize("grid", [(2, 2), (1, 4), (4, 1)], ids=lambda g: f"{g[0]}x{g[1]}")
def test_grid_logs_verify_and_a_swap_or_a_crossed_order_is_caught(grid, grid_world):
    logs = [w[grid]["log"] for w in grid_world]
    rep = verify_schedules(logs, label=str(grid))
    assert rep.ok, rep.diff_text()
    # every collective names its axes; an axis of one rank issues none
    sizes = dict(zip(AXES, grid))
    assert all(e.axes and np.prod([sizes[a] for a in e.axes]) > 1 for e in logs[0])
    # two collectives of one group swapped on rank 1
    bad = [list(lg) for lg in logs]
    i = next(k for k, e in enumerate(bad[1]) if e.kind == "all_reduce_sum")
    j = next(k for k, e in enumerate(bad[1]) if k > i and e.group == bad[1][i].group
             and e != bad[1][i])
    bad[1][i], bad[1][j] = bad[1][j], bad[1][i]
    rep = verify_schedules(bad, label="swapped")
    assert not rep.ok and any("diverges" in p for p in rep.problems)
    if grid == (2, 2):
        # rank 0 runs its data collective before its model one, rank 3 the
        # reverse: each group agrees, but the ranks block each other
        ev = {e.axes: e for e in logs[0] if e.kind == "all_reduce_sum"}
        mk = lambda e, r: dataclasses.replace(e, group=tuple(
            _members(((r // 2), r % 2), grid, e.axes)))
        crossed = [[mk(ev[("data",)], r), mk(ev[("model",)], r)] for r in range(4)]
        crossed[1] = crossed[1][::-1]
        crossed[2] = crossed[2][::-1]
        rep = verify_schedules(crossed, label="crossed")
        assert not rep.ok and any("block" in p for p in rep.problems), rep.problems
