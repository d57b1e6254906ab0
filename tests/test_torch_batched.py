"""The leading batch axis of the port's FMM stages and kernels' plain
versions, on the CPU: each batched stage against a loop over its items,
within 1e-6 relative (the same products, so in practice bit for bit),
P2P in its four modes, the serial driver on batched trees, and the
kernel wrappers' refusal of a batch they cannot launch.

The serving engine hands a bucket of B jobs to these stages at once; on
the card each kernel is then one launch for the whole batch
(``test_torch_kernels.py``'s ``gpu`` cases hold those launches to the
plain versions and to one launch per item).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core import equations as eqs
from repro_torch.core import expansions as ex
from repro_torch.core import fmm
from repro_torch.core.quadtree import Tree, box_centers, box_size, build_tree
from repro_torch.kernels import m2l, ops, p2p

B, LEVEL, P = 3, 3, 8
TOL = 1e-6


def _rel(a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return float(torch.linalg.vector_norm(a - b)
                 / max(float(torch.linalg.vector_norm(b)), 1e-30))


def _c(rng, *shape):
    return torch.as_tensor((rng.normal(size=shape) + 1j * rng.normal(size=shape))
                           .astype(np.complex64))


def _leaves(rng, n, s):
    """Particles in their boxes (``z`` inside the box of its slot), complex
    charges, about a third of the slots empty."""
    h = 1.0 / n
    iy, ix = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    u = rng.uniform(0.05, 0.95, size=(n, n, s, 2))
    z = ((ix[..., None] + u[..., 0]) * h + 1j * (iy[..., None] + u[..., 1]) * h)
    q = rng.normal(size=(n, n, s)) + 1j * rng.normal(size=(n, n, s))
    mask = rng.uniform(size=(n, n, s)) > 0.3
    return (torch.as_tensor(z.astype(np.complex64)),
            torch.as_tensor(q.astype(np.complex64)), torch.as_tensor(mask))


def _batch(rng, n, s, count=B):
    items = [_leaves(rng, n, s) for _ in range(count)]
    return [torch.stack([it[k] for it in items]) for k in range(3)]


def _each(batched, fn, *args):
    """The largest relative error of ``batched[b]`` against ``fn`` on item b."""
    return max(_rel(batched[b], fn(*(a[b] for a in args))) for b in range(len(batched)))


def test_p2m_takes_a_batch():
    rng = np.random.default_rng(0)
    n = 1 << LEVEL
    z, q, m = _batch(rng, n, 5)
    cen = torch.as_tensor(box_centers(LEVEL), dtype=torch.complex64)
    coeff = eqs.LAPLACE.p2m_coeff(P)
    for c in (None, coeff):
        out = ex.p2m(z, q, m, cen, box_size(LEVEL), P, coeff=c)
        assert out.shape == (B, n, n, P)
        err = _each(out, lambda zz, qq, mm: ex.p2m(zz, qq, mm, cen, box_size(LEVEL), P,
                                                   coeff=c), z, q, m)
        assert err <= TOL


@pytest.mark.parametrize("stage", ["m2m", "l2l"])
def test_translations_take_a_batch(stage):
    rng = np.random.default_rng(1)
    grid = _c(rng, B, 8, 8, P)
    fn = (lambda g: ex.m2m(g, P)) if stage == "m2m" else (lambda g: ex.l2l(g, P))
    out = fn(grid)
    assert out.shape == ((B, 4, 4, P) if stage == "m2m" else (B, 16, 16, P))
    assert _each(out, fn, grid) <= TOL


@pytest.mark.parametrize("eq", [eqs.VORTEX, eqs.LAPLACE])
@pytest.mark.parametrize("tile", [False, True])
def test_m2l_takes_a_batch(eq, tile):
    """The whole folded route (stack, contraction, relayout, scale), on a
    full level grid and on a halo'd 2-D tile with odd anchors."""
    rng = np.random.default_rng(2)
    if tile:
        grid = _c(rng, B, 11 + 6, 9 + 6, P)
        args = dict(row0=3, halo=3, col0=5, col_halo=3)
        fn = lambda g: ops.m2l_apply_slab(g, 5, P, eq=eq, **args)  # noqa: E731
    else:
        grid = _c(rng, B, 16, 16, P)
        fn = lambda g: ops.m2l_apply(g, 4, P, eq=eq)  # noqa: E731
    before = m2l.LAUNCHES
    out = fn(grid)
    assert m2l.LAUNCHES == before            # the CPU takes the plain version
    assert out.shape[0] == B and out.shape[1:] == fn(grid[0]).shape
    assert _each(out, fn, grid) <= TOL


def test_parent_planes_round_trip_with_a_batch():
    rng = np.random.default_rng(3)
    grid = _c(rng, B, 6, 10, P)
    planes = ex.to_parent_planes(grid, P)
    assert planes.shape == (B, 3, 5, 4 * P)
    assert torch.equal(planes[1], ex.to_parent_planes(grid[1], P))
    assert torch.equal(ex.from_parent_planes(planes, P), grid)


def test_folded_contract_takes_a_batch():
    rng = np.random.default_rng(4)
    stack = _c(rng, B, 7, 5, 4 * P)
    W = torch.as_tensor(ex.m2l_folded_operator(P), dtype=torch.complex64)
    out = m2l.m2l_plain(stack, W)
    assert out.shape == (B, 5, 3, 4 * P)
    assert _each(out, lambda s: m2l.m2l_plain(s, W), stack) <= TOL


def test_l2p_takes_a_batch():
    rng = np.random.default_rng(5)
    n = 1 << LEVEL
    z, _, _ = _batch(rng, n, 4)
    le = _c(rng, B, n, n, P)
    cen = torch.as_tensor(box_centers(LEVEL), dtype=torch.complex64)
    for modes in (("value",), ("value", "ngrad")):
        fn = lambda l, zz: ex.l2p_eval(l, zz, cen, box_size(LEVEL), P, modes)  # noqa: E731
        out = fn(le, z)
        assert out.shape[:4] == (B, n, n, 4)
        assert _each(out, fn, le, z) <= TOL


MODES = [("base", False), ("laplace", False), ("base", True), ("laplace", True)]


@pytest.mark.parametrize("mode,passive", MODES)
@pytest.mark.parametrize("sigma", [None, 0.05])
def test_p2p_plain_takes_a_batch_in_every_mode(mode, passive, sigma):
    """P2P's plain version, and the dispatcher on CPU tensors (which counts
    no launch), in all four modes: a batch against one call per grid."""
    rng = np.random.default_rng(6)
    zh, qh, mh = _batch(rng, 9, 5)                    # (B, 7 + 2, 7 + 2, 5)
    zt = mt = None
    if passive:
        zt, _, mt = _batch(rng, 7, 3)
    out = p2p.p2p_plain(zh, qh, mh, sigma, zt, mt, mode)
    nout = p2p.MODES[mode].nout
    assert out.shape == (B, 7, 7, 3 if passive else 5) + ((2,) if nout == 2 else ())
    one = lambda *a: p2p.p2p_plain(*a[:3], sigma, *(a[3:] or (None, None)), mode)  # noqa: E731
    args = (zh, qh, mh) + ((zt, mt) if passive else ())
    assert _each(out, one, *args) <= TOL
    before = dict(p2p.LAUNCHES_BY_MODE)
    eq = eqs.LAPLACE if mode == "laplace" else eqs.VORTEX
    assert torch.equal(ops.p2p_apply_slab(zh, qh, mh, sigma, zt, mt, eq=eq), out)
    assert p2p.LAUNCHES_BY_MODE == before


@pytest.mark.parametrize("eq,with_targets", [(eqs.VORTEX, False), (eqs.LAPLACE, False),
                                             (eqs.LAPLACE, True), (eqs.TRACER, True)])
def test_fmm_evaluate_takes_a_batched_tree(eq, with_targets):
    """The serial driver on a tree whose arrays lead with B (and targets
    with the same B): each item as it evaluates alone."""
    rng = np.random.default_rng(7)
    trees, tgts = [], []
    for _ in range(B):
        pos = rng.uniform(0.05, 0.95, (200, 2))
        trees.append(build_tree(pos, rng.normal(size=200), LEVEL, 0.02, slots=16,
                                charge_scale=eq.charge_scale, device="cpu")[0])
        tp = rng.uniform(0.05, 0.95, (60, 2))
        tgts.append(build_tree(tp, np.zeros(60), LEVEL, 0.02, slots=8, device="cpu")[0])

    def stacked(ts):
        return Tree(*(torch.stack([getattr(t, f) for t in ts]) for f in ("z", "q", "mask")),
                    level=LEVEL, sigma=0.02)
    tt = stacked(tgts) if with_targets else None
    out = fmm.fmm_evaluate(stacked(trees), P, eq=eq, targets=tt, device="cpu")
    for b in range(B):
        one = fmm.fmm_evaluate(trees[b], P, eq=eq, device="cpu",
                               targets=tgts[b] if with_targets else None)
        assert out[b].shape == one.shape
        assert _rel(out[b], one) <= TOL


def test_fmm_evaluate_refuses_targets_of_another_batch():
    rng = np.random.default_rng(8)
    z, q, m = _batch(rng, 8, 4)
    src = Tree(z=z, q=q, mask=m, level=LEVEL, sigma=0.02)
    tgt = Tree(z=z[:2], q=q[:2], mask=m[:2], level=LEVEL, sigma=0.02)
    with pytest.raises(ValueError, match="batch"):
        fmm.fmm_evaluate(src, P, eq=eqs.TRACER, targets=tgt, device="cpu")


def test_kernel_wrappers_refuse_a_batch_they_cannot_launch():
    """Checked before any launch, so on the CPU too: a batch must hold 1 to
    65535 grids (the kernels' gridDim.z) and at most one leading axis."""
    empty = torch.zeros((0, 6, 6, 4), dtype=torch.complex64)
    five = torch.zeros((2, 2, 6, 6, 4), dtype=torch.complex64)
    huge = torch.zeros((p2p.MAX_BATCH + 1, 3, 3, 1), dtype=torch.complex64)
    for z in (empty, five, huge):
        with pytest.raises(ValueError, match="B <="):
            p2p.p2p_cuda(z, z, z.real > 0, 0.05)
        with pytest.raises(ValueError, match="B <="):
            m2l.m2l_cuda(z, torch.zeros((8, 4, 4), dtype=torch.complex64))
    ok = torch.zeros((2, 6, 6, 4), dtype=torch.complex64)
    with pytest.raises(ValueError, match="CUDA"):        # then the device check
        p2p.p2p_cuda(ok, ok, ok.real > 0, 0.05)
    with pytest.raises(ValueError, match="CUDA"):
        m2l.m2l_cuda(ok, torch.zeros((8, 4, 4), dtype=torch.complex64))


def test_near_field_pads_only_the_grid_axes():
    rng = np.random.default_rng(9)
    z, q, m = _batch(rng, 8, 4)
    tree = Tree(z=z, q=q, mask=m, level=LEVEL, sigma=0.02)
    out = fmm.near_field(tree)
    assert out.shape == (B, 8, 8, 4)
    for b in range(B):
        one = fmm.near_field(Tree(z=z[b], q=q[b], mask=m[b], level=LEVEL, sigma=0.02))
        assert _rel(out[b], one) <= TOL
    # the padded batch rows of a bucket carry empty masks: their output is 0
    pad = Tree(z=F.pad(z, (0, 0, 0, 0, 0, 0, 0, 1)), q=F.pad(q, (0, 0, 0, 0, 0, 0, 0, 1)),
               mask=F.pad(m, (0, 0, 0, 0, 0, 0, 0, 1)), level=LEVEL, sigma=0.02)
    assert bool((fmm.near_field(pad)[B] == 0).all())
