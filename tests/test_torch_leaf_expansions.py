"""The leaf expansions' kernel (``kernels/leaf_expansions.py`` +
``csrc/leaf_expansions.cu``): the dispatchers, the plain route and the
launch configurations on the CPU; on the card, P2M and L2P against their
plain versions and the launches one evaluation makes.

Tolerances on the card: the kernel forms the same running products as the
plain version's power table, in FP32, but sums a box's slots in another
order and evaluates L2P by Horner's rule instead of a table of powers, so
the two agree to a few FP32 roundings of each of the ``p`` multiply-adds:
rel L2 ``TOL`` = 1e-5 up to p = 17, as the port's other f32 comparisons
of sums taken in another order, and in proportion to p beyond (the
roundings of a product of p factors add up with p).
"""
import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core import equations as eqs
from repro_torch.core import expansions as ex
from repro_torch.core import fmm
from repro_torch.core.quadtree import build_tree
from repro_torch.kernels import leaf_expansions as leaf
from repro_torch.kernels import ops

TOL = 1e-5


def _tol(p: int) -> float:
    return TOL * max(1.0, p / 17)


def _rel(a, b):
    a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()
    return float(torch.linalg.vector_norm(a - b)
                 / max(float(torch.linalg.vector_norm(b)), 1e-30))


def _inputs(lead, ny, nx, s, p, seed, level=6, holes=False, device="cpu"):
    """Leaf boxes of side ``2**-level`` with ``s`` slots: particles inside
    their boxes, complex charges, empty slots holding z = 0 and random q
    (which must be ignored), and random LEs.  ``holes``: the slots filled as
    a prefix, then about a quarter of the live ones emptied again; else
    about a third of the slots empty anywhere."""
    rng = np.random.default_rng(seed)
    r = 2.0 ** -level
    iy, ix = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    cen = ((ix + 0.5) * r + 1j * (iy + 0.5) * r).astype(np.complex64)
    shape = tuple(lead) + (ny, nx, s)
    u = rng.uniform(-0.49, 0.49, size=shape + (2,))
    z = cen[..., None] + r * (u[..., 0] + 1j * u[..., 1])
    q = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    if holes:
        count = rng.integers(0, s + 1, size=shape[:-1])
        mask = np.arange(s) < count[..., None]
        mask &= rng.uniform(size=shape) > 0.25
    else:
        mask = rng.uniform(size=shape) > 0.3
    z = np.where(mask, z, 0)
    le_shape = tuple(lead) + (ny, nx, p)
    le = rng.normal(size=le_shape) + 1j * rng.normal(size=le_shape)
    put = lambda a, dt: torch.as_tensor(np.asarray(a).astype(dt), device=device)  # noqa: E731
    return dict(z=put(z, np.complex64), q=put(q, np.complex64),
                mask=torch.as_tensor(mask, device=device), cen=put(cen, np.complex64),
                le=put(le, np.complex64), r=r)


# ---------------------------------------------------------------------------
# The CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stage", ["p2m", "l2p"])
def test_leaf_dispatch_takes_plain_on_cpu(stage):
    """A CPU tensor takes the plain version, bit for bit, and launches
    nothing; ``expansions``' default ``compute`` is the same plain version."""
    d = _inputs((), 6, 5, 7, 9, 0)
    coeff = eqs.LAPLACE.p2m_coeff(9)
    before = (leaf.P2M_LAUNCHES, leaf.L2P_LAUNCHES, ops.PLAIN_CALLS)
    if stage == "p2m":
        got = ops.p2m_apply(d["z"], d["q"], d["mask"], d["cen"], d["r"], 9, coeff)
        want = leaf.p2m_plain(d["z"], d["q"], d["mask"], d["cen"], d["r"], 9, coeff)
        default = ex.p2m(d["z"], d["q"], d["mask"], d["cen"], d["r"], 9, coeff=coeff)
    else:
        modes = ("value", "ngrad")
        got = ops.l2p_apply(d["le"], d["z"], d["cen"], d["r"], 9, modes)
        want = leaf.l2p_plain(d["le"], d["z"], d["cen"], d["r"], 9, modes)
        default = ex.l2p_eval(d["le"], d["z"], d["cen"], d["r"], 9, modes)
    assert (leaf.P2M_LAUNCHES, leaf.L2P_LAUNCHES, ops.PLAIN_CALLS) == before
    assert torch.equal(got, want) and torch.equal(default, want)


@pytest.mark.parametrize("stage", ["p2m", "l2p"])
def test_leaf_plain_route_is_counted_on_cpu(stage):
    """``plain=True`` on CPU tensors runs the plain version and adds one to
    ``ops.PLAIN_CALLS`` a call."""
    d = _inputs((2,), 4, 4, 3, 6, 1)
    p2m = functools.partial(ops.p2m_apply, plain=True)
    l2p = functools.partial(ops.l2p_apply, plain=True)
    ops.PLAIN_CALLS = 0
    if stage == "p2m":
        got = ex.p2m(d["z"], d["q"], d["mask"], d["cen"], d["r"], 6, compute=p2m)
        want = leaf.p2m_plain(d["z"], d["q"], d["mask"], d["cen"], d["r"], 6)
    else:
        got = ex.l2p_eval(d["le"], d["z"], d["cen"], d["r"], 6, compute=l2p)
        want = leaf.l2p_plain(d["le"], d["z"], d["cen"], d["r"], 6)
    assert ops.PLAIN_CALLS == 1
    assert torch.equal(got, want)


def test_fmm_evaluate_plain_counts_both_leaf_stages():
    """``fmm_evaluate(plain=True)`` on the CPU: one P2P, one P2M, one L2P
    and one M2L a level 2..L, all through the plain versions."""
    rng = np.random.default_rng(2)
    tree, _ = build_tree(rng.uniform(0.05, 0.95, (300, 2)), rng.normal(size=300),
                         level=4, sigma=0.02, device="cpu")
    ops.PLAIN_CALLS = 0
    got = fmm.fmm_evaluate(tree, 8, device="cpu", plain=True)
    assert ops.PLAIN_CALLS == 3 + (4 - 1)
    assert torch.equal(got, fmm.fmm_evaluate(tree, 8, device="cpu"))


@pytest.mark.parametrize("stage", ["p2m", "l2p"])
def test_leaf_cuda_rejects_cpu_tensors(stage):
    d = _inputs((), 4, 4, 2, 5, 3)
    with pytest.raises(ValueError, match="CUDA"):
        if stage == "p2m":
            leaf.p2m_cuda(d["z"], d["q"], d["mask"], d["cen"], d["r"], 5)
        else:
            leaf.l2p_cuda(d["le"], d["z"], d["cen"], d["r"], 5)


# every order and slot count the callers ask for: the paper's p = 17 at 8
# slots (4 at the probe grid), the service's buckets (p 6 to 17, 16 and 32
# slots), Laplace's p = 16, the wide jobs' p = 40 and 64 and 512 to 2,048
# slots, a relevel's headroom, and orders and slots on every side of each
# register and stage bound
CALLER_ORDERS = tuple(range(1, 65)) + (96, 128, 512, leaf.MAX_P)
CALLER_SLOTS = tuple(range(1, 257)) + (300, 511, 512, 1000, 1024, 1025, 2048, 4096)


def test_leaf_launch_fits_a_hopper_block():
    """Every P2M and L2P launch of the callers' shapes fits one block:
    threads a multiple of 32 within 1024, the stage within ``P2M_STAGE``
    slots and the coefficients within ``L2P_COEFFS`` (one box past either),
    shared memory that holds what the kernel stages and within 232,448
    bytes; a P2M group is a power of two that divides a warp, and its
    orders the least register tile that holds p (32 in chunks past it)."""
    for s in CALLER_SLOTS:
        for p in CALLER_ORDERS:
            k, g, nbox, sc, threads, smem = leaf.p2m_launch_config(s, p)
            assert threads == leaf.P2M_THREADS and threads % 32 == 0
            assert threads <= leaf.MAX_THREADS
            assert g in (1, 2, 4, 8, 16, 32) and nbox * g == threads
            assert g == 32 or s <= 8 * g, (s, g)
            assert k in leaf.P2M_ORDERS and (p <= k or k == 32)
            assert k == 8 or p > leaf.P2M_ORDERS[leaf.P2M_ORDERS.index(k) - 1]
            assert 1 <= sc <= s and nbox * sc <= leaf.P2M_STAGE
            assert smem >= (2 * nbox * sc + nbox) * 8 and smem >= (nbox * k + nbox) * 8
            assert smem <= 48 * 1024 <= leaf.MAX_SMEM
            nbox, threads, smem = leaf.l2p_launch_config(s, p)
            assert threads == leaf.L2P_THREADS and threads % 32 == 0
            assert nbox >= 1 and (nbox == 1 or (nbox * s <= threads
                                                 and nbox * p <= leaf.L2P_COEFFS))
            assert smem >= nbox * p * 8 and smem <= leaf.MAX_SMEM


def test_leaf_launch_config_at_the_main_paths_shapes():
    """The paper's leaves (8 slots, p = 17): P2M 128 boxes a block, one
    thread each, 24 orders in registers; L2P 32 boxes (256 slots) a block,
    64 at the probe grid's 4 slots; Laplace's p = 16 takes 16 orders."""
    assert leaf.p2m_launch_config(8, 17) == (24, 1, 128, 8, 128, (25 + 1) * 128 * 8)
    assert leaf.l2p_launch_config(8, 17) == (32, 256, 32 * 17 * 8)
    assert leaf.l2p_launch_config(4, 17) == (64, 256, 64 * 17 * 8)
    assert leaf.p2m_launch_config(8, 16)[:3] == (16, 1, 128)
    assert leaf.p2m_launch_config(2048, 64)[:4] == (32, 32, 4, 256)
    for bad in ((0, 17), (8, 0), (8, leaf.MAX_P + 1)):
        with pytest.raises(ValueError):
            leaf.p2m_launch_config(*bad)
        with pytest.raises(ValueError):
            leaf.l2p_launch_config(*bad)


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _check_p2m(d, p, coeff=None, cen=None):
    cen = d["cen"] if cen is None else cen
    before = leaf.P2M_LAUNCHES
    got = ops.p2m_apply(d["z"], d["q"], d["mask"], cen, d["r"], p, coeff)
    torch.cuda.synchronize()
    assert leaf.P2M_LAUNCHES == before + 1
    want = leaf.p2m_plain(d["z"], d["q"], d["mask"], cen, d["r"], p, coeff)
    assert got.shape == want.shape
    assert bool(torch.isfinite(torch.view_as_real(got)).all())
    assert _rel(got, want) < _tol(p)
    return got


def _check_l2p(d, p, modes=("value",), cen=None):
    cen = d["cen"] if cen is None else cen
    before = leaf.L2P_LAUNCHES
    got = ops.l2p_apply(d["le"], d["z"], cen, d["r"], p, modes)
    torch.cuda.synchronize()
    assert leaf.L2P_LAUNCHES == before + 1
    want = leaf.l2p_plain(d["le"], d["z"], cen, d["r"], p, modes)
    assert got.shape == want.shape
    m = d["mask"]                         # the driver masks the empty slots
    got, want = got[m], want[m]
    assert bool(torch.isfinite(torch.view_as_real(got)).all())
    assert _rel(got, want) < _tol(p)


# (name, lead, ny, nx, s, p, level, holes): the main path's shapes, masks
# with holes, leading batch axes
GPU_CASES = [
    ("sources", (), 1024, 1024, 8, 17, 10, False),
    ("probes", (), 1024, 1024, 4, 17, 10, False),
    ("holes", (), 64, 64, 8, 17, 6, True),
    ("holes_ragged", (), 37, 45, 5, 17, 6, True),
    ("batch", (3,), 32, 32, 8, 17, 5, True),
    ("bucket", (8,), 128, 128, 32, 12, 7, True),
    ("two_axes", (2, 2), 16, 16, 8, 17, 4, False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("name,lead,ny,nx,s,p,level,holes", GPU_CASES,
                         ids=[c[0] for c in GPU_CASES])
def test_leaf_kernels_match_plain(cuda, name, lead, ny, nx, s, p, level, holes):
    d = _inputs(lead, ny, nx, s, p, sum(map(ord, name)), level=level, holes=holes,
                device=cuda)
    _check_p2m(d, p)
    _check_l2p(d, p)


# the orders and slot counts of every caller
ORDERS = (8, 12, 16, 17, 40, 64)
SLOTS = (1, 4, 8, 32, 300, 2048)


@pytest.mark.gpu
@pytest.mark.parametrize("p", ORDERS)
@pytest.mark.parametrize("s", SLOTS)
def test_leaf_kernels_match_plain_at_every_order_and_slot_count(cuda, p, s):
    side = max(2, int((65536 // s) ** 0.5))
    d = _inputs((), side, side + 1, s, p, 7 * p + s, device=cuda)
    _check_p2m(d, p)
    _check_l2p(d, p)


@pytest.mark.gpu
@pytest.mark.parametrize("modes", [("value", "ngrad"), ("ngrad", "value"),
                                   ("ngrad",), ("value",)])
@pytest.mark.parametrize("p", [16, 17, 40])
def test_leaf_kernels_laplace_weights_and_modes(cuda, modes, p):
    """Laplace: the per-order weights ``p2m_coeff`` folded into P2M, and
    L2P's two channels in either order, or the derivative alone."""
    d = _inputs((2,), 48, 40, 8, p, p, holes=True, device=cuda)
    _check_p2m(d, p, coeff=eqs.LAPLACE.p2m_coeff(p))
    _check_l2p(d, p, modes)


@pytest.mark.gpu
def test_p2m_kernel_finite_for_empty_boxes_at_depth(cuda):
    """Level 10, p = 17: empty slots hold z = 0, whose zhat^16 overflows
    float32; the kernel, like the plain version, keeps them at zhat = 0, so
    every ME is finite, empty boxes' exactly 0."""
    d = _inputs((), 64, 64, 8, 17, 11, level=10, holes=True, device=cuda)
    off = 0.7 + 0.6j                         # far from the origin, as at depth
    d["mask"][:8] = False                    # empty boxes
    d["z"] = torch.where(d["mask"], d["z"] + off, 0)
    d["cen"] = d["cen"] + off
    got = _check_p2m(d, 17)
    assert bool((got[:8] == 0).all())


@pytest.mark.gpu
def test_leaf_kernels_take_a_centre_slice(cuda):
    """The sharded driver's centres: a tile's slice of the padded centres,
    not contiguous; the kernel reads the slice's own values."""
    d = _inputs((), 24, 20, 8, 17, 5, device=cuda)
    padded = F.pad(d["cen"], (0, 6, 0, 4))
    big = torch.zeros(40, 40, dtype=torch.complex64, device=cuda)
    big[3:3 + padded.shape[0], 5:5 + padded.shape[1]] = padded
    cen = big[3:3 + 24, 5:5 + 20]
    assert not cen.is_contiguous()
    _check_p2m(d, 17, cen=cen)
    _check_l2p(d, 17, ("value", "ngrad"), cen=cen)


@pytest.mark.gpu
def test_leaf_launch_config_is_the_kernels(cuda):
    """``csrc/leaf_expansions.cu`` chooses the launches that
    ``p2m_launch_config`` and ``l2p_launch_config`` give, at every shape
    the callers use."""
    for s in CALLER_SLOTS[::7] + (8, 4, 2048):
        for p in CALLER_ORDERS[::3] + (17, 40, 64):
            leaf.check_launch_config(s, p)


@pytest.mark.gpu
def test_leaf_kernels_are_bit_for_bit_repeatable(cuda):
    d = _inputs((2,), 40, 40, 8, 17, 9, holes=True, device=cuda)
    a = ops.p2m_apply(d["z"], d["q"], d["mask"], d["cen"], d["r"], 17)
    b = ops.p2m_apply(d["z"], d["q"], d["mask"], d["cen"], d["r"], 17)
    assert torch.equal(a, b)
    a = ops.l2p_apply(d["le"], d["z"], d["cen"], d["r"], 17, ("value", "ngrad"))
    b = ops.l2p_apply(d["le"], d["z"], d["cen"], d["r"], 17, ("value", "ngrad"))
    assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("eq", ["vortex", "laplace"])
def test_fmm_evaluate_launches_one_p2m_and_one_l2p(cuda, eq):
    """One evaluation on the card: exactly one P2M and one L2P launch, no
    plain call, and the result within the kernels' tolerance of the CPU's
    plain route."""
    rng = np.random.default_rng(4)
    pos, gamma = rng.uniform(0.05, 0.95, (2000, 2)), rng.normal(size=2000)
    tree, _ = build_tree(pos, gamma, level=5, sigma=0.02, device=cuda)
    cpu, _ = build_tree(pos, gamma, level=5, sigma=0.02, device="cpu")
    before = (leaf.P2M_LAUNCHES, leaf.L2P_LAUNCHES)
    ops.PLAIN_CALLS = 0
    got = fmm.fmm_evaluate(tree, 12, eq=eq, device=cuda)
    torch.cuda.synchronize()
    assert (leaf.P2M_LAUNCHES, leaf.L2P_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert ops.PLAIN_CALLS == 0
    want = fmm.fmm_evaluate(cpu, 12, eq=eq, device="cpu")
    assert _rel(got, want) < 1e-4


@pytest.mark.gpu
def test_leaf_kernels_reject_bad_inputs(cuda):
    d = _inputs((), 4, 4, 3, 6, 0, device=cuda)
    z, q, m, cen, le, r = d["z"], d["q"], d["mask"], d["cen"], d["le"], d["r"]
    with pytest.raises(ValueError, match="complex64"):
        leaf.p2m_cuda(z.to(torch.complex128), q, m, cen, r, 6)
    with pytest.raises(ValueError, match="bool"):
        leaf.p2m_cuda(z, q, m.to(torch.uint8), cen, r, 6)
    with pytest.raises(ValueError, match="contiguous"):
        leaf.p2m_cuda(z.transpose(0, 1), q.transpose(0, 1), m.transpose(0, 1), cen, r, 6)
    with pytest.raises(ValueError, match="match"):
        leaf.p2m_cuda(z, q[:-1].contiguous(), m, cen, r, 6)
    with pytest.raises(ValueError, match="match"):
        leaf.p2m_cuda(z, q, m, cen[:-1], r, 6)
    with pytest.raises(ValueError, match="CUDA"):
        leaf.p2m_cuda(z, q, m, cen.cpu(), r, 6)
    with pytest.raises(ValueError, match="coeff"):
        leaf.p2m_cuda(z, q, m, cen, r, 6, coeff=np.ones(5))
    with pytest.raises(ValueError, match="match"):
        leaf.l2p_cuda(le[..., :5].contiguous(), z, cen, r, 6)
    with pytest.raises(ValueError, match="CUDA"):
        leaf.l2p_cuda(le.cpu(), z, cen, r, 6)
    with pytest.raises(ValueError, match="unknown l2p mode"):
        leaf.l2p_cuda(le, z, cen, r, 6, ("value", "grad"))
    with pytest.raises(ValueError, match="channels"):
        leaf.l2p_cuda(le, z, cen, r, 6, ("value", "ngrad", "value"))
