"""The port's kernels: plain versions against the reference's jnp routes on
the CPU, and the CUDA kernels against their plain versions on the card.

The reference's Pallas kernels do not run on the installed jax, so the
plain versions are held to ``fmm.p2p_slab_reference``/``ref.p2p_ref`` and
``expansions.m2l_folded``/``ref.m2l_ref``: f32 sums in another order, so
rel 1e-5.  The ``gpu`` cases decide inside the test whether a card exists;
they import no jax, so ``pytest -m gpu`` runs them where jax is absent.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import expansions as ex
from repro_torch.core.equations import VORTEX
from repro_torch.kernels import m2l, ops, p2p, ref


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _particles(ny, nx, s, seed):
    rng = np.random.default_rng(seed)
    z = (rng.uniform(size=(ny, nx, s)) + 1j * rng.uniform(size=(ny, nx, s))).astype(np.complex64)
    q = (rng.normal(size=(ny, nx, s)) + 1j * rng.normal(size=(ny, nx, s))).astype(np.complex64)
    mask = rng.uniform(size=(ny, nx, s)) > 0.3
    return z, q, mask


def _holed(ny, nx, s, seed):
    """Slots filled as a prefix, as ``rebuild_tree`` fills them, then about a
    quarter of the live slots emptied again (the holes a fault leaves); dead
    slots keep random z and q, which must be ignored."""
    rng = np.random.default_rng(seed)
    z, q, _ = _particles(ny, nx, s, seed)
    fill = rng.integers(0, s + 1, size=(ny, nx, 1))
    mask = (np.arange(s) < fill) & (rng.uniform(size=(ny, nx, s)) > 0.25)
    return z, q, mask


def _halo(*arrays):
    return [np.pad(a, ((1, 1), (1, 1), (0, 0))) for a in arrays]


@pytest.fixture(scope="module")
def jx():
    """The reference package's jnp routes (imported here, not at the top)."""
    import jax.numpy as jnp
    from repro.core import equations, expansions, fmm
    from repro.kernels import ref as jref
    return SimpleNamespace(jnp=jnp, eqs=equations, ex=expansions, fmm=fmm,
                           ref=jref)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# P2P
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ny,nx,s", [(4, 4, 3), (8, 8, 5), (8, 16, 1), (6, 6, 8)])
@pytest.mark.parametrize("sigma", [None, 0.05])
def test_p2p_plain_matches_reference(jx, ny, nx, s, sigma):
    jnp = jx.jnp
    z, q, mask = _particles(ny, nx, s, ny * 100 + nx + s)
    zh, qh, mh = _halo(z, q, mask)
    out = p2p.p2p_plain(torch.as_tensor(zh), torch.as_tensor(qh),
                        torch.as_tensor(mh), sigma).numpy()
    slab = np.asarray(jx.fmm.p2p_slab_reference(jnp.asarray(zh), jnp.asarray(qh),
                                              jnp.asarray(mh), sigma))
    grid = np.asarray(jx.ref.p2p_ref(jnp.asarray(z), jnp.asarray(q),
                                   jnp.asarray(mask), sigma=sigma))
    assert _rel(np.where(mask, out, 0), np.where(mask, slab, 0)) < 1e-5
    assert _rel(np.where(mask, out, 0), np.where(mask, grid, 0)) < 1e-5
    # the port's own second routes agree too
    tref = ref.p2p_ref(torch.as_tensor(z), torch.as_tensor(q),
                       torch.as_tensor(mask), sigma).numpy()
    assert _rel(np.where(mask, tref, 0), np.where(mask, grid, 0)) < 1e-5


@pytest.mark.parametrize("ny,nx,s", [(5, 7, 1), (6, 6, 3), (9, 8, 8), (4, 5, 16)])
@pytest.mark.parametrize("sigma", [None, 0.05])
def test_p2p_plain_matches_reference_on_masks_with_holes(jx, ny, nx, s, sigma):
    """Prefix-filled slots with holes punched in them; the plain version
    writes 0 at every masked target (the reference leaves them don't-care)."""
    jnp = jx.jnp
    zh, qh, mh = _halo(*_holed(ny, nx, s, ny * 1000 + nx * 10 + s))
    out = p2p.p2p_plain(torch.as_tensor(zh), torch.as_tensor(qh),
                        torch.as_tensor(mh), sigma).numpy()
    slab = np.asarray(jx.fmm.p2p_slab_reference(jnp.asarray(zh), jnp.asarray(qh),
                                              jnp.asarray(mh), sigma))
    live = mh[1:-1, 1:-1]
    assert 0 < live.sum() < live.size
    assert _rel(np.where(live, out, 0), np.where(live, slab, 0)) < 1e-5
    assert np.all(out[~live] == 0)


def test_p2p_launch_fits_a_hopper_block():
    """Every slot count the wrapper takes launches within one block's
    232,448 bytes of shared memory and 1024 threads, one thread per halo
    box, with the tile's records sized for every slot live."""
    for s in range(1, p2p.MAX_SLOTS + 1):
        ty, tx, threads, smem = p2p.launch_config(s)
        assert (ty, tx) in p2p.TILES
        assert smem == p2p.smem_bytes(ty, tx, s) <= p2p.MAX_SMEM, s
        assert threads % 32 == 0 and (ty + 2) * (tx + 2) <= threads <= 1024, s
        assert smem >= (ty + 2) * (tx + 2) * s * 16 + ty * tx * s * 8, s


def test_p2p_launch_config_takes_the_large_tile_at_the_papers_slots():
    assert p2p.launch_config(8)[:3] == (16, 16, 352)


def _first_slots_of(tile):
    """The least slot count whose launch takes ``tile``, else None."""
    return next((s for s in range(1, p2p.MAX_SLOTS + 1)
                 if p2p.launch_config(s)[:2] == tile), None)


@pytest.mark.parametrize("tile", p2p.TILES)
def test_p2p_every_tile_is_the_launch_of_some_slot_count(tile):
    assert _first_slots_of(tile) is not None


@pytest.mark.parametrize("s", [0, p2p.MAX_SLOTS + 1])
def test_p2p_launch_config_rejects_slot_counts_out_of_range(s):
    with pytest.raises(ValueError, match="slots"):
        p2p.launch_config(s)


def test_p2p_dispatch_takes_plain_on_cpu():
    z, q, mask = _particles(6, 6, 4, 3)
    zh, qh, mh = (torch.as_tensor(a) for a in _halo(z, q, mask))
    before = p2p.LAUNCHES
    out = ops.p2p_apply_slab(zh, qh, mh, 0.05)
    assert p2p.LAUNCHES == before
    assert torch.equal(out, p2p.p2p_plain(zh, qh, mh, 0.05))


def test_p2p_cuda_rejects_cpu_tensors():
    z, q, mask = _particles(4, 4, 2, 0)
    zh, qh, mh = (torch.as_tensor(a) for a in _halo(z, q, mask))
    with pytest.raises(ValueError, match="CUDA"):
        p2p.p2p_cuda(zh, qh, mh, 0.05)


@pytest.mark.gpu
@pytest.mark.parametrize("ny,nx,s", [(4, 4, 3), (8, 8, 5), (13, 11, 5),
                                     (8, 16, 1), (6, 6, 8), (33, 17, 8)])
@pytest.mark.parametrize("sigma", [None, 0.05])
def test_p2p_kernel_matches_plain(cuda, ny, nx, s, sigma):
    z, q, mask = _particles(ny, nx, s, ny * 100 + nx + s)
    zh, qh, mh = (torch.as_tensor(a, device=cuda) for a in _halo(z, q, mask))
    before = p2p.LAUNCHES
    got = p2p.p2p_cuda(zh, qh, mh, sigma)
    torch.cuda.synchronize()
    assert p2p.LAUNCHES == before + 1
    want = p2p.p2p_plain(zh, qh, mh, sigma)
    m = torch.as_tensor(mask, device=cuda)
    assert _rel(got[m].cpu(), want[m].cpu()) < 1e-5
    assert bool((got[~m] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("ny,nx,s", [(40, 40, 1), (23, 37, 3), (64, 48, 8),
                                     (37, 70, 8), (19, 21, 16)])
@pytest.mark.parametrize("sigma", [None, 0.05])
def test_p2p_kernel_matches_plain_on_masks_with_holes(cuda, ny, nx, s, sigma):
    """Holes in prefix-filled slots, ragged grids (not a multiple of the
    tile), ghost rows and columns that hold live sources (the slab form);
    masked targets get exactly 0."""
    z, q, mask = _holed(ny + 2, nx + 2, s, ny * 7 + nx + s)
    zh, qh, mh = (torch.as_tensor(a, device=cuda) for a in (z, q, mask))
    before = p2p.LAUNCHES
    got = p2p.p2p_cuda(zh, qh, mh, sigma)
    torch.cuda.synchronize()
    assert p2p.LAUNCHES == before + 1
    want = p2p.p2p_plain(zh, qh, mh, sigma)
    live = mh[1:-1, 1:-1]
    assert bool(torch.isfinite(torch.view_as_real(got)).all())
    assert bool((got[~live] == 0).all())
    assert _rel(got.cpu(), want.cpu()) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("tile", p2p.TILES)
def test_p2p_kernel_matches_plain_on_every_tile(cuda, tile):
    """Each tile at the least slot count that takes it, on a grid ragged
    in both directions, with holes in the masks."""
    s = _first_slots_of(tile)
    ny, nx = 2 * tile[0] + 1, 2 * tile[1] + 3
    z, q, mask = _holed(ny + 2, nx + 2, s, s)
    zh, qh, mh = (torch.as_tensor(a, device=cuda) for a in (z, q, mask))
    got = p2p.p2p_cuda(zh, qh, mh, 0.05)
    want = p2p.p2p_plain(zh, qh, mh, 0.05)
    assert bool((got[~mh[1:-1, 1:-1]] == 0).all())
    assert _rel(got.cpu(), want.cpu()) < 1e-5


@pytest.mark.gpu
def test_p2p_kernel_rejects_bad_inputs(cuda):
    z, q, mask = _particles(4, 4, 2, 0)
    zh, qh, mh = (torch.as_tensor(a, device=cuda) for a in _halo(z, q, mask))
    with pytest.raises(ValueError, match="complex64"):
        p2p.p2p_cuda(zh.to(torch.complex128), qh, mh, 0.05)
    with pytest.raises(ValueError, match="contiguous"):
        p2p.p2p_cuda(zh.transpose(0, 1), qh.transpose(0, 1), mh.transpose(0, 1), 0.05)
    with pytest.raises(ValueError, match="match"):
        p2p.p2p_cuda(zh, qh[:-1].contiguous(), mh, 0.05)


# ---------------------------------------------------------------------------
# P2P's two-channel (Laplace) and passive-target modes
# ---------------------------------------------------------------------------

# (mode, passive): the kernel's formulas and target modes beside the vortex
# kernel at the sources
NEW_MODES = [("laplace", False), ("base", True), ("laplace", True)]
NOUT = {"base": 1, "laplace": 2}


def _targets(ny, nx, st, seed):
    """Passive targets: random points, about a third of the slots masked
    (dead slots keep random z, which must be ignored), and a few probes
    placed on a source to hit the r2 > 0 exclusion."""
    rng = np.random.default_rng(seed)
    zt = (rng.uniform(size=(ny, nx, st)) + 1j * rng.uniform(size=(ny, nx, st))).astype(np.complex64)
    mt = rng.uniform(size=(ny, nx, st)) > 0.3
    return zt, mt


def _mode_inputs(ny, nx, s, st, passive, seed, device="cpu"):
    """Halo'd sources with holes in prefix-filled slots, on a grid whose
    ghost rows and columns hold live sources (the slab form), and passive
    targets or None."""
    zh, qh, mh = _holed(ny + 2, nx + 2, s, seed)
    zt = mt = None
    if passive:
        zt, mt = _targets(ny, nx, st, seed + 1)
        zt[0, 0, 0] = zh[1, 1, 0]          # a probe on a source (if live)
    put = lambda a: None if a is None else torch.as_tensor(a, device=device)  # noqa: E731
    return tuple(put(a) for a in (zh, qh, mh, zt, mt))


def _live(mh, mt, out):
    m = mh[1:-1, 1:-1] if mt is None else mt
    return m if out.ndim == 3 else m[..., None]


@pytest.mark.parametrize("mode,passive", NEW_MODES)
@pytest.mark.parametrize("ny,nx,s,st", [(4, 4, 3, 5), (9, 8, 8, 4), (5, 7, 1, 2),
                                        (6, 6, 8, 8), (4, 5, 16, 3)])
@pytest.mark.parametrize("sigma", [None, 0.05])
def test_p2p_plain_modes_match_reference(jx, mode, passive, ny, nx, s, st, sigma):
    """The plain version's new modes against the reference's
    ``p2p_slab_reference(..., z_tgt=, eq=)``: rel 1e-5 over live targets,
    exact zeros at masked ones, ``st != s`` and ragged grids."""
    jnp = jx.jnp
    zh, qh, mh, zt, mt = _mode_inputs(ny, nx, s, st, passive, ny * 97 + nx + s)
    out = p2p.p2p_plain(zh, qh, mh, sigma, zt, mt, mode).numpy()
    jeq = jx.eqs.LAPLACE if mode == "laplace" else jx.eqs.VORTEX
    want = np.asarray(jx.fmm.p2p_slab_reference(
        jnp.asarray(zh.numpy()), jnp.asarray(qh.numpy()), jnp.asarray(mh.numpy()),
        sigma, z_tgt=None if zt is None else jnp.asarray(zt.numpy()), eq=jeq))
    tgt = (ny, nx, st if passive else s)
    assert out.shape == want.shape == tgt + ((2,) if mode == "laplace" else ())
    live = _live(mh, mt, out).numpy()
    live = np.broadcast_to(live, out.shape)
    assert 0 < live.sum() < live.size
    assert _rel(np.where(live, out, 0), np.where(live, want, 0)) < 1e-5
    assert np.all(out[~live] == 0)


def test_p2p_laplace_plain_channels_are_the_spec_formula():
    """Channel 1 is the field ``-q/dz``: for real charges, minus the vortex
    formula with the same charges."""
    zh, qh, mh, _, _ = _mode_inputs(6, 7, 4, 4, False, 5)
    qh = torch.complex(qh.real, torch.zeros_like(qh.real))
    lap = p2p.p2p_plain(zh, qh, mh, 0.05, mode="laplace")
    vor = p2p.p2p_plain(zh, qh, mh, 0.05)
    assert _rel(lap[..., 1].numpy(), -vor.numpy()) < 1e-6


def test_p2p_launch_fits_a_hopper_block_in_every_mode():
    """Every (s, st, nout) the wrapper takes launches within one block's
    shared memory and threads; the vortex launch at the paper's slots is
    the one the compile-time instance is built for."""
    for nout in (1, 2):
        for s in range(1, p2p.MAX_SLOTS + 1):
            for st in range(1, p2p.MAX_SLOTS + 1):
                ty, tx, threads, smem = p2p.launch_config(s, st, nout)
                assert (ty, tx) in p2p.TILES
                assert smem == p2p.smem_bytes(ty, tx, s, st, nout) <= p2p.MAX_SMEM
                assert threads % 32 == 0 and (ty + 2) * (tx + 2) <= threads <= 1024
                assert smem >= (ty + 2) * (tx + 2) * s * 16 + ty * tx * st * nout * 8
    assert p2p.launch_config(8) == p2p.launch_config(8, 8, 1)
    assert p2p.launch_config(8, 8, 2)[:2] == (8, 16)      # Laplace, paper's slots
    assert p2p.launch_config(8, 4, 1)[:2] == (16, 16)     # probes, 4 a box
    with pytest.raises(ValueError, match="channels"):
        p2p.launch_config(8, 8, 3)
    with pytest.raises(ValueError, match="slots"):
        p2p.launch_config(8, p2p.MAX_SLOTS + 1)


@pytest.mark.parametrize("mode,passive", NEW_MODES)
def test_p2p_dispatch_takes_plain_modes_on_cpu(mode, passive):
    from repro_torch.core import equations as eqs
    zh, qh, mh, zt, mt = _mode_inputs(5, 6, 4, 3, passive, 9)
    eq = eqs.LAPLACE if mode == "laplace" else eqs.TRACER
    before = dict(p2p.LAUNCHES_BY_MODE), p2p.LAUNCHES
    out = ops.p2p_apply_slab(zh, qh, mh, 0.05, z_tgt=zt, mask_tgt=mt, eq=eq)
    assert (dict(p2p.LAUNCHES_BY_MODE), p2p.LAUNCHES) == before
    assert torch.equal(out, p2p.p2p_plain(zh, qh, mh, 0.05, zt, mt, mode))


def _first_shape_of(tile, nout, passive):
    """The least (s, st) whose launch takes ``tile`` in a mode; passive
    targets take st = 2s (at most MAX_SLOTS)."""
    for s in range(1, p2p.MAX_SLOTS + 1):
        st = min(2 * s, p2p.MAX_SLOTS) if passive else s
        if p2p.launch_config(s, st, nout)[:2] == tile:
            return s, st
    return None


@pytest.mark.parametrize("mode,passive", NEW_MODES)
@pytest.mark.parametrize("tile", p2p.TILES)
def test_p2p_every_tile_is_the_launch_of_some_shape_in_every_mode(mode, passive, tile):
    assert _first_shape_of(tile, NOUT[mode], passive) is not None


@pytest.mark.gpu
@pytest.mark.parametrize("mode,passive", NEW_MODES)
@pytest.mark.parametrize("ny,nx,s,st", [(4, 4, 3, 5), (13, 11, 5, 5), (40, 40, 1, 4),
                                        (23, 37, 3, 7), (64, 48, 8, 4),
                                        (37, 70, 8, 8), (19, 21, 16, 2)])
@pytest.mark.parametrize("sigma", [None, 0.05])
def test_p2p_kernel_modes_match_plain(cuda, mode, passive, ny, nx, s, st, sigma):
    """Each new mode of the kernel against its plain version on the card:
    holes in the source masks, masked targets, ragged grids, live ghost
    rows and columns; masked targets get exactly 0."""
    zh, qh, mh, zt, mt = _mode_inputs(ny, nx, s, st, passive, ny * 7 + nx + s, cuda)
    key = mode + ("_passive" if passive else "")
    before, total = p2p.LAUNCHES_BY_MODE[key], p2p.LAUNCHES
    got = p2p.p2p_cuda(zh, qh, mh, sigma, zt, mt, mode)
    torch.cuda.synchronize()
    assert (p2p.LAUNCHES_BY_MODE[key], p2p.LAUNCHES) == (before + 1, total + 1)
    want = p2p.p2p_plain(zh, qh, mh, sigma, zt, mt, mode)
    live = _live(mh, mt, got).expand(got.shape)
    assert bool(torch.isfinite(torch.view_as_real(got)).all())
    assert bool((got[~live] == 0).all())
    assert _rel(got.cpu(), want.cpu()) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("mode,passive", NEW_MODES)
@pytest.mark.parametrize("tile", p2p.TILES)
def test_p2p_kernel_modes_match_plain_on_every_tile(cuda, mode, passive, tile):
    """Each tile at the least shape that takes it in each mode, on a grid
    ragged in both directions, with holes in the masks."""
    s, st = _first_shape_of(tile, NOUT[mode], passive)
    ny, nx = 2 * tile[0] + 1, 2 * tile[1] + 3
    zh, qh, mh, zt, mt = _mode_inputs(ny, nx, s, st, passive, s, cuda)
    assert p2p.launch_config(s, st, NOUT[mode])[:2] == tile
    got = p2p.p2p_cuda(zh, qh, mh, 0.05, zt, mt, mode)
    want = p2p.p2p_plain(zh, qh, mh, 0.05, zt, mt, mode)
    live = _live(mh, mt, got).expand(got.shape)
    assert bool((got[~live] == 0).all())
    assert _rel(got.cpu(), want.cpu()) < 1e-5


@pytest.mark.gpu
def test_p2p_kernel_rejects_bad_mode_inputs(cuda):
    zh, qh, mh, zt, mt = _mode_inputs(4, 4, 2, 3, True, 0, cuda)
    with pytest.raises(ValueError, match="mode"):
        p2p.p2p_cuda(zh, qh, mh, 0.05, mode="stokes")
    with pytest.raises(ValueError, match="together"):
        p2p.p2p_cuda(zh, qh, mh, 0.05, zt, None)
    with pytest.raises(ValueError, match="z_tgt"):
        p2p.p2p_cuda(zh, qh, mh, 0.05, zt[:-1].contiguous(), mt[:-1].contiguous())
    with pytest.raises(ValueError, match="mask_tgt"):
        p2p.p2p_cuda(zh, qh, mh, 0.05, zt, mt[..., :-1].contiguous())
    with pytest.raises(ValueError, match="complex64"):
        p2p.p2p_cuda(zh, qh, mh, 0.05, zt.to(torch.complex128), mt)


# ---------------------------------------------------------------------------
# M2L
# ---------------------------------------------------------------------------


def _me(n, p, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, n, p)) + 1j * rng.normal(size=(n, n, p))).astype(np.complex64)


@pytest.mark.parametrize("level", [2, 3, 4])
@pytest.mark.parametrize("p", [8, 17])
def test_m2l_plain_matches_reference(jx, level, p):
    jnp = jx.jnp
    me = _me(1 << level, p, level * 10 + p)
    me_halo = np.pad(me, ((2, 2), (0, 0), (0, 0)))
    stack, (PR, rs), (PC, cs) = ex.m2l_slab_stack(torch.as_tensor(me_halo), p, 0, 2)
    W = torch.as_tensor(jx.ex.m2l_folded_operator(p), dtype=torch.complex64)
    acc = m2l.m2l_plain(stack, W)
    le = ex.from_parent_planes(acc, p)[rs:rs + (1 << level), cs:cs + (1 << level)]
    le = (le * 2.0 ** level).numpy()
    folded = np.asarray(jx.ex.m2l_folded(jnp.asarray(me_halo), level, p))
    masked = np.asarray(jx.ref.m2l_ref(jnp.asarray(me), level, p))
    assert _rel(le, folded) < 1e-5
    assert _rel(le, masked) < 1e-5
    # the dispatcher takes the same plain path on the CPU, uncounted
    before = m2l.LAUNCHES
    assert _rel(ops.m2l_apply(torch.as_tensor(me), level, p).numpy(), folded) < 1e-5
    assert m2l.LAUNCHES == before


def test_m2l_cuda_rejects_cpu_tensors():
    stack = torch.zeros((4, 4, 32), dtype=torch.complex64)
    W = torch.zeros((8, 32, 32), dtype=torch.complex64)
    with pytest.raises(ValueError, match="CUDA"):
        m2l.m2l_cuda(stack, W)


@pytest.mark.gpu
@pytest.mark.parametrize("PR,PC", [(2, 2), (3, 3), (7, 9), (8, 8), (17, 5), (13, 11)])
@pytest.mark.parametrize("p", [8, 17, 24, 32])   # each register tile of the kernel
def test_m2l_kernel_matches_plain(cuda, PR, PC, p):
    rng = np.random.default_rng(PR * 31 + PC + p)
    K = 4 * p
    stack = torch.as_tensor(rng.normal(size=(PR + 2, PC + 2, K))
                            + 1j * rng.normal(size=(PR + 2, PC + 2, K)),
                            dtype=torch.complex64, device=cuda)
    W = ops.folded_operator(VORTEX, p, 5, cuda)
    before = m2l.LAUNCHES
    got = m2l.m2l_cuda(stack, W)
    torch.cuda.synchronize()
    assert m2l.LAUNCHES == before + 1
    assert _rel(got.cpu(), m2l.m2l_plain(stack, W).cpu()) < 1e-5


@pytest.mark.gpu
def test_m2l_kernel_on_slab_matches_plain_route(cuda):
    """Odd anchors and column ghosts go through the kernel's route too."""
    p, level = 8, 5
    rng = np.random.default_rng(7)
    me_halo = (rng.normal(size=(11 + 6, 9 + 6, p))
               + 1j * rng.normal(size=(11 + 6, 9 + 6, p))).astype(np.complex64)
    args = dict(row0=3, halo=3, col0=5, col_halo=3)
    got = ops.m2l_apply_slab(torch.as_tensor(me_halo, device=cuda), level, p, **args)
    want = ops.m2l_apply_slab(torch.as_tensor(me_halo), level, p, **args)
    assert _rel(got.cpu(), want) < 1e-5


@pytest.mark.gpu
def test_m2l_kernel_rejects_bad_inputs(cuda):
    stack = torch.zeros((4, 4, 32), dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError, match="W must be"):
        m2l.m2l_cuda(stack, torch.zeros((8, 28, 28), dtype=torch.complex64, device=cuda))
    with pytest.raises(ValueError, match="complex64"):
        m2l.m2l_cuda(stack.to(torch.complex128),
                     torch.zeros((8, 32, 32), dtype=torch.complex64, device=cuda))
    big = torch.zeros((4, 4, 4 * 33), dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError, match=f"p <= {m2l.MAX_P}"):
        m2l.m2l_cuda(big, torch.zeros((8, 132, 132), dtype=torch.complex64, device=cuda))


@pytest.mark.gpu
def test_fmm_velocity_kernel_route_matches_plain_route(cuda):
    from repro_torch.core.fmm import fmm_velocity
    from repro_torch.core.quadtree import build_tree
    rng = np.random.default_rng(1)
    pos, gamma = rng.uniform(size=(3000, 2)), rng.normal(size=3000)
    for sigma in (0.01, None):
        t_gpu, _ = build_tree(pos, gamma, level=5, sigma=sigma, device=cuda)
        t_cpu, _ = build_tree(pos, gamma, level=5, sigma=sigma, device="cpu")
        b0, m0 = p2p.LAUNCHES, m2l.LAUNCHES
        got = fmm_velocity(t_gpu, 17)
        torch.cuda.synchronize()
        assert (p2p.LAUNCHES - b0, m2l.LAUNCHES - m0) == (1, 4)
        want = fmm_velocity(t_cpu, 17, device="cpu")
        assert _rel(got.cpu(), want) < 1e-5
