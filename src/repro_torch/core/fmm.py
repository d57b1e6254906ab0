"""Serial dense FMM driver.

Mirrors the paper's bird's-eye view (Fig 2): upward sweep (P2M, M2M),
downward sweep (M2L, L2L), evaluation (L2P + near-field P2P), all on dense
level grids.  M2L and P2P go through one slab-oriented path each
(``m2l_slab_fn`` / ``p2p_slab_fn``), P2M and L2P through
``ops.p2m_apply`` / ``ops.l2p_apply``, all of which dispatch by device:
the CUDA kernels on the card, their plain PyTorch versions on the CPU.

Every kernel-specific piece comes from an
:class:`~repro_torch.core.equations.EquationSpec`; the drivers never branch
on an equation's name.  ``fmm_velocity`` is the vortex-kernel wrapper over
the generic ``fmm_evaluate``; passing ``targets`` evaluates the sources'
field at a separate batch of passive target points (the ``tracer`` mode).

The serial driver also takes a tree whose arrays carry a leading batch
axis, ``(B, n, n, s)``: B independent evaluations at one level, one P2P
launch and one M2L launch per level 2..L for the whole batch (the serving
engine's bucket of jobs, what ``vmap`` of the reference driver computes).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .. import spans
from ..configs.backend import check_finite, check_on, resolve_device
from ..kernels import ops as kops
from . import equations as eqs
from . import expansions as ex
from . import health as hw
from .quadtree import P2P_OFFSETS, Tree, box_centers, box_size


# ---------------------------------------------------------------------------
# Slab dispatchers — the one M2L / P2P path.
# ---------------------------------------------------------------------------


def m2l_slab_fn(p: int, eq=None, plain: bool = False):
    """Returns ``fn(me_halo, level, row0=0, halo=M2L_HALO, col0=0,
    col_halo=0) -> le_slab``: the parity-folded M2L (exactly 27
    interactions per box) with the spec's operator and scale, through the
    CUDA kernel for CUDA tensors (its plain version with ``plain``, CPU
    tensors only)."""
    eq = eqs.get_equation(eq)

    def fn(me_halo, level, row0=0, halo=ex.M2L_HALO, col0=0, col_halo=0):
        return kops.m2l_apply_slab(me_halo, level, p, row0=row0, halo=halo,
                                   col0=col0, col_halo=col_halo, eq=eq,
                                   plain=plain)
    return fn


def m2l_grid_fn(p: int, eq=None, plain: bool = False):
    """Grid form of ``m2l_slab_fn``: ``fn(grid, level)`` over a full
    (ny, nx, p) level grid, zero ghost rows attached by ``ops.m2l_apply``."""
    eq = eqs.get_equation(eq)

    def fn(grid, level):
        return kops.m2l_apply(grid, level, p, eq=eq, plain=plain)
    return fn


def p2p_slab_reference(z_halo, q_halo, mask_halo, sigma, z_tgt=None,
                       eq=None):
    """Plain P2P over a slab with ±1 ghost rows/cols attached, through the
    spec's :meth:`pairwise` (the complex-division form for the vortex
    kernel) — a second route beside the kernel's plain version, and the
    only one for a spec whose formula the kernel lacks.  ``z_tgt``
    ([B,] rows, cols, st) evaluates the sources' field at separate target
    points; None keeps source == target."""
    eq = eqs.get_equation(eq)
    rows, cols = z_halo.shape[-3] - 2, z_halo.shape[-2] - 2
    zt = z_halo[..., 1:1 + rows, 1:1 + cols, :] if z_tgt is None else z_tgt
    out = None
    for (dx, dy) in P2P_OFFSETS:
        window = (..., slice(1 + dy, 1 + dy + rows), slice(1 + dx, 1 + dx + cols),
                  slice(None))
        w = eq.pairwise(zt, z_halo[window], q_halo[window], mask_halo[window],
                        sigma)
        out = w if out is None else out + w
    return out


def p2p_slab_fn(eq=None, plain: bool = False):
    """Returns ``fn(z_halo, q_halo, mask_halo, sigma, z_tgt=None,
    mask_tgt=None) -> w`` over a slab with ±1 ghost rows/cols attached,
    through the CUDA kernel for CUDA tensors (its plain version with
    ``plain``, CPU tensors only); ``z_tgt``/``mask_tgt`` select passive-target evaluation."""
    eq = eqs.get_equation(eq)

    def fn(z_halo, q_halo, mask_halo, sigma, z_tgt=None, mask_tgt=None):
        return kops.p2p_apply_slab(z_halo, q_halo, mask_halo, sigma,
                                   z_tgt=z_tgt, mask_tgt=mask_tgt, eq=eq,
                                   plain=plain)
    return fn


# ---------------------------------------------------------------------------
# Interior/rim overlapped tile execution (the sharded driver's).
#
# A padded rank tile is split into an INTERIOR (every box at least one halo
# width from each tile edge, whose stencil reads only local data) and four
# RIM strips along the edges, whose stencils read the exchanged ghost
# buffer.  The interior is launched before the buffer is asked for, so an
# exchange in flight overlaps it; the rims are stitched over the edges.
# Strips cut from a buffer are views: a row strip is contiguous but starts
# inside the buffer, off the 16-byte boundary the P2P kernel needs, so every
# strip is copied into a fresh allocation here.
# ---------------------------------------------------------------------------


def _resolve(buf):
    """A halo buffer, or a zero-argument function that waits for it."""
    return buf() if callable(buf) else buf


def _fresh(view: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``view`` in a new (aligned) allocation."""
    return view.clone(memory_format=torch.contiguous_format)


def m2l_tile_overlapped(m2l_slab, me_local: torch.Tensor, me_buf, level: int,
                        rows_valid: int, cols_valid: int) -> torch.Tensor:
    """Interior/rim M2L over one padded tile.

    ``me_local`` is the (rmax, cmax, p) padded tile (padding is zero);
    ``me_buf`` the (rmax+2w, cmax+2w, p) two-axis halo buffer
    (w = ``expansions.M2L_HALO``) with the neighbours' data adjacent to the
    valid extents, or a function returning it, called after the interior's
    launch.  Tile origins and extents are parity-even at every sharded
    level, so ``row0=col0=0`` anchors every slice.  Returns the
    (rmax, cmax, p) LE tile; boxes outside the valid extents hold
    don't-care values, masked out downstream.
    """
    w = ex.M2L_HALO
    rmax, cmax, p = me_local.shape
    le = torch.zeros_like(me_local)
    if rmax > 2 * w and cmax > 2 * w:
        le[w:rmax - w, w:cmax - w] = m2l_slab(me_local, level, halo=w,
                                              col_halo=w)
    buf = _resolve(me_buf)

    def strip(r0, c0, nr, nc):
        return m2l_slab(_fresh(buf[r0:r0 + nr, c0:c0 + nc]), level,
                        halo=w, col_halo=w)

    top = strip(0, 0, 3 * w, cmax + 2 * w)                      # (w, cmax)
    bot = strip(rows_valid - w, 0, 3 * w, cmax + 2 * w)         # (w, cmax)
    left = strip(0, 0, rmax + 2 * w, 3 * w)                     # (rmax, w)
    right = strip(0, cols_valid - w, rmax + 2 * w, 3 * w)       # (rmax, w)
    le[:, :w] = left
    le[:, cols_valid - w:cols_valid] = right
    le[:w] = top
    le[rows_valid - w:rows_valid] = bot
    return le


def p2p_tile_overlapped(p2p_slab, z, q, mask, bufs, rows_valid: int,
                        cols_valid: int, sigma, z_tgt=None,
                        mask_tgt=None) -> torch.Tensor:
    """Interior/rim P2P over one padded tile (halo width 1).

    ``z/q/mask`` are the (rmax, cmax, s) local tile; ``bufs`` the exchanged
    ``(z_buf, q_buf, m_buf)``, each (rmax+2, cmax+2, s), or a function
    returning them, called after the interior's launch.  The interior reads
    the local tile as its own ±1 halo, the four rim strips read the
    buffers.  ``z_tgt``/``mask_tgt`` (rmax, cmax, st) are passive targets,
    tile-local: the split then partitions the target boxes.  Returns the
    (rmax, cmax, s|st[, C]) output tile.
    """
    rmax, cmax, s = z.shape

    def tgt(r0, c0, nr, nc):
        if z_tgt is None:
            return None, None
        return (_fresh(z_tgt[r0:r0 + nr, c0:c0 + nc]),
                _fresh(mask_tgt[r0:r0 + nr, c0:c0 + nc]))

    wout = None
    if rmax > 2 and cmax > 2:
        interior = p2p_slab(z, q, mask, sigma, *tgt(1, 1, rmax - 2, cmax - 2))
        wout = interior.new_zeros((rmax, cmax) + tuple(interior.shape[2:]))
        wout[1:rmax - 1, 1:cmax - 1] = interior
    z_buf, q_buf, m_buf = _resolve(bufs)

    def strip(r0, c0, nr, nc, tr0, tc0, tnr, tnc):
        cut = lambda a: _fresh(a[r0:r0 + nr, c0:c0 + nc])  # noqa: E731
        return p2p_slab(cut(z_buf), cut(q_buf), cut(m_buf), sigma,
                        *tgt(tr0, tc0, tnr, tnc))

    west = strip(0, 0, rmax + 2, 3, 0, 0, rmax, 1)                   # (rmax, 1)
    if wout is None:
        wout = west.new_zeros((rmax, cmax) + tuple(west.shape[2:]))
    wout[:, :1] = west
    wout[:, cols_valid - 1:cols_valid] = strip(
        0, cols_valid - 1, rmax + 2, 3, 0, cols_valid - 1, rmax, 1)
    wout[:1] = strip(0, 0, 3, cmax + 2, 0, 0, 1, cmax)                # (1, cmax)
    wout[rows_valid - 1:rows_valid] = strip(
        rows_valid - 1, 0, 3, cmax + 2, rows_valid - 1, 0, 1, cmax)
    return wout


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _centers_on(level: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(box_centers(level), dtype=torch.complex64,
                           device=device)


def upward_sweep(tree: Tree, p: int, eq=None,
                 plain: bool = False) -> list[torch.Tensor]:
    """Build normalized MEs for every level; returns me[l] for l=0..L,
    each ([B,] 2**l, 2**l, p).  P2M runs through the CUDA kernel for CUDA
    tensors (its plain version with ``plain``, CPU tensors only)."""
    eq = eqs.get_equation(eq)
    L = tree.level
    me = [None] * (L + 1)
    with spans.span("fmm.p2m", tree.device):
        me[L] = ex.p2m(tree.z, tree.q, tree.mask, _centers_on(L, tree.device),
                       box_size(L), p, coeff=eq.p2m_coeff(p),
                       compute=functools.partial(kops.p2m_apply, plain=plain))
    with spans.span("fmm.m2m"):
        mop = ex.device_operator(eq.m2m_operator, p, tree.device)
        for l in range(L, 0, -1):
            me[l - 1] = ex.m2m(me[l], p, op=mop)
    return me


def downward_sweep(me: list[torch.Tensor], p: int,
                   m2l_fn=None) -> list[torch.Tensor]:
    """Build LEs for levels 2..L (levels 0-1 have empty interaction lists).

    L2L is the plain polynomial recentering of the local expansion; the
    equation specifics live in ``m2l_fn`` (built by ``m2l_grid_fn``).
    """
    L = len(me) - 1
    m2l = m2l_fn or m2l_grid_fn(p)
    le = [None] * (L + 1)
    for l in range(2, L + 1):
        with spans.span("fmm.m2l", level=l):
            le[l] = m2l(me[l], l)
        if l > 2:
            with spans.span("fmm.l2l", level=l):
                le[l] = le[l] + ex.l2l(le[l - 1], p)
    return le


def near_field(tree: Tree, p2p_fn=None, z_tgt=None,
               mask_tgt=None) -> torch.Tensor:
    """P2P over the 3x3 stencil (the tree's sigma; None is singular).

    ``z_tgt``/``mask_tgt`` ([B,] n, n, st) evaluate at passive targets
    instead of the sources.  Returns ([B,] n, n, s|st[, C]).
    """
    slab = p2p_fn or p2p_slab_fn()
    pad = (0, 0, 1, 1, 1, 1)
    with spans.span("p2p.stage", tree.device):
        halo = F.pad(tree.z, pad), F.pad(tree.q, pad), F.pad(tree.mask, pad)
    return slab(*halo, tree.sigma, z_tgt, mask_tgt)


def _mask_channels(mask, out):
    """Zero masked slots, broadcasting over trailing output channels."""
    m = mask if out.ndim == mask.ndim else mask[..., None]
    return torch.where(m, out, 0)


@spans.traced("fmm.evaluate")
def fmm_evaluate(tree: Tree, p: int, eq=None, targets: Tree | None = None,
                 with_health: bool = False, device=None, plain: bool = False):
    """Complete FMM evaluation of a registered equation.

    Returns (n, n, s) complex for single-channel equations, or
    (n, n, s, eq.nout) in the spec's channel order (Laplace: potential,
    field).  ``targets``, a second :class:`Tree` at the same level holding
    passive target points (charges ignored), switches to source != target
    evaluation: the output is per target slot, (n, n, st[, C]).  Trees
    whose arrays carry a leading batch axis B (``targets`` with the same B)
    evaluate B systems at once, each as it would alone, with one P2P and
    one M2L launch per level for the batch; the output leads with B.
    ``device`` (None: the CUDA card) must hold both trees.
    ``with_health=True`` additionally returns a ``health.N_FIELDS`` int32
    health word (non-finite sentinels on the leaf expansion coefficients
    and the masked output), as ``(out, health)``.  ``plain=True`` runs
    P2P, M2L, P2M and L2P through the kernels' plain versions (the
    stepper's ``reference`` rung) and raises on the card.
    """
    eq = eqs.get_equation(eq)
    if targets is None and eq.needs_targets:
        raise ValueError(f"equation {eq.name!r} requires a targets tree")
    if targets is not None and targets.level != tree.level:
        raise ValueError("targets tree level != source tree level")
    if targets is not None and targets.z.shape[:-3] != tree.z.shape[:-3]:
        raise ValueError(f"targets batch {tuple(targets.z.shape[:-3])} != "
                         f"sources batch {tuple(tree.z.shape[:-3])}")
    dev = resolve_device(device)
    check_on(dev, tree.z, tree.q, tree.mask)
    if targets is not None:
        check_on(dev, targets.z, targets.mask)
    if eq.q_is_real:
        # real-charge equations read only Re q, as the reference does
        tree = Tree(z=tree.z, q=torch.complex(tree.q.real,
                                              torch.zeros_like(tree.q.real)),
                    mask=tree.mask, level=tree.level, sigma=tree.sigma)
    L = tree.level
    p2p = p2p_slab_fn(eq, plain=plain)
    zt = None if targets is None else targets.z
    mt = None if targets is None else targets.mask
    out_mask = tree.mask if targets is None else targets.mask
    if L < 2:
        # Tiny trees are all near field.
        out = _mask_channels(out_mask, near_field(tree, p2p, zt, mt))
        check_finite("p2p", out)
        if not with_health:
            return out
        return out, hw.with_flag(hw.empty(tree.device), hw.F_VEL,
                                 hw.nonfinite(out, out_mask))
    me = upward_sweep(tree, p, eq, plain=plain)
    check_finite("upward_sweep", *me)
    le = downward_sweep(me, p, m2l_fn=m2l_grid_fn(p, eq, plain=plain))
    check_finite("downward_sweep", *le[2:])
    with spans.span("fmm.l2p", dev):
        far = ex.l2p_eval(le[L], tree.z if zt is None else zt,
                          _centers_on(L, tree.device), box_size(L), p, eq.l2p_modes,
                          compute=functools.partial(kops.l2p_apply, plain=plain))
    check_finite("l2p", far)
    with spans.span("fmm.p2p"):
        near = near_field(tree, p2p, zt, mt)
    check_finite("p2p", near)
    out = _mask_channels(out_mask, far + near)
    if not with_health:
        return out
    with spans.span("fmm.health"):
        health = hw.empty(tree.device)
        health = hw.with_flag(health, hw.F_COEFF,
                              torch.maximum(hw.nonfinite(me[L]),
                                            hw.nonfinite(le[L])))
        health = hw.with_flag(health, hw.F_VEL, hw.nonfinite(out, out_mask))
    return out, health


def fmm_velocity(tree: Tree, p: int, with_health: bool = False, device=None,
                 plain: bool = False):
    """Complex velocity W = u - iv per slot — the vortex-kernel form of
    :func:`fmm_evaluate`."""
    return fmm_evaluate(tree, p, eq=eqs.VORTEX, with_health=with_health,
                        device=device, plain=plain)


def fmm_velocity_singular(tree: Tree, p: int, device=None) -> torch.Tensor:
    """FMM with the singular kernel also in the near field.

    Isolates pure series-truncation error: compared against a singular
    direct sum it measures the p-convergence of the expansions alone.
    """
    sing = Tree(z=tree.z, q=tree.q, mask=tree.mask, level=tree.level,
                sigma=None)
    return fmm_velocity(sing, p, device=device)


def flops_estimate(tree_level: int, slots: int, p: int, eq=None) -> dict:
    """Rough FLOP census per stage of the serial driver.

    The M2L term counts the 27 (p x p) apply-accumulates per box that the
    parity-folded contraction performs as valid interactions.  P2P and L2P
    scale with the output arity ``eq.nout``.
    """
    eq = eqs.get_equation(eq)
    L, s, C = tree_level, slots, eq.nout
    nleaf = 4 ** L
    cmul = 6.0  # complex multiply-add ~ 6 real flops
    stages = {
        "p2m": nleaf * s * p * 2 * cmul,
        "m2m": sum(4 ** l for l in range(1, L + 1)) * p * p * cmul,
        "m2l": sum(4 ** l for l in range(2, L + 1)) * 27 * p * p * cmul,
        "l2l": sum(4 ** l for l in range(3, L + 1)) * p * p * cmul,
        "l2p": nleaf * s * p * 2 * cmul * C,
        "p2p": nleaf * 9 * s * s * 12.0 * C,
    }
    stages["total"] = sum(stages.values())
    return stages
