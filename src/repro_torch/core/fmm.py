"""Serial dense FMM driver.

Mirrors the paper's bird's-eye view (Fig 2): upward sweep (P2M, M2M),
downward sweep (M2L, L2L), evaluation (L2P + near-field P2P), all on dense
level grids.  M2L and P2P go through one slab-oriented path each
(``m2l_slab_fn`` / ``p2p_slab_fn``), which dispatch by device: the CUDA
kernels on the card, their plain PyTorch versions on the CPU.

Every kernel-specific piece comes from an
:class:`~repro_torch.core.equations.EquationSpec`; the drivers never branch
on an equation's name.  ``fmm_velocity`` is the vortex-kernel wrapper over
the generic ``fmm_evaluate``; passing ``targets`` evaluates the sources'
field at a separate batch of passive target points (the ``tracer`` mode).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..configs.backend import check_on, resolve_device
from ..kernels import ops as kops
from . import equations as eqs
from . import expansions as ex
from . import health as hw
from .quadtree import P2P_OFFSETS, Tree, box_centers, box_size


# ---------------------------------------------------------------------------
# Slab dispatchers — the one M2L / P2P path.
# ---------------------------------------------------------------------------


def m2l_slab_fn(p: int, eq=None):
    """Returns ``fn(me_halo, level, row0=0, halo=M2L_HALO, col0=0,
    col_halo=0) -> le_slab``: the parity-folded M2L (exactly 27
    interactions per box) with the spec's operator and scale, through the
    CUDA kernel for CUDA tensors."""
    eq = eqs.get_equation(eq)

    def fn(me_halo, level, row0=0, halo=ex.M2L_HALO, col0=0, col_halo=0):
        return kops.m2l_apply_slab(me_halo, level, p, row0=row0, halo=halo,
                                   col0=col0, col_halo=col_halo, eq=eq)
    return fn


def m2l_grid_fn(p: int, eq=None):
    """Grid form of ``m2l_slab_fn``: ``fn(grid, level)`` over a full
    (ny, nx, p) level grid, zero ghost rows attached by ``ops.m2l_apply``."""
    eq = eqs.get_equation(eq)

    def fn(grid, level):
        return kops.m2l_apply(grid, level, p, eq=eq)
    return fn


def p2p_slab_reference(z_halo, q_halo, mask_halo, sigma, z_tgt=None,
                       eq=None):
    """Plain P2P over a slab with ±1 ghost rows/cols attached, through the
    spec's :meth:`pairwise` (the complex-division form for the vortex
    kernel) — a second route beside the kernel's plain version, and the
    only one for a spec whose formula the kernel lacks.  ``z_tgt``
    (rows, cols, st) evaluates the sources' field at separate target
    points; None keeps source == target."""
    eq = eqs.get_equation(eq)
    rows, cols = z_halo.shape[0] - 2, z_halo.shape[1] - 2
    zt = z_halo[1:1 + rows, 1:1 + cols] if z_tgt is None else z_tgt
    out = None
    for (dx, dy) in P2P_OFFSETS:
        zs = z_halo[1 + dy:1 + dy + rows, 1 + dx:1 + dx + cols]
        qs = q_halo[1 + dy:1 + dy + rows, 1 + dx:1 + dx + cols]
        ms = mask_halo[1 + dy:1 + dy + rows, 1 + dx:1 + dx + cols]
        w = eq.pairwise(zt, zs, qs, ms, sigma)
        out = w if out is None else out + w
    return out


def p2p_slab_fn(eq=None):
    """Returns ``fn(z_halo, q_halo, mask_halo, sigma, z_tgt=None,
    mask_tgt=None) -> w`` over a slab with ±1 ghost rows/cols attached,
    through the CUDA kernel for CUDA tensors; ``z_tgt``/``mask_tgt``
    select passive-target evaluation."""
    eq = eqs.get_equation(eq)

    def fn(z_halo, q_halo, mask_halo, sigma, z_tgt=None, mask_tgt=None):
        return kops.p2p_apply_slab(z_halo, q_halo, mask_halo, sigma,
                                   z_tgt=z_tgt, mask_tgt=mask_tgt, eq=eq)
    return fn


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _centers_on(level: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(box_centers(level), dtype=torch.complex64,
                           device=device)


def upward_sweep(tree: Tree, p: int, eq=None) -> list[torch.Tensor]:
    """Build normalized MEs for every level; returns me[l] for l=0..L."""
    eq = eqs.get_equation(eq)
    L = tree.level
    me = [None] * (L + 1)
    me[L] = ex.p2m(tree.z, tree.q, tree.mask, _centers_on(L, tree.device),
                   box_size(L), p, coeff=eq.p2m_coeff(p))
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
        le[l] = m2l(me[l], l)
        if l > 2:
            le[l] = le[l] + ex.l2l(le[l - 1], p)
    return le


def near_field(tree: Tree, p2p_fn=None, z_tgt=None,
               mask_tgt=None) -> torch.Tensor:
    """P2P over the 3x3 stencil (the tree's sigma; None is singular).

    ``z_tgt``/``mask_tgt`` (n, n, st) evaluate at passive targets instead
    of the sources.  Returns (n, n, s|st[, C]).
    """
    slab = p2p_fn or p2p_slab_fn()
    pad = (0, 0, 1, 1, 1, 1)
    return slab(F.pad(tree.z, pad), F.pad(tree.q, pad), F.pad(tree.mask, pad),
                tree.sigma, z_tgt, mask_tgt)


def _mask_channels(mask, out):
    """Zero masked slots, broadcasting over trailing output channels."""
    m = mask if out.ndim == mask.ndim else mask[..., None]
    return torch.where(m, out, 0)


def fmm_evaluate(tree: Tree, p: int, eq=None, targets: Tree | None = None,
                 with_health: bool = False, device=None):
    """Complete FMM evaluation of a registered equation.

    Returns (n, n, s) complex for single-channel equations, or
    (n, n, s, eq.nout) in the spec's channel order (Laplace: potential,
    field).  ``targets``, a second :class:`Tree` at the same level holding
    passive target points (charges ignored), switches to source != target
    evaluation: the output is per target slot, (n, n, st[, C]).
    ``device`` (None: the CUDA card) must hold both trees.
    ``with_health=True`` additionally returns a ``health.N_FIELDS`` int32
    health word (non-finite sentinels on the leaf expansion coefficients
    and the masked output), as ``(out, health)``.
    """
    eq = eqs.get_equation(eq)
    if targets is None and eq.needs_targets:
        raise ValueError(f"equation {eq.name!r} requires a targets tree")
    if targets is not None and targets.level != tree.level:
        raise ValueError("targets tree level != source tree level")
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
    p2p = p2p_slab_fn(eq)
    zt = None if targets is None else targets.z
    mt = None if targets is None else targets.mask
    out_mask = tree.mask if targets is None else targets.mask
    if L < 2:
        # Tiny trees are all near field.
        out = _mask_channels(out_mask, near_field(tree, p2p, zt, mt))
        if not with_health:
            return out
        return out, hw.with_flag(hw.empty(tree.device), hw.F_VEL,
                                 hw.nonfinite(out, out_mask))
    me = upward_sweep(tree, p, eq)
    le = downward_sweep(me, p, m2l_fn=m2l_grid_fn(p, eq))
    far = ex.l2p_eval(le[L], tree.z if zt is None else zt,
                      _centers_on(L, tree.device), box_size(L), p, eq.l2p_modes)
    near = near_field(tree, p2p, zt, mt)
    out = _mask_channels(out_mask, far + near)
    if not with_health:
        return out
    health = hw.empty(tree.device)
    health = hw.with_flag(health, hw.F_COEFF,
                          torch.maximum(hw.nonfinite(me[L]),
                                        hw.nonfinite(le[L])))
    health = hw.with_flag(health, hw.F_VEL, hw.nonfinite(out, out_mask))
    return out, health


def fmm_velocity(tree: Tree, p: int, with_health: bool = False, device=None):
    """Complex velocity W = u - iv per slot — the vortex-kernel form of
    :func:`fmm_evaluate`."""
    return fmm_evaluate(tree, p, eq=eqs.VORTEX, with_health=with_health,
                        device=device)


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
