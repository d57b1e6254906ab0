"""2D complex multipole/local expansions and translation operators.

The far-field kernel is the singular complex velocity kernel

    W(z) = sum_j q_j / (z - z_j),        q_j = gamma_j / (2*pi*i).

Multipole expansion (ME) about a box center c with side r:
``W(z) = sum_k a_k / (z - c)^(k+1)``; local expansion (LE):
``W(z) = sum_l b_l (z - c)^l``.  Coefficients are stored scale-normalized,
``ahat_k = a_k r^-k`` and ``bhat_l = b_l r^l``, so every translation
operator is level independent and M2L carries one ``1/r`` scalar.

Parity folding: M2L works at parent granularity.  A level grid is
relayouted into four child-parity planes stacked along the coefficient
axis — a ``(ny/2, nx/2, 4p)`` parent-plane grid — and the 40-offset masked
reduction collapses to 8 shifted products against the ``(8, 4p, 4p)``
parent-neighbor block operator, whose zero blocks are the parity masks.

The operator builders are numpy (complex128) and identical to the
reference package's; the stages are torch functions on dense level grids.
Every stage takes grids with leading batch axes (``(..., n, n, p)``, the
serving engine's bucket of jobs) and box centres that broadcast over them;
without one it computes the same products as with one.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .quadtree import M2L_OFFSETS, M2L_VALIDITY, PARENT_NEIGH8

# Child offsets within a parent, (cy, cx) in {0,1}^2; delta_hat = (c_child -
# c_parent) / r_parent = ((cx - .5)/2, (cy - .5)/2).
CHILD_OFFSETS = [(cy, cx) for cy in range(2) for cx in range(2)]


def _binom_table(n: int) -> np.ndarray:
    c = np.zeros((n, n), dtype=np.float64)
    c[:, 0] = 1.0
    for i in range(1, n):
        for j in range(1, i + 1):
            c[i, j] = c[i - 1, j - 1] + c[i - 1, j]
    return c


@functools.lru_cache(maxsize=None)
def m2m_operator(p: int) -> np.ndarray:
    """(4, p, p) tensor: ahat_parent[m] = sum_k Op[c, m, k] ahat_child[k].

    Op[c, m, k] = C(m, k) * dhat_c^(m-k) * 2^-k   (k <= m), with
    dhat_c = (child center - parent center) / r_parent.
    """
    C = _binom_table(p)
    op = np.zeros((4, p, p), dtype=np.complex128)
    for ci, (cy, cx) in enumerate(CHILD_OFFSETS):
        dhat = ((cx - 0.5) / 2.0) + 1j * ((cy - 0.5) / 2.0)
        for m in range(p):
            for k in range(m + 1):
                op[ci, m, k] = C[m, k] * dhat ** (m - k) * 2.0 ** (-k)
    return op


@functools.lru_cache(maxsize=None)
def l2l_operator(p: int) -> np.ndarray:
    """(4, p, p) tensor: bhat_child[m] = sum_l Op[c, m, l] bhat_parent[l].

    Op[c, m, l] = 2^-m * C(l, m) * dhat_c^(l-m)   (l >= m).
    """
    C = _binom_table(p)
    op = np.zeros((4, p, p), dtype=np.complex128)
    for ci, (cy, cx) in enumerate(CHILD_OFFSETS):
        dhat = ((cx - 0.5) / 2.0) + 1j * ((cy - 0.5) / 2.0)
        for m in range(p):
            for l in range(m, p):
                op[ci, m, l] = 2.0 ** (-m) * C[l, m] * dhat ** (l - m)
    return op


@functools.lru_cache(maxsize=None)
def m2l_operator(p: int) -> np.ndarray:
    """(40, p, p) tensor: bhat_tgt[l] = (1/r) sum_k Op[o, l, k] ahat_src[k].

    For a source at integer offset d = (dx, dy) from the target (in units
    of the level box size), dhat = dx + 1j*dy and
    Op[o, l, k] = (-1)^(k+1) * C(k+l, l) * dhat^-(k+l+1).
    """
    C = _binom_table(2 * p)
    op = np.zeros((len(M2L_OFFSETS), p, p), dtype=np.complex128)
    for oi, (dx, dy) in enumerate(M2L_OFFSETS):
        dhat = float(dx) + 1j * float(dy)
        for l in range(p):
            for k in range(p):
                op[oi, l, k] = (-1.0) ** (k + 1) * C[k + l, l] * dhat ** (-(k + l + 1))
    return op


def fold_operator(base: np.ndarray, p: int) -> np.ndarray:
    """Fold a (40, p, p) child-offset M2L operator ``[o, l, k]`` into the
    (8, 4p, 4p) parent-neighbor block operator.

    ``W[d, s*p + k, c*p + l]`` maps coefficient ``k`` of source child ``s``
    of parent-neighbor ``PARENT_NEIGH8[d]`` to coefficient ``l`` of target
    child ``c`` (children in CHILD_OFFSETS order).  Blocks for
    near-neighbor pairs are structurally zero — the parity masks, folded
    in — so exactly 27 blocks per target child are nonzero.
    """
    idx = {off: i for i, off in enumerate(M2L_OFFSETS)}
    W = np.zeros((8, 4 * p, 4 * p), dtype=np.complex128)
    for di, (Dx, Dy) in enumerate(PARENT_NEIGH8):
        for si, (sy, sx) in enumerate(CHILD_OFFSETS):
            for ci, (py, px) in enumerate(CHILD_OFFSETS):
                d = (2 * Dx + sx - px, 2 * Dy + sy - py)
                if max(abs(d[0]), abs(d[1])) >= 2:
                    W[di, si * p:(si + 1) * p, ci * p:(ci + 1) * p] = base[idx[d]].T
    return W


@functools.lru_cache(maxsize=None)
def m2l_folded_operator(p: int) -> np.ndarray:
    """The velocity kernel's folded block operator (see ``fold_operator``)."""
    return fold_operator(m2l_operator(p), p)


def device_operator(builder, p: int, device: torch.device) -> torch.Tensor:
    """``builder(p)`` as a complex64 tensor, copied to ``device`` once.

    A spec's bound method (``eq.m2m_operator``) is keyed by the spec's
    value and the function: bound methods compare their ``__self__`` by
    identity, so an equal spec built anew would key a second copy."""
    owner = getattr(builder, "__self__", None)
    key = builder if owner is None else (owner, builder.__func__)
    return _device_operator(key, p, device)


@functools.lru_cache(maxsize=None)
def _device_operator(key, p: int, device: torch.device) -> torch.Tensor:
    builder = key if callable(key) else key[1].__get__(key[0])
    return torch.as_tensor(builder(p), dtype=torch.complex64, device=device)


def _as_op(op, default, p: int, device: torch.device) -> torch.Tensor:
    if op is None:
        return device_operator(default, p, device)
    return torch.as_tensor(op, dtype=torch.complex64, device=device)


# ---------------------------------------------------------------------------
# Stage implementations (dense level grids).
# Grids: me / le at level l have shape (..., n, n, p), n = 2**l, row-major
# (iy, ix), with any leading batch axes "...".
# ---------------------------------------------------------------------------


def _powers(zhat: torch.Tensor, p: int) -> torch.Tensor:
    """Stack [zhat^0, ..., zhat^(p-1)] along a new last axis."""
    steps = [torch.ones_like(zhat)]
    for _ in range(p - 1):
        steps.append(steps[-1] * zhat)
    return torch.stack(steps, dim=-1)


def p2m(z: torch.Tensor, q: torch.Tensor, mask: torch.Tensor,
        centers: torch.Tensor, r: float, p: int,
        coeff: np.ndarray | None = None) -> torch.Tensor:
    """Particles -> normalized MEs at the leaf level.  (..., n, n, s) ->
    (..., n, n, p); ``centers`` (n, n) broadcasts over the batch.

    ``coeff`` is an optional (p,) per-order charge map ``c_k``:
    ``ahat_k = c_k sum q zhat^k``; None is the velocity kernel's identity.

    Empty slots get ``zhat = 0``: they hold ``z = 0``, whose ``zhat`` is up
    to ``2**level`` in size, and from level 9 at p=17 its power
    ``zhat**(p-1)`` overflows float32 — the zero charge times inf would
    make the box's ME NaN.
    """
    zhat = torch.where(mask, (z - centers[..., None]) / r, 0)   # (n, n, s)
    pw = _powers(zhat, p)                          # (n, n, s, p)
    me = torch.einsum("...s,...sk->...k", torch.where(mask, q, 0), pw)
    if coeff is not None:
        me = me * torch.as_tensor(coeff, dtype=me.dtype, device=me.device)
    return me


def m2m(me_child: torch.Tensor, p: int, op=None) -> torch.Tensor:
    """Child level grid (..., 2ny, 2nx, p) -> parent grid (..., ny, nx, p).

    ``op`` overrides the (4, p, p) translation tensor (None: the velocity
    kernel's, kept on the device after first use).
    """
    op = _as_op(op, m2m_operator, p, me_child.device)
    lead = me_child.shape[:-3]
    ny, nx = me_child.shape[-3] // 2, me_child.shape[-2] // 2
    c = me_child.reshape(*lead, ny, 2, nx, 2, p)   # [..., py, cy, px, cx, k]
    # CHILD_OFFSETS order is (cy, cx) row-major -> index c = cy*2+cx
    c = c.transpose(-4, -3).reshape(*lead, ny, nx, 4, p)
    return torch.einsum("...ck,cmk->...m", c, op)


def parity_mask(n: int, validity_o: np.ndarray) -> np.ndarray:
    """(n, n) bool mask from a (2, 2) [py, px] parity-validity table."""
    parity = np.arange(n) % 2
    return validity_o[np.ix_(parity, parity)]


def m2l_masked40(me: torch.Tensor, level: int, p: int) -> torch.Tensor:
    """Dense M2L via 40 masked shifted products (the pre-folding form).

    The independent oracle for the parity-folded path: every box computes
    all 40 candidate offsets and the parity masks discard ~1/3 of the
    work afterwards.  Not for the hot path.
    """
    n = me.shape[0]
    r = 2.0 ** (-level)
    ops = device_operator(m2l_operator, p, me.device)
    pad = F.pad(me, (0, 0, 3, 3, 3, 3))
    le = torch.zeros_like(me)
    for oi, (dx, dy) in enumerate(M2L_OFFSETS):
        src = pad[3 + dy:3 + dy + n, 3 + dx:3 + dx + n, :]
        contrib = torch.einsum("yxk,lk->yxl", src, ops[oi])
        m = torch.as_tensor(parity_mask(n, M2L_VALIDITY[oi]), dtype=me.dtype,
                            device=me.device)
        le = le + contrib * m[..., None]
    return le / r


# ---------------------------------------------------------------------------
# Parity-folded M2L (parent granularity) — the hot path.
# ---------------------------------------------------------------------------

M2L_HALO = 2   # child rows/cols of ghost data needed by an even-aligned slab


def to_parent_planes(grid: torch.Tensor, p: int) -> torch.Tensor:
    """(..., 2R, 2C, p) even-aligned child grid -> (..., R, C, 4p) parent
    planes.

    Plane ``c = cy*2 + cx`` (CHILD_OFFSETS order) holds the child with local
    parity (cy, cx); row 0 of ``grid`` must have even global parity.
    """
    lead = grid.shape[:-3]
    R, C = grid.shape[-3] // 2, grid.shape[-2] // 2
    g = grid.reshape(*lead, R, 2, C, 2, p).transpose(-4, -3)
    return g.reshape(*lead, R, C, 4 * p)


def from_parent_planes(stack: torch.Tensor, p: int) -> torch.Tensor:
    """(..., R, C, 4p) parent planes -> (..., 2R, 2C, p) child grid (inverse
    layout)."""
    lead = stack.shape[:-3]
    R, C = stack.shape[-3], stack.shape[-2]
    g = stack.reshape(*lead, R, C, 2, 2, p).transpose(-4, -3)
    return g.reshape(*lead, 2 * R, 2 * C, p)


def m2l_slab_geometry(rows: int, row0: int, halo: int) -> tuple[int, int, int]:
    """Index algebra of the folded M2L slab.

    Returns ``(lo, PR, shift)``: ``lo`` is the local index (into the halo'd
    slab) of the first source child row, ``PR`` the number of parent rows
    covering the interior, ``shift`` the interior's offset within its first
    parent cell.  Raises if ``halo`` ghost rows cannot cover the ±1 parent
    source neighborhood (even-aligned even-length slabs need 2; odd
    alignment or odd length needs 3).
    """
    g0, g1 = row0, row0 + rows - 1
    Ps, Pe = g0 // 2, g1 // 2
    PR = Pe - Ps + 1
    shift = g0 - 2 * Ps
    lo = (2 * Ps - 2) - g0 + halo            # first needed source child row
    hi = (2 * Pe + 3) - g0 + halo            # last needed source child row
    if lo < 0 or hi > rows + 2 * halo - 1:
        raise ValueError(
            f"halo={halo} too small for rows={rows}, row0={row0}: the ±1 "
            f"parent source window needs rows [{lo}, {hi}] of the slab")
    return lo, PR, shift


def m2l_slab_stack(me_halo: torch.Tensor, p: int, row0: int, halo: int,
                   col0: int = 0, col_halo: int = 0
                   ) -> tuple[torch.Tensor, tuple[int, int], tuple[int, int]]:
    """Stage a halo'd slab (or 2-D tile) into the parent-plane layout.

    Slices the ±1-parent source window out of the slab and relayouts it to
    parent planes.  With ``col_halo=0`` the columns span the full (even)
    grid width and the column window is zero-padded here; with
    ``col_halo>0`` the slab carries column ghosts and the same geometry
    algebra runs on the column axis, anchored at ``col0``.  Returns
    ``(stack, (PR, rshift), (PC, cshift))`` with ``stack`` a contiguous
    (..., PR+2, PC+2, 4p) tensor.
    """
    rows = me_halo.shape[-3] - 2 * halo
    lo, PR, rshift = m2l_slab_geometry(rows, row0, halo)
    sub = me_halo[..., lo:lo + 2 * (PR + 2), :, :]
    if col_halo == 0:
        cols = me_halo.shape[-2]
        if cols % 2:
            raise ValueError("M2L slab columns must span the full (even) width")
        sub = F.pad(sub, (0, 0, 2, 2))
        PC, cshift = cols // 2, 0
    else:
        cols = me_halo.shape[-2] - 2 * col_halo
        clo, PC, cshift = m2l_slab_geometry(cols, col0, col_halo)
        sub = sub[..., clo:clo + 2 * (PC + 2), :]
    stack = to_parent_planes(sub, p).contiguous()
    return stack, (PR, rshift), (PC, cshift)


def folded_contract(stack: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """The folded M2L contraction: (..., PR+2, PC+2, 4p) parent planes
    against the (8, 4p, 4p) block operator -> (..., PR, PC, 4p), unscaled.

    ``acc[y, x] = sum_d stack[1 + Dy + y, 1 + Dx + x] @ W[d]`` over the 8
    ``PARENT_NEIGH8`` offsets.
    """
    PR, PC = stack.shape[-3] - 2, stack.shape[-2] - 2
    acc = torch.zeros(stack.shape[:-3] + (PR, PC, stack.shape[-1]),
                      dtype=stack.dtype, device=stack.device)
    for d, (Dx, Dy) in enumerate(PARENT_NEIGH8):
        acc = acc + stack[..., 1 + Dy:1 + Dy + PR, 1 + Dx:1 + Dx + PC, :] @ W[d]
    return acc


def m2l_folded(me_halo: torch.Tensor, level: int, p: int, row0: int = 0,
               halo: int = M2L_HALO, col0: int = 0, col_halo: int = 0,
               op=None, scale: float | None = None,
               contract=folded_contract) -> torch.Tensor:
    """Parity-folded M2L over a slab/tile with ghost data attached.

    ``me_halo``: (..., rows + 2*halo, cols + 2*col_halo, p) — the interior plus
    ``halo`` ghost rows above and below and ``col_halo`` ghost columns
    left and right (zeros at domain edges).  ``row0``/``col0`` are the
    global indices of the first interior row/column and anchor the parity
    pattern.  Returns the (..., rows, cols, p) LE slab.

    ``op``/``scale`` override the folded block operator and the dimension
    scalar (defaults: the velocity kernel's).  ``contract`` computes the
    stack-by-operator contraction: the plain ``folded_contract`` here, the
    CUDA kernel's dispatcher in ``kernels/ops.py``.
    """
    rows = me_halo.shape[-3] - 2 * halo
    cols = me_halo.shape[-2] - 2 * col_halo
    stack, (PR, rshift), (PC, cshift) = m2l_slab_stack(me_halo, p, row0, halo,
                                                       col0, col_halo)
    W = _as_op(op, m2l_folded_operator, p, me_halo.device)
    if scale is None:
        scale = float(2.0 ** level)          # 1 / box_size(level), exact
    le = from_parent_planes(contract(stack, W), p)        # (..., 2PR, 2PC, p)
    le = le[..., rshift:rshift + rows, cshift:cshift + cols, :]
    return le * scale


def l2l(le_parent: torch.Tensor, p: int, op=None) -> torch.Tensor:
    """Parent grid (..., ny, nx, p) -> child grid (..., 2ny, 2nx, p)."""
    op = _as_op(op, l2l_operator, p, le_parent.device)
    lead = le_parent.shape[:-3]
    ny, nx = le_parent.shape[-3], le_parent.shape[-2]
    c = torch.einsum("...l,cml->...cm", le_parent, op)  # (..., ny, nx, 4, m)
    c = c.reshape(*lead, ny, nx, 2, 2, p).transpose(-4, -3)
    return c.reshape(*lead, 2 * ny, 2 * nx, p)


def l2p_eval(le: torch.Tensor, z: torch.Tensor, centers: torch.Tensor,
             r: float, p: int, modes: tuple[str, ...] = ("value",)
             ) -> torch.Tensor:
    """Evaluate leaf LEs at particle positions, per channel.

    ``modes`` entries each emit one complex channel: ``"value"`` is the LE
    polynomial itself (the velocity for the vortex kernel) and ``"ngrad"``
    its negated z-derivative ``-(1/r) sum_l l bhat_l zhat^(l-1)``.
    ``le`` (..., n, n, p) and ``z`` (..., n, n, s) share their leading
    batch axes; ``centers`` (n, n) broadcasts over them.  Returns
    (..., n, n, s) for one mode, (..., n, n, s, len(modes)) otherwise.
    """
    zhat = (z - centers[..., None]) / r
    pw = _powers(zhat, p)                          # (n, n, s, p)
    outs = []
    for mode in modes:
        if mode == "value":
            outs.append(torch.einsum("...l,...sl->...s", le, pw))
        elif mode == "ngrad":
            lw = torch.arange(1, p, dtype=le.real.dtype, device=le.device)
            outs.append(-torch.einsum("...l,...sl->...s", le[..., 1:] * lw,
                                      pw[..., :p - 1]) / r)
        else:
            raise ValueError(f"unknown l2p mode {mode!r}")
    return outs[0] if len(outs) == 1 else torch.stack(outs, dim=-1)
