"""Quadtree geometry, Morton indexing, and dense tree construction.

Level ``l`` of the tree is a dense ``(2^l, 2^l, ...)`` grid in row-major
order ``(iy, ix)``; Morton (z-order) indices serve the partitioner.  The
domain is the unit square ``[0, 1]^2``, the box side at level ``l`` is
``2**-l`` and particle positions are complex ``z = x + 1j*y``.

The offset tables and the host-side binning are numpy and identical to
the reference package's; the tree itself holds torch tensors on a device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .. import spans
from ..configs.backend import resolve_device

# ---------------------------------------------------------------------------
# Morton (z-order) indexing — used by the partitioner, not the dense kernels.
# ---------------------------------------------------------------------------


def _part1by1(x: np.ndarray) -> np.ndarray:
    """Interleave zeros: abcd -> 0a0b0c0d (supports up to 16-bit inputs)."""
    x = np.array(x, dtype=np.uint32, copy=True)   # never mutate the caller
    x &= np.uint32(0x0000FFFF)
    x = (x | (x << 8)) & np.uint32(0x00FF00FF)
    x = (x | (x << 4)) & np.uint32(0x0F0F0F0F)
    x = (x | (x << 2)) & np.uint32(0x33333333)
    x = (x | (x << 1)) & np.uint32(0x55555555)
    return x


def _compact1by1(x: np.ndarray) -> np.ndarray:
    x = np.array(x, dtype=np.uint32, copy=True)   # never mutate the caller
    x &= np.uint32(0x55555555)
    x = (x | (x >> 1)) & np.uint32(0x33333333)
    x = (x | (x >> 2)) & np.uint32(0x0F0F0F0F)
    x = (x | (x >> 4)) & np.uint32(0x00FF00FF)
    x = (x | (x >> 8)) & np.uint32(0x0000FFFF)
    return x


def morton_encode(ix: np.ndarray, iy: np.ndarray) -> np.ndarray:
    """(ix, iy) grid coords -> z-order index (paper's quadtree numbering)."""
    return (_part1by1(iy) << 1) | _part1by1(ix)


def morton_decode(code: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    code = np.asarray(code, dtype=np.uint32)
    return _compact1by1(code), _compact1by1(code >> 1)


# ---------------------------------------------------------------------------
# Interaction-list algebra for the dense uniform tree.
#
# A source box at relative offset (dx, dy), |dx|,|dy| <= 3, is in the
# interaction list of a target box iff (a) it is not a near neighbor
# (max(|dx|,|dy|) >= 2) and (b) its parent is a neighbor of the target's
# parent.  Condition (b) depends only on the parity of the target's grid
# coordinate:   |floor((parity + d) / 2)| <= 1.
# There are 40 candidate offsets; each parity class admits exactly 27.
# ---------------------------------------------------------------------------

M2L_OFFSETS: list[tuple[int, int]] = [
    (dx, dy)
    for dy in range(-3, 4)
    for dx in range(-3, 4)
    if max(abs(dx), abs(dy)) >= 2
]
assert len(M2L_OFFSETS) == 40


def parity_valid(parity: int, d: int) -> bool:
    """True iff parent(target+d) is a neighbor of parent(target)."""
    return abs(math.floor((parity + d) / 2)) <= 1


# VALIDITY[o, py, px]: offset o is in the interaction list of boxes with
# grid-coordinate parities (iy % 2 == py, ix % 2 == px).
M2L_VALIDITY = np.zeros((len(M2L_OFFSETS), 2, 2), dtype=bool)
for _o, (_dx, _dy) in enumerate(M2L_OFFSETS):
    for _py in range(2):
        for _px in range(2):
            M2L_VALIDITY[_o, _py, _px] = parity_valid(_px, _dx) and parity_valid(_py, _dy)
# Each parity class has exactly 27 interaction-list members (paper §5.2).
assert (M2L_VALIDITY.sum(axis=0) == 27).all()

# Near-field stencil (self + 8 neighbors).
P2P_OFFSETS: list[tuple[int, int]] = [(dx, dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]

# The 8 contributing parent offsets of the parity-folded M2L (the (0,0)
# parent holds only near neighbors of every child, so its block is zero).
PARENT_NEIGH8: list[tuple[int, int]] = [
    (dx, dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dx, dy) != (0, 0)
]

# M2L_PARITY_OFFSETS[py][px]: the 27 child-granularity offsets valid for
# parity class (py, px), in (parent-offset, source-child) raster order —
# the order the folded operator contracts them in.
M2L_PARITY_OFFSETS: list[list[list[tuple[int, int]]]] = [[[] for _ in range(2)]
                                                         for _ in range(2)]
for _py in range(2):
    for _px in range(2):
        for (_Dx, _Dy) in PARENT_NEIGH8:
            for _sy in range(2):
                for _sx in range(2):
                    _d = (2 * _Dx + _sx - _px, 2 * _Dy + _sy - _py)
                    if max(abs(_d[0]), abs(_d[1])) >= 2:
                        M2L_PARITY_OFFSETS[_py][_px].append(_d)

# Cross-check the folded enumeration against the mask table: same 27 sets.
for _py in range(2):
    for _px in range(2):
        _folded = set(M2L_PARITY_OFFSETS[_py][_px])
        _masked = {off for _o, off in enumerate(M2L_OFFSETS)
                   if M2L_VALIDITY[_o, _py, _px]}
        assert _folded == _masked and len(_folded) == 27


# ---------------------------------------------------------------------------
# Geometry helpers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Domain:
    """Physical root box mapped onto the solver's unit square.

    Records the affine map from physical coordinates to ``[0, 1]^2`` so
    the root box can grow when particles escape; ``to_unit``/``from_unit``
    act on ``(N, 2)`` position arrays and the identity domain is
    bit-transparent.  Unit quantities for the vortex kernel:
    ``sigma_unit = sigma / size`` and ``gamma_unit = gamma / size**2``.
    """

    origin: tuple[float, float] = (0.0, 0.0)
    size: float = 1.0

    def to_unit(self, positions: np.ndarray) -> np.ndarray:
        return (np.asarray(positions, np.float64)
                - np.asarray(self.origin)) / self.size

    def from_unit(self, positions: np.ndarray) -> np.ndarray:
        return np.asarray(positions, np.float64) * self.size \
            + np.asarray(self.origin)

    @property
    def is_identity(self) -> bool:
        return self.origin == (0.0, 0.0) and self.size == 1.0

    @staticmethod
    def covering(positions: np.ndarray, margin: float = 0.25,
                 at_least: Optional["Domain"] = None) -> "Domain":
        """Smallest square (plus relative ``margin`` per side) containing
        every position — and, when ``at_least`` is given, that whole domain
        too, so expansion never orphans the current root box."""
        pos = np.asarray(positions, np.float64)
        lo, hi = pos.min(axis=0), pos.max(axis=0)
        if at_least is not None:
            o = np.asarray(at_least.origin)
            lo = np.minimum(lo, o)
            hi = np.maximum(hi, o + at_least.size)
        side = max(float((hi - lo).max()), 1e-9)
        size = side * (1.0 + 2.0 * margin)
        center = (lo + hi) / 2.0
        origin = center - size / 2.0
        return Domain(origin=(float(origin[0]), float(origin[1])), size=size)


def box_size(level: int) -> float:
    return 2.0 ** (-level)


def box_centers(level: int) -> np.ndarray:
    """Complex centers of all boxes at ``level``, shape (2^l, 2^l) [iy, ix]."""
    n = 1 << level
    r = box_size(level)
    xs = (np.arange(n) + 0.5) * r
    cx, cy = np.meshgrid(xs, xs, indexing="xy")  # [iy, ix]
    return (cx + 1j * cy).astype(np.complex128)


# ---------------------------------------------------------------------------
# Dense tree container
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Tree:
    """Dense uniform quadtree of particles.

    ``z``/``q``/``mask`` have shape ``(n, n, s)`` with ``n = 2**level`` leaf
    boxes per side and ``s`` padded slots per box.  ``q`` already includes
    the ``gamma / (2*pi*i)`` pseudo-charge factor for the Biot-Savart kernel.
    ``sigma=None`` selects the singular kernel.
    """

    z: torch.Tensor       # complex64 (n, n, s) particle positions
    q: torch.Tensor       # complex64 (n, n, s) pseudo-charges
    mask: torch.Tensor    # bool      (n, n, s) slot occupancy
    level: int
    sigma: Optional[float]

    @property
    def nside(self) -> int:
        return 1 << self.level

    @property
    def slots(self) -> int:
        return self.z.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.z.device

    @property
    def num_particles(self) -> torch.Tensor:
        return self.mask.sum()


@dataclasses.dataclass(frozen=True)
class TreeIndex:
    """Host-side bookkeeping to map dense tree slots back to input order."""

    box_of_particle: np.ndarray   # (N,) flat row-major box id per input particle
    slot_of_particle: np.ndarray  # (N,) slot within the box
    counts: np.ndarray            # (n, n) particles per box


def choose_level(num_particles: int, target_per_box: float = 4.0, max_level: int = 12) -> int:
    """Pick the tree depth so the mean leaf occupancy ~ ``target_per_box``."""
    level = 0
    while level < max_level and num_particles / float(4 ** (level + 1)) >= target_per_box:
        level += 1
    return level


def tree_from_numpy(z: np.ndarray, q: np.ndarray, mask: np.ndarray, level: int,
                    sigma: Optional[float], device=None) -> Tree:
    """Build a :class:`Tree` from ``(n, n, s)`` host arrays (e.g. the
    reference tree's arrays as numpy); complex values round to complex64."""
    dev = resolve_device(device)
    return Tree(
        z=torch.as_tensor(np.array(z, dtype=np.complex64), device=dev),
        q=torch.as_tensor(np.array(q, dtype=np.complex64), device=dev),
        mask=torch.as_tensor(np.array(mask, dtype=bool), device=dev),
        level=int(level),
        sigma=None if sigma is None else float(sigma),
    )


@spans.traced("quadtree.build_tree")
def build_tree(
    positions: np.ndarray,
    gamma: np.ndarray,
    level: int,
    sigma: Optional[float],
    slots: Optional[int] = None,
    charge_scale: Optional[complex] = None,
    device=None,
) -> tuple[Tree, TreeIndex]:
    """Bin particles into the dense leaf grid (host numpy, then one copy to
    ``device``; ``None`` means the CUDA card).

    positions: (N, 2) float in [0, 1)^2;  gamma: (N,) real strengths.
    ``slots`` pads every box to a fixed capacity (defaults to the max
    occupancy).  ``charge_scale`` maps the input strength to the stored
    pseudo-charge ``q``; None keeps the vortex default ``1/(2*pi*i)``.
    """
    dev = resolve_device(device)
    positions = np.asarray(positions, dtype=np.float64)
    gamma = np.asarray(gamma, dtype=np.float64)
    n = 1 << level
    ij = np.clip((positions * n).astype(np.int64), 0, n - 1)
    ix, iy = ij[:, 0], ij[:, 1]
    box = iy * n + ix  # flat row-major box id

    order = np.argsort(box, kind="stable")
    sorted_box = box[order]
    counts = np.bincount(sorted_box, minlength=n * n)
    max_occ = int(counts.max()) if counts.size else 0
    if slots is None:
        slots = max(max_occ, 1)
    if max_occ > slots:
        raise ValueError(f"box occupancy {max_occ} exceeds slot capacity {slots}")

    # slot index = rank of the particle within its (sorted) box run
    starts = np.zeros(n * n + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slot_sorted = np.arange(len(box)) - starts[sorted_box]

    zflat = np.zeros((n * n, slots), dtype=np.complex128)
    qflat = np.zeros((n * n, slots), dtype=np.complex128)
    mflat = np.zeros((n * n, slots), dtype=bool)
    if charge_scale is None:
        charge_scale = 1.0 / (2j * np.pi)
    zflat[sorted_box, slot_sorted] = positions[order, 0] + 1j * positions[order, 1]
    qflat[sorted_box, slot_sorted] = gamma[order] * charge_scale
    mflat[sorted_box, slot_sorted] = True

    slot_of_particle = np.empty(len(box), dtype=np.int64)
    slot_of_particle[order] = slot_sorted

    tree = tree_from_numpy(zflat.reshape(n, n, slots), qflat.reshape(n, n, slots),
                           mflat.reshape(n, n, slots), level, sigma, dev)
    index = TreeIndex(box_of_particle=box, slot_of_particle=slot_of_particle,
                      counts=counts.reshape(n, n))
    return tree, index


def map_leaves(fn, aux):
    """Apply ``fn`` to every leaf (tensor or array) of a nested
    tuple/list/dict payload; None stays None."""
    if aux is None:
        return None
    if isinstance(aux, dict):
        return {k: map_leaves(fn, v) for k, v in aux.items()}
    if isinstance(aux, (list, tuple)):
        return type(aux)(map_leaves(fn, v) for v in aux)
    return fn(aux)


def rebuild_tree(tree: Tree, new_z: torch.Tensor, aux=None):
    """Device-side rebinning: scatter particles into a fresh dense tree.

    ``new_z`` holds updated complex positions in ``tree``'s slot layout;
    charges and occupancy come from ``tree``.  ``aux`` is an optional
    nested tuple/list/dict of per-slot ``(n, n, s)`` tensors rebinned
    alongside the particles.  Returns ``(new_tree, new_aux, ok)`` with
    ``ok`` a bool tensor: False iff a box overflowed its ``tree.slots``
    capacity, in which case the surplus particles are dropped.  Positions
    outside the unit square are clamped into the edge boxes, matching
    ``build_tree``'s host binning.  Bit-identical to the reference: the
    argsort is stable, exactly as ``jnp.argsort``.
    """
    n, s = tree.nside, tree.slots
    N = n * n * s
    z = new_z.reshape(N)
    m = tree.mask.reshape(N)

    # clamping the float first matches the reference's saturating
    # truncate-then-clip; a NaN position bins to 0 there, so it does here
    # (a NaN cast to int64 would index out of range)
    ix = torch.nan_to_num(z.real * n, nan=0.0).clamp(0, n - 1).to(torch.int64)
    iy = torch.nan_to_num(z.imag * n, nan=0.0).clamp(0, n - 1).to(torch.int64)
    box = torch.where(m, iy * n + ix, n * n)        # empty slots sort last

    order = torch.argsort(box, stable=True)
    sb = box[order]
    idx = torch.arange(N, device=z.device)
    is_start = torch.ones_like(sb, dtype=torch.bool)
    is_start[1:] = sb[1:] != sb[:-1]
    # slot = rank within the sorted box run (distance to the run's start)
    slot = idx - torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    ok = torch.all((sb == n * n) | (slot < s))

    keep = (sb < n * n) & (slot < s)                # overflow slots are dropped
    dest = torch.where(keep, sb * s + slot, N)

    def scatter(vals):
        # one spare slot at index N takes every dropped value, then is cut
        flat = torch.zeros((N + 1,), dtype=vals.dtype, device=vals.device)
        flat[dest] = vals.reshape(N)[order]
        return flat[:N].reshape(n, n, s)

    new_tree = Tree(z=scatter(z), q=scatter(tree.q), mask=scatter(m),
                    level=tree.level, sigma=tree.sigma)
    return new_tree, map_leaves(scatter, aux), ok


def gather_particle_values(values, index: TreeIndex) -> torch.Tensor:
    """Read per-slot results back into the original particle order (on the
    values' device)."""
    values = torch.as_tensor(values)
    flat = values.reshape(index.counts.size, -1)
    box = torch.as_tensor(index.box_of_particle, device=values.device)
    slot = torch.as_tensor(index.slot_of_particle, device=values.device)
    return flat[box, slot]
