"""Execution plans: the cost model's partition mapped onto device tiles.

The partitioner (core/partition.py) reproduces the paper's §4 pipeline —
weighted subtree graph, SFC seed, FM refinement, measured-time rebalance —
and two plan artifacts map it onto the dense leaf grid the sharded driver
executes (DESIGN.md §3, "mode A" / §8):

* :class:`SlabPlan` — 1-D: the per-row projection of Eqs 13-15 collapsed
  into contiguous, parity-even leaf-row bands of *unequal* height, one per
  device, padded to a common ``rows_max``;
* :class:`BlockPlan` — 2-D: a ``Pr x Pc`` device grid of contiguous,
  parity-even row-x-column tiles of unequal size (a tensor-product grid, so
  every tile's four lateral neighbors own matching extents and the halo
  exchange stays single-hop on both axes).  Boundaries come from recursive
  min/max splitting of the 2-D Eq 13-15 cost field (``cell_loads``) and are
  then refined under ``partition.refine_fm``'s objective — cut-weight
  reduction subject to a balance guard — applied *directly* to the 2-D
  boundary moves instead of via the 1-D majority collapse a SlabPlan needs.

Both plans are **static** (hashable) artifacts: a sharded driver builds
its program once per plan, and the per-device ``row0/rows`` (± ``col0/cols``)
records become constant lookup tables indexed by the device's rank.

Host numpy only: the port's own copy of the reference package's planner,
equal to it on the same counts.

Eq (20)'s min/max metric on modeled tile loads (``plan_stats``) is the
quantity the model plan must win on versus the uniform strawman, and
``halo_volume`` prices the halo-exchange traffic each plan implies — the 2-D
block plan's whole reason to exist (ROADMAP "2-D execution plans"); the
benchmark harness and tests/test_partition.py pin both on the paper's own
Lamb-Oseen lattice.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import cost_model as cm
from .cost_model import ModelParams
from . import partition as pt


@dataclasses.dataclass(frozen=True)
class SlabPlan:
    """Contiguous, parity-even leaf-row bands, one per device.

    ``row0[d]`` is the global leaf row where device ``d``'s band starts and
    ``rows[d]`` its valid height; bands tile ``[0, 2**level)`` exactly.
    Every ``row0``/``rows`` is even so each band is aligned to parent rows
    (the folded M2L's 2-row halo contract, DESIGN.md §4) and M2M below the
    band never crosses a device boundary.  Execution pads every band to
    ``rows_max`` rows; the padding carries ``mask=False`` slots and zero
    expansions and is masked out of P2P/L2P.
    """

    level: int
    row0: tuple[int, ...]
    rows: tuple[int, ...]

    def __post_init__(self):
        n = 1 << self.level
        if len(self.row0) != len(self.rows) or not self.rows:
            raise ValueError("row0 and rows must be equal-length, non-empty")
        expect = 0
        for d, (r0, r) in enumerate(zip(self.row0, self.rows)):
            if r0 != expect:
                raise ValueError(f"band {d} starts at {r0}, expected {expect}"
                                 " (bands must be contiguous)")
            if r <= 0 or r % 2 or r0 % 2:
                raise ValueError(f"band {d} (row0={r0}, rows={r}) must be a"
                                 " positive parity-even band")
            expect = r0 + r
        if expect != n:
            raise ValueError(f"bands cover {expect} rows, grid has {n}")

    # -- static geometry ----------------------------------------------------

    @property
    def nparts(self) -> int:
        return len(self.rows)

    @property
    def nside(self) -> int:
        return 1 << self.level

    @property
    def rows_max(self) -> int:
        return max(self.rows)

    @property
    def is_uniform(self) -> bool:
        return len(set(self.rows)) == 1

    # -- host-side index maps (all static numpy; the plan is hashable) ------

    def owner_of_row(self) -> np.ndarray:
        """(n,) device owning each global leaf row."""
        return np.repeat(np.arange(self.nparts), np.asarray(self.rows))

    def gather_index(self) -> tuple[np.ndarray, np.ndarray]:
        """Standard layout -> plan layout: ``(P*rows_max,)`` source row per
        padded slot plus a validity mask (False on padding rows).

        Delegates to the 2-D maps of the ``Pr x 1`` block view — the index
        algebra the driver actually executes — so the 1-D contract can
        never diverge from it (a slab's columns span the full width, hence
        column 0 carries the whole per-row record)."""
        src_r, _, valid = self.as_block().gather_index()
        return src_r[:, 0].copy(), valid[:, 0].copy()

    def scatter_index(self) -> np.ndarray:
        """Plan layout -> standard layout: ``(n,)`` padded-slot per row."""
        return self.as_block().scatter_index()[0][:, 0].copy()

    def describe(self) -> str:
        return " ".join(f"[{r0}:{r0 + r})" for r0, r in zip(self.row0, self.rows))

    def as_block(self) -> "BlockPlan":
        """This plan as the ``Pr x 1`` special case of a :class:`BlockPlan`
        (the sharded driver executes both kinds through the one 2-D path)."""
        return BlockPlan(level=self.level, row0=self.row0, rows=self.rows,
                         col0=(0,), cols=(self.nside,))

    def sharded_depth(self, min_rows: int = 4) -> int:
        """How many levels (from the leaves up) the bands can shard."""
        return self.as_block().sharded_depth(min_rows)

    def interior_extents(self, w: int) -> tuple[tuple[int, int], ...]:
        """Per-device overlap-interior extents (see BlockPlan)."""
        return self.as_block().interior_extents(w)

    def rim_owners(self) -> tuple[tuple[int, int, int, int], ...]:
        """Per-device rim ghost owners (see BlockPlan)."""
        return self.as_block().rim_owners()


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """A ``Pr x Pc`` device grid of contiguous, parity-even leaf tiles.

    Device ``d = i * Pc + j`` owns the rectangle
    ``[row0[i], row0[i] + rows[i]) x [col0[j], col0[j] + cols[j])``.
    Row bands and column bands form a tensor-product grid: a tile's north/
    south neighbors own the same column range and its east/west neighbors
    the same row range, so the two-axis halo exchange is single-hop and the
    corner (diagonal) ghosts ride along on the second axis's strips (the
    strips carry the already-attached first-axis halos).  All ``row0/rows/
    col0/cols`` are even, so every tile is parent-aligned on both axes (the
    folded M2L's 2-row halo contract, DESIGN.md §4/§8).  Execution pads
    every tile to ``(rows_max, cols_max)``; padding carries ``mask=False``
    slots and zero expansions and is masked out of P2P/L2P.
    """

    level: int
    row0: tuple[int, ...]
    rows: tuple[int, ...]
    col0: tuple[int, ...]
    cols: tuple[int, ...]

    def __post_init__(self):
        n = 1 << self.level
        for axis, (b0, bl) in (("row", (self.row0, self.rows)),
                               ("col", (self.col0, self.cols))):
            if len(b0) != len(bl) or not bl:
                raise ValueError(f"{axis}0 and {axis}s must be equal-length,"
                                 " non-empty")
            expect = 0
            for d, (x0, x) in enumerate(zip(b0, bl)):
                if x0 != expect:
                    raise ValueError(f"{axis} band {d} starts at {x0}, expected"
                                     f" {expect} (bands must be contiguous)")
                if x <= 0 or x % 2 or x0 % 2:
                    raise ValueError(f"{axis} band {d} ({axis}0={x0}, extent="
                                     f"{x}) must be a positive parity-even band")
                expect = x0 + x
            if expect != n:
                raise ValueError(f"{axis} bands cover {expect}, grid has {n}")

    # -- static geometry ----------------------------------------------------

    @property
    def grid(self) -> tuple[int, int]:
        return len(self.rows), len(self.cols)

    @property
    def nparts(self) -> int:
        return len(self.rows) * len(self.cols)

    @property
    def nside(self) -> int:
        return 1 << self.level

    @property
    def rows_max(self) -> int:
        return max(self.rows)

    @property
    def cols_max(self) -> int:
        return max(self.cols)

    @property
    def is_uniform(self) -> bool:
        return len(set(self.rows)) == 1 and len(set(self.cols)) == 1

    def alignment(self) -> int:
        """Largest ``m`` with every tile boundary (both axes) divisible by
        ``2**m`` — levels ``L-m+1 .. L`` keep tiles even-aligned."""
        vals = self.row0 + self.rows + self.col0 + self.cols
        m = 1
        while all(v % (1 << (m + 1)) == 0 for v in vals):
            m += 1
        return m

    def sharded_depth(self, min_rows: int = 4) -> int:
        """How many levels (from the leaves up) the tiles can shard.

        Level ``L - s`` is shardable when every tile boundary stays even
        after ``s`` halvings on both axes and the smallest tile dimension
        keeps ``min_rows`` rows/cols at the coarsest sharded level.
        Parity-even plans always support depth 1 when L >= 3.
        """
        if self.level < 3:
            return 0
        m = 1
        align = self.alignment()
        dmin = min(min(self.rows), min(self.cols))
        while (m + 1 <= align and self.level - (m + 1) >= 2
               and (dmin >> m) >= min_rows):
            m += 1
        return m

    # -- host-side index maps (all static numpy; the plan is hashable) ------

    def owner_of_row(self) -> np.ndarray:
        """(n,) row-band index owning each global leaf row."""
        return np.repeat(np.arange(len(self.rows)), np.asarray(self.rows))

    def owner_of_col(self) -> np.ndarray:
        """(n,) column-band index owning each global leaf column."""
        return np.repeat(np.arange(len(self.cols)), np.asarray(self.cols))

    def gather_index(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Standard layout -> plan layout: per padded slot ``(P*rows_max,
        cols_max)`` source row, source column, and validity mask (False on
        padding rows/cols)."""
        Pr, Pc = self.grid
        rmax, cmax = self.rows_max, self.cols_max
        src_r = np.zeros((Pr * Pc * rmax, cmax), dtype=np.int64)
        src_c = np.zeros((Pr * Pc * rmax, cmax), dtype=np.int64)
        valid = np.zeros((Pr * Pc * rmax, cmax), dtype=bool)
        for i, (r0, r) in enumerate(zip(self.row0, self.rows)):
            for j, (c0, c) in enumerate(zip(self.col0, self.cols)):
                d0 = (i * Pc + j) * rmax
                src_r[d0:d0 + r, :c] = (r0 + np.arange(r))[:, None]
                src_c[d0:d0 + r, :c] = (c0 + np.arange(c))[None, :]
                valid[d0:d0 + r, :c] = True
        return src_r, src_c, valid

    def scatter_index(self) -> tuple[np.ndarray, np.ndarray]:
        """Plan layout -> standard layout: ``(n, n)`` padded row slot and
        column per grid cell (indexes the ``(P*rows_max, cols_max)`` shard
        output)."""
        Pr, Pc = self.grid
        oi = self.owner_of_row()
        oj = self.owner_of_col()
        d = oi[:, None] * Pc + oj[None, :]
        lr = np.arange(self.nside) - np.asarray(self.row0)[oi]
        lc = np.arange(self.nside) - np.asarray(self.col0)[oj]
        sr = d * self.rows_max + lr[:, None]
        sc = np.broadcast_to(lc[None, :], (self.nside, self.nside))
        return sr, np.ascontiguousarray(sc)

    def tile_maps(self, shift: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Device, tile-local row, and tile-local column of every grid cell
        at level ``L - shift`` — the 2-D owner maps that reassemble unequal
        tiles after the cut-level ``all_gather``.  Requires all boundaries
        divisible by ``2**shift`` (see ``alignment``)."""
        Pr, Pc = self.grid
        n_lv = self.nside >> shift
        oi = self.owner_of_row()[np.arange(n_lv) << shift]
        oj = self.owner_of_col()[np.arange(n_lv) << shift]
        owner = oi[:, None] * Pc + oj[None, :]
        lr = np.arange(n_lv) - (np.asarray(self.row0)[oi] >> shift)
        lc = np.arange(n_lv) - (np.asarray(self.col0)[oj] >> shift)
        return (owner,
                np.ascontiguousarray(np.broadcast_to(lr[:, None], owner.shape)),
                np.ascontiguousarray(np.broadcast_to(lc[None, :], owner.shape)))

    def describe(self) -> str:
        r = " ".join(f"[{x0}:{x0 + x})" for x0, x in zip(self.row0, self.rows))
        c = " ".join(f"[{x0}:{x0 + x})" for x0, x in zip(self.col0, self.cols))
        return f"rows {r} x cols {c}"

    # -- interior/rim geometry (overlapped execution, DESIGN.md §9) ---------

    def interior_extents(self, w: int) -> tuple[tuple[int, int], ...]:
        """Per-device (rows, cols) of the overlap *interior* — the boxes at
        least ``w`` rows/cols from every tile edge, whose stencils read
        only local data.  This is the work the overlapped driver computes
        while the halo collectives are in flight.  Device order
        ``d = i * Pc + j``."""
        return tuple((max(r - 2 * w, 0), max(c - 2 * w, 0))
                     for r in self.rows for c in self.cols)

    def rim_owners(self) -> tuple[tuple[int, int, int, int], ...]:
        """Per-device (north, south, west, east) neighbor device supplying
        each rim strip's ghost data, ``-1`` at domain edges (the strip then
        reads zeros, matching the serial zero padding).  Consumed by the
        halo/rim accounting (``_halo_device_stats``), which derives each
        device's exchanged-strip count from it; a sharded driver's
        exchange pairs follow the same ``d = i * Pc + j`` raster layout.  Device order ``d = i * Pc + j``."""
        Pr, Pc = self.grid
        return tuple(((i - 1) * Pc + j if i > 0 else -1,
                      (i + 1) * Pc + j if i < Pr - 1 else -1,
                      i * Pc + j - 1 if j > 0 else -1,
                      i * Pc + j + 1 if j < Pc - 1 else -1)
                     for i in range(Pr) for j in range(Pc))


# ---------------------------------------------------------------------------
# Plan construction from the cost model
# ---------------------------------------------------------------------------


def uniform_plan(level: int, nparts: int) -> SlabPlan:
    """The strawman: equal-count parity-even bands (DPMTA-style split)."""
    R = (1 << level) // 2                      # parent rows
    if nparts > R:
        raise ValueError(f"{nparts} parts need >= {2 * nparts} leaf rows"
                         f" (level {level} has {2 * R})")
    base, extra = divmod(R, nparts)
    rows = tuple(2 * (base + (1 if d < extra else 0)) for d in range(nparts))
    row0 = tuple(int(x) for x in np.concatenate([[0], np.cumsum(rows)[:-1]]))
    return SlabPlan(level=level, row0=row0, rows=rows)


def cell_loads(counts: np.ndarray, params: ModelParams) -> np.ndarray:
    """Modeled work per *parent cell* (2x2 leaf block) — the 2-D Eq 13-15
    cost field, shape ``(2**level // 2, 2**level // 2)``.

    Leaf work uses the exact per-box Eq (14) (with the true 3x3 neighbor
    P2P product); non-leaf work at levels ``cut..L-1`` is spread uniformly
    over the leaf boxes each coarse box covers, matching ``work_subtree``'s
    census so tile loads and subtree-graph loads share units.
    """
    n = counts.shape[0]
    L = params.level
    nb = cm.neighbor_count_sum(counts)
    per_box = cm.work_leaf(counts, params.p, neighbor_counts=nb,
                           nout=params.nout)
    nonleaf = sum(4 ** l for l in range(params.cut, L)) \
        * cm.work_nonleaf(params.p) / (4 ** L)
    per_box = per_box + nonleaf
    return per_box.reshape(n // 2, 2, n // 2, 2).sum(axis=(1, 3))


def row_loads(counts: np.ndarray, params: ModelParams) -> np.ndarray:
    """Modeled work per *parent* leaf-row pair — ``cell_loads`` projected
    1-D (the quantity SlabPlan boundaries are optimized over)."""
    return cell_loads(counts, params).sum(axis=1)


def _bounds_loads(w: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    pre = np.concatenate([[0.0], np.cumsum(w)])
    return pre[bounds[1:]] - pre[bounds[:-1]]


def _quantile_bounds(w: np.ndarray, nparts: int) -> np.ndarray:
    """Weight-quantile seed split (the 1-D analogue of the weighted-SFC
    seed in core/partition.py); every part gets at least one row."""
    assign = pt.partition_weighted_sfc(w, nparts)
    return np.concatenate([[0], np.cumsum(np.bincount(assign,
                                                      minlength=nparts))])


def _uniform_bounds(length: int, nparts: int) -> np.ndarray:
    """Equal-count contiguous bounds (base/extra split) — the strawman seed
    both the 1-D and 2-D planners refine from."""
    base, extra = divmod(length, nparts)
    return np.concatenate([[0], np.cumsum([base + (1 if d < extra else 0)
                                           for d in range(nparts)])]
                          ).astype(np.int64)


def _balance_key(loads: np.ndarray) -> tuple[float, float]:
    """Lexicographic objective: maximize Eq-20 min/max, then minimize the
    bottleneck.  Smaller is better."""
    mx = float(loads.max())
    ratio = float(loads.min()) / mx if mx > 0 else 1.0
    return (-ratio, mx)


def _refine_bounds(w: np.ndarray, bounds: np.ndarray, nparts: int) -> np.ndarray:
    """Move boundaries one row at a time while ``_balance_key`` improves
    (the 1-D analogue of partition.refine_fm's boundary passes)."""
    bounds = bounds.copy()
    loads = _bounds_loads(w, bounds)
    for _ in range(4 * len(w)):
        best_move, best_key = None, _balance_key(loads)
        for i in range(1, nparts):
            for step in (-1, 1):
                if not bounds[i - 1] < bounds[i] + step < bounds[i + 1]:
                    continue
                trial = loads.copy()
                dw = w[bounds[i] - 1] if step < 0 else w[bounds[i]]
                trial[i - 1] += step * dw
                trial[i] -= step * dw
                k = _balance_key(trial)
                if k < best_key:
                    best_move, best_key = (i, step, trial), k
        if best_move is None:
            break
        i, step, loads = best_move
        bounds[i] += step
    return bounds


def _split_min_max(w: np.ndarray, nparts: int) -> np.ndarray:
    """Balanced contiguous partition of ``w`` into ``nparts`` runs.

    Boundary refinement over the Eq-20 objective from two seeds — the
    weight-quantile split and the uniform equal-count split — keeping the
    better result.  Seeding from uniform guarantees the model plan is never
    worse than the strawman on the modeled metric.
    """
    cands = [_refine_bounds(w, _quantile_bounds(w, nparts), nparts),
             _refine_bounds(w, _uniform_bounds(len(w), nparts), nparts)]
    return min(cands, key=lambda b: _balance_key(_bounds_loads(w, b)))


def plan_from_counts(counts: np.ndarray, params: ModelParams, nparts: int,
                     method: str = "model",
                     row_weight_scale: np.ndarray | None = None,
                     grid: tuple[int, int] | None = None):
    """Collapse the cost model onto parity-even row bands (or 2-D tiles).

    method='uniform'/'uniform-sfc'  equal-count bands (no cost model)
    method='sfc'                    greedy weight-balanced quantile split
    method='model'                  min-max optimal band boundaries

    ``row_weight_scale`` (parent-row granularity for bands, parent-cell
    ``(R, C)`` granularity for tiles) folds measured-feedback slowdowns into
    the weights — see ``replan``.  The uniform strawman carries no cost
    model, but measured feedback still applies: with a scale the equal-count
    split is re-split min/max on the measured slowdown field alone, so a
    dynamic stepper on the strawman sheds rows from a slow device instead of
    silently ignoring its own timer (tests/test_partition.py pins this).

    ``grid=(Pr, Pc)`` routes to :func:`block_plan_from_counts` and returns a
    :class:`BlockPlan` instead (``Pr * Pc`` must equal ``nparts``).
    """
    if grid is not None:
        if grid[0] * grid[1] != nparts:
            raise ValueError(f"grid {grid} has {grid[0] * grid[1]} tiles for"
                             f" {nparts} devices")
        return block_plan_from_counts(counts, params, grid, method=method,
                                      cell_weight_scale=row_weight_scale)
    n = counts.shape[0]
    if n != 1 << params.level:
        raise ValueError(f"counts side {n} != 2**level ({1 << params.level})")
    if nparts <= 1:
        return SlabPlan(level=params.level, row0=(0,), rows=(n,))
    if method in ("uniform", "uniform-sfc") and row_weight_scale is None:
        return uniform_plan(params.level, nparts)
    if method in ("uniform", "uniform-sfc"):
        w = np.ones(n // 2, dtype=np.float64)
    else:
        w = row_loads(counts, params)
    if row_weight_scale is not None:
        w = w * np.asarray(row_weight_scale, dtype=np.float64)
    if nparts > len(w):
        raise ValueError(f"{nparts} parts need >= {2 * nparts} leaf rows")
    if method == "sfc":
        assign = pt.partition_weighted_sfc(w, nparts)
        bounds = np.concatenate([[0], np.cumsum(np.bincount(assign, minlength=nparts))])
    elif method in ("model", "uniform", "uniform-sfc"):
        bounds = _split_min_max(w, nparts)
    else:
        raise ValueError(f"unknown plan method: {method}")
    rows = tuple(int(2 * (b1 - b0)) for b0, b1 in zip(bounds[:-1], bounds[1:]))
    row0 = tuple(int(2 * b) for b in bounds[:-1])
    return SlabPlan(level=params.level, row0=row0, rows=rows)


# ---------------------------------------------------------------------------
# 2-D block plans (tensor-product tile grids)
# ---------------------------------------------------------------------------


def uniform_block_plan(level: int, grid: tuple[int, int]) -> BlockPlan:
    """The 2-D strawman: equal-count parity-even tiles on a Pr x Pc grid."""
    rp = uniform_plan(level, grid[0])
    cp = uniform_plan(level, grid[1])
    return BlockPlan(level=level, row0=rp.row0, rows=rp.rows,
                     col0=cp.row0, cols=cp.rows)


def _prefix2d(W: np.ndarray) -> np.ndarray:
    """Inclusive 2-D prefix-sum table of ``W`` (one row/col of zeros
    prepended) — depends only on the weight field, so boundary-refinement
    loops hoist it once and score every candidate move against it."""
    S = np.zeros((W.shape[0] + 1, W.shape[1] + 1))
    S[1:, 1:] = W.cumsum(axis=0).cumsum(axis=1)
    return S


def _loads_from_prefix(S: np.ndarray, rb: np.ndarray,
                       cb: np.ndarray) -> np.ndarray:
    """(Pr, Pc) tile loads under tensor bounds, from a ``_prefix2d`` table."""
    P = S[np.ix_(rb, cb)]
    return P[1:, 1:] - P[:-1, 1:] - P[1:, :-1] + P[:-1, :-1]


def _grid_tile_loads(W: np.ndarray, rb: np.ndarray, cb: np.ndarray) -> np.ndarray:
    """(Pr, Pc) tile loads of the 2-D weight field under tensor bounds."""
    return _loads_from_prefix(_prefix2d(W), rb, cb)


def _grid_cut_weights(counts: np.ndarray, params: ModelParams
                      ) -> tuple[np.ndarray, np.ndarray]:
    """FM edge-cut field at parent-line granularity.

    ``hw[i, c]``: cost of cutting between parent rows ``i`` and ``i+1``
    within parent column ``c`` (shape ``(R-1, C)``); ``vw[r, j]`` likewise
    for column cuts (shape ``(R, C-1)``).  The expansion term is the Eq-11
    lateral ME/LE traffic (factor 4: both directions, both rings — the same
    constant ``partition.build_subtree_graph`` prices a subtree face with);
    the particle term is Eq's ghost traffic for the two leaf lines adjacent
    to the cut (``comm_particles_boundary``).
    """
    n = counts.shape[0]
    R = n // 2
    a = cm.alpha_comm(params.p, params.coeff_bytes) * 4.0
    colcells = counts.reshape(n, R, 2).sum(axis=-1)        # (n leaf rows, C)
    rowcells = counts.reshape(R, 2, n).sum(axis=1)         # (R, n leaf cols)
    hw = a + cm.PARTICLE_BYTES * (colcells[1:-2:2, :] + colcells[2:-1:2, :])
    vw = a + cm.PARTICLE_BYTES * (rowcells[:, 1:-2:2] + rowcells[:, 2:-1:2])
    return hw, vw


def _grid_edge_cut(hw: np.ndarray, vw: np.ndarray, rb: np.ndarray,
                   cb: np.ndarray) -> float:
    """Total cut weight of the tensor-grid boundaries (interior lines)."""
    cut = sum(float(hw[b - 1, :].sum()) for b in rb[1:-1])
    cut += sum(float(vw[:, b - 1].sum()) for b in cb[1:-1])
    return cut


def _grid_moves(rb: np.ndarray, cb: np.ndarray):
    """All legal ±1 boundary moves (axis, boundary index, step)."""
    for i in range(1, len(rb) - 1):
        for step in (-1, 1):
            if rb[i - 1] < rb[i] + step < rb[i + 1]:
                yield ("r", i, step)
    for j in range(1, len(cb) - 1):
        for step in (-1, 1):
            if cb[j - 1] < cb[j] + step < cb[j + 1]:
                yield ("c", j, step)


def _refine_grid(W: np.ndarray, hw: np.ndarray, vw: np.ndarray,
                 rb: np.ndarray, cb: np.ndarray,
                 imbalance_tol: float = 0.05) -> tuple[np.ndarray, np.ndarray]:
    """Two-phase boundary refinement of a tensor tile grid.

    Phase A moves row/column boundaries one parent line at a time while the
    Eq-20 lexicographic balance key improves (the 2-D analogue of
    ``_refine_bounds``).  Phase B then applies ``partition.refine_fm``'s
    objective directly to the 2-D boundaries: accept the move with the
    largest edge-cut reduction subject to the balance guard (bottleneck no
    worse than ``(1 + tol)`` x and min/max ratio no worse than ``(1 - tol)``
    x the phase-A optimum) — no 1-D majority collapse in the loop.
    """
    rb, cb = rb.copy(), cb.copy()
    S = _prefix2d(W)               # hoisted: W never changes during refinement

    def key(rbounds, cbounds):
        return _balance_key(_loads_from_prefix(S, rbounds, cbounds).ravel())

    def apply(move):
        r2, c2 = rb.copy(), cb.copy()
        axis, i, step = move
        (r2 if axis == "r" else c2)[i] += step
        return r2, c2

    for _ in range(4 * (W.shape[0] + W.shape[1])):
        best = min(((key(*apply(m)), m) for m in _grid_moves(rb, cb)),
                   default=None, key=lambda t: t[0])
        if best is None or best[0] >= key(rb, cb):
            break
        rb, cb = apply(best[1])

    ratio_a, max_a = key(rb, cb)
    for _ in range(4 * (W.shape[0] + W.shape[1])):
        cut0 = _grid_edge_cut(hw, vw, rb, cb)
        best = None
        for m in _grid_moves(rb, cb):
            r2, c2 = apply(m)
            ratio, mx = key(r2, c2)
            if mx > (1.0 + imbalance_tol) * max_a:
                continue
            if -ratio < (1.0 - imbalance_tol) * -ratio_a:
                continue
            cut = _grid_edge_cut(hw, vw, r2, c2)
            if cut < cut0 and (best is None or cut < best[0]):
                best = (cut, m)
        if best is None:
            break
        rb, cb = apply(best[1])
    return rb, cb


def block_plan_from_counts(counts: np.ndarray, params: ModelParams,
                           grid: tuple[int, int], method: str = "model",
                           cell_weight_scale: np.ndarray | None = None
                           ) -> BlockPlan:
    """Recursive min/max split of the 2-D cost field onto a Pr x Pc grid.

    Row bounds are seeded from the row projection of ``cell_loads`` and
    column bounds from the column projection (quantile and uniform seeds,
    as in the 1-D path — seeding from uniform guarantees the model plan
    never scores below the strawman on the modeled metric), then both axes
    are refined jointly under the Eq-20 balance key and the FM edge-cut
    objective (``_refine_grid``).

    ``cell_weight_scale`` (``(R, C)`` parent-cell granularity, or ``(R,)``
    per-parent-row — normalized to a column vector so row slowdowns scale
    rows, matching ``plan_loads``) folds measured-feedback slowdowns into
    the field; as in the 1-D path, the uniform strawman with a scale is
    re-split on the measured field alone.
    """
    if cell_weight_scale is not None:
        cell_weight_scale = np.asarray(cell_weight_scale, dtype=np.float64)
        if cell_weight_scale.ndim == 1:
            cell_weight_scale = cell_weight_scale[:, None]
    Pr, Pc = grid
    n = counts.shape[0]
    if n != 1 << params.level:
        raise ValueError(f"counts side {n} != 2**level ({1 << params.level})")
    if Pr < 1 or Pc < 1:
        raise ValueError(f"grid {grid} must be positive")
    if Pr * Pc == 1:
        return BlockPlan(level=params.level, row0=(0,), rows=(n,),
                         col0=(0,), cols=(n,))
    R = n // 2
    if Pr > R or Pc > R:
        raise ValueError(f"grid {grid} needs >= {2 * max(Pr, Pc)} leaf"
                         f" rows/cols (level {params.level} has {n})")
    if method in ("uniform", "uniform-sfc") and cell_weight_scale is None:
        return uniform_block_plan(params.level, grid)
    if method in ("uniform", "uniform-sfc"):
        W = np.ones((R, R), dtype=np.float64)
    elif method in ("model", "sfc"):
        W = cell_loads(counts, params)
    else:
        raise ValueError(f"unknown plan method: {method}")
    if cell_weight_scale is not None:
        W = W * np.asarray(cell_weight_scale, dtype=np.float64)

    def axis_bounds(w, nparts):
        return [_quantile_bounds(w, nparts), _uniform_bounds(len(w), nparts)]

    seeds = list(zip(axis_bounds(W.sum(axis=1), Pr),
                     axis_bounds(W.sum(axis=0), Pc)))
    if method == "sfc":
        rb, cb = seeds[0]
    else:
        hw, vw = _grid_cut_weights(counts, params)
        cands = [_refine_grid(W, hw, vw, rb, cb) for rb, cb in seeds]
        # keep the raw uniform seed as a candidate: phase B may trade up to
        # `imbalance_tol` of balance for cut, so without it the model plan
        # could score below the strawman on the Eq-20 metric
        cands.append(seeds[1])
        rb, cb = min(cands, key=lambda b: (
            _balance_key(_grid_tile_loads(W, *b).ravel()),
            _grid_edge_cut(hw, vw, *b)))
    return BlockPlan(
        level=params.level,
        row0=tuple(int(2 * b) for b in rb[:-1]),
        rows=tuple(int(2 * (b1 - b0)) for b0, b1 in zip(rb[:-1], rb[1:])),
        col0=tuple(int(2 * b) for b in cb[:-1]),
        cols=tuple(int(2 * (b1 - b0)) for b0, b1 in zip(cb[:-1], cb[1:])))


# ---------------------------------------------------------------------------
# Quality metrics and dynamic feedback (paper Eq 20 / §4 "dynamic")
# ---------------------------------------------------------------------------


def plan_loads(plan, counts: np.ndarray, params: ModelParams,
               weight_scale: np.ndarray | None = None) -> np.ndarray:
    """Modeled work per device under the current particle distribution.

    ``(nparts,)`` in device order for both plan kinds (BlockPlan devices in
    ``d = i * Pc + j`` raster order).  ``weight_scale`` may be per-parent-
    row ``(R,)`` or per-parent-cell ``(R, C)`` regardless of plan kind —
    the mismatched direction is broadcast (rows over cells) or projected
    (cells summed per row), so the grid autotuner and the stepper's
    adoption test can score slab and block candidates with one measured
    scale."""
    if isinstance(plan, BlockPlan):
        W = cell_loads(counts, params)
        if weight_scale is not None:
            ws = np.asarray(weight_scale, dtype=np.float64)
            W = W * (ws[:, None] if ws.ndim == 1 else ws)
        rb = np.concatenate([[0], np.cumsum(np.asarray(plan.rows) // 2)])
        cb = np.concatenate([[0], np.cumsum(np.asarray(plan.cols) // 2)])
        return _grid_tile_loads(W, rb, cb).ravel()
    if weight_scale is not None:
        ws = np.asarray(weight_scale, dtype=np.float64)
        if ws.ndim == 2:
            w = (cell_loads(counts, params) * ws).sum(axis=1)
        else:
            w = row_loads(counts, params) * ws
    else:
        w = row_loads(counts, params)
    bounds = np.concatenate([[0], np.cumsum(np.asarray(plan.rows) // 2)])
    return _bounds_loads(w, bounds)


def plan_stats(plan, counts: np.ndarray, params: ModelParams) -> dict:
    """Eq (20) min/max load balance + load summary, next to partition_stats."""
    loads = plan_loads(plan, counts, params)
    stats = {
        "load_balance": float(loads.min() / loads.max()) if loads.max() > 0 else 1.0,
        "max_load": float(loads.max()),
        "mean_load": float(loads.mean()),
        "min_load": float(loads.min()),
        "rows": list(plan.rows),
    }
    if isinstance(plan, BlockPlan):
        stats["cols"] = list(plan.cols)
        stats["grid"] = plan.grid
    return stats


def replan(counts: np.ndarray, params: ModelParams, nparts: int,
           prev_plan=None, measured_times: np.ndarray | None = None,
           method: str = "model", grid=None, overlap: bool = True,
           pipeline: bool = True):
    """Dynamic re-planning: current counts + measured per-device times.

    Without measurements this is a pure a-priori re-plan from the drifted
    particle distribution.  With ``measured_times`` the per-device slowdown
    rates (``partition.measured_rates`` — the same feedback ``rebalance``
    applies to subtree vertices) scale each device's rows/cells before the
    min-max re-split, so a slow device sheds rows (or tiles) exactly as the
    paper's dynamic rebalancing sheds subtrees.  A :class:`BlockPlan`
    ``prev_plan`` re-plans on its own grid unless ``grid`` overrides it.
    ``grid="auto"`` re-runs the per-axis grid autotuner
    (:func:`autotune_plan`) with the measured scale, so slab vs block and
    ``(Pr, Pc)`` are themselves re-chosen from the drifted distribution
    (``overlap`` and ``pipeline`` select the comm term the score uses —
    they must match the executing driver's flags or the model scores a
    different program than the one that runs).
    """
    if grid == "auto":
        scale = None
        if measured_times is not None and prev_plan is not None:
            scale = measured_row_scale(prev_plan, counts, params,
                                       measured_times)
        return autotune_plan(counts, params, nparts, method=method,
                             cell_weight_scale=scale, overlap=overlap,
                             pipeline=pipeline)
    if grid is None and isinstance(prev_plan, BlockPlan):
        grid = prev_plan.grid
    scale = None
    if measured_times is not None and prev_plan is not None:
        scale = measured_row_scale(prev_plan, counts, params, measured_times)
        if grid is not None and scale.ndim == 1:
            # migrating a 1-D slab plan onto a 2-D grid: the per-parent-row
            # slowdowns apply to every column of the cell field (an (R, 1)
            # column vector broadcasts per-row; a bare (R,) would multiply
            # along the wrong axis)
            scale = scale[:, None]
    return plan_from_counts(counts, params, nparts, method=method,
                            row_weight_scale=scale, grid=grid)


def measured_row_scale(plan, counts: np.ndarray, params: ModelParams,
                       measured_times: np.ndarray) -> np.ndarray:
    """Per-parent-row (bands) or per-parent-cell (tiles) slowdown factors
    implied by measured device times — the weight scaling both ``replan``
    and the stepper's adoption test must share (diverging formulas would
    re-split on different weights)."""
    loads = plan_loads(plan, counts, params)
    rates = pt.measured_rates(loads, np.asarray(measured_times, np.float64))
    if isinstance(plan, BlockPlan):
        Pc = len(plan.cols)
        oi = plan.owner_of_row()[::2]
        oj = plan.owner_of_col()[::2]
        return rates[oi[:, None] * Pc + oj[None, :]]
    return rates[plan.owner_of_row()[::2]]


def assignment_from_plan(plan, cut: int) -> np.ndarray:
    """Subtree assignment implied by the plan's leaf ownership.

    Lets the stepper keep the paper's 2-D subtree assignment in sync with
    the execution plan so ``partition.rebalance`` / ``partition_stats`` can
    run on the same graph the paper partitions.  For a SlabPlan this is the
    majority owner of the leaf rows under each cut-grid row; for a
    BlockPlan the maximum-overlap tile is exact and separable (majority row
    band x majority column band).
    """
    nsub = 1 << cut
    sub = plan.nside // nsub

    def majority(owner_1d):
        out = np.empty(nsub, dtype=np.int64)
        for t in range(nsub):
            out[t] = np.bincount(owner_1d[t * sub:(t + 1) * sub]).argmax()
        return out

    if isinstance(plan, BlockPlan):
        Pc = len(plan.cols)
        oi = majority(plan.owner_of_row())
        oj = majority(plan.owner_of_col())
        return (oi[:, None] * Pc + oj[None, :]).reshape(-1)
    row_owner = majority(plan.owner_of_row())
    return np.repeat(row_owner, nsub)


# ---------------------------------------------------------------------------
# Halo-volume accounting (implementation counterpart of Eqs 11-12, per plan)
# ---------------------------------------------------------------------------


def _halo_device_stats(block: BlockPlan, params: ModelParams,
                       executed: bool) -> tuple[np.ndarray, np.ndarray,
                                                np.ndarray, np.ndarray]:
    """Per-device halo traffic and rim recompute of one FMM evaluation.

    Returns ``(m2l_bytes, p2p_bytes, rim_m2l_boxes, rim_p2p_boxes)``, each
    ``(nparts,)`` in device order.  The byte terms price the two-axis
    exchanged strips (see :func:`halo_volume`); the rim terms count the
    boxes the *overlapped* driver evaluates from the exchanged buffer (the
    four edge strips per sharded M2L level / at the leaves — the work that
    cannot start until the collective lands, DESIGN.md §9)."""
    Pr, Pc = block.grid
    L = params.level
    depth = block.sharded_depth()
    l_cut = L - depth
    a = params.p * params.coeff_bytes
    m2l = np.zeros(Pr * Pc)
    p2p = np.zeros(Pr * Pc)
    rim_m2l = np.zeros(Pr * Pc)
    rim_p2p = np.zeros(Pr * Pc)
    owners = block.rim_owners()       # neighbor topology, -1 at domain edges
    for i in range(Pr):
        for j in range(Pc):
            d = i * Pc + j
            north, south, west, east = owners[d]
            row_nb = (north >= 0) + (south >= 0)     # strips sent up/down
            col_nb = (west >= 0) + (east >= 0)       # strips sent left/right
            for lv in range(l_cut + 1, L + 1):
                shift = L - lv
                w = cm.M2L_HALO_ROWS
                if executed:
                    rext, cext = block.rows_max >> shift, block.cols_max >> shift
                    cext += 2 * w                     # corner-carrying strips
                else:
                    rext = block.rows[i] >> shift
                    cext = (block.cols[j] >> shift) + col_nb * w
                m2l[d] += (col_nb * w * rext + row_nb * w * cext) * a
                rr = (block.rows_max if executed else block.rows[i]) >> shift
                cc = (block.cols_max if executed else block.cols[j]) >> shift
                rim_m2l[d] += 2 * w * (rr + cc)
            w = cm.P2P_HALO_ROWS
            if executed:
                rext, cext = block.rows_max, block.cols_max + 2 * w
            else:
                rext = block.rows[i]
                cext = block.cols[j] + col_nb * w
            p2p[d] += (col_nb * w * rext + row_nb * w * cext) \
                * params.slots * cm.PARTICLE_BYTES
            rr = block.rows_max if executed else block.rows[i]
            cc = block.cols_max if executed else block.cols[j]
            rim_p2p[d] += 2 * w * (rr + cc)
    return m2l, p2p, rim_m2l, rim_p2p


def halo_volume(plan, params: ModelParams, executed: bool = False) -> dict:
    """Bytes the driver's halo exchange moves per FMM evaluation.

    Sums, over every device and every sharded level, the M2L coefficient
    strips (width ``cost_model.M2L_HALO_ROWS``) and the leaf-level P2P
    particle strips (width ``P2P_HALO_ROWS``) the two-axis exchange sends.
    ``executed=False`` prices the *modeled* volume (valid tile extents —
    the quantity the 2-D plan must win on versus the 1-D slab);
    ``executed=True`` prices what the driver literally transfers, i.e. the
    padded ``(rows_max, cols_max)`` extents plus the corner-carrying column
    halos on every row strip.  The cut-level ``all_gather`` is not counted
    (identical structure for both plan kinds).

    ``rim_m2l_boxes`` / ``rim_p2p_boxes`` additionally report the rim cost
    of the overlapped driver: the boxes per evaluation whose compute is
    serialized behind the exchange (the four edge strips; multiply the P2P
    term by ``params.slots`` for slot counts) — the quantity the
    overlap-aware comm model (:func:`plan_comm_cost`) charges against the
    hiding budget.
    """
    block = plan.as_block() if isinstance(plan, SlabPlan) else plan
    m2l, p2p, rim_m2l, rim_p2p = _halo_device_stats(block, params, executed)
    return {"m2l": float(m2l.sum()), "p2p": float(p2p.sum()),
            "total": float((m2l + p2p).sum()),
            "rim_m2l_boxes": float(rim_m2l.sum()),
            "rim_p2p_boxes": float(rim_p2p.sum()),
            "sharded_levels": block.sharded_depth()}


def plan_comm_cost(plan, counts: np.ndarray, params: ModelParams,
                   overlap: bool = True, executed: bool = True,
                   weight_scale: np.ndarray | None = None,
                   pipeline: bool = True) -> np.ndarray:
    """(nparts,) modeled serial communication cost per device.

    ``overlap=False`` is the paper's Eq 16-20 price: ``t_byte`` times the
    device's halo bytes, paid serially before the dependent compute.
    ``overlap=True`` is the interior/rim driver's residue (DESIGN.md §9):
    each device's halo bytes are hidden behind its *interior* work — the
    plan load scaled by the interior fraction of the tile
    (``interior_extents``) — and only ``max(0, t_comm - t_hide)`` remains
    serial (``cost_model.comm_overlap_effective``, which owns both
    branches).  This is the term that stops the partitioner
    double-counting bytes the driver hides.  ``weight_scale`` (measured
    slowdown feedback, see ``plan_loads``) scales the hiding budget too:
    a slow device's interior takes longer in wall clock, so it hides the
    same exchange more easily — the comm term sees the same device speeds
    the balance term uses.

    ``pipeline=True`` (default, matching the drivers) enlarges the hiding
    budget with the substep pipeline's windows (DESIGN.md §12): the
    replicated root-tree sweep now runs between the halo collectives'
    issue and the rim consumption (``cost_model.work_root_tree``), and the
    prefetched cross-substep P2P exchange additionally flies through the
    next substep's upward sweep (``cost_model.work_upward``).  The enlarged
    budget can only shrink the residue, never grow it.
    """
    block = plan.as_block() if isinstance(plan, SlabPlan) else plan
    m2l_b, p2p_b, _, _ = _halo_device_stats(block, params, executed)
    bytes_d = m2l_b + p2p_b
    loads = plan_loads(plan, counts, params, weight_scale)
    Pr, Pc = block.grid
    area = np.array([block.rows[i] * block.cols[j]
                     for i in range(Pr) for j in range(Pc)], dtype=np.float64)
    ints = np.array([r * c for r, c in
                     block.interior_extents(cm.P2P_HALO_ROWS)],
                    dtype=np.float64)
    hide = loads * ints / np.maximum(area, 1.0)
    extra = 0.0
    if pipeline:
        extra = cm.work_root_tree(params) + cm.work_upward(params, area)
        if weight_scale is not None:
            # a slow device's pipeline windows stretch too: scale by its
            # mean slowdown, like the interior budget above
            mean_scale = loads / np.maximum(
                plan_loads(plan, counts, params), 1e-30)
            extra = extra * mean_scale
    return cm.comm_overlap_effective(bytes_d, hide, params, overlap=overlap,
                                     extra_hide=extra)


def plan_score(plan, counts: np.ndarray, params: ModelParams,
               overlap: bool = True,
               weight_scale: np.ndarray | None = None,
               pipeline: bool = True) -> float:
    """Modeled bottleneck step cost: Eq-20 max over devices of work plus
    the overlap-aware serial comm residue — the objective the grid
    autotuner minimizes.  Smaller is better.  ``weight_scale`` feeds both
    terms, so the balance and comm-hiding models see the same measured
    device speeds; ``pipeline`` selects the §12 enlarged hiding budget the
    executing driver actually has."""
    loads = plan_loads(plan, counts, params, weight_scale)
    comm = plan_comm_cost(plan, counts, params, overlap=overlap,
                          weight_scale=weight_scale, pipeline=pipeline)
    return float((params.t_flop * loads + comm).max())


def candidate_grids(nparts: int) -> list[tuple[int, int]]:
    """All ``(Pr, Pc)`` factorizations of ``nparts`` — ``(nparts, 1)`` is
    the 1-D slab candidate, everything else a 2-D block grid."""
    return [(pr, nparts // pr) for pr in range(1, nparts + 1)
            if nparts % pr == 0]


def autotune_plan(counts: np.ndarray, params: ModelParams, nparts: int,
                  method: str = "model",
                  cell_weight_scale: np.ndarray | None = None,
                  overlap: bool = True, pipeline: bool = True):
    """Per-axis plan autotuning (ROADMAP): choose slab vs block AND the
    ``(Pr, Pc)`` device grid at replan time.

    Builds one candidate plan per factorization of ``nparts`` (the
    ``(P, 1)`` slab plus every 2-D tensor grid that fits the leaf grid) and
    keeps the one minimizing :func:`plan_score` — the Eq-20 balance
    bottleneck plus the overlap-aware comm residue of ``halo_volume``, so
    the choice trades balance against the bytes the driver cannot hide.
    ``cell_weight_scale`` carries measured-feedback slowdowns at parent-row
    ``(R,)`` or parent-cell ``(R, C)`` granularity (either shape works for
    both candidate kinds; see ``plan_loads``).
    """
    R = (1 << params.level) // 2
    best: tuple[float, object] | None = None
    for Pr, Pc in candidate_grids(nparts):
        if Pr > R or Pc > R:
            continue
        if Pc == 1:
            row_scale = None
            if cell_weight_scale is not None:
                ws = np.asarray(cell_weight_scale, dtype=np.float64)
                if ws.ndim == 2:
                    # project cell slowdowns onto rows: the scale that makes
                    # scaled row loads equal the row sums of the scaled field
                    W = cell_loads(counts, params)
                    den = W.sum(axis=1)
                    num = (W * ws).sum(axis=1)
                    row_scale = np.where(den > 0, num / np.where(den > 0, den, 1.0), 1.0)
                else:
                    row_scale = ws
            plan = plan_from_counts(counts, params, nparts, method=method,
                                    row_weight_scale=row_scale)
        else:
            plan = block_plan_from_counts(counts, params, (Pr, Pc),
                                          method=method,
                                          cell_weight_scale=cell_weight_scale)
        score = plan_score(plan, counts, params, overlap=overlap,
                           weight_scale=cell_weight_scale, pipeline=pipeline)
        if best is None or score < best[0]:
            best = (score, plan)
    if best is None:
        raise ValueError(f"no (Pr, Pc) factorization of {nparts} fits a"
                         f" level-{params.level} grid")
    return best[1]
