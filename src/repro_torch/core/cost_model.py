"""Work, communication, and memory estimates (paper §5, Eqs 11-15, Tables 1-2).

This module is the quantitative heart of the paper: an a-priori model of
tree-based N-body computation that feeds the load-balancing partitioner.
All functions are host-side NumPy (they run in the launcher / partitioner,
never on device): the port's own copy of the reference package's model.

Conventions: d = 2 (quadtree), L = tree depth, k = cut level, p = expansion
terms, s = max particles per box, N_i = per-box particle count.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

D = 2                 # space dimension (quadtree; the model generalizes via d)
N_CHILD = 4           # n_c
N_IL = 27             # interaction-list size (2D upper bound, paper §5.2)
N_ND = 9              # near-domain boxes (3x3 stencil incl. self)
PARTICLE_BYTES = 28   # B, paper §5.3
ARROW_BYTES = 108     # A, overlap arrow size, paper §5.3

# Halo widths of the dense slab implementation (rows of ghost data exchanged
# per sharded level).  Parity folding (DESIGN.md §4) works at parent
# granularity, so M2L needs ±1 parent row = 2 child rows — down from the ±3
# child rows a box-granularity interaction list implies.  P2P needs ±1 leaf
# row.  tests/test_cost_model.py pins these against expansions.M2L_HALO and
# kernels.p2p.P2P_HALO.
M2L_HALO_ROWS = 2
P2P_HALO_ROWS = 1


@dataclasses.dataclass(frozen=True)
class ModelParams:
    level: int                   # L: leaf level of the global tree
    cut: int                     # k: tree cut level -> 4^k subtrees
    p: int                       # expansion order
    slots: int                   # s: max particles per box
    coeff_bytes: int = 16        # bytes per complex coefficient (complex128)
    # calibration constants (seconds per unit); fit from measurements
    t_flop: float = 1.0
    t_byte: float = 1.0
    # per-equation work constant (core/equations.py): output channels per
    # target — P2P and L2P scale with it, the coefficient sweeps do not
    nout: int = 1


# ---------------------------------------------------------------------------
# Work estimates (paper Eqs 13-15)
# ---------------------------------------------------------------------------


def work_nonleaf(p: int, n_c: int = N_CHILD, n_il: int = N_IL) -> float:
    """Eq (13): O(p^2 (2 n_c + n_IL)) — M2M + L2L + M2L for one box."""
    return float(p * p * (2 * n_c + n_il))


def work_leaf(n_i: np.ndarray, p: int, n_il: int = N_IL, n_nd: int = N_ND,
              neighbor_counts: np.ndarray | None = None,
              nout: int = 1) -> np.ndarray:
    """Eq (14): O(2 N_i p + p^2 n_IL + n_nd N_i^2) per leaf box.

    If ``neighbor_counts`` (sum of particle counts over the 3x3 stencil) is
    given, the P2P term uses the *exact* N_i * sum_nd N_j product instead of
    the paper's uniform n_nd * N_i^2 surrogate.  ``nout`` is the equation's
    output arity (ModelParams.nout): the P2P pair sum and the L2P half of
    the ``2 N_i p`` term scale with the channel count, the P2M half and the
    shared coefficient sweep do not.
    """
    n_i = np.asarray(n_i, dtype=np.float64)
    p2p = n_i * neighbor_counts if neighbor_counts is not None else n_nd * n_i * n_i
    return (1.0 + nout) * n_i * p + float(p * p * n_il) + p2p * nout


def neighbor_count_sum(counts: np.ndarray) -> np.ndarray:
    """Sum of per-box particle counts over each box's 3x3 near domain."""
    padded = np.pad(counts, 1)
    out = np.zeros_like(counts, dtype=np.float64)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            n = counts.shape[0]
            out += padded[1 + dy:1 + dy + n, 1 + dx:1 + dx + n]
    return out


def work_subtree(counts: np.ndarray, params: ModelParams) -> np.ndarray:
    """Eq (15) evaluated exactly per subtree from leaf occupancy ``counts``.

    counts: (2^L, 2^L) particles per leaf box (row-major grid).
    Returns (4^k,) modeled work per subtree, ordered by subtree grid id
    (row-major over the cut-level grid; use morton reorder for z-order).
    """
    L, k, p = params.level, params.cut, params.p
    nsub = 1 << k
    sub_leaf = 1 << (L - k)            # leaf boxes per subtree side
    # Non-leaf boxes inside one subtree: levels k..L-1 of the global tree
    # (the subtree root sits at cut level k).  Eq 15's first sum.
    nonleaf_boxes = sum(4 ** (l - k) for l in range(k, L))
    w_nonleaf = nonleaf_boxes * work_nonleaf(p)

    nb = neighbor_count_sum(counts)
    w_leaf = work_leaf(counts, p, neighbor_counts=nb,
                       nout=params.nout)                    # (2^L, 2^L)
    w_leaf_sub = w_leaf.reshape(nsub, sub_leaf, nsub, sub_leaf).sum(axis=(1, 3))
    return (w_leaf_sub + w_nonleaf).reshape(-1)


def work_active_total(counts: np.ndarray, params: ModelParams) -> float:
    """Total useful work (for padding-waste metrics on SPMD hardware)."""
    return float(work_subtree(counts, params).sum())


def work_padded_total(counts: np.ndarray, params: ModelParams) -> float:
    """Work actually paid by the dense padded execution (all slots active)."""
    full = np.full_like(counts, params.slots)
    return float(work_subtree(full, params).sum())


def batch_padding_stats(per_job_work: float, n_jobs: int,
                        capacity: int) -> dict[str, float]:
    """Batch-axis pricing for the serving engine's padded vmap lane.

    A bucket executed at ``capacity`` pays the dense per-job work for
    every batch row, occupied or padding — the batch-axis analogue of
    :func:`work_padded_total`'s slot padding.  Returns the paid/useful
    split and the utilization the admission policy can steer on.
    """
    paid = float(per_job_work) * int(capacity)
    useful = float(per_job_work) * int(n_jobs)
    return {"paid": paid, "useful": useful,
            "padding_waste": paid - useful,
            "utilization": (useful / paid) if paid else 1.0}


def array_digest(*arrays) -> str:
    """Stable content digest of host arrays — the value part of artifact
    cache keys (trees keyed by particle data, plans by leaf counts)."""
    h = hashlib.sha1()
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a))
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Communication estimates (paper Eqs 11-12)
# ---------------------------------------------------------------------------


def alpha_comm(p: int, coeff_bytes: int = 16) -> float:
    """Bytes per expansion exchanged: p coefficients of ``coeff_bytes``."""
    return float(p * coeff_bytes)


def comm_lateral(params: ModelParams) -> float:
    """Eq (11): sum_{n=k+1}^{L} alpha * 2^(n-k) * 4.

    Boundary boxes of a subtree facing a lateral neighbor at global level n
    form a line of 2^(n-k) boxes; the factor 4 covers the M2L ghost exchange
    in both directions for both expansion rings (paper §5.1).
    """
    L, k = params.level, params.cut
    a = alpha_comm(params.p, params.coeff_bytes)
    return float(sum(a * (2 ** (n - k)) * 4 for n in range(k + 1, L + 1)))


def comm_diagonal(params: ModelParams) -> float:
    """Eq (12): alpha * (L - k - 1) * 4 — only corner boxes at each level.

    The paper prints ``alpha ((k - L) - 1) * 4``; the cut level k is always
    < L so we read it as the magnitude |L - k| - 1 (one corner box per level
    below the cut, excluding the subtree root).
    """
    L, k = params.level, params.cut
    a = alpha_comm(params.p, params.coeff_bytes)
    return float(a * max(L - k - 1, 0) * 4)


def comm_particles_boundary(params: ModelParams, counts_edge: float) -> float:
    """Ghost-particle traffic for P2P across a subtree face (model extension).

    The paper folds this into 'communication of particles in the local
    domain'; we expose it so the graph can weight particle-heavy boundaries.
    counts_edge: total particles in the boundary boxes of the shared face.
    """
    return PARTICLE_BYTES * counts_edge


def comm_halo_dense(params: ModelParams, slots: int | None = None) -> dict[str, float]:
    """Per-device halo-exchange bytes of the dense slab implementation.

    Implementation-level counterpart of Eqs (11)-(12): a row slab exchanges
    ``M2L_HALO_ROWS`` full rows of ME coefficients per sharded level (both
    directions) and ``P2P_HALO_ROWS`` rows of particle slots at the leaves.
    Parity folding cuts the M2L term by ``1 - M2L_HALO_ROWS/3`` relative to
    the box-granularity ±3 halo.
    """
    L, k, p = params.level, params.cut, params.p
    s = params.slots if slots is None else slots
    m2l = sum(2 * M2L_HALO_ROWS * (2 ** n) * p * params.coeff_bytes
              for n in range(k + 1, L + 1))
    p2p = 2 * P2P_HALO_ROWS * (2 ** L) * s * PARTICLE_BYTES
    return {"m2l": float(m2l), "p2p": float(p2p), "total": float(m2l + p2p)}


def comm_root_tree(params: ModelParams) -> float:
    """M2M/L2L traffic between a subtree and the root tree (per subtree)."""
    return alpha_comm(params.p, params.coeff_bytes) * 2.0


def comm_overlap_effective(comm_bytes, hide_work, params: ModelParams,
                           overlap: bool = True, extra_hide=0.0):
    """Serial-residue cost of an overlapped halo exchange (DESIGN.md §9).

    The paper's running-time model (Eqs 16-20) prices communication as a
    serial term added to compute; the interior/rim driver instead hides the
    exchange behind the tile-interior work, so only the residue
    ``max(0, t_byte * bytes - t_flop * hide_work)`` is paid serially.
    ``hide_work`` is the modeled interior work available to hide behind
    (same units as ``work_leaf`` / ``work_subtree``); without overlap the
    full serial price is returned.  Accepts scalars or per-device arrays.

    ``extra_hide`` is the substep pipeline's ENLARGED hiding budget
    (DESIGN.md §12): additional flops traced between a collective's issue
    and its first consumption — the replicated root-tree sweep the
    pipelined driver defers past the sharded M2L work
    (:func:`work_root_tree`) and the cross-substep window the prefetched
    P2P exchange flies through (:func:`work_upward`).  It simply joins
    ``hide_work`` under the same max(0, ...) residue, so more hiding can
    never price WORSE than less.  Ignored when ``overlap`` is False (the
    serial ordering has nothing in flight).
    """
    t_comm = params.t_byte * np.asarray(comm_bytes, dtype=np.float64)
    if not overlap:
        return t_comm
    hide = (np.asarray(hide_work, dtype=np.float64)
            + np.asarray(extra_hide, dtype=np.float64))
    return np.maximum(0.0, t_comm - params.t_flop * hide)


def work_root_tree(params: ModelParams) -> float:
    """Flops of the replicated root-tree sweep (levels 2..k M2L/L2L plus
    the below-cut M2M chain), paid identically on every device.

    Under the pipelined driver (DESIGN.md §12) this compute runs only at
    the cut-level all_gather's first consumption point — i.e. AFTER all
    sharded-level M2L work — so it is hiding budget for the per-level halo
    exchanges still in flight, on top of the interior extents.
    """
    k, p = params.cut, params.p
    boxes = sum(4 ** l for l in range(2, k + 1))
    return float(boxes * work_nonleaf(p))


def work_upward(params: ModelParams, leaf_boxes) -> np.ndarray:
    """P2M + subtree M2M flops for ``leaf_boxes`` local leaf boxes — the
    substep k+1 compute available to hide a CROSS-substep prefetched P2P
    exchange (DESIGN.md §12): the stepper issues the next substep's packed
    exchange right after rebinning, and the upward sweep of the next
    evaluation runs before the exchanged rim is first read.  Dense layout
    pays every slot, so the P2M term scales with ``params.slots``.
    """
    lb = np.asarray(leaf_boxes, dtype=np.float64)
    p2m = lb * params.slots * 2.0 * params.p
    # subtree M2M boxes above the leaves: sum_{j>=1} 4^-j ~ 1/3 of leaves
    m2m = (lb / 3.0) * params.p * params.p
    return p2m + m2m


# ---------------------------------------------------------------------------
# Memory estimates (paper §5.3, Tables 1 and 2)
# ---------------------------------------------------------------------------


def total_boxes(level: int) -> int:
    """Lambda = sum_l 4^l = (4^(L+1) - 1) / 3."""
    return (4 ** (level + 1) - 1) // 3


def memory_serial(params: ModelParams, n_particles: int) -> dict[str, float]:
    """Table 1 (bytes).  d=2, B=28, Lambda = total boxes, s = slots."""
    L, p, s = params.level, params.p, params.slots
    lam = total_boxes(L)
    d, B = D, PARTICLE_BYTES
    return {
        "box_centers": 8 * d * lam,
        "interaction_boxes": (2 * 4) * lam + (27 * 4) * lam,
        "interaction_values": (2 * 4) * lam + 27 * (8 * d + 16 * p) * lam,
        "multipole_coefficients": 16 * p * lam,
        "temporary_coefficients": 16 * p * lam,
        "local_coefficients": 16 * p * lam,
        "local_particles": (2 * 4) * lam + B * n_particles,
        "neighbor_particles": (2 * 4) * lam + 8 * B * s * (2 ** (d * L)),
    }


def memory_parallel(params: ModelParams, n_procs: int, n_local_trees: int,
                    n_boundary_boxes: int) -> dict[str, float]:
    """Table 2 (bytes): explicitly parallel structures per process."""
    s, A = params.slots, ARROW_BYTES
    return {
        "partition": (2 * 4) * n_procs + 4 * n_local_trees,
        "inverse_partition": 4 * n_local_trees,
        "neighbor_send_overlap": n_boundary_boxes * s * A,
        "neighbor_recv_overlap": n_boundary_boxes * s * A,
        "interaction_send_overlap": 27 * n_boundary_boxes * A,
        "interaction_recv_overlap": 27 * n_boundary_boxes * A,
    }


# ---------------------------------------------------------------------------
# Greengard-Gropp running-time model (paper Eq 10) — kept as the baseline
# model our extension is compared against in benchmarks/fmm_scaling.py.
# ---------------------------------------------------------------------------


def greengard_gropp_time(n: int, n_procs: int, boxes_finest: int,
                         a: float = 1.0, b: float = 1.0, c: float = 1.0,
                         d: float = 1.0) -> float:
    """T = a N/P + b log4(P) + c N/(B P) + d N B / P   (lower-order e dropped)."""
    import math

    P, B = n_procs, boxes_finest
    return (a * n / P + b * math.log(P, 4.0) + c * n / (B * P) + d * n * B / P)
