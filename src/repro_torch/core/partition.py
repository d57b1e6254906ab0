"""Weighted-graph build and load-balancing partitioner (paper §4).

The paper cuts the FMM tree at level k, producing 4^k subtrees, builds a
weighted graph (vertex weight = modeled work, edge weight = modeled
communication) and partitions it with ParMETIS.  ParMETIS is not available
here, so we implement the same pipeline natively:

  * space-filling-curve (Morton) seeding — also the *baseline* uniform
    partition the paper compares against (DPMTA-style equal split),
  * greedy weight-balanced SFC split,
  * Fiduccia–Mattheyses/Kernighan–Lin boundary refinement (min cut subject
    to a balance constraint).

The module is generic: the same engine places FMM subtrees on devices and
MoE experts on expert-parallel ranks (DESIGN.md §4), and `rebalance` folds
measured execution times back into the weights (straggler mitigation /
heterogeneous pools — the paper's "dynamic" load balancing).  Host numpy
only: the port's own copy of the reference package's partitioner.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .cost_model import (
    ModelParams,
    comm_diagonal,
    comm_lateral,
    comm_particles_boundary,
    work_subtree,
)
from .quadtree import morton_encode


@dataclasses.dataclass
class Graph:
    """Undirected weighted graph in CSR-ish adjacency-list form."""

    vertex_weight: np.ndarray          # (V,) float
    adjacency: list[list[tuple[int, float]]]  # per-vertex [(nbr, edge_w)]

    @property
    def num_vertices(self) -> int:
        return len(self.vertex_weight)

    def edge_cut(self, assign: np.ndarray) -> float:
        cut = 0.0
        for u, nbrs in enumerate(self.adjacency):
            for v, w in nbrs:
                if v > u and assign[u] != assign[v]:
                    cut += w
        return cut

    def part_loads(self, assign: np.ndarray, nparts: int) -> np.ndarray:
        return np.bincount(assign, weights=self.vertex_weight, minlength=nparts)


def build_subtree_graph(counts: np.ndarray, params: ModelParams) -> Graph:
    """Paper §4/§5: subtree graph with modeled work and comm weights.

    counts: (2^L, 2^L) per-leaf-box particle counts.  Vertices are the 4^k
    subtrees in row-major cut-grid order.
    """
    k = params.cut
    nsub = 1 << k
    L = params.level
    sub_leaf = 1 << (L - k)

    vw = work_subtree(counts, params)  # (4^k,)

    lat = comm_lateral(params)
    diag = comm_diagonal(params)
    # particles on each subtree face (for the ghost-particle traffic term)
    csub = counts.reshape(nsub, sub_leaf, nsub, sub_leaf)
    face = {
        "N": csub[:, 0, :, :].sum(axis=-1),   # top row of each subtree
        "S": csub[:, -1, :, :].sum(axis=-1),
        "W": csub[:, :, :, 0].sum(axis=1),
        "E": csub[:, :, :, -1].sum(axis=1),
    }

    adjacency: list[list[tuple[int, float]]] = [[] for _ in range(nsub * nsub)]

    def vid(iy: int, ix: int) -> int:
        return iy * nsub + ix

    for iy in range(nsub):
        for ix in range(nsub):
            for dy, dx in ((0, 1), (1, 0), (1, 1), (1, -1)):
                jy, jx = iy + dy, ix + dx
                if not (0 <= jy < nsub and 0 <= jx < nsub):
                    continue
                if dy == 0:      # E-W lateral
                    ghost = face["E"][iy, ix] + face["W"][jy, jx]
                    w = lat + comm_particles_boundary(params, ghost)
                elif dx == 0:    # N-S lateral
                    ghost = face["S"][iy, ix] + face["N"][jy, jx]
                    w = lat + comm_particles_boundary(params, ghost)
                else:            # diagonal
                    w = diag
                u, v = vid(iy, ix), vid(jy, jx)
                adjacency[u].append((v, w))
                adjacency[v].append((u, w))

    return Graph(vertex_weight=vw.astype(np.float64), adjacency=adjacency)


def morton_order(nsub: int) -> np.ndarray:
    """Row-major vertex ids sorted by Morton code (the SFC traversal)."""
    iy, ix = np.divmod(np.arange(nsub * nsub), nsub)
    codes = morton_encode(ix.astype(np.uint32), iy.astype(np.uint32))
    return np.argsort(codes, kind="stable")


# ---------------------------------------------------------------------------
# Partitioners
# ---------------------------------------------------------------------------


def partition_uniform_sfc(num_vertices: int, nparts: int,
                          order: np.ndarray | None = None) -> np.ndarray:
    """Baseline: equal *count* contiguous SFC split (paper's strawman)."""
    order = np.arange(num_vertices) if order is None else order
    assign = np.empty(num_vertices, dtype=np.int64)
    bounds = np.linspace(0, num_vertices, nparts + 1).astype(int)
    for part in range(nparts):
        assign[order[bounds[part]:bounds[part + 1]]] = part
    return assign


def partition_weighted_sfc(vertex_weight: np.ndarray, nparts: int,
                           order: np.ndarray | None = None) -> np.ndarray:
    """Greedy weight-balanced contiguous split along the SFC."""
    V = len(vertex_weight)
    order = np.arange(V) if order is None else order
    w = vertex_weight[order]
    cum = np.cumsum(w)
    total = cum[-1]
    assign = np.empty(V, dtype=np.int64)
    start = 0
    for part in range(nparts):
        if part == nparts - 1:
            end = V
        else:
            target = total * (part + 1) / nparts
            idx = int(np.searchsorted(cum, target, side="left"))
            # boundary closest to the target load (unbiased for equal weights)
            if idx + 1 <= V and idx >= 1 and \
                    abs(cum[idx - 1] - target) <= abs(cum[min(idx, V - 1)] - target):
                end = idx
            else:
                end = idx + 1
            end = max(end, start + 1)
            end = min(end, V - (nparts - part - 1))
        assign[order[start:end]] = part
        start = end
    return assign


def refine_fm(graph: Graph, assign: np.ndarray, nparts: int,
              imbalance_tol: float = 0.05, max_passes: int = 8,
              comm_scale: float = 1.0) -> np.ndarray:
    """Fiduccia–Mattheyses-style boundary refinement.

    Moves boundary vertices to the adjacent part with the largest gain
    (cut-weight reduction, plus a load-balance gain term) while keeping
    every part's load under (1 + tol) * average.  This is the ParMETIS
    stand-in; passes terminate when no improving move exists.
    """
    assign = assign.copy()
    loads = graph.part_loads(assign, nparts)
    avg = loads.sum() / nparts
    cap = (1.0 + imbalance_tol) * avg
    floor = (1.0 - imbalance_tol) * avg
    vw = graph.vertex_weight

    for _ in range(max_passes):
        moved = 0
        for u in np.argsort(-vw):  # heavy vertices first
            pu = assign[u]
            # balance constraints: never overfill the target NOR drain the
            # source below the floor (else min/max LB collapses on uniform
            # distributions — the paper's own lattice case)
            if loads[pu] - vw[u] < floor:
                continue
            # connectivity of u to each part
            conn = {}
            for v, w in graph.adjacency[u]:
                conn[assign[v]] = conn.get(assign[v], 0.0) + w
            internal = conn.get(pu, 0.0)
            best_gain, best_part = 0.0, pu
            for pv, wv in conn.items():
                if pv == pu:
                    continue
                if loads[pv] + vw[u] > cap:
                    continue
                gain = comm_scale * (wv - internal)
                # balance gain: moving off an overloaded part is worth it
                gain += max(loads[pu] - avg, 0.0) - max(loads[pv] + vw[u] - avg, 0.0)
                if gain > best_gain:
                    best_gain, best_part = gain, pv
            if best_part != pu:
                loads[pu] -= vw[u]
                loads[best_part] += vw[u]
                assign[u] = best_part
                moved += 1
        if moved == 0:
            break
    return assign


def partition(graph: Graph, nparts: int, method: str = "model",
              order: np.ndarray | None = None,
              imbalance_tol: float = 0.05) -> np.ndarray:
    """Produce a subtree -> part assignment.

    method='uniform-sfc'  equal-count SFC split (baseline; no cost model)
    method='sfc'          weight-balanced SFC split (model, no refinement)
    method='model'        weight-balanced SFC seed + FM min-cut refinement
                          (the paper's full pipeline)
    """
    if nparts <= 1:
        return np.zeros(graph.num_vertices, dtype=np.int64)
    nsub = int(round(np.sqrt(graph.num_vertices)))
    if order is None and nsub * nsub == graph.num_vertices:
        order = morton_order(nsub)
    if method == "uniform-sfc":
        return partition_uniform_sfc(graph.num_vertices, nparts, order)
    seed = partition_weighted_sfc(graph.vertex_weight, nparts, order)
    if method == "sfc":
        return seed
    if method == "model":
        return refine_fm(graph, seed, nparts, imbalance_tol)
    raise ValueError(f"unknown partition method: {method}")


# ---------------------------------------------------------------------------
# Quality metrics and dynamic feedback
# ---------------------------------------------------------------------------


def load_balance_metric(graph: Graph, assign: np.ndarray, nparts: int) -> float:
    """Paper Eq (20) on modeled work: min part load / max part load."""
    loads = graph.part_loads(assign, nparts)
    return float(loads.min() / loads.max()) if loads.max() > 0 else 1.0


def partition_stats(graph: Graph, assign: np.ndarray, nparts: int) -> dict:
    loads = graph.part_loads(assign, nparts)
    return {
        "edge_cut": graph.edge_cut(assign),
        "load_balance": load_balance_metric(graph, assign, nparts),
        "max_load": float(loads.max()),
        "mean_load": float(loads.mean()),
        "imbalance": float(loads.max() / loads.mean()) if loads.mean() else 1.0,
    }


def measured_rates(loads: np.ndarray, measured_times: np.ndarray) -> np.ndarray:
    """Per-part slowdown rate (seconds per modeled work unit).

    If part p ran ``measured_times[p]`` seconds for modeled load W_p, its
    rate is t_p / W_p; empty or unmeasured parts inherit the mean positive
    rate.  This is the feedback signal both ``rebalance`` (2-D subtree
    weights) and ``plan.replan`` (1-D row-band weights) apply.
    """
    loads = np.asarray(loads, dtype=np.float64)
    t = np.asarray(measured_times, dtype=np.float64)
    rate = np.where(loads > 0, t / np.maximum(loads, 1e-30), 0.0)
    return np.where(rate > 0, rate,
                    rate[rate > 0].mean() if (rate > 0).any() else 1.0)


def rebalance(graph: Graph, assign: np.ndarray, nparts: int,
              measured_times: np.ndarray,
              imbalance_tol: float = 0.05) -> np.ndarray:
    """Dynamic feedback: fold measured per-part times into the weights.

    Every vertex in part p gets its weight scaled by p's ``measured_rates``
    slowdown before re-partitioning.  This reproduces the DPMTA-style
    measured rebalancing the paper discusses (§4) but keeps it
    model-driven, and doubles as straggler mitigation in the trainer.
    """
    rate = measured_rates(graph.part_loads(assign, nparts), measured_times)
    scaled = Graph(vertex_weight=graph.vertex_weight * rate[assign],
                   adjacency=graph.adjacency)
    return partition(scaled, nparts, method="model", imbalance_tol=imbalance_tol)
