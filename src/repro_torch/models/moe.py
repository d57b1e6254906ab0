"""Mixture-of-Experts layer on one card, and cost-model expert placement.

The reference's ``models/moe.py`` without its mesh: ``moe_layer`` is the
single-rank path, every expert local.  Tokens are routed to their top-k
experts, gathered into a capacity-padded ``(E, C, D)`` block, run through
the experts' SwiGLU FFNs as batched matrix products, and combined with
their gate weights.  Capacity is per call, ``C = ceil(N k / E * cf)``
(``cf`` the config's capacity factor), and an assignment past its expert's
capacity is dropped, exactly as in the reference: the rank of an
assignment within its expert is the exclusive count of earlier ones in the
flat ``(token, choice)`` order.

``expert_placement`` is the paper's technique transplanted: experts as the
vertices of a weighted graph (token loads) with co-activation edges,
partitioned by ``core/partition.py``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.partition import Graph, partition
from .config import ModelConfig
from .layers import normal_init


def init_moe(generator: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
             device=None) -> dict:
    """The router stays f32, the dtype in which routing reads it."""
    m = cfg.moe
    D, E, Fd = cfg.d_model, m.num_experts, m.expert_ff
    return {
        "router": normal_init(generator, (D, E), D ** -0.5, torch.float32, device),
        "experts_gate": normal_init(generator, (E, D, Fd), D ** -0.5, dtype, device),
        "experts_in": normal_init(generator, (E, D, Fd), D ** -0.5, dtype, device),
        "experts_out": normal_init(generator, (E, Fd, D), Fd ** -0.5, dtype, device),
    }


def capacity(num_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for one call over ``num_tokens`` tokens."""
    m = cfg.moe
    return max(int(math.ceil(num_tokens * m.top_k / m.num_experts * m.capacity_factor)), 1)


def route(x: torch.Tensor, router: torch.Tensor, *, top_k: int, capacity: int):
    """Routing of ``x`` (N, D) over the router's E experts.

    Returns, per flat ``(token, choice)`` assignment in token-major order,
    ``(flat_e, flat_w, slot, keep)``: the expert, its softmax weight over
    the token's top-k logits, the row of the ``(E * capacity + 1)`` gather
    buffer it lands in (the last row is the overflow bin), and whether it is
    within capacity.
    """
    E = router.shape[1]
    logits = x.to(torch.float32) @ router.to(torch.float32)          # (N, E)
    gate_w, gate_e = torch.topk(logits, top_k, dim=-1)               # sorted
    gate_w = torch.softmax(gate_w, dim=-1)
    flat_e, flat_w = gate_e.reshape(-1), gate_w.reshape(-1)
    # rank of each assignment within its expert: the exclusive count of
    # earlier ones, read off a stable sort by expert
    order = torch.sort(flat_e, stable=True).indices
    # counted by an integer index_add (exact in any order; bincount would
    # wait on the host for the largest key)
    counts = torch.zeros(E, dtype=flat_e.dtype, device=x.device).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    first = torch.cumsum(counts, dim=0) - counts          # each expert's first place
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=x.device) - first[flat_e[order]]
    keep = rank < capacity
    slot = torch.where(keep, flat_e * capacity + rank, E * capacity)
    return flat_e, flat_w, slot, keep


def _moe_local(x, router, wg, wi, wo, *, top_k: int, capacity: int):
    """MoE over every expert: x (N, D) -> (N, D)."""
    N, D = x.shape
    E = wg.shape[0]
    _, flat_w, slot, keep = route(x, router, top_k=top_k, capacity=capacity)
    flat_tok = torch.arange(N, device=x.device).repeat_interleave(top_k)
    # gather into (E * capacity + 1, D); the overflow bin is dropped
    xe = torch.zeros((E * capacity + 1, D), dtype=x.dtype, device=x.device)
    xe[slot] = torch.where(keep[:, None], x[flat_tok], 0)
    xe = xe[:-1].reshape(E, capacity, D)
    dt = x.dtype
    h = F.silu(torch.bmm(xe, wg.to(dt))) * torch.bmm(xe, wi.to(dt))
    ye = torch.bmm(h, wo.to(dt))                                      # (E, C, D)
    yflat = torch.cat([ye.reshape(-1, D), torch.zeros((1, D), dtype=dt, device=x.device)])
    ytok = yflat[slot] * flat_w[:, None].to(dt)
    ytok = torch.where(keep[:, None], ytok, 0)
    # each token has exactly top_k contributions, token-major: a fixed-order
    # sum (a scatter-add would add in another order on every run)
    return ytok.reshape(N, top_k, D).sum(dim=1)


def moe_layer(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, T, D) -> (B, T, D), every expert on this card."""
    B, T, D = x.shape
    m = cfg.moe
    out = _moe_local(x.reshape(B * T, D), p["router"], p["experts_gate"],
                     p["experts_in"], p["experts_out"], top_k=m.top_k,
                     capacity=capacity(B * T, cfg))
    return out.reshape(B, T, D)


# ---------------------------------------------------------------------------
# Cost-model expert placement (host numpy)
# ---------------------------------------------------------------------------


def expert_placement(token_counts: np.ndarray, coactivation: np.ndarray,
                     num_ranks: int) -> np.ndarray:
    """Assign experts to ranks balancing load and minimizing co-traffic.

    token_counts: (E,) tokens routed per expert (vertex weights);
    coactivation: (E, E) counts of experts chosen together for a token
    (edge weights).  Returns (E,) the rank of each expert.
    """
    E = len(token_counts)
    adjacency = [[] for _ in range(E)]
    for i in range(E):
        for j in range(i + 1, E):
            if coactivation[i, j] > 0:
                adjacency[i].append((j, float(coactivation[i, j])))
                adjacency[j].append((i, float(coactivation[i, j])))
    g = Graph(vertex_weight=np.asarray(token_counts, np.float64), adjacency=adjacency)
    return partition(g, num_ranks, method="model",
                     order=np.argsort(-np.asarray(token_counts)))


def placement_permutation(assign: np.ndarray, num_ranks: int) -> np.ndarray:
    """Expert-id permutation so that rank r's contiguous shard holds its
    experts, every rank exactly ``E // num_ranks`` of them: a rank over
    that count gives its last experts to ranks under it."""
    E = len(assign)
    per = E // num_ranks
    buckets = [list(np.where(assign == r)[0]) for r in range(num_ranks)]
    overflow = []
    for b in buckets:
        while len(b) > per:
            overflow.append(b.pop())
    for b in buckets:
        while len(b) < per:
            b.append(overflow.pop())
    return np.concatenate([np.asarray(b, np.int64) for b in buckets])
