"""Mixture-of-Experts layer, on one card or with its experts over a grid's
model axis, and cost-model expert placement.

The reference's ``models/moe.py``.  Tokens are routed to their top-k
experts, gathered into a capacity-padded ``(E, C, D)`` block, run through
the experts' SwiGLU FFNs as batched matrix products, and combined with
their gate weights.  Capacity is per call, ``C = ceil(N k / E * cf)``
(``cf`` the config's capacity factor), and an assignment past its expert's
capacity is dropped, exactly as in the reference: the rank of an
assignment within its expert is the exclusive count of earlier ones in the
flat ``(token, choice)`` order.

With a grid (``launch/mesh.py:GridMesh``) whose model axis holds more than
one rank, ``moe_layer`` is the reference's replicated-dispatch expert
parallelism, its ``shard_map`` body written out: activations are this data
rank's rows, replicated over the model axis; model rank ``m`` holds experts
``[m E_l, (m + 1) E_l)`` with their dim 1 split over the data axes (FSDP).
Each rank gathers its experts' dim 1 back (``make_fsdp_gather_q8`` or the
16-bit gather), routes its rows over all ``E`` experts, keeps the
assignments to its own (capacity from its own rows, as the reference's
per-shard count), and one all-reduce over the model axis adds the ranks'
partial outputs.  The pair :func:`copy_to_model` / :func:`reduce_from_model`
is what the ``shard_map`` specs imply for autograd: ``x`` and the router
enter replicated over the model axis, so each model rank's gradient of them
covers its own experts only and the backward sums them; the output leaves
through the sum, whose backward is the identity.

On a grid whose model axis holds one rank and whose batch axes hold more,
``moe_layer`` routes as the reference's one-rank path does on the global
batch (one capacity for all its tokens), each data rank its own rows.

``expert_placement`` is the paper's technique transplanted: experts as the
vertices of a weighted graph (token loads) with co-activation edges,
partitioned by ``core/partition.py``.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.partition import Graph, partition
from ..parallel.sharding import (axis_size, batch_axes, block_shape, normalize_spec,
                                 param_spec)
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


def route(x: torch.Tensor, router: torch.Tensor, *, top_k: int, capacity: int,
          e_start: int = 0, e_local: Optional[int] = None,
          choices: Optional[torch.Tensor] = None, before=None,
          slots: Optional[int] = None):
    """Routing of ``x`` (N, D) over the router's E experts, kept for the
    ``e_local`` experts from ``e_start`` on (all E by default).  ``choices``
    (N, top_k), when given, are the experts each token takes in place of
    its top-k (their weights the softmax of its logits at them): a check
    that holds one run to another routes both alike, since a near tie
    among the logits may fall either way under f32 sums in another order.

    Returns, per flat ``(token, choice)`` assignment in token-major order,
    ``(flat_e, flat_w, slot, keep)``: the expert, its softmax weight over
    the token's top-k logits, the row of the ``(e_local * slots + 1)``
    gather buffer it lands in (the last row is the overflow bin; ``slots``
    is ``capacity`` by default), and whether it is one of the kept
    experts' and within capacity.  The rank of an assignment within its
    expert counts the earlier assignments to that expert: this rank's, and
    with ``before`` those of the ranks ahead of it in the global batch's
    token order (``before(counts)`` maps this rank's (e_local,) counts to
    theirs, summed).  Its slot is its rank among this rank's own.
    """
    E = router.shape[1]
    e_local = E if e_local is None else e_local
    slots = capacity if slots is None else slots
    logits = x.to(torch.float32) @ router.to(torch.float32)          # (N, E)
    if choices is None:
        gate_w, gate_e = torch.topk(logits, top_k, dim=-1)           # sorted
    else:
        gate_e = choices.to(device=x.device, dtype=torch.long)
        gate_w = torch.gather(logits, -1, gate_e)
    gate_w = torch.softmax(gate_w, dim=-1)
    flat_e, flat_w = gate_e.reshape(-1), gate_w.reshape(-1)
    local_e = flat_e - e_start
    mine = (local_e >= 0) & (local_e < e_local)
    local_e = torch.where(mine, local_e, e_local)    # the others: one bucket past
    # rank of each assignment within its expert: the exclusive count of
    # earlier ones, read off a stable sort by expert
    order = torch.sort(local_e, stable=True).indices
    # counted by an integer index_add (exact in any order; bincount would
    # wait on the host for the largest key)
    counts = torch.zeros(e_local + 1, dtype=flat_e.dtype, device=x.device).index_add_(
        0, local_e, torch.ones_like(local_e))
    first = torch.cumsum(counts, dim=0) - counts          # each expert's first place
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=x.device) - first[local_e[order]]
    ahead = rank
    if before is not None:
        prior = torch.cat([before(counts[:e_local]), counts.new_zeros(1)])
        ahead = rank + prior[local_e]
    keep = mine & (ahead < capacity)
    slot = torch.where(keep, local_e * slots + rank, e_local * slots)
    return flat_e, flat_w, slot, keep


def _moe_local(x, router, wg, wi, wo, *, top_k: int, capacity: int, e_start: int = 0,
               before=None, slots: Optional[int] = None):
    """MoE over the experts ``wg``/``wi``/``wo`` hold (from ``e_start`` on):
    x (N, D) -> (N, D), the sum of those experts' contributions
    (``before`` and ``slots`` as :func:`route` takes them)."""
    N, D = x.shape
    E_local = wg.shape[0]
    slots = capacity if slots is None else slots
    _, flat_w, slot, keep = route(x, router, top_k=top_k, capacity=capacity,
                                  e_start=e_start, e_local=E_local, before=before,
                                  slots=slots)
    flat_tok = torch.arange(N, device=x.device).repeat_interleave(top_k)
    # gather into (E_local * slots + 1, D); the overflow bin is dropped
    xe = torch.zeros((E_local * slots + 1, D), dtype=x.dtype, device=x.device)
    xe[slot] = torch.where(keep[:, None], x[flat_tok], 0)
    xe = xe[:-1].reshape(E_local, slots, D)
    dt = x.dtype
    h = F.silu(torch.bmm(xe, wg.to(dt))) * torch.bmm(xe, wi.to(dt))
    ye = torch.bmm(h, wo.to(dt))                                      # (E, C, D)
    yflat = torch.cat([ye.reshape(-1, D), torch.zeros((1, D), dtype=dt, device=x.device)])
    ytok = yflat[slot] * flat_w[:, None].to(dt)
    ytok = torch.where(keep[:, None], ytok, 0)
    # each token has exactly top_k contributions, token-major: a fixed-order
    # sum (a scatter-add would add in another order on every run)
    return ytok.reshape(N, top_k, D).sum(dim=1)


# ---------------------------------------------------------------------------
# The grid's collectives under autograd
# ---------------------------------------------------------------------------


class _CopyTo(torch.autograd.Function):
    """Forward the identity; backward the sum over ``axes``."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_sum(g, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    """Forward the sum over ``axes``; backward the identity."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.all_reduce_sum(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to(x, mesh, axes):
    """``x`` entering a computation replicated over ``axes``: the identity,
    whose backward adds the ranks' partial gradients over ``axes``."""
    return _CopyTo.apply(x, mesh, axes)


def reduce_from(x, mesh, axes):
    """The sum of the ranks' partial ``x`` over ``axes``, whose backward
    hands each rank the gradient as it is."""
    return _ReduceFrom.apply(x, mesh, axes)


def copy_to_model(x, mesh):
    return copy_to(x, mesh, ("model",))


def reduce_from_model(x, mesh):
    return reduce_from(x, mesh, ("model",))


class _Gather(torch.autograd.Function):
    """All-gather on dim 1 over ``axes``; backward ``reduce_scatter`` of the
    cotangent, in its dtype, over the same axes."""

    @staticmethod
    def forward(ctx, w, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh.all_gather(w, axes, dim=1)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(g, ctx.axes, dim=1), None, None


def fsdp_gather(w, mesh, axes, compute_dtype):
    """The 16-bit FSDP gather: cast to the compute dtype, then all-gather
    dim 1 over ``axes`` (the wire carries the compute dtype)."""
    return _Gather.apply(w.to(compute_dtype), mesh, axes)


class _GatherQ8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, mesh, axes, compute_dtype):
        ctx.mesh, ctx.axes, ctx.dtype = mesh, axes, w.dtype
        scale = torch.amax(torch.abs(w), dim=(1, 2), keepdim=True) / 127.0 + 1e-12
        q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
        qg = mesh.all_gather(q, axes, dim=1)
        sg = mesh.all_gather(scale, axes, dim=1)                      # (E, nsh, 1)
        e, d_full, f = qg.shape
        nsh = sg.shape[1]
        blocks = qg.reshape(e, nsh, d_full // nsh, f).to(compute_dtype)
        return (blocks * sg[..., None].to(compute_dtype)).reshape(e, d_full, f)

    @staticmethod
    def backward(ctx, g):
        gl = ctx.mesh.reduce_scatter(g.to(torch.float32), ctx.axes, dim=1)
        return gl.to(ctx.dtype), None, None, None


def make_fsdp_gather_q8(axes, compute_dtype):
    """int8-quantized FSDP all-gather with a straight-through backward.

    Forward: per-expert absmax int8 quantization of the local dim-1 block
    (``round`` half to even, as ``jnp.round``), an all-gather of the int8
    payload and of the per-(expert, shard) scales, dequantized into the
    compute dtype: the wire carries 1 byte an element.  Backward: the
    exact adjoint of a tiled all-gather (``reduce_scatter`` of the f32
    cotangent), the quantizer treated as the identity (STE).  Returns
    ``gather(w, mesh)``."""
    def gather(w, mesh):
        return _GatherQ8.apply(w, mesh, axes, compute_dtype)
    return gather


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------


def _fsdp_axes(mesh, dim1: int):
    """The reference's chain for the experts' dim 1 (``moe.py:160-167``):
    every batch axis when their product divides it, else ``data`` alone
    when it does, else None."""
    dp_axes = batch_axes(mesh)
    dp = axis_size(mesh, dp_axes)
    if dp > 1 and dim1 % dp == 0:
        return dp_axes
    if "data" in mesh.axis_names and mesh.shape["data"] > 1 \
            and dim1 % mesh.shape["data"] == 0:
        return ("data",)
    return None


def _ranks_ahead(mesh, axes):
    """``before`` for :func:`route` over the data ranks ``axes``: the
    per-expert counts of the ranks whose rows come earlier in the global
    batch (an all-gather of every rank's counts, summed over those
    ahead)."""
    def before(counts):
        every = mesh.all_gather(counts[None], axes, dim=0)          # (ranks, E)
        return every[:mesh.axis_index(axes)].sum(dim=0)
    return before


def moe_layer(p, x: torch.Tensor, cfg: ModelConfig, mesh=None,
              placement: Optional[np.ndarray] = None, *, rows_split: bool = True) -> torch.Tensor:
    """x: (B, T, D) -> (B, T, D).

    Without a grid, or on a grid of one rank, every expert is on this card
    and capacity counts all of ``x``'s tokens.  On a grid of more ranks
    ``p``'s experts are this rank's blocks as ``parallel/sharding.py:
    param_spec`` stores them, ``(E / M, D / n_fsdp, F)``, gathered back
    over their FSDP dim; the router is whole.  ``x`` is this data rank's
    rows (``rows_split``; else every data rank holds the whole batch).
    Where the model axis holds more than one rank, this is the reference's
    expert parallelism (module docstring).  Where it holds one, the
    reference routes the global batch on every device: one capacity from
    the global token count, and each assignment's place within its expert
    counts the earlier data ranks' assignments to it (``_ranks_ahead``)
    before this rank's own; this rank computes its own rows' tokens.
    ``placement`` (a permutation of expert ids, the cost-model placement)
    is taken as the reference takes it: the expert weights are permuted
    where they are loaded, so it changes nothing here.
    """
    B, T, D = x.shape
    m = cfg.moe
    if mesh is None or mesh.size == 1:
        out = _moe_local(x.reshape(B * T, D), p["router"], p["experts_gate"],
                         p["experts_in"], p["experts_out"], top_k=m.top_k,
                         capacity=capacity(B * T, cfg))
        return out.reshape(B, T, D)

    tp = mesh.shape.get("model", 1)
    if m.num_experts % tp:
        raise ValueError(f"{m.num_experts} experts do not split over {tp} model ranks")
    e_local = m.num_experts // tp
    fsdp_ax = _fsdp_axes(mesh, D)
    want = ("model", fsdp_ax, None)
    shapes = {"experts_gate": (m.num_experts, D, m.expert_ff),
              "experts_in": (m.num_experts, D, m.expert_ff),
              "experts_out": (m.num_experts, m.expert_ff, D)}
    for name, shape in shapes.items():
        spec = param_spec(mesh, name, shape)
        if normalize_spec(spec, mesh) != normalize_spec(want, mesh):
            raise ValueError(f"moe_layer: {name} {shape} is stored as {spec} but "
                             f"the layer reads it as {want}; the port does not "
                             f"reshard")
        if tuple(p[name].shape) != block_shape(mesh, spec, shape):
            raise ValueError(f"moe_layer: {name} is {tuple(p[name].shape)}, not "
                             f"this rank's block {block_shape(mesh, spec, shape)}")
    dt = x.dtype
    wg, wi, wo = p["experts_gate"], p["experts_in"], p["experts_out"]
    if fsdp_ax is not None:
        if cfg.moe_gather_bits == 8:
            gather = make_fsdp_gather_q8(fsdp_ax, dt)
            wg, wi, wo = gather(wg, mesh), gather(wi, mesh), gather(wo, mesh)
        else:
            wg, wi, wo = (fsdp_gather(w, mesh, fsdp_ax, dt) for w in (wg, wi, wo))
    rest = tuple(a for a in batch_axes(mesh) if a not in (fsdp_ax or ()))
    if axis_size(mesh, rest) > 1:
        # experts replicated over a batch axis: their gradient sums over it
        wg, wi, wo = (copy_to(w, mesh, rest) for w in (wg, wi, wo))
    N = B * T
    if tp == 1:
        dp_axes = batch_axes(mesh)
        glob = rows_split and axis_size(mesh, dp_axes) > 1
        cap = capacity(N * (axis_size(mesh, dp_axes) if glob else 1), cfg)
        out = _moe_local(x.reshape(N, D), p["router"], wg, wi, wo, top_k=m.top_k,
                         capacity=cap, before=_ranks_ahead(mesh, dp_axes) if glob else None,
                         slots=min(cap, N))
        return out.reshape(B, T, D)
    xs = copy_to_model(x, mesh)
    router = copy_to_model(p["router"], mesh)
    out = _moe_local(xs.reshape(N, D), router, wg, wi, wo, top_k=m.top_k,
                     capacity=capacity(N, cfg),              # this data rank's rows: per shard
                     e_start=mesh.axis_index("model") * e_local)
    return reduce_from_model(out, mesh).reshape(B, T, D)


def moe_param_specs(mesh) -> dict:
    """The reference's specs of the MoE parameters: experts over the model
    axis (EP), every other dim whole.  This is the expert-parallel view
    alone: ``param_spec`` also splits the experts' dim 1 over the batch
    axes where it divides (FSDP), and ``moe_layer`` reads the experts as
    ``param_spec`` stores them, so it takes blocks of these specs only on
    a grid whose batch axes hold one rank."""
    return {
        "router": (None, None),
        "experts_gate": ("model", None, None),
        "experts_in": ("model", None, None),
        "experts_out": ("model", None, None),
    }


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
