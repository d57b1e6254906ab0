"""The grid's layout of the dense blocks, shared by training and serving.

The reference keeps its parameters under ``param_shardings`` and lets GSPMD
place the work; the port has no compiler, so this module writes out one
rank's program on a ``launch/mesh.py:GridMesh`` (``(data, model)`` or
``(pod, data, model)``), the layout ``parallel/sharding.py:param_spec``
gives (its "TP: attention heads / FFN hidden / vocab over 'model'"):

* A weight is this rank's block.  :func:`weight` gathers it just where a
  block uses it, over every dim but one it keeps split over the model
  axis; so under a layer's checkpoint the gathered weight dies at the
  layer's end and is gathered again in remat's recompute.  Its backward is
  the gradient of this rank's block: summed over the batch axes (a
  ``reduce_scatter`` on a dim split over them, else an all-reduce), and on
  a dim gathered over the model axis either sliced (the compute was the
  same on every model rank) or, for a weight that each model rank uses a
  part of (``partial``), summed there too.
* Attention splits its query heads over the model axis where their count
  divides it and each rank's heads read whole KV heads (:func:`q_split`):
  each rank projects its heads from its column blocks of ``w_q``/``w_k``/
  ``w_v`` (or slices them from the gathered weight, where the blocks are
  not those heads), attends them, and multiplies by its row block of
  ``w_o``; one all-reduce over ``model`` ends the block.  Otherwise the
  block runs whole on every model rank.
* The SwiGLU MLP splits its hidden dim where ``w_gate``, ``w_in`` and
  ``w_out`` all split it (:func:`mlp`); the embedding and the vocab of the
  loss split where the table's rows do.
* Under autograd the pair ``copy_to_model``/``reduce_from_model``
  (``models/moe.py``) brackets each split: the block's input enters
  replicated over the model axis, so its gradient sums the ranks' parts,
  and the output leaves through the sum, whose backward is the identity.

Recurrent layers run whole on every model rank.  The experts keep their
own expert parallelism (``models/moe.py:moe_layer``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import sharding as shd
from . import layers as ll
from .config import ModelConfig
from .moe import copy_to_model, reduce_from_model

__all__ = ["model_split", "weight", "whole", "q_split", "kv_layout", "proj_heads",
           "row_block", "head_range", "mlp", "attention", "embed", "copy_to_model",
           "reduce_from_model"]


def model_split(spec, mesh, dim: int) -> bool:
    """Whether ``spec`` splits ``dim`` over the model axis alone."""
    if mesh.shape.get("model", 1) == 1 or dim >= len(spec):
        return False
    return shd.normalize_spec(spec, mesh)[dim] == ("model",)


def _grad_block(g: torch.Tensor, spec, mesh, keep, partial: bool) -> torch.Tensor:
    """This rank's block, under ``spec``, of the gradient ``g`` of the
    gathered weight (dim ``keep`` already a block)."""
    batch = shd.batch_axes(mesh)
    if any(set(shd.spec_axes(e)) & set(batch) and not set(shd.spec_axes(e)) <= set(batch)
           for e in spec):
        raise ValueError(f"spec {spec} mixes batch and other axes on one dim")
    summed: set = set()
    for d, entry in enumerate(spec):
        axes = shd.spec_axes(entry)
        if d != keep and axes and set(axes) <= set(batch) and shd.axis_size(mesh, axes) > 1:
            g = mesh.reduce_scatter(g, axes, dim=d)
            summed |= set(axes)
    rest = tuple(a for a in batch if a not in summed)
    if shd.axis_size(mesh, rest) > 1:
        g = mesh.all_reduce_sum(g, rest)
    model_done = False
    for d, entry in enumerate(spec):
        axes = shd.spec_axes(entry)
        if d == keep or not axes or set(axes) & set(batch) or shd.axis_size(mesh, axes) == 1:
            continue
        if partial:
            g = mesh.reduce_scatter(g, axes, dim=d)
            model_done = True
        else:
            size = g.shape[d] // shd.axis_size(mesh, axes)
            g = g.narrow(d, mesh.axis_index(axes) * size, size).clone()
    if partial and not model_done and mesh.shape.get("model", 1) > 1:
        g = mesh.all_reduce_sum(g, ("model",))
    return g


class _Weight(torch.autograd.Function):
    """A block -> the weight gathered on every dim but ``keep``; backward
    :func:`_grad_block`."""

    @staticmethod
    def forward(ctx, block, mesh, spec, keep, partial):
        ctx.mesh, ctx.spec, ctx.keep, ctx.partial = mesh, spec, keep, partial
        out = block
        for d, entry in enumerate(spec):
            axes = shd.spec_axes(entry)
            if d == keep or shd.axis_size(mesh, axes or None) == 1:
                continue
            out = mesh.all_gather(out, axes, dim=d)
        return out if out is not block else block.view_as(block)

    @staticmethod
    def backward(ctx, g):
        return _grad_block(g, ctx.spec, ctx.mesh, ctx.keep, ctx.partial), None, None, None, None


def weight(t: torch.Tensor, spec, mesh, keep=None, partial: bool = False):
    """``t`` (a block under ``spec``) gathered on every dim but ``keep``
    when ``keep`` is split over the model axis alone, which stays this
    rank's block; returns (tensor, whether ``keep`` stayed split).
    ``partial``: each model rank uses a different part of the gathered
    weight, so its gradient is summed over the model axis."""
    split = keep is not None and model_split(spec, mesh, keep)
    return _Weight.apply(t, mesh, tuple(spec), keep if split else None, partial), split


def whole(tree, prefix: str, by_name: dict, mesh):
    """Every leaf of ``tree`` (named from ``prefix``) gathered whole, for a
    block that runs whole on every model rank."""
    if isinstance(tree, torch.Tensor):
        return weight(tree, by_name[prefix], mesh)[0]
    return {k: whole(v, f"{prefix}/{k}", by_name, mesh) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def q_split(cfg: ModelConfig, mesh) -> bool:
    """Whether the query heads split over the model axis with each rank's
    heads reading whole KV heads (as many as they need, the same on every
    rank)."""
    M = mesh.shape.get("model", 1)
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    return M > 1 and H % M == 0 and (Hkv % M == 0 or M % Hkv == 0)


def kv_layout(cfg: ModelConfig, mesh) -> str:
    """``"one"`` (the model axis holds one rank), ``"heads"`` (the KV heads
    divide the model axis) or ``"sequence"``: the attention caches' split,
    ``kv_cache_spec``'s rule."""
    M = mesh.shape.get("model", 1)
    if M == 1:
        return "one"
    return "heads" if cfg.num_kv_heads % M == 0 else "sequence"


def proj_heads(x, p, which: str, prefix: str, by_name: dict, mesh, lo: int, n: int,
               hd: int, own: bool):
    """``x @ w_<which> (+ b_<which>)`` of the attention weights ``p`` for
    heads ``[lo, lo + n)`` of the columns.  ``own``: the heads are this
    model rank's, not every rank's: its column block when that is those
    heads, else sliced from the whole weight (whose gradient then sums over
    the model axis).  Returns (B, T, n, hd)."""
    dt = x.dtype
    B, T, _ = x.shape
    w, spec = p[f"w_{which}"], by_name[f"{prefix}/w_{which}"]
    keep = own and model_split(spec, mesh, 1) and w.shape[1] == n * hd
    wt, split = weight(w, spec, mesh, keep=1 if keep else None, partial=own and not keep)
    if not split:
        wt = wt[:, lo * hd:(lo + n) * hd]
    y = x @ wt.to(dt)
    if f"b_{which}" in p:
        b, _ = weight(p[f"b_{which}"], by_name[f"{prefix}/b_{which}"], mesh, partial=own)
        y = y + b[lo * hd:(lo + n) * hd].to(dt)
    return y.reshape(B, T, n, hd)


def row_block(w, spec, mesh, lo: int, n: int, own: bool) -> torch.Tensor:
    """Rows ``[lo, lo + n)`` of ``w`` (``w_o``: the rows of this rank's
    heads when ``own``, else all of them): its row block when that is those
    rows, else sliced from the whole weight."""
    keep = own and model_split(spec, mesh, 0) and w.shape[0] == n
    wt, split = weight(w, spec, mesh, keep=0 if keep else None, partial=own and not keep)
    return wt if split else wt[lo:lo + n]


def head_range(cfg: ModelConfig, mesh, own: bool) -> tuple[int, int, int, int]:
    """(first query head, count, first KV head, count) this rank attends."""
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    if not own:
        return 0, H, 0, Hkv
    q_n = H // mesh.shape["model"]
    q_lo = mesh.axis_index("model") * q_n
    g = H // Hkv
    return q_lo, q_n, q_lo // g, max(q_n // g, 1)


def attention(p, x, cfg: ModelConfig, prefix: str, by_name: dict, mesh, *, positions,
              window, q_chunk: int) -> torch.Tensor:
    """The cache-free attention block on the grid: ``x`` (B, T, D) normed,
    the same on every model rank; returns its output (before the residual),
    the same on every model rank.  ``p`` holds the block's weights as this
    rank's blocks."""
    B, T, _ = x.shape
    hd = cfg.head_dim_
    own = q_split(cfg, mesh)
    q_lo, q_n, kv_lo, kv_n = head_range(cfg, mesh, own)
    xs = copy_to_model(x, mesh) if own else x
    q = proj_heads(xs, p, "q", prefix, by_name, mesh, q_lo, q_n, hd, own)
    k = proj_heads(xs, p, "k", prefix, by_name, mesh, kv_lo, kv_n, hd, own)
    v = proj_heads(xs, p, "v", prefix, by_name, mesh, kv_lo, kv_n, hd, own)
    q = ll.rope(q, positions, cfg.rope_theta).transpose(1, 2)
    k = ll.rope(k, positions, cfg.rope_theta).transpose(1, 2)
    v = v.transpose(1, 2)
    out = ll.attention_core(q, k, v, causal=True, window=window, q_chunk=q_chunk,
                            score_dtype=getattr(torch, cfg.score_dtype), impl=cfg.attn_impl)
    out = out.transpose(1, 2).reshape(B, T, q_n * hd)
    wo = row_block(p["w_o"], by_name[f"{prefix}/w_o"], mesh, q_lo * hd, q_n * hd, own)
    y = out @ wo.to(x.dtype)
    return reduce_from_model(y, mesh) if own else y


# ---------------------------------------------------------------------------
# MLP, embedding
# ---------------------------------------------------------------------------


def mlp(p, x, prefix: str, by_name: dict, mesh) -> torch.Tensor:
    """SwiGLU with its hidden dim split over the model axis where
    ``w_gate``, ``w_in`` and ``w_out`` all split it, else whole."""
    dt = x.dtype
    dims = {"w_gate": 1, "w_in": 1, "w_out": 0}
    split = all(model_split(by_name[f"{prefix}/{n}"], mesh, d) for n, d in dims.items())
    xs = copy_to_model(x, mesh) if split else x
    w = {n: weight(p[n], by_name[f"{prefix}/{n}"], mesh, keep=d if split else None)[0]
         for n, d in dims.items()}
    h = F.silu(xs @ w["w_gate"].to(dt)) * (xs @ w["w_in"].to(dt))
    y = h @ w["w_out"].to(dt)
    return reduce_from_model(y, mesh) if split else y


def embed(w, tokens, spec, mesh, dt) -> torch.Tensor:
    """The embedding rows of ``tokens`` from this rank's block of the table:
    gathered over its other axes; where the vocab splits over the model
    axis, each rank looks up the tokens of its own rows (zero elsewhere)
    and one all-reduce over ``model`` adds them, exactly (one term a
    token is not zero)."""
    w, split = weight(w, spec, mesh, keep=0)
    if not split:
        return w[tokens].to(dt)
    rows = w.shape[0]
    local = tokens - mesh.axis_index("model") * rows
    mine = (local >= 0) & (local < rows)
    h = torch.where(mine[..., None], w[local.clamp(0, rows - 1)].to(dt), 0)
    return reduce_from_model(h, mesh)
