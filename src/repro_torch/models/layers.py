"""Shared transformer layers: RMSNorm, RoPE, GQA attention, SwiGLU MLP.

The reference's layers in PyTorch, with its ``(B, H, T, d)`` attention
layout.  ``attention_core`` runs a hand-written flash-attention kernel on
a CUDA tensor in exactly the case the kernels compute (causal, no query
offset, ``T == S``, f32 scores, no window or one that covers every key,
``T <= window``, and a head dim the kernels take, a multiple of 8 up to
256), where the kernels' top-left causal mask is the model's mask.  The dtype and head dim pick the kernel
(``kernels.flash_attn.route``; the README's route table); the tensor-core
kernels read the transposed views as they are.  The kernel runs inside
autograd (``ops.flash_attention_with_grad``): training's forward launches
it too, and its backward differentiates the plain version one query chunk
at a time.  Every other
case, and every CPU tensor, takes ``attention_core_plain``: the
reference's q-chunked exact softmax.  The choice follows the arguments
alone; nothing falls back on a failure.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels import flash_attn, ops
from .config import ModelConfig

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.promote_types(x.dtype, torch.float32))     # f32, f64 in f64
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (B, T, H, d) with even d; positions: (T,) or (B, T)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freq       # (..., T, half)
    if ang.ndim == 2:                                         # (T, half) -> broadcast B
        ang = ang[None]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention core
# ---------------------------------------------------------------------------


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: Optional[int] = None,
                   q_chunk: int = 512, q_offset: int = 0,
                   score_dtype: torch.dtype = torch.float32,
                   impl: str = "chunked") -> torch.Tensor:
    """Exact attention.  q: (B, H, T, d);  k, v: (B, Hkv, S, d).

    On a CUDA tensor with ``causal``, ``q_offset == 0``, ``T == S``, f32
    scores, no ``window`` or ``T <= window`` (where the window hides no
    key: ``kpos > qpos - window`` holds for every ``kpos <= qpos``) and a
    head dim that ``flash_attn.takes_head_dim`` this is a flash kernel
    (``ops.flash_attention_with_grad``, top-left mask, equal to the model's
    here); otherwise :func:`attention_core_plain`.  ``impl="skip_core"`` is
    the reference's dry-run accounting stand-in for a flash kernel, not a
    model: the same q/k/v/o streams and no score-sized block (``q`` plus
    the keys' and values' means over the sequence, each kv head's repeated
    over its group), on any device.
    """
    if impl == "skip_core":
        g = q.shape[1] // k.shape[1]
        return (q + k.mean(dim=2, keepdim=True).repeat_interleave(g, dim=1)
                + v.mean(dim=2, keepdim=True).repeat_interleave(g, dim=1)).to(q.dtype)
    if impl != "chunked":
        raise ValueError(f"unknown attention impl {impl!r}")
    T, S = q.shape[2], k.shape[2]
    if (q.device.type == "cuda" and causal and q_offset == 0 and T == S
            and score_dtype == torch.float32 and (window is None or T <= window)
            and flash_attn.takes_head_dim(q.shape[-1])):
        return ops.flash_attention_with_grad(q, k, v, causal=True, q_chunk=q_chunk)
    return attention_core_plain(q, k, v, causal=causal, window=window,
                                q_chunk=q_chunk, q_offset=q_offset,
                                score_dtype=score_dtype)


def attention_core_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: Optional[int] = None,
                         q_chunk: int = 512, q_offset: int = 0,
                         score_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The reference's exact attention, looped over query chunks.

    GQA via a head-group einsum (no kv repeat).  ``q_offset`` is the absolute
    position of q[0]; ``window`` a local attention span.  Scores are formed
    in ``score_dtype`` (products accumulated in f32, then rounded, as the
    reference's ``preferred_element_type``), reductions run in f32, and the
    output is accumulated in f32.  The causal mask is bottom-right aligned
    through ``q_offset``: key ``kpos`` is visible from ``q_offset + t`` when
    ``kpos <= q_offset + t``.  Under autograd each chunk runs under its own
    non-reentrant checkpoint, so a backward holds one chunk's blocks at a
    time; the values are the same either way.
    """
    B, H, T, d = q.shape
    _, Hkv, S, _ = k.shape
    g = H // Hkv
    qc = min(q_chunk, T)
    if T % qc:
        qc = T  # a single chunk for ragged tiny shapes
    nc = T // qc
    qr = q.reshape(B, Hkv, g, nc, qc, d)
    kf = k.to(score_dtype).to(torch.float32)
    vf = v.to(score_dtype).to(torch.float32)
    # the reference's jax.checkpoint of its mapped chunk_fn
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    outs = []
    for idx in range(nc):
        args = (qr[:, :, :, idx], kf, vf, q_offset + idx * qc, causal, window, score_dtype)
        outs.append(checkpoint(_chunk_attention, *args, use_reentrant=False) if grad
                    else _chunk_attention(*args))
    out = torch.cat(outs, dim=3)                    # (B, Hkv, g, T, d)
    return out.reshape(B, H, T, d).to(q.dtype)


def _chunk_attention(qc_, kf, vf, q0: int, causal: bool, window: Optional[int],
                     score_dtype: torch.dtype) -> torch.Tensor:
    """One query chunk of :func:`attention_core_plain`: qc_ (B, Hkv, g, qc,
    d) at positions ``q0 + t`` against every key; returns the chunk's f32
    output (B, Hkv, g, qc, d)."""
    qc, S = qc_.shape[3], kf.shape[2]
    dev = qc_.device
    scale = torch.tensor(1.0 / (qc_.shape[-1] ** 0.5), dtype=score_dtype, device=dev)
    neg = torch.tensor(NEG_INF, dtype=score_dtype, device=dev)
    kpos = torch.arange(S, device=dev)
    qf = qc_.to(score_dtype).to(torch.float32)
    s = torch.einsum("bkgtd,bksd->bkgts", qf, kf).to(score_dtype) * scale
    qpos = q0 + torch.arange(qc, device=dev)
    mask = torch.ones((qc, S), dtype=torch.bool, device=dev)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    s = torch.where(mask, s, neg)
    # stable softmax: reductions in f32, materialized blocks in score_dtype
    m = s.amax(dim=-1, keepdim=True).to(torch.float32)
    p = torch.exp(s.to(torch.float32) - m).to(score_dtype)
    z = p.to(torch.float32).sum(dim=-1, keepdim=True)
    a = p / z.to(score_dtype)
    return torch.einsum("bkgts,bksd->bkgtd", a.to(torch.float32), vf)


def decode_attention(q1: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                     t, window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention against a (B, Hkv, S, d) cache; t = current pos."""
    B, H, _, d = q1.shape
    _, Hkv, S, _ = cache_k.shape
    g = H // Hkv
    qr = q1.reshape(B, Hkv, g, 1, d)
    s = torch.einsum("bkgtd,bksd->bkgts", qr.to(torch.float32),
                     cache_k.to(torch.float32)) / (d ** 0.5)
    kpos = torch.arange(S, device=q1.device)
    mask = kpos <= t
    if window is not None:
        mask &= kpos > t - window
    s = s.masked_fill(~mask, NEG_INF)
    a = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgts,bksd->bkgtd", a, cache_v.to(torch.float32))
    return out.reshape(B, H, 1, d).to(q1.dtype)


# ---------------------------------------------------------------------------
# Attention layer (projections + rope + core/cache)
# ---------------------------------------------------------------------------


def normal_init(generator, shape, std, dtype, device):
    """Normal draws with standard deviation ``std`` in f32, stored as ``dtype``."""
    return (torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device) * std).to(dtype)


def init_attention(generator: torch.Generator, cfg: ModelConfig,
                   dtype=torch.float32, device=None) -> dict:
    D, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    sc = D ** -0.5
    p = {
        "w_q": normal_init(generator, (D, H * hd), sc, dtype, device),
        "w_k": normal_init(generator, (D, Hkv * hd), sc, dtype, device),
        "w_v": normal_init(generator, (D, Hkv * hd), sc, dtype, device),
        "w_o": normal_init(generator, (H * hd, D), (H * hd) ** -0.5, dtype, device),
    }
    if cfg.qkv_bias:
        p["b_q"] = torch.zeros((H * hd,), dtype=dtype, device=device)
        p["b_k"] = torch.zeros((Hkv * hd,), dtype=dtype, device=device)
        p["b_v"] = torch.zeros((Hkv * hd,), dtype=dtype, device=device)
    return p


def attention_layer(p, x, cfg: ModelConfig, *, positions, window=None,
                    cache=None, cache_index=None, q_chunk: int = 512):
    """x: (B, T, D).  Returns (out, new_cache).

    cache: optional (k, v) each (B, Hkv, S, d).  With ``cache_index`` (an
    int) it runs decode: writes k/v at the index and attends to the cache;
    without, it writes the whole prefix and attends over T.  The port writes
    the cache tensors in place and returns them.
    """
    B, T, D = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    dt = x.dtype
    q = x @ p["w_q"].to(dt)
    k = x @ p["w_k"].to(dt)
    v = x @ p["w_v"].to(dt)
    if cfg.qkv_bias:
        q = q + p["b_q"].to(dt)
        k = k + p["b_k"].to(dt)
        v = v + p["b_v"].to(dt)
    q = rope(q.reshape(B, T, H, hd), positions, cfg.rope_theta).transpose(1, 2)
    k = rope(k.reshape(B, T, Hkv, hd), positions, cfg.rope_theta).transpose(1, 2)
    v = v.reshape(B, T, Hkv, hd).transpose(1, 2)            # (B, Hkv, T, d)

    new_cache = None
    score_dtype = getattr(torch, cfg.score_dtype)
    if cache is not None:
        ck, cv = cache
        if cache_index is not None:    # decode: append one token
            ck[:, :, cache_index:cache_index + T] = k.to(ck.dtype)
            cv[:, :, cache_index:cache_index + T] = v.to(cv.dtype)
            out = decode_attention(q, ck, cv, cache_index, window=window)
        else:                          # prefill: write the whole prefix
            ck[:, :, :T] = k.to(ck.dtype)
            cv[:, :, :T] = v.to(cv.dtype)
            out = attention_core(q, k, v, causal=True, window=window,
                                 q_chunk=q_chunk, score_dtype=score_dtype,
                                 impl=cfg.attn_impl)
        new_cache = (ck, cv)
    else:
        out = attention_core(q, k, v, causal=True, window=window, q_chunk=q_chunk,
                             score_dtype=score_dtype, impl=cfg.attn_impl)

    out = out.transpose(1, 2).reshape(B, T, H * hd)
    return out @ p["w_o"].to(dt), new_cache


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.float32, device=None) -> dict:
    return {
        "w_gate": normal_init(generator, (d_model, d_ff), d_model ** -0.5, dtype, device),
        "w_in": normal_init(generator, (d_model, d_ff), d_model ** -0.5, dtype, device),
        "w_out": normal_init(generator, (d_ff, d_model), d_ff ** -0.5, dtype, device),
    }


def mlp_layer(p, x):
    dt = x.dtype
    h = F.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_in"].to(dt))
    return h @ p["w_out"].to(dt)
