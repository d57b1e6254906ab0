"""Model assembly for the dense family: [attn + SwiGLU MLP] x L, caches.

The reference's ``models/transformer.py`` for ``family="dense"``.  Layers
run as a Python loop over ``params["layers"]``; the reference's
``lax.scan`` and rematerialization have no counterpart in inference.  Other
families (moe, ssm, hybrid, audio, vlm) and ``lm_loss`` are not ported yet.

Parameters are a plain dict of tensors: ``embed`` (V, D), ``final_norm``
(D,), ``lm_head`` (V, D) unless embeddings are tied, and ``layers``, one
dict per layer with ``ln1``, ``attn`` (``w_q``, ``w_k``, ``w_v``, ``w_o``
and, with ``qkv_bias``, ``b_q``, ``b_k``, ``b_v``), ``ln2`` and ``mlp``
(``w_gate``, ``w_in``, ``w_out``).  Each is stored in the dtype in which
``forward`` reads it: ``cfg.dtype`` for layer weights and ``embed``, f32
for ``lm_head`` (and for ``embed`` when tied), which ``unembed`` reads in f32.

Decode caches are a list with one ``{"k", "v", "pos"}`` dict per layer,
k/v ``(B, Hkv, max_len, d)`` in bf16 by default (the reference's default,
which its engine relies on).  The port writes them in place.
"""
from __future__ import annotations

import torch

from ..configs.backend import resolve_device
from . import layers as ll
from .config import ModelConfig
from .layers import init_attention, init_mlp, mlp_layer, normal_init, rms_norm

NOT_PORTED_FAMILIES = ("moe", "ssm", "hybrid", "audio", "vlm")


def layer_kinds(cfg: ModelConfig) -> list[str]:
    if cfg.family in NOT_PORTED_FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} ({cfg.name}) is not "
                                  f"ported yet; the port runs dense models")
    return ["attn"] * cfg.num_layers


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None) -> dict:
    """Random parameters, normal with the reference's scales, on ``device``.

    ``generator`` defaults to one seeded with 0 on the device.  Numbers
    differ from the reference's ``jax.random`` draws; ``convert`` carries the
    reference's own weights across.
    """
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev if dev.type == "cuda" else "cpu")
        generator.manual_seed(0)
    kinds = layer_kinds(cfg)
    D, wdt = cfg.d_model, compute_dtype(cfg)
    head_dt = torch.float32
    params = {
        "embed": normal_init(generator, (cfg.vocab, D), 0.02,
                             head_dt if cfg.tie_embeddings else wdt, dev),
        "final_norm": torch.ones((D,), dtype=wdt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(generator, (cfg.vocab, D), 0.02, head_dt, dev)
    params["layers"] = [
        {"ln1": torch.ones((D,), dtype=wdt, device=dev),
         "attn": init_attention(generator, cfg, wdt, dev),
         "ln2": torch.ones((D,), dtype=wdt, device=dev),
         "mlp": init_mlp(generator, D, cfg.d_ff, wdt, dev)}
        for _ in kinds]
    return params


def param_tensors(params: dict) -> list[torch.Tensor]:
    """Every tensor of a parameter (or cache) tree, in a fixed order."""
    if isinstance(params, torch.Tensor):
        return [params]
    items = params.values() if isinstance(params, dict) else params
    return [t for item in items for t in param_tensors(item)]


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device=None) -> list[dict]:
    """One ``{"k", "v", "pos"}`` decode cache per layer; ``pos`` holds the
    position written to each slot, -1 for an empty one."""
    dev = resolve_device(device)
    Hkv, hd = cfg.num_kv_heads, cfg.head_dim_
    return [{"k": torch.zeros((batch, Hkv, max_len, hd), dtype=dtype, device=dev),
             "v": torch.zeros((batch, Hkv, max_len, hd), dtype=dtype, device=dev),
             "pos": torch.full((max_len,), -1, dtype=torch.int32, device=dev)}
            for _ in layer_kinds(cfg)]


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _attn_block(p, h, cfg, *, positions, window, cache, pos_scalar, q_chunk):
    """Attention with an optional cache.  Returns (h, cache)."""
    x = rms_norm(h, p["ln1"].to(h.dtype), cfg.rms_eps)
    if cache is None:
        out, _ = ll.attention_layer(p["attn"], x, cfg, positions=positions,
                                    window=window, q_chunk=q_chunk)
        return h + out, None

    B, T, D = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    dt = x.dtype
    pa = p["attn"]
    q = (x @ pa["w_q"].to(dt)).reshape(B, T, H, hd)
    k = (x @ pa["w_k"].to(dt)).reshape(B, T, Hkv, hd)
    v = (x @ pa["w_v"].to(dt)).reshape(B, T, Hkv, hd)
    if cfg.qkv_bias:
        q = q + pa["b_q"].to(dt).reshape(H, hd)
        k = k + pa["b_k"].to(dt).reshape(Hkv, hd)
        v = v + pa["b_v"].to(dt).reshape(Hkv, hd)
    q = ll.rope(q, positions, cfg.rope_theta).transpose(1, 2)
    k = ll.rope(k, positions, cfg.rope_theta).transpose(1, 2)
    v = v.transpose(1, 2)

    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    wlen = ck.shape[2]
    if T == 1:  # decode: ring-buffer write at pos % wlen
        slot = pos_scalar % wlen
        ck[:, :, slot] = k[:, :, 0].to(ck.dtype)
        cv[:, :, slot] = v[:, :, 0].to(cv.dtype)
        cpos[slot] = pos_scalar
        out = _masked_decode_attn(q, ck, cv, cpos, pos_scalar, window)
    else:       # prefill: write the last wlen tokens at their slots
        ntail = min(T, wlen)
        ptail = positions[T - ntail:]
        slots = (ptail % wlen).long()
        ck[:, :, slots] = k[:, :, T - ntail:].to(ck.dtype)
        cv[:, :, slots] = v[:, :, T - ntail:].to(cv.dtype)
        cpos[slots] = ptail.to(torch.int32)
        out = ll.attention_core(q, k, v, causal=True, window=window,
                                q_chunk=q_chunk,
                                score_dtype=getattr(torch, cfg.score_dtype),
                                impl=cfg.attn_impl)

    out = out.transpose(1, 2).reshape(B, T, H * hd)
    return h + out @ pa["w_o"].to(dt), cache


def _masked_decode_attn(q1, ck, cv, kpos, t, window):
    B, H, _, d = q1.shape
    Hkv = ck.shape[1]
    g = H // Hkv
    s = torch.einsum("bkgtd,bksd->bkgts",
                     q1.reshape(B, Hkv, g, 1, d).to(torch.float32),
                     ck.to(torch.float32)) / (d ** 0.5)
    mask = (kpos >= 0) & (kpos <= t)
    if window is not None:
        mask &= kpos > t - window
    s = s.masked_fill(~mask, ll.NEG_INF)
    a = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgts,bksd->bkgtd", a, cv.to(torch.float32))
    return out.reshape(B, H, 1, d).to(q1.dtype)


def _ffn_block(p, h, cfg):
    x = rms_norm(h, p["ln2"].to(h.dtype), cfg.rms_eps)
    return h + mlp_layer(p["mlp"], x)


def apply_layer(p, h, cfg, kind, *, positions, cache, pos_scalar, q_chunk):
    """One block.  Returns (h, cache)."""
    if kind != "attn":
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet")
    h, st = _attn_block(p, h, cfg, positions=positions, window=None,
                        cache=cache, pos_scalar=pos_scalar, q_chunk=q_chunk)
    return _ffn_block(p, h, cfg), st


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def forward(params, tokens, cfg: ModelConfig, *, caches=None, pos_scalar=None,
            q_chunk: int = 512):
    """Returns (hidden (B, T, D), caches).

    tokens: (B, T) integer.  ``caches`` with ``pos_scalar`` and T == 1
    decodes one token at position ``pos_scalar`` (an int, uniform across
    the batch); ``caches`` alone prefills them.
    """
    dt = compute_dtype(cfg)
    h = params["embed"][tokens].to(dt)
    B, T, _ = h.shape
    if pos_scalar is not None and T == 1:
        positions = torch.full((B, 1), pos_scalar, dtype=torch.int32, device=h.device)
    else:
        positions = torch.arange(T, dtype=torch.int32, device=h.device)
    for i, kind in enumerate(layer_kinds(cfg)):
        h, _ = apply_layer(params["layers"][i], h, cfg, kind, positions=positions,
                           cache=None if caches is None else caches[i],
                           pos_scalar=pos_scalar, q_chunk=q_chunk)
    h = rms_norm(h, params["final_norm"].to(dt), cfg.rms_eps)
    return h, caches


def unembed(params, h, cfg: ModelConfig):
    W = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return h.to(torch.float32) @ W.to(torch.float32).T
