"""Serving on a grid of ranks: prefill and decode with the parameters and
the decode caches split as the reference's dry run lays them out.

The reference jits ``prefill_step``/``decode_step`` with the parameters
under ``param_shardings`` and the caches under the dry run's
``cache_shardings`` and lets GSPMD place the work.  The port has no
compiler, so this module writes out one rank's program on a
``launch/mesh.py:GridMesh`` (``(data, model)`` or ``(pod, data, model)``):

* The parameters are this rank's blocks under ``parallel/sharding.py:
  param_specs``, laid out as training lays them out
  (``models/tensor_parallel.py``, whose blocks this module calls).  Each
  layer gathers what it needs just before use and drops it after: only
  one layer's weights are ever whole.  Where a weight's spec splits its columns over the model
  axis (``w_q``/``w_k``/``w_v``, ``w_gate``/``w_in``, the vocab of
  ``lm_head``) the rank keeps its columns and gathers only the other dims,
  and the matching row split of ``w_o``/``w_out`` ends the block with one
  all-reduce over ``model`` (tensor parallelism).  Recurrent layers run
  whole on every model rank, their state gathered over ``model`` first.
  The experts stay on their model rank (``models/moe.py:moe_layer``).
* The batch is split over the batch axes where it divides them (else every
  data rank serves all of it); the steps take and return the whole batch,
  as the reference's callers see global arrays, and keep this rank's rows.
* Each cache leaf is this rank's block under ``parallel/sharding.py:
  cache_spec``.  Attention caches take one of two layouts:

  - **heads** (the KV heads divide the model axis): model rank ``m`` holds
    its KV heads, computes its query heads and attends them alone;
  - **sequence** (they do not): model rank ``m`` holds the slots
    ``[m S/M, (m+1) S/M)`` of every KV head.  Prefill writes the slots of
    its block.  Decode writes the new slot on the rank that holds it; each
    rank scores all query heads against its slots, and the ranks' partial
    softmaxes combine through an all-reduce of the maxima, then one of the
    weighted values and the sums.  ``pos`` (the slot positions) is whole
    on every rank.

  In prefill, where the query heads split over the model axis (their count
  divides it, and each rank's heads read a whole number of KV heads), each
  rank attends its own query heads: one flash-attention call a layer.

The logits come back whole on every rank (the reference's
``out_shardings=P()``).  A grid of one rank takes the one-rank path.
"""
from __future__ import annotations

import torch

from ..models import layers as ll
from ..models import tensor_parallel as tp
from ..models import transformer as tfm
from ..models.config import ModelConfig
from ..models.mamba2 import mamba_layer
from ..models.moe import moe_layer
from ..models.rglru import rglru_layer
from ..models.tensor_parallel import kv_layout
from ..parallel import sharding as shd
from ..train.loop import grid_specs, unflatten

__all__ = ["param_blocks", "cache_specs",
           "init_cache_blocks", "shard_tree", "rows_split",
           "local_rows", "kv_layout", "grid_forward", "grid_unembed"]


# ---------------------------------------------------------------------------
# Blocks of trees
# ---------------------------------------------------------------------------


def param_blocks(full, cfg: ModelConfig, mesh):
    """This rank's blocks of the whole parameters ``full``."""
    by_name = grid_specs(cfg, mesh)
    return shard_tree(full, [by_name[n] for n, _ in shd.flat_names(full)], mesh)


def cache_specs(mesh, caches) -> list[tuple]:
    """The spec of every cache leaf, in ``param_tensors``' order."""
    return [shd.cache_spec(mesh, name, tuple(t.shape))
            for name, t in shd.flat_names(caches)]


def shard_tree(full, specs, mesh):
    """This rank's blocks of ``full`` under ``specs`` (in ``param_tensors``'
    order), each in storage of its own, in ``full``'s structure."""
    blocks = []
    for t, spec in zip(tfm.param_tensors(full), specs):
        b = shd.local_block(t, spec, mesh)
        blocks.append(b if b is t else b.clone())
    return unflatten(full, blocks)


def init_cache_blocks(cfg: ModelConfig, batch: int, max_len: int, mesh,
                      dtype: torch.dtype = torch.bfloat16, device=None) -> list[dict]:
    """This rank's blocks of ``init_cache(cfg, batch, max_len)``, made at
    their own size (the whole caches are drawn on the meta device)."""
    full = tfm.init_cache(cfg, batch, max_len, dtype, device="meta")
    dev = mesh.device if device is None else torch.device(device)
    return unflatten(full, [
        torch.full(shd.block_shape(mesh, spec, tuple(t.shape)),
                   -1 if t.dtype == torch.int32 else 0, dtype=t.dtype, device=dev)
        for t, spec in zip(tfm.param_tensors(full), cache_specs(mesh, full))])


def rows_split(mesh, batch: int) -> bool:
    """Whether a batch of ``batch`` rows splits over the batch axes (the
    reference's ``batch_shardings``: else every data rank holds it all)."""
    n = shd.axis_size(mesh, shd.batch_axes(mesh))
    return n > 1 and batch % n == 0


def local_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This data rank's rows of the whole-batch ``x``."""
    if not rows_split(mesh, x.shape[0]):
        return x
    return shd.local_block(x, shd.batch_spec(mesh, x.dim()), mesh)


def _attn(p, h, cfg, prefix, by_name, mesh, *, positions, window, cache,
          pos_scalar, q_chunk):
    """The attention block on the grid with this rank's cache block."""
    x = ll.rms_norm(h, p["ln1"].to(h.dtype), cfg.rms_eps)
    B, T, D = x.shape
    Hkv, hd = cfg.num_kv_heads, cfg.head_dim_
    M = mesh.shape.get("model", 1)
    m = mesh.axis_index("model") if M > 1 else 0
    layout = kv_layout(cfg, mesh)
    decode = T == 1
    pa, pre = p["attn"], f"{prefix}/attn"
    # the query heads this rank attends, and the KV heads they read
    own_q = layout == "heads" or (tp.q_split(cfg, mesh) and not decode)
    q_lo, q_n, kv_lo, kv_n = tp.head_range(cfg, mesh, own_q)
    # the KV heads this rank computes: its cache heads, else all of them
    if layout == "heads":
        c_lo, c_n = m * (Hkv // M), Hkv // M
    else:
        c_lo, c_n = 0, Hkv
    q = tp.proj_heads(x, pa, "q", pre, by_name, mesh, q_lo, q_n, hd, own_q)
    k = tp.proj_heads(x, pa, "k", pre, by_name, mesh, c_lo, c_n, hd, layout == "heads")
    v = tp.proj_heads(x, pa, "v", pre, by_name, mesh, c_lo, c_n, hd, layout == "heads")
    q = ll.rope(q, positions, cfg.rope_theta).transpose(1, 2)
    k = ll.rope(k, positions, cfg.rope_theta).transpose(1, 2)
    v = v.transpose(1, 2)                                   # (B, c_n, T, d)

    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    wlen = cpos.shape[0]
    wl = ck.shape[2]                                        # this rank's slots
    lo = m * wl if layout == "sequence" else 0
    if decode:
        slot = pos_scalar % wlen
        if lo <= slot < lo + wl:
            ck[:, :, slot - lo] = k[:, :, 0].to(ck.dtype)
            cv[:, :, slot - lo] = v[:, :, 0].to(cv.dtype)
        cpos[slot] = pos_scalar
        if layout == "sequence":
            out = _split_decode_attn(q, ck, cv, cpos[lo:lo + wl], pos_scalar, window, mesh)
        else:
            out = tfm._masked_decode_attn(q, ck, cv, cpos, pos_scalar, window)
    else:
        ntail = min(T, wlen)
        ptail = positions[T - ntail:]
        cpos[(ptail % wlen).long()] = ptail.to(torch.int32)
        if T >= wlen:       # every slot written: slot s holds the tail's p = s mod wlen
            base = T - wlen
            idx = base + (torch.arange(lo, lo + wl, device=x.device) - base) % wlen
            ck.copy_(k[:, :, idx].to(ck.dtype))
            cv.copy_(v[:, :, idx].to(cv.dtype))
        else:               # slots [0, T) written, position p in slot p
            n = max(0, min(lo + wl, T) - lo)
            ck[:, :, :n] = k[:, :, lo:lo + n].to(ck.dtype)
            cv[:, :, :n] = v[:, :, lo:lo + n].to(cv.dtype)
        ka = k[:, kv_lo - c_lo:kv_lo - c_lo + kv_n]
        va = v[:, kv_lo - c_lo:kv_lo - c_lo + kv_n]
        out = ll.attention_core(q, ka, va, causal=True, window=window, q_chunk=q_chunk,
                                score_dtype=getattr(torch, cfg.score_dtype),
                                impl=cfg.attn_impl)
    out = out.transpose(1, 2).reshape(B, T, q_n * hd)
    wo = tp.row_block(pa["w_o"], by_name[f"{pre}/w_o"], mesh, q_lo * hd, q_n * hd, own_q)
    y = out @ wo.to(x.dtype)
    if own_q:
        y = tp.reduce_from_model(y, mesh)
    return h + y, cache


def _split_decode_attn(q1, ck, cv, kpos, t, window, mesh):
    """One token's attention over this rank's slots of every KV head,
    combined with the other model ranks': the largest score first (an
    all-reduce of the maxima), then the exponentials' weighted values and
    sums (one all-reduce)."""
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
    mx = mesh.all_reduce_max(s.amax(dim=-1, keepdim=True), ("model",))
    e = torch.exp(s - mx)
    both = torch.cat([torch.einsum("bkgts,bksd->bkgtd", e, cv.to(torch.float32)),
                      e.sum(dim=-1, keepdim=True)], dim=-1)
    both = mesh.all_reduce_sum(both, ("model",))
    out = both[..., :d] / both[..., d:]
    return out.reshape(B, H, 1, d).to(q1.dtype)


def _model_part(spec) -> tuple:
    """``spec`` with only its model-axis entries: a recurrent state is this
    rank's rows already, and gathers or splits its other dims alone."""
    return tuple(e if "model" in shd.spec_axes(e) else None for e in spec)


def _state_whole(st, specs: dict, mesh):
    return {k: shd.gather_full(v, _model_part(specs[k]), mesh) for k, v in st.items()}


def _state_block(st, specs: dict, mesh):
    out = {}
    for k, v in st.items():
        b = shd.local_block(v, _model_part(specs[k]), mesh)
        out[k] = b if b is v else b.clone()
    return out


def _layer(p, h, cfg, kind, i, by_name, mesh, *, positions, cache, state_specs,
           pos_scalar, q_chunk, rows):
    prefix = f"layers/{i}"
    if kind in ("mamba", "rglru"):
        state = None if cache is None else _state_whole(cache, state_specs, mesh)
        if kind == "mamba":
            x = ll.rms_norm(h, p["ln"].to(h.dtype), cfg.rms_eps)
            out, st = mamba_layer(tp.whole(p["mamba"], f"{prefix}/mamba", by_name, mesh),
                                  x, cfg, state)
            h = h + out
        else:
            x = ll.rms_norm(h, p["ln1"].to(h.dtype), cfg.rms_eps)
            out, st = rglru_layer(tp.whole(p["rec"], f"{prefix}/rec", by_name, mesh),
                                  x, cfg, state)
            h = h + out
            x = ll.rms_norm(h, p["ln2"].to(h.dtype), cfg.rms_eps)
            h = h + tp.mlp(p["mlp"], x, f"{prefix}/mlp", by_name, mesh)
        return h, (None if cache is None else _state_block(st, state_specs, mesh))
    window = cfg.rglru.window if cfg.rglru is not None else None
    h, cache = _attn(p, h, cfg, prefix, by_name, mesh, positions=positions,
                     window=window, cache=cache, pos_scalar=pos_scalar, q_chunk=q_chunk)
    x = ll.rms_norm(h, p["ln2"].to(h.dtype), cfg.rms_eps)
    if kind == "moe":
        return h + moe_layer(p["moe"], x, cfg, mesh, rows_split=rows), cache
    return h + tp.mlp(p["mlp"], x, f"{prefix}/mlp", by_name, mesh), cache


def grid_forward(params, tokens, cfg: ModelConfig, mesh, by_name: dict, *,
                 batch: int, caches, pos_scalar=None, patch_embeds=None,
                 q_chunk: int = 512):
    """``forward`` on the grid for serving: ``params`` and ``caches`` are
    this rank's blocks (``by_name`` maps each parameter's name to its
    spec), ``tokens`` (and a vlm's ``patch_embeds``) this rank's rows of a
    batch of ``batch``.  Returns (hidden of this rank's rows, caches), the
    cache blocks written in place or replaced (recurrent states)."""
    # the recurrent states' whole shapes, for their specs
    whole = tfm.init_cache(cfg, batch, 1, device="meta")
    state_specs = [{k: shd.cache_spec(mesh, f"{i}/{k}", tuple(v.shape))
                    for k, v in c.items()} for i, c in enumerate(whole)]
    dt = tfm.compute_dtype(cfg)
    h = tp.embed(params["embed"], tokens, by_name["embed"], mesh, dt)
    if cfg.num_patches and patch_embeds is not None:
        proj = shd.gather_full(params["patch_proj"], by_name["patch_proj"], mesh)
        h = torch.cat([patch_embeds.to(dt) @ proj.to(dt), h], dim=1)
        del proj
    B, T, _ = h.shape
    if pos_scalar is not None and T == 1:
        positions = torch.full((B, 1), pos_scalar, dtype=torch.int32, device=h.device)
    else:
        positions = torch.arange(T, dtype=torch.int32, device=h.device)
    for i, kind in enumerate(tfm.layer_kinds(cfg)):
        h, caches[i] = _layer(params["layers"][i], h, cfg, kind, i, by_name, mesh,
                              positions=positions, cache=caches[i],
                              state_specs=state_specs[i], pos_scalar=pos_scalar,
                              q_chunk=q_chunk, rows=rows_split(mesh, batch))
    h = ll.rms_norm(h, params["final_norm"].to(dt), cfg.rms_eps)
    return h, caches


def grid_unembed(params, h, cfg: ModelConfig, mesh, by_name: dict,
                 rows: bool) -> torch.Tensor:
    """Logits of this rank's rows ``h`` (B_l, T, D), the vocab split over
    the model axis where ``lm_head``'s spec splits it, gathered whole on
    every rank: over the model axis, then (``rows``: the batch is split)
    over the batch axes."""
    name = "embed" if cfg.tie_embeddings else "lm_head"
    w, split = tp.weight(params[name], by_name[name], mesh, keep=0)
    f32 = torch.promote_types(h.dtype, torch.float32)
    logits = h.to(f32) @ w.to(f32).T
    del w
    if split:
        logits = mesh.all_gather(logits, ("model",), dim=-1)
    if rows:
        logits = mesh.all_gather(logits, shd.batch_axes(mesh), dim=0)
    return logits
