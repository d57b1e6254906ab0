"""Model assembly: block dispatch per family, caches, unembedding, loss.

The reference's ``models/transformer.py``.  Families:

  dense/audio/vlm : [attn + SwiGLU MLP] x L   (audio = small-vocab LM; vlm
                    prepends projected patch embeddings)
  moe             : [attn + MoE FFN] x L
  hybrid          : Griffin pattern (rglru, rglru, local attn) cycled
  ssm             : [mamba2 SSD] x L

Layers run as a Python loop over ``params["layers"]``, one dict per layer
in order (``convert.params_from_jax`` reads the reference's grouped
``lax.scan`` layout).  ``forward(remat=True)`` runs each layer under
non-reentrant ``torch.utils.checkpoint``, the reference's ``jax.checkpoint``
of its scan body; under ``remat_policy="save_block_out"`` an attention
layer's attention and FFN blocks take a checkpoint each, so the sum after
the attention block stays (the reference saves the named ``attn_out`` and
``moe_out``), with the same values.  On a grid of ranks ``forward`` takes
this rank's blocks and lays the work out as ``models/tensor_parallel.py``
says.  ``lm_loss`` is the reference's chunked cross-entropy, each chunk
checkpointed.

Parameters are a plain dict of tensors: ``embed`` (V, D), ``final_norm``
(D,), ``lm_head`` (V, D) unless embeddings are tied, ``patch_proj``
(patch_dim, D) for a vlm, and ``layers``.  A layer of kind ``attn`` holds
``ln1``, ``attn`` (``w_q``, ``w_k``, ``w_v``, ``w_o`` and, with
``qkv_bias``, ``b_q``, ``b_k``, ``b_v``), ``ln2`` and ``mlp`` (``w_gate``,
``w_in``, ``w_out``); ``moe`` holds ``moe`` (``models/moe.py``) in place
of ``mlp``; ``rglru`` holds ``ln1``, ``rec`` (``models/rglru.py``), ``ln2``
and ``mlp``; ``mamba`` holds ``ln`` and ``mamba`` (``models/mamba2.py``).
Each is stored in the dtype in which ``forward`` reads it: ``cfg.dtype``,
except the names in ``F32_WEIGHTS`` and ``lm_head`` (and ``embed`` when
tied), which are read in f32.

Decode caches are a list with one entry per layer: ``{"k", "v", "pos"}``
for attention, k/v ``(B, Hkv, wlen, d)`` in bf16 by default (the
reference's default, which its engine relies on), ``wlen = max_len``, or
``min(max_len, window)`` for a hybrid's local attention, a ring buffer;
``{"h", "conv"}`` for RG-LRU and ``{"ssm", "conv"}`` for Mamba-2.  The port
writes k/v in place; a recurrent layer's new state replaces its entry, in
the dtype the reference returns (an f32 model's first call turns the bf16
conv tails into f32).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.backend import resolve_device
from . import layers as ll
from .config import ModelConfig
from .layers import init_attention, init_mlp, mlp_layer, normal_init, rms_norm
from .mamba2 import init_mamba, init_mamba_state, mamba_layer
from ..parallel import sharding as shd
from ..parallel.sharding import axis_size, batch_axes
from . import tensor_parallel as tp
from .moe import init_moe, moe_layer, reduce_from
from .rglru import init_rglru, init_rglru_state, rglru_layer

# weights read in f32 whatever the compute dtype (besides lm_head and a tied embed)
F32_WEIGHTS = frozenset({"router", "lru_wa", "lru_wi", "lru_lambda", "lru_ba",
                         "lru_bi", "a_log", "dt_bias", "d_skip"})


def layer_kinds(cfg: ModelConfig) -> list[str]:
    if cfg.family == "ssm":
        return ["mamba"] * cfg.num_layers
    if cfg.family == "moe":
        return ["moe"] * cfg.num_layers
    if cfg.family == "hybrid":
        pat = cfg.rglru.pattern
        return [pat[i % len(pat)] for i in range(cfg.num_layers)]
    return ["attn"] * cfg.num_layers


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


def _init_one(generator, cfg: ModelConfig, kind: str, wdt, dev) -> dict:
    D = cfg.d_model

    def ones():
        return torch.ones((D,), dtype=wdt, device=dev)
    if kind == "mamba":
        return {"ln": ones(), "mamba": init_mamba(generator, cfg, wdt, dev)}
    if kind == "rglru":
        return {"ln1": ones(), "rec": init_rglru(generator, cfg, wdt, dev),
                "ln2": ones(), "mlp": init_mlp(generator, D, cfg.d_ff, wdt, dev)}
    ffn = ({"moe": init_moe(generator, cfg, wdt, dev)} if kind == "moe" else
           {"mlp": init_mlp(generator, D, cfg.d_ff, wdt, dev)})
    return {"ln1": ones(), "attn": init_attention(generator, cfg, wdt, dev),
            "ln2": ones(), **ffn}


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
    if cfg.num_patches:
        params["patch_proj"] = normal_init(generator, (cfg.patch_dim, D),
                                           cfg.patch_dim ** -0.5, wdt, dev)
    params["layers"] = [_init_one(generator, cfg, kind, wdt, dev) for kind in kinds]
    return params


def param_tensors(params: dict) -> list[torch.Tensor]:
    """Every tensor of a parameter (or cache) tree, in a fixed order."""
    if isinstance(params, torch.Tensor):
        return [params]
    items = params.values() if isinstance(params, dict) else params
    return [t for item in items for t in param_tensors(item)]


def grid_specs(cfg: ModelConfig, mesh) -> dict[str, tuple]:
    """Every parameter's spec on ``mesh`` by its name (``layers/0/attn/w_q``),
    from the full shapes (drawn on the meta device); kept per config and
    grid shape, since every step asks."""
    return _grid_specs(cfg, tuple(mesh.dims), tuple(mesh.axis_names))


@functools.lru_cache(maxsize=32)
def _grid_specs(cfg: ModelConfig, dims: tuple, axis_names: tuple) -> dict[str, tuple]:
    full = init_params(cfg, torch.Generator(), "meta")
    grid = shd.AbstractGrid(dims, axis_names)
    return dict(zip((n for n, _ in shd.flat_names(full)), shd.param_specs(grid, full)))


def on_grid(mesh) -> bool:
    """Whether ``mesh`` is a grid of more than one rank, whose parameters
    are blocks (a grid of one rank holds them whole)."""
    return mesh is not None and mesh.size > 1


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device=None) -> list[dict]:
    """One decode cache per layer.  An attention cache's ``pos`` holds the
    position written to each slot, -1 for an empty one."""
    dev = resolve_device(device)
    Hkv, hd = cfg.num_kv_heads, cfg.head_dim_

    def one(kind):
        if kind == "mamba":
            return init_mamba_state(cfg, batch, dtype, dev)
        if kind == "rglru":
            return init_rglru_state(cfg, batch, dtype, dev)
        wlen = max_len
        if kind == "attn" and cfg.rglru is not None:
            wlen = min(max_len, cfg.rglru.window)   # ring-buffer window cache
        return {"k": torch.zeros((batch, Hkv, wlen, hd), dtype=dtype, device=dev),
                "v": torch.zeros((batch, Hkv, wlen, hd), dtype=dtype, device=dev),
                "pos": torch.full((wlen,), -1, dtype=torch.int32, device=dev)}
    return [one(kind) for kind in layer_kinds(cfg)]


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


def _ffn_block(p, h, cfg, kind, mesh=None):
    x = rms_norm(h, p["ln2"].to(h.dtype), cfg.rms_eps)
    if kind == "moe":
        return h + moe_layer(p["moe"], x, cfg, mesh)
    return h + mlp_layer(p["mlp"], x)


def apply_layer(p, h, cfg, kind, *, positions, cache, pos_scalar, q_chunk,
                mesh=None):
    """One block.  Returns (h, cache): the attention cache written in place,
    or a recurrent layer's new state.  ``mesh`` reaches the MoE layer only."""
    if kind == "mamba":
        x = rms_norm(h, p["ln"].to(h.dtype), cfg.rms_eps)
        out, st = mamba_layer(p["mamba"], x, cfg, cache)
        return h + out, st
    if kind == "rglru":
        x = rms_norm(h, p["ln1"].to(h.dtype), cfg.rms_eps)
        out, st = rglru_layer(p["rec"], x, cfg, cache)
        return _ffn_block(p, h + out, cfg, "mlp"), st
    window = cfg.rglru.window if cfg.rglru is not None else None
    h, st = _attn_block(p, h, cfg, positions=positions, window=window,
                        cache=cache, pos_scalar=pos_scalar, q_chunk=q_chunk)
    return _ffn_block(p, h, cfg, kind, mesh), st


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def forward(params, tokens, cfg: ModelConfig, *, patch_embeds=None, caches=None,
            pos_scalar=None, q_chunk: int = 512, remat: bool = False, mesh=None):
    """Returns (hidden (B, T, D), caches).

    tokens: (B, T_text) integer.  For a vlm, ``patch_embeds`` (B, P,
    patch_dim) are projected and prepended (T = P + T_text).  ``caches``
    with ``pos_scalar`` and T == 1 decodes one token at position
    ``pos_scalar`` (an int, uniform across the batch); ``caches`` alone
    prefills them.  Each layer's entry of ``caches`` is replaced by its new
    state.  ``remat`` (training, no caches) keeps only each layer's input
    for the backward and recomputes the layer there; under
    ``cfg.remat_policy == "save_block_out"`` an attention layer's two
    blocks are checkpointed apart, so its attention block's output stays
    (the reference's saved ``attn_out`` and ``moe_out``).

    ``mesh`` (a ``GridMesh``): on a grid of one rank it reaches
    ``moe_layer`` only.  On a grid of more (:func:`on_grid`; training, no
    caches) ``params`` are this rank's blocks and ``tokens`` this data
    rank's rows, laid out by ``models/tensor_parallel.py``: each layer
    gathers its weights inside its checkpoint, so they are whole for one
    layer at a time and its gradient is reduced in its own backward.
    """
    if remat and caches is not None:
        raise ValueError("remat=True is for training: it takes no caches")
    grid = on_grid(mesh)
    if grid and caches is not None:
        raise ValueError("forward on a grid is training's; serving on a grid is "
                         "serve/grid.py:grid_forward")
    by_name = grid_specs(cfg, mesh) if grid else None
    dt = compute_dtype(cfg)
    if grid:
        h = tp.embed(params["embed"], tokens, by_name["embed"], mesh, dt)
    else:
        h = params["embed"][tokens].to(dt)
    if cfg.num_patches and patch_embeds is not None:
        proj = params["patch_proj"]
        if grid:
            proj = tp.weight(proj, by_name["patch_proj"], mesh)[0]
        h = torch.cat([patch_embeds.to(dt) @ proj.to(dt), h], dim=1)
        del proj
    B, T, _ = h.shape
    if pos_scalar is not None and T == 1:
        positions = torch.full((B, 1), pos_scalar, dtype=torch.int32, device=h.device)
    else:
        positions = torch.arange(T, dtype=torch.int32, device=h.device)
    split = cfg.remat_policy == "save_block_out"
    for i, kind in enumerate(layer_kinds(cfg)):
        p = params["layers"][i]
        where = (f"layers/{i}", by_name) if grid else None
        if remat or grid:
            parts = ("attn", "ffn") if remat and split and kind in ("attn", "moe") else (None,)
            for part in parts:
                args = (p, h, cfg, kind, positions, q_chunk, mesh, part, where)
                h = checkpoint(_layer_out, *args, use_reentrant=False) if remat \
                    else _layer_out(*args)
            continue
        h, st = apply_layer(p, h, cfg, kind, positions=positions,
                            cache=None if caches is None else caches[i],
                            pos_scalar=pos_scalar, q_chunk=q_chunk, mesh=mesh)
        if caches is not None:
            caches[i] = st
    norm = params["final_norm"]
    if grid:
        norm = tp.weight(norm, by_name["final_norm"], mesh)[0]
    h = rms_norm(h, norm.to(dt), cfg.rms_eps)
    return h, caches


def _layer_out(p, h, cfg, kind, positions, q_chunk, mesh=None, part=None, where=None):
    """One cache-free block's output (its recurrent state dropped):
    the whole layer, or with ``part`` ("attn", "ffn") one of an attention
    layer's two blocks.  ``where`` is (the layer's name, the specs by
    name) on a grid, where ``p`` holds this rank's blocks."""
    if where is not None:
        return _grid_layer(p, h, cfg, kind, *where, mesh, positions, q_chunk, part)
    if part == "attn":
        window = cfg.rglru.window if cfg.rglru is not None else None
        return _attn_block(p, h, cfg, positions=positions, window=window, cache=None,
                           pos_scalar=None, q_chunk=q_chunk)[0]
    if part == "ffn":
        return _ffn_block(p, h, cfg, kind, mesh)
    return apply_layer(p, h, cfg, kind, positions=positions, cache=None,
                       pos_scalar=None, q_chunk=q_chunk, mesh=mesh)[0]


def _grid_norm(p, name, h, prefix, by_name, mesh, eps):
    scale = tp.weight(p[name], by_name[f"{prefix}/{name}"], mesh)[0]
    return rms_norm(h, scale.to(h.dtype), eps)


def _grid_layer(p, h, cfg, kind, prefix, by_name, mesh, positions, q_chunk, part=None):
    """One cache-free layer (or ``part`` of it) on a grid: each weight of
    this rank's blocks ``p`` gathered where the layer uses it
    (``models/tensor_parallel.py``); the experts as ``moe_layer`` takes
    them."""
    eps = cfg.rms_eps
    if kind == "mamba":
        x = _grid_norm(p, "ln", h, prefix, by_name, mesh, eps)
        out, _ = mamba_layer(tp.whole(p["mamba"], f"{prefix}/mamba", by_name, mesh), x, cfg)
        return h + out
    if kind == "rglru":
        x = _grid_norm(p, "ln1", h, prefix, by_name, mesh, eps)
        out, _ = rglru_layer(tp.whole(p["rec"], f"{prefix}/rec", by_name, mesh), x, cfg)
        h = h + out
        x = _grid_norm(p, "ln2", h, prefix, by_name, mesh, eps)
        return h + tp.mlp(p["mlp"], x, f"{prefix}/mlp", by_name, mesh)
    if part != "ffn":
        x = _grid_norm(p, "ln1", h, prefix, by_name, mesh, eps)
        window = cfg.rglru.window if cfg.rglru is not None else None
        h = h + tp.attention(p["attn"], x, cfg, f"{prefix}/attn", by_name, mesh,
                             positions=positions, window=window, q_chunk=q_chunk)
    if part != "attn":
        x = _grid_norm(p, "ln2", h, prefix, by_name, mesh, eps)
        if kind == "moe":
            pm = dict(p["moe"], router=tp.weight(p["moe"]["router"],
                                                 by_name[f"{prefix}/moe/router"], mesh)[0])
            h = h + moe_layer(pm, x, cfg, mesh)
        else:
            h = h + tp.mlp(p["mlp"], x, f"{prefix}/mlp", by_name, mesh)
    return h


def unembed(params, h, cfg: ModelConfig):
    W = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    f32 = torch.promote_types(h.dtype, torch.float32)     # f64 in an f64 model
    return h.to(f32) @ W.to(f32).T


# ---------------------------------------------------------------------------
# Loss: chunked cross-entropy (never materializes (B, T, V))
# ---------------------------------------------------------------------------


def _chunk_nll(h, labels, W):
    """Summed NLL over labels >= 0 of one chunk, and their count."""
    logits = h.to(torch.float32) @ W.to(torch.float32).T           # (B, c, V)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, labels.clamp(min=0)[..., None].long())[..., 0]
    m = (labels >= 0).to(torch.float32)
    return ((lse - tgt) * m).sum(), m.sum()


def _chunk_nll_vocab(h, labels, W, mesh):
    """:func:`_chunk_nll` with the vocab split over the model axis: ``W``
    is this rank's rows of the table.  The logsumexp combines the ranks'
    (the largest logit first, then the sums) and the target's logit comes
    from the rank that holds its row."""
    logits = h.to(torch.float32) @ W.to(torch.float32).T           # (B, c, V / M)
    rows = W.shape[0]
    mx = mesh.all_reduce_max(logits.detach().amax(dim=-1), ("model",))
    local = labels.long() - mesh.axis_index("model") * rows
    mine = (local >= 0) & (local < rows)
    tgt = torch.gather(logits, -1, local.clamp(0, rows - 1)[..., None])[..., 0]
    both = torch.stack([torch.exp(logits - mx[..., None]).sum(dim=-1),
                        torch.where(mine, tgt, 0)])
    both = tp.reduce_from_model(both, mesh)
    m = (labels >= 0).to(torch.float32)
    return ((mx + torch.log(both[0]) - both[1]) * m).sum(), m.sum()


def lm_loss(params, hidden, labels, cfg: ModelConfig, chunk: int = 256, mesh=None):
    """Mean NLL over labels >= 0.  hidden (B, T, D); labels (B, T).

    Runs T in chunks of ``chunk`` (all of T when ``chunk`` does not divide
    it), each under a non-reentrant checkpoint: the (B, c, V) f32 logits
    block exists only while its chunk runs, forward and backward.

    On a grid, ``hidden`` and ``labels`` are this data rank's rows and the
    mean is over the global batch: this rank's NLL sum over the global
    count of labels >= 0, summed over the batch axes.  The value is the
    reference's on every rank; the sum's backward is the identity, so each
    rank's gradient is its rows' share, and the shares add up exactly over
    the data ranks.  On a grid of more than one rank the table is this
    rank's block, gathered once for every chunk; where its vocab splits
    over the model axis, each rank's chunks run on its rows of the vocab
    (:func:`_chunk_nll_vocab`).
    """
    T = hidden.shape[1]
    name = "embed" if cfg.tie_embeddings else "lm_head"
    W, split = params[name], False
    if on_grid(mesh):
        W, split = tp.weight(W, grid_specs(cfg, mesh)[name], mesh, keep=0)
        if split:
            hidden = tp.copy_to_model(hidden, mesh)
    c = min(chunk, T)
    if T % c:
        c = T
    nll = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, T, c):
        args = (hidden[:, i:i + c], labels[:, i:i + c], W) + ((mesh,) if split else ())
        n, k = checkpoint(_chunk_nll_vocab if split else _chunk_nll, *args,
                          use_reentrant=False)
        nll, cnt = nll + n, cnt + k
    axes = () if mesh is None else batch_axes(mesh)
    if axis_size(mesh, axes) == 1:
        return nll / torch.clamp(cnt, min=1.0)
    cnt = mesh.all_reduce_sum(cnt.detach(), axes)
    return reduce_from(nll / torch.clamp(cnt, min=1.0), mesh, axes)
