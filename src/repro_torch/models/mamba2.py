"""Mamba-2 SSD (state-space duality) block, arXiv:2405.21060.

The reference's ``models/mamba2.py``.  Prefill runs the chunked SSD
algorithm: within a chunk a quadratic, attention-like product, across
chunks a linear recurrence over the chunk states.  A length that the chunk
does not divide is one chunk (the reference's fallback), whose ``(l, l)``
decay and weight blocks are materialized whole; the decay block is built
in place (autograd saves neither tensor those steps overwrite) and the
weights out of place (autograd saves the decay block for the product's
backward).  Decode is the recurrence on a ``(heads, head_dim, d_state)``
f32 state.  A single group (G = 1), as in the 1.3b config.

``a_log``, ``dt_bias`` and ``d_skip`` are read in f32 and stored so; the
rest in the compute dtype.  The f32 math is f64 in an f64 model.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import normal_init, rms_norm


def _dims(cfg: ModelConfig):
    m = cfg.mamba
    d_in = m.expand * cfg.d_model
    nheads = d_in // m.head_dim
    return m, d_in, nheads


def init_mamba(generator: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
               device=None) -> dict:
    m, d_in, nheads = _dims(cfg)
    conv_ch = d_in + 2 * m.d_state
    proj_out = 2 * d_in + 2 * m.d_state + nheads
    f32 = torch.float32
    D = cfg.d_model
    return {
        "in_proj": normal_init(generator, (D, proj_out), D ** -0.5, dtype, device),
        "conv_w": normal_init(generator, (m.d_conv, conv_ch), 0.5, dtype, device),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nheads, dtype=f32, device=device)),
        "dt_bias": torch.zeros((nheads,), dtype=f32, device=device),
        "d_skip": torch.ones((nheads,), dtype=f32, device=device),
        "norm_scale": torch.ones((d_in,), dtype=dtype, device=device),
        "out_proj": normal_init(generator, (d_in, D), d_in ** -0.5, dtype, device),
    }


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., l) -> (..., l, l) lower-triangular cumulative segment sums,
    -inf above the diagonal."""
    l = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    upper = torch.ones((l, l), dtype=torch.bool, device=a.device).triu_(1)
    return d.masked_fill_(upper, float("-inf"))


def _ssd_chunked(x, dt, a, Bm, Cm, chunk: int, init_state=None, big_dtype=None):
    """Chunked SSD.  x: (B, T, H, P); dt: (B, T, H); a: (H,) (negative);
    Bm, Cm: (B, T, N).  Returns (y, final_state (B, H, P, N)).

    ``big_dtype`` rounds the large intermediates (the weights W, x * dt,
    the chunk states' inputs) as the reference does; products accumulate in
    x's dtype (f32, or f64) and so does the decay math."""
    B_, T, H, P_ = x.shape
    N = Bm.shape[-1]
    l = min(chunk, T)
    if T % l:
        l = T
    nc = T // l
    xr = x.reshape(B_, nc, l, H, P_)
    dtr = dt.reshape(B_, nc, l, H)
    Br = Bm.reshape(B_, nc, l, N)
    Cr = Cm.reshape(B_, nc, l, N)
    bdt = big_dtype or x.dtype

    def rounded(t):
        return t.to(bdt).to(x.dtype)

    dA = dtr * a                                          # (b, c, l, h)
    dA_cum = torch.cumsum(dA, dim=2)

    # 1) within each chunk: W = (C B^T) * L, then one batched (l,s)@(s,hp)
    S = torch.einsum("bcln,bcsn->bcls", Cr, Br)           # (b, c, l, s)
    L = _segsum(dA.permute(0, 1, 3, 2)).exp_()            # (b, c, h, l, s)
    W = rounded(L * S[:, :, None])                        # L * S
    del L
    xdt = rounded(xr * dtr[..., None])                    # (b, c, s, h, p)
    Y = torch.einsum("bchls,bcshp->bclhp", W, xdt)
    del W, S, xdt

    # 2) each chunk's input state
    decay_states = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)   # (b, c, l, h)
    xw = rounded(xr * (decay_states * dtr)[..., None])        # (b, c, l, h, p)
    states = torch.einsum("bcln,bclhp->bchpn", rounded(Br), xw)

    # 3) the recurrence over chunks
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])              # (b, c, h)
    s = (torch.zeros((B_, H, P_, N), dtype=x.dtype, device=x.device)
         if init_state is None else init_state)
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, c][..., None, None] + states[:, c]
    prev = torch.stack(prev, dim=1)                           # (b, c, h, p, n)

    # 4) the previous chunks' state, seen from each position
    state_decay = torch.exp(dA_cum)                           # (b, c, l, h)
    Y_off = torch.einsum("bcln,bchpn->bclhp", Cr, prev)
    Y = Y + Y_off * state_decay[..., None]
    return Y.reshape(B_, T, H, P_), s


def mamba_layer(p, x: torch.Tensor, cfg: ModelConfig, state: Optional[dict] = None):
    """x: (B, T, D).  state: {'ssm': (B, H, P, N) f32, 'conv': (B, dc-1, ch)}.

    Returns (out, new_state): one step when ``state`` is given and T == 1,
    else the chunked scan from ``state['ssm']`` (zero without one)."""
    m, d_in, nheads = _dims(cfg)
    B_, T, D = x.shape
    dt_ = x.dtype
    zxbcdt = x @ p["in_proj"].to(dt_)
    z, xbc, dt_raw = torch.split(zxbcdt, [d_in, d_in + 2 * m.d_state, nheads], dim=-1)

    # causal depthwise conv over (x, B, C); the tail keeps the promoted dtype
    dc = m.d_conv
    tail = (torch.zeros((B_, dc - 1, xbc.shape[-1]), dtype=dt_, device=x.device)
            if state is None else state["conv"])
    xp = torch.cat([tail, xbc], dim=1)
    xbc = sum(xp[:, dc - 1 - j:dc - 1 - j + T] * p["conv_w"][j].to(dt_)
              for j in range(dc)) + p["conv_b"].to(dt_)
    new_conv = xp[:, -(dc - 1):]
    xbc = F.silu(xbc)
    xs, Bm, Cm = torch.split(xbc, [d_in, m.d_state, m.d_state], dim=-1)

    f32 = torch.promote_types(dt_, torch.float32)                      # f64 in f64
    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"])                     # (B, T, H)
    a = -torch.exp(p["a_log"])                                         # (H,)
    xh = xs.reshape(B_, T, nheads, m.head_dim).to(f32)
    Bm32, Cm32 = Bm.to(f32), Cm.to(f32)

    if state is not None and T == 1:
        dec = torch.exp(dt[:, 0] * a)                                  # (B, H)
        upd = torch.einsum("bn,bh,bhp->bhpn", Bm32[:, 0], dt[:, 0], xh[:, 0])
        final = state["ssm"] * dec[..., None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", Cm32[:, 0], final)[:, None]   # (B, 1, H, P)
    else:
        init = state["ssm"] if state is not None else None
        y, final = _ssd_chunked(xh, dt, a, Bm32, Cm32, m.chunk, init,
                                big_dtype=getattr(torch, cfg.score_dtype))

    y = y + p["d_skip"][:, None] * xh                                  # skip
    y = y.reshape(B_, T, d_in).to(dt_)
    y = y * F.silu(z)
    y = rms_norm(y, p["norm_scale"].to(dt_), cfg.rms_eps)
    out = y @ p["out_proj"].to(dt_)
    return out, {"ssm": final, "conv": new_conv}


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> dict:
    m, d_in, nheads = _dims(cfg)
    return {"ssm": torch.zeros((batch, nheads, m.head_dim, m.d_state),
                               dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, m.d_conv - 1, d_in + 2 * m.d_state),
                                dtype=dtype, device=device)}
