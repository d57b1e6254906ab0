"""RecurrentGemma/Griffin recurrent block: the RG-LRU recurrence.

The reference's ``models/rglru.py``.  The recurrence

    a_t = exp(-c * softplus(Lambda) * r_t),   r_t = sigmoid(W_a x_t)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

is linear in h.  Prefill runs it as a log-depth doubling scan over time
(the reference's ``lax.associative_scan``, whose tree adds in another
order); decode is the one-step recurrence on the carried ``h``.

``lru_wa``, ``lru_wi``, ``lru_lambda``, ``lru_ba`` and ``lru_bi`` are read
in f32 whatever the compute dtype, and stored so; the rest in the compute
dtype.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import normal_init

_C = 8.0  # RG-LRU temperature constant


def init_rglru(generator: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
               device=None) -> dict:
    D = cfg.d_model
    W = cfg.rglru.lru_width or D
    f32 = torch.float32
    return {
        "w_gate": normal_init(generator, (D, W), D ** -0.5, dtype, device),
        "w_in": normal_init(generator, (D, W), D ** -0.5, dtype, device),
        "w_out": normal_init(generator, (W, D), W ** -0.5, dtype, device),
        "conv_w": normal_init(generator, (4, W), 0.5, dtype, device),
        "lru_wa": normal_init(generator, (W, W), W ** -0.5, f32, device),
        "lru_wi": normal_init(generator, (W, W), W ** -0.5, f32, device),
        "lru_lambda": torch.linspace(0.5, 4.0, W, dtype=f32, device=device),
        "lru_ba": torch.zeros((W,), dtype=f32, device=device),
        "lru_bi": torch.zeros((W,), dtype=f32, device=device),
    }


def _causal_conv4(x: torch.Tensor, w: torch.Tensor, state=None):
    """Depthwise causal conv, width 4.  x: (B, T, W); w: (4, W).

    state: (B, 3, W) trailing inputs of the previous segment.  Returns
    (y, new_state); the tail takes the promoted dtype of state and x.
    """
    B, T, W = x.shape
    tail = torch.zeros((B, 3, W), dtype=x.dtype, device=x.device) if state is None else state
    xp = torch.cat([tail, x], dim=1)                  # (B, T+3, W)
    y = sum(xp[:, 3 - j:3 - j + T] * w[j] for j in range(4))
    return y, xp[:, -3:]


def _lru_scan(a: torch.Tensor, b: torch.Tensor, h0=None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1, by doubling: after the step of
    span s, (a_t, b_t) compose the 2s steps ending at t.  a, b: (B, T, W).

    Under autograd each step builds a new ``a`` and ``b`` from the old ones
    (autograd keeps the old ones for the backward); otherwise it updates
    copies in place, which writes only the part that changes (12% of
    recurrentgemma-2b's serving prefill on an H100, PERF.md §6).  Both take the same sums
    and products, so they give the same values."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (a, b, h0)):
        return _lru_scan_out_of_place(a, b, h0)
    a, b = a.clone(), b.clone()
    if h0 is not None:
        b[:, 0] += a[:, 0] * h0          # fold the initial state into the first step
    T = a.shape[1]
    s = 1
    while s < T:
        # each right-hand side is formed whole before it is written back
        b[:, s:] += a[:, s:] * b[:, :-s]
        a[:, s:] = a[:, s:] * a[:, :-s]
        s *= 2
    return b


def _lru_scan_out_of_place(a: torch.Tensor, b: torch.Tensor, h0=None) -> torch.Tensor:
    """:func:`_lru_scan` with every step out of place, for autograd."""
    if h0 is not None:
        b = torch.cat([(b[:, 0] + a[:, 0] * h0)[:, None], b[:, 1:]], dim=1)
    T = a.shape[1]
    s = 1
    while s < T:
        b = torch.cat([b[:, :s], b[:, s:] + a[:, s:] * b[:, :-s]], dim=1)
        a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return b


def rglru_layer(p, x: torch.Tensor, cfg: ModelConfig, state: Optional[dict] = None):
    """x: (B, T, D).  state: {'h': (B, W) f32, 'conv': (B, 3, W)}.

    Returns (out, new_state): one step of the recurrence when ``state`` is
    given and T == 1, else the scan from ``state['h']`` (zero without one).
    """
    dt = x.dtype
    u = F.gelu(x @ p["w_gate"].to(dt), approximate="tanh")
    c = x @ p["w_in"].to(dt)
    conv_state = state["conv"] if state is not None else None
    c, new_conv = _causal_conv4(c, p["conv_w"].to(dt), conv_state)

    cf = c.to(torch.float32)
    r = torch.sigmoid(cf @ p["lru_wa"] + p["lru_ba"])
    i = torch.sigmoid(cf @ p["lru_wi"] + p["lru_bi"])
    log_a = -_C * F.softplus(p["lru_lambda"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * cf)

    if state is not None and x.shape[1] == 1:          # decode: one step
        h = a[:, 0] * state["h"] + b[:, 0]
        hseq = h[:, None]
    else:
        hseq = _lru_scan(a, b, state["h"] if state is not None else None)
    out = (u * hseq.to(dt)) @ p["w_out"].to(dt)
    return out, {"h": hseq[:, -1], "conv": new_conv}


def init_rglru_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> dict:
    W = cfg.rglru.lru_width or cfg.d_model
    return {"h": torch.zeros((batch, W), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, 3, W), dtype=dtype, device=device)}
