"""Plain oracles for the kernels, independent of their plain versions."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import expansions as ex
from ..core.quadtree import P2P_OFFSETS
from ..core.vortex import pairwise_w


def p2p_ref(z, q, mask, sigma=None):
    """Near-field direct sum over the 3x3 stencil; complex W per slot."""
    ny, nx, _ = z.shape
    pad = (0, 0, 1, 1, 1, 1)
    zp, qp, mp = F.pad(z, pad), F.pad(q, pad), F.pad(mask, pad)
    w = 0
    for (dx, dy) in P2P_OFFSETS:
        w = w + pairwise_w(z,
                           zp[1 + dy:1 + dy + ny, 1 + dx:1 + dx + nx],
                           qp[1 + dy:1 + dy + ny, 1 + dx:1 + dx + nx],
                           mp[1 + dy:1 + dy + ny, 1 + dx:1 + dx + nx],
                           sigma)
    return w


def m2l_ref(me, level: int, p: int):
    """Dense 40-offset masked M2L — the independent (pre-folding) oracle."""
    return ex.m2l_masked40(me, level, p)


def attention_ref(q, k, v, causal: bool = True):
    """Exact softmax attention with GQA head grouping.  f32 math.

    The causal mask is bottom-right aligned (``tril(k=S-T)``): the model's
    mask, where the last query sees every key.  It agrees with the flash
    kernel's top-left mask only for ``T == S``.
    """
    B, H, T, d = q.shape
    _, Hkv, S, _ = k.shape
    group = H // Hkv
    k = torch.repeat_interleave(k, group, dim=1)
    v = torch.repeat_interleave(v, group, dim=1)
    s = torch.einsum("bhtd,bhsd->bhts", q.to(torch.float32),
                     k.to(torch.float32)) / (d ** 0.5)
    if causal:
        mask = torch.tril(torch.ones((T, S), dtype=torch.bool, device=q.device),
                          diagonal=S - T)
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    a = torch.exp(s - s.amax(dim=-1, keepdim=True))
    a = a / a.sum(dim=-1, keepdim=True)
    return torch.einsum("bhts,bhsd->bhtd", a, v.to(torch.float32)).to(q.dtype)
