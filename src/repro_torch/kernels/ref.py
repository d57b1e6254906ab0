"""Plain oracles for the kernels, independent of their plain versions."""
from __future__ import annotations

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
