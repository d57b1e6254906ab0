"""Dispatchers for the kernels: the device of the tensor decides.

A CUDA tensor launches the hand-written kernel (or the launch raises); a
CPU tensor takes the kernel's plain PyTorch version.  There is no
fallback from one to the other.  The M2L wrappers come in the grid form
(zero ghost rows attached here) and the slab form (ghosts attached by the
caller); both run ``expansions.m2l_folded`` with the kernel's contraction.
``flash_attention`` serves the LM's prefill attention; it picks one of its
three kernels by ``flash_attn.route`` (device, dtype, head dim).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..core import equations as eqs
from ..core import expansions as ex
from . import flash_attn as _fa
from . import m2l as _m2l
from . import p2p as _p2p


def p2p_apply_slab(z_halo, q_halo, mask_halo, sigma, eq=None):
    """P2P over a slab with ±1 ghost rows/cols attached -> (rows, cols, s)."""
    eq = eqs.get_equation(eq)
    if not eqs.uses_base_p2p(eq):
        raise NotImplementedError(
            f"the P2P kernel implements the vortex pair formula; equation "
            f"{eq.name!r} overrides it")
    if z_halo.device.type == "cpu":
        return _p2p.p2p_plain(z_halo, q_halo, mask_halo, sigma)
    return _p2p.p2p_cuda(z_halo, q_halo, mask_halo, sigma)


def m2l_contract(stack: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """The folded contraction on the stack's device."""
    if stack.device.type == "cpu":
        return _m2l.m2l_plain(stack, W)
    return _m2l.m2l_cuda(stack, W)


@functools.lru_cache(maxsize=None)
def folded_operator(eq, p: int, level: int, device: torch.device) -> torch.Tensor:
    """``eq``'s folded (8, 4p, 4p) operator, copied to ``device`` once."""
    return torch.as_tensor(eq.m2l_folded(p, level), dtype=torch.complex64,
                           device=device)


def m2l_apply_slab(me_halo, level: int, p: int, row0: int = 0,
                   halo: int = ex.M2L_HALO, col0: int = 0, col_halo: int = 0,
                   eq=None):
    """Parity-folded M2L over a halo'd row slab or 2-D tile; ``col_halo>0``
    means column ghosts are attached too."""
    eq = eqs.get_equation(eq)
    return ex.m2l_folded(me_halo, level, p, row0=row0, halo=halo, col0=col0,
                         col_halo=col_halo,
                         op=folded_operator(eq, p, level, me_halo.device),
                         scale=eq.m2l_scale(level), contract=m2l_contract)


def m2l_apply(me, level: int, p: int, eq=None):
    """Parity-folded M2L for one level's full (ny, nx, p) ME grid."""
    me_halo = F.pad(me, (0, 0, 0, 0, ex.M2L_HALO, ex.M2L_HALO))
    return m2l_apply_slab(me_halo, level, p, eq=eq)


def flash_attention(q, k, v, causal: bool = True):
    """Blockwise attention; q (B, H, T, d), k/v (B, Hkv, S, d), top-left
    causal mask, on the route ``flash_attn.route`` names.  The tensor-core
    kernels (bf16 and 3xTF32) read strided views as they are; the SIMT
    kernel gets contiguous copies."""
    which = _fa.route(q, k)
    if which == "plain":
        return _fa.flash_attention_plain(q, k, v, causal=causal)
    if which == "tc":
        return _fa.flash_attention_tc(q, k, v, causal=causal)
    if which == "tf32":
        return _fa.flash_attention_tf32(q, k, v, causal=causal)
    return _fa.flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                    causal=causal)
