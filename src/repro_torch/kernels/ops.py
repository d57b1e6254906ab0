"""Dispatchers for the kernels: the device of the tensor decides.

A CUDA tensor launches the hand-written kernel (or the launch raises); a
CPU tensor takes the kernel's plain PyTorch version.  There is no
fallback from one to the other.  The M2L wrappers come in the grid form
(zero ghost rows attached here) and the slab form (ghosts attached by the
caller); both run ``expansions.m2l_folded`` with the kernel's contraction.
``p2m_apply`` and ``l2p_apply`` are the leaf expansions' per-box
computation, which ``expansions.p2m`` and ``expansions.l2p_eval`` take as
``compute``.
``flash_attention`` serves the LM's prefill attention; it picks one of its
three kernels by ``flash_attn.route`` (device, dtype, head dim).
``flash_attention_with_grad`` is the same call inside autograd, for
training.

Every P2P, M2L, P2M and L2P wrapper passes a leading batch axis through
to its kernel: a batch of grids is one launch, and one count.

``plain=True`` runs the kernels' plain versions and is taken on CPU
tensors only (a CUDA tensor raises): the stepper's recovery ladder asks
for it on its ``reference`` rung on the CPU, and every such call adds one
to ``PLAIN_CALLS``.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .. import spans
from ..core import equations as eqs
from ..core import expansions as ex
from . import flash_attn as _fa
from . import leaf_expansions as _leaf
from . import m2l as _m2l
from . import p2p as _p2p

PLAIN_CALLS = 0     # P2P, M2L, P2M and L2P calls made with plain=True since the last reset


def _count_plain(t: torch.Tensor) -> None:
    global PLAIN_CALLS
    if t.device.type != "cpu":
        raise ValueError(f"plain=True takes CPU tensors only, not {t.device}: on "
                         f"the card the kernel launches or raises")
    PLAIN_CALLS += 1


def p2p_apply_slab(z_halo, q_halo, mask_halo, sigma, z_tgt=None,
                   mask_tgt=None, eq=None, plain: bool = False):
    """P2P over a slab with ±1 ghost rows/cols attached, ([B,] rows+2,
    cols+2, s) -> ([B,] rows, cols, st) or ([B,] rows, cols, st, eq.nout);
    ``z_tgt``/``mask_tgt`` ([B,] rows, cols, st) are passive targets (None:
    the sources, ``st = s``).  Masked targets get 0.

    A spec whose ``p2p_terms`` the kernel computes (``equations.p2p_mode``)
    goes to the kernel or its plain version; any other runs on the CPU
    through its own ``pairwise`` (``fmm.p2p_slab_reference``) and raises on
    the card.
    """
    eq = eqs.get_equation(eq)
    mode = eqs.p2p_mode(eq)
    if plain:
        _count_plain(z_halo)
    if mode is None:
        if z_halo.device.type != "cpu":
            raise NotImplementedError(
                f"the P2P kernel computes the base and Laplace pair formulas; "
                f"equation {eq!r} defines its own")
        from ..core.fmm import p2p_slab_reference
        out = p2p_slab_reference(z_halo, q_halo, mask_halo, sigma, z_tgt=z_tgt,
                                 eq=eq)
        live = mask_halo[..., 1:-1, 1:-1, :] if z_tgt is None else mask_tgt
        return torch.where(live if out.ndim == live.ndim else live[..., None],
                           out, 0)
    if z_halo.device.type == "cpu":
        return _p2p.p2p_plain(z_halo, q_halo, mask_halo, sigma, z_tgt, mask_tgt,
                              mode)
    return _p2p.p2p_cuda(z_halo, q_halo, mask_halo, sigma, z_tgt, mask_tgt, mode)


def m2l_contract(stack: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """The folded contraction on the stack's device."""
    if stack.device.type == "cpu":
        return _m2l.m2l_plain(stack, W)
    return _m2l.m2l_cuda(stack, W)


def _m2l_plain_contract(stack: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    _count_plain(stack)
    return _m2l.m2l_plain(stack, W)


@functools.lru_cache(maxsize=None)
def folded_operator(eq, p: int, level: int, device: torch.device) -> torch.Tensor:
    """``eq``'s folded (8, 4p, 4p) operator, copied to ``device`` once."""
    return torch.as_tensor(eq.m2l_folded(p, level), dtype=torch.complex64,
                           device=device)


def m2l_apply_slab(me_halo, level: int, p: int, row0: int = 0,
                   halo: int = ex.M2L_HALO, col0: int = 0, col_halo: int = 0,
                   eq=None, plain: bool = False):
    """Parity-folded M2L over a halo'd row slab or 2-D tile; ``col_halo>0``
    means column ghosts are attached too."""
    eq = eqs.get_equation(eq)
    return ex.m2l_folded(me_halo, level, p, row0=row0, halo=halo, col0=col0,
                         col_halo=col_halo,
                         op=folded_operator(eq, p, level, me_halo.device),
                         scale=eq.m2l_scale(level),
                         contract=_m2l_plain_contract if plain else m2l_contract)


def m2l_apply(me, level: int, p: int, eq=None, plain: bool = False):
    """Parity-folded M2L for one level's full ([B,] ny, nx, p) ME grid."""
    with spans.span("m2l.stage", me.device, level=level):
        me_halo = F.pad(me, (0, 0, 0, 0, ex.M2L_HALO, ex.M2L_HALO))
    return m2l_apply_slab(me_halo, level, p, eq=eq, plain=plain)


def p2m_apply(z, q, mask, centers, r: float, p: int, coeff=None,
              plain: bool = False):
    """The leaf MEs, ``expansions.p2m``'s ``compute``: the P2M kernel for
    CUDA tensors, its plain version for CPU tensors (and with ``plain``,
    CPU tensors only)."""
    if plain:
        _count_plain(z)
    if z.device.type == "cpu":
        return _leaf.p2m_plain(z, q, mask, centers, r, p, coeff)
    return _leaf.p2m_cuda(z, q, mask, centers, r, p, coeff)


def l2p_apply(le, z, centers, r: float, p: int, modes=("value",),
              plain: bool = False):
    """The leaf LEs at the slots, ``expansions.l2p_eval``'s ``compute``: the
    L2P kernel for CUDA tensors, its plain version for CPU tensors (and with
    ``plain``, CPU tensors only)."""
    if plain:
        _count_plain(z)
    if z.device.type == "cpu":
        return _leaf.l2p_plain(le, z, centers, r, p, modes)
    return _leaf.l2p_cuda(le, z, centers, r, p, modes)


def flash_attention(q, k, v, causal: bool = True):
    """Blockwise attention; q (B, H, T, d), k/v (B, Hkv, S, d), top-left
    causal mask, on the route ``flash_attn.route`` names.  Every route's
    kernel reads the model's strided views as they are (no copy); the
    ``simt`` route's, like the others, runs on the tensor cores."""
    which = _fa.route(q, k)
    if which == "plain":
        return _fa.flash_attention_plain(q, k, v, causal=causal)
    if which == "tc":
        return _fa.flash_attention_tc(q, k, v, causal=causal)
    if which == "tf32":
        return _fa.flash_attention_tf32(q, k, v, causal=causal)
    return _fa.flash_attention_cuda(q, k, v, causal=causal)


class _FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` as an autograd node.  The forward launches
    the route's kernel and saves q, k and v; the backward recomputes the
    plain version one query chunk of ``q_chunk`` rows at a time (those rows
    against the keys they can see) and differentiates it: the chunk's
    ``dq`` lands in its rows, ``dk``/``dv`` add up in f32 and are cast once
    at the end, and each chunk's blocks are freed before the next.  The TPU
    kernel has no backward kernel either: the reference's training never
    calls it."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_chunk):
        ctx.causal, ctx.q_chunk = causal, q_chunk
        ctx.save_for_backward(q, k, v)
        return flash_attention(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        T, S = q.shape[2], k.shape[2]
        qc = min(ctx.q_chunk, T)
        dq = torch.empty_like(q)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for lo in range(0, T, qc):
            hi = min(lo + qc, T)
            # a causal chunk sees the keys up to its last row (T == S here)
            s = hi if ctx.causal and T == S else S
            with torch.enable_grad():
                parts = [q[:, :, lo:hi].detach().requires_grad_(),
                         k[:, :, :s].detach().float().requires_grad_(),
                         v[:, :, :s].detach().float().requires_grad_()]
                out = _fa.flash_attention_plain(*parts, causal=ctx.causal,
                                                q_offset=lo if ctx.causal and T == S else 0)
            gq, gk, gv = torch.autograd.grad(out, parts, grad[:, :, lo:hi])
            dq[:, :, lo:hi] = gq
            dk[:, :, :s] += gk
            dv[:, :, :s] += gv
            del out, parts, gq, gk, gv
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None


def flash_attention_with_grad(q, k, v, causal: bool = True, q_chunk: int = 512):
    """:func:`flash_attention` (the same launch, counted as it is) with a
    gradient: the plain version's, recomputed in the backward one query
    chunk of ``q_chunk`` rows at a time.  Under ``no_grad`` or
    ``inference_mode`` it records nothing."""
    return _FlashAttention.apply(q, k, v, causal, q_chunk)
