"""Blockwise online-softmax (flash) attention: CUDA kernel and plain version.

``flash_attention_cuda`` launches ``csrc/flash_attn.cu``, which replaces the
TPU kernel ``_fa_kernel`` launched by ``flash_attention`` in
``src/repro/kernels/flash_attn.py``.  Both compute, for q ``(B, H, T, d)``
and k, v ``(B, Hkv, S, d)`` with ``H % Hkv == 0``, exact softmax attention
in f32 with GQA by index arithmetic (query head ``h`` reads key/value head
``h // (H // Hkv)``), and write the output in q's dtype.

The causal mask is the TPU kernel's **top-left** one: key ``kpos`` is hidden
from query ``qpos`` when ``kpos > qpos``.  For ``T == S`` that is the
model's causal mask.  For ``T != S`` it is not the bottom-right mask of
``ref.attention_ref`` (``tril(k=S-T)``); the model routes only ``T == S``
here (``models.layers.attention_core``).

Bound on an H100 at Yi-6B's prefill shape (4, 32, 4, 2048, 128) bf16,
causal: operations, 137.5 GFLOP against 151 MB of traffic.  The kernel runs
its products as FP32 SIMT FMAs (2.05 ms at 67 TFLOP/s); the tensor-core
bound is 0.139 ms.  Design: see the note in the CUDA source.

``flash_attention_plain`` is the same function in plain PyTorch; the CPU
path and the kernel's checks use it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 256

LAUNCHES = 0        # kernel launches since the last reset


def _check_shapes(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, H, T, d) and k, v (B, Hkv, S, d); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, _, d = q.shape
    if k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if H % k.shape[1]:
        raise ValueError(f"{H} query heads are not a multiple of {k.shape[1]} "
                         f"key/value heads")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """q (B, H, T, d), k/v (B, Hkv, S, d) -> (B, H, T, d) in q's dtype.

    f32 math, top-left causal mask (``kpos > qpos`` hidden), masked scores
    contributing exactly 0 and the TPU kernel's ``l > 0`` guard.
    """
    _check_shapes(q, k, v)
    B, H, T, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    g = H // Hkv
    qf = q.to(torch.float32).reshape(B, Hkv, g, T, d)
    s = torch.einsum("bkgtd,bksd->bkgts", qf, k.to(torch.float32)) * (1.0 / d ** 0.5)
    if causal:
        hidden = (torch.arange(S, device=q.device)[None, :]
                  > torch.arange(T, device=q.device)[:, None])
        s = s.masked_fill(hidden, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    if causal:
        p = p.masked_fill(hidden, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgts,bksd->bkgtd", p, v.to(torch.float32))
    o = o / torch.where(l > 0, l, torch.ones_like(l))
    return o.reshape(B, H, T, d).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attn")
    fn = lib.flash_attn_launch
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, ctypes.c_float, i, i, vp]
        fn.restype = i
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Launch the CUDA flash-attention kernel; same contract as
    :func:`flash_attention_plain`.  Inputs must be contiguous: the caller
    makes them so after its ``(B, T, H, d) -> (B, H, T, d)`` transpose."""
    global LAUNCHES
    _check_shapes(q, k, v)
    B, H, T, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} must be a multiple of 8 in "
                         f"[8, {MAX_HEAD_DIM}]")
    if T == 0 or S == 0:
        raise ValueError(f"empty sequence: T={T}, S={S}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype not in (torch.float32, torch.bfloat16) or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}; q, k and v must all be "
                             f"float32 or all bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_attn_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   out.data_ptr(), B, H, Hkv, T, S, d,
                                   1.0 / d ** 0.5, int(causal),
                                   int(q.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
