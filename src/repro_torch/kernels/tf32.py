"""The 3xTF32 split of ``csrc/tf32x3.cuh``, modelled in plain PyTorch, and
the card's own answer to what a TF32 tensor-core pass reads.

An f32 ``x`` splits into ``hi = rna(x)``, TF32 rounded to nearest with
ties away from zero (10 mantissa bits), and ``lo = x - hi``, exact in f32.
The tensor core ignores the low 13 bits of each operand, so it reads ``lo``
truncated to TF32.  A product ``a @ b`` then runs as ``a_lo @ b_hi +
a_hi @ b_lo + a_hi @ b_hi``: each TF32 x TF32 product is exact in f32 and
the sums are f32.  :func:`matmul_3xtf32` is that arithmetic on the CPU, for
the tests that hold the kernels' method to the reference; the kernels
(``csrc/m2l.cu``, ``csrc/flash_attn_tf32.cu``) do it on the card.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

HALF_ULP = 0x1000   # half a TF32 ulp in f32 bits
MASK = -0x2000      # 0xffffe000 as int32: sign, exponent, 10 mantissa bits


def truncate(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` with its low 13 bits cleared: what a TF32 pass reads."""
    return (x.view(torch.int32) & MASK).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` of f32 ``x``, as the kernels compute them: an integer
    add of half an ulp and a mask give ``hi``, an f32 subtraction ``lo``.
    ``hi + lo == x`` exactly for finite ``|x| < 2**128 * (1 - 2**-12)``."""
    if x.dtype != torch.float32:
        raise ValueError(f"split takes float32, got {x.dtype}")
    hi = ((x.view(torch.int32) + HALF_ULP) & MASK).view(torch.float32)
    return hi, x - hi


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (f32) in the kernels' three TF32 passes."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    return truncate(a_lo) @ b_hi + a_hi @ truncate(b_lo) + a_hi @ b_hi


def probe(x: torch.Tensor) -> torch.Tensor:
    """What one TF32 tensor-core pass reads of each element of the CUDA f32
    vector ``x`` (``x[i] * 1`` through ``mma.sync``).  The probe kernel is
    ``tf32x3::probe_kernel``, exported by the M2L library (``csrc/m2l.cu``),
    so this loads ``m2l``."""
    if not x.is_cuda or x.dtype != torch.float32 or x.ndim != 1:
        raise ValueError("probe takes a 1-D float32 CUDA tensor")
    lib = _build.load("m2l")
    fn = lib.tf32_probe
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    x = x.contiguous()
    out = torch.empty_like(x)
    err = fn(x.data_ptr(), out.data_ptr(), x.numel(),
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"tf32 probe launch failed: CUDA error {err}")
    return out
