"""Blockwise online-softmax (flash) attention: three CUDA kernels and the
plain version.

The kernels replace the TPU kernel ``_fa_kernel`` launched by
``flash_attention`` in ``src/repro/kernels/flash_attn.py``.  All compute,
for q ``(B, H, T, d)`` and k, v ``(B, Hkv, S, d)`` with ``H % Hkv == 0``,
softmax attention with f32 sums and GQA by index arithmetic (query head
``h`` reads key/value head ``h // (H // Hkv)``), and write the output in
q's dtype.  :func:`route` picks one by device, dtype and head dim alone:

- ``"tc"``: ``flash_attention_tc`` launches ``csrc/flash_attn_tc.cu`` on
  Hopper's tensor cores (bf16 ``wgmma``, TMA-fed K/V) for bf16 with
  d 64, 128 or 256, strided inputs included;
- ``"tf32"``: ``flash_attention_tf32`` launches
  ``csrc/flash_attn_tf32.cu`` on the TF32 tensor cores with a 3xTF32
  split (f32 accuracy; no single TF32 pass) for f32 with d 64, 128 or
  256, strided inputs included;
- ``"simt"``: ``flash_attention_cuda`` launches ``csrc/flash_attn.cu``
  (FP32 SIMT FMAs) for every other CUDA case: the other head dims up to
  256, in bf16 or f32;
- ``"plain"``: ``flash_attention_plain`` for a CPU tensor.

The causal mask is the TPU kernel's **top-left** one: key ``kpos`` is hidden
from query ``qpos`` when ``kpos > qpos``.  For ``T == S`` that is the
model's causal mask.  For ``T != S`` it is not the bottom-right mask of
``ref.attention_ref`` (``tril(k=S-T)``); the model routes only ``T == S``
here (``models.layers.attention_core``).

Bound on an H100 at Yi-6B's prefill shape (4, 32, 4, 2048, 128), causal:
operations, 137.5 GFLOP against 151 MB of traffic in bf16 (302 MB in f32):
0.139 ms on the bf16 tensor cores, 0.833 ms for the three TF32 passes of
an f32 product at 495 TFLOP/s (2.05 ms at the 67 TFLOP/s FP32 SIMT peak).
At recurrentgemma-2b's attention (4, 10, 1, 2048, 256), causal: 85.9
GFLOP, 0.0869 ms in bf16; in f32 0.521 ms for the three TF32 passes
against 185 MB of traffic (0.055 ms), so operations bound it (1.283 ms at
the FP32 SIMT peak).
Design: see the notes in the CUDA sources.

``flash_attention_plain`` is the same function in plain PyTorch; the CPU
path and the kernels' checks use it.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 256

TC_HEAD_DIMS = (64, 128, 256)   # head dims of the bf16 tensor-core kernel
TF32_HEAD_DIMS = (64, 128, 256)  # head dims of the 3xTF32 tensor-core kernel
MAX_SMEM = 232_448              # bytes of shared memory one block may use on Hopper

LAUNCHES = 0        # SIMT kernel launches since the last reset
TC_LAUNCHES = 0     # bf16 tensor-core kernel launches since the last reset
TF32_LAUNCHES = 0   # 3xTF32 tensor-core kernel launches since the last reset


def route(q: torch.Tensor, k: torch.Tensor) -> str:
    """``"plain"`` for a CPU tensor; for CUDA q and k, ``"tc"`` if both are
    bf16 with d in ``TC_HEAD_DIMS``, ``"tf32"`` if both are f32 with d in
    ``TF32_HEAD_DIMS``; ``"simt"`` for every other CUDA case."""
    if q.device.type == "cpu":
        return "plain"
    d = q.shape[-1]
    if q.dtype == k.dtype == torch.bfloat16 and d in TC_HEAD_DIMS:
        return "tc"
    if q.dtype == k.dtype == torch.float32 and d in TF32_HEAD_DIMS:
        return "tf32"
    return "simt"


def tc_launch_config(d: int) -> tuple[int, int, int]:
    """``(keys per tile, threads, shared-memory bytes)`` of the bf16
    tensor-core kernel at head dim ``d``, as ``csrc/flash_attn_tc.cu``'s
    ``Smem<d>`` lays it out (the launch refuses any other pair): a 128-row
    Q tile and two stages of K and V tiles in bf16, 128 keys a tile (64 at
    d = 256, where 128 would need 320 KB), 64 bytes of barriers and 1 KB
    of alignment slack; two warpgroups."""
    if d not in TC_HEAD_DIMS:
        raise ValueError(f"head dim {d}: the tensor-core kernel takes d in "
                         f"{TC_HEAD_DIMS}")
    bk = 64 if d == 256 else 128
    return bk, 256, 128 * d * 2 + 2 * (2 * bk * d * 2) + 64 + 1024


def tf32_launch_config(d: int) -> tuple[int, int, int, int]:
    """``(query rows per block, keys per tile, threads, shared-memory
    bytes)`` of the 3xTF32 kernel at head dim ``d``, as
    ``csrc/flash_attn_tf32.cu``'s ``Smem<d>`` lays it out (the launch
    refuses any other triple), all f32, two warpgroups, 32-key tiles, 64
    bytes of barriers and 1 KB of alignment slack.  At d 64 and 128 a
    block owns 128 rows, 64 a warpgroup: Q's hi and lo, a 2-stage ring of
    raw K tiles, K's lo and V^T's hi and lo.  At d = 256, where Q alone
    would be 256 KB, it owns 64 rows and the warpgroups split O's columns:
    Q's hi and lo, one raw tile that TMA lands K and then V in, and a
    K-tile-sized region per warpgroup that holds in turn its half of K's
    hi and lo, its partial S and its V^T's hi and lo."""
    if d not in TF32_HEAD_DIMS:
        raise ValueError(f"head dim {d}: the 3xTF32 kernel takes d in "
                         f"{TF32_HEAD_DIMS}")
    bq, k_tiles = (64, 3) if d == 256 else (128, 5)
    return bq, 32, 256, 2 * bq * d * 4 + k_tiles * 32 * d * 4 + 64 + 1024


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


def _tma_lib(name: str, n_config: int) -> ctypes.CDLL:
    lib = _build.load(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, *[i64] * 12,
                       *[i] * n_config, ctypes.c_float, i, vp]
        fn.restype = i
    return lib


def _tma_strides(name: str, t: torch.Tensor) -> list[int]:
    """(batch, head, seq) strides in elements for a kernel's tensor maps:
    each a multiple of 16 bytes; a dimension of size 1 takes the stride it
    would have in a contiguous tensor."""
    per16 = 16 // t.element_size()
    strides = []
    for dim in range(3):
        st = t.stride(dim) if t.shape[dim] > 1 else math.prod(t.shape[dim + 1:])
        if st % per16:
            raise ValueError(f"{name} has strides {t.stride()}: the tensor-core "
                             f"kernels need every stride but d's a multiple "
                             f"of {per16} elements (16 bytes)")
        strides.append(st)
    return strides


def _launch_tma(kind: str, name: str, dtype: torch.dtype, head_dims, q, k, v,
                causal: bool, extra: tuple[int, ...] = ()) -> torch.Tensor:
    """Check q, k, v for a TMA-fed tensor-core kernel, launch
    ``csrc/<name>.cu`` with the launch arguments ``extra`` before the scale
    and return its output, a ``(B, H, T, d)`` view of ``(B, T, H, d)``
    memory."""
    _check_shapes(q, k, v)
    B, H, T, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if d not in head_dims:
        raise ValueError(f"head dim {d}: the {kind} kernel takes d in "
                         f"{head_dims}")
    if T == 0 or S == 0:
        raise ValueError(f"empty sequence: T={T}, S={S}")
    strides = []
    for tname, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != dtype:
            raise ValueError(f"{tname} is {t.dtype}; the {kind} kernel takes "
                             f"{str(dtype).removeprefix('torch.')}")
        if t.stride(3) != 1:
            raise ValueError(f"{tname} must have unit stride in d, has "
                             f"strides {t.stride()}")
        strides += _tma_strides(tname, t)
        if t.data_ptr() % 16:
            raise ValueError(f"{tname} must start on a 16-byte boundary")
        if not t.is_cuda:
            raise ValueError(f"{tname} must be a CUDA tensor, got {t.device}")
        if t.device != q.device:
            raise ValueError(f"{tname} on {t.device}, q on {q.device}")
    out = torch.empty((B, T, H, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = getattr(_tma_lib(name, len(extra)), f"{name}_launch")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Hkv, T,
        S, d, *strides, *_tma_strides("out", out), *extra, 1.0 / d ** 0.5,
        int(causal), stream)
    if err:
        raise RuntimeError(f"{kind} flash attention launch failed: "
                           f"{'CUresult' if err < 0 else 'CUDA error'} {abs(err)}")
    return out


def flash_attention_tc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool = True) -> torch.Tensor:
    """Launch the bf16 tensor-core flash-attention kernel; same contract as
    :func:`flash_attention_plain` for bf16 with d 64, 128 or 256.

    q, k and v may be strided views (a unit stride in d, every other stride
    a multiple of 8 elements).  The output lies in ``(B, T, H, d)`` memory
    and is returned as its ``(B, H, T, d)`` view, so a caller's
    ``out.transpose(1, 2).reshape(B, T, H * d)`` is free.
    """
    global TC_LAUNCHES
    bk, _, smem = tc_launch_config(q.shape[-1])
    out = _launch_tma("tensor-core", "flash_attn_tc", torch.bfloat16, TC_HEAD_DIMS,
                      q, k, v, causal, extra=(bk, smem))
    TC_LAUNCHES += 1
    return out


def flash_attention_tf32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Launch the 3xTF32 tensor-core flash-attention kernel; same contract
    as :func:`flash_attention_plain` for f32 with d 64, 128 or 256, held to
    f32 accuracy (three TF32 passes per product, no single pass).

    q, k and v may be strided views (a unit stride in d, every other stride
    a multiple of 4 elements); the output is laid out as
    :func:`flash_attention_tc`'s.
    """
    global TF32_LAUNCHES
    bq, bk, _, smem = tf32_launch_config(q.shape[-1])
    out = _launch_tma("3xTF32", "flash_attn_tf32", torch.float32, TF32_HEAD_DIMS,
                      q, k, v, causal, extra=(bq, bk, smem))
    TF32_LAUNCHES += 1
    return out
