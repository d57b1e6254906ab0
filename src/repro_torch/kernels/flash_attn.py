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
- ``"simt"``: ``flash_attention_cuda`` launches ``csrc/flash_attn.cu`` for
  every other CUDA case: the other head dims up to 256, in bf16 or f32,
  strided inputs included.  The name is the route's; its arithmetic runs
  on the tensor cores through warp-level ``mma.sync`` (bf16 products, or
  f32 ones as three TF32 passes), and on a grid short of the card it splits
  each q tile's key range across a thread-block cluster
  (:func:`simt_launch_config`);
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
the FP32 SIMT peak).  At Phi-3-mini's attention (4, 32, 32, 2048, 96),
causal, the simt route's: 103.1 GFLOP, 0.104 ms in bf16 and 0.625 ms in
f32.
Design: see the notes in the CUDA sources.

``flash_attention_plain`` is the same function in plain PyTorch; the CPU
path and the kernels' checks use it.  ``flash_attention_split_plain`` and
``merge_partials_plain`` are the plain version of the cluster split (the
key range cut into parts, their partial results merged in rank order);
the CPU tests use them, the card's path never calls them.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 256

TC_HEAD_DIMS = (64, 128, 256)   # head dims of the bf16 tensor-core kernel
TF32_HEAD_DIMS = (64, 128, 256)  # head dims of the 3xTF32 tensor-core kernel
MAX_SMEM = 232_448              # bytes of shared memory one block may use on Hopper
SIMT_SPLITS = range(1, 9)       # blocks a cluster: 8 is the portable maximum
SMS = _build.SMS                # the H100's streaming multiprocessors

LAUNCHES = 0        # SIMT kernel launches since the last reset
TC_LAUNCHES = 0     # bf16 tensor-core kernel launches since the last reset
TF32_LAUNCHES = 0   # 3xTF32 tensor-core kernel launches since the last reset


def takes_head_dim(d: int) -> bool:
    """Whether a flash kernel computes head dim ``d``: the simt route takes
    any multiple of 8 up to ``MAX_HEAD_DIM`` (16-byte rows of bf16), the
    tensor-core routes a subset."""
    return d % 8 == 0 and 8 <= d <= MAX_HEAD_DIM


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


def simt_head_dim_class(d: int) -> int:
    """``csrc/flash_attn.cu:dclass``: the head dims an instance of the simt
    kernel computes, d rounded up to 32 (at least 32); Q's and K's columns
    past d are zero in shared memory."""
    return max(32, -(-d // 32) * 32)


def _simt_smem(d: int, bf16: bool, rows: int, bk: int, stages: int) -> int:
    """``csrc/flash_attn.cu:smem_bytes``: Q and a ring of ``stages`` K and V
    tiles, Q's and K's rows the head-dim class plus 8 elements apart, V's
    the same in bf16 and the class plus 4 floats in f32."""
    D = simt_head_dim_class(d)
    return (2 if bf16 else 4) * (rows * (D + 8) + stages * bk * (2 * D + (16 if bf16 else 12)))


def simt_launch_config(d: int, dtype: torch.dtype,
                       grid: tuple[int, int, int, int, bool]
                       ) -> tuple[int, int, int, int, int, int]:
    """``(query rows per block, keys per tile, stages, threads, shared-memory
    bytes, split)`` of the simt route's launch at head dim ``d`` on ``grid
    = (B, H, T, S, causal)``, as ``csrc/flash_attn.cu:config`` chooses it
    (the launch refuses any other tuple).  A block owns 64 query rows on 4
    warps of 16, key tiles of 64 in bf16 and 32 in f32, on 2 stages; where
    ``T > 64``, 128 rows: on 4 warps of 32 in bf16 up to the 128 head-dim
    class (each K and V fragment a warp loads feeds two 16-row products),
    else on 8 warps of 16 where a 64-row block would hold its SM alone
    (more than half of ``MAX_SMEM``) and 128 rows fit, f32's tiles cut to
    16 keys where 32 do not (the 224 and 256 classes).  A grid of ``B * H *
    ceil(T / rows)`` blocks short of the card splits each q tile's key range
    over a cluster of the most of 2..8 blocks that keeps the grid within one
    wave of ``SMS`` blocks, and never more than the key tiles of the
    heaviest q tile; a grid of at least ``SMS / 2`` blocks runs split 1."""
    if not takes_head_dim(d):
        raise ValueError(f"head dim {d} must be a multiple of 8 in "
                         f"[8, {MAX_HEAD_DIM}]")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the simt route takes float32 or bfloat16, not {dtype}")
    B, H, T, S, causal = grid
    bf16 = dtype == torch.bfloat16
    rows, bk, stages, threads = 64, (64 if bf16 else 32), 2, 128
    if T > 64 and bf16 and simt_head_dim_class(d) <= 128:
        rows = 128
    elif T > 64 and _simt_smem(d, bf16, 64, bk, stages) > MAX_SMEM // 2:
        tile = bk if bf16 or _simt_smem(d, bf16, 128, bk, stages) <= MAX_SMEM else 16
        if _simt_smem(d, bf16, 128, tile, stages) <= MAX_SMEM:
            rows, bk, threads = 128, tile, 256
    blocks = B * H * -(-T // rows)
    tiles = -(-(min(T, S) if causal else S) // bk)
    split = max(s for s in SIMT_SPLITS if s == 1 or (blocks * s <= SMS and s <= tiles))
    return rows, bk, stages, threads, _simt_smem(d, bf16, rows, bk, stages), split


def simt_kernel_config(d: int, dtype: torch.dtype,
                       grid: tuple[int, int, int, int, bool]
                       ) -> tuple[int, int, int, int, int, int]:
    """The launch that ``csrc/flash_attn.cu:config`` itself chooses (the
    library is built on first use): :func:`simt_launch_config` must give the
    same tuple, which the launch checks."""
    B, H, T, S, causal = grid
    out = (ctypes.c_int * 6)()
    err = _lib().flash_attn_config(d, int(dtype == torch.bfloat16), B, H, T, S,
                                   int(causal), out)
    if err:
        raise ValueError(f"the simt kernel takes no launch at d={d}, {grid}")
    return tuple(out)


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
                          causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q (B, H, T, d), k/v (B, Hkv, S, d) -> (B, H, T, d) in q's dtype.

    f32 math, top-left causal mask (``kpos > qpos`` hidden, ``qpos`` from
    ``q_offset``: the rows of a query chunk), masked scores contributing
    exactly 0 and the TPU kernel's ``l > 0`` guard.
    """
    _check_shapes(q, k, v)
    B, H, T, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    g = H // Hkv
    qf = q.to(torch.float32).reshape(B, Hkv, g, T, d)
    s = torch.einsum("bkgtd,bksd->bkgts", qf, k.to(torch.float32)) * (1.0 / d ** 0.5)
    if causal:
        hidden = (torch.arange(S, device=q.device)[None, :]
                  > q_offset + torch.arange(T, device=q.device)[:, None])
        s = s.masked_fill(hidden, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    if causal:
        p = p.masked_fill(hidden, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgts,bksd->bkgtd", p, v.to(torch.float32))
    o = o / torch.where(l > 0, l, torch.ones_like(l))
    return o.reshape(B, H, T, d).to(q.dtype)


def merge_partials_plain(parts) -> torch.Tensor:
    """Merge per-part attention partials ``(m, l, o)`` in the given (rank)
    order, as the simt kernel's cluster does: ``m`` and ``l`` (..., T) each
    row's max score and sum of probabilities over the part's keys (``m`` =
    ``NEG_INF``, ``l`` = 0 where the part shows a row no key), ``o`` (...,
    T, d) the unnormalized sum of probabilities times values.  Returns f32
    ``sum_k w_k o_k / sum_k w_k l_k`` with ``w_k = exp(m_k - max_k m_k)`` and
    the ``l > 0`` guard."""
    M = parts[0][0]
    for m, _, _ in parts[1:]:
        M = torch.maximum(M, m)
    L, acc = torch.zeros_like(M), torch.zeros_like(parts[0][2])
    for m, l, o in parts:
        w = torch.exp(m - M)
        L = L + w * l
        acc = acc + w[..., None] * o
    return acc / torch.where(L > 0, L, torch.ones_like(L))[..., None]


def flash_attention_split_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                causal: bool = True, split: int = 1) -> torch.Tensor:
    """:func:`flash_attention_plain` with the key range cut into ``split``
    parts (part r holds keys ``r S // split`` up to ``(r + 1) S // split``),
    each part's partial computed alone and the partials merged in rank order
    by :func:`merge_partials_plain`: the arithmetic of the simt kernel's
    cluster split, in plain PyTorch."""
    _check_shapes(q, k, v)
    B, H, T, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if not 1 <= split <= S:
        raise ValueError(f"split {split} must be in [1, S = {S}]")
    g = H // Hkv
    qf = q.to(torch.float32).reshape(B, Hkv, g, T, d)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    qpos = torch.arange(T, device=q.device)[:, None]
    parts = []
    for r in range(split):
        lo, hi = r * S // split, (r + 1) * S // split
        s = torch.einsum("bkgtd,bksd->bkgts", qf, kf[:, :, lo:hi]) * (1.0 / d ** 0.5)
        hidden = (torch.arange(lo, hi, device=q.device)[None, :] > qpos if causal
                  else torch.zeros(T, hi - lo, dtype=torch.bool, device=q.device))
        s = s.masked_fill(hidden, NEG_INF)
        m = s.amax(dim=-1) if hi > lo else torch.full(s.shape[:-1], NEG_INF,
                                                      device=q.device)
        p = torch.exp(s - m[..., None]).masked_fill(hidden, 0.0)
        parts.append((m, p.sum(dim=-1), torch.einsum("bkgts,bksd->bkgtd", p,
                                                     vf[:, :, lo:hi])))
    return merge_partials_plain(parts).reshape(B, H, T, d).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attn")
    fn = lib.flash_attn_launch
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, ctypes.c_float, vp]
        fn.restype = i
        lib.flash_attn_config.argtypes = [i, i, i, i, i, i, i, ctypes.POINTER(i)]
        lib.flash_attn_config.restype = i
    return lib


def _check_strided(name: str, t: torch.Tensor, q: torch.Tensor) -> list[int]:
    """Raise unless the flash kernels read ``t`` as it lies (a unit stride in
    d, the other strides by :func:`_tma_strides`' rule, a 16-byte start, a
    CUDA tensor on q's device); its (batch, head, seq) strides in
    elements."""
    if t.stride(3) != 1:
        raise ValueError(f"{name} must have unit stride in d, has strides {t.stride()}")
    strides = _tma_strides(name, t)
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.device != q.device:
        raise ValueError(f"{name} on {t.device}, q on {q.device}")
    return strides


@functools.lru_cache(maxsize=1024)
def _simt_plan(layouts: tuple, causal: bool) -> tuple:
    """The simt launch of q, k, v with these layouts (shape, stride, dtype of
    each in turn), checked once a layout: the output's size and strides
    (``(B, T, H, d)`` memory seen as ``(B, H, T, d)``) and the kernel's
    argument block (shapes, strides, :func:`simt_launch_config`, causal,
    dtype)."""
    q, k, v = (torch.empty_strided(*layouts[i:i + 2], dtype=layouts[i + 2], device="meta")
               for i in (0, 3, 6))
    _check_shapes(q, k, v)
    B, H, T, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if not takes_head_dim(d):
        raise ValueError(f"head dim {d} must be a multiple of 8 in "
                         f"[8, {MAX_HEAD_DIM}]")
    if T == 0 or S == 0:
        raise ValueError(f"empty sequence: T={T}, S={S}")
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in (torch.float32, torch.bfloat16) or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}; q, k and v must all be "
                             f"float32 or all bfloat16")
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have unit stride in d, has strides "
                             f"{t.stride()}")
        strides += _tma_strides(name, t)
    out = torch.empty((B, T, H, d), dtype=q.dtype, device="meta").transpose(1, 2)
    cfg = simt_launch_config(d, q.dtype, (B, H, T, S, causal))
    args = (ctypes.c_int64 * 26)(B, H, Hkv, T, S, d, *strides, *_tma_strides("out", out),
                                 *cfg, int(causal), int(q.dtype == torch.bfloat16))
    return tuple(out.shape), out.stride(), args, 1.0 / d ** 0.5


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Launch the simt route's flash-attention kernel (``csrc/flash_attn.cu``,
    on the tensor cores: bf16 products, or f32 ones as three TF32 passes);
    same contract as :func:`flash_attention_plain` for bf16 or f32 at any
    head dim that is a multiple of 8 up to 256.

    q, k and v may be strided views (a unit stride in d, every other stride
    a multiple of 16 bytes); the output lies in ``(B, T, H, d)`` memory and
    is returned as its ``(B, H, T, d)`` view, as :func:`flash_attention_tc`'s.
    The launch is :func:`simt_launch_config`'s; one launch, counted in
    ``LAUNCHES``.  Shapes, strides and dtypes are checked once a layout
    (:func:`_simt_plan`), the tensors' device and alignment every call.
    """
    global LAUNCHES
    size, stride, args, scale = _simt_plan(
        (q.shape, q.stride(), q.dtype, k.shape, k.stride(), k.dtype, v.shape,
         v.stride(), v.dtype), bool(causal))
    dev = q.get_device()
    ptrs = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        ptr = t.data_ptr()
        if ptr % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
        if t.get_device() != dev or dev < 0:
            raise ValueError(f"{name} must be a CUDA tensor on q's device, got "
                             f"{t.device} (q on {q.device})")
        ptrs.append(ptr)
    out = torch.empty_strided(size, stride, dtype=q.dtype, device=q.device)
    err = _lib().flash_attn_launch(*ptrs, out.data_ptr(), args, scale,
                                   torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {err} "
                           f"(launch {tuple(args)[18:24]})")
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
            raise ValueError(f"{name} has strides {t.stride()}: the flash "
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
        strides += _check_strided(tname, t, q)
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
