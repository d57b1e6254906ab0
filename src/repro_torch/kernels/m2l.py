"""Parity-folded multipole-to-local contraction (M2L): CUDA kernel and
plain version.

``m2l_cuda`` launches ``csrc/m2l.cu``, which replaces the TPU kernel
``_m2l_kernel`` launched by ``m2l_pallas_slab`` in
``src/repro/kernels/m2l.py``.  Both compute, on the parent-plane stack
``(PR+2, PC+2, 4p)`` built by ``expansions.m2l_slab_stack``, the 8 shifted
complex products against the ``(8, 4p, 4p)`` folded operator, one per
``PARENT_NEIGH8`` offset: exactly 27 interactions per child box.  The
relayout back to the level grid and the ``m2l_scale`` factor stay in
``expansions.m2l_folded``.

Bound on an H100: ``8 (4p)^2`` complex multiply-adds per parent (less
where the operator's structural zero blocks are skipped by the bound's
count; the kernel does the dense product), each f32 product as three TF32
tensor-core passes.  The kernel runs the complex product as one real
product on the interleaved (re, im) view, on ``mma.sync`` TF32 tensor-core
instructions with a 3xTF32 split (f32 accuracy, no single TF32 pass): a
block stages its ``(8+2, 8+2, 4p)`` halo tile once and streams the split
operator (:func:`split_operator`) through a ring of bulk async copies; the
8 offsets accumulate in registers.  See ``csrc/m2l.cu``.  The split is
cached per operator tensor (:func:`cached_split`), so each operator that
``ops.folded_operator`` caches is split once.

Every stack may carry a leading batch axis ``B``: one launch for the
whole batch, B on the kernel's ``gridDim.z``, all against one operator
(the serving engine's bucket of jobs, what ``vmap`` of the TPU kernel
computes).

Orders past ``TILE_P`` (32) outgrow the kernel's register tile and shared
memory; they launch its wide form, which splits the output columns into
slices of at most 32 n-tiles and streams K in chunks of 16 coefficients,
halo and operator alike, so its shared memory does not depend on p.  On a
grid of at most half as many tiles x slices as the card's 132 SMs (the
service's wide jobs) each tile's reduction is split across a thread-block
cluster, as large as keeps the grid within one wave of 132 blocks: its
blocks take the 8 offsets between them, each sums a partial tile, and the
cluster adds the partials in rank order through distributed shared memory,
one launch, bit for bit the same on every run
(:func:`wide_launch_config`).

``m2l_plain`` is the same function in plain PyTorch.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..core import expansions as ex
from . import _build, tf32

MAX_SMEM = 232_448  # bytes of shared memory one block may use on Hopper
TILE_P = 32         # the register-tile kernel's orders: 16 n-tiles per warp
MAX_BATCH = 65535   # stacks a launch takes: the batch is gridDim.z
THREADS = 256       # 8 warps a block, either form
SMS = _build.SMS    # the H100's streaming multiprocessors
# the wide form (csrc/m2l.cu): a stage is a 10 x 10 halo chunk of 16
# coefficients (36 floats a parent) and a 16 x 128 piece of the split
# operator; two stages at split 1, WIDE_DEEP in a cluster
WIDE_STAGE = (100 * 36 + 16 * 128 * 4) * 4
WIDE_SMEM = 2 * WIDE_STAGE                      # csrc/m2l.cu:WIDE_SMEM
WIDE_DEEP = 4
WIDE_SPLITS = (1, 2, 4, 8)                      # blocks a cluster: offsets 8 / split each


def smem_bytes(p: int) -> int:
    """Shared memory of the launch at order ``p``, as ``csrc/m2l.cu``'s
    ``m2l_smem_bytes`` gives it: the 10 x 10 halo tile (parents ``8p + 4``
    floats apart), a 3-stage ring of 4 k-steps of ``W_split`` and the ring's
    barriers up to ``TILE_P``; past it, the wide form's on a grid that
    fills the card (split 1: two stages of a halo chunk and an operator
    piece; :func:`wide_launch_config` gives a grid's)."""
    if p < 1:
        raise ValueError(f"p={p}: the M2L kernel takes p >= 1")
    if p > TILE_P:
        return WIDE_SMEM
    return 100 * (8 * p + 4) * 4 + 3 * 4 * (4 * 4 * p * 16) + 8 * 3 + 128


def wide_launch_config(PR: int, PC: int, p: int) -> tuple[int, int, int]:
    """``(slices, split, smem bytes)`` of the wide form's launch on one
    ``(PR, PC)`` parent grid at order ``p`` > ``TILE_P``, as
    ``csrc/m2l.cu:wide_config`` chooses it; the batch never enters.  The
    output columns go in slices of at most 32 n-tiles.  The 8 offsets split
    over a cluster of the most of 2, 4, 8 blocks that keeps the grid within
    ``SMS`` blocks, one wave (a split block, on ``WIDE_DEEP`` stages, holds
    its SM alone); a grid of more than ``SMS / 2`` tiles x slices runs
    split 1 (one block a tile and slice, two stages).  At split 8 the
    slices narrow, to as many as ``ceil(p / 8)`` (about 8 n-tiles each),
    while the blocks stay within ``SMS``.  Slices are as even as ``p``
    allows, none left empty."""
    if p <= TILE_P or PR < 1 or PC < 1:
        raise ValueError(f"({PR}, {PC}) parents at p={p}: the wide form takes "
                         f"p > {TILE_P} on at least one parent")
    tiles, slices = -(-PR // 8) * -(-PC // 8), -(-p // 32)
    split = max(s for s in WIDE_SPLITS if s == 1 or tiles * slices * s <= SMS)
    if split == WIDE_SPLITS[-1]:
        slices = max(slices, min(-(-p // 8), SMS // (tiles * split)))
    slices = -(-p // -(-p // slices))
    return slices, split, (2 if split == 1 else WIDE_DEEP) * WIDE_STAGE


def wide_blocks(PR: int, PC: int, p: int) -> int:
    """Blocks of the wide form's launch on one ``(PR, PC)`` grid at order
    ``p``: tiles x slices x split (:func:`wide_launch_config`)."""
    slices, split, _ = wide_launch_config(PR, PC, p)
    return -(-PR // 8) * -(-PC // 8) * slices * split


LAUNCHES = 0        # kernel launches since the last reset
WIDE_LAUNCHES = 0   # of them in the wide form (p past TILE_P)

_SPLITS = WeakIdKeyDictionary()   # operator tensor -> its split_operator form


def m2l_plain(stack: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """([B,] PR+2, PC+2, 4p) parent planes x (8, 4p, 4p) -> ([B,] PR, PC, 4p)."""
    return ex.folded_contract(stack, W)


def split_operator(W: torch.Tensor) -> torch.Tensor:
    """The kernel's form of the (8, K, K) complex64 operator: (8, K, K, 4)
    f32 holding ``[re_hi, re_lo, im_hi, im_lo]`` of each entry, the 3xTF32
    split of ``tf32.split``."""
    if W.dtype != torch.complex64 or W.ndim != 3:
        raise ValueError(f"W must be (8, K, K) complex64, got {W.dtype} "
                         f"{tuple(W.shape)}")
    hi, lo = tf32.split(torch.view_as_real(W).contiguous())
    return torch.stack([hi[..., 0], lo[..., 0], hi[..., 1], lo[..., 1]], dim=-1)


def cached_split(W: torch.Tensor) -> torch.Tensor:
    """:func:`split_operator` of ``W``, made on the first call for this
    tensor and kept while it lives.  Operators are never changed in place
    (``ops.folded_operator`` shares one tensor among all its callers)."""
    Ws = _SPLITS.get(W)
    if Ws is None:
        Ws = _SPLITS[W] = split_operator(W)
    return Ws


def _lib() -> ctypes.CDLL:
    lib = _build.load("m2l")
    if lib.m2l_launch.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.m2l_launch.argtypes = [vp, vp, vp, i, i, i, i, vp]
        lib.m2l_launch.restype = i
        lib.m2l_smem_bytes.argtypes = [i]
        lib.m2l_smem_bytes.restype = i
        ip = ctypes.POINTER(i)
        lib.m2l_wide_config.argtypes = [i, i, i, ip, ip, ip]
        lib.m2l_wide_config.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _check_wide_config(PR: int, PC: int, p: int) -> None:
    """Raise unless the kernel's wide launch on this grid is
    :func:`wide_launch_config`'s (checked once a grid shape)."""
    got = [ctypes.c_int() for _ in range(3)]
    _lib().m2l_wide_config(PR, PC, p, *map(ctypes.byref, got))
    got, want = tuple(v.value for v in got), wide_launch_config(PR, PC, p)
    if got != want or want[2] > MAX_SMEM:
        raise ValueError(f"({PR}, {PC}) parents at p={p}: the kernel launches "
                         f"(slices, split, smem) {got}, kernels/m2l.py:"
                         f"wide_launch_config {want}")


def m2l_cuda(stack: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA M2L kernel; same contract as :func:`m2l_plain`: one
    launch for a 3-D stack or a 4-D batch of them.  The kernel reads ``W``
    in its split form, :func:`cached_split`."""
    global LAUNCHES, WIDE_LAUNCHES
    if (stack.ndim not in (3, 4) or stack.shape[-3] < 3 or stack.shape[-2] < 3
            or (stack.ndim == 4 and not 1 <= stack.shape[0] <= MAX_BATCH)):
        raise ValueError(f"stack must be ([B,] PR+2, PC+2, 4p) with 1 <= B <= "
                         f"{MAX_BATCH}, got {tuple(stack.shape)}")
    for name, t in (("stack", stack), ("W", W)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.complex64:
            raise ValueError(f"{name} must be complex64, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if W.device != stack.device:
        raise ValueError(f"W on {W.device}, stack on {stack.device}")
    K = stack.shape[-1]
    if K % 4 or tuple(W.shape) != (8, K, K):
        raise ValueError(f"W must be (8, {K}, {K}) with {K} = 4p, got "
                         f"{tuple(W.shape)}")
    p = K // 4
    lib = _lib()
    smem = lib.m2l_smem_bytes(p)
    if smem != smem_bytes(p) or smem > MAX_SMEM:
        raise ValueError(f"p={p}: the kernel asks for {smem} bytes of shared "
                         f"memory, kernels/m2l.py:smem_bytes {smem_bytes(p)}")
    W_split = cached_split(W)
    lead = tuple(stack.shape[:-3])                   # () or (B,)
    PR, PC = stack.shape[-3] - 2, stack.shape[-2] - 2
    if p > TILE_P:
        _check_wide_config(PR, PC, p)
    out = torch.empty(lead + (PR, PC, K), dtype=torch.complex64, device=stack.device)
    stream = torch.cuda.current_stream(stack.device).cuda_stream
    err = lib.m2l_launch(stack.data_ptr(), W_split.data_ptr(), out.data_ptr(),
                         lead[0] if lead else 1, PR, PC, p, stream)
    if err:
        raise RuntimeError(f"m2l kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    WIDE_LAUNCHES += p > TILE_P
    return out
