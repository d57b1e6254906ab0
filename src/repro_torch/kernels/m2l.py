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

Bound on an H100: FP32 arithmetic, ``8 (4p)^2`` complex multiply-adds per
parent (less where the operator's structural zero blocks are skipped by
the bound's count; the kernel does the dense product).  The kernel stages
each block's ``(8+2, 8+2, 4p)`` halo tile and one ``W[d]`` at a time in
shared memory and keeps a 4x4 register tile of accumulators per thread,
in IEEE FP32 FMAs (no TF32).

``m2l_plain`` is the same function in plain PyTorch.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import expansions as ex
from . import _build

MAX_SMEM = 232_448  # bytes of shared memory one block may use on Hopper

LAUNCHES = 0        # kernel launches since the last reset


def m2l_plain(stack: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """(PR+2, PC+2, 4p) parent planes x (8, 4p, 4p) -> (PR, PC, 4p)."""
    return ex.folded_contract(stack, W)


def _lib() -> ctypes.CDLL:
    lib = _build.load("m2l")
    if lib.m2l_launch.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.m2l_launch.argtypes = [vp, vp, vp, i, i, i, vp]
        lib.m2l_launch.restype = i
        lib.m2l_smem_bytes.argtypes = [i]
        lib.m2l_smem_bytes.restype = i
    return lib


def m2l_cuda(stack: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA M2L kernel; same contract as :func:`m2l_plain`."""
    global LAUNCHES
    for name, t in (("stack", stack), ("W", W)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.complex64:
            raise ValueError(f"{name} must be complex64, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if W.device != stack.device:
        raise ValueError(f"W on {W.device}, stack on {stack.device}")
    if stack.ndim != 3 or stack.shape[0] < 3 or stack.shape[1] < 3:
        raise ValueError(f"stack must be (PR+2, PC+2, 4p), got "
                         f"{tuple(stack.shape)}")
    K = stack.shape[2]
    if K % 4 or tuple(W.shape) != (8, K, K):
        raise ValueError(f"W must be (8, {K}, {K}) with {K} = 4p, got "
                         f"{tuple(W.shape)}")
    p = K // 4
    lib = _lib()
    if 16 * p > 1024 or lib.m2l_smem_bytes(p) > MAX_SMEM:
        raise ValueError(f"p={p} exceeds the kernel's thread or shared-memory "
                         f"limit")
    PR, PC = stack.shape[0] - 2, stack.shape[1] - 2
    out = torch.empty((PR, PC, K), dtype=torch.complex64, device=stack.device)
    stream = torch.cuda.current_stream(stack.device).cuda_stream
    err = lib.m2l_launch(stack.data_ptr(), W.data_ptr(), out.data_ptr(),
                         PR, PC, p, stream)
    if err:
        raise RuntimeError(f"m2l kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
