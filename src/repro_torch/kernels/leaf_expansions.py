"""Leaf expansions (P2M and L2P): CUDA kernel and plain version.

``p2m_cuda`` and ``l2p_cuda`` launch ``csrc/leaf_expansions.cu``, which
replaces no TPU kernel: the reference computes P2M and L2P in jnp
(``src/repro/core/expansions.py``: ``p2m``, ``l2p_eval``), and so did the
port (``p2m_plain``, ``l2p_plain`` here), which builds every slot's powers
``zhat^0 .. zhat^(p-1)`` as a table in device memory and contracts it with
an einsum.  At the paper's size (1024 x 1024 leaf boxes of 8 slots, p =
17) that table is 1.14 GB, and the two stages took about 24 ms of an
evaluation on an H100, 100-145x their bound.

* P2M: ``ahat_k = c_k sum q zhat^k`` over a box's live slots, ``zhat = (z -
  centre) / r``; empty slots count as ``zhat = 0`` and ``q = 0`` (their
  ``z = 0`` would overflow ``zhat^(p-1)`` at depth); ``c_k`` the optional
  per-order weights (``EquationSpec.p2m_coeff``).
* L2P: at every slot of a box (the driver masks) each of ``modes``:
  ``"value"``, the LE polynomial, and ``"ngrad"``, its negated derivative
  ``-(1/r) sum l bhat_l zhat^(l-1)``; one channel, or two stacked last.

Every array may carry leading batch axes (the serving engine's buckets);
the centres ``(n, n)`` broadcast over them.

Bound on an H100: bytes, every input read once and every output written
once: P2M 285 MB at the paper's size (z, q, the mask, the coefficients),
0.085 ms at 3.35 TB/s; L2P at the sources 277 MB, 0.083 ms; at the probe
grid's 4 slots 210 MB, 0.063 ms.  The kernel keeps the powers in
registers: P2M stages a tile of consecutive boxes' slots (one contiguous
range) through shared memory, computing ``zhat`` and the masked charge on
the way in, and a thread (or a group of up to a warp, for many slots) sums
a box's orders in registers, in chunks of 32 past that; the tile's
coefficients leave as one contiguous range.  L2P stages a tile's
coefficients and gives each slot a thread, which runs Horner's rule (the
derivative's beside it) over its box's coefficients in shared memory.
:func:`p2m_launch_config` and :func:`l2p_launch_config` size the launches;
they adapt to the slots, the order and the channels they see.

``P2M_LAUNCHES`` and ``L2P_LAUNCHES`` count the kernels' launches.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

MAX_SMEM = 232_448  # bytes of shared memory one block may use on Hopper
MAX_THREADS = 1024
MAX_P = 1024        # orders the kernel takes
MAX_SLOTS = 1 << 24
P2M_THREADS = 128   # a P2M block: 128 / g boxes of g threads
P2M_STAGE = 1024    # slots a P2M tile stages at once
P2M_ORDERS = (8, 16, 24, 32)   # orders a thread keeps in registers
L2P_THREADS = 256   # an L2P block: a thread a slot
L2P_COEFFS = 4096   # coefficients an L2P tile stages at most
L2P_MODES = ("value", "ngrad")

P2M_LAUNCHES = 0    # kernel launches since the last reset
L2P_LAUNCHES = 0


# ---------------------------------------------------------------------------
# Plain versions: the CPU path and the kernels' yardstick.
# ---------------------------------------------------------------------------


def _powers(zhat: torch.Tensor, p: int) -> torch.Tensor:
    """Stack [zhat^0, ..., zhat^(p-1)] along a new last axis."""
    steps = [torch.ones_like(zhat)]
    for _ in range(p - 1):
        steps.append(steps[-1] * zhat)
    return torch.stack(steps, dim=-1)


def p2m_plain(z: torch.Tensor, q: torch.Tensor, mask: torch.Tensor,
              centers: torch.Tensor, r: float, p: int,
              coeff: np.ndarray | None = None) -> torch.Tensor:
    """Particles -> normalized MEs at the leaf level, (..., n, n, s) ->
    (..., n, n, p), through the power table (``expansions.p2m``)."""
    zhat = torch.where(mask, (z - centers[..., None]) / r, 0)   # (n, n, s)
    pw = _powers(zhat, p)                          # (n, n, s, p)
    me = torch.einsum("...s,...sk->...k", torch.where(mask, q, 0), pw)
    if coeff is not None:
        me = me * torch.as_tensor(coeff, dtype=me.dtype, device=me.device)
    return me


def l2p_plain(le: torch.Tensor, z: torch.Tensor, centers: torch.Tensor,
              r: float, p: int, modes: tuple[str, ...] = ("value",)
              ) -> torch.Tensor:
    """Leaf LEs at particle positions, per channel, through the power table
    (``expansions.l2p_eval``)."""
    zhat = (z - centers[..., None]) / r
    pw = _powers(zhat, p)                          # (n, n, s, p)
    outs = []
    for mode in modes:
        if mode == "value":
            outs.append(torch.einsum("...l,...sl->...s", le, pw))
        elif mode == "ngrad":
            lw = torch.arange(1, p, dtype=le.real.dtype, device=le.device)
            outs.append(-torch.einsum("...l,...sl->...s", le[..., 1:] * lw,
                                      pw[..., :p - 1]) / r)
        else:
            raise ValueError(f"unknown l2p mode {mode!r}")
    return outs[0] if len(outs) == 1 else torch.stack(outs, dim=-1)


# ---------------------------------------------------------------------------
# Launch configurations (csrc/leaf_expansions.cu computes the same).
# ---------------------------------------------------------------------------


def _check_sizes(s: int, p: int) -> None:
    if not 1 <= s <= MAX_SLOTS:
        raise ValueError(f"s={s} slots: the leaf kernels take 1 to {MAX_SLOTS}")
    if not 1 <= p <= MAX_P:
        raise ValueError(f"p={p}: the leaf kernels take orders 1 to {MAX_P}")


@functools.lru_cache(maxsize=None)
def p2m_launch_config(s: int, p: int) -> tuple[int, int, int, int, int, int]:
    """``(orders, group, boxes, stage, threads, smem bytes)`` of the P2M
    launch for ``s`` slots at order ``p``: the orders a thread keeps in
    registers (the least of ``P2M_ORDERS`` that holds ``p``, the last one in
    chunks past it), the threads a box (1 up to 8 slots, then as many as
    give each at most 8 slots, at most a warp), the boxes a tile
    (``P2M_THREADS / group``), the slots a box stages at once (``s`` up to
    ``P2M_STAGE`` a tile), and the shared memory: the stage's ``zhat`` and
    charges, or the tile's coefficients, whichever is larger, box rows an
    odd number of elements apart, and the tile's centres."""
    _check_sizes(s, p)
    k = next((o for o in P2M_ORDERS if p <= o), P2M_ORDERS[-1])
    g = 1
    while g < 32 and g * 8 < s:
        g *= 2
    nbox = P2M_THREADS // g
    sc = min(s, P2M_STAGE // nbox)
    smem = (max(2 * nbox * (sc | 1), nbox * (k | 1)) + nbox) * 8
    return k, g, nbox, sc, P2M_THREADS, smem


@functools.lru_cache(maxsize=None)
def l2p_launch_config(s: int, p: int) -> tuple[int, int, int]:
    """``(boxes, threads, smem bytes)`` of the L2P launch for ``s`` slots at
    order ``p``: a tile of ``L2P_THREADS / s`` boxes (at least one), at most
    ``L2P_COEFFS`` coefficients, staged with box rows an odd number of
    coefficients apart."""
    _check_sizes(s, p)
    nbox = max(1, min(L2P_THREADS // s, L2P_COEFFS // (p | 1)))
    return nbox, L2P_THREADS, nbox * (p | 1) * 8


# ---------------------------------------------------------------------------
# The kernels.
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = _build.load("leaf_expansions")
    if lib.leaf_p2m_launch.argtypes is None:
        vp, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.leaf_p2m_launch.argtypes = [vp, vp, vp, vp, vp, vp, ll, i, i, i, f, i, vp]
        lib.leaf_p2m_launch.restype = i
        lib.leaf_l2p_launch.argtypes = [vp, vp, vp, vp, ll, i, i, i, f, i, i, i, vp]
        lib.leaf_l2p_launch.restype = i
        ip = ctypes.POINTER(i)
        lib.leaf_p2m_config.argtypes = [i, i, ip, ip, ip, ip, ip]
        lib.leaf_p2m_config.restype = None
        lib.leaf_l2p_config.argtypes = [i, i, ip, ip]
        lib.leaf_l2p_config.restype = None
    return lib


@functools.lru_cache(maxsize=None)
def check_launch_config(s: int, p: int) -> None:
    """Raise unless the kernel's launches for ``s`` slots at order ``p`` are
    :func:`p2m_launch_config`'s and :func:`l2p_launch_config`'s, within one
    Hopper block (checked once a shape)."""
    lib = _lib()
    got = [ctypes.c_int() for _ in range(5)]
    lib.leaf_p2m_config(s, p, *map(ctypes.byref, got))
    k, g, nbox, sc, threads, smem = p2m_launch_config(s, p)
    if tuple(v.value for v in got) != (k, g, nbox, sc, smem) or smem > MAX_SMEM:
        raise ValueError(f"s={s}, p={p}: the P2M kernel launches "
                         f"{tuple(v.value for v in got)}, kernels/leaf_expansions.py:"
                         f"p2m_launch_config {(k, g, nbox, sc, smem)}")
    got = [ctypes.c_int() for _ in range(2)]
    lib.leaf_l2p_config(s, p, *map(ctypes.byref, got))
    nbox, threads, smem = l2p_launch_config(s, p)
    if tuple(v.value for v in got) != (nbox, smem) or smem > MAX_SMEM:
        raise ValueError(f"s={s}, p={p}: the L2P kernel launches "
                         f"{tuple(v.value for v in got)}, kernels/leaf_expansions.py:"
                         f"l2p_launch_config {(nbox, smem)}")


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"{name} {tuple(t.shape)} on {t.device} does not "
                         f"match {tuple(shape)} on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _centers(centers: torch.Tensor, grid: tuple, device) -> torch.Tensor:
    """The (n, n) centres as the kernel reads them: a slice (the sharded
    driver's tile of the padded centres) is copied contiguous."""
    cen = centers.contiguous()
    _check("centers", cen, torch.complex64, grid, device)
    return cen


@functools.lru_cache(maxsize=None)
def _device_coeff(raw: bytes, device: torch.device) -> torch.Tensor:
    """A (p,) complex128 weight vector's bytes as complex64 on ``device``,
    copied once (a copy from host memory waits for the card's queue)."""
    c = np.frombuffer(raw, dtype=np.complex128).copy()
    return torch.as_tensor(c, dtype=torch.complex64, device=device)


def _grid_of(t: torch.Tensor, name: str) -> tuple:
    if t.ndim < 3 or t.shape[-3] < 1 or t.shape[-2] < 1 or t.shape[-1] < 1:
        raise ValueError(f"{name} must be (..., n, n, s) with n, s >= 1, got "
                         f"{tuple(t.shape)}")
    if t.numel() == 0:
        raise ValueError(f"{name} {tuple(t.shape)} is empty")
    return tuple(t.shape[-3:-1])


def p2m_cuda(z: torch.Tensor, q: torch.Tensor, mask: torch.Tensor,
             centers: torch.Tensor, r: float, p: int,
             coeff: np.ndarray | None = None) -> torch.Tensor:
    """Launch the CUDA P2M kernel; same contract as :func:`p2m_plain`: one
    launch whatever the leading axes."""
    global P2M_LAUNCHES
    grid = _grid_of(z, "z")
    for name, t, dtype in (("z", z, torch.complex64), ("q", q, torch.complex64),
                           ("mask", mask, torch.bool)):
        _check(name, t, dtype, z.shape, z.device)
    s = z.shape[-1]
    _check_sizes(s, p)
    cen = _centers(centers, grid, z.device)
    c = None
    if coeff is not None:
        coeff = np.asarray(coeff, dtype=np.complex128)
        if coeff.shape != (p,):
            raise ValueError(f"coeff must be ({p},), got {coeff.shape}")
        c = _device_coeff(coeff.tobytes(), z.device)
    check_launch_config(s, p)
    smem = p2m_launch_config(s, p)[5]
    out = torch.empty(tuple(z.shape[:-1]) + (p,), dtype=torch.complex64,
                      device=z.device)
    nn = grid[0] * grid[1]
    stream = torch.cuda.current_stream(z.device).cuda_stream
    err = _lib().leaf_p2m_launch(z.data_ptr(), q.data_ptr(), mask.data_ptr(),
                                 cen.data_ptr(), None if c is None else c.data_ptr(),
                                 out.data_ptr(), z.numel() // s, nn, s, p, float(r),
                                 smem, stream)
    if err:
        raise RuntimeError(f"p2m kernel launch failed: CUDA error {err}")
    P2M_LAUNCHES += 1
    return out


def l2p_cuda(le: torch.Tensor, z: torch.Tensor, centers: torch.Tensor,
             r: float, p: int, modes: tuple[str, ...] = ("value",)
             ) -> torch.Tensor:
    """Launch the CUDA L2P kernel; same contract as :func:`l2p_plain`: one
    launch whatever the leading axes and channels."""
    global L2P_LAUNCHES
    for mode in modes:
        if mode not in L2P_MODES:
            raise ValueError(f"unknown l2p mode {mode!r}")
    if not 1 <= len(modes) <= 2:
        raise ValueError(f"modes {modes}: the L2P kernel emits 1 or 2 channels")
    grid = _grid_of(z, "z")
    _check("z", z, torch.complex64, z.shape, z.device)
    _check("le", le, torch.complex64, tuple(z.shape[:-1]) + (p,), z.device)
    s = z.shape[-1]
    _check_sizes(s, p)
    cen = _centers(centers, grid, z.device)
    check_launch_config(s, p)
    smem = l2p_launch_config(s, p)[2]
    nout = len(modes)
    codes = sum(1 << c for c, mode in enumerate(modes) if mode == "ngrad")
    out = torch.empty(tuple(z.shape) + ((nout,) if nout > 1 else ()),
                      dtype=torch.complex64, device=z.device)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    err = _lib().leaf_l2p_launch(le.data_ptr(), z.data_ptr(), cen.data_ptr(),
                                 out.data_ptr(), z.numel() // s, grid[0] * grid[1], s,
                                 p, float(r), nout, codes, smem, stream)
    if err:
        raise RuntimeError(f"l2p kernel launch failed: CUDA error {err}")
    L2P_LAUNCHES += 1
    return out
