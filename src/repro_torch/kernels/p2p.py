"""Near-field direct interactions (P2P): CUDA kernel and plain version.

``p2p_cuda`` launches ``csrc/p2p.cu``, which replaces the TPU kernel
``_p2p_kernel`` launched by ``p2p_pallas_slab`` in
``src/repro/kernels/p2p.py``.  Both compute, over a leaf grid with ±1
ghost rows/cols attached, a pair sum over the 3x3 ``P2P_OFFSETS`` stencil
with the Gaussian mollifier (or singular for ``sigma=None``), masking
empty sources and coincident pairs, in one of two formulas (``mode``):

* ``"base"``: the vortex kernel's velocity, one complex channel;
* ``"laplace"``: ``LaplaceEquation.p2p_terms``, two channels, the
  potential ``q * log|dz|`` and the field ``-q/dz``.

Targets are the sources themselves, or a separate ``(rows, cols, st)``
block of passive targets ``z_tgt`` with its ``mask_tgt`` (no halo; ``st``
may differ from ``s``).  Masked targets get 0.

Bound on an H100: bytes — the mask read whole, the z and q of live slots
read once and the output written whole (about 88 MB at the paper's size,
level 10 with 8 slots, of which the output is 67 MB; Laplace's two
channels double the output); the arithmetic, about 18 FP32 operations per
live pair, is far smaller because only 9% of the slots are live.  The
kernel works on live slots only: a block packs its halo tile's live
sources into shared memory (a scan of the mask), gives one thread to each
live target, and writes its whole output tile, zeros in the dead slots, in
one coalesced pass.  :func:`launch_config` sizes the tile for the slot
counts and channels.

``p2p_plain`` is the same function in plain PyTorch, with the formula of
the spec's ``p2p_terms``; the CPU path and the kernel's checks use it.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.equations import LAPLACE, VORTEX
from ..core.quadtree import P2P_OFFSETS
from . import _build

MAX_SMEM = 232_448  # bytes of shared memory one block may use on Hopper
MAX_THREADS = 1024
MAX_SLOTS = 136     # as the PR 11 kernel's 8 x 8 tile allowed
# target-box tiles (TY, TX), largest first, each the choice for some s up to
# MAX_SLOTS: 16 x 16 stages 1.27x its boxes
TILES = ((16, 16), (8, 16), (8, 8), (4, 8), (4, 4), (2, 4), (2, 2))
SMEM_TARGET = 72 * 1024   # three blocks an SM

# each mode's formula: the spec whose ``p2p_terms`` it is
MODES = {"base": VORTEX, "laplace": LAPLACE}

LAUNCHES = 0        # kernel launches since the last reset
# the same launches by formula and targets: "base", "laplace",
# "base_passive", "laplace_passive"
LAUNCHES_BY_MODE = dict.fromkeys(
    ("base", "laplace", "base_passive", "laplace_passive"), 0)


def smem_bytes(ty: int, tx: int, s: int, st: int | None = None,
               nout: int = 1) -> int:
    """Shared memory of a ``ty x tx``-box tile with ``s`` source slots,
    ``st`` target slots (default ``s``) and ``nout`` channels, as
    ``csrc/p2p.cu:smem_bytes`` lays it out: 16-byte records and 4-byte
    tags for every slot of the halo tile, the 8-byte output tile, the
    boxes' starts and 32 warp sums."""
    st = s if st is None else st
    nb = (ty + 2) * (tx + 2)
    return (nb * s * 16 + ty * tx * st * nout * 8 + nb * s * 4
            + (nb + 1) * 4 + 32 * 4)


def launch_config(s: int, st: int | None = None,
                  nout: int = 1) -> tuple[int, int, int, int]:
    """``(TY, TX, threads, smem bytes)`` of the kernel's launch for ``s``
    source slots, ``st`` target slots (default ``s``) and ``nout``
    channels: the largest tile of ``TILES`` within ``SMEM_TARGET`` (else
    the largest within ``MAX_SMEM``), one thread per halo box."""
    st = s if st is None else st
    for name, n in (("s", s), ("st", st)):
        if not 1 <= n <= MAX_SLOTS:
            raise ValueError(f"{name}={n} slots: the P2P kernel takes 1 to "
                             f"{MAX_SLOTS}")
    if nout not in (1, 2):
        raise ValueError(f"nout={nout}: the P2P kernel emits 1 or 2 channels")
    fits = [t for t in TILES if smem_bytes(*t, s, st, nout) <= MAX_SMEM]
    ty, tx = next((t for t in fits if smem_bytes(*t, s, st, nout) <= SMEM_TARGET),
                  fits[0])
    threads = min(MAX_THREADS, -(-(ty + 2) * (tx + 2) // 32) * 32)
    return ty, tx, threads, smem_bytes(ty, tx, s, st, nout)


def p2p_plain(z_halo: torch.Tensor, q_halo: torch.Tensor,
              mask_halo: torch.Tensor, sigma: float | None,
              z_tgt: torch.Tensor | None = None,
              mask_tgt: torch.Tensor | None = None,
              mode: str = "base") -> torch.Tensor:
    """(rows+2, cols+2, s) halo'd z/q/mask -> (rows, cols, st) complex, or
    (rows, cols, st, 2) for ``mode="laplace"`` (potential, field).

    ``z_tgt``/``mask_tgt`` (rows, cols, st) are passive targets; None
    evaluates at the sources (``st = s``).  Masked target slots get 0, as
    in the kernel.
    """
    eq = MODES[mode]
    rows, cols = z_halo.shape[0] - 2, z_halo.shape[1] - 2
    if z_tgt is None:
        z_tgt, mask_tgt = z_halo[1:1 + rows, 1:1 + cols], mask_halo[1:1 + rows, 1:1 + cols]
    tx, ty = z_tgt.real[..., :, None], z_tgt.imag[..., :, None]
    acc = [torch.zeros(z_tgt.shape, dtype=torch.float32, device=z_tgt.device)
           for _ in range(2 * eq.nout)]
    for (dx, dy) in P2P_OFFSETS:
        zs = z_halo[1 + dy:1 + dy + rows, 1 + dx:1 + dx + cols]
        qs = q_halo[1 + dy:1 + dy + rows, 1 + dx:1 + dx + cols]
        ms = mask_halo[1 + dy:1 + dy + rows, 1 + dx:1 + dx + cols]
        ddx = tx - zs.real[..., None, :]                  # (rows, cols, st, s)
        ddy = ty - zs.imag[..., None, :]
        r2 = ddx * ddx + ddy * ddy
        valid = ms[..., None, :] & (r2 > 0.0)
        moll = None
        if sigma is not None:
            moll = 1.0 - torch.exp(-r2 / (2.0 * sigma * sigma))
        terms = eq.p2p_terms(ddx, ddy, r2, valid, qs.real[..., None, :],
                             qs.imag[..., None, :], moll)
        for c, (tre, tim) in enumerate(terms):
            acc[2 * c] = acc[2 * c] + tre.sum(dim=-1)
            acc[2 * c + 1] = acc[2 * c + 1] + tim.sum(dim=-1)
    chans = [torch.complex(acc[2 * c], acc[2 * c + 1]) for c in range(eq.nout)]
    out = chans[0] if eq.nout == 1 else torch.stack(chans, dim=-1)
    return torch.where(mask_tgt if eq.nout == 1 else mask_tgt[..., None], out, 0)


def _lib() -> ctypes.CDLL:
    lib = _build.load("p2p")
    fn = lib.p2p_launch
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, i,
                       ctypes.c_float, i, i, i, vp]
        fn.restype = i
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.shape != shape or t.device != device:
        raise ValueError(f"{name} {tuple(t.shape)} on {t.device} does not "
                         f"match {tuple(shape)} on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def p2p_cuda(z_halo: torch.Tensor, q_halo: torch.Tensor,
             mask_halo: torch.Tensor, sigma: float | None,
             z_tgt: torch.Tensor | None = None,
             mask_tgt: torch.Tensor | None = None,
             mode: str = "base") -> torch.Tensor:
    """Launch the CUDA P2P kernel; same contract as :func:`p2p_plain`."""
    global LAUNCHES
    if z_halo.ndim != 3 or z_halo.shape[0] < 3 or z_halo.shape[1] < 3:
        raise ValueError(f"z_halo must be (rows+2, cols+2, s), got "
                         f"{tuple(z_halo.shape)}")
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: the P2P kernel computes {sorted(MODES)}")
    if (z_tgt is None) != (mask_tgt is None):
        raise ValueError("z_tgt and mask_tgt come together")
    for name, t, dtype in (("z_halo", z_halo, torch.complex64),
                           ("q_halo", q_halo, torch.complex64),
                           ("mask_halo", mask_halo, torch.bool)):
        _check(name, t, dtype, z_halo.shape, z_halo.device)
    rows, cols, s = z_halo.shape[0] - 2, z_halo.shape[1] - 2, z_halo.shape[2]
    passive = z_tgt is not None
    if passive:
        if z_tgt.ndim != 3 or tuple(z_tgt.shape[:2]) != (rows, cols):
            raise ValueError(f"z_tgt must be ({rows}, {cols}, st), got "
                             f"{tuple(z_tgt.shape)}")
        _check("z_tgt", z_tgt, torch.complex64, z_tgt.shape, z_halo.device)
        _check("mask_tgt", mask_tgt, torch.bool, z_tgt.shape, z_halo.device)
    st = z_tgt.shape[2] if passive else s
    nout = MODES[mode].nout
    ty, tx, threads, smem = launch_config(s, st, nout)
    out = torch.empty((rows, cols, st) + ((nout,) if nout > 1 else ()),
                      dtype=torch.complex64, device=z_halo.device)
    singular = sigma is None
    two_s2 = 1.0 if singular else 2.0 * sigma * sigma
    stream = torch.cuda.current_stream(z_halo.device).cuda_stream
    err = _lib().p2p_launch(z_halo.data_ptr(), q_halo.data_ptr(),
                            mask_halo.data_ptr(),
                            z_tgt.data_ptr() if passive else None,
                            mask_tgt.data_ptr() if passive else None,
                            out.data_ptr(), rows, cols, s, st, nout, ty, tx,
                            two_s2, int(singular), threads, smem, stream)
    if err:
        raise RuntimeError(f"p2p kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    LAUNCHES_BY_MODE[mode + ("_passive" if passive else "")] += 1
    return out
