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

Every array may carry a leading batch axis ``B``: B independent grids in
one launch, B on the kernel's ``gridDim.z`` (the serving engine's bucket of
jobs, what ``vmap`` of the TPU kernel computes).  The output then carries
it too; a grid's result does not depend on the others in its batch.

Bound on an H100: bytes — the mask read whole, the z and q of live slots
read once and the output written whole (about 88 MB at the paper's size,
level 10 with 8 slots, of which the output is 67 MB; Laplace's two
channels double the output); the arithmetic, about 18 FP32 operations per
live pair, is far smaller because only 9% of the slots are live.  The
kernel works on live slots only: a block packs its halo tile's live
sources into shared memory (a scan of the mask), gives one thread to each
live target, and writes its whole output tile, zeros in the dead slots, in
one coalesced pass.  :func:`launch_config` sizes the tile for the slot
counts and channels.  Past ``TILE_SLOTS`` source or target slots (the
slot tag's 8 bits; a tile's records would soon outgrow shared memory) the
launch takes the kernel's streaming form instead: a target box and 256 of
its target slots a block, the live targets packed one a thread, the
neighbourhood's live sources staged through shared memory in chunks.  On a
grid of fewer boxes x passes than twice the card's 132 SMs (the service's
clustered jobs) each box's sources are split across a thread-block cluster
of ``STREAM_SPLIT`` blocks, whose partial sums are added in rank order
through distributed shared memory, one launch, bit for bit the same on
every run (:func:`stream_launch_config`).

``p2p_plain`` is the same function in plain PyTorch, with the formula of
the spec's ``p2p_terms``; the CPU path and the kernel's checks use it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core.equations import LAPLACE, VORTEX
from ..core.quadtree import P2P_OFFSETS
from . import _build

MAX_SMEM = 232_448  # bytes of shared memory one block may use on Hopper
MAX_THREADS = 1024
TILE_SLOTS = 256    # the tiled kernel's tag keeps a target's slot in 8 bits
MAX_BATCH = 65535   # grids a launch takes: the batch is gridDim.z
# target-box tiles (TY, TX), largest first, each the choice for some s up to
# TILE_SLOTS: 16 x 16 stages 1.27x its boxes
TILES = ((16, 16), (8, 16), (8, 8), (4, 8), (4, 4), (2, 4), (2, 2))
SMEM_TARGET = 72 * 1024   # three blocks an SM
# the streaming form past TILE_SLOTS (csrc/p2p.cu:p2p_stream_kernel): one
# target box and pass of 256 target slots a cluster of STREAM_SPLIT blocks
# (or one block), one live target a thread; shared memory for 1024 source
# records a chunk, the pass's 256 packed target slots and 32 warp sums
STREAM_THREADS = 256
STREAM_SMEM = 1024 * 16 + 256 * 4 + 32 * 4
STREAM_SPLIT = 9    # blocks a cluster: the 9 neighbour boxes, one each
SMS = _build.SMS    # the H100's streaming multiprocessors

# each mode's formula: the spec whose ``p2p_terms`` it is
MODES = {"base": VORTEX, "laplace": LAPLACE}

LAUNCHES = 0        # kernel launches since the last reset
STREAM_LAUNCHES = 0  # of them in the streaming form (past TILE_SLOTS)
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
    channels: up to ``TILE_SLOTS`` of each, the largest tile of ``TILES``
    within ``SMEM_TARGET`` (else the largest within ``MAX_SMEM``), one
    thread per halo box; past it, the streaming form's one box a block."""
    st = s if st is None else st
    for name, n in (("s", s), ("st", st)):
        if not 1 <= n <= 1 << 24:
            raise ValueError(f"{name}={n} slots: the P2P kernel takes 1 to "
                             f"{1 << 24}")
    if nout not in (1, 2):
        raise ValueError(f"nout={nout}: the P2P kernel emits 1 or 2 channels")
    if max(s, st) > TILE_SLOTS:
        return 1, 1, STREAM_THREADS, STREAM_SMEM
    fits = [t for t in TILES if smem_bytes(*t, s, st, nout) <= MAX_SMEM]
    ty, tx = next((t for t in fits if smem_bytes(*t, s, st, nout) <= SMEM_TARGET),
                  fits[0])
    threads = min(MAX_THREADS, -(-(ty + 2) * (tx + 2) // 32) * 32)
    return ty, tx, threads, smem_bytes(ty, tx, s, st, nout)


def stream_launch_config(rows: int, cols: int, s: int, st: int | None = None,
                         nout: int = 1) -> tuple[int, int, int]:
    """``(split, threads, smem bytes)`` of the streaming form's launch on one
    ``rows x cols`` grid with ``s`` source and ``st`` target slots (default
    ``s``), as ``csrc/p2p.cu:stream_split`` chooses it; the batch never
    enters.  Boxes x passes of ``STREAM_THREADS`` target slots fewer than
    ``2 x SMS`` split each box's sources over a cluster of ``STREAM_SPLIT``
    blocks; more run one block a box and pass."""
    st = s if st is None else st
    if rows < 1 or cols < 1:
        raise ValueError(f"a {rows} x {cols} grid: the P2P kernel takes one box or more")
    if launch_config(s, st, nout) != (1, 1, STREAM_THREADS, STREAM_SMEM):
        raise ValueError(f"s={s}, st={st}: the tiled kernel takes the launch")
    blocks = rows * cols * -(-st // STREAM_THREADS)
    split = STREAM_SPLIT if blocks < 2 * SMS else 1
    return split, STREAM_THREADS, STREAM_SMEM


def stream_blocks(rows: int, cols: int, s: int, st: int | None = None,
                  nout: int = 1) -> int:
    """Blocks of the streaming form's launch on one ``rows x cols`` grid:
    boxes x passes x split (:func:`stream_launch_config`)."""
    st = s if st is None else st
    return rows * cols * -(-st // STREAM_THREADS) * stream_launch_config(
        rows, cols, s, st, nout)[0]


def p2p_plain(z_halo: torch.Tensor, q_halo: torch.Tensor,
              mask_halo: torch.Tensor, sigma: float | None,
              z_tgt: torch.Tensor | None = None,
              mask_tgt: torch.Tensor | None = None,
              mode: str = "base") -> torch.Tensor:
    """([B,] rows+2, cols+2, s) halo'd z/q/mask -> ([B,] rows, cols, st)
    complex, or ([B,] rows, cols, st, 2) for ``mode="laplace"`` (potential,
    field).

    ``z_tgt``/``mask_tgt`` ([B,] rows, cols, st) are passive targets; None
    evaluates at the sources (``st = s``).  Masked target slots get 0, as
    in the kernel.
    """
    eq = MODES[mode]
    rows, cols = z_halo.shape[-3] - 2, z_halo.shape[-2] - 2
    if z_tgt is None:
        z_tgt = z_halo[..., 1:1 + rows, 1:1 + cols, :]
        mask_tgt = mask_halo[..., 1:1 + rows, 1:1 + cols, :]
    tx, ty = z_tgt.real[..., :, None], z_tgt.imag[..., :, None]
    acc = [torch.zeros(z_tgt.shape, dtype=torch.float32, device=z_tgt.device)
           for _ in range(2 * eq.nout)]
    for (dx, dy) in P2P_OFFSETS:
        window = (..., slice(1 + dy, 1 + dy + rows), slice(1 + dx, 1 + dx + cols),
                  slice(None))
        zs, qs, ms = z_halo[window], q_halo[window], mask_halo[window]
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
        fn.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i,
                       ctypes.c_float, i, i, i, vp]
        fn.restype = i
        lib.p2p_stream_split.argtypes = [i, i, i, i]
        lib.p2p_stream_split.restype = i
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


@functools.lru_cache(maxsize=None)
def _check_stream_split(rows: int, cols: int, s: int, st: int, nout: int) -> None:
    """Raise unless the kernel's streaming launch on this grid splits as
    :func:`stream_launch_config` does (checked once a grid shape)."""
    split = _lib().p2p_stream_split(rows, cols, s, st)
    want = stream_launch_config(rows, cols, s, st, nout)[0]
    if split != want:
        raise ValueError(f"{rows} x {cols} boxes of {st} target slots: the kernel "
                         f"splits {split}, kernels/p2p.py:stream_launch_config {want}")


def p2p_cuda(z_halo: torch.Tensor, q_halo: torch.Tensor,
             mask_halo: torch.Tensor, sigma: float | None,
             z_tgt: torch.Tensor | None = None,
             mask_tgt: torch.Tensor | None = None,
             mode: str = "base") -> torch.Tensor:
    """Launch the CUDA P2P kernel; same contract as :func:`p2p_plain`: one
    launch for a 3-D grid or a 4-D batch of them."""
    global LAUNCHES, STREAM_LAUNCHES
    if (z_halo.ndim not in (3, 4) or z_halo.shape[-3] < 3 or z_halo.shape[-2] < 3
            or (z_halo.ndim == 4 and not 1 <= z_halo.shape[0] <= MAX_BATCH)):
        raise ValueError(f"z_halo must be ([B,] rows+2, cols+2, s) with 1 <= B <= "
                         f"{MAX_BATCH}, got {tuple(z_halo.shape)}")
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: the P2P kernel computes {sorted(MODES)}")
    if (z_tgt is None) != (mask_tgt is None):
        raise ValueError("z_tgt and mask_tgt come together")
    for name, t, dtype in (("z_halo", z_halo, torch.complex64),
                           ("q_halo", q_halo, torch.complex64),
                           ("mask_halo", mask_halo, torch.bool)):
        _check(name, t, dtype, z_halo.shape, z_halo.device)
    lead = tuple(z_halo.shape[:-3])                  # () or (B,)
    batch = lead[0] if lead else 1
    rows, cols, s = z_halo.shape[-3] - 2, z_halo.shape[-2] - 2, z_halo.shape[-1]
    passive = z_tgt is not None
    if passive:
        if z_tgt.ndim != z_halo.ndim or tuple(z_tgt.shape[:-1]) != lead + (rows, cols):
            raise ValueError(f"z_tgt must be {lead + (rows, cols)} + (st,), got "
                             f"{tuple(z_tgt.shape)}")
        _check("z_tgt", z_tgt, torch.complex64, z_tgt.shape, z_halo.device)
        _check("mask_tgt", mask_tgt, torch.bool, z_tgt.shape, z_halo.device)
    st = z_tgt.shape[-1] if passive else s
    # csrc/p2p.cu reads a box's mask at s = 8 as one 8-byte word: every grid
    # of the batch must start on an 8-byte boundary there
    if s == 8 and lead and mask_halo.stride(0) % 8:
        raise ValueError(f"mask_halo's grids are {mask_halo.stride(0)} bytes "
                         f"apart: the s = 8 kernel needs a multiple of 8")
    nout = MODES[mode].nout
    ty, tx, threads, smem = launch_config(s, st, nout)
    if max(s, st) > TILE_SLOTS:
        if batch * -(-st // STREAM_THREADS) > MAX_BATCH:
            raise ValueError(f"{batch} grids of {st} target slots: the streaming "
                             f"form takes at most {MAX_BATCH} grids x passes of "
                             f"{STREAM_THREADS}")
        _check_stream_split(rows, cols, s, st, nout)
    out = torch.empty(lead + (rows, cols, st) + ((nout,) if nout > 1 else ()),
                      dtype=torch.complex64, device=z_halo.device)
    singular = sigma is None
    two_s2 = 1.0 if singular else 2.0 * sigma * sigma
    stream = torch.cuda.current_stream(z_halo.device).cuda_stream
    err = _lib().p2p_launch(z_halo.data_ptr(), q_halo.data_ptr(),
                            mask_halo.data_ptr(),
                            z_tgt.data_ptr() if passive else None,
                            mask_tgt.data_ptr() if passive else None,
                            out.data_ptr(), batch, rows, cols, s, st, nout, ty, tx,
                            two_s2, int(singular), threads, smem, stream)
    if err:
        raise RuntimeError(f"p2p kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    STREAM_LAUNCHES += max(s, st) > TILE_SLOTS
    LAUNCHES_BY_MODE[mode + ("_passive" if passive else "")] += 1
    return out
