"""The yardstick's arithmetic: peaks, and each stage's operations and bytes.

Every count is the benchmark's own, from the points and the boxes that
hold them, never from a padded layout, so the same work reads the same
bound whatever implements it.  A complex multiply-add is 8 real operations (a complex
product 6); a division, square root, exponential or logarithm counts as
one.  Bytes count each input read once and each output written once.

The peaks are NVIDIA's data sheet for one H100 SXM (dense rates, 700 W).
The P2P operations per live pair are a frozen copy of
``chip_smoke.py:P2P_OPS`` (commit 5f3f6255), counted from
``csrc/p2p.cu``'s pair term.  :func:`live_pairs` is a frozen copy of
``chip_smoke.py:live_pairs`` (same commit); :func:`live_pairs_from_counts`
gives the same number from the boxes' occupancies, for points no two of
which coincide.
"""
from __future__ import annotations

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12          # FP32 outside the tensor cores
TF32_FLOP_PER_S = 495e12
# an f32 product at f32 accuracy on the tensor cores: three TF32 passes
F32_PRODUCT_FLOP_PER_S = TF32_FLOP_PER_S / 3

# FP32 operations per live pair in csrc/p2p.cu: deltas 2, r2 3, 1/r2 1, two
# accumulated products 8, the mollifier 4 more (divide, exp, subtract,
# multiply) with a finite sigma; Laplace's two channels: deltas 2, r2 3, the
# potential 3 (log, two products), the field's weight 1, channel 0 4,
# channel 1 10, the mollifier 3 more.
P2P_OPS = {("base", True): 14, ("base", False): 18,
           ("laplace", True): 23, ("laplace", False): 26}

CMUL, CMADD = 6, 8
C64 = 8                            # bytes of a complex64


def live_pairs(z_halo, mask_halo, zt=None, mt=None) -> int:
    """Pairs (live target, live source, r2 > 0) over the 3x3 stencil of a
    grid with one ghost row and column on each side; the targets are the
    sources unless ``zt``/``mt`` give passive ones."""
    rows, cols = z_halo.shape[0] - 2, z_halo.shape[1] - 2
    if zt is None:
        zt, mt = z_halo[1:1 + rows, 1:1 + cols], mask_halo[1:1 + rows, 1:1 + cols]
    total = 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            zs = z_halo[1 + dy:1 + dy + rows, 1 + dx:1 + dx + cols]
            ms = mask_halo[1 + dy:1 + dy + rows, 1 + dx:1 + dx + cols]
            d = zt[..., :, None] - zs[..., None, :]
            r2 = d.real * d.real + d.imag * d.imag
            total += int((mt[..., :, None] & ms[..., None, :] & (r2 > 0)).sum())
    return total


def neighbourhood_sums(counts: np.ndarray) -> np.ndarray:
    """Sum of each box's 3 x 3 neighbourhood (zero outside the grid)."""
    c = np.pad(np.asarray(counts, np.int64), 1)
    n, m = counts.shape
    return sum(c[1 + dy:1 + dy + n, 1 + dx:1 + dx + m]
               for dy in (-1, 0, 1) for dx in (-1, 0, 1))


def live_pairs_from_counts(src_counts: np.ndarray, tgt_counts=None) -> int:
    """:func:`live_pairs` from the live sources of each box (and the
    passive targets of each box, if any): every target with every source
    of its 3 x 3 neighbourhood, less each source with itself."""
    src = np.asarray(src_counts, np.int64)
    near = neighbourhood_sums(src)
    if tgt_counts is None:
        return int((src * near).sum() - src.sum())
    return int((np.asarray(tgt_counts, np.int64) * near).sum())


def level_counts(leaf_counts: np.ndarray, level: int) -> np.ndarray:
    """Points in each box of ``level``, from the leaf boxes' counts."""
    c = np.asarray(leaf_counts, np.int64)
    n, f = 1 << level, c.shape[0] >> level
    return c.reshape(n, f, n, f).sum(axis=(1, 3))


def interaction_pairs(src: np.ndarray, tgt: np.ndarray) -> int:
    """Ordered (target box, source box) pairs of one level's M2L
    interaction lists in which both boxes hold points: the source among
    the children of the neighbours of the target's parent, not adjacent
    to the target (27 for a box away from the edges)."""
    n = src.shape[0]
    s, t = np.pad(np.asarray(src) > 0, 3), np.asarray(tgt) > 0
    total = 0
    for py in (0, 1):
        for px in (0, 1):
            tt = t[py::2, px::2]
            for dy in range(-2 - py, 4 - py):
                for dx in range(-2 - px, 4 - px):
                    if abs(dy) <= 1 and abs(dx) <= 1:
                        continue
                    y, x = py + dy + 3, px + dx + 3
                    total += int(np.count_nonzero(tt & s[y:y + n:2, x:x + n:2]))
    return total


def evaluation_work(desc: dict) -> dict:
    """{stage: {"ops", "bytes", "rate"}} of one FMM evaluation, over the
    points and the boxes that hold them (never the padded slots).

    ``desc``: ``equation`` ("vortex", "laplace", "tracer"), ``level``,
    ``p``, ``singular`` (no sigma), ``src_counts`` (the live sources of
    each leaf box) and, for passive targets, ``tgt_counts``.  M2L runs at
    the f32 product rate, the rest at FP32.
    """
    L, p = int(desc["level"]), int(desc["p"])
    src = np.asarray(desc["src_counts"], np.int64)
    passive = desc.get("tgt_counts") is not None
    tgt = np.asarray(desc["tgt_counts"], np.int64) if passive else src
    laplace = desc["equation"] == "laplace"
    nout = 2 if laplace else 1
    n_src, n_tgt = int(src.sum()), int(tgt.sum())
    tri = p * (p + 1) // 2
    src_boxes = [np.count_nonzero(level_counts(src, l)) for l in range(L + 1)]
    tgt_boxes = [np.count_nonzero(level_counts(tgt, l)) for l in range(L + 1)]
    # P2M: zhat 4, p - 1 powers, p accumulations; Laplace's per-order weights
    p2m = n_src * (4 + CMUL * (p - 1) + CMADD * p) + (src_boxes[L] * p * CMUL if laplace else 0)
    # M2M into the multipoles M2L reads (levels 2 to L - 1), L2L out of the
    # locals it writes (children at levels 3 to L)
    m2m = sum(src_boxes[3:]) * tri * CMADD
    m2l_levels = [dict(m2l_level_work(level_counts(src, l), level_counts(tgt, l), p), level=l)
                  for l in range(2, L + 1)]
    l2l = sum(tgt_boxes[3:]) * tri * CMADD
    # L2P: zhat 4, p - 1 powers, p accumulations; the field's p - 1 more
    l2p = n_tgt * (4 + CMUL * (p - 1) + CMADD * p + ((CMADD * (p - 1) + 2) if laplace else 0))
    mode = "laplace" if laplace else "base"
    pairs = live_pairs_from_counts(src, tgt if passive else None)
    p2p_bytes = (2 * C64 * n_src                   # z and q of each source
                 + (C64 * n_tgt if passive else 0)  # z of each passive target
                 + C64 * nout * n_tgt)             # each target's output
    fp32 = FP32_FLOP_PER_S
    return {
        "p2m": {"ops": p2m, "bytes": 0, "rate": fp32},
        "m2m": {"ops": m2m, "bytes": 0, "rate": fp32},
        "m2l": {"ops": sum(w["ops"] for w in m2l_levels),
                "bytes": sum(w["bytes"] for w in m2l_levels),
                "rate": F32_PRODUCT_FLOP_PER_S, "levels": m2l_levels},
        "l2l": {"ops": l2l, "bytes": 0, "rate": fp32},
        "l2p": {"ops": l2p, "bytes": 0, "rate": fp32},
        "p2p": {"ops": pairs * P2P_OPS[(mode, bool(desc["singular"]))],
                "bytes": p2p_bytes, "rate": fp32, "pairs": pairs},
    }


def m2l_level_work(src: np.ndarray, tgt: np.ndarray, p: int) -> dict:
    """One level's M2L from its boxes' source and target counts: p x p
    complex multiply-adds for each interaction pair of boxes that both
    hold points; bytes the p coefficients of each box holding sources
    read once and of each box holding targets written once (the
    translation operators, which depend on the offset alone, count as
    computed)."""
    pairs = interaction_pairs(src, tgt)
    boxes = np.count_nonzero(src) + np.count_nonzero(tgt)
    return {"pairs": pairs, "ops": pairs * p * p * CMADD, "bytes": int(boxes) * p * C64,
            "rate": F32_PRODUCT_FLOP_PER_S}


def bound_s(ops: float, nbytes: float, rate: float) -> float:
    """The least time of a kernel: max(bytes at HBM speed, ops at ``rate``)."""
    return max(nbytes / HBM_BYTES_PER_S, ops / rate)


def least_time_s(work: dict) -> float:
    """The least time of an evaluation's counted work: each stage's
    operations at its rate, summed."""
    return sum(w["ops"] / w["rate"] for w in work.values())


def kick_ops(live: int) -> int:
    """One kick of ``live`` particles: a real scale of a complex number (2)
    and a complex add (2)."""
    return 4 * live


def counts_of(mask: torch.Tensor) -> np.ndarray:
    """Live slots of each box of an (n, n, s) mask, on the host."""
    return mask.sum(dim=-1, dtype=torch.int32).cpu().numpy()
