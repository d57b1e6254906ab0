"""On-device health sentinels for guarded FMM execution.

A *health word* is a tiny ``(N_FIELDS,) int32`` tensor computed on the
device alongside the results and read by the host with the step's own
outputs.

Fields (index constants below):

  flags (0/1)           F_VEL       non-finite velocity/output at a live slot
                        F_COEFF     non-finite expansion coefficient (ME or LE)
                        F_HALO      non-finite value in an exchanged halo buffer
                        F_OVERFLOW  a leaf box overflowed its slots during rebin
  counts                F_OOD       live particles outside the unit domain
                                    (counted BEFORE the rebin clamps them)
                        F_DROPPED   live particles silently dropped by a rebin
  gauges (max)          F_OCC       max leaf occupancy after the step

Merge semantics: flags and gauges combine by ``max``, counts by ``+``.

``pack``/``unpack`` give the single packed word form for reports and logs:

  bits 0-3    F_VEL | F_COEFF<<1 | F_HALO<<2 | F_OVERFLOW<<3
  bits 4-15   F_OOD      (clamped to 4095)
  bits 16-23  F_DROPPED  (clamped to 255)
  bits 24-31  F_OCC      (clamped to 255)

``ok`` is the fault predicate: any flag set or any count nonzero is a
fault; occupancy is a gauge, not a fault.
"""
from __future__ import annotations

import numpy as np
import torch

N_FIELDS = 8
F_VEL, F_COEFF, F_HALO, F_OVERFLOW, F_OOD, F_DROPPED, F_OCC, F_SPARE = \
    range(N_FIELDS)

FIELD_NAMES = ("vel_nonfinite", "coeff_nonfinite", "halo_nonfinite",
               "leaf_overflow", "out_of_domain", "dropped", "max_occupancy",
               "spare")

# count fields combine by +; everything else by max
_COUNT_FIELDS = (F_OOD, F_DROPPED)
_IS_COUNT = np.zeros(N_FIELDS, dtype=bool)
_IS_COUNT[list(_COUNT_FIELDS)] = True


def empty(device=None) -> torch.Tensor:
    return torch.zeros((N_FIELDS,), dtype=torch.int32, device=device)


def nonfinite(x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """0/1 int32 tensor: any non-finite entry (live slots only when ``mask``)."""
    bad = ~torch.isfinite(x)
    if x.is_complex():
        bad = ~(torch.isfinite(x.real) & torch.isfinite(x.imag))
    if mask is not None:
        m = mask if bad.ndim == mask.ndim else mask[..., None]
        bad = bad & m
    return torch.any(bad).to(torch.int32)


def out_of_domain_count(z: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Live particles outside the unit square [0, 1)^2 — the positions the
    rebin would silently clamp into the edge boxes."""
    out = (z.real < 0.0) | (z.real >= 1.0) | (z.imag < 0.0) | (z.imag >= 1.0)
    return (out & mask).sum().to(torch.int32)


def with_flag(vec: torch.Tensor, field: int, cond) -> torch.Tensor:
    out = vec.clone()
    out[field] = torch.maximum(out[field], torch.as_tensor(
        cond, dtype=torch.int32, device=vec.device))
    return out


def with_count(vec: torch.Tensor, field: int, n) -> torch.Tensor:
    out = vec.clone()
    out[field] += torch.as_tensor(n, dtype=torch.int32, device=vec.device)
    return out


def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose two health words (substeps, driver + step level)."""
    is_count = torch.as_tensor(_IS_COUNT, device=a.device)
    return torch.where(is_count, a + b, torch.maximum(a, b))


def device_combine(stacked: torch.Tensor) -> torch.Tensor:
    """Reduce a (P, N_FIELDS) per-device stack to one global word."""
    is_count = torch.as_tensor(_IS_COUNT, device=stacked.device)
    return torch.where(is_count, stacked.sum(dim=0),
                       stacked.max(dim=0).values).to(torch.int32)


# -- host-side report helpers ------------------------------------------------


def _host(vec) -> np.ndarray:
    if isinstance(vec, torch.Tensor):
        vec = vec.cpu().numpy()
    return np.asarray(vec, dtype=np.int64)


def ok(vec) -> bool:
    """True iff no fault is flagged (occupancy is a gauge, not a fault)."""
    return bool((_host(vec)[:F_OCC] == 0).all())


def pack(vec) -> int:
    """Health vector -> one packed 32-bit word (clamped fields; see above)."""
    v = _host(vec)
    word = (min(max(int(v[F_VEL]), 0), 1)
            | (min(max(int(v[F_COEFF]), 0), 1) << 1)
            | (min(max(int(v[F_HALO]), 0), 1) << 2)
            | (min(max(int(v[F_OVERFLOW]), 0), 1) << 3)
            | (min(max(int(v[F_OOD]), 0), 4095) << 4)
            | (min(max(int(v[F_DROPPED]), 0), 255) << 16)
            | (min(max(int(v[F_OCC]), 0), 255) << 24))
    return int(word)


def unpack(word: int) -> np.ndarray:
    v = np.zeros(N_FIELDS, dtype=np.int64)
    v[F_VEL] = word & 1
    v[F_COEFF] = (word >> 1) & 1
    v[F_HALO] = (word >> 2) & 1
    v[F_OVERFLOW] = (word >> 3) & 1
    v[F_OOD] = (word >> 4) & 4095
    v[F_DROPPED] = (word >> 16) & 255
    v[F_OCC] = (word >> 24) & 255
    return v


def describe(vec) -> dict:
    """Human/structured view of a health vector (or packed word)."""
    v = _host(vec)
    if v.ndim == 0:
        v = unpack(int(v))
    return {name: int(v[i]) for i, name in enumerate(FIELD_NAMES)
            if name != "spare"}
