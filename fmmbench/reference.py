"""The plain reference: direct pair sums in float64, and their control.

The program's FMM defines each configuration's field as a sum over every
other source: the Gaussian-core kernel (``sigma``) for sources in the 3 x 3
leaf boxes around the target's box, the singular kernel for all others,
as ``core/fmm.py`` splits near and far field; with ``sigma`` None every
pair is singular.  A target's box is ``floor(x * 2**level)``, clamped into
the grid, as the program bins.  This module sums that definition directly
over every source, in float64, a block of targets at a time, in plain
PyTorch on any device.  It imports nothing of the program and takes no
table the program made.

``precision="tf32"`` is the control: the same sum with float32 pair
terms, each product's operands cut to TF32 (the low 13 mantissa bits
dropped, as a TF32 pass on the H100 reads them) and float32 sums.  It is
the reference computed in the precision next below the configurations'
float32.
"""
from __future__ import annotations

import contextlib

import torch

VORTEX_SCALE = 1.0 / (2j * 3.141592653589793)   # circulation -> pseudo-charge
TF32_DROP = 0x1FFF                              # the mantissa bits a TF32 pass drops


def boxes(z: torch.Tensor, level: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The leaf box (ix, iy) of each point, clamped into the grid."""
    n = 1 << level
    ix = torch.floor((z.real.double() * n).clamp(0, n - 1)).to(torch.int64)
    iy = torch.floor((z.imag.double() * n).clamp(0, n - 1)).to(torch.int64)
    return ix, iy


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values with the low 13 mantissa bits dropped (toward zero)."""
    bits = x.contiguous().view(torch.int32) & ~TF32_DROP
    return bits.view(torch.float32)


@contextlib.contextmanager
def _no_tf32():
    cuda = torch.backends.cuda.matmul
    old = cuda.allow_tf32
    cuda.allow_tf32 = False
    try:
        yield
    finally:
        cuda.allow_tf32 = old


def _matmul_tf32(kr, ki, qr, qi):
    """(kr + i ki) @ (qr + i qi) with TF32 operands and float32 sums."""
    kr, ki, qr, qi = tf32(kr), tf32(ki), tf32(qr), tf32(qi)
    with _no_tf32():
        return torch.complex(kr @ qr - ki @ qi, kr @ qi + ki @ qr)


def pair_sum(kind: str, z_tgt: torch.Tensor, z_src: torch.Tensor,
             q_src: torch.Tensor, sigma, level: int, precision: str = "f64",
             block: int = 128) -> torch.Tensor:
    """The field at ``z_tgt`` (T,) of the sources ``z_src``, ``q_src`` (S,).

    ``kind`` "vortex": ``sum_j q_j / (z - z_j)``, (T,) complex.  ``kind``
    "laplace": (T, 2) complex, the potential ``sum_j q_j log|z - z_j|`` and
    the field ``-sum_j q_j / (z - z_j)``.  Coincident pairs are left out.
    The result is complex128 for ``precision`` "f64", complex64 for "tf32".
    """
    if kind not in ("vortex", "laplace"):
        raise ValueError(f"unknown kind {kind!r}")
    if precision not in ("f64", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    ctype = torch.complex128 if precision == "f64" else torch.complex64
    zs = z_src.to(ctype)
    qs = q_src.to(ctype)
    ixs, iys = boxes(z_src, level)
    ixt, iyt = boxes(z_tgt, level)
    out = []
    for a in range(0, len(z_tgt), block):
        zt = z_tgt[a:a + block].to(ctype)
        dz = zt[:, None] - zs[None, :]
        r2 = dz.real * dz.real + dz.imag * dz.imag
        valid = r2 > 0
        weight = valid.to(r2.dtype)
        if sigma is not None:
            near = (((ixt[a:a + block, None] - ixs[None, :]).abs() <= 1)
                    & ((iyt[a:a + block, None] - iys[None, :]).abs() <= 1))
            weight = weight * torch.where(
                near, 1.0 - torch.exp(-r2 / (2.0 * sigma * sigma)), 1.0)
        safe = torch.where(valid, r2, 1.0)
        inv = torch.complex(dz.real / safe, -dz.imag / safe) * weight   # 1/dz
        cols = [inv]
        if kind == "laplace":
            pot = 0.5 * torch.log(safe) * weight
            cols = [torch.complex(pot, torch.zeros_like(pot)), -inv]
        res = []
        for k in cols:
            if precision == "f64":
                res.append(k @ qs)
            else:
                res.append(_matmul_tf32(k.real, k.imag, qs.real, qs.imag))
        out.append(res[0] if kind == "vortex" else torch.stack(res, dim=-1))
        del dz, r2, valid, weight, inv, cols
    return torch.cat(out)


def rel_l2(value: torch.Tensor, ref: torch.Tensor) -> float:
    """||value - ref|| / ||ref|| in float64."""
    value = value.to(torch.complex128 if value.is_complex() else torch.float64)
    ref = ref.to(value.dtype)
    return float(torch.linalg.vector_norm(value - ref) / torch.linalg.vector_norm(ref))
