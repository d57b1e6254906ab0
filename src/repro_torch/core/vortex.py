"""Vortex-particle client application (paper §3 and §7.1).

Complex-velocity convention: ``W = u - i v``.  A vortex of circulation
``gamma_j`` at ``z_j`` induces

    W(z) = gamma_j / (2*pi*i * (z - z_j))                       (singular)
    W_sigma(z) = W(z) * (1 - exp(-|z - z_j|^2 / (2 sigma^2)))   (Gaussian core)

which matches the paper's Eq (8).  With pseudo-charge ``q = gamma/(2*pi*i)``
both kernels are ``q/(z - z_j)`` times a mollifier.
"""
from __future__ import annotations

import numpy as np
import torch


def pairwise_w(z_tgt: torch.Tensor, z_src: torch.Tensor, q_src: torch.Tensor,
               mask_src: torch.Tensor, sigma: float | None) -> torch.Tensor:
    """Direct-sum complex velocity at ``z_tgt`` from masked sources.

    Shapes: z_tgt (..., T), z_src/q_src/mask_src (..., S) -> (..., T).
    ``sigma=None`` selects the singular kernel; finite sigma the
    regularized Biot-Savart kernel.  Self/coincident pairs are excluded via
    an |dz|^2 == 0 guard.  This is the complex-division form; the kernels
    use the real/imag form of ``EquationSpec.p2p_terms``.
    """
    dz = z_tgt[..., :, None] - z_src[..., None, :]            # (..., T, S)
    r2 = (dz * torch.conj(dz)).real
    valid = mask_src[..., None, :] & (r2 > 0)
    inv = torch.where(valid, 1.0, 0.0) / torch.where(r2 > 0, dz, 1.0)
    if sigma is not None:
        inv = inv * (1.0 - torch.exp(-r2 / (2.0 * sigma * sigma)))
    return torch.einsum("...ts,...s->...t", inv, q_src)


def direct_sum(z: np.ndarray, gamma: np.ndarray, sigma: float | None,
               chunk: int = 2048) -> np.ndarray:
    """O(N^2) oracle: complex velocity W = u - iv at every particle (f64)."""
    z = np.asarray(z, dtype=np.complex128)
    q = np.asarray(gamma, dtype=np.float64) / (2j * np.pi)
    out = np.zeros_like(z)
    for start in range(0, len(z), chunk):
        zt = z[start:start + chunk]
        dz = zt[:, None] - z[None, :]
        r2 = np.abs(dz) ** 2
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = np.where(r2 > 0, 1.0 / np.where(r2 > 0, dz, 1.0), 0.0)
        if sigma is not None:
            inv = inv * (1.0 - np.exp(-r2 / (2.0 * sigma * sigma)))
        out[start:start + chunk] = inv @ q
    return out


def velocity_from_w(w) -> tuple:
    """(u, v) from complex W = u - iv (numpy arrays or torch tensors)."""
    if isinstance(w, torch.Tensor):
        return w.real, -w.imag
    return np.real(w), -np.imag(w)


# ---------------------------------------------------------------------------
# Lamb-Oseen vortex test case (paper §7.1)
# ---------------------------------------------------------------------------


def lamb_oseen_omega(r: np.ndarray, gamma0: float, nu: float, t: float) -> np.ndarray:
    """Vorticity field, paper Eq (16)."""
    return gamma0 / (4.0 * np.pi * nu * t) * np.exp(-r * r / (4.0 * nu * t))


def lamb_oseen_velocity(x: np.ndarray, y: np.ndarray, gamma0: float, nu: float,
                        t: float, x0: float = 0.5, y0: float = 0.5) -> tuple[np.ndarray, np.ndarray]:
    """Analytical azimuthal velocity of the Lamb-Oseen vortex (paper Eq 17).

    u_theta(r) = Gamma0 / (2 pi r) * (1 - exp(-r^2 / (4 nu t)))
    (the paper's printed Eq (17) has a typo; this is the standard form).
    """
    dx, dy = x - x0, y - y0
    r2 = dx * dx + dy * dy
    r = np.sqrt(r2)
    with np.errstate(divide="ignore", invalid="ignore"):
        ut = gamma0 / (2.0 * np.pi * np.where(r > 0, r, 1.0)) * (1.0 - np.exp(-r2 / (4.0 * nu * t)))
    ut = np.where(r > 0, ut, 0.0)
    return -ut * dy / np.where(r > 0, r, 1.0), ut * dx / np.where(r > 0, r, 1.0)


def lamb_oseen_particles(m_side: int, gamma0: float = 1.0, nu: float = 5e-4,
                         t: float = 4.0, spacing_ratio: float = 0.8,
                         sigma: float = 0.02, extent: float = 0.8,
                         x0: float = 0.5, y0: float = 0.5):
    """Lattice particle initialization as in the paper's strong-scaling setup.

    Particles on an ``m_side x m_side`` lattice covering ``extent`` of the
    unit domain; circulation = vorticity * cell area (h = spacing, with
    h / sigma = spacing_ratio).  Returns ``(positions, gamma, sigma)`` with
    sigma rescaled when the lattice had to shrink to fit.
    """
    h = sigma * spacing_ratio
    span = (m_side - 1) * h
    scale = 1.0
    if span > extent:  # keep lattice inside the unit domain
        scale = extent / span
        h *= scale
        span = extent
    xs = x0 - span / 2 + h * np.arange(m_side)
    ys = y0 - span / 2 + h * np.arange(m_side)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    r = np.sqrt((X - x0) ** 2 + (Y - y0) ** 2)
    w = lamb_oseen_omega(r, gamma0, nu, t)
    gamma = (w * h * h).ravel()
    pos = np.stack([X.ravel(), Y.ravel()], axis=1)
    return pos, gamma, sigma * scale
