"""Equation registry: everything kernel-specific in one object.

An :class:`EquationSpec` captures the kernel contract the drivers consume
(they never branch on an equation name):

* ``charge_scale``  — input strength -> stored pseudo-charge ``q``;
* ``p2m_coeff``     — per-order charge map ``ahat_k = c_k sum q zhat^k``;
* ``m2m_operator``  — the (4, p, p) upward translation tensor;
* ``m2l_folded``    — the parity-folded (8, 4p, 4p) block operator;
* ``m2l_scale``     — the M2L dimension scalar (``1/r`` for velocity);
* ``l2p_modes``     — which LE evaluations to emit;
* ``p2p_terms``     — the near-field pair interaction in explicit
  real/imag arithmetic (the formula of the plain P2P and the CUDA kernel);
* ``nout``          — output channels per target slot.

Registered: ``vortex``, the Biot-Savart velocity client (the default).
"""
from __future__ import annotations

import numpy as np
import torch

from . import expansions as ex


class EquationSpec:
    """Base spec: the complex velocity kernel (vortex) contract.

    Instances are lightweight singletons; hashing/equality go through the
    class and ``name`` so a spec can key caches of device operators.
    """

    name: str = "vortex"
    nout: int = 1                    # complex output channels per target
    l2p_modes: tuple[str, ...] = ("value",)
    charge_scale: complex = 1.0 / (2j * np.pi)   # gamma -> pseudo-charge q

    def __hash__(self):
        return hash(("EquationSpec", type(self).__qualname__, self.name))

    def __eq__(self, other):
        return type(other) is type(self) and other.name == self.name

    def __repr__(self):
        return f"EquationSpec({self.name!r})"

    # -- expansion-side contract (numpy operator builders, host-side) -------

    def p2m_coeff(self, p: int):
        """(p,) per-order weights ``c_k``, or None for the identity map."""
        return None

    def m2m_operator(self, p: int) -> np.ndarray:
        return ex.m2m_operator(p)

    def m2l_folded(self, p: int, level: int) -> np.ndarray:
        """Parity-folded (8, 4p, 4p) block operator for ``level``.  The
        velocity kernel is scale-normalized to level independence."""
        return ex.m2l_folded_operator(p)

    def m2l_scale(self, level: int) -> float:
        """Scalar applied to the folded M2L output (velocity: 1/length)."""
        return float(2.0 ** level)           # == 1 / box_size(level), exact

    # -- near-field contract -------------------------------------------------

    def p2p_terms(self, ddx, ddy, r2, valid, qr, qi, moll):
        """Per-pair contributions in explicit real/imag arithmetic.

        All operands broadcast to ``(..., T, S)``: target-source deltas
        ``ddx/ddy``, squared distance ``r2``, the validity mask (source
        occupancy AND ``r2 > 0`` self-exclusion), source charge components
        ``qr/qi``, and the Gaussian mollifier ``moll`` (None selects the
        singular kernel).  Returns ``nout`` pairs ``(re, im)`` to be summed
        over the source axis.  The CUDA P2P kernel implements exactly this
        formula for the base contract.
        """
        inv = torch.where(valid, 1.0, 0.0) / torch.where(r2 > 0.0, r2, 1.0)
        if moll is not None:
            inv = inv * moll
        return [((qr * ddx + qi * ddy) * inv, (qi * ddx - qr * ddy) * inv)]

    def pairwise(self, z_tgt, z_src, q_src, mask_src, sigma):
        """Direct pair sum built on :meth:`p2p_terms`, coincident pairs
        excluded.

        Shapes: z_tgt (..., T); z_src/q_src/mask_src (..., S).  Returns
        (..., T) complex for single-channel equations, (..., T, nout)
        otherwise.
        """
        ddx = z_tgt.real[..., :, None] - z_src.real[..., None, :]
        ddy = z_tgt.imag[..., :, None] - z_src.imag[..., None, :]
        r2 = ddx * ddx + ddy * ddy
        valid = mask_src[..., None, :] & (r2 > 0)
        moll = None
        if sigma is not None:
            moll = 1.0 - torch.exp(-r2 / (2.0 * sigma * sigma))
        qr = q_src.real[..., None, :]
        qi = q_src.imag[..., None, :]
        outs = [torch.complex(re.sum(dim=-1), im.sum(dim=-1))
                for re, im in self.p2p_terms(ddx, ddy, r2, valid, qr, qi,
                                             moll)]
        return outs[0] if self.nout == 1 else torch.stack(outs, dim=-1)


class VortexEquation(EquationSpec):
    """The Biot-Savart velocity client — the registry default.

    Identical math to the base contract; :meth:`pairwise` uses the
    complex-division form ``vortex.pairwise_w`` as the reference's plain
    route does (the two agree to f32 roundoff).
    """

    def pairwise(self, z_tgt, z_src, q_src, mask_src, sigma):
        from .vortex import pairwise_w
        return pairwise_w(z_tgt, z_src, q_src, mask_src, sigma)


VORTEX = VortexEquation()

EQUATIONS: dict[str, EquationSpec] = {VORTEX.name: VORTEX}


def get_equation(eq) -> EquationSpec:
    """Resolve a spec, a registered name, or None (-> vortex default)."""
    if eq is None:
        return VORTEX
    if isinstance(eq, EquationSpec):
        return eq
    try:
        return EQUATIONS[eq]
    except KeyError:
        raise ValueError(f"unknown equation {eq!r}; registered: "
                         f"{sorted(EQUATIONS)}") from None


def register(spec: EquationSpec) -> EquationSpec:
    """Add a spec to the registry.

    Re-registering the same spec is a no-op; replacing an existing name
    with a different spec raises, since device operators are cached keyed
    on the spec.
    """
    if spec.name in EQUATIONS and EQUATIONS[spec.name] != spec:
        raise ValueError(
            f"equation {spec.name!r} is already registered with a "
            f"different spec; register variants under a new name")
    EQUATIONS[spec.name] = spec
    return spec


def uses_base_p2p(eq: EquationSpec) -> bool:
    """True iff ``eq``'s near field is the base contract's single-channel
    formula — the one the CUDA P2P kernel implements."""
    return type(eq).p2p_terms is EquationSpec.p2p_terms and eq.nout == 1
