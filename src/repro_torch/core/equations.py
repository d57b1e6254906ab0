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
* ``nout``          — output channels per target slot;
* ``q_is_real``     — the charges are real (only ``Re q`` is read);
* ``needs_targets`` — passive source != target evaluation.

Registered:

``vortex``   the Biot-Savart velocity client (the default);
``laplace``  the 2-D Laplace potential ``Re[q log(z - z_j)]`` and field
             ``-q/(z - z_j)`` from one downward sweep (the
             Greengard-Rokhlin log expansion); channel 0 is the potential,
             channel 1 the field;
``tracer``   the velocity kernel evaluated at a separate batch of passive
             target points (probe grids, tracer particles) binned into the
             same tree.

:func:`p2p_mode` names the CUDA P2P kernel's formula for a spec: the base
single-channel formula or Laplace's two channels.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import expansions as ex
from .quadtree import box_size


class EquationSpec:
    """Base spec: the complex velocity kernel (vortex) contract.

    Instances are lightweight singletons; hashing/equality go through the
    class and ``name`` so a spec can key caches of device operators.
    """

    name: str = "vortex"
    nout: int = 1                    # complex output channels per target
    q_is_real: bool = False          # only Re q is read
    needs_targets: bool = False      # passive source != target evaluation
    l2p_modes: tuple[str, ...] = ("value",)
    charge_scale: complex = 1.0 / (2j * np.pi)   # gamma -> pseudo-charge q
    default_p: int = 12              # expansion order for p="auto" jobs

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

    # -- f64 numpy oracle (independent of the torch path) --------------------

    def direct_channels(self, dz: np.ndarray, r2: np.ndarray, q: np.ndarray,
                        moll) -> list[np.ndarray]:
        """Numpy complex128 per-pair channels (guarded at r2 == 0)."""
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = np.where(r2 > 0, 1.0, 0.0) / np.where(r2 > 0, dz, 1.0)
        if moll is not None:
            inv = inv * moll
        return [inv * q]


class VortexEquation(EquationSpec):
    """The Biot-Savart velocity client — the registry default.

    Identical math to the base contract; :meth:`pairwise` uses the
    complex-division form ``vortex.pairwise_w`` as the reference's plain
    route does (the two agree to f32 roundoff).
    """

    def pairwise(self, z_tgt, z_src, q_src, mask_src, sigma):
        from .vortex import pairwise_w
        return pairwise_w(z_tgt, z_src, q_src, mask_src, sigma)


class LaplaceEquation(EquationSpec):
    """2-D Laplace potential + field from one downward sweep.

    Multipole data is the Greengard-Rokhlin log expansion
    ``Phi(z) = a_0 log(z - c) + sum_k a_k / (z - c)^k`` with
    ``a_0 = sum q`` and ``a_k = -(1/k) sum q (z_j - c)^k``; the local side
    is the plain polynomial ``sum_l b_l (z - c)^l`` whose value is the
    (complex) potential and whose negated derivative is the field.  The
    coefficients are scale-normalized as the velocity kernel's: M2M and
    L2L stay level independent and the only level dependence is the
    ``a_0 log r`` shift, folded into the M2L operator's ``[l=0, k=0]``
    entries.  Charges are real; ``Re`` of the potential is branch-cut
    exact.
    """

    name = "laplace"
    nout = 2
    q_is_real = True
    l2p_modes = ("value", "ngrad")
    charge_scale = 1.0 + 0.0j
    default_p = 16                   # the log expansion converges slower

    def p2m_coeff(self, p: int):
        c = np.zeros(p, dtype=np.complex128)
        c[0] = 1.0
        c[1:] = -1.0 / np.arange(1, p)
        return c

    def m2m_operator(self, p: int) -> np.ndarray:
        return _laplace_m2m_operator(p)

    def m2l_folded(self, p: int, level: int) -> np.ndarray:
        return _laplace_m2l_folded(p, level)

    def m2l_scale(self, level: int) -> float:
        return 1.0

    def p2p_terms(self, ddx, ddy, r2, valid, qr, qi, moll):
        w = torch.where(valid, 1.0, 0.0)
        if moll is not None:
            w = w * moll
        # potential: q * log|dz| (real log; Re[] is branch-exact for the
        # real charges this equation is defined over)
        pot = 0.5 * torch.log(torch.where(r2 > 0.0, r2, 1.0)) * w
        inv = w / torch.where(r2 > 0.0, r2, 1.0)
        return [(qr * pot, qi * pot),
                (-(qr * ddx + qi * ddy) * inv, -(qi * ddx - qr * ddy) * inv)]

    def direct_channels(self, dz, r2, q, moll):
        w = np.where(r2 > 0, 1.0, 0.0)
        if moll is not None:
            w = w * moll
        pot = 0.5 * np.log(np.where(r2 > 0, r2, 1.0)) * w
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = w / np.where(r2 > 0, dz, 1.0)
        return [q * pot, -q * inv]


class TracerEquation(VortexEquation):
    """Passive velocity evaluation at a separate target batch: the vortex
    math, with targets that carry no charges, binned into the same leaf
    layout."""

    name = "tracer"
    needs_targets = True


VORTEX = VortexEquation()
LAPLACE = LaplaceEquation()
TRACER = TracerEquation()

EQUATIONS: dict[str, EquationSpec] = {e.name: e
                                      for e in (VORTEX, LAPLACE, TRACER)}


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


def resolve_job_spec(eq, *, have_targets: bool = False,
                     steps: int = 0) -> EquationSpec:
    """Per-job spec resolution for a serving path: resolves like
    :func:`get_equation`, then refuses a job the spec cannot run — a
    ``needs_targets`` equation without a target set, or a trajectory
    (``steps > 0``) of any equation but the vortex system."""
    spec = get_equation(eq)
    if spec.needs_targets and not have_targets:
        raise ValueError(f"equation {spec.name!r} requires a probe/target "
                         f"set (job.targets is None)")
    if steps and spec.name != "vortex":
        raise ValueError(f"trajectory sessions (steps={steps}) integrate "
                         f"the vortex system; equation {spec.name!r} is "
                         f"evaluation-only")
    return spec


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


# The CUDA P2P kernel's formulas, keyed by the ``p2p_terms`` that defines
# each, with the channel count it emits.
_P2P_MODES = {EquationSpec.p2p_terms: ("base", 1),
              LaplaceEquation.p2p_terms: ("laplace", 2)}


def p2p_mode(eq: EquationSpec) -> str | None:
    """The CUDA P2P kernel's formula for ``eq``'s near field — ``"base"``
    (the single-channel velocity formula) or ``"laplace"`` (potential and
    field) — by the ``p2p_terms`` its class carries; None when the kernel
    has no such formula."""
    mode, nout = _P2P_MODES.get(type(eq).p2p_terms, (None, None))
    return mode if nout == eq.nout else None


# ---------------------------------------------------------------------------
# Laplace operator builders (Carrier-Greengard-Rokhlin lemmas 2.3 / 2.4,
# scale-normalized like expansions.py)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _laplace_m2m_operator(p: int) -> np.ndarray:
    """(4, p, p) log-expansion M2M: ``bhat_l = sum_k Op[c, l, k] ahat_k``.

    With dhat = (c_child - c_parent) / r_parent (CGR Lemma 2.3, normalized):
    ``bhat_0 = ahat_0``; for l >= 1,
    ``bhat_l = -ahat_0 dhat^l / l + sum_{k=1}^{l} ahat_k 2^-k dhat^(l-k)
    C(l-1, k-1)``.
    """
    C = ex._binom_table(max(p, 2))
    op = np.zeros((4, p, p), dtype=np.complex128)
    for ci, (cy, cx) in enumerate(ex.CHILD_OFFSETS):
        dhat = ((cx - 0.5) / 2.0) + 1j * ((cy - 0.5) / 2.0)
        op[ci, 0, 0] = 1.0
        for l in range(1, p):
            op[ci, l, 0] = -(dhat ** l) / l
            for k in range(1, l + 1):
                op[ci, l, k] = C[l - 1, k - 1] * dhat ** (l - k) * 2.0 ** (-k)
    return op


@functools.lru_cache(maxsize=None)
def _laplace_m2l_base(p: int, level: int) -> np.ndarray:
    """(40, p, p) log-expansion M2L: ``bhat_l = sum_k Op[o, l, k] ahat_k``.

    For a source at dimensionless offset d (CGR Lemma 2.4, normalized with
    z0 = d * r): the tail entries are level independent, and the whole
    ``a_0 log(z0) = a_0 (log(-d) + log r)`` shift sits in ``Op[o, 0, 0]``,
    the only level-dependent entry.
    """
    C = ex._binom_table(2 * p + 2)
    logr = np.log(box_size(level))
    op = np.zeros((len(ex.M2L_OFFSETS), p, p), dtype=np.complex128)
    for oi, (dx, dy) in enumerate(ex.M2L_OFFSETS):
        d = float(dx) + 1j * float(dy)
        op[oi, 0, 0] = np.log(-d) + logr
        for k in range(1, p):
            op[oi, 0, k] = (-1.0) ** k * d ** (-k)
        for l in range(1, p):
            op[oi, l, 0] = -1.0 / (l * d ** l)
            for k in range(1, p):
                op[oi, l, k] = (-1.0) ** k * C[l + k - 1, k - 1] \
                    * d ** (-(k + l))
    return op


@functools.lru_cache(maxsize=None)
def _laplace_m2l_folded(p: int, level: int) -> np.ndarray:
    return ex.fold_operator(_laplace_m2l_base(p, level), p)


# ---------------------------------------------------------------------------
# O(N^2) oracle, per equation (host-side numpy, f64)
# ---------------------------------------------------------------------------


def direct_sum(eq, z_tgt: np.ndarray, z_src: np.ndarray, strength: np.ndarray,
               sigma: float | None, chunk: int = 2048) -> np.ndarray:
    """f64 direct sum of ``eq``'s pair interaction at arbitrary targets.

    ``strength`` is the raw input strength (circulation for vortex/tracer,
    charge for laplace); the spec's ``charge_scale`` maps it to the stored
    pseudo-charge as ``quadtree.build_tree`` does.  Returns (T,) complex128
    for single-channel equations, (T, nout) otherwise.  Coincident pairs
    are excluded by the r2 > 0 guard.
    """
    eq = get_equation(eq)
    z_tgt = np.asarray(z_tgt, dtype=np.complex128)
    z_src = np.asarray(z_src, dtype=np.complex128)
    q = np.asarray(strength, dtype=np.float64) * eq.charge_scale
    out = np.zeros((len(z_tgt), eq.nout), dtype=np.complex128)
    for start in range(0, len(z_tgt), chunk):
        zt = z_tgt[start:start + chunk]
        dz = zt[:, None] - z_src[None, :]
        r2 = np.abs(dz) ** 2
        moll = None
        if sigma is not None:
            moll = 1.0 - np.exp(-r2 / (2.0 * sigma * sigma))
        for c, ch in enumerate(eq.direct_channels(dz, r2, q[None, :], moll)):
            out[start:start + chunk, c] = ch.sum(axis=1)
    return out[:, 0] if eq.nout == 1 else out
