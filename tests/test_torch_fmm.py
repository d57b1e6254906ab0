"""The port's serial FMM against the reference's plain route and the f64
direct sums."""
import numpy as np
import pytest
import torch

from repro.core import fmm as jfmm
from repro.core import health as jhw
from repro.core import quadtree as jqt
from repro_torch.core import equations as eqs
from repro_torch.core import fmm, health as hw, vortex
from repro_torch.core.quadtree import build_tree, gather_particle_values


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _random_case(n, seed, level, sigma=0.02):
    """The reference tests' case: uniform particles, normal strengths."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.02, 0.98, size=(n, 2))
    gamma = rng.normal(size=n)
    jt, _ = jqt.build_tree(pos, gamma, level=level, sigma=sigma)
    tt, index = build_tree(pos, gamma, level=level, sigma=sigma, device="cpu")
    return pos, gamma, jt, tt, index


@pytest.mark.parametrize("level", [1, 2, 3, 4])
@pytest.mark.parametrize("p", [8, 17])
def test_fmm_velocity_matches_reference(level, p):
    _, _, jt, tt, _ = _random_case(1200, level * 3 + p, level)
    got = fmm.fmm_velocity(tt, p, device="cpu").numpy()
    assert _rel(got, jfmm.fmm_velocity(jt, p, use_kernels=False)) < 1e-5
    sing = fmm.fmm_velocity_singular(tt, p, device="cpu").numpy()
    assert _rel(sing, jfmm.fmm_velocity_singular(jt, p)) < 1e-5


def test_fmm_with_health_matches_reference():
    _, _, jt, tt, _ = _random_case(800, 1, 3)
    out, health = fmm.fmm_velocity(tt, 12, with_health=True, device="cpu")
    jout, jhealth = jfmm.fmm_velocity(jt, 12, with_health=True)
    assert _rel(out.numpy(), jout) < 1e-5
    np.testing.assert_array_equal(health.numpy(), np.asarray(jhealth))
    assert hw.ok(health) and jhw.ok(jhealth)
    # a NaN charge at a live slot trips the coefficient and velocity flags
    q = tt.q.clone()
    q[tt.mask.nonzero()[0].tolist()] = complex("nan")
    bad = type(tt)(z=tt.z, q=q, mask=tt.mask, level=tt.level, sigma=tt.sigma)
    _, health = fmm.fmm_velocity(bad, 12, with_health=True, device="cpu")
    assert health[hw.F_COEFF] == 1 and health[hw.F_VEL] == 1
    assert not hw.ok(health)


@pytest.mark.parametrize("level", [2, 3, 4])
def test_fmm_matches_direct_singular(level):
    pos, gamma, _, tt, index = _random_case(1500, level, level)
    w = fmm.fmm_velocity_singular(tt, 17, device="cpu")
    w_at = gather_particle_values(w, index).numpy()
    exact = vortex.direct_sum(pos[:, 0] + 1j * pos[:, 1], gamma, sigma=None)
    assert _rel(w_at, exact) < 2e-4  # f32 arithmetic floor


def test_fmm_p_convergence():
    """Truncation error decays with p (spectral convergence)."""
    pos, gamma, _, tt, index = _random_case(1200, 7, 3)
    exact = vortex.direct_sum(pos[:, 0] + 1j * pos[:, 1], gamma, sigma=None)
    errs = [_rel(gather_particle_values(
        fmm.fmm_velocity_singular(tt, p, device="cpu"), index).numpy(), exact)
        for p in (4, 8, 16)]
    assert errs[1] < errs[0] * 0.5
    assert errs[2] < errs[1]


def test_fmm_regularized_kernel_substitution():
    """Near field regularized, far field singular, against the regularized
    direct sum: small while sigma is well below the leaf box."""
    pos, gamma, _, tt, index = _random_case(2000, 9, 3)
    w = gather_particle_values(fmm.fmm_velocity(tt, 17, device="cpu"), index)
    exact = vortex.direct_sum(pos[:, 0] + 1j * pos[:, 1], gamma, sigma=0.02)
    assert _rel(w.numpy(), exact) < 5e-4


def test_numpy_oracles_are_the_reference_copies():
    from repro.core import vortex as jv
    rng = np.random.default_rng(2)
    z = rng.uniform(size=300) + 1j * rng.uniform(size=300)
    gamma = rng.normal(size=300)
    for sigma in (None, 0.02):
        np.testing.assert_array_equal(vortex.direct_sum(z, gamma, sigma, chunk=128),
                                      jv.direct_sum(z, gamma, sigma, chunk=128))
    for a, b in zip(vortex.lamb_oseen_particles(40), jv.lamb_oseen_particles(40)):
        np.testing.assert_array_equal(a, b)
    x, y = rng.uniform(size=50), rng.uniform(size=50)
    for a, b in zip(vortex.lamb_oseen_velocity(x, y, 1.0, 5e-4, 4.0),
                    jv.lamb_oseen_velocity(x, y, 1.0, 5e-4, 4.0)):
        np.testing.assert_array_equal(a, b)
    w = z.astype(np.complex64)
    u, v = vortex.velocity_from_w(torch.as_tensor(w))
    np.testing.assert_array_equal(u.numpy(), jv.velocity_from_w(w)[0])
    np.testing.assert_array_equal(v.numpy(), jv.velocity_from_w(w)[1])


def test_pairwise_forms_agree():
    """The complex-division ``pairwise_w`` and the real/imag ``p2p_terms``
    form agree to f32 roundoff."""
    rng = np.random.default_rng(3)
    zt = torch.as_tensor(rng.uniform(size=(4, 6)) + 1j * rng.uniform(size=(4, 6)),
                         dtype=torch.complex64)
    zs = torch.as_tensor(rng.uniform(size=(4, 7)) + 1j * rng.uniform(size=(4, 7)),
                         dtype=torch.complex64)
    qs = torch.as_tensor(rng.normal(size=(4, 7)) + 0j, dtype=torch.complex64)
    ms = torch.as_tensor(rng.uniform(size=(4, 7)) > 0.2)
    for sigma in (None, 0.1):
        a = eqs.VORTEX.pairwise(zt, zs, qs, ms, sigma)
        b = eqs.EquationSpec.pairwise(eqs.VORTEX, zt, zs, qs, ms, sigma)
        assert _rel(a.numpy(), b.numpy()) < 1e-6


def test_flops_estimate_matches_reference():
    for level, s, p in ((3, 4, 8), (10, 8, 17)):
        ref = jfmm.flops_estimate(level, s, p)
        got = fmm.flops_estimate(level, s, p)
        assert got == {k: ref[k] for k in got}


def test_equation_registry():
    assert eqs.get_equation(None) is eqs.VORTEX
    assert eqs.get_equation("vortex") is eqs.VORTEX
    with pytest.raises(ValueError, match="unknown equation"):
        eqs.get_equation("nope")
    assert eqs.register(eqs.VORTEX) is eqs.VORTEX

    class Other(eqs.EquationSpec):
        name = "vortex"

    with pytest.raises(ValueError, match="already registered"):
        eqs.register(Other())
    assert eqs.uses_base_p2p(eqs.VORTEX)


def test_fmm_rejects_a_tree_on_another_device():
    _, _, _, tt, _ = _random_case(100, 0, 2)
    with pytest.raises(ValueError, match="expected"):
        fmm.fmm_velocity(tt, 8, device="meta")
