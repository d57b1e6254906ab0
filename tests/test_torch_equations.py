"""The port's equation registry (``core/equations.py``) and its Laplace and
tracer evaluations against the reference and the f64 oracles.

Mirrors the serial part of ``tests/test_equations.py``: each registered
equation matches an independent f64 direct sum at p = 17 (singular at
interaction-list distance, regularized in the near field), with the
reference's own tolerances; the port's ``fmm_evaluate`` matches the
reference's plain route (``use_kernels=False``) on the same trees to rel
L2 1e-5; and the driver consumes only the spec.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import equations as jeqs
from repro.core import fmm as jfmm
from repro.core import quadtree as jqt
from repro_torch.core import equations as eqs
from repro_torch.core import fmm
from repro_torch.core.quadtree import (Tree, build_tree, gather_particle_values,
                                       tree_from_numpy)

ROOT = Path(__file__).resolve().parents[1]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _case(n=1500, seed=0, level=3, eq=eqs.VORTEX, sigma=0.02):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.02, 0.98, size=(n, 2))
    strength = rng.normal(size=n)
    tree, index = build_tree(pos, strength, level, sigma=sigma,
                             charge_scale=eq.charge_scale, device="cpu")
    return pos, strength, tree, index


def _singular(tree):
    return Tree(z=tree.z, q=tree.q, mask=tree.mask, level=tree.level,
                sigma=None)


def _probe_case(level=3, n_src=1500, n_tgt=800, seed=3):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.02, 0.98, size=(n_src, 2))
    strength = rng.normal(size=n_src)
    tpos = rng.uniform(0.05, 0.95, size=(n_tgt, 2))
    tree, _ = build_tree(pos, strength, level, sigma=0.02, device="cpu")
    targets, tindex = build_tree(tpos, np.zeros(n_tgt), level, sigma=0.02,
                                 device="cpu")
    return pos, strength, tpos, tree, targets, tindex


def _evaluate(tree, p, **kw):
    return fmm.fmm_evaluate(tree, p, device="cpu", **kw).numpy()


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


def test_registry_contents_and_hashing():
    assert set(eqs.EQUATIONS) >= {"vortex", "laplace", "tracer"}
    assert eqs.get_equation(None) is eqs.VORTEX
    assert eqs.get_equation("laplace") is eqs.LAPLACE
    assert eqs.get_equation(eqs.TRACER) is eqs.TRACER
    with pytest.raises(ValueError, match="unknown equation"):
        eqs.get_equation("navier-stokes")
    assert hash(eqs.LAPLACE) == hash(eqs.LaplaceEquation())
    assert eqs.LAPLACE == eqs.LaplaceEquation()
    assert eqs.LAPLACE != eqs.VORTEX
    assert eqs.VORTEX.nout == 1 and eqs.LAPLACE.nout == 2
    assert eqs.TRACER.needs_targets and not eqs.VORTEX.needs_targets
    for name in ("vortex", "laplace", "tracer"):
        mine, ref = eqs.get_equation(name), jeqs.get_equation(name)
        for attr in ("nout", "q_is_real", "needs_targets", "l2p_modes",
                     "charge_scale", "default_p"):
            assert getattr(mine, attr) == getattr(ref, attr), (name, attr)


def test_register_refuses_silent_replacement():
    class Variant(eqs.LaplaceEquation):
        pass

    v = Variant()
    assert v.name == "laplace"
    assert v != eqs.LAPLACE and hash(v) != hash(eqs.LAPLACE)
    with pytest.raises(ValueError, match="already registered"):
        eqs.register(v)
    assert eqs.register(eqs.LAPLACE) is eqs.LAPLACE

    class Custom(eqs.EquationSpec):
        name = "custom-test-eq"

    try:
        assert eqs.register(Custom()) == Custom()
        assert eqs.get_equation("custom-test-eq") == Custom()
    finally:
        eqs.EQUATIONS.pop("custom-test-eq", None)


def test_p2p_mode_names_the_kernel_formula_by_class():
    """The mode follows the ``p2p_terms`` a class carries, never its name."""
    assert eqs.p2p_mode(eqs.VORTEX) == "base"
    assert eqs.p2p_mode(eqs.TRACER) == "base"
    assert eqs.p2p_mode(eqs.LAPLACE) == "laplace"

    class RenamedLaplace(eqs.LaplaceEquation):
        name = "potential"

    class Doubled(eqs.EquationSpec):
        name = "vortex"

        def p2p_terms(self, *args):
            return [(2 * a, 2 * b) for a, b in super().p2p_terms(*args)]

    class Wider(eqs.EquationSpec):
        nout = 2

    assert eqs.p2p_mode(RenamedLaplace()) == "laplace"
    assert eqs.p2p_mode(Doubled()) is None
    assert eqs.p2p_mode(Wider()) is None


def test_resolve_job_spec():
    assert eqs.resolve_job_spec(None) is eqs.VORTEX
    assert eqs.resolve_job_spec("laplace") is eqs.LAPLACE
    assert eqs.resolve_job_spec("tracer", have_targets=True) is eqs.TRACER
    assert eqs.resolve_job_spec("vortex", steps=5) is eqs.VORTEX
    with pytest.raises(ValueError, match="requires a probe/target set"):
        eqs.resolve_job_spec("tracer")
    with pytest.raises(ValueError, match="evaluation-only"):
        eqs.resolve_job_spec("laplace", steps=3)
    with pytest.raises(ValueError, match="unknown equation"):
        eqs.resolve_job_spec("nope")


# ---------------------------------------------------------------------------
# Laplace operators: bit for bit the reference's numpy arrays
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", [2, 8, 16, 17])
@pytest.mark.parametrize("level", [2, 5, 10])
def test_laplace_operators_equal_reference(p, level):
    np.testing.assert_array_equal(eqs._laplace_m2m_operator(p),
                                  jeqs._laplace_m2m_operator(p))
    np.testing.assert_array_equal(eqs._laplace_m2l_base(p, level),
                                  jeqs._laplace_m2l_base(p, level))
    np.testing.assert_array_equal(eqs._laplace_m2l_folded(p, level),
                                  jeqs._laplace_m2l_folded(p, level))
    np.testing.assert_array_equal(eqs.LAPLACE.m2l_folded(p, level),
                                  jeqs.LAPLACE.m2l_folded(p, level))
    np.testing.assert_array_equal(eqs.LAPLACE.p2m_coeff(p),
                                  jeqs.LAPLACE.p2m_coeff(p))
    assert eqs.LAPLACE.m2l_scale(level) == jeqs.LAPLACE.m2l_scale(level) == 1.0


@pytest.mark.parametrize("name", ["vortex", "laplace", "tracer"])
@pytest.mark.parametrize("sigma", [None, 0.02])
def test_direct_sum_is_the_reference_oracle(name, sigma):
    rng = np.random.default_rng(4)
    z = rng.uniform(size=300) + 1j * rng.uniform(size=300)
    zt = np.concatenate([z[:50], rng.uniform(size=40) + 1j * rng.uniform(size=40)])
    strength = rng.normal(size=300)
    np.testing.assert_array_equal(
        eqs.direct_sum(name, zt, z, strength, sigma, chunk=64),
        jeqs.direct_sum(name, zt, z, strength, sigma, chunk=64))


# ---------------------------------------------------------------------------
# Laplace: potential + field from one downward sweep, vs f64 direct sums
# ---------------------------------------------------------------------------


def test_laplace_matches_direct_singular_p17():
    pos, strength, tree, index = _case(eq=eqs.LAPLACE)
    z = pos[:, 0] + 1j * pos[:, 1]
    out = _evaluate(_singular(tree), 17, eq=eqs.LAPLACE)
    assert out.shape == tuple(tree.z.shape) + (2,)
    exact = eqs.direct_sum(eqs.LAPLACE, z, z, strength, sigma=None)
    pot = gather_particle_values(out[..., 0], index)
    fld = gather_particle_values(out[..., 1], index)
    assert _rel(pot.real, exact[:, 0].real) < 1e-5
    assert _rel(fld, exact[:, 1]) < 5e-5          # f32 floor (cf. vortex)


def test_laplace_matches_direct_regularized_p17():
    pos, strength, tree, index = _case(eq=eqs.LAPLACE)
    z = pos[:, 0] + 1j * pos[:, 1]
    out = _evaluate(tree, 17, eq=eqs.LAPLACE)
    exact = eqs.direct_sum(eqs.LAPLACE, z, z, strength, sigma=0.02)
    assert _rel(gather_particle_values(out[..., 0], index).real,
                exact[:, 0].real) < 1e-5
    assert _rel(gather_particle_values(out[..., 1], index),
                exact[:, 1]) < 1e-5


def test_laplace_field_is_negated_vortex():
    """For real charges the Laplace field ``-q/(z - z_j)`` equals the
    negated vortex velocity computed by the independent velocity-kernel
    operators."""
    _, _, tree, _ = _case(eq=eqs.LAPLACE)
    sing = _singular(tree)
    fld = _evaluate(sing, 17, eq=eqs.LAPLACE)[..., 1]
    w = _evaluate(sing, 17, eq=eqs.VORTEX)
    assert _rel(fld, -w) < 1e-6


def test_laplace_p_convergence():
    pos, strength, tree, index = _case(n=1200, seed=7, eq=eqs.LAPLACE)
    z = pos[:, 0] + 1j * pos[:, 1]
    exact = eqs.direct_sum(eqs.LAPLACE, z, z, strength, sigma=None)
    errs = []
    for p in (4, 8, 16):
        out = _evaluate(_singular(tree), p, eq=eqs.LAPLACE)
        errs.append(_rel(gather_particle_values(out[..., 0], index).real,
                         exact[:, 0].real))
    assert errs[1] < errs[0] * 0.5
    assert errs[2] < errs[1]


def test_real_charge_equation_reads_only_re_q():
    """Laplace on a tree built with the vortex's complex charge scale acts
    as if q were projected to its real part."""
    rng = np.random.default_rng(5)
    pos = rng.uniform(0.02, 0.98, size=(800, 2))
    bad, _ = build_tree(pos, rng.normal(size=800), 3, sigma=0.02, device="cpu")
    proj = Tree(z=bad.z, q=torch.complex(bad.q.real, torch.zeros_like(bad.q.real)),
                mask=bad.mask, level=bad.level, sigma=bad.sigma)
    np.testing.assert_array_equal(_evaluate(bad, 10, eq=eqs.LAPLACE),
                                  _evaluate(proj, 10, eq=eqs.LAPLACE))


# ---------------------------------------------------------------------------
# Tracer: passive source != target evaluation
# ---------------------------------------------------------------------------


def test_tracer_matches_direct():
    pos, strength, tpos, tree, targets, tindex = _probe_case()
    z = pos[:, 0] + 1j * pos[:, 1]
    tz = tpos[:, 0] + 1j * tpos[:, 1]
    exact = eqs.direct_sum(eqs.TRACER, tz, z, strength, sigma=0.02)
    out = _evaluate(tree, 17, eq=eqs.TRACER, targets=targets)
    assert out.shape == tuple(targets.z.shape)
    assert _rel(gather_particle_values(out, tindex), exact) < 5e-5


def test_tracer_requires_targets():
    _, _, tree, _ = _case()
    with pytest.raises(ValueError, match="requires a targets tree"):
        fmm.fmm_evaluate(tree, 8, eq=eqs.TRACER, device="cpu")


def test_targets_must_share_the_level_and_device():
    _, _, tpos, tree, _, _ = _probe_case()
    other, _ = build_tree(tpos, np.zeros(len(tpos)), 4, sigma=0.02, device="cpu")
    with pytest.raises(ValueError, match="level"):
        fmm.fmm_evaluate(tree, 8, eq=eqs.TRACER, targets=other, device="cpu")
    meta = Tree(z=tree.z.to("meta"), q=tree.q.to("meta"),
                mask=tree.mask.to("meta"), level=tree.level, sigma=tree.sigma)
    with pytest.raises(ValueError, match="expected"):
        fmm.fmm_evaluate(tree, 8, eq=eqs.TRACER, targets=meta, device="cpu")


def test_laplace_at_probe_targets():
    rng = np.random.default_rng(11)
    pos = rng.uniform(0.02, 0.98, size=(1200, 2))
    strength = rng.normal(size=1200)
    tpos = rng.uniform(0.1, 0.9, size=(500, 2))
    tree, _ = build_tree(pos, strength, 3, sigma=0.02,
                         charge_scale=eqs.LAPLACE.charge_scale, device="cpu")
    targets, tindex = build_tree(tpos, np.zeros(500), 3, sigma=0.02, device="cpu")
    out = _evaluate(tree, 17, eq=eqs.LAPLACE, targets=targets)
    assert out.shape == tuple(targets.z.shape) + (2,)
    z = pos[:, 0] + 1j * pos[:, 1]
    tz = tpos[:, 0] + 1j * tpos[:, 1]
    exact = eqs.direct_sum(eqs.LAPLACE, tz, z, strength, sigma=0.02)
    assert _rel(gather_particle_values(out[..., 0], tindex).real,
                exact[:, 0].real) < 1e-5
    assert _rel(gather_particle_values(out[..., 1], tindex),
                exact[:, 1]) < 1e-5


# ---------------------------------------------------------------------------
# The port's fmm_evaluate against the reference's plain route
# ---------------------------------------------------------------------------


def _ref_and_port_trees(pos, strength, level, sigma, charge_scale):
    jt, _ = jqt.build_tree(pos, strength, level, sigma=0.02,
                           charge_scale=charge_scale)
    jt = jqt.Tree(z=jt.z, q=jt.q, mask=jt.mask, level=level, sigma=sigma)
    tt = tree_from_numpy(np.asarray(jt.z), np.asarray(jt.q), np.asarray(jt.mask),
                         level, sigma, device="cpu")
    return jt, tt


@pytest.mark.parametrize("case", ["laplace", "tracer", "laplace_at_targets"])
@pytest.mark.parametrize("level", [1, 3, 4])
@pytest.mark.parametrize("sigma", [None, 0.02])
def test_fmm_evaluate_matches_reference(case, level, sigma):
    rng = np.random.default_rng(level * 10 + (sigma is None))
    pos = rng.uniform(0.02, 0.98, size=(1500, 2))
    strength = rng.normal(size=1500)
    tpos = rng.uniform(0.05, 0.95, size=(700, 2))
    name = case.split("_")[0]
    jeq, eq = jeqs.get_equation(name), eqs.get_equation(name)
    jt, tt = _ref_and_port_trees(pos, strength, level, sigma, jeq.charge_scale)
    jtg = ttg = None
    if case != "laplace":
        jtg, ttg = _ref_and_port_trees(tpos, np.zeros(len(tpos)), level, sigma,
                                       None)
    want = np.asarray(jfmm.fmm_evaluate(jt, 17, eq=jeq, targets=jtg,
                                        use_kernels=False))
    got = _evaluate(tt, 17, eq=eq, targets=ttg)
    assert got.shape == want.shape
    mask = np.asarray((jt if jtg is None else jtg).mask)
    m = mask if got.ndim == 3 else mask[..., None]
    assert _rel(np.where(m, got, 0), np.where(m, want, 0)) < 1e-5
    assert np.all(got[~mask] == 0)


def test_fmm_evaluate_with_health_covers_the_targets():
    _, _, _, tree, targets, _ = _probe_case()
    out, health = fmm.fmm_evaluate(tree, 12, eq=eqs.TRACER, targets=targets,
                                   with_health=True, device="cpu")
    jt, jtg = (jqt.Tree(z=t.z.numpy(), q=t.q.numpy(), mask=t.mask.numpy(),
                        level=t.level, sigma=t.sigma) for t in (tree, targets))
    jout, jhealth = jfmm.fmm_evaluate(jt, 12, eq=jeqs.TRACER, targets=jtg,
                                      with_health=True)
    np.testing.assert_array_equal(health.numpy(), np.asarray(jhealth))
    assert _rel(out.numpy(), np.asarray(jout)) < 1e-5


def test_fmm_driver_has_no_equation_branches():
    """The port's slab path consumes only the spec: the reference's
    ``no-equation-branches`` lint rule finds nothing in it, and does find a
    planted branch."""
    from repro.analysis.lint import EquationBranchRule, lint_source, run_lint

    rule = EquationBranchRule()
    files = [ROOT / "src" / "repro_torch" / rel for rel in
             ("core/fmm.py", "kernels/ops.py", "kernels/m2l.py", "kernels/p2p.py")]
    for f in files:
        assert rule.applies(str(f)), f
        findings = run_lint(f, rules=[rule])
        assert findings == [], "\n".join(str(x) for x in findings)
    planted = "def f(eq):\n    if eq.name == 'laplace':\n        return 1\n"
    assert lint_source(planted, str(files[0]), [rule])
