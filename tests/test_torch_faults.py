"""Fault injection and the recovery ladder of the port's serial stepper,
against the reference's serial stepper (``mesh=None``, jnp route).

The inputs are those of ``tests/test_faults.py``: 300 particles from
``default_rng(1)``, sigma 0.02, p = 6, dt = 0.002, here on one device.
Every drill must record the same rung names in both packages and end
within 5e-5 of the reference's positions (particles matched by an id
carried as payload); plain-retry recoveries must also equal the port's
own unfaulted run bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import faults as jflt
from repro.core import stepper as jst
from repro_torch.core import faults as flt
from repro_torch.core import health as hw
from repro_torch.core import stepper as st
from repro_torch.kernels import ops

rng = np.random.default_rng(1)
POS = 0.02 + 0.96 * rng.random((300, 2))
GAMMA = rng.standard_normal(300) * 0.1
KW = dict(sigma=0.02, p=6, dt=0.002, payload={"id": np.arange(300) + 0j})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the CPU route runs hundreds of small ops a
    step, and under the suite's parallel workers their threads would
    oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(faults=None, steps=3, **extra):
    s = st.VortexStepper(POS, GAMMA, faults=faults, device="cpu", **KW, **extra)
    return s, [s.step() for _ in range(steps)]


def _ref(faults=None, steps=3, **extra):
    s = jst.VortexStepper(POS, GAMMA, faults=faults, **KW, **extra)
    return s, [s.step() for _ in range(steps)]


def _specs(mod, *specs):
    return mod.FaultInjector(*(mod.FaultSpec(*a, **k) for a, k in specs))


def _by_id(stepper):
    """Physical positions indexed by particle id, and the domain."""
    pos, _ = stepper.particles()
    ids = np.rint(stepper._gather_payload_values()["id"].real).astype(int)
    out = np.full((300, 2), np.nan)
    out[ids] = pos
    return out


def _state(s):
    return [torch.as_tensor(np.array(a)) for a in
            (s.tree.z, s.tree.q, s.tree.mask, s.payload["id"])]


def _same_records(a, b):
    assert [(r.recovered, r.releveled, r.replanned, r.level, r.health)
            for r in a] == [(r.recovered, r.releveled, r.replanned, r.level,
                             r.health) for r in b]


@pytest.fixture(scope="module")
def unfaulted():
    port, precs = _port()
    ref, rrecs = _ref()
    return port, precs, ref, rrecs


# ---------------------------------------------------------------------------
# Specs and the injector
# ---------------------------------------------------------------------------


def test_fault_spec_validation_and_rank():
    with pytest.raises(ValueError, match="unknown fault site"):
        flt.FaultSpec("bitflip", step=1)
    with pytest.raises(ValueError):
        jflt.FaultSpec("bitflip", step=1)
    assert flt.SITES == jflt.SITES
    f = flt.FaultSpec("proc_kill", step=3, device=2)
    assert f.rank == 2 and hash(f) == hash(flt.FaultSpec("proc_kill", 3, 2))
    with pytest.raises(dataclasses.FrozenInstanceError):
        f.step = 4
    assert [x.name for x in dataclasses.fields(flt.FaultSpec)] == \
        [x.name for x in dataclasses.fields(jflt.FaultSpec)]


def test_injector_queries_match_reference():
    specs = [(("teleport",), dict(step=2, magnitude=0.6)),
             (("overflow",), dict(step=2, sticky=True)),
             (("halo_nan",), dict(step=3, device=1, only_grid=(2, 2))),
             (("tile_corrupt",), dict(step=1, sticky=True)),
             (("time_inflate",), dict(step=3, magnitude=50.0)),
             (("time_inflate",), dict(step=3, magnitude=2.0)),
             (("proc_kill",), dict(step=4, device=2)),
             (("proc_hang",), dict(step=5, device=1))]
    port, ref = _specs(flt, *specs), _specs(jflt, *specs)
    fields = lambda fs: [dataclasses.astuple(f) for f in fs]  # noqa: E731
    for step in range(6):
        for attempt in range(3):
            assert fields(port.active(step, attempt)) == \
                fields(ref.active(step, attempt))
        assert port.time_factor(step) == ref.time_factor(step)
    assert fields(port.proc_faults()) == fields(ref.proc_faults())


# ---------------------------------------------------------------------------
# Device-side corruption, bit for bit
# ---------------------------------------------------------------------------


def _grid(seed, shape=(6, 6, 5), dtype=np.complex64):
    r = np.random.default_rng(seed)
    z = (r.random(shape) + 1j * r.random(shape)).astype(dtype)
    mask = r.random(shape) < 0.6
    return z, mask


@pytest.mark.parametrize("specs", [
    [(("teleport",), dict(step=1, magnitude=0.6))],
    [(("teleport",), dict(step=1, magnitude=-0.25))],
    [(("overflow",), dict(step=1))],
    [(("teleport",), dict(step=1, magnitude=0.3)), (("overflow",), dict(step=1))],
    [(("halo_nan",), dict(step=1))]])
def test_corrupt_positions_matches_reference(specs):
    import jax.numpy as jnp
    z, mask = _grid(0)
    got = flt.corrupt_positions(torch.as_tensor(z), torch.as_tensor(mask),
                                _specs(flt, *specs).active(1))
    want = jflt.corrupt_positions(jnp.asarray(z), jnp.asarray(mask),
                                  _specs(jflt, *specs).active(1))
    assert got.dtype == torch.complex64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", [np.complex64, np.float32])
@pytest.mark.parametrize("device_index", [0, 1])
@pytest.mark.parametrize("grid", [(4, 1), (2, 2)])
def test_corrupt_halo_and_tile_match_reference(dtype, device_index, grid):
    import jax.numpy as jnp
    z, _ = _grid(1, (3, 8, 4))
    buf = z if dtype == np.complex64 else z.real.copy()
    specs = [(("halo_nan",), dict(step=1, device=1)),
             (("halo_nan",), dict(step=1, device=0, only_grid=(2, 2))),
             (("tile_corrupt",), dict(step=1, device=1))]
    pf, jf = _specs(flt, *specs).active(1), _specs(jflt, *specs).active(1)
    got = flt.corrupt_halo(torch.as_tensor(buf), pf, device_index, grid)
    want = jflt.corrupt_halo(jnp.asarray(buf), jf, jnp.int32(device_index), grid)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = flt.corrupt_tile(torch.as_tensor(buf), pf, device_index)
    want = jflt.corrupt_tile(jnp.asarray(buf), jf, jnp.int32(device_index))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Serial drills against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("site,kw,rung", [
    ("teleport", dict(magnitude=0.6), "retry_1"),
    ("overflow", {}, "retry_1"),
    # the sharded driver's sites land nowhere on one device
    ("halo_nan", {}, ""),
    ("tile_corrupt", {}, "")])
def test_transient_fault_recovers_bit_exact(unfaulted, site, kw, rung):
    """A non-sticky fault fires on attempt 0 only: the plain retry re-runs
    the same computation from the intact pre-step tree, so the state is
    the unfaulted run's bit for bit, and the rungs are the reference's."""
    port0, _, _, _ = unfaulted
    specs = [((site,), dict(step=2, **kw))]
    port, precs = _port(_specs(flt, *specs))
    ref, rrecs = _ref(_specs(jflt, *specs))
    assert precs[1].recovered == rung
    if rung:
        assert precs[1].health != 0 and hw.ok(hw.unpack(precs[1].health))
    assert precs[0].recovered == "" and precs[2].recovered == ""
    _same_records(precs, rrecs)
    for a, b in zip(_state(port), _state(port0)):
        assert torch.equal(a, b)
    np.testing.assert_allclose(_by_id(port), _by_id(ref), rtol=0, atol=5e-5)


def test_unfaulted_run_matches_reference(unfaulted):
    port, precs, ref, rrecs = unfaulted
    _same_records(precs, rrecs)
    assert dataclasses.asdict(port.params) == dataclasses.asdict(ref.params)
    np.testing.assert_allclose(_by_id(port), _by_id(ref), rtol=0, atol=5e-5)


def test_sticky_teleport_recovers_via_domain_expansion(unfaulted):
    """A sticky teleport whose physical magnitude fits a doubled root box
    escalates past retry, half dt and re-level to the domain expansion;
    after it every particle is kept, finite and inside the domain."""
    specs = [(("teleport",), dict(step=2, sticky=True, magnitude=0.6))]
    port, precs = _port(_specs(flt, *specs))
    ref, rrecs = _ref(_specs(jflt, *specs))
    assert precs[1].recovered == "expand_domain", precs[1]
    _same_records(precs, rrecs)
    assert port.domain.size >= 2.0
    assert (port.domain.origin, port.domain.size) == \
        (ref.domain.origin, ref.domain.size)
    pos = _by_id(port)
    assert np.isfinite(pos).all()
    u = port.domain.to_unit(pos)
    assert (u >= 0).all() and (u <= 1).all()
    np.testing.assert_allclose(pos, _by_id(ref), rtol=0, atol=5e-5)
    _, g0 = unfaulted[0].particles()
    _, g1 = port.particles()
    np.testing.assert_allclose(np.sort(g1), np.sort(g0), rtol=1e-5)


def test_transient_fault_recovers_on_the_reference_rung():
    """With every rung before it off, the ladder's reference rung runs the
    kernels' plain versions (counted by ``ops.PLAIN_CALLS``) and rescues a
    transient fault, as in the reference."""
    pol = dict(max_retries=0, halve_dt=False, relevel=False,
               expand_domain=False)
    specs = [(("teleport",), dict(step=2, magnitude=0.6))]
    ops.PLAIN_CALLS = 0
    port, precs = _port(_specs(flt, *specs), policy=st.RecoveryPolicy(**pol))
    level = port.params.level
    # one rk2 attempt: two evaluations, each one P2P, one P2M, one L2P and
    # level - 1 M2L
    assert ops.PLAIN_CALLS == 2 * (3 + level - 1)
    ref, rrecs = _ref(_specs(jflt, *specs), policy=jst.RecoveryPolicy(**pol))
    assert precs[1].recovered == "reference"
    _same_records(precs, rrecs)
    np.testing.assert_allclose(_by_id(port), _by_id(ref), rtol=0, atol=5e-5)


def test_unrecoverable_fault_raises_typed_error_with_report():
    """A sticky overflow defeats every compute rung; with no checkpoint
    the stepper raises the typed error with the reference's rung list,
    and the pre-step state survives the failed attempts."""
    specs = [(("overflow",), dict(step=2, sticky=True))]
    reports = []
    for mod, smod, kw in ((flt, st, dict(device="cpu")), (jflt, jst, {})):
        s = smod.VortexStepper(POS, GAMMA, faults=_specs(mod, *specs), **KW, **kw)
        s.step()
        with pytest.raises(smod.StepperFaultError) as e:
            s.step()
        assert s.step_count == 1
        reports.append(e.value.report)
    port, ref = reports
    rungs = [a["rung"] for a in port.attempts]
    assert rungs == [a["rung"] for a in ref.attempts]
    assert rungs[0] == "step" and "reference" in rungs and len(rungs) >= 3
    assert port.step == 2 and port.attempts[0]["health"]["leaf_overflow"] == 1
    assert [a["health"] for a in port.attempts] == \
        [a["health"] for a in ref.attempts]
    assert "unrecoverable" in str(port)
    assert (port.plan, port.level, port.dt) == (ref.plan, ref.level, ref.dt)


def test_rollback_restores_last_checkpoint_bit_exact(tmp_path):
    """With every compute rung off, a sticky fault falls through to the
    rollback rung: the stepper restores the last snapshot bit-exact and
    does NOT advance; a second encounter of the same step raises."""
    off = dict(max_retries=0, halve_dt=False, relevel=False,
               expand_domain=False, plan_fallback=False, reference_route=False)
    specs = [(("teleport",), dict(step=3, sticky=True, magnitude=2.0))]
    rungs = []
    for mod, smod, kw in ((flt, st, dict(device="cpu")), (jflt, jst, {})):
        s = smod.VortexStepper(
            POS, GAMMA, faults=_specs(mod, *specs),
            policy=smod.RecoveryPolicy(**off),
            checkpoint_dir=str(tmp_path / mod.__name__), checkpoint_every=1,
            **KW, **kw)
        s.step()
        s.step()
        s._ckpt.wait()
        before = _state(s)
        rec = s.step()
        assert rec.recovered == "rollback" and s.step_count == 2
        for a, b in zip(_state(s), before):
            assert torch.equal(a, b)
        with pytest.raises(smod.StepperFaultError) as e:
            s.step()
        assert e.value.report.step == 3
        rungs.append([a["rung"] for a in e.value.report.attempts])
    assert rungs[0] == rungs[1] == ["step"]


def test_time_inflation_does_not_thrash_replanning():
    """One corrupted wall-clock sample: the dynamic stepper replans as it
    does without it, and the median/clip filter moves the estimate < 2x."""
    def plans(faults):
        s, recs = _port(faults, steps=6, dynamic=True, replan_every=2)
        t = st.host_wallclock_times(s)
        assert t is None or np.isfinite(t).all()
        return [r.replanned for r in recs], s.plan
    base_flags, base_plan = plans(None)
    inf_flags, inf_plan = plans(_specs(
        flt, (("time_inflate",), dict(step=3, magnitude=50.0))))
    assert inf_plan == base_plan and inf_flags == base_flags
    clean = [0.01, 0.011, 0.009, 0.0105]
    assert st.robust_wall(clean + [0.5]) < 2 * st.robust_wall(clean)
    assert st.robust_wall(clean + [0.5]) == jst.robust_wall(clean + [0.5])
