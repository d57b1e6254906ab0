"""Two RK2 steps of the port against the reference's serial plain route.

The lattice keeps every particle well inside its leaf box, so the f32
roundoff between the two routes cannot move a particle across a box edge:
the rebinned trees must then agree in every mask bit, and positions to
1e-6 absolute.
"""
import dataclasses
import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import quadtree as jqt
from repro.core import stepper as jst
from repro_torch.core import health as hw
from repro_torch.core import quadtree as qt
from repro_torch.core.stepper import VortexStepper, rk2_step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the CPU route runs hundreds of small ops a
    step, and under the suite's parallel workers their threads would
    oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lattice(level=3, per_side=3, seed=0):
    """``per_side**2`` particles per leaf box at 30-70% of its width."""
    n, h = 1 << level, qt.box_size(level)
    offs = np.linspace(0.3, 0.7, per_side)
    cells = np.arange(n)
    x = ((cells[:, None] + offs[None, :]) * h).ravel()
    X, Y = np.meshgrid(x, x, indexing="xy")
    pos = np.stack([X.ravel(), Y.ravel()], axis=1)
    gamma = 0.01 * np.random.default_rng(seed).normal(size=len(pos))
    return pos, gamma


@pytest.mark.parametrize("guard,with_payload,p", [(True, True, 8),
                                                  (False, False, 17)])
def test_two_rk2_steps_match_reference(guard, with_payload, p):
    pos, gamma = _lattice()
    level, dt, slots = 3, 0.01, 12
    jt, _ = jqt.build_tree(pos, gamma, level=level, sigma=0.02, slots=slots)
    tt, _ = qt.build_tree(pos, gamma, level=level, sigma=0.02, slots=slots,
                          device="cpu")
    label = np.arange(np.asarray(jt.z).size, dtype=np.int32).reshape(jt.z.shape)
    jpay = jnp.asarray(label) if with_payload else None
    tpay = torch.as_tensor(label) if with_payload else None
    for _ in range(2):
        jt, jpay, jok, jocc, jh = jst.rk2_step(jt, dt, jpay, p=p, guard=guard)
        tt, tpay, tok, tocc, th = rk2_step(tt, dt, tpay, p=p, guard=guard,
                                           device="cpu")
        np.testing.assert_array_equal(tt.mask.numpy(), np.asarray(jt.mask))
        np.testing.assert_allclose(tt.z.numpy(), np.asarray(jt.z), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tt.q.numpy(), np.asarray(jt.q))
        assert bool(tok) == bool(jok) and int(tocc) == int(jocc)
        if with_payload:
            np.testing.assert_array_equal(tpay.numpy(), np.asarray(jpay))
        if guard:
            np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
            assert hw.ok(th)
        else:
            assert th is None and jh is None
    # the particles moved, and none crossed a box edge
    start, _ = qt.build_tree(pos, gamma, level=level, sigma=0.02, slots=slots,
                             device="cpu")
    assert not torch.equal(tt.z, start.z)
    assert torch.equal(tt.mask, start.mask)


def test_rk2_step_flags_overflow_like_reference():
    """A step that packs particles past the slot capacity: ok is False, the
    health word carries the overflow bit and the dropped count."""
    pos, gamma = _lattice(level=2, per_side=3, seed=1)
    gamma = gamma * 0.0
    gamma[0] = 50.0          # one strong vortex sweeps its neighbours along
    jt, _ = jqt.build_tree(pos, gamma, level=2, sigma=0.02, slots=9)
    tt, _ = qt.build_tree(pos, gamma, level=2, sigma=0.02, slots=9, device="cpu")
    jr = jst.rk2_step(jt, 0.02, p=8, guard=True)
    tr = rk2_step(tt, 0.02, p=8, guard=True, device="cpu")
    assert not bool(tr[2]) and not bool(jr[2])
    assert int(tr[3]) == int(jr[3])
    np.testing.assert_array_equal(tr[4].numpy(), np.asarray(jr[4]))
    assert tr[4][hw.F_OVERFLOW] == 1 and tr[4][hw.F_DROPPED] > 0
    assert not hw.ok(tr[4])


# ---------------------------------------------------------------------------
# rk2_step's fault and plain arguments
# ---------------------------------------------------------------------------


def _tree_state(out):
    t, pay, ok, occ, h = out
    return [t.z, t.q, t.mask, pay, ok, occ, h]


def _assert_same(a, b):
    for x, y in zip(a, b):
        assert (x is None and y is None) or torch.equal(x, y)


def test_rk2_step_without_faults_is_the_plain_call():
    """``faults=()`` and specs that land nowhere on one device run exactly
    the injection-free step."""
    from repro_torch.core.faults import FaultSpec
    pos, gamma = _lattice()
    tt, _ = qt.build_tree(pos, gamma, level=3, sigma=0.02, slots=12, device="cpu")
    pay = torch.arange(tt.z.numel(), dtype=torch.int32).reshape(tt.z.shape)
    base = rk2_step(tt, 0.01, pay, p=8, guard=True, device="cpu")
    for faults in ((), (FaultSpec("halo_nan", 1), FaultSpec("tile_corrupt", 1))):
        _assert_same(_tree_state(rk2_step(tt, 0.01, pay, p=8, guard=True,
                                          faults=faults, device="cpu")),
                     _tree_state(base))


def test_rk2_step_plain_route_equals_the_default_on_cpu():
    """On the CPU both routes are the kernels' plain versions: bit for bit,
    and only the explicit request is counted."""
    from repro_torch.kernels import ops
    pos, gamma = _lattice()
    tt, _ = qt.build_tree(pos, gamma, level=3, sigma=0.02, slots=12, device="cpu")
    ops.PLAIN_CALLS = 0
    base = rk2_step(tt, 0.01, p=8, guard=True, device="cpu")
    assert ops.PLAIN_CALLS == 0
    plain = rk2_step(tt, 0.01, p=8, guard=True, plain=True, device="cpu")
    _assert_same(_tree_state(plain), _tree_state(base))
    # two evaluations, each one P2P, one P2M, one L2P and one M2L per
    # level 2..3
    assert ops.PLAIN_CALLS == 2 * (3 + 2)


@pytest.mark.parametrize("kernel", ["p2p", "m2l", "p2m", "l2p"])
def test_plain_route_refuses_tensors_off_the_cpu(kernel):
    """``plain=True`` is the CPU's route: a tensor on any other device
    (here the meta device, which has no data) raises before a plain call
    is counted, so on the card a kernel launches or raises."""
    from repro_torch.core import expansions as ex
    from repro_torch.kernels import ops
    ops.PLAIN_CALLS = 0
    if kernel == "p2p":
        z = torch.zeros(6, 6, 8, dtype=torch.complex64, device="meta")
        mask = torch.zeros(6, 6, 8, dtype=torch.bool, device="meta")
        call = lambda: ops.p2p_apply_slab(z, z, mask, 0.01, plain=True)  # noqa: E731
    elif kernel == "m2l":
        me = torch.zeros(4 + 2 * ex.M2L_HALO, 4, 8, dtype=torch.complex64,
                         device="meta")
        call = lambda: ops.m2l_apply_slab(me, 2, 8, plain=True)  # noqa: E731
    else:
        z = torch.zeros(4, 4, 8, dtype=torch.complex64, device="meta")
        mask = torch.zeros(4, 4, 8, dtype=torch.bool, device="meta")
        cen = torch.zeros(4, 4, dtype=torch.complex64, device="meta")
        le = torch.zeros(4, 4, 6, dtype=torch.complex64, device="meta")
        p2m = functools.partial(ops.p2m_apply, plain=True)
        l2p = functools.partial(ops.l2p_apply, plain=True)
        call = ((lambda: ex.p2m(z, z, mask, cen, 0.25, 6, compute=p2m))  # noqa: E731
                if kernel == "p2m" else
                (lambda: ex.l2p_eval(le, z, cen, 0.25, 6, compute=l2p)))  # noqa: E731
    with pytest.raises(ValueError, match="CPU tensors only"):
        call()
    assert ops.PLAIN_CALLS == 0


def test_rk2_step_teleport_matches_reference():
    from repro.core.faults import FaultSpec as JSpec
    from repro_torch.core.faults import FaultSpec
    pos, gamma = _lattice()
    jt, _ = jqt.build_tree(pos, gamma, level=3, sigma=0.02, slots=12)
    tt, _ = qt.build_tree(pos, gamma, level=3, sigma=0.02, slots=12, device="cpu")
    jr = jst.rk2_step(jt, 0.01, p=8, guard=True,
                      faults=(JSpec("teleport", 1, magnitude=0.05),))
    tr = rk2_step(tt, 0.01, p=8, guard=True, device="cpu",
                  faults=(FaultSpec("teleport", 1, magnitude=0.05),))
    np.testing.assert_array_equal(tr[0].mask.numpy(), np.asarray(jr[0].mask))
    np.testing.assert_allclose(tr[0].z.numpy(), np.asarray(jr[0].z), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(tr[4].numpy(), np.asarray(jr[4]))


def test_debug_nan_names_the_first_stage():
    """Under ``set_debug_nan(True)`` a NaN position stops ``fmm_evaluate``
    at the first stage whose output it reaches; off, the step runs and the
    health word flags it instead."""
    from repro_torch.configs import backend
    from repro_torch.core.fmm import fmm_velocity
    pos, gamma = _lattice()
    tt, _ = qt.build_tree(pos, gamma, level=3, sigma=0.02, slots=12, device="cpu")
    z = tt.z.clone()
    z[3, 3, 0] = complex("nan+nanj")
    bad = qt.Tree(z=z, q=tt.q, mask=tt.mask, level=3, sigma=0.02)
    out = rk2_step(bad, 0.01, p=8, guard=True, device="cpu")
    assert not hw.ok(out[4])
    backend.set_debug_nan(True)
    try:
        with pytest.raises(FloatingPointError, match="upward_sweep"):
            fmm_velocity(bad, 8, device="cpu")
        with pytest.raises(FloatingPointError, match="upward_sweep"):
            rk2_step(bad, 0.01, p=8, device="cpu")
        rk2_step(tt, 0.01, p=8, device="cpu")          # a healthy step passes
    finally:
        backend.set_debug_nan(False)


# ---------------------------------------------------------------------------
# VortexStepper (the cases of tests/test_stepper.py, and against the
# reference's serial stepper)
# ---------------------------------------------------------------------------


def test_stepper_rk2_matches_host_rebuild_loop():
    from repro_torch.core.fmm import fmm_velocity
    from repro_torch.core.vortex import lamb_oseen_particles
    pos0, gamma0, sigma = lamb_oseen_particles(40)
    p, dt, steps = 10, 0.004, 3
    st = VortexStepper(pos0, gamma0, sigma, p=p, dt=dt, device="cpu",
                       payload={"z0": pos0[:, 0] + 1j * pos0[:, 1]})
    for _ in range(steps):
        st.step()
    # the loop of host build_tree twice per RK2 step the stepper replaces
    level, slots = st.params.level, st.params.slots
    def velocity(at):
        t, ix = qt.build_tree(at, gamma0, level, sigma, slots=slots, device="cpu")
        w = qt.gather_particle_values(fmm_velocity(t, p, device="cpu"), ix).numpy()
        return np.stack([w.real, -w.imag], 1)

    pos = pos0.copy()
    for _ in range(steps):
        mid = pos + 0.5 * dt * velocity(pos)
        pos = pos + dt * velocity(mid)
    m = st.tree.mask.numpy().reshape(-1)
    z_dev = st.tree.z.numpy().reshape(-1)[m]
    z0_dev = st.payload["z0"].numpy().reshape(-1)[m]
    dev = z_dev[np.lexsort((z0_dev.imag, z0_dev.real))]
    z0_host = (pos0[:, 0] + 1j * pos0[:, 1]).astype(np.complex64)
    host = (pos[:, 0] + 1j * pos[:, 1])[np.lexsort((z0_host.imag, z0_host.real))]
    assert len(dev) == len(host)
    assert np.abs(dev - host).max() < 5e-5


def test_stepper_orbit_invariant():
    from repro_torch.core.vortex import lamb_oseen_particles
    pos0, gamma0, sigma = lamb_oseen_particles(40)
    r0 = np.hypot(pos0[:, 0] - 0.5, pos0[:, 1] - 0.5)
    st = VortexStepper(pos0, gamma0, sigma, p=10, dt=0.005, device="cpu",
                       payload={"r0": r0 + 0j})
    for _ in range(4):
        st.step()
    m = st.tree.mask.numpy().reshape(-1)
    z = st.tree.z.numpy().reshape(-1)[m]
    rr0 = st.payload["r0"].numpy().reshape(-1)[m].real
    r = np.hypot(z.real - 0.5, z.imag - 0.5)
    sel = rr0 > 0.02
    assert np.abs(r[sel] - rr0[sel]).max() < 5e-3


def test_occupancy_guard_relevels_before_overflow():
    from repro_torch.core.vortex import lamb_oseen_particles
    pos0, gamma0, sigma = lamb_oseen_particles(40)
    st = VortexStepper(pos0, gamma0, sigma, p=8, dt=0.004, device="cpu",
                       slots_headroom=1.0, occupancy_guard=0.9,
                       payload={"z0": pos0[:, 0] + 1j * pos0[:, 1]})
    n_before = int(st.tree.mask.sum())
    level_before = st.params.level
    assert st.maybe_replan() == "relevel"
    assert int(st.tree.mask.sum()) == n_before
    assert st.params.slots >= st.counts().max()
    z0 = st.payload["z0"].numpy().reshape(-1)
    assert (z0 != 0).sum() == n_before
    assert st.params.level >= level_before


def test_stepper_measured_times_fn_is_wired():
    from repro_torch.core.vortex import lamb_oseen_particles
    pos0, gamma0, sigma = lamb_oseen_particles(40)
    calls = []

    def timer(stepper):
        calls.append(stepper.step_count)
        return np.ones(stepper.nparts)

    st = VortexStepper(pos0, gamma0, sigma, p=8, dt=0.004, dynamic=True,
                       replan_every=1, measured_times_fn=timer, device="cpu")
    st.step()
    assert calls == [1]


def test_clean_wall_samples_drops_every_retrace_successor():
    from repro_torch.core.stepper import StepRecord, clean_wall_samples

    def rec(step, sec, replanned=False, releveled=False, recovered=""):
        return StepRecord(step=step, seconds=sec, load_balance=1.0,
                          replanned=replanned, releveled=releveled,
                          level=5, recovered=recovered)

    records = [rec(1, 1.0), rec(2, 9.0, replanned=True), rec(3, 9.0),
               rec(4, 1.1), rec(5, 9.0, releveled=True), rec(6, 9.0),
               rec(7, 1.2), rec(8, 9.0, recovered="expand_domain"),
               rec(9, 9.0), rec(10, 1.3)]
    assert clean_wall_samples(records) == [1.0, 1.1, 1.2, 1.3]
    jrecords = [jst.StepRecord(**dataclasses.asdict(r)) for r in records]
    assert clean_wall_samples(records) == jst.clean_wall_samples(jrecords)
    assert clean_wall_samples([rec(1, 9.0, releveled=True),
                               rec(2, 9.0), rec(3, 1.0)]) == [1.0]
    assert clean_wall_samples([]) == []


def test_occupancy_guard_relevel_is_recorded_as_relevel():
    from repro_torch.core.stepper import clean_wall_samples
    from repro_torch.core.vortex import lamb_oseen_particles
    pos0, gamma0, sigma = lamb_oseen_particles(40)
    st = VortexStepper(pos0, gamma0, sigma, p=8, dt=0.004, device="cpu",
                       slots_headroom=1.0, occupancy_guard=0.9,
                       dynamic=True, replan_every=1)
    rec = st.step()
    assert rec.releveled and not rec.replanned
    assert clean_wall_samples(st.history) == []


def _by_id(stepper, n):
    pos, _ = stepper.particles()
    ids = np.rint(stepper._gather_payload_values()["id"].real).astype(int)
    out = np.full((n, 2), np.nan)
    out[ids] = pos
    return out


def test_stepper_matches_reference_over_four_steps():
    """The port's serial stepper against the reference's: same level,
    slots, plan, per-step record flags and health words, and positions
    within 5e-5 (particles matched by an id payload)."""
    from repro_torch.core.vortex import lamb_oseen_particles
    pos0, gamma0, sigma = lamb_oseen_particles(40)
    kw = dict(p=8, dt=0.004, dynamic=True, replan_every=2,
              payload={"id": np.arange(len(pos0)) + 0j})
    st = VortexStepper(pos0, gamma0, sigma, device="cpu", **kw)
    js = jst.VortexStepper(pos0, gamma0, sigma, **kw)
    assert dataclasses.asdict(st.params) == dataclasses.asdict(js.params)
    assert st.plan.describe() == js.plan.describe()
    for _ in range(4):
        a, b = st.step(), js.step()
        assert (a.step, a.replanned, a.releveled, a.level, a.recovered,
                a.health, a.load_balance) == (b.step, b.replanned, b.releveled,
                                              b.level, b.recovered, b.health,
                                              b.load_balance)
    assert st.params.slots == js.params.slots
    assert st.plan.describe() == js.plan.describe()
    assert st.stats() == js.stats()
    np.testing.assert_allclose(_by_id(st, len(pos0)), _by_id(js, len(pos0)),
                               rtol=0, atol=5e-5)
    assert st.modeled_step_work() == js.modeled_step_work()
    # one part: neither package has a simpler plan to fall back on
    assert st.nparts == 1 and js._fallback_plans() == st._fallback_plans() == []


def test_stepper_refuses_a_mesh_and_a_multi_part_grid(tmp_path):
    """A mesh on another device than ``device``, and a grid of more tiles
    than parts (the reference's error), are refused."""
    from repro_torch.core.vortex import lamb_oseen_particles
    from repro_torch.launch.mesh import make_local_mesh
    pos0, gamma0, sigma = lamb_oseen_particles(12)
    with pytest.raises(ValueError, match="is not the mesh's"):
        VortexStepper(pos0, gamma0, sigma, mesh=make_local_mesh(device="cpu"),
                      device="meta")
    with pytest.raises(ValueError, match="4 tiles for 1 devices"):
        VortexStepper(pos0, gamma0, sigma, plan_grid=(2, 2), device="cpu")
    with pytest.raises(ValueError, match="4 tiles for 1 devices"):
        VortexStepper(pos0, gamma0, sigma, plan_grid=(2, 2),
                      mesh=make_local_mesh(device="cpu"))
    # one tile, and the autotuner over one part, run as the slab plan
    for grid in ((1, 1), "auto"):
        st = VortexStepper(pos0, gamma0, sigma, p=6, plan_grid=grid, device="cpu")
        st.step()


def test_stepper_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    from repro_torch.core.vortex import lamb_oseen_particles
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pos0, gamma0, sigma = lamb_oseen_particles(12)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VortexStepper(pos0, gamma0, sigma)


def test_stepper_refuses_more_slots_than_the_p2p_kernel_takes_on_the_card():
    """The P2P kernel takes any slot count (its streaming form past
    ``p2p.TILE_SLOTS``), so the stepper refuses none: a tree of 400 slots
    builds, re-levels and steps on the CPU as the reference's does, and its
    launch on the card fits one block."""
    from repro_torch.kernels import p2p
    rng = np.random.default_rng(0)
    pos = 0.5 + 0.01 * rng.random((200, 2))    # one leaf box holds them all
    gamma = rng.standard_normal(200) * 0.01
    st = VortexStepper(pos, gamma, 0.02, p=4, device="cpu")
    assert st.params.slots == 400 > p2p.TILE_SLOTS
    assert not hasattr(st, "_check_slots")
    assert p2p.launch_config(st.params.slots) == (1, 1, p2p.STREAM_THREADS,
                                                  p2p.STREAM_SMEM)
    st._relevel()
    assert st.params.slots == 400
    rec = st.step()
    assert rec.recovered == "" and st.step_count == 1
    assert int(st.tree.mask.sum()) == 200
