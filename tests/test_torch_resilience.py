"""The port's resilience protocol (``repro_torch.parallel.resilience``),
held to the reference's cases (``tests/test_resilience.py``, all but its
two drills, which ``test_torch_supervisor.py`` ports): watchdog deadlines,
heartbeat staleness, the epoch barrier, membership agreement, the restart
policy and the fault-report error, and the process-level fault sites.

The no-false-positive case steps the port's sharded stepper on 4 gloo CPU
ranks (``spawn_world``) instead of a jax subprocess; one case feeds the
same inputs to both packages' pure functions and asserts equal outputs.
"""
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from repro_torch.core.faults import FaultInjector, FaultSpec, PROC_SITES, SITES
from repro_torch.launch.mesh import spawn_world
from repro_torch.parallel import resilience as rz

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

# the reference drills' scenario
N_SIDE, P, DT = 20, 4, 0.004


# ---------------------------------------------------------------------------
# deadline computation
# ---------------------------------------------------------------------------


def test_step_deadline_units():
    pol = rz.WatchdogPolicy(margin=3.0, slack=2.0, min_deadline=1.0,
                            compile_grace=300.0)
    # no estimate yet -> compile grace
    assert rz.step_deadline(pol, None) == 300.0
    # steady state: margin * predicted + slack
    assert rz.step_deadline(pol, 0.5) == pytest.approx(3.5)
    # floored (slack=0 so the floor binds)
    assert rz.step_deadline(
        rz.WatchdogPolicy(margin=3.0, slack=0.0, min_deadline=1.0),
        1e-6) == 1.0
    # a step known to be a first (or post-adoption) step gets the grace
    assert rz.step_deadline(pol, 0.5, compiled=False) == 300.0
    # Eq 13-15 calibration path
    assert rz.predicted_from_calibration(2e-6, 1e5) == pytest.approx(0.2)
    assert rz.predicted_from_calibration(None, 1e5) is None
    assert rz.predicted_from_calibration(2e-6, None) is None
    assert rz.predicted_from_calibration(0.0, 1e5) is None


def _deadline_rows(mesh, steps):
    """One rank of the no-false-positive case: the deadline computed before
    each step, and the step's (rank-wide) seconds."""
    from repro_torch.core.stepper import VortexStepper
    from repro_torch.core.vortex import lamb_oseen_particles
    pol = rz.WatchdogPolicy(margin=3.0, slack=0.5, min_deadline=0.05,
                            compile_grace=900.0)
    pos, gamma, sigma = lamb_oseen_particles(N_SIDE)
    st = VortexStepper(pos, gamma, sigma, p=P, dt=DT, mesh=mesh,
                       plan_method="model")
    rows, compiled = [], False
    for _ in range(steps):
        deadline = rz.step_deadline(pol, st.predicted_step_seconds(), compiled)
        rec = st.step()
        compiled = not (rec.replanned or rec.releveled)
        rows.append((deadline, rec.seconds))
    return rows


def test_watchdog_deadline_no_false_positives_20_steps():
    """Cost-model-derived deadlines across 20 clean steps on 4 ranks: every
    step finishes inside the deadline computed BEFORE it ran, and the
    deadlines after warm-up are tight (far below the compile grace)."""
    worlds = spawn_world(_deadline_rows, 4, device="cpu", timeout_s=300,
                         args=(20,))
    rows = worlds[0]
    assert all(w == rows for w in worlds)      # one rank-wide step time
    assert len(rows) == 20
    for i, (deadline, seconds) in enumerate(rows):
        assert seconds < deadline, \
            f"step {i + 1}: false positive ({seconds:.3f}s > {deadline:.3f}s)"
    tail = [d for d, _ in rows[5:]]
    assert max(tail) < 900.0 / 4, f"deadlines never tightened: {tail}"


# ---------------------------------------------------------------------------
# heartbeat staleness
# ---------------------------------------------------------------------------


def test_heartbeat_staleness_sigstop_peer(tmp_path):
    """A SIGSTOPped beater (a stdlib subprocess) goes overdue against its
    OWN published deadline within bounded time; a beating peer never does."""
    beater = textwrap.dedent(f"""
        import sys, time
        sys.path.insert(0, {SRC!r})
        from repro_torch.parallel import resilience as rz
        hb = rz.Heartbeat({str(tmp_path)!r}, 0, 1)
        while True:
            hb.beat(step=3, phase="step", deadline=0.5)
            time.sleep(0.05)
    """)
    p = subprocess.Popen([sys.executable, "-c", beater])
    pol = rz.WatchdogPolicy(compile_grace=30.0)
    wd = rz.Watchdog(str(tmp_path), 0, ranks=(1,), policy=pol)
    try:
        deadline = time.time() + 10
        while rz.read_heartbeat(str(tmp_path), 0, 1) is None:
            assert time.time() < deadline, "beater never started"
            time.sleep(0.02)
        time.sleep(0.3)
        assert wd.overdue() == {}
        assert wd.fresh() == (1,)
        os.kill(p.pid, signal.SIGSTOP)     # hung, not dead
        t0 = time.time()
        while not wd.overdue():
            assert time.time() - t0 < 5.0, "stopped beater never went overdue"
            time.sleep(0.05)
        over = wd.overdue()
        assert 1 in over and over[1] > 0.0
        assert wd.fresh() == ()
        assert rz.read_heartbeat(str(tmp_path), 0, 1)["deadline"] == 0.5
    finally:
        os.kill(p.pid, signal.SIGCONT)
        p.kill()
        p.wait(timeout=30)


def test_watchdog_never_beat_rank(tmp_path):
    pol = rz.WatchdogPolicy(compile_grace=0.2)
    wd = rz.Watchdog(str(tmp_path), 0, ranks=(0,), policy=pol)
    assert wd.overdue() == {}              # inside the boot grace
    time.sleep(0.3)
    assert 0 in wd.overdue()               # grace expired, no beat ever


# ---------------------------------------------------------------------------
# epoch barrier + membership agreement
# ---------------------------------------------------------------------------


def test_epoch_barrier_passes_and_times_out(tmp_path):
    d = str(tmp_path)
    b0 = rz.EpochBarrier(d, 0, 0, (0, 1), poll_interval=0.01)
    b1 = rz.EpochBarrier(d, 0, 1, (0, 1), poll_interval=0.01)
    t = threading.Thread(target=lambda: b1.wait(0, timeout=5.0))
    t.start()
    b0.wait(0, timeout=5.0)
    t.join(timeout=5.0)
    assert not t.is_alive()
    beats = []
    with pytest.raises(rz.BarrierTimeout) as ei:
        b0.wait(1, timeout=0.3, on_poll=lambda: beats.append(time.time()))
    assert ei.value.missing == (1,)
    assert ei.value.epoch == 1
    assert len(beats) >= 5


def test_barrier_aborts_on_fault_announcement(tmp_path):
    """A waiting rank aborts as soon as a fault announcement lands."""
    d = str(tmp_path)
    b0 = rz.EpochBarrier(d, 0, 0, (0, 1), poll_interval=0.01)
    caught = {}

    def waiter():
        try:
            b0.wait(0, timeout=60.0)
        except rz.FaultAnnounced as e:
            caught["dead"] = e.dead
            caught["t"] = time.time()

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.2)
    t0 = time.time()
    rz.announce_fault(d, 0, [1], epoch=0, by="supervisor")
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert caught["dead"] == (1,)
    assert caught["t"] - t0 < 2.0


def test_concurrent_detection_single_decision(tmp_path):
    """Two ranks detect the same death at once: both announce (first writer
    wins), both agree on the same view, and ONE decision is published."""
    d = str(tmp_path)
    results, anns = {}, {}

    def detect(rank):
        anns[rank] = rz.announce_fault(d, 0, [2], epoch=7, by=rank)
        results[rank] = rz.agree_view(d, 0, rank, [0, 1], 7, timeout=5.0)

    ts = [threading.Thread(target=detect, args=(r,)) for r in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30.0)
        assert not t.is_alive()
    assert results[0] == results[1] == (0, 1)
    assert anns[0] == anns[1]
    assert anns[0]["dead"] == [2]
    decisions = [n for n in os.listdir(os.path.join(d, "gen_0"))
                 if n.startswith("decision_") and n.endswith(".json")]
    assert decisions == ["decision_7.json"]
    assert rz.read_decision(d, 0)["survivors"] == [0, 1]


def test_divergent_views_converge_by_intersection(tmp_path):
    """One detector still believes a doubly-dead rank is alive; the views
    are intersected and re-voted at epoch+1 until identical."""
    d = str(tmp_path)
    results = {}

    def vote(rank, proposed):
        results[rank] = rz.agree_view(d, 0, rank, proposed, 3,
                                      timeout=1.0, max_rounds=4)

    ts = [threading.Thread(target=vote, args=(0, [0, 1])),
          threading.Thread(target=vote, args=(1, [0, 1, 3]))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30.0)
        assert not t.is_alive()
    assert results[0] == results[1] == (0, 1)


def test_agreement_rejects_selfless_proposal(tmp_path):
    with pytest.raises(rz.AgreementError):
        rz.agree_view(str(tmp_path), 0, 2, [0, 1], 0, timeout=0.2)


# ---------------------------------------------------------------------------
# restart policy
# ---------------------------------------------------------------------------


def test_restart_policy_backoff_and_floor():
    pol = rz.RestartPolicy(max_restarts=3, backoff_base=0.5,
                           backoff_max=4.0, min_world=2)
    assert pol.backoff(0) == 0.0
    assert [pol.backoff(n) for n in (1, 2, 3, 4, 5)] == \
        [0.5, 1.0, 2.0, 4.0, 4.0]


def test_restart_policy_quarantine_and_rejoin():
    pol = rz.RestartPolicy(rejoin_after=2, flap_limit=2)
    hist = {2: [0]}
    assert pol.next_ranks([0, 1, 3], 0, hist) == (0, 1, 3)
    assert pol.next_ranks([0, 1, 3], 2, hist) == (0, 1, 2, 3)
    assert pol.next_ranks([0, 1, 3], 9, {2: [0, 5]}) == (0, 1, 3)
    assert rz.RestartPolicy().next_ranks([0, 1], 9, hist) == (0, 1)


def test_mesh_fault_error_carries_reports():
    rep = rz.ProcFaultReport(generation=1, epoch=4, dead=(2,), hung=(),
                             world_before=4, world_after=3, restore_step=2,
                             detected_by="supervisor", detect_seconds=0.4)
    err = rz.MeshFaultError("max restarts exceeded", [rep])
    assert err.faults == (rep,)
    assert "max restarts exceeded" in str(err)
    assert "dead=[2]" in str(err)
    assert rep.describe()["world_after"] == 3


# ---------------------------------------------------------------------------
# FaultSpec at process granularity
# ---------------------------------------------------------------------------


def test_proc_fault_sites():
    assert set(PROC_SITES) <= set(SITES)
    kill = FaultSpec(site="proc_kill", step=4, device=2)
    hang = FaultSpec(site="proc_hang", step=3, device=1, sticky=True)
    assert kill.rank == 2 and hang.rank == 1
    inj = FaultInjector(kill, hang,
                        FaultSpec(site="teleport", step=4),
                        FaultSpec(site="time_inflate", step=4))
    assert inj.proc_faults() == (kill, hang)
    active = inj.active(4)
    assert all(f.site not in PROC_SITES + ("time_inflate",) for f in active)
    assert [f.site for f in active] == ["teleport"]
    with pytest.raises(ValueError):
        FaultSpec(site="proc_reboot", step=1)


# ---------------------------------------------------------------------------
# the same pure functions as the reference's
# ---------------------------------------------------------------------------


def test_pure_functions_equal_the_reference():
    """``step_deadline``, ``predicted_from_calibration``,
    ``RestartPolicy.backoff`` and ``next_ranks`` give the reference's
    outputs on the same inputs."""
    from repro.parallel import resilience as ref
    for margin, slack, floor, grace in ((3.0, 2.0, 1.0, 300.0),
                                        (2.5, 0.0, 0.05, 900.0),
                                        (1.0, 0.5, 4.0, 10.0)):
        kw = dict(margin=margin, slack=slack, min_deadline=floor,
                  compile_grace=grace)
        mine, theirs = rz.WatchdogPolicy(**kw), ref.WatchdogPolicy(**kw)
        for predicted in (None, 0.0, 1e-6, 0.37, 2.0, 50.0, 1e4):
            for compiled in (True, False):
                assert rz.step_deadline(mine, predicted, compiled) == \
                    ref.step_deadline(theirs, predicted, compiled)
    for spu in (None, -1.0, 0.0, 2e-6, 3.5):
        for work in (None, -2.0, 0.0, 1e5, 7.25):
            assert rz.predicted_from_calibration(spu, work) == \
                ref.predicted_from_calibration(spu, work)
    histories = ({}, {2: [0]}, {2: [0, 5]}, {1: [3], 4: [1]}, {0: [0], 3: [2, 2]})
    for kw in ({}, dict(backoff_base=0.1, backoff_max=2.0),
               dict(rejoin_after=2, flap_limit=2), dict(rejoin_after=0, flap_limit=1),
               dict(rejoin_after=3, flap_limit=3)):
        mine, theirs = rz.RestartPolicy(**kw), ref.RestartPolicy(**kw)
        for n in range(-1, 9):
            assert mine.backoff(n) == theirs.backoff(n)
        for survivors in ((0, 1, 3), (1,), (0, 2), ()):
            for gen in (0, 1, 2, 5, 9):
                for hist in histories:
                    assert mine.next_ranks(survivors, gen, hist) == \
                        theirs.next_ranks(survivors, gen, hist)
    assert rz.EXIT_SHRINK == ref.EXIT_SHRINK
