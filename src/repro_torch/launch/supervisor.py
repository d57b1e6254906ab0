"""Kill-drill supervisor over torch rank processes: the port's counterpart
of ``src/repro/launch/supervisor.py``.

``Supervisor`` runs the sharded ``VortexStepper`` on a world of OS
processes, one a rank, and survives a killed or hung rank:

  * every rank passes the epoch barrier of ``parallel/resilience.py``
    before each step's collectives and keeps a heartbeat whose deadline is
    derived from the Eq 13-15 cost model's predicted step time, so a hang
    is detected in bounded time;
  * on detection (a rank's process exits, or its heartbeat goes stale past
    its own published deadline) the survivors agree on the new world
    through the epoch-numbered view protocol, the supervisor SIGKILLs what
    is left of the generation (a SIGSTOPped rank included) and respawns the
    survivors as generation g+1, each restoring
    ``VortexStepper.from_checkpoint`` onto the smaller world, so the
    survivors' trajectory is bit for bit a clean run at that world from the
    same checkpoint;
  * the :class:`~repro_torch.parallel.resilience.RestartPolicy` bounds the
    loop (restarts, backoff, quarantine and rejoin, a degraded-mode floor),
    and a typed :class:`~repro_torch.parallel.resilience.MeshFaultError`
    carries the fault history out.

Process model.  Each generation is one ``torch.distributed`` group of
``len(ranks)`` processes (gloo; a ``file://`` store under the generation's
directory), joined by :func:`~repro_torch.launch.mesh.join_world`: the
logical rank ids (0, 1, 3 after a shrink) stay the supervisor's, the group
numbers its members 0..world-1, and the lowest rank writes the checkpoints.
Unlike the reference, whose ranks each run the whole world's program, the
port's collectives cross processes, so a rank that dies or stops mid-step
leaves its peers inside a collective.  Each worker therefore runs a guard
thread beside the step: it keeps the heartbeat fresh while the main thread
is blocked, and, when a fault is announced or a peer goes stale while the
main thread is inside a collective, it runs the agreement itself and ends
the process with ``EXIT_SHRINK`` (the failed group is never torn down
collectively).  A collective that raises (a peer's connection closed) or
times out (the group's timeout is the deadline of a step with no
estimate, the compile grace) enters the same detection path; only a rank that sees no fault
within its deadline treats the error as its own and exits nonzero.

On the card every rank uses the same device over gloo, and the kernels are
built once by the supervisor before the first generation, so the ranks
only load them.  Drill faults use the ``FaultSpec`` vocabulary:
``proc_kill`` / ``proc_hang`` SIGKILL / SIGSTOP rank k mid-step n.

CLI:
  python -m repro_torch.launch.supervisor --world 4 --target-step 6 \\
      --coord-dir D --kill 2:4 --device cpu   # SIGKILL rank 2 mid-step 4
(without ``--device`` the ranks run on the CUDA card, and the command
raises where there is none; ``--worker CFG.json`` is the rank entry point.)
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from typing import Optional

from ..configs.backend import resolve_device
from ..parallel import resilience as rz

_SRC_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SupervisorConfig:
    world: int
    target_step: int
    coord_dir: str
    checkpoint_dir: Optional[str] = None    # default: <coord_dir>/ckpt
    # scenario (gen-0 build; later generations restore from checkpoint)
    n_side: int = 20
    p: int = 4
    dt: float = 0.004
    target_per_box: float = 8.0
    plan_method: str = "model"              # deterministic across ranks
    checkpoint_every: int = 2
    checkpoint_keep: int = 8
    device: Optional[str] = None            # every rank's; None: the CUDA card
    watchdog: rz.WatchdogPolicy = dataclasses.field(
        default_factory=rz.WatchdogPolicy)
    restart: rz.RestartPolicy = dataclasses.field(
        default_factory=rz.RestartPolicy)
    max_wall: float = 1800.0                # hard supervisor wall clock
    poll_interval: float = 0.1

    def __post_init__(self):
        if self.checkpoint_dir is None:
            self.checkpoint_dir = os.path.join(self.coord_dir, "ckpt")


@dataclasses.dataclass
class SupervisorResult:
    success: bool
    final_step: int
    generations: list                       # per-generation summary dicts
    faults: list                            # ProcFaultReport per shrink
    world_history: list                     # [(generation, ranks), ...]
    result_dir: str                         # gen dir with result_<rank>.npz
    ranks: tuple                            # final generation's ranks

    def describe(self) -> dict:
        d = dataclasses.asdict(self)
        d["faults"] = [f.describe() for f in self.faults]
        return d


def group_timeout(policy: rz.WatchdogPolicy) -> float:
    """Seconds a rank's collectives (and its group's rendezvous) wait: the
    deadline of a step with no estimate yet (the compile grace), so a
    blocked collective ends in bounded time even where no heartbeat goes
    stale."""
    return rz.step_deadline(policy, None, compiled=False)


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------


class Supervisor:
    """Spawns rank workers, watches heartbeats/exits, executes proc-fault
    drills, and coordinates shrink + generation-stamped restart."""

    def __init__(self, config: SupervisorConfig, faults=None):
        self.cfg = config
        self.faults = faults                # FaultInjector with proc sites
        self.fault_history: dict = {}       # rank -> [generation, ...]
        self.reports: list = []
        self.generations: list = []
        self.world_history: list = []
        self.device = resolve_device(config.device)

    # -- worker process management ------------------------------------------

    def _threads(self, world: int) -> int:
        if self.device.type == "cpu":
            return 1
        return max(1, (os.cpu_count() or 1) // world)

    def _worker_env(self) -> dict:
        env = dict(os.environ)
        pp = env.get("PYTHONPATH", "")
        if _SRC_DIR not in pp.split(os.pathsep):
            env["PYTHONPATH"] = _SRC_DIR + (os.pathsep + pp if pp else "")
        return env

    def _spawn_generation(self, generation: int, ranks, restore_step,
                          seconds_per_work) -> dict:
        gdir = rz.gen_dir(self.cfg.coord_dir, generation)
        world = len(ranks)
        procs = {}
        for rank in ranks:
            cfg = {
                "rank": int(rank), "ranks": [int(r) for r in ranks],
                "generation": int(generation),
                "coord_dir": self.cfg.coord_dir,
                "checkpoint_dir": self.cfg.checkpoint_dir,
                "restore_step": restore_step,
                "target_step": self.cfg.target_step,
                "n_side": self.cfg.n_side, "p": self.cfg.p,
                "dt": self.cfg.dt,
                "target_per_box": self.cfg.target_per_box,
                "plan_method": self.cfg.plan_method,
                "checkpoint_every": self.cfg.checkpoint_every,
                "checkpoint_keep": self.cfg.checkpoint_keep,
                "seconds_per_work": seconds_per_work,
                "process_index": list(ranks).index(rank),
                "store": os.path.join(gdir, "store"),
                "group_timeout": group_timeout(self.cfg.watchdog),
                "device": str(self.device),
                "threads": self._threads(world),
                "watchdog": dataclasses.asdict(self.cfg.watchdog),
            }
            cfg_path = os.path.join(gdir, f"worker_{rank}.json")
            with open(cfg_path, "w") as f:
                json.dump(cfg, f)
            log = open(os.path.join(gdir, f"worker_{rank}.log"), "w")
            # each rank in a session of its own: a rank the hang drill
            # SIGSTOPs is then in no process group of the supervisor's, so
            # the SIGHUP and SIGCONT that POSIX sends to an orphaned group
            # holding a stopped member can never reach the supervisor
            procs[rank] = (subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.supervisor",
                 "--worker", cfg_path],
                stdout=log, stderr=subprocess.STDOUT,
                env=self._worker_env(), start_new_session=True), log)
        return procs

    def _teardown(self, procs: dict) -> None:
        """SIGKILL every still-running rank (kills SIGSTOPped ones too)."""
        for rank, (p, log) in procs.items():
            if p.poll() is None:
                try:
                    os.kill(p.pid, signal.SIGKILL)
                except OSError:
                    pass
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
            log.close()

    # -- drill execution (proc_kill / proc_hang FaultSpec sites) ------------

    def _proc_specs(self) -> list:
        if self.faults is None:
            return []
        return list(self.faults.proc_faults())

    def _maybe_fire_drills(self, generation, ranks, procs, fired) -> list:
        """Execute due proc-fault specs; returns [(spec, t_injected)]."""
        events = []
        for spec in self._proc_specs():
            key = (spec.site, spec.rank, spec.step)
            if key in fired or spec.rank not in ranks:
                continue
            hb = rz.read_heartbeat(self.cfg.coord_dir, generation, spec.rank)
            if hb is None:
                continue
            due = (hb["step"] >= spec.step or
                   (hb["step"] >= spec.step - 1 and hb["phase"] == "step"))
            if not due:
                continue
            p, _ = procs[spec.rank]
            sig = (signal.SIGKILL if spec.site == "proc_kill"
                   else signal.SIGSTOP)
            try:
                os.kill(p.pid, sig)
                events.append((spec, time.time()))
            except OSError:
                pass
            fired.add(key)
        return events

    # -- the generation loop ------------------------------------------------

    def run(self) -> SupervisorResult:
        cfg = self.cfg
        os.makedirs(cfg.coord_dir, exist_ok=True)
        if self.device.type == "cuda":
            from ..kernels import _build
            _build.build(("p2p", "m2l"))    # the ranks only load them
        t_run0 = time.time()
        generation, restarts = 0, 0
        ranks = tuple(range(cfg.world))
        restore_step: Optional[int] = None
        seconds_per_work: Optional[float] = None
        fired: set = set()
        pending_report: Optional[rz.ProcFaultReport] = None

        while True:
            self.world_history.append((generation, list(ranks)))
            t_spawn = time.time()
            procs = self._spawn_generation(generation, ranks, restore_step,
                                           seconds_per_work)
            watchdog = rz.Watchdog(cfg.coord_dir, generation, ranks,
                                   cfg.watchdog)
            gen_rec = {"generation": generation, "ranks": list(ranks),
                       "restore_step": restore_step, "outcome": None,
                       "spawn_to_restored_s": None,
                       "spawn_to_first_step_s": None}
            t_inject = t_detect = t_restored = t_first = None
            injected: list = []
            dead_exits: dict = {}
            shrink_exits: set = set()
            done_ranks: set = set()

            while True:
                time.sleep(cfg.poll_interval)
                now = time.time()
                if now - t_run0 > cfg.max_wall:
                    self._teardown(procs)
                    raise rz.MeshFaultError(
                        f"supervisor wall clock exceeded "
                        f"({cfg.max_wall:.0f}s)", self.reports)

                injected += self._maybe_fire_drills(generation, ranks, procs,
                                                    fired)
                if injected and t_inject is None:
                    t_inject = injected[0][1]

                hbs = {r: rz.read_heartbeat(cfg.coord_dir, generation, r)
                       for r in ranks}
                live = {r for r in ranks if r not in done_ranks}
                if t_restored is None and all(
                        hbs[r] and hbs[r]["phase"] != "boot" for r in ranks):
                    t_restored = now
                    gen_rec["spawn_to_restored_s"] = now - t_spawn
                    # close the PREVIOUS fault's restore_seconds window
                    if pending_report is not None:
                        pending_report.restore_seconds = (
                            now - t_spawn + pending_report.restore_seconds)
                base_step = restore_step if restore_step is not None else 0
                if t_first is None and any(
                        hbs[r] and hbs[r]["step"] > base_step for r in ranks):
                    t_first = now
                    gen_rec["spawn_to_first_step_s"] = now - t_spawn
                    if pending_report is not None and t_restored is not None:
                        pending_report.first_step_seconds = now - t_restored
                        pending_report = None

                for r in list(live):
                    p, _ = procs[r]
                    rc = p.poll()
                    if rc is None:
                        continue
                    if rc == 0:
                        done_ranks.add(r)
                    elif rc == rz.EXIT_SHRINK:
                        shrink_exits.add(r)
                        done_ranks.add(r)       # exited deliberately
                    else:
                        dead_exits[r] = rc
                        done_ranks.add(r)

                if len(done_ranks) == len(ranks) and not dead_exits \
                        and not shrink_exits:
                    gen_rec["outcome"] = "completed"
                    self.generations.append(gen_rec)
                    self._teardown(procs)
                    return SupervisorResult(
                        success=True, final_step=cfg.target_step,
                        generations=self.generations, faults=self.reports,
                        world_history=self.world_history,
                        result_dir=rz.gen_dir(cfg.coord_dir, generation),
                        ranks=ranks)

                hung = {r: over for r, over in watchdog.overdue(now).items()
                        if r not in done_ranks and r not in dead_exits}
                announcement = rz.read_fault(cfg.coord_dir, generation)
                faulted = bool(dead_exits or hung or shrink_exits
                               or announcement)
                if not faulted:
                    continue
                if t_detect is None:
                    t_detect = now
                    # tell still-waiting ranks immediately (first writer
                    # wins; rank-side detections keep their own timestamp)
                    rz.announce_fault(cfg.coord_dir, generation,
                                      sorted(set(dead_exits) | set(hung)),
                                      epoch=None, by="supervisor")
                # give survivors a bounded grace to agree + exit on their
                # own (a hung rank will not); then tear the remnant down
                remaining = [r for r in ranks if r not in done_ranks
                             and r not in hung and procs[r][0].poll() is None]
                if remaining and now - t_detect < cfg.watchdog.teardown_grace:
                    continue
                break

            # -- coordinated shrink -----------------------------------------
            self._teardown(procs)
            announcement = rz.read_fault(cfg.coord_dir, generation)
            decision = rz.read_decision(cfg.coord_dir, generation)
            dead = sorted(set(dead_exits) | set(hung) |
                          set((announcement or {}).get("dead", [])))
            if decision is not None:
                survivors = tuple(r for r in decision["survivors"]
                                  if r not in dead)
            else:
                survivors = tuple(r for r in ranks if r not in dead)
            for r in dead:
                self.fault_history.setdefault(r, []).append(generation)
            restarts += 1
            # carry the measured seconds-per-work calibration across the
            # restart so the next generation's watchdog deadline starts
            # from the cost model instead of the compile grace
            spus = [hbs[r]["spu"] for r in ranks
                    if hbs.get(r) and hbs[r].get("spu")]
            if spus:
                seconds_per_work = sorted(spus)[len(spus) // 2]

            from ..checkpoint.manager import CheckpointManager
            restore_step = CheckpointManager(
                cfg.checkpoint_dir, keep=cfg.checkpoint_keep).latest_step()

            report = rz.ProcFaultReport(
                generation=generation,
                epoch=(decision or announcement or {}).get("epoch"),
                dead=tuple(sorted(set(dead_exits) |
                                  set((announcement or {}).get("dead", []))
                                  - set(hung))),
                hung=tuple(sorted(hung)),
                world_before=len(ranks), world_after=len(survivors),
                restore_step=restore_step,
                detected_by=(announcement or {}).get("by", "supervisor"),
                detect_seconds=(t_detect - t_inject
                                if t_inject is not None and t_detect
                                else None),
                restore_seconds=0.0,    # grown by the next gen's milestones
                reason="shrink")
            self.reports.append(report)
            pending_report = report
            gen_rec["outcome"] = "fault"
            gen_rec["fault"] = str(report)
            self.generations.append(gen_rec)

            if restarts > cfg.restart.max_restarts:
                raise rz.MeshFaultError(
                    f"max restarts exceeded ({cfg.restart.max_restarts})",
                    self.reports)
            next_ranks = cfg.restart.next_ranks(survivors, generation,
                                                self.fault_history)
            if len(next_ranks) < cfg.restart.min_world:
                raise rz.MeshFaultError(
                    f"world shrank below the degraded-mode floor "
                    f"({len(next_ranks)} < {cfg.restart.min_world})",
                    self.reports)
            time.sleep(cfg.restart.backoff(restarts))
            # account teardown+backoff into the report's restore window
            report.restore_seconds = time.time() - t_detect
            generation += 1
            ranks = next_ranks


# ---------------------------------------------------------------------------
# the rank worker
# ---------------------------------------------------------------------------


class _Guard(threading.Thread):
    """A rank's heartbeat and fault watch, beside its main thread.

    It beats every poll interval with the state the main thread last set
    (one lock: the two threads never write the heartbeat file at once).
    While the main thread is inside a collective (``blocking``), a fault
    announcement or a stale peer makes this thread run the detection
    itself: a SIGSTOPped peer leaves the main thread blocked until the
    group's timeout.  :meth:`detect` runs once a process, from whichever
    thread comes first, and ends the process with ``EXIT_SHRINK``."""

    def __init__(self, cfg: dict, policy: rz.WatchdogPolicy):
        super().__init__(daemon=True)
        self.rank, self.gen = cfg["rank"], cfg["generation"]
        self.ranks = tuple(cfg["ranks"])
        self.coord = cfg["coord_dir"]
        self.policy = policy
        self.hb = rz.Heartbeat(self.coord, self.gen, self.rank)
        self.watchdog = rz.Watchdog(self.coord, self.gen, self.ranks, policy)
        self.state = {"step": cfg["restore_step"] or 0, "phase": "boot",
                      "deadline": policy.compile_grace,
                      "spu": cfg.get("seconds_per_work")}
        self.blocking = True            # boot: the group's rendezvous
        self.stepper = None             # its checkpoint writer is flushed
        self.is_writer = self.rank == min(self.ranks)
        self._beat_lock = threading.Lock()
        self._detecting = threading.Lock()
        self._halt = threading.Event()

    def beat(self, **update) -> None:
        with self._beat_lock:
            self.state.update(update)
            self.hb.beat(**self.state)

    def run(self) -> None:
        while not self._halt.is_set():
            self.beat()
            if self.blocking and not self._detecting.locked():
                fault = rz.read_fault(self.coord, self.gen)
                if fault is not None:
                    self.detect(fault["dead"], fault.get("epoch"))
                stale = [r for r in self.watchdog.overdue() if r != self.rank]
                if stale:
                    self.detect(stale, None)
            time.sleep(self.policy.poll_interval)

    def finish(self, **update) -> None:
        """Stop beating, then write the last beat."""
        self._halt.set()
        self.join()
        self.beat(**update)

    def detect(self, dead, epoch) -> None:
        """The reference's ``detect_and_exit``: announce, agree on the
        survivors' view, flush the checkpoint writer, exit ``EXIT_SHRINK``.
        Never returns."""
        if not self._detecting.acquire(blocking=False):
            while True:                 # the other thread is on it
                time.sleep(1.0)
        pol = self.policy
        epoch = self.state["step"] if epoch is None else epoch
        # agreement can take a while: publish a deadline that covers it
        self.beat(phase="agree", deadline=pol.agree_timeout + pol.slack)
        ann = rz.announce_fault(self.coord, self.gen, dead, epoch, by=self.rank)
        dead = sorted(set(dead) | set(ann["dead"]))
        epoch = ann["epoch"] if ann.get("epoch") is not None else epoch
        if self.rank in dead:
            # the standing announcement names this rank (a watchdog race):
            # step aside, the survivors' decision excludes it
            self.beat(phase="evicted", deadline=pol.compile_grace)
            _exit(rz.EXIT_SHRINK)
        proposed = [r for r in self.ranks if r not in dead]
        rz.agree_view(self.coord, self.gen, self.rank, proposed, epoch,
                      timeout=pol.agree_timeout, poll_interval=pol.poll_interval)
        st = self.stepper
        if self.is_writer and st is not None and st._ckpt is not None:
            st._ckpt.wait()             # never strand an in-flight snapshot
        self.beat(phase="shrink", deadline=pol.compile_grace)
        _exit(rz.EXIT_SHRINK)

    def await_fault(self, error: BaseException, timeout: float) -> None:
        """After a collective raised: wait (blocking, so this thread
        watches) for the fault that caused it; with none within
        ``timeout`` the error is this rank's own, and is raised."""
        traceback.print_exception(error)     # into the rank's log
        self.blocking = True
        end = time.time() + timeout
        while time.time() < end or self._detecting.locked():
            time.sleep(self.policy.poll_interval)
        raise error


def _exit(code: int) -> None:
    """End the process now: a group whose collective failed is not torn
    down (that would be a collective too)."""
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def _launch_counts() -> tuple:
    from ..kernels import m2l, ops, p2p
    return p2p.LAUNCHES, m2l.LAUNCHES, ops.PLAIN_CALLS


def clean_restore(mesh, checkpoint_dir: str, step: int, target_step: int,
                  kwargs: dict) -> dict:
    """What a clean run on ``mesh`` makes of checkpoint ``step``: the
    stepper restored with ``kwargs`` (the drill's scenario) and stepped to
    ``target_step``, its tree on the host.  A drill's survivors must equal
    it bit for bit (run it by ``mesh.spawn_world``)."""
    from ..core.stepper import VortexStepper
    st = VortexStepper.from_checkpoint(checkpoint_dir, mesh=mesh, step=step,
                                       checkpoint_every=0, **kwargs)
    while st.step_count < target_step:
        st.step()
    return {k: getattr(st.tree, k).cpu().numpy() for k in ("z", "q", "mask")}


def restore_kwargs(cfg) -> dict:
    """The stepper settings a restored generation (and :func:`clean_restore`)
    takes from a drill's configuration (a dict or :class:`SupervisorConfig`)."""
    get = cfg.get if isinstance(cfg, dict) else lambda k: getattr(cfg, k)
    return {"plan_method": get("plan_method"),
            "target_per_box": get("target_per_box")}


def worker_main(cfg_path: str) -> int:
    with open(cfg_path) as f:
        cfg = json.load(f)
    rank, gen = cfg["rank"], cfg["generation"]
    ranks = tuple(cfg["ranks"])
    print(f"rank {rank} generation {gen}: pid {os.getpid()} ppid {os.getppid()} "
          f"pgid {os.getpgid(0)} sid {os.getsid(0)}", flush=True)
    policy = rz.WatchdogPolicy(**cfg["watchdog"])
    coord = cfg["coord_dir"]
    guard = _Guard(cfg, policy)
    guard.start()

    import numpy as np

    from ..configs.backend import set_cpu_cores
    from ..core import parallel_fmm as pf
    from ..core.stepper import VortexStepper
    from ..core.vortex import lamb_oseen_particles
    from .mesh import join_world

    set_cpu_cores(cfg["threads"])
    mesh = join_world(cfg["store"], len(ranks), cfg["process_index"],
                      timeout_s=cfg["group_timeout"], device=cfg["device"])
    is_writer = guard.is_writer
    ck_dir, ck_every = cfg["checkpoint_dir"], cfg["checkpoint_every"]
    if cfg["restore_step"] is not None:
        st = VortexStepper.from_checkpoint(
            ck_dir, mesh=mesh, step=cfg["restore_step"],
            checkpoint_every=ck_every if is_writer else 0,
            checkpoint_keep=cfg["checkpoint_keep"], **restore_kwargs(cfg))
    else:
        pos, gamma, sigma = lamb_oseen_particles(cfg["n_side"])
        st = VortexStepper(
            pos, gamma, sigma, p=cfg["p"], dt=cfg["dt"], mesh=mesh,
            plan_method=cfg["plan_method"],
            target_per_box=cfg["target_per_box"],
            checkpoint_dir=ck_dir if is_writer else None,
            checkpoint_every=ck_every,
            checkpoint_keep=cfg["checkpoint_keep"])
        if is_writer:
            st.save_checkpoint()    # step 0: a shrink always has a restore
            st._ckpt.wait()         # point, even before the first cadence
    guard.stepper = st
    guard.blocking = False
    guard.beat(step=st.step_count, phase="restored",
               deadline=policy.compile_grace)

    barrier = rz.EpochBarrier(coord, gen, rank, ranks,
                              poll_interval=policy.poll_interval)
    watchdog = rz.Watchdog(coord, gen, ranks, policy)
    compiled = False
    modeled_work = st.modeled_step_work()
    steps = []
    while st.step_count < cfg["target_step"]:
        spu = guard.state["spu"]
        predicted = st.predicted_step_seconds()
        if predicted is None:
            predicted = rz.predicted_from_calibration(spu, modeled_work)
        deadline = rz.step_deadline(policy, predicted, compiled)
        guard.beat(step=st.step_count, phase="step", deadline=deadline)
        epoch, rounds = st.step_count, 0
        while True:                     # the barrier before the collectives
            try:
                barrier.wait(epoch, timeout=deadline, on_poll=guard.beat)
                break
            except rz.FaultAnnounced as e:
                guard.detect(e.dead, e.epoch if e.epoch is not None else epoch)
            except rz.BarrierTimeout as e:
                stale = [r for r in watchdog.overdue()
                         if r != rank and r in e.missing]
                if stale:
                    guard.detect(stale, epoch)
                rounds += 1             # laggards still fresh: wait more,
                if rounds >= policy.max_barrier_rounds:     # but bounded
                    guard.detect(list(e.missing), epoch)
        expected = pf.kernel_launches(st.plan, st.overlap)
        before = _launch_counts()
        guard.blocking = True
        try:
            rec = st.step()
        except Exception as e:          # a peer's fault, seen by a collective
            guard.await_fault(e, deadline + policy.agree_timeout)
        guard.blocking = False
        after = _launch_counts()
        steps.append({"step": st.step_count, "host_ms": rec.seconds * 1e3,
                      "recovered": rec.recovered,
                      "p2p": after[0] - before[0], "m2l": after[1] - before[1],
                      "plain": after[2] - before[2],
                      "expected": {k: 2 * v for k, v in expected.items()}})
        compiled = not (rec.replanned or rec.releveled)
        if not compiled:
            modeled_work = st.modeled_step_work()
        sample = st.predicted_step_seconds()
        if sample is not None and modeled_work > 0:
            guard.beat(spu=sample / modeled_work)
    if is_writer and st._ckpt is not None:
        st._ckpt.wait()
    gdir = rz.gen_dir(coord, gen)
    np.savez(os.path.join(gdir, f"result_{rank}.npz"),
             z=st.tree.z.cpu().numpy(), q=st.tree.q.cpu().numpy(),
             mask=st.tree.mask.cpu().numpy(), step=st.step_count)
    rz._write_atomic(os.path.join(gdir, f"result_{rank}.json"), json.dumps({
        "rank": rank, "generation": gen, "ranks": list(ranks),
        "device": str(mesh.device), "plan": st.plan.describe(),
        "steps": steps, "mesh_rank": mesh.rank,
        "mesh_log": [e.to_json() for e in mesh.log.events]}, default=str))
    guard.finish(step=st.step_count, phase="done",
                 deadline=policy.compile_grace)
    return 0


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _parse_drills(kills, hangs):
    from ..core.faults import FaultInjector, FaultSpec
    specs = []
    for site, items in (("proc_kill", kills), ("proc_hang", hangs)):
        for item in items or ():
            r, s = item.split(":")
            specs.append(FaultSpec(site=site, step=int(s), device=int(r)))
    return FaultInjector(*specs) if specs else None


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.supervisor",
        description="multi-process kill-drill supervisor over torch ranks")
    ap.add_argument("--worker", metavar="CFG", default=None,
                    help=argparse.SUPPRESS)   # internal rank entry point
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--target-step", type=int, default=6)
    ap.add_argument("--coord-dir", default=None,
                    help="coordination directory (default: a new temporary one)")
    ap.add_argument("--n-side", type=int, default=20)
    ap.add_argument("--p", type=int, default=4)
    ap.add_argument("--dt", type=float, default=0.004)
    ap.add_argument("--checkpoint-every", type=int, default=2)
    ap.add_argument("--kill", action="append", metavar="RANK:STEP",
                    help="SIGKILL rank mid-step (repeatable)")
    ap.add_argument("--hang", action="append", metavar="RANK:STEP",
                    help="SIGSTOP rank mid-step (repeatable)")
    ap.add_argument("--min-world", type=int, default=1)
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--max-wall", type=float, default=1800.0)
    ap.add_argument("--device", default=None,
                    help="every rank's device (default: the CUDA card)")
    args = ap.parse_args(argv)

    if args.worker:
        return worker_main(args.worker)

    cfg = SupervisorConfig(
        world=args.world, target_step=args.target_step,
        coord_dir=args.coord_dir or tempfile.mkdtemp(prefix="fmm-drill-"),
        n_side=args.n_side, p=args.p, dt=args.dt,
        checkpoint_every=args.checkpoint_every, device=args.device,
        restart=rz.RestartPolicy(max_restarts=args.max_restarts,
                                 min_world=args.min_world),
        max_wall=args.max_wall)
    sup = Supervisor(cfg, faults=_parse_drills(args.kill, args.hang))
    result = sup.run()
    print(json.dumps(result.describe(), indent=2, default=str))
    return 0 if result.success else 1


if __name__ == "__main__":
    sys.exit(main())
