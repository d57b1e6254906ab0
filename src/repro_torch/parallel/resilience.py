"""Cross-process resilience protocol: the port's copy of
``src/repro/parallel/resilience.py``.

Pure-stdlib primitives shared by the rank workers and the supervisor
(``launch/supervisor.py``): a heartbeat file protocol, a collective-timeout
watchdog whose deadline is derived from the Eq 13-15 cost model's predicted
step time (robust_wall-filtered seconds-per-work-unit times the current
plan's modeled bottleneck), an epoch-numbered barrier that runs before each
step's collectives, a membership-agreement protocol for coordinated mesh
shrink, and the :class:`RestartPolicy` / :class:`MeshFaultError` pair
bounding the supervisor's restart loop.

The module imports neither torch nor the reference package: the
supervisor process and the heartbeat-only test fixtures use it without a
device runtime, and the port keeps its own copy, as it does of the
planner.  Its behaviour is the reference's, case for case
(``tests/test_torch_resilience.py``), with two repairs for writers that
share a process (the port's worker beats and detects from two threads,
and the tests run ranks as threads): a temporary file is named by process
AND thread, and the loser of a first-writer-wins publication waits for
the winner's file instead of returning its own object.  And one repair of
the agreement: a member one round behind (it voted in an earlier round) is
waited for once more before it is dropped as dead, so two survivors that
time out on a third rank at slightly different moments still agree.

File layout (everything generation-scoped under ``coord_dir/gen_<g>/``):

  hb_<rank>.json       heartbeat: {rank, gen, step, phase, t, pid, deadline,
                       spu} — atomically replaced on every beat.  ``phase``
                       walks boot -> restored -> step -> done (or shrink);
                       ``deadline`` is the rank's own published per-step
                       watchdog deadline, so readers never need to model a
                       peer's workload to judge its staleness.
  bar_<rank>           barrier cursor: the highest epoch this rank reached
                       (monotonic; one file per rank, atomically replaced).
  fault.json           first-writer-wins fault announcement: {dead, epoch,
                       by, t}.  Ranks poll it inside the barrier wait so a
                       supervisor-side (or peer-side) detection aborts the
                       wait immediately instead of after a full timeout.
  view_<epoch>_<rank>.json / decision_<epoch>.json
                       the epoch-numbered membership agreement (below).

Detection -> agreement -> shrink (the worker side):

  A rank killed or stopped mid-step stops beating; survivors block at the
  NEXT epoch barrier.  The wait is bounded by the watchdog deadline; on
  timeout each survivor checks every laggard's heartbeat age against the
  laggard's own published deadline, announces the stale set in
  ``fault.json``, writes its proposed survivor view for the detection
  epoch, and waits for identical views from every proposed member.  Two
  ranks detecting the same death concurrently converge trivially
  (identical proposals); diverging proposals are intersected and re-voted
  at epoch+1 (bounded rounds).  The first rank to observe full agreement
  publishes ``decision_<epoch>.json`` via O_EXCL; everyone returns the
  agreed view and exits with ``EXIT_SHRINK`` so the supervisor tears down
  the dead mesh and respawns the survivors at generation g+1.
"""
from __future__ import annotations

import dataclasses
import errno
import json
import os
import threading
import time
from typing import Optional, Sequence

# Worker exit code meaning "I detected a process fault, agreed on the
# survivor view, and am exiting for a coordinated shrink" (vs 0 = reached
# the target step, anything else = this rank itself failed).
EXIT_SHRINK = 75


# ---------------------------------------------------------------------------
# small atomic-file helpers
# ---------------------------------------------------------------------------


def _write_atomic(path: str, payload: str) -> None:
    tmp = path + f".tmp{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        f.write(payload)
    os.replace(tmp, path)


def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _write_excl_json(path: str, obj: dict, wait: float = 5.0) -> bool:
    """First-writer-wins publication; False when someone else already won
    (after waiting up to ``wait`` seconds for the winner's file to land)."""
    try:
        fd = os.open(path + ".lock", os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except OSError as e:
        if e.errno == errno.EEXIST:
            end = time.time() + wait
            while not os.path.exists(path) and time.time() < end:
                time.sleep(0.001)
            return False
        raise
    try:
        _write_atomic(path, json.dumps(obj))
    finally:
        os.close(fd)
    return True


def gen_dir(coord_dir: str, generation: int) -> str:
    d = os.path.join(coord_dir, f"gen_{generation}")
    os.makedirs(d, exist_ok=True)
    return d


# ---------------------------------------------------------------------------
# watchdog policy + deadline derivation
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WatchdogPolicy:
    """Knobs for the collective-timeout watchdog.

    The per-step deadline is ``margin * predicted + slack`` floored at
    ``min_deadline``, where ``predicted`` is the robust_wall-filtered
    measured step time when the process has its own clean samples, else
    the Eq 13-15 modeled bottleneck times the calibrated seconds-per-work
    handed down from the previous generation.  Steps that are known to
    retrace (the first step in a process, the step after a plan/level
    adoption) are covered by ``compile_grace`` instead — a deadline tuned
    for steady-state steps would flag every legitimate recompile."""

    margin: float = 3.0
    slack: float = 2.0
    min_deadline: float = 1.0
    compile_grace: float = 300.0
    poll_interval: float = 0.05
    agree_timeout: float = 30.0
    max_barrier_rounds: int = 10
    teardown_grace: float = 15.0


def step_deadline(policy: WatchdogPolicy, predicted: Optional[float],
                  compiled: bool = True) -> float:
    """Bounded-time deadline for one stepper call.

    ``predicted`` is the cost-model/measurement step-seconds estimate
    (None = no estimate yet); ``compiled=False`` marks steps that will
    retrace (first call in the process, post-adoption), which get the
    compile grace window instead of the steady-state deadline."""
    if predicted is None:
        return policy.compile_grace
    d = max(policy.min_deadline, policy.margin * predicted + policy.slack)
    if not compiled:
        d = max(d, policy.compile_grace)
    return d


def predicted_from_calibration(seconds_per_work: Optional[float],
                               modeled_work: Optional[float]) -> Optional[float]:
    """Eq 13-15 prediction: calibrated seconds-per-work-unit (robust_wall
    over the previous generation's clean samples divided by its modeled
    bottleneck) times the current plan's modeled bottleneck load."""
    if seconds_per_work is None or modeled_work is None:
        return None
    if seconds_per_work <= 0.0 or modeled_work <= 0.0:
        return None
    return seconds_per_work * modeled_work


# ---------------------------------------------------------------------------
# heartbeats
# ---------------------------------------------------------------------------


class Heartbeat:
    """Per-rank heartbeat writer (atomic replace; one file per rank)."""

    def __init__(self, coord_dir: str, generation: int, rank: int):
        self.dir = gen_dir(coord_dir, generation)
        self.rank = int(rank)
        self.generation = int(generation)
        self.path = os.path.join(self.dir, f"hb_{rank}.json")

    def beat(self, *, step: int, phase: str, deadline: float,
             spu: Optional[float] = None) -> None:
        _write_atomic(self.path, json.dumps({
            "rank": self.rank, "gen": self.generation, "step": int(step),
            "phase": phase, "deadline": float(deadline), "t": time.time(),
            "pid": os.getpid(), "spu": spu}))


def read_heartbeat(coord_dir: str, generation: int,
                   rank: int) -> Optional[dict]:
    return _read_json(os.path.join(coord_dir, f"gen_{generation}",
                                   f"hb_{rank}.json"))


class Watchdog:
    """Heartbeat staleness detector over a set of ranks.

    A rank is OVERDUE when its last beat is older than the deadline it
    itself published with that beat (a SIGKILLed or SIGSTOPped rank's
    heartbeat freezes, so its age grows past its own deadline in bounded
    time); a rank that never beat is overdue once the generation is older
    than ``policy.compile_grace``."""

    def __init__(self, coord_dir: str, generation: int,
                 ranks: Sequence[int], policy: WatchdogPolicy):
        self.coord_dir = coord_dir
        self.generation = int(generation)
        self.ranks = tuple(int(r) for r in ranks)
        self.policy = policy
        self.start = time.time()

    def ages(self, now: Optional[float] = None) -> dict:
        """rank -> (age_seconds, published_deadline) for ranks with beats."""
        now = time.time() if now is None else now
        out = {}
        for r in self.ranks:
            hb = read_heartbeat(self.coord_dir, self.generation, r)
            if hb is not None:
                out[r] = (now - hb["t"], hb["deadline"])
        return out

    def overdue(self, now: Optional[float] = None) -> dict:
        """rank -> seconds past its own deadline, for every stale rank."""
        now = time.time() if now is None else now
        out = {}
        seen = self.ages(now)
        for r in self.ranks:
            if r in seen:
                age, deadline = seen[r]
                if age > deadline:
                    out[r] = age - deadline
            elif now - self.start > self.policy.compile_grace:
                out[r] = now - self.start - self.policy.compile_grace
        return out

    def fresh(self, now: Optional[float] = None) -> tuple:
        bad = self.overdue(now)
        return tuple(r for r in self.ranks if r not in bad)


# ---------------------------------------------------------------------------
# epoch barrier (the per-step cross-process collective)
# ---------------------------------------------------------------------------


class BarrierTimeout(RuntimeError):
    def __init__(self, epoch: int, missing: Sequence[int]):
        super().__init__(f"barrier epoch {epoch} timed out waiting for "
                         f"ranks {sorted(missing)}")
        self.epoch = epoch
        self.missing = tuple(sorted(missing))


class FaultAnnounced(RuntimeError):
    """Raised out of a barrier wait when a fault announcement lands."""

    def __init__(self, dead: Sequence[int], epoch: Optional[int], by):
        super().__init__(f"fault announced by {by}: dead={sorted(dead)}")
        self.dead = tuple(sorted(dead))
        self.epoch = epoch
        self.by = by


def announce_fault(coord_dir: str, generation: int, dead: Sequence[int],
                   epoch: Optional[int], by) -> dict:
    """Publish (first-writer-wins) and return the generation's fault
    announcement.  Later announcers get the original announcement back —
    detection is idempotent across the supervisor and any number of
    concurrently-detecting ranks."""
    path = os.path.join(gen_dir(coord_dir, generation), "fault.json")
    obj = {"dead": sorted(int(r) for r in dead), "epoch": epoch,
           "by": by, "t": time.time()}
    _write_excl_json(path, obj)
    got = _read_json(path)
    return got if got is not None else obj


def read_fault(coord_dir: str, generation: int) -> Optional[dict]:
    return _read_json(os.path.join(coord_dir, f"gen_{generation}",
                                   "fault.json"))


class EpochBarrier:
    """File barrier over monotonically increasing epochs.

    Each rank owns one cursor file holding the highest epoch it reached;
    ``wait(e)`` publishes the local cursor and polls until every peer's
    cursor is >= e.  The wait aborts with :class:`FaultAnnounced` the
    moment a fault announcement exists (so the slowest survivor does not
    serialize detection behind its own full timeout) and with
    :class:`BarrierTimeout` after ``timeout`` seconds."""

    def __init__(self, coord_dir: str, generation: int, rank: int,
                 ranks: Sequence[int],
                 poll_interval: float = 0.05):
        self.coord_dir = coord_dir
        self.dir = gen_dir(coord_dir, generation)
        self.generation = int(generation)
        self.rank = int(rank)
        self.ranks = tuple(int(r) for r in ranks)
        self.poll_interval = poll_interval

    def _cursor_path(self, rank: int) -> str:
        return os.path.join(self.dir, f"bar_{rank}")

    def cursor(self, rank: int) -> int:
        try:
            with open(self._cursor_path(rank)) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return -1

    def arrive(self, epoch: int) -> None:
        _write_atomic(self._cursor_path(self.rank), str(int(epoch)))

    def wait(self, epoch: int, timeout: float, on_poll=None) -> None:
        """``on_poll`` (no-arg callable) runs every poll iteration — the
        worker refreshes its heartbeat there, so a rank BLOCKED at the
        barrier stays provably alive (only its in-step compute window is
        covered by the published deadline; without the refresh a long wait
        for a genuinely-dead peer would make every waiting survivor look
        stale too)."""
        self.arrive(epoch)
        deadline = time.time() + timeout
        while True:
            if on_poll is not None:
                on_poll()
            fault = read_fault(self.coord_dir, self.generation)
            if fault is not None:
                raise FaultAnnounced(fault["dead"], fault.get("epoch"),
                                     fault.get("by"))
            missing = [r for r in self.ranks
                       if r != self.rank and self.cursor(r) < epoch]
            if not missing:
                return
            if time.time() > deadline:
                raise BarrierTimeout(epoch, missing)
            time.sleep(self.poll_interval)


# ---------------------------------------------------------------------------
# epoch-numbered membership agreement
# ---------------------------------------------------------------------------


class AgreementError(RuntimeError):
    pass


def agree_view(coord_dir: str, generation: int, rank: int,
               proposed: Sequence[int], epoch: int, *,
               timeout: float = 30.0, poll_interval: float = 0.02,
               max_rounds: int = 4) -> tuple:
    """Agree on the survivor view for a shrink.

    Each participating rank writes ``view_<epoch>_<rank>.json`` with its
    proposed alive set and waits for a view from every member of that set.
    All identical -> the first observer publishes ``decision_<epoch>.json``
    (O_EXCL) and everyone returns the agreed tuple.  Mismatched views are
    intersected and re-voted at epoch+1; members that never produce a view
    within ``timeout`` (a cascading death mid-agreement) are dropped from
    the next round's proposal, except that a member who voted in an
    earlier round of this agreement (one round behind, not dead) gets one
    more ``timeout`` first.  Bounded by ``max_rounds``."""
    d = gen_dir(coord_dir, generation)
    start = epoch
    proposed = sorted(int(r) for r in proposed)
    rank = int(rank)
    if rank not in proposed:
        raise AgreementError(f"rank {rank} proposing a view without itself")
    for _ in range(max_rounds):
        dec_path = os.path.join(d, f"decision_{epoch}.json")
        _write_atomic(os.path.join(d, f"view_{epoch}_{rank}.json"),
                      json.dumps({"rank": rank, "alive": proposed}))
        deadline = time.time() + timeout
        extended = False
        while True:
            dec = _read_json(dec_path)
            if dec is not None:
                return tuple(dec["survivors"])
            views = {}
            for r in proposed:
                v = _read_json(os.path.join(d, f"view_{epoch}_{r}.json"))
                if v is not None:
                    views[r] = tuple(sorted(v["alive"]))
            if len(views) == len(proposed):
                if len(set(views.values())) == 1:
                    agreed = views[rank]
                    _write_excl_json(dec_path, {
                        "survivors": list(agreed), "epoch": epoch,
                        "by": rank, "t": time.time()})
                    dec = _read_json(dec_path)
                    return tuple(dec["survivors"]) if dec else agreed
                # diverging proposals: intersect, re-vote at epoch + 1
                common = set(proposed)
                for v in views.values():
                    common &= set(v)
                proposed = sorted(common)
                break
            if time.time() > deadline:
                behind = [r for r in proposed if r not in views and any(
                    os.path.exists(os.path.join(d, f"view_{e}_{r}.json"))
                    for e in range(start, epoch))]
                if behind and not extended:
                    deadline, extended = deadline + timeout, True
                    continue
                # non-responders are themselves dead: drop them and re-vote
                proposed = sorted(set(views) & set(proposed) | {rank})
                break
            time.sleep(poll_interval)
        epoch += 1
        if rank not in proposed or len(proposed) == 0:
            raise AgreementError("agreement collapsed to an empty view")
    raise AgreementError(f"no agreement after {max_rounds} rounds")


def read_decision(coord_dir: str, generation: int) -> Optional[dict]:
    """Latest published shrink decision of a generation, if any."""
    d = os.path.join(coord_dir, f"gen_{generation}")
    best = None
    try:
        names = os.listdir(d)
    except OSError:
        return None
    for name in names:
        if name.startswith("decision_") and name.endswith(".json"):
            obj = _read_json(os.path.join(d, name))
            if obj is not None and (best is None or
                                    obj["epoch"] > best["epoch"]):
                best = obj
    return best


# ---------------------------------------------------------------------------
# restart policy + typed fault error
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RestartPolicy:
    """Bounds on the supervisor's coordinated-restart loop.

    ``max_restarts`` caps shrink/restart events across the whole run;
    restarts back off exponentially (``backoff_base * 2**(n-1)`` capped at
    ``backoff_max``); a faulted rank is quarantined and may rejoin after
    ``rejoin_after`` generations (None = never) unless it has faulted
    ``flap_limit`` times (a flapping rank is quarantined permanently);
    shrinking below ``min_world`` ranks raises :class:`MeshFaultError`
    (the degraded-mode floor)."""

    max_restarts: int = 3
    backoff_base: float = 0.5
    backoff_max: float = 30.0
    min_world: int = 1
    rejoin_after: Optional[int] = None
    flap_limit: int = 2

    def backoff(self, restarts: int) -> float:
        if restarts <= 0:
            return 0.0
        return min(self.backoff_base * (2.0 ** (restarts - 1)),
                   self.backoff_max)

    def next_ranks(self, survivors: Sequence[int], generation: int,
                   fault_history: dict) -> tuple:
        """Ranks of generation ``generation + 1``: the survivors plus any
        quarantined rank whose quarantine expired (``rejoin_after``
        generations since its last fault) and that is not flapping.
        ``fault_history``: rank -> list of generations it faulted in."""
        ranks = set(int(r) for r in survivors)
        if self.rejoin_after is not None:
            for r, gens in fault_history.items():
                if int(r) in ranks or len(gens) >= self.flap_limit:
                    continue
                if generation + 1 - max(gens) >= self.rejoin_after:
                    ranks.add(int(r))
        return tuple(sorted(ranks))


@dataclasses.dataclass
class ProcFaultReport:
    """Structured account of one detected process fault (the §14 analogue
    of the in-process ladder's FaultReport)."""

    generation: int
    epoch: Optional[int]            # barrier epoch the fault was caught at
    dead: tuple                     # ranks that exited / were SIGKILLed
    hung: tuple                     # ranks alive but heartbeat-stale
    world_before: int
    world_after: int
    restore_step: Optional[int]     # checkpoint step the survivors restored
    detected_by: object             # "supervisor" or a rank id
    detect_seconds: Optional[float] = None   # injection -> detection
    restore_seconds: Optional[float] = None  # detection -> survivors ready
    first_step_seconds: Optional[float] = None  # ready -> first step done
    reason: str = ""

    def describe(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        t = [f"gen {self.generation}: dead={list(self.dead)} "
             f"hung={list(self.hung)} world {self.world_before}->"
             f"{self.world_after} restore_step={self.restore_step} "
             f"detected_by={self.detected_by}"]
        if self.detect_seconds is not None:
            t.append(f"detect={self.detect_seconds:.2f}s")
        if self.restore_seconds is not None:
            t.append(f"restore={self.restore_seconds:.2f}s")
        if self.reason:
            t.append(self.reason)
        return " ".join(t)


class MeshFaultError(RuntimeError):
    """Raised when the restart policy is exhausted (max restarts, degraded
    floor, or supervisor wall clock); carries the structured fault
    history."""

    def __init__(self, reason: str, faults: Sequence[ProcFaultReport] = ()):
        lines = [reason] + [f"  {f}" for f in faults]
        super().__init__("\n".join(lines))
        self.reason = reason
        self.faults = tuple(faults)
