"""The collective-schedule verifier: one host program, every rank id.

The port's counterpart of ``src/repro/analysis/schedule.py``.  Each rank of
the sharded driver runs its own copy of one host program; a branch that
makes one rank skip an all-gather the others issue, or post a receive whose
shape differs from its peer's send, is the distributed hang: every other
rank blocks in the message for ever, and nothing says so until the group's
timeout.  The reference evaluates its lowered module once per device id;
the port runs the host program itself:

1. :class:`DryMesh` has :class:`~repro_torch.launch.mesh.RankMesh`'s
   interface and its schedule log, and moves no data: a receive is zeros of
   the shape asked for, an all-gather returns ``size`` copies of the local
   tensor, an all-reduce returns the local value;
2. :func:`simulate` runs ``fn`` once for every rank id of a world, in this
   process, each run on its own ``DryMesh``, and returns the ranks' logs;
3. :func:`verify_schedules` checks the logs against each other: every rank
   issues the same all-gathers, all-reduces and barriers, in the same order,
   with equal shapes and dtypes; every send of rank ``a`` to rank ``b`` in
   round ``t`` meets a receive at ``b`` from ``a`` in round ``t`` with the
   same shape and dtype, and no receive is left without its send; and each
   event is sane (peers in range, no send to itself, no peer twice in a
   round, every wait names an issue it has not completed yet).

The same verifier takes the logs of real ranks (``mesh.log.events`` of each
rank of a ``spawn_world``): that is how the dry simulation is held to the
card.  The dry run is faithful as long as no rank's shapes depend on the
values it receives; the sharded driver's shapes come from the plan alone.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..configs.backend import resolve_device
from ..launch.mesh import MeshEvent, Pending, ScheduleLog, Wire

__all__ = ["DryMesh", "ScheduleReport", "simulate", "verify_schedules",
           "verify_entry", "same_schedule", "counts_text", "COLLECTIVES"]

# the events every rank must issue in the same order with the same operands
COLLECTIVES = ("all_gather", "all_reduce_max", "barrier")


@dataclasses.dataclass(frozen=True)
class DryMesh:
    """A rank's mesh that logs what it is asked to send and moves nothing."""

    size: int
    rank: int
    device: torch.device
    axis: str = "data"
    wire: Wire = dataclasses.field(default_factory=Wire, compare=False,
                                   repr=False)
    log: ScheduleLog = dataclasses.field(default_factory=ScheduleLog,
                                         compare=False, repr=False)

    def __post_init__(self):
        self.log.rank = self.rank

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis: self.size}

    @property
    def staged(self) -> bool:
        return False

    def exchange(self, sends, recvs) -> Pending:
        tag = self.wire.rounds
        self.wire.rounds += 1
        issue = self.log.exchange(tag, sends, recvs)
        dev = self.device
        return Pending([], lambda: [torch.zeros(tuple(shape), dtype=dtype, device=dev)
                                    for _, shape, dtype in recvs], [],
                       self.log, issue)

    def all_gather(self, t: torch.Tensor) -> Pending:
        issue = self.log.record("all_gather", shape=tuple(t.shape),
                                dtype=str(t.dtype).removeprefix("torch."))
        return Pending([], lambda: torch.stack([t] * self.size), [],
                       self.log, issue)

    def all_reduce_max(self, value: float) -> float:
        self.log.record("all_reduce_max")
        return float(value)

    def barrier(self) -> None:
        self.log.record("barrier")


def simulate(fn: Callable, world: int, *args, device=None, axis: str = "data",
             **kwargs) -> list[list[MeshEvent]]:
    """Run ``fn(*args, mesh=DryMesh(world, r), **kwargs)`` for every rank id
    ``r`` of ``world`` and return each rank's schedule (its log's events).
    ``device`` (None: the CUDA card) is every dry rank's device."""
    dev = resolve_device(device)
    logs = []
    for r in range(world):
        mesh = DryMesh(size=world, rank=r, device=dev, axis=axis)
        fn(*args, mesh=mesh, **kwargs)
        logs.append(list(mesh.log.events))
    return logs


@dataclasses.dataclass
class ScheduleReport:
    ok: bool
    ranks: int
    schedules: list            # per-rank [MeshEvent, ...]
    problems: list             # human-readable findings
    label: str = ""

    def diff_text(self) -> str:
        head = f"schedule report [{self.label}] ranks={self.ranks}: " + \
               ("CONSISTENT" if self.ok else "DIVERGENT")
        lines = [head]
        lines.extend(f"  problem: {p}" for p in self.problems)
        if not self.ok:
            for r, seq in enumerate(self.schedules):
                lines.append(f"  rank {r}: {len(seq)} events")
                for k, e in enumerate(seq):
                    lines.append(f"    [{k}] {e.brief()}")
        elif self.schedules:
            lines.append(f"  every rank: {counts_text(self.schedules[0])}")
        return "\n".join(lines)


def counts_text(events) -> str:
    """``"n collectives, m exchanges, k messages"`` of one rank's events."""
    coll = sum(e.kind in COLLECTIVES for e in events)
    ex = sum(e.kind == "exchange" for e in events)
    msgs = sum(len(e.sends) for e in events if e.kind == "exchange")
    return f"{coll} collectives, {ex} exchange rounds, {msgs} messages sent"


def _round_before(events, k: int) -> str:
    """Where event ``k`` sits: after which exchange round."""
    last = next((e.round for e in reversed(events[:k]) if e.kind == "exchange"),
                None)
    return "before round 0" if last is None else f"after round {last}"


def _check_sanity(r: int, events, world: int) -> list:
    problems, waited = [], set()
    for k, e in enumerate(events):
        where = f"rank {r} event {k}"
        if e.kind == "exchange":
            where = f"rank {r} round {e.round}"
            for name, msgs in (("send to", e.sends), ("receive from", e.recvs)):
                peers = [m[0] for m in msgs]
                bad = sorted({p for p in peers if not 0 <= p < world})
                if bad:
                    problems.append(f"{where}: {name} rank(s) {bad} out of "
                                    f"range [0, {world})")
                if r in peers:
                    problems.append(f"{where}: {name} itself")
                dup = sorted({p for p in peers if peers.count(p) > 1})
                if dup:
                    problems.append(f"{where}: {name} rank(s) {dup} twice in "
                                    f"one round")
        elif e.kind == "wait":
            if e.issue is None or not 0 <= e.issue < k or \
                    events[e.issue].kind not in ("exchange", "all_gather"):
                problems.append(f"{where}: wait names no issue ({e.issue})")
            elif e.issue in waited:
                problems.append(f"{where}: event {e.issue} waited twice")
            waited.add(e.issue)
    return problems


def verify_schedules(logs, label: str = "") -> ScheduleReport:
    """Verify the schedules of all ranks of one world (``logs[r]`` is rank
    ``r``'s list of :class:`~repro_torch.launch.mesh.MeshEvent`s) against
    each other; see the module docstring for the checks."""
    logs = [list(lg.events) if isinstance(lg, ScheduleLog) else list(lg)
            for lg in logs]
    world = len(logs)
    problems = []
    for r, events in enumerate(logs):
        problems.extend(_check_sanity(r, events, world))
    # -- the collectives: one sequence on every rank --------------------------
    coll = [[(k, e) for k, e in enumerate(events) if e.kind in COLLECTIVES]
            for events in logs]
    ref = coll[0]
    for r in range(1, world):
        seq = coll[r]
        n = min(len(ref), len(seq))
        k = next((i for i in range(n) if ref[i][1] != seq[i][1]), n)
        if k < n:
            problems.append(
                f"rank {r} diverges from rank 0 at collective {k} "
                f"({_round_before(logs[r], seq[k][0])}): "
                f"[{ref[k][1].brief()}] vs [{seq[k][1].brief()}]")
        elif len(ref) != len(seq):
            longer, who = (ref, 0) if len(ref) > len(seq) else (seq, r)
            problems.append(
                f"rank {r} issues {len(seq)} collectives, rank 0 issues "
                f"{len(ref)}; first unmatched: [{longer[k][1].brief()}] only "
                f"on rank {who} ({_round_before(logs[who], longer[k][0])}): "
                f"the other ranks would block in this collective for ever")
    # -- the exchanges: every send met by its receive, round by round ---------
    rounds = [{e.round: e for e in events if e.kind == "exchange"}
              for events in logs]
    for a in range(world):
        for t, e in sorted(rounds[a].items()):
            for b, shape, dtype in e.sends:
                if not 0 <= b < world or b == a:
                    continue
                other = rounds[b].get(t)
                want = [(s, d) for p, s, d in (other.recvs if other else ())
                        if p == a]
                if other is None:
                    problems.append(f"round {t}: rank {a} sends to rank {b} "
                                    f"{tuple(shape)} {dtype}, but rank {b} has "
                                    f"no round {t}")
                elif not want:
                    problems.append(f"round {t}: rank {a} sends to rank {b} "
                                    f"{tuple(shape)} {dtype}, rank {b} posts no "
                                    f"receive from rank {a}")
                elif want[0] != (shape, dtype):
                    problems.append(f"round {t}: rank {a} sends to rank {b} "
                                    f"{tuple(shape)} {dtype}, rank {b} receives "
                                    f"{tuple(want[0][0])} {want[0][1]} from "
                                    f"rank {a}")
            for b, shape, dtype in e.recvs:
                if not 0 <= b < world or b == a:
                    continue
                other = rounds[b].get(t)
                if not any(p == a for p, _, _ in (other.sends if other else ())):
                    problems.append(f"round {t}: rank {a} waits for a message "
                                    f"from rank {b} that rank {b} never sends")
    return ScheduleReport(ok=not problems, ranks=world, schedules=logs,
                          problems=problems, label=label)


def verify_entry(fn: Callable, *args, world: int, label: str = "",
                 device=None, **kwargs) -> ScheduleReport:
    """Run ``fn`` on every rank id of ``world`` (:func:`simulate`) and
    verify the schedules."""
    logs = simulate(fn, world, *args, device=device, **kwargs)
    return verify_schedules(logs, label=label or getattr(fn, "__name__", "entry"))


def same_schedule(a, b) -> Optional[str]:
    """None if two runs' schedules of one rank agree event for event
    (kind, round, peers, shapes, dtypes, waits), else the first
    difference.  Rounds and waits are read as ``ScheduleLog.since`` gives
    them: counted from the first event of each run."""
    a, b = list(a), list(b)
    n = min(len(a), len(b))
    k = next((i for i in range(n) if a[i] != b[i]), n)
    if k < n:
        return f"event {k}: [{a[k].brief()}] vs [{b[k].brief()}]"
    if len(a) != len(b):
        return f"{len(a)} events vs {len(b)}"
    return None
