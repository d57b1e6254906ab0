"""Rank meshes over ``torch.distributed``: the port's counterpart of
``src/repro/launch/mesh.py``.

A :class:`RankMesh` is the one-axis world the sharded driver
(``core/parallel_fmm.py``) runs on: its process group, the axis name, the
world size (``mesh.shape[axis]``, as a JAX mesh reports it), this
process's rank in it and the device its tensors live on.  Every process
holds its own mesh; the driver is one program per rank.

The wire.  An NCCL group moves device tensors as they are.  A ``gloo``
group sends from host memory, so on a CUDA device every send is copied to
the host first and every receive copied back to the device after it
lands: the kernels stay on the card and only the messages are staged.
:class:`Wire` counts the staged bytes and the host seconds the copies
took.  NCCL refuses two ranks on one card, so on one card a world of
several ranks runs over ``gloo``.

:func:`spawn_world` starts a world of ``world`` processes (``spawn``, a
``file://`` store in a temporary directory: no network) and returns what
each rank's function returned; :func:`join_world` joins a process that
someone else started (``launch/supervisor.py``'s ranks) to its group.

The schedule log.  Every message call of a :class:`RankMesh` appends one
:class:`MeshEvent` to ``mesh.log``: an ``exchange`` with its round and the
peer, shape and dtype of each send and receive, an ``all_gather``, an
``all_reduce_max``, a ``barrier``, and a ``wait`` naming the issue it
completes.  The log costs a list append and never reads a tensor's data;
``analysis/schedule.py`` verifies the logs of all ranks against each other.
Each event takes a number from one process-wide sequence, which
``launch/trace_analysis.py:OpTrace`` shares to order the events among the
operations it records.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import os
import pickle
import shutil
import tempfile
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..configs.backend import resolve_device


# one sequence for every mesh event and every operation a trace records
SEQ = itertools.count()
# objects with ``before_mesh_event()`` and ``on_mesh_event(log, index)`` (an
# active ``OpTrace``), told of every event as it is logged
OBSERVERS: list = []


@dataclasses.dataclass(frozen=True)
class MeshEvent:
    """One message call of one rank, in program order.

    ``kind`` is ``exchange``, ``all_gather``, ``all_reduce_max``,
    ``barrier`` or ``wait``.  An exchange has its ``round`` (the tag its
    messages carry) and ``sends``/``recvs`` as ``(peer, shape, dtype)``
    triples; an all-gather has the local ``shape`` and ``dtype``; a wait
    names, as ``issue``, the index in the log of the exchange or all-gather
    it completes.  ``seq`` orders the event among traced operations and is
    left out of comparisons."""

    kind: str
    round: Optional[int] = None
    sends: tuple = ()
    recvs: tuple = ()
    shape: Optional[tuple] = None
    dtype: Optional[str] = None
    issue: Optional[int] = None
    seq: int = dataclasses.field(default=-1, compare=False)

    def brief(self) -> str:
        bits = [self.kind]
        if self.round is not None:
            bits.append(f"round {self.round}")
        for name, msgs in (("send", self.sends), ("recv", self.recvs)):
            bits += [f"{name} {'to' if name == 'send' else 'from'} {peer} "
                     f"{tuple(shape)} {dtype}" for peer, shape, dtype in msgs]
        if self.shape is not None:
            bits.append(f"{tuple(self.shape)} {self.dtype}")
        if self.issue is not None:
            bits.append(f"of event {self.issue}")
        return " ".join(bits)

    def to_json(self) -> dict:
        """The event as JSON-ready data (tuples become lists)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "MeshEvent":
        def msgs(m):
            return tuple((int(peer), tuple(shape), dtype) for peer, shape, dtype in m)
        return cls(d["kind"], round=d["round"], sends=msgs(d["sends"]),
                   recvs=msgs(d["recvs"]),
                   shape=None if d["shape"] is None else tuple(d["shape"]),
                   dtype=d["dtype"], issue=d["issue"], seq=d.get("seq", -1))


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


class ScheduleLog:
    """The :class:`MeshEvent`s of one mesh, in program order; ``rank`` is
    the mesh's."""

    def __init__(self, rank: int = -1):
        self.events: list[MeshEvent] = []
        self.rank = rank

    def record(self, kind: str, **fields) -> int:
        """Append one event; returns its index in the log."""
        for obs in OBSERVERS:
            obs.before_mesh_event()
        ev = MeshEvent(kind, seq=next(SEQ), **fields)
        self.events.append(ev)
        index = len(self.events) - 1
        for obs in OBSERVERS:
            obs.on_mesh_event(self, index)
        return index

    def exchange(self, round_: int, sends, recvs) -> int:
        return self.record(
            "exchange", round=round_,
            sends=tuple((int(peer), tuple(t.shape), _dtype_name(t.dtype))
                        for peer, t in sends),
            recvs=tuple((int(peer), tuple(shape), _dtype_name(dtype))
                        for peer, shape, dtype in recvs))

    def since(self, mark: int) -> list[MeshEvent]:
        """The events from index ``mark`` on, with rounds and wait issues
        counted from the first of them: one call's schedule, comparable
        with another run's."""
        evs = self.events[mark:]
        r0 = next((e.round for e in evs if e.round is not None), 0)
        return [dataclasses.replace(
            e, round=None if e.round is None else e.round - r0,
            issue=None if e.issue is None else e.issue - mark) for e in evs]

    def __len__(self) -> int:
        return len(self.events)


@dataclasses.dataclass
class Wire:
    """What one rank's messages cost: bytes copied between the card and
    host memory for a ``gloo`` group, the host seconds those copies took
    (the device is synchronised before each copy to the host, so kernels
    queued before it are not counted there; a copy back to the card may
    wait for kernels queued before it), and the number of message rounds,
    whose running count is each round's tag."""

    staged_bytes: int = 0
    staging_s: float = 0.0
    rounds: int = 0

    def reset(self) -> None:
        self.staged_bytes, self.staging_s = 0, 0.0


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """One rank's view of a one-axis world: ``group`` (None for a world of
    one, which issues no collective), ``axis``, ``size`` ranks, this
    ``rank`` and its ``device``; ``backend`` is the group's."""

    group: object
    axis: str
    size: int
    rank: int
    device: torch.device
    backend: str = "none"
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
        """True when messages pass through host memory (gloo off the CPU)."""
        return self.backend == "gloo" and self.device.type != "cpu"

    # -- host staging --------------------------------------------------------

    def _wire_device(self) -> torch.device:
        return torch.device("cpu") if self.backend == "gloo" else self.device

    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        t = torch.view_as_real(t) if t.is_complex() else t
        t = t.contiguous()
        if not self.staged:
            return t
        torch.cuda.current_stream(t.device).synchronize()
        t0 = time.perf_counter()
        host = t.cpu()
        self.wire.staging_s += time.perf_counter() - t0
        self.wire.staged_bytes += host.numel() * host.element_size()
        return host

    def _from_wire(self, buf: torch.Tensor, complex_: bool) -> torch.Tensor:
        if self.staged:
            t0 = time.perf_counter()
            buf = buf.to(self.device)
            self.wire.staging_s += time.perf_counter() - t0
            self.wire.staged_bytes += buf.numel() * buf.element_size()
        return torch.view_as_complex(buf) if complex_ else buf

    def _recv_buffer(self, shape, dtype: torch.dtype) -> torch.Tensor:
        if dtype.is_complex:
            shape, dtype = tuple(shape) + (2,), dtype.to_real()
        return torch.empty(shape, dtype=dtype, device=self._wire_device())

    # -- messages ------------------------------------------------------------

    def exchange(self, sends, recvs) -> "Pending":
        """Post one round of point-to-point messages: ``sends`` lists
        ``(peer, tensor)``, ``recvs`` lists ``(peer, shape, dtype)``.  Every
        rank of the group calls it at the same point of its program, with or
        without peers, so the rounds' tags agree.  Returns a :class:`Pending`
        whose ``wait()`` gives the received tensors, in ``recvs`` order."""
        tag = self.wire.rounds
        self.wire.rounds += 1
        issue = self.log.exchange(tag, sends, recvs)
        ops, keep, out = [], [], []
        for peer, t in sends:
            w = self._to_wire(t)
            keep.append(w)          # the send buffer lives until the wait
            ops.append(dist.P2POp(dist.isend, w, group=self.group,
                                  group_peer=peer, tag=tag))
        for peer, shape, dtype in recvs:
            b = self._recv_buffer(shape, dtype)
            out.append((b, dtype.is_complex))
            ops.append(dist.P2POp(dist.irecv, b, group=self.group,
                                  group_peer=peer, tag=tag))
        works = dist.batch_isend_irecv(ops) if ops else []
        return Pending(works, lambda: [self._from_wire(b, c) for b, c in out],
                       keep, self.log, issue)

    def all_gather(self, t: torch.Tensor) -> "Pending":
        """Post an all-gather of ``t`` (the same shape on every rank);
        ``wait()`` gives the ``size`` tensors stacked on a new axis 0."""
        issue = self.log.record("all_gather", shape=tuple(t.shape),
                                dtype=_dtype_name(t.dtype))
        if self.group is None:
            return Pending([], lambda: t[None], [], self.log, issue)
        w = self._to_wire(t)
        bufs = [torch.empty_like(w) for _ in range(self.size)]
        work = dist.all_gather(bufs, w, group=self.group, async_op=True)
        return Pending([work], lambda: torch.stack(
            [self._from_wire(b, t.is_complex()) for b in bufs]), [w],
            self.log, issue)

    def all_reduce_max(self, value: float) -> float:
        """The largest ``value`` over the ranks (a host float)."""
        self.log.record("all_reduce_max")
        if self.group is None:
            return float(value)
        t = torch.tensor([value], dtype=torch.float64,
                         device=self._wire_device())
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return float(t.item())

    def barrier(self) -> None:
        self.log.record("barrier")
        if self.group is not None:
            dist.barrier(group=self.group)


class Pending:
    """Messages in flight: ``wait()`` completes them once and returns what
    they delivered on the mesh's device (a list with one tensor per
    receive, or an all-gather's stacked tensors).  The first ``wait()``
    logs a ``wait`` event naming the ``issue`` in ``log``, when given."""

    def __init__(self, works, finish, keep, log: Optional[ScheduleLog] = None,
                 issue: Optional[int] = None):
        self._works, self._finish, self._keep = works, finish, keep
        self._log, self._issue = log, issue
        self._value = None

    def wait(self):
        if self._finish is not None:
            if self._log is not None:
                self._log.record("wait", issue=self._issue)
            for w in self._works:
                w.wait()
            self._value = self._finish()
            self._finish = self._keep = self._works = None
        return self._value


def make_local_mesh(axis: str = "data", device=None) -> RankMesh:
    """A world of one rank, without ``torch.distributed``."""
    return RankMesh(group=None, axis=axis, size=1, rank=0,
                    device=resolve_device(device))


def make_world_mesh(world: int, axis: str = "data", device=None) -> RankMesh:
    """This rank's mesh over the default process group of ``world`` ranks
    (``torch.distributed`` initialised by the caller or :func:`spawn_world`)."""
    if not dist.is_initialized() or dist.get_world_size() != world:
        raise ValueError(f"the default process group must hold {world} ranks")
    return RankMesh(group=dist.group.WORLD, axis=axis, size=world,
                    rank=dist.get_rank(), device=resolve_device(device),
                    backend=str(dist.get_backend()))


def make_group_mesh(members, axis: str = "data", device=None) -> Optional[RankMesh]:
    """A mesh over the ranks ``members`` of the default group, numbered in
    that order.  Every rank of the default group must call it (the group is
    created collectively); those outside ``members`` get None."""
    members = list(members)
    group = dist.new_group(members)
    me = dist.get_rank()
    if me not in members:
        return None
    return RankMesh(group=group, axis=axis, size=len(members),
                    rank=members.index(me), device=resolve_device(device),
                    backend=str(dist.get_backend(group)))


def join_world(store: str, world: int, index: int, *, timeout_s: float,
               device=None, backend: str = "gloo") -> RankMesh:
    """Join this process, as member ``index`` of ``world``, to the group
    whose ``file://`` store is ``store`` (a path that no earlier group
    used), and return its mesh.  For processes started by someone else (a
    supervisor's generation of ranks): every member calls it with the same
    store and world.  The group's collectives, and the wait for the other
    members, time out after ``timeout_s``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=world, rank=index,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return make_world_mesh(world, device=dev)


def _rank_main(rank: int, fn: Callable, world: int, device: str, backend: str,
               root: str, timeout_s: float, args: tuple) -> None:
    if resolve_device(device).type == "cpu":
        torch.set_num_threads(1)
    mesh = join_world(f"{root}/store", world, rank, timeout_s=timeout_s,
                      device=device, backend=backend)
    try:
        out = fn(mesh, *args)
        with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_world(fn: Callable, world: int, *, device=None, backend: str = "gloo",
                timeout_s: float = 300.0, args: tuple = ()) -> list:
    """Run ``fn(mesh, *args)`` on ``world`` new processes, one rank each,
    and return each rank's result (pickled through a temporary directory,
    which also holds the ``file://`` store).

    ``fn`` must be importable by name (``spawn`` pickles it by reference).
    ``device`` (None: the CUDA card) is every rank's device; ranks on the
    CPU use one intra-op thread each.  The group's collectives time out
    after ``timeout_s``, so a rank that raises cannot leave the others
    blocked for ever; if any rank fails, the others are terminated and
    this raises with the failed rank's traceback.
    """
    device = str(resolve_device(device))
    root = tempfile.mkdtemp(prefix="rank_world_")
    try:
        mp.start_processes(_rank_main, args=(fn, world, device, backend, root,
                                             float(timeout_s), tuple(args)),
                           nprocs=world, join=True, start_method="spawn")
        results = []
        for r in range(world):
            with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(root, ignore_errors=True)
