"""Spans of the port's own stages, kept in memory.

    with spans.span("fmm.p2m", device=tree.device):
        ...

records one :class:`Record`: the span's name, its id, its parent's id and
its root's id (the outermost span open when it started: a stepper step, or
an evaluation called alone), its host start and end on one monotonic clock
(``time.perf_counter_ns``), an optional ``level``, and, for a span given a
CUDA ``device`` (a device span) in a timed root, the device milliseconds
between two CUDA events recorded on that device's current stream.  One
root in every :data:`TIMED_EVERY` is timed (``Record.timed``, the same on
every span of the root): an event costs about as much host time as a
kernel launch, so device time is sampled over the roots, which are alike,
rather than paid for in each.  The events come from a pool and are read
only by :func:`take`, which returns the records and clears them: no span
synchronises the device or reads a tensor.  Only the spans whose device
time a reader uses are device spans; the rest are host spans.
:func:`traced` makes a whole function call one host span.

Spans are recorded while the recorder is enabled (:func:`enable`) or while
``torch.profiler`` runs; in the second case the recorder holds at most
:data:`HELD` records, so a profile that nobody takes from leaves a bounded
buffer.  While the profiler runs each span also opens a profiler range of
its name (``torch._C._profiler._RecordFunctionFast`` where the build has
it, else ``torch.profiler.record_function``), so the program's stages
stand on the host side of the device trace's clock and name its idle gaps.
Otherwise :func:`span` reads one flag and the profiler's state and returns
a shared null context: no event, no range, no record.

Names are fixed, since readers match them whole: ``stepper.*`` and
``replan.*`` (``core/stepper.py``), ``rk2.*`` (``rk2_step``), ``fmm.*``
(``core/fmm.py``), ``m2l.stage``/``m2l.unstage`` and ``p2p.stage`` (the
layouts around the M2L contraction and the P2P halo pads),
``quadtree.build_tree``.  The launch counters of ``kernels/`` are apart.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import threading
import time
from typing import Optional

import torch
from torch.autograd import _profiler_enabled

__all__ = ["Record", "span", "traced", "enable", "disable", "take", "HELD",
           "TIMED_EVERY"]

HELD = 1 << 14            # records held while only a profiler turns spans on
TIMED_EVERY = 4           # one root in this many records its device spans' events

_ENABLED = False
_records: list = []       # closed spans, in the order they closed
_pending: list = []       # (record, start event, end event, pool key) not yet read
_free: dict = {}          # CUDA device index -> timing events free for reuse
_ids = itertools.count(1)
_roots = itertools.count()
_local = threading.local()
_range_type = None


@dataclasses.dataclass(slots=True)
class Record:
    name: str
    id: int
    parent: Optional[int]     # None for a root
    root: int                 # the id of the outermost span open at the start
    timed: bool = False       # the root's device spans record CUDA events
    t0_ns: int = 0
    t1_ns: int = 0
    level: Optional[int] = None
    device_ms: Optional[float] = None   # CUDA-event ms; None for a host span

    @property
    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e6


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _range(name: str):
    """A profiler range of ``name``: the C++ fast range where there is one
    (a few times cheaper on the host than ``record_function``)."""
    global _range_type
    if _range_type is None:
        try:
            from torch._C._profiler import _RecordFunctionFast as _range_type
        except ImportError:
            _range_type = torch.profiler.record_function
    return _range_type(name)


def _event(key: int):
    free = _free.get(key)
    return free.pop() if free else torch.cuda.Event(enable_timing=True)


class _Span:
    __slots__ = ("name", "device", "level", "rec", "range", "events")

    def __init__(self, name: str, device, level):
        self.name, self.device, self.level = name, device, level

    def __enter__(self):
        self.range = self.rec = self.events = None
        if _profiler_enabled():
            self.range = _range(self.name)
            self.range.__enter__()
        stack = _stack()
        if not _ENABLED and len(_records) + len(stack) >= HELD:
            return None
        i = next(_ids)
        parent = stack[-1] if stack else None
        if parent is None:
            self.rec = Record(self.name, i, None, i, next(_roots) % TIMED_EVERY == 0,
                              level=self.level)
        else:
            self.rec = Record(self.name, i, parent.id, parent.root, parent.timed,
                              level=self.level)
        stack.append(self.rec)
        if self.rec.timed and self.device is not None and self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            key = stream.device.index
            self.events = (stream, _event(key), _event(key), key)
            self.events[1].record(stream)
        self.rec.t0_ns = time.perf_counter_ns()
        return self.rec

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            rec.t1_ns = time.perf_counter_ns()
            _stack().pop()
            if self.events is not None:
                stream, start, end, key = self.events
                end.record(stream)
                _pending.append((rec, start, end, key))
            _records.append(rec)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str, device=None, level: Optional[int] = None):
    """A context manager that records the span ``name``; ``device`` (a
    ``torch.device``: a CUDA one adds the span's device time) and ``level``
    are optional.  A shared null context while the recorder is off and no
    profiler runs."""
    if not _ENABLED and not _profiler_enabled():
        return _NULL
    return _Span(name, device, level)


def traced(name: str):
    """Decorator: each call of the function is the host span ``name``.
    Off, the call costs the same check as :func:`span` and nothing more."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _ENABLED and not _profiler_enabled():
                return fn(*args, **kwargs)
            with _Span(name, None, None):
                return fn(*args, **kwargs)
        return call
    return wrap


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def take() -> list:
    """The closed spans' records in the order they started, each device
    span's ``device_ms`` read (waiting for its end event); clears them and
    returns the events to the pool."""
    global _records, _pending
    records, pending = _records, _pending
    _records, _pending = [], []
    for rec, start, end, key in pending:
        end.synchronize()
        rec.device_ms = start.elapsed_time(end)
        _free.setdefault(key, []).extend((start, end))
    records.sort(key=lambda r: r.id)
    return records
