"""Timing on the card: CUDA-event spans and the profiler reader.

:func:`read_profile` extends ``chip_smoke.py:device_profile`` (commit
5f3f6255): device time by kernel name and the union of the device's busy
intervals from ``torch.profiler``, plus the idle gaps named by what the
host was doing.  :class:`Spans` times calls with CUDA events, as
``chip_smoke.py:stage_ms`` does.  Each of them needs a CUDA card and
raises without one: nothing here falls back to the host's clock.
"""
from __future__ import annotations

import bisect
import time

import torch


# the benchmark's own record_function ranges (fmmbench/entries/*.py)
ANNOTATIONS = frozenset({"fmmbench.step", "fmmbench.evaluation", "VortexStepper.maybe_replan"})


def require_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("this measurement needs a CUDA card: "
                           "torch.cuda.is_available() is false")


class Spans:
    """CUDA-event spans by name: ``with spans("rebin"): ...`` records an
    event before and after; :meth:`ms` reads them once the device is done.
    ``group`` collects the spans recorded while it is open, so a caller can
    sum the stages of one evaluation."""

    def __init__(self):
        require_card()
        self.marks: dict[str, list] = {}
        self.groups: list[list] = []
        self._open: list | None = None

    def __call__(self, name: str):
        return _Span(self, name)

    def begin_group(self) -> None:
        self._open = []

    def end_group(self) -> None:
        if self._open is not None:
            self.groups.append(self._open)
        self._open = None

    def ms(self, name: str) -> list[float]:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.marks.get(name, [])]

    def group_ms(self) -> list[float]:
        torch.cuda.synchronize()
        return [sum(a.elapsed_time(b) for a, b in g) for g in self.groups]


class _Span:
    def __init__(self, spans: Spans, name: str):
        self.spans, self.name = spans, name

    def __enter__(self):
        self.a = torch.cuda.Event(enable_timing=True)
        self.a.record()
        return self

    def __exit__(self, *exc):
        b = torch.cuda.Event(enable_timing=True)
        b.record()
        self.spans.marks.setdefault(self.name, []).append((self.a, b))
        if self.spans._open is not None:
            self.spans._open.append((self.a, b))
        return False


class Profile:
    """torch.profiler over a stretch of the window: :meth:`start` and
    :meth:`stop` bracket it (each after a device sync), and the host's
    clock gives the stretch's length."""

    def __init__(self):
        require_card()
        self.prof = None
        self.window_s = None

    @staticmethod
    def warm() -> None:
        """Start and stop the profiler once on a small operation, so that
        the tracer's first start (seconds) falls in set-up."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self.prof is None or self.window_s is not None:
            return
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)


def read_profile(prof, window_s: float, top: int = 10) -> dict | None:
    """Device time by kernel name, busy seconds (the union of the device's
    intervals), and the idle gaps named by the innermost host event that
    spans each gap's middle.  None when the profiler saw no device event."""
    events = list(prof.events())
    # a record_function range also shows on the device's timeline, spanning
    # the kernels it launched: it is no operation, so it counts as no busy time
    dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)
                 and e.name not in ANNOTATIONS)
    if not dev:
        return None
    by_name: dict[str, float] = {}
    busy = []                               # merged (start, end) intervals, us
    for start, end, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        if busy and start <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], end)
        else:
            busy.append([start, end])
    busy_us = sum(b - a for a, b in busy)
    host = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU)
    starts = [h[0] for h in host]
    gaps: dict[str, float] = {}
    for (_, a), (b, _) in zip(busy[:-1], busy[1:]):
        mid = (a + b) / 2
        name = "(no host event)"
        # the latest-starting host event that still spans the middle is the
        # innermost one; look back a bounded way
        for i in range(bisect.bisect_right(starts, mid) - 1,
                       max(bisect.bisect_right(starts, mid) - 512, -1), -1):
            if host[i][1] >= mid:
                name = host[i][2]
                break
        gaps[name] = gaps.get(name, 0.0) + (b - a)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"busy_s": busy_us / 1e6, "window_s": window_s,
            "kernel_s": {k: v / 1e6 for k, v in by_name.items()},
            "device_ops": [[k[:120], v / 1e6] for k, v in ranked[:top]],
            "idle_gaps": [[k[:120], v / 1e6] for k, v in
                          sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]}


def kernel_s(profile: dict, *names: str) -> float:
    """Device seconds of the kernels whose name holds one of ``names``."""
    return sum(s for k, s in profile["kernel_s"].items() if any(n in k for n in names))
