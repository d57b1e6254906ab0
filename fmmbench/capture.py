"""What the entries share: the sample of captured calls and the wrappers.

:class:`Recorder` keeps a reservoir of ``k`` of the window's steps (or
evaluations), drawn from a seeded generator as they come, by reference:
no copy and no device work.  :class:`Patches` sets the benchmark's
wrappers as attributes of the program's modules and takes them off again;
:func:`trace_spans` adds the ``--trace 1`` wrappers: CUDA-event spans
around the expansion stages (grouped by evaluation) and, inside the
profiled stretch, around each P2P and M2L launch; :class:`Stretch` runs
the profiler over a steady stretch of the window; :func:`closed_loop` is
the window.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from fmmbench import profiling


class Recorder:
    """Reservoir of ``k`` steps' captures, drawn from ``rng`` as steps come."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng = k, rng
        self.kept: list = [None] * k
        self.seen = 0
        self.current = None
        self._slot = None

    def begin(self) -> None:
        i, self.seen = self.seen, self.seen + 1
        slot = i if i < self.k else int(self.rng.integers(0, i + 1))
        self._slot = slot if slot < self.k else None
        self.current = None if self._slot is None else {"index": i, "evals": [], "rebins": []}

    def commit(self) -> None:
        if self.current is not None:
            self.kept[self._slot] = self.current
        self.current = None

    def nbytes(self) -> int:
        """Bytes of the storages the kept captures hold, each counted once
        (at most what they add to the device's peak: a storage the program
        still holds is counted too)."""
        seen: dict = {}

        def walk(x):
            if isinstance(x, torch.Tensor):
                st = x.untyped_storage()
                seen[(x.device, st.data_ptr())] = st.nbytes()
            elif isinstance(x, dict):
                for v in x.values():
                    walk(v)
            elif isinstance(x, (list, tuple)):
                for v in x:
                    walk(v)
            elif dataclasses.is_dataclass(x):
                walk(vars(x))
        walk(self.kept)
        return sum(seen.values())


class Patches:
    """Module attributes replaced by wrappers, put back by :meth:`remove`."""

    def __init__(self):
        self.saved = []

    def set(self, module, name: str, new) -> None:
        self.saved.append((module, name, getattr(module, name)))
        setattr(module, name, new)

    def remove(self) -> None:
        for module, name, orig in reversed(self.saved):
            setattr(module, name, orig)
        self.saved = []


def trace_spans(patches: Patches, state) -> None:
    """Time the expansion stages and, while ``state.in_stretch``, the P2P
    and M2L launches into ``state.spans``."""
    from repro_torch.core import expansions, fmm
    from repro_torch.kernels import m2l, p2p

    def stage(orig):
        def call(*args, **kwargs):
            with state.spans("expansions"):
                return orig(*args, **kwargs)
        return call

    def kernel(name, orig):
        def call(*args, **kwargs):
            if not state.in_stretch:
                return orig(*args, **kwargs)
            with state.spans(f"{name}_kernel"):
                return orig(*args, **kwargs)
        return call

    for module, name in ((fmm, "upward_sweep"), (expansions, "l2l"), (expansions, "l2p_eval")):
        patches.set(module, name, stage(getattr(module, name)))
    patches.set(p2p, "p2p_cuda", kernel("p2p", p2p.p2p_cuda))
    patches.set(m2l, "m2l_cuda", kernel("m2l", m2l.m2l_cuda))


class Stretch:
    """The profiled stretch of a traced window: ``steps`` steps from step
    ``start`` under torch.profiler, with the P2P and M2L launches counted
    across it.  Off (every method a no-op) in an untraced run."""

    def __init__(self, state, params: dict, on: bool):
        self.state, self.on = state, on
        self.start, self.steps = int(params["start"]), int(params["steps"])
        self.prof = profiling.Profile() if on else None
        self.launches = None
        self.done = 0

    @staticmethod
    def _counters():
        from repro_torch.kernels import m2l, p2p
        return p2p.LAUNCHES, m2l.LAUNCHES

    def before(self, i: int) -> None:
        if self.on and i == self.start:
            self.prof.start()
            self.state.in_stretch = True
            self.launches = self._counters()

    def after(self, n: int) -> None:
        if self.on and self.state.in_stretch and n >= self.start + self.steps:
            self.stop(n)

    def stop(self, n: int) -> None:
        if not (self.on and self.state.in_stretch):
            return
        self.prof.stop()
        self.state.in_stretch = False
        p1, m1 = self._counters()
        self.launches = {"p2p": p1 - self.launches[0], "m2l": m1 - self.launches[1]}
        self.done = n - self.start

    def trace(self, spans: dict, evaluations: list, kick_ops_per_step: int) -> dict:
        """The trace the per-layer readers read."""
        prof = None
        if self.prof.prof is not None:
            prof = profiling.read_profile(self.prof.prof, self.prof.window_s)
        return {"spans": spans, "profile": prof,
                "stretch": {"steps": self.done, "evaluations": evaluations,
                            "launches": self.launches if self.done else {"p2p": 0, "m2l": 0},
                            "window_s": self.prof.window_s},
                "stretch_start": self.start, "kick_ops_per_step": kick_ops_per_step}


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def closed_loop(state, ctx, one) -> tuple[list, float]:
    """The window: ``one(i)`` back to back for ``ctx.seconds``, each ending
    in a device sync, the profiled stretch among them.  ``one`` returns
    False to end the window early.  Returns the seconds of each step and
    of the window (up to the end of its last step)."""
    state.stretch = Stretch(state, ctx.cell.traffic["trace"], ctx.trace)
    times = []
    t_start = time.perf_counter()
    deadline = t_start + ctx.seconds
    t_end = t_start
    while True:
        state.stretch.before(len(times))
        t0 = time.perf_counter()
        if t0 >= deadline or one(len(times)) is False:
            break
        sync(ctx.device)
        t_end = time.perf_counter()
        times.append(t_end - t0)
        state.stretch.after(len(times))
    state.stretch.stop(len(times))
    return times, t_end - t_start
