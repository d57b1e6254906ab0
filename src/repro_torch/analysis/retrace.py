"""Cache-miss accounting with argument blame.

The port's counterpart of ``src/repro/analysis/retrace.py``.  The port
compiles nothing at call time, but it keeps caches whose misses cost real
time: the launch-configuration checks of the kernel wrappers (each asks the
library how it would launch), the expansion operators (built in f64 on the
host and copied to the device), the service's batched entries (its
counterpart of a jit cache, ``fmm_service.BATCHED_ENTRIES``) and the kernel
builds (``nvcc``, minutes cold).  An *unexpected* miss means a key stopped
comparing equal: a plan rebuilt as a fresh non-equal object, an equation
spec losing its value identity, a shape wobble where a re-level should have
kept the tree.

:func:`cache_registry` names every such cache and reads its misses.
:class:`RetraceMonitor` wraps a callable and reads the registry across each
call; ``expect_hit``/``expect_miss`` assert the outcome and name the caches
that missed; on an unexpected miss :func:`signature_of` and
:func:`diff_signatures` name the arguments that changed since the last
call.  :func:`run_session` and :func:`run_serve_session` script the
reference's lifecycles step for step, a hit being "no new cache entry" and
a miss "new entries".

The reference's host-leaf step (numpy leaves keying a separate jit entry)
has no torch counterpart: the port's entry points take tensors only, and a
host array where a tensor belongs raises (``configs/backend.py:check_on``),
as the kernel wrappers do for a tensor off the card.  The serving session
pins that raise in its place.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["RetraceMonitor", "RetraceViolation", "SessionEvent",
           "cache_registry", "cache_misses", "clear_caches", "signature_of",
           "diff_signatures", "run_session", "run_serve_session"]


class RetraceViolation(AssertionError):
    """An unexpected cache outcome, with the blamed caches and arguments."""


def _lru_caches() -> dict:
    from ..core import expansions as ex
    from ..core import fmm, parallel_fmm
    from ..kernels import flash_attn, m2l, ops, p2p

    return {
        "p2p._check_stream_split": p2p._check_stream_split,
        "m2l._check_wide_config": m2l._check_wide_config,
        "ops.folded_operator": ops.folded_operator,
        "flash_attn._simt_plan": flash_attn._simt_plan,
        "expansions.m2m_operator": ex.m2m_operator,
        "expansions.l2l_operator": ex.l2l_operator,
        "expansions.m2l_operator": ex.m2l_operator,
        "expansions.m2l_folded_operator": ex.m2l_folded_operator,
        "expansions.device_operator": ex._device_operator,
        "fmm._centers_on": fmm._centers_on,
        "parallel_fmm._owner_maps": parallel_fmm._owner_maps,
        "parallel_fmm._gather_index": parallel_fmm._gather_index,
        "parallel_fmm._scatter_index": parallel_fmm._scatter_index,
    }


def cache_registry() -> dict[str, Callable[[], int]]:
    """``{cache name: () -> misses so far}`` for every cache the port
    keeps across calls: the ``lru_cache``s (their ``misses``), the
    service's batched entries (distinct launch configurations) and the
    kernel libraries loaded (``kernels/_build.py``)."""
    from ..kernels import _build
    from ..serve import fmm_service as svc

    reg = {name: (lambda f=f: f.cache_info().misses)
           for name, f in _lru_caches().items()}
    for name, entries in svc.BATCHED_ENTRIES.items():
        reg[f"fmm_service.{name}"] = lambda e=entries: len(e)
    reg["_build.libraries"] = lambda: len(_build._LIBS)
    return reg


def cache_misses() -> dict[str, int]:
    return {name: read() for name, read in cache_registry().items()}


def clear_caches() -> None:
    """Empty every cache of the registry but the kernel libraries, so the
    next call starts cold (a session's first step)."""
    from ..serve import fmm_service as svc

    for f in _lru_caches().values():
        f.cache_clear()
    for entries in svc.BATCHED_ENTRIES.values():
        entries.clear()


def _describe(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return f"tensor{tuple(leaf.shape)}:{str(leaf.dtype).removeprefix('torch.')}" \
               f":{leaf.device.type}"
    if isinstance(leaf, np.ndarray):
        return f"array{tuple(leaf.shape)}:{leaf.dtype}:host"
    return repr(leaf)


def signature_of(args, kwargs) -> dict:
    """Flatten a call into ``{path: descriptor}``: tensors become
    (shape, dtype, device), host arrays are tagged ``:host``, dataclasses
    (a ``Tree``) are walked field by field, and everything else becomes its
    repr, the value a cache keys on."""
    sig = {}

    def walk(path, x):
        if isinstance(x, (tuple, list)):
            for i, v in enumerate(x):
                walk(f"{path}[{i}]", v)
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(f"{path}[{k!r}]", v)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type) and \
                any(isinstance(getattr(x, f.name), (torch.Tensor, np.ndarray))
                    for f in dataclasses.fields(x)):
            for f in dataclasses.fields(x):
                walk(f"{path}.{f.name}", getattr(x, f.name))
        else:
            sig[path] = _describe(x)

    walk("[0]", tuple(args))
    walk("[1]", dict(kwargs))
    return sig


def diff_signatures(old: Optional[dict], new: dict) -> list:
    """Per-argument differences, ``['path: old -> new', ...]``."""
    if old is None:
        return ["<first call>"]
    out = []
    for key in sorted(set(old) | set(new)):
        a, b = old.get(key, "<absent>"), new.get(key, "<absent>")
        if a != b:
            out.append(f"{key}: {a} -> {b}")
    return out or ["<signatures identical: a key that compares by identity>"]


@dataclasses.dataclass
class SessionEvent:
    step: str                  # script step label, e.g. "replan-equal"
    expected: str              # "hit" | "miss" | "raise" | a pinned count
    got: str
    blame: list                # argument diffs when the outcome surprised
    caches: list = dataclasses.field(default_factory=list)   # caches that missed

    @property
    def ok(self) -> bool:
        return self.expected == self.got

    def __str__(self):
        state = "OK  " if self.ok else "FAIL"
        missed = f" caches: {', '.join(self.caches)}" if self.caches else ""
        extra = f" blame: {'; '.join(self.blame)}" if (
            self.blame and not self.ok) else ""
        return f"[{state}] {self.step}: expected {self.expected}, " \
               f"got {self.got}{missed}{extra}"


class RetraceMonitor:
    """Watch the cache registry across the calls of one callable."""

    def __init__(self, fn: Callable, name: str = ""):
        if not callable(fn):
            raise TypeError(f"{fn!r} is not callable")
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "callable")
        self.events: list = []
        self._last_sig: Optional[dict] = None

    def call(self, *args, expect: Optional[str] = None, step: str = "call",
             strict: bool = True, **kwargs):
        """Call through, recording which caches gained entries.  ``expect``
        is "hit"/"miss"/None; a violated expectation raises
        :class:`RetraceViolation` (``strict=False`` records it only)."""
        before = cache_misses()
        out = self.fn(*args, **kwargs)
        after = cache_misses()
        missed = sorted(k for k in after if after[k] != before.get(k))
        got = "miss" if missed else "hit"
        sig = signature_of(args, kwargs)
        blame = diff_signatures(self._last_sig, sig) if got == "miss" else []
        self._last_sig = sig
        ev = SessionEvent(step=step, expected=expect or got, got=got,
                          blame=blame, caches=missed)
        self.events.append(ev)
        if strict and expect is not None and not ev.ok:
            raise RetraceViolation(
                f"{self.name}: unexpected {got} at step {step!r} "
                f"(caches that missed: {', '.join(missed) or 'none'}); "
                f"arguments changed: {'; '.join(blame) or 'none'}")
        return out

    def expect_hit(self, *args, step: str = "hit", **kwargs):
        return self.call(*args, expect="hit", step=step, **kwargs)

    def expect_miss(self, *args, step: str = "miss", **kwargs):
        return self.call(*args, expect="miss", step=step, **kwargs)

    def expect_raise(self, *args, step: str = "raise", **kwargs) -> None:
        """Record whether the call raises; a host array where a tensor
        belongs must."""
        try:
            self.fn(*args, **kwargs)
            got = "no raise"
        except (TypeError, ValueError) as e:
            got, why = "raise", f"{type(e).__name__}: {e}"
        self.events.append(SessionEvent(step=step, expected="raise", got=got,
                                        blame=[] if got == "raise" else
                                        ["host arrays were accepted"],
                                        caches=[]))
        if got == "raise":
            self.events[-1].blame = [why]

    @property
    def ok(self) -> bool:
        return all(e.ok for e in self.events)

    def report(self) -> str:
        head = f"retrace monitor [{self.name}]: " + \
               ("OK" if self.ok else "VIOLATIONS")
        return "\n".join([head] + [f"  {e}" for e in self.events])


def run_session(level: int = 3, p: int = 4, n: int = 400, device=None) -> list:
    """The scripted stepper lifecycle on a mesh of one rank (the CLI's
    retrace section), from cold caches.  Steps, as the reference's:

    * cold ``rk2_step``                           -> miss
    * steady second step                          -> hit
    * replan onto an EQUAL plan (fresh object)    -> hit (plans compare by value)
    * re-level (the tree's shape changes)         -> miss
    * checkpoint restore (host copy, back on the device) -> hit
    * ``parallel_fmm_evaluate`` equation switch   -> miss, miss, then hit
      both ways, an equal ``LaplaceEquation()`` instance included

    Returns the event list; any ``not ev.ok`` entry is a finding.
    """
    from ..configs.backend import resolve_device
    from ..core import equations as eqs
    from ..core import parallel_fmm as pf
    from ..core import stepper as stp
    from ..core.cost_model import ModelParams
    from ..core.plan import plan_from_counts
    from ..core.quadtree import Tree, build_tree
    from ..launch.mesh import make_local_mesh

    dev = resolve_device(device)
    mesh = make_local_mesh(device=dev)
    clear_caches()
    rng = np.random.default_rng(0)
    pos = rng.uniform(0.05, 0.95, size=(n, 2))
    gamma = rng.normal(size=n)
    tree, index = build_tree(pos, gamma, level, sigma=0.02, device=dev)
    params = ModelParams(level=level, cut=2, p=p, slots=tree.slots)
    plan = plan_from_counts(index.counts, params, 1, method="model")

    mon = RetraceMonitor(stp.TRACE_ENTRY_POINTS["rk2_step"], "rk2_step")
    kw = dict(p=p, mesh=mesh, strict=False)
    mon.call(tree, 1e-4, plan=plan, expect="miss", step="cold-compile", **kw)
    mon.call(tree, 1e-4, plan=plan, expect="hit", step="steady-step", **kw)
    # replan: a fresh plan object with identical content keys the same entries
    plan2 = plan_from_counts(index.counts, params, 1, method="model")
    mon.call(tree, 1e-4, plan=plan2, expect="hit", step="replan-equal", **kw)
    tree_up, index_up = build_tree(pos, gamma, level + 1, sigma=0.02, device=dev)
    params_up = ModelParams(level=level + 1, cut=2, p=p, slots=tree_up.slots)
    plan_up = plan_from_counts(index_up.counts, params_up, 1, method="model")
    mon.call(tree_up, 1e-4, plan=plan_up, expect="miss", step="re-level", **kw)
    # checkpoint restore: through host memory (a checkpoint's numpy arrays)
    # and back onto the device, same shapes: no new entry
    host = {k: getattr(tree, k).cpu().numpy() for k in ("z", "q", "mask")}
    restored = Tree(z=torch.as_tensor(host["z"], device=dev),
                    q=torch.as_tensor(host["q"], device=dev),
                    mask=torch.as_tensor(host["mask"], device=dev),
                    level=tree.level, sigma=tree.sigma)
    mon.call(restored, 1e-4, plan=plan, expect="hit", step="checkpoint-restore",
             **kw)

    ltree, _ = build_tree(pos, gamma, level, sigma=0.02,
                          charge_scale=eqs.LAPLACE.charge_scale, device=dev)
    # a second entry point starts cold, as the reference's second jitted
    # function has its own cache (the port's caches are shared)
    clear_caches()
    mon2 = RetraceMonitor(pf.TRACE_ENTRY_POINTS["parallel_fmm_evaluate"],
                          "parallel_fmm_evaluate")
    kw = dict(mesh=mesh, strict=False)
    mon2.call(tree, p, expect="miss", step="vortex-cold", **kw)
    mon2.call(ltree, p, eq=eqs.LAPLACE, expect="miss", step="switch-laplace", **kw)
    mon2.call(tree, p, expect="hit", step="switch-back-vortex", **kw)
    # a re-built spec INSTANCE equal to the registered one keys the same entries
    mon2.call(ltree, p, eq=eqs.LaplaceEquation(), expect="hit",
              step="fresh-spec-instance", **kw)
    return mon.events + mon2.events


def run_serve_session(level: int = 2, p: int = 6, n: int = 90,
                      device=None) -> list:
    """The scripted serving lifecycle over the batched entry points, from
    cold caches.  A bucket (``BucketKey`` and capacity) is one entry of
    ``BATCHED_ENTRIES``; steady serving adds none.  Steps, as the
    reference's:

    * cold bucket (first batch of a shape)             -> miss
    * steady wave: same bucket, FRESH charge values    -> hit
    * second bucket (bigger slot capacity)             -> miss
    * switch back to the first bucket                  -> hit
    * probe-grid entry: cold, then steady              -> miss, hit
    * entry-count pin: the batched entries grew by exactly the 3 buckets
    * host leaves (numpy batches) -> raise, where the reference's jit
      keyed a separate entry (the module docstring says why)
    """
    from ..configs.backend import resolve_device
    from ..core import equations as eqs
    from ..core.quadtree import build_tree
    from ..serve import fmm_service as svc

    dev = resolve_device(device)
    clear_caches()
    rng = np.random.default_rng(7)
    sigma = 0.02

    def batch(n_jobs, slots):
        trees = []
        for _ in range(n_jobs):
            pos = rng.uniform(0.05, 0.95, size=(n, 2))
            t, _ = build_tree(pos, rng.normal(size=n), level, sigma=sigma,
                              slots=slots, device=dev)
            trees.append(t)
        return svc.stack_trees(trees, n_jobs)

    base = svc.batched_cache_entries()
    kw = dict(level=level, sigma=sigma, p=p, eq=eqs.VORTEX, strict=False)

    mon = RetraceMonitor(svc.TRACE_ENTRY_POINTS["batched_fmm_eval"],
                         "batched_fmm_eval")
    z, q, m = batch(2, slots=16)
    mon.call(z, q, m, expect="miss", step="cold-bucket-compile", **kw)
    z2, q2, m2 = batch(2, slots=16)
    mon.call(z2, q2, m2, expect="hit", step="steady-wave-fresh-values", **kw)
    zb, qb, mb = batch(2, slots=32)
    mon.call(zb, qb, mb, expect="miss", step="second-bucket", **kw)
    mon.call(z, q, m, expect="hit", step="switch-back-bucket", **kw)

    mon2 = RetraceMonitor(svc.TRACE_ENTRY_POINTS["batched_fmm_eval_targets"],
                          "batched_fmm_eval_targets")
    tz, _, tm = batch(2, slots=16)
    mon2.call(z, q, m, tz, tm, expect="miss", step="targets-cold", **kw)
    mon2.call(z2, q2, m2, tz, tm, expect="hit", step="targets-steady", **kw)

    delta = svc.batched_cache_entries() - base
    mon.events.append(SessionEvent(
        step="entry-count-pin", expected="3 entries", got=f"{delta} entries",
        blame=[] if delta == 3 else
        ["batched entries grew past the scripted bucket count: a bucket key "
         "does not compare by value"]))

    kw.pop("strict")
    mon.expect_raise(z.cpu().numpy(), q.cpu().numpy(), m.cpu().numpy(),
                     step="host-leaf-footgun", **kw)
    return mon.events + mon2.events
