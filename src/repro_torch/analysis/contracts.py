"""Declarative trace contracts over what one call of an entry point does.

The port's counterpart of ``src/repro/analysis/contracts.py``.  A
:class:`TraceContract` states one structural invariant of an entry point,
"no tensor with a 680-wide dimension", "4 exchange directions", "the
all-gather is issued 32 operations before its wait", and checks it against
a :class:`Traced` call: the :class:`~repro_torch.launch.trace_analysis.OpTrace`
of one run (aten operations, kernel launches, mesh events) plus what the
run did to its inputs.  The reference reads StableHLO and HLO text; the
port has neither, so a contract reads the run itself.

Why structure, not numerics: a regression that stages the ``(nb, 40p)``
M2L gather buffer again, or syncs the host inside the step, gives the same
numbers and a silent slowdown; the contract makes it a failed check with a
name.

Pair contracts (:func:`fewer_bytes`, :func:`issue_depth_grows`) compare two
traced calls: "folded beats masked-40" and "pipelining grows the overlap
window".

Declaring a contract: subclass :class:`TraceContract`, implement
``measure(traced)`` and ``check(traced) -> ContractResult``, give it a
stable ``name``, add it to the catalog in :mod:`repro_torch.analysis.check`
and a planted violation to ``tests/test_torch_analysis.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..kernels import ops as kops
from ..launch.trace_analysis import (OpTrace, analyze_trace,
                                     collective_issue_depths, input_tensors,
                                     shape_dim_hits)

__all__ = [
    "ContractResult", "Traced", "TraceContract", "PairContract",
    "collective_count", "evaluate", "fewer_bytes", "format_results",
    "issue_depth_grows", "launch_count", "min_issue_depth", "no_f64_upcast",
    "no_host_callback", "no_plain_calls", "no_staging_dim", "not_donated",
    "sentinel_free", "violations",
]


@dataclasses.dataclass(frozen=True)
class ContractResult:
    contract: str          # contract name, e.g. "no_staging_dim(680)"
    ok: bool
    detail: str            # measured value / first offending record
    target: str = ""       # entry-point label, filled in by evaluate()

    def __str__(self):
        state = "OK  " if self.ok else "FAIL"
        tgt = f" @ {self.target}" if self.target else ""
        return f"[{state}] {self.contract}{tgt}: {self.detail}"


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes, so NaNs compare equal to themselves."""
    t = torch.view_as_real(t) if t.is_complex() else t
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


class Traced:
    """One call of ``fn(*args, **kwargs)`` run under :class:`OpTrace`: the
    counterpart of ``Lowered``.

    One untraced call comes first, so the trace is the steady state: the
    operator and launch-configuration caches are filled, as a jitted
    program's constants are.  On CUDA inputs the traced
    call runs under ``torch.cuda.set_sync_debug_mode("error")`` (unless
    ``sync_debug=False``): a host sync raises there, and is kept as
    ``sync_error`` for :func:`no_host_callback` to report.  Every input
    tensor's ``_version`` and bytes are compared before and after (a write
    that a kernel makes through ``ctypes`` bumps no version).
    ``plain_calls`` is the rise of ``ops.PLAIN_CALLS`` over the call.
    """

    def __init__(self, fn: Callable, *args, label: str = "",
                 sync_debug: Optional[bool] = None, **kwargs):
        self.label = label or getattr(fn, "__name__", "entry")
        inputs = input_tensors((args, kwargs))
        cuda = any(t.is_cuda for t in inputs)
        fn(*args, **kwargs)
        versions = [t._version for t in inputs]
        before = [_bits(t).clone() for t in inputs]
        plain0 = kops.PLAIN_CALLS
        self.sync_error = ""
        self.trace = OpTrace((args, kwargs))
        debug = cuda if sync_debug is None else sync_debug
        old = torch.cuda.get_sync_debug_mode() if debug else None
        try:
            if debug:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            with self.trace:
                self.out = fn(*args, **kwargs)
        except RuntimeError as e:
            if not debug or "synchroniz" not in str(e):
                raise
            self.sync_error = str(e).splitlines()[0][:160]
            self.out = None
        finally:
            if debug:
                torch.cuda.set_sync_debug_mode(old)
        self.plain_calls = kops.PLAIN_CALLS - plain0
        self.version_changes = [i for i, (t, v) in enumerate(zip(inputs, versions))
                                if t._version != v]
        self.value_changes = [i for i, (t, b) in enumerate(zip(inputs, before))
                              if not torch.equal(_bits(t), b)]
        self._stats = None

    @classmethod
    def from_trace(cls, trace: OpTrace, label: str = "trace") -> "Traced":
        """A :class:`Traced` around records made elsewhere (tests plant
        violations this way, or trace a block of code by hand)."""
        self = cls.__new__(cls)
        self.label, self.trace, self.out = label, trace, None
        self.sync_error, self.plain_calls = "", 0
        self.version_changes, self.value_changes = [], []
        self._stats = None
        return self

    @property
    def records(self) -> list:
        return self.trace.records

    @property
    def stats(self) -> dict:
        if self._stats is None:
            self._stats = analyze_trace(self.trace)
        return self._stats


class TraceContract:
    """One structural invariant over a single traced call."""

    name = "trace-contract"

    def measure(self, traced: Traced):
        """The quantity the contract constrains (for diagnostics)."""
        raise NotImplementedError

    def check(self, traced: Traced) -> ContractResult:
        raise NotImplementedError

    def _result(self, ok: bool, detail: str) -> ContractResult:
        return ContractResult(self.name, bool(ok), detail)


class PairContract:
    """A comparative invariant between two traced calls (a, b)."""

    name = "pair-contract"

    def check_pair(self, a: Traced, b: Traced) -> ContractResult:
        raise NotImplementedError

    def _result(self, ok: bool, detail: str) -> ContractResult:
        return ContractResult(self.name, bool(ok), detail)


# ---------------------------------------------------------------------------
# the catalog of contract classes
# ---------------------------------------------------------------------------


class _NoRecord(TraceContract):
    """Shared body of the absence contracts: no record may match ``pred``
    (or, with ``hits``, ``hits(traced)`` must be empty)."""

    def __init__(self, name: str, pred: Optional[Callable], why: str,
                 hits: Optional[Callable] = None):
        self.name, self.why = name, why
        self._find = hits or (lambda traced: [r for r in traced.records
                                              if pred(r)])

    def _hits(self, traced: Traced) -> list:
        return self._find(traced)

    def measure(self, traced: Traced) -> int:
        return len(self._hits(traced))

    def check(self, traced: Traced) -> ContractResult:
        hits = self._hits(traced)
        if not hits:
            return self._result(True, self.why)
        return self._result(False, f"{self.why} violated ({len(hits)}x): "
                                   f"{hits[0].brief()[:160]}")


def no_staging_dim(dim: int) -> TraceContract:
    """No traced tensor has a ``dim``-sized dimension: the M2L no-staging
    pin.  The pre-folding wrapper materialized a (nb, 40p) gather buffer,
    so any 40p-wide shape is the regression signature."""
    return _NoRecord(f"no_staging_dim({dim})", None, f"no {dim}-wide tensor",
                     hits=lambda traced: shape_dim_hits(traced.trace, int(dim)))


_F64 = ("torch.float64", "torch.complex128")


def no_f64_upcast() -> TraceContract:
    """No float64/complex128 tensor anywhere: the production path is
    f32/complex64 end to end (f64 lives only in the host-side oracles and
    the operator builders), so a double tensor is an accidental upcast."""
    return _NoRecord("no_f64_upcast",
                     lambda r: any(d in _F64 for d in r.in_dtypes + r.out_dtypes),
                     "no f64/c128 tensor")


def sentinel_free() -> TraceContract:
    """``guard=False`` runs the exact unguarded program: no finiteness
    sentinel at all (the guard's cost is opt-in, never ambient)."""
    names = {"isfinite", "isnan", "isinf", "isposinf", "isneginf"}
    return _NoRecord("sentinel_free",
                     lambda r: r.kind in ("op", "fn") and r.name in names,
                     "no finiteness sentinels")


class _NoHostCallback(_NoRecord):
    """No host round trip: no ``_local_scalar_dense`` (``.item()``,
    ``float(t)``), no operation whose output shape depends on the data
    (``nonzero``, ``masked_select``, ``unique``, boolean indexing), no copy
    between the host and the card, no ``torch.cuda.synchronize()`` or
    ``Event.synchronize()`` (recorded by the trace, since
    ``set_sync_debug_mode`` misses them: ``trace_analysis.UNSEEN_SYNCS``);
    on the card, nothing that ``set_sync_debug_mode("error")`` refused
    (``Stream.synchronize()``, ``.item()``, ``.tolist()``, ``.cpu()``,
    ``nonzero``).  Each serializes the card's queue on the host.  A read of
    pinned memory after a non-blocking copy waits for nothing, so neither
    sees it."""

    def __init__(self):
        super().__init__("no_host_callback",
                         lambda r: r.data_dependent, "no host syncs")

    def check(self, traced: Traced) -> ContractResult:
        if traced.sync_error:
            return self._result(False, f"{self.why} violated: the card refused "
                                       f"a sync: {traced.sync_error}")
        return super().check(traced)


def no_host_callback() -> TraceContract:
    return _NoHostCallback()


class _NotDonated(TraceContract):
    """No input is written: no operation writes into the storage of an
    input tensor, every input's ``_version`` is unchanged and its bytes
    equal a copy taken before the call.  The guarded stepper's recovery
    ladder retries the same step from the intact pre-step tree."""

    def __init__(self, argname: str):
        self.name = f"not_donated({argname})"

    def measure(self, traced: Traced) -> int:
        return (sum(r.writes_input for r in traced.records)
                + len(traced.version_changes) + len(traced.value_changes))

    def check(self, traced: Traced) -> ContractResult:
        hit = next((r for r in traced.records if r.writes_input), None)
        if hit is not None:
            return self._result(False, f"{hit.name} writes into an input: "
                                       f"{hit.brief()[:120]}")
        if traced.version_changes or traced.value_changes:
            return self._result(False, f"inputs changed by the call: versions "
                                       f"{traced.version_changes}, values "
                                       f"{traced.value_changes}")
        return self._result(True, "no input written")


def not_donated(argname: str = "buffers") -> TraceContract:
    return _NotDonated(argname)


class _CountPin(TraceContract):
    """Shared body of the count pins: ``count`` pins equality,
    ``min_count``/``max_count`` a band."""

    def __init__(self, name: str, what: str, count=None, min_count=None,
                 max_count=None):
        if count is None and min_count is None and max_count is None:
            raise ValueError("pin at least one of count/min_count/max_count")
        self.what, self.count = what, count
        self.min_count, self.max_count = min_count, max_count
        want = (f"=={count}" if count is not None else
                "/".join(filter(None, [
                    f">={min_count}" if min_count is not None else None,
                    f"<={max_count}" if max_count is not None else None])))
        self.name = f"{name}({what}, {want})"

    def check(self, traced: Traced) -> ContractResult:
        got = self.measure(traced)
        ok = ((self.count is None or got == self.count)
              and (self.min_count is None or got >= self.min_count)
              and (self.max_count is None or got <= self.max_count))
        return self._result(ok, f"{self.what} x{got}")


class _CollectiveCount(_CountPin):
    """Mesh events of one kind (``exchange``, ``all_gather``,
    ``all_reduce_max``, ``barrier``), or the exchanges' ``messages`` (sends)
    or ``directions`` (distinct peer offsets over every rank traced): the
    fused-exchange pin counts directions, as the reference counts
    collective-permutes."""

    def measure(self, traced: Traced) -> int:
        return int(traced.stats["count_per_kind"].get(self.what, 0))


def collective_count(kind: str, count: Optional[int] = None, *,
                     min_count: Optional[int] = None,
                     max_count: Optional[int] = None) -> TraceContract:
    return _CollectiveCount("collective_count", kind, count, min_count, max_count)


class _LaunchCount(_CountPin):
    """Launches of one hand-written kernel, by its counter's name (``p2p``
    for every mode, ``p2p[base]``, ``m2l``, ``p2m``, ``l2p``, ``flash_tc``
    ...)."""

    def measure(self, traced: Traced) -> int:
        return int(traced.stats["launches"].get(self.what, 0))


def launch_count(kernel: str, count: Optional[int] = None, *,
                 min_count: Optional[int] = None,
                 max_count: Optional[int] = None) -> TraceContract:
    return _LaunchCount("launch_count", kernel, count, min_count, max_count)


class _NoPlainCalls(TraceContract):
    """No P2P, M2L, P2M or L2P call went to a kernel's plain version by
    request (``ops.PLAIN_CALLS`` did not rise)."""

    name = "no_plain_calls"

    def measure(self, traced: Traced) -> int:
        return traced.plain_calls

    def check(self, traced: Traced) -> ContractResult:
        return self._result(traced.plain_calls == 0,
                            f"plain calls x{traced.plain_calls}")


def no_plain_calls() -> TraceContract:
    return _NoPlainCalls()


class _MinIssueDepth(TraceContract):
    """The deepest issue of ``kind`` has at least ``min_depth`` operations
    and launches before its wait: the substep-pipeline pin, the window the
    card fills while the messages fly."""

    def __init__(self, kind: str, min_depth: int):
        self.kind, self.min_depth = kind, int(min_depth)
        self.name = f"min_issue_depth({kind}, {min_depth})"

    def measure(self, traced: Traced) -> int:
        return max(collective_issue_depths(traced.trace, (self.kind,))[self.kind],
                   default=0)

    def check(self, traced: Traced) -> ContractResult:
        got = self.measure(traced)
        return self._result(got >= self.min_depth,
                            f"max {self.kind} issue depth {got}")


def min_issue_depth(kind: str, min_depth: int) -> TraceContract:
    return _MinIssueDepth(kind, min_depth)


class _FewerBytes(PairContract):
    """Call a moves strictly fewer bytes than call b (the parity-folded M2L
    against the masked-40 form)."""

    def __init__(self, label_a: str = "a", label_b: str = "b"):
        self.label_a, self.label_b = label_a, label_b
        self.name = f"fewer_bytes({label_a} < {label_b})"

    def check_pair(self, a: Traced, b: Traced) -> ContractResult:
        ba, bb = a.stats["bytes"], b.stats["bytes"]
        return self._result(ba < bb,
                            f"{self.label_a}={ba:.3e} {self.label_b}={bb:.3e}"
                            f" ratio={bb / max(ba, 1.0):.2f}x")


def fewer_bytes(label_a: str = "a", label_b: str = "b") -> PairContract:
    return _FewerBytes(label_a, label_b)


class _IssueDepthGrows(PairContract):
    """Call a (pipelined) issues ``kind`` strictly deeper than call b
    (serial order), while the ``guard_kind`` count stays equal: the
    prefetch moves the exchange, never duplicates it."""

    def __init__(self, kind: str = "all_gather", guard_kind: str = "exchange"):
        self.kind, self.guard_kind = kind, guard_kind
        self.name = f"issue_depth_grows({kind})"

    def check_pair(self, a: Traced, b: Traced) -> ContractResult:
        kinds = (self.kind, self.guard_kind)
        da = collective_issue_depths(a.trace, kinds)
        db = collective_issue_depths(b.trace, kinds)
        deep_a = max(da[self.kind], default=0)
        deep_b = max(db[self.kind], default=0)
        n_a, n_b = len(da[self.guard_kind]), len(db[self.guard_kind])
        ok = deep_a > deep_b and n_a == n_b
        return self._result(ok, f"{self.kind} depth {deep_a} vs {deep_b}, "
                                f"{self.guard_kind} x{n_a} vs x{n_b}")


def issue_depth_grows(kind: str = "all_gather",
                      guard_kind: str = "exchange") -> PairContract:
    return _IssueDepthGrows(kind, guard_kind)


# ---------------------------------------------------------------------------
# evaluation engine
# ---------------------------------------------------------------------------


def evaluate(traced: Traced, contracts, pair_with: Optional[Traced] = None) -> list:
    """Check every contract against ``traced`` (pair contracts against
    ``(traced, pair_with)``); results carry the entry-point label."""
    out = []
    for c in contracts:
        if isinstance(c, PairContract):
            if pair_with is None:
                raise ValueError(f"{c.name} needs pair_with=")
            r = c.check_pair(traced, pair_with)
            label = f"{traced.label} vs {pair_with.label}"
        else:
            r = c.check(traced)
            label = traced.label
        out.append(dataclasses.replace(r, target=label))
    return out


def violations(results) -> list:
    return [r for r in results if not r.ok]


def format_results(results) -> str:
    return "\n".join(str(r) for r in results)
