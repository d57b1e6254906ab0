"""What one call really does: its aten operations, its kernel launches and
its messages, recorded in program order.

The port's counterpart of ``src/repro/launch/hlo_analysis.py``.  The
reference walks the optimized HLO text of a jitted program; the port has no
program text, so this module records the call itself:

* :class:`OpTrace` is a ``TorchDispatchMode``.  Under it every aten
  operation is recorded with its input and output shapes and dtypes,
  whether it is a view, whether it writes into one of its arguments and
  whether that argument shares the storage of one of the traced call's
  input tensors.  A ``TorchFunctionMode`` beside it records the few
  torch-level calls that decompose before they reach aten (``isfinite``
  becomes ``abs``/``eq``/``ne``; ``float(t)`` becomes
  ``_local_scalar_dense``).
* The hand-written CUDA kernels launch through ``ctypes`` and are opaque to
  a dispatch mode.  Their wrappers' counters (``p2p.LAUNCHES_BY_MODE``,
  ``m2l.LAUNCHES``, the flash routes' counters) are read before every
  recorded operation and message, and each launch found becomes a
  ``kernel`` record at that point of the sequence.
* Every message call of a mesh (``launch/mesh.py:ScheduleLog``) becomes a
  ``mesh`` record; mesh events and operations draw their sequence numbers
  from one counter, ``mesh.SEQ``.
* :class:`PeakTracker` is a second dispatch mode: the bytes of the storages
  that a call's operations make, live and at their peak (the dry run's
  temporaries, on real or fake tensors).
* ``torch.cuda.synchronize()`` and ``Event.synchronize()`` wait for the card
  where ``set_sync_debug_mode("error")`` does not look
  (:data:`UNSEEN_SYNCS`); while a trace is active each call becomes a
  data-dependent ``fn`` record, which the "no host sync" contract refuses.

:func:`analyze_trace` returns the keys of ``analyze_hlo``, the mesh
events' bytes by the reference's rule (:func:`collective_bytes`).  FLOPs are
``2 * out * K`` for each matrix product (``mm``, ``bmm``, ``addmm``,
``baddbmm``, ``matmul``, and ``einsum`` with ``K`` its contracted dims),
the reference's count, in which a complex product
counts as one; ``real_flops`` counts it as the 4 real products it is.
The kernels' launches are counted by name and add no FLOPs.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import Counter, defaultdict

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from . import mesh as _mesh

__all__ = ["OpRecord", "OpTrace", "PeakTracker", "analyze_trace",
           "collective_bytes", "kernel_counts",
           "shape_dim_hits", "collective_issue_depths", "input_tensors",
           "UNSEEN_SYNCS"]

# products whose FLOPs are counted: 2 * out * K, K the last dim of the
# left operand (the bias of addmm/baddbmm is argument 0)
_PRODUCTS = {"mm": 0, "bmm": 0, "matmul": 0, "addmm": 1, "baddbmm": 1}
# operations whose output shape depends on the data: each needs the values
# on the host before it can allocate
DATA_DEPENDENT = frozenset({
    "nonzero", "masked_select", "_unique", "_unique2", "unique_dim",
    "unique_consecutive", "unique_dim_consecutive", "repeat_interleave",
    "_local_scalar_dense", "item", "equal", "is_nonzero", "allclose",
    "masked_scatter"})
# operations that take index tensors: a bool index is a data-dependent shape
_INDEXING = frozenset({"index", "index_put", "index_put_", "_index_put_impl_"})
# copies: one between the host and the card waits for the card's queue
_COPIES = frozenset({"_to_copy", "copy_", "_copy_from", "_copy_from_and_resize"})
# torch-level calls recorded by name (they decompose before aten)
_FN_NAMES = frozenset({"isfinite", "isnan", "isinf", "isposinf", "isneginf",
                       "item", "tolist", "cpu", "numpy", "__float__",
                       "__int__", "__bool__"})


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One recorded event.  ``kind`` is ``op`` (an aten operation), ``fn``
    (a torch-level call of :data:`_FN_NAMES`), ``kernel`` (one launch of a
    hand-written kernel, ``name`` its counter's) or ``mesh`` (a message
    call, ``event`` the :class:`~repro_torch.launch.mesh.MeshEvent`)."""

    seq: int
    kind: str
    name: str
    in_shapes: tuple = ()
    in_dtypes: tuple = ()
    out_shapes: tuple = ()
    out_dtypes: tuple = ()
    view: bool = False
    writes: tuple = ()              # names of the arguments it writes into
    writes_input: bool = False      # one of them shares an input's storage
    data_dependent: bool = False
    flops: float = 0.0
    real_flops: float = 0.0
    bytes: int = 0
    event: object = None            # the MeshEvent of a mesh record
    log: int = 0                    # id() of the mesh record's log
    index: int = -1                 # its index in that log
    rank: int = -1                  # the rank whose mesh logged it
    group_size: int = 1             # the ranks of the mesh record's group

    def brief(self) -> str:
        if self.kind == "mesh":
            return f"rank {self.rank}: {self.event.brief()}"
        shapes = ", ".join(f"{tuple(s)}:{d}" for s, d in
                           zip(self.out_shapes or self.in_shapes,
                               self.out_dtypes or self.in_dtypes))
        return f"{self.name}({shapes})"


def input_tensors(obj) -> list:
    """Every tensor in ``obj``: tuples, lists, dicts and dataclass fields
    are walked."""
    out, stack, seen = [], [obj], set()
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif dataclasses.is_dataclass(x) and not isinstance(x, type) \
                and id(x) not in seen:
            seen.add(id(x))
            stack.extend(getattr(x, f.name) for f in dataclasses.fields(x))
    return out


def kernel_counts() -> dict[str, int]:
    """The kernel wrappers' launch counters, by name: P2P by mode
    (``p2p[base]`` ...), ``m2l``, the leaf expansions' ``p2m`` and ``l2p``
    and the three flash routes; the range forms' subsets as ``p2p_stream``
    and ``m2l_wide``."""
    global _KERNELS
    if _KERNELS is None:
        from ..kernels import flash_attn, leaf_expansions, m2l, p2p
        _KERNELS = (flash_attn, m2l, p2p, leaf_expansions)
    fa, m2l, p2p, leaf = _KERNELS
    out = {f"p2p[{m}]": n for m, n in p2p.LAUNCHES_BY_MODE.items()}
    out.update({"m2l": m2l.LAUNCHES, "p2m": leaf.P2M_LAUNCHES,
                "l2p": leaf.L2P_LAUNCHES, "flash_simt": fa.LAUNCHES,
                "flash_tc": fa.TC_LAUNCHES, "flash_tf32": fa.TF32_LAUNCHES,
                "p2p_stream": p2p.STREAM_LAUNCHES,
                "m2l_wide": m2l.WIDE_LAUNCHES})
    return out


_KERNELS = None


# counters whose launches are already counted by another (the range forms)
_SUBSETS = frozenset({"p2p_stream", "m2l_wide"})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage (its C++ object: fake tensors have
    no data pointer)."""
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return 0


def _einsum_k(equation: str, operands) -> int:
    """The product of the contracted dims of an ``einsum`` (the labels of
    its inputs that its output drops): with ``2 * out``, its FLOPs.  Under
    ``inference_mode`` an ``einsum`` reaches a dispatch mode whole, not as
    the ``bmm`` it becomes under autograd."""
    lhs, _, out = equation.replace(" ", "").partition("->")
    sizes = {}
    for term, t in zip(lhs.split(","), operands):
        term = term.replace("...", "")
        for label, n in zip(reversed(term), reversed(t.shape)):
            sizes[label] = n
    k = 1
    for label, n in sizes.items():
        if label not in out:
            k *= n
    return k


class _FnTrace(TorchFunctionMode):
    def __init__(self, owner: "OpTrace"):
        super().__init__()
        self.owner = owner

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in _FN_NAMES:
            self.owner._poll()
            tensors = [a for a in tree_flatten((args, kwargs or {}))[0]
                       if isinstance(a, torch.Tensor)]
            self.owner.records.append(OpRecord(
                seq=next(_mesh.SEQ), kind="fn", name=name,
                in_shapes=tuple(tuple(t.shape) for t in tensors),
                in_dtypes=tuple(str(t.dtype) for t in tensors),
                data_dependent=name in ("item", "tolist", "cpu", "numpy",
                                        "__float__", "__int__", "__bool__")))
        return func(*args, **(kwargs or {}))


class OpTrace(TorchDispatchMode):
    """Record every aten operation, kernel launch and mesh event while
    active (``with OpTrace(inputs) as tr: ...``; ``tr.records`` after).

    ``inputs`` (any nest of tensors, as :func:`input_tensors` walks) are
    the traced call's inputs: an operation that writes into their storage
    is marked ``writes_input``."""

    def __init__(self, inputs=()):
        super().__init__()
        self.records: list[OpRecord] = []
        self._inputs = {_storage(t) for t in input_tensors(inputs)} - {0}
        self._counts: dict[str, int] = {}
        self._fn = _FnTrace(self)
        self.launches: Counter = Counter()

    # -- kernel counters and mesh events --------------------------------------

    def _poll(self) -> None:
        now = kernel_counts()
        for name, n in now.items():
            was = self._counts.get(name, 0)
            d = n - was if n >= was else n       # a reset counter starts anew
            if d <= 0:
                continue
            self.launches[name] += d
            if name not in _SUBSETS:
                for _ in range(d):
                    self.records.append(OpRecord(seq=next(_mesh.SEQ),
                                                 kind="kernel", name=name))
        self._counts = now

    def before_mesh_event(self) -> None:
        self._poll()

    def on_mesh_event(self, log, index: int) -> None:
        ev = log.events[index]
        self.records.append(OpRecord(seq=ev.seq, kind="mesh", name=ev.kind,
                                     event=ev, log=id(log), index=index,
                                     rank=log.rank,
                                     group_size=len(ev.group) if ev.group else log.size))

    def _sync_call(self, name: str) -> None:
        self._poll()
        self.records.append(OpRecord(seq=next(_mesh.SEQ), kind="fn", name=name,
                                     data_dependent=True))

    def _patch_syncs(self) -> None:
        """Route the host syncs that ``set_sync_debug_mode`` does not refuse
        (:data:`UNSEEN_SYNCS`) through a recording wrapper while active."""
        trace, real_sync, real_event = self, torch.cuda.synchronize, torch.cuda.Event.synchronize

        def synchronize(*args, **kwargs):
            trace._sync_call("torch.cuda.synchronize")
            return real_sync(*args, **kwargs)

        def event_synchronize(event):
            trace._sync_call("Event.synchronize")
            return real_event(event)
        self._real_syncs = (real_sync, real_event)
        torch.cuda.synchronize = synchronize
        torch.cuda.Event.synchronize = event_synchronize

    def __enter__(self):
        self._counts = kernel_counts()
        _mesh.OBSERVERS.append(self)
        self._patch_syncs()
        self._fn.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            self._poll()
            return super().__exit__(*exc)
        finally:
            self._fn.__exit__(*exc)
            torch.cuda.synchronize, torch.cuda.Event.synchronize = self._real_syncs
            _mesh.OBSERVERS.remove(self)

    # -- aten operations ------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self._poll()
        out = func(*args, **kwargs)
        schema = func._schema
        short = schema.name.split("::")[-1]
        flat_in = [a for a in tree_flatten((args, kwargs))[0]
                   if isinstance(a, torch.Tensor)]
        flat_out = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in schema.returns)
        writes, hits = [], False
        for i, a in enumerate(schema.arguments):
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            val = kwargs.get(a.name, args[i] if i < len(args) else None)
            for t in tree_flatten(val)[0]:
                if isinstance(t, torch.Tensor):
                    writes.append(a.name)
                    hits = hits or _storage(t) in self._inputs
        devices = {t.device.type for t in flat_in + flat_out}
        dependent = short in DATA_DEPENDENT or (
            short in _COPIES and len(devices) > 1) or (
            short in _INDEXING and any(
                isinstance(t, torch.Tensor) and t.dtype in (torch.bool, torch.uint8)
                for t in tree_flatten(args[1] if len(args) > 1 else ())[0]))
        flops = 0.0
        if short in _PRODUCTS and flat_out:
            lhs = args[_PRODUCTS[short]]
            flops = 2.0 * flat_out[0].numel() * lhs.shape[-1]
        elif short == "einsum" and flat_out:
            flops = 2.0 * flat_out[0].numel() * _einsum_k(args[0], args[1])
        real = flops * (4 if flat_out and flat_out[0].is_complex() else 1)
        self.records.append(OpRecord(
            seq=next(_mesh.SEQ), kind="op", name=short,
            in_shapes=tuple(tuple(t.shape) for t in flat_in),
            in_dtypes=tuple(str(t.dtype) for t in flat_in),
            out_shapes=tuple(tuple(t.shape) for t in flat_out),
            out_dtypes=tuple(str(t.dtype) for t in flat_out),
            view=view, writes=tuple(writes), writes_input=hits,
            data_dependent=dependent, flops=flops, real_flops=real,
            bytes=0 if view else sum(_nbytes(t) for t in flat_out)))
        return out


class PeakTracker(TorchDispatchMode):
    """The bytes that a call's operations hold live, and their peak: the
    port's counterpart of ``compiled.memory_analysis()``'s temporaries.

    Counts storages, not tensors: the first output of an operation that
    lies in a storage neither an input of that operation nor already
    counted adds the storage's ``nbytes()`` (views and in-place results add
    nothing), and ``weakref.finalize`` takes it off when the storage is
    freed.  Works alike on real and on fake tensors (``FakeTensorMode``
    outside this mode), so a dry run reads the peak of a call that it never
    allocates; a tensor on the meta device holds nothing and is not
    counted.  ``inputs`` (any nest of tensors) are the call's arguments:
    their storages are never counted.  ``live`` is the bytes counted now,
    ``peak`` the most at any point, both above the arguments; ``at_peak``
    the bytes live at the peak by the operation that made them."""

    def __init__(self, inputs=()):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.at_peak: dict[str, int] = {}
        self._sizes: dict[int, tuple[int, str]] = {}
        self._by_op: Counter = Counter()
        self._known = {_storage(t) for t in input_tensors(inputs)}

    def _free(self, key: int) -> None:
        n, op = self._sizes.pop(key, (0, ""))
        self.live -= n
        self._by_op[op] -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        seen = {_storage(t) for t in tree_flatten((args, kwargs))[0]
                if isinstance(t, torch.Tensor)}
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor) or t.device.type == "meta":
                continue            # a meta tensor holds no memory (a shape probe)
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            key = st._cdata
            if key in seen or key in self._sizes or key in self._known:
                continue
            n, op = st.nbytes(), func._schema.name.split("::")[-1]
            self._sizes[key] = (n, op)
            self.live += n
            self._by_op[op] += n
            weakref.finalize(st, self._free, key)
        if self.live > self.peak:
            self.peak = self.live
            self.at_peak = {k: v for k, v in self._by_op.items() if v}
        return out


def _elems(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def _itemsize(dtype: str) -> int:
    return torch.empty((), dtype=getattr(torch, dtype)).element_size()


def collective_bytes(record: OpRecord) -> int:
    """The bytes of one mesh record by the reference's rule
    (``hlo_analysis.py``): a collective's result, times the group size for
    a reduce-scatter.  An exchange's result is what it receives; an
    all-gather's is its input times the group; an all-reduce's and a
    reduce-scatter's (times the group) are their input's.  A host-float
    ``all_reduce_max`` of a :class:`RankMesh` carries one f64; a barrier and
    a wait carry nothing."""
    ev = record.event
    if ev.kind == "exchange":
        return sum(_elems(shape) * _itemsize(dtype) for _, shape, dtype in ev.recvs)
    if ev.kind in ("barrier", "wait"):
        return 0
    if ev.shape is None:                    # RankMesh.all_reduce_max: one f64
        return 8
    n = _elems(ev.shape) * _itemsize(ev.dtype)
    return n * record.group_size if ev.kind == "all_gather" else n


def analyze_trace(trace) -> dict:
    """``analyze_hlo``'s keys for one traced call: ``flops`` (and
    ``real_flops``), ``bytes`` (outputs of the operations that make data,
    views excluded), ``collective_bytes`` and ``per_kind`` (bytes of the
    mesh events by kind, by the reference's rule: :func:`collective_bytes`),
    ``count`` and ``count_per_kind``
    (mesh events by kind, and the exchanges' ``messages`` and distinct
    ``directions``, a direction being a send's peer less its rank),
    ``bytes_by_op`` and ``count_by_op`` (aten operations by name), and
    ``launches`` (kernel launches by counter).  ``trace`` is an
    :class:`OpTrace` or its list of records."""
    records = trace.records if isinstance(trace, OpTrace) else list(trace)
    flops = real = 0.0
    nbytes = 0
    by_op, count_by_op = defaultdict(float), Counter()
    per_kind, counts = defaultdict(float), Counter()
    directions = set()
    launches = Counter()
    for r in records:
        if r.kind == "op":
            flops += r.flops
            real += r.real_flops
            nbytes += r.bytes
            by_op[r.name] += r.bytes
            count_by_op[r.name] += 1
        elif r.kind == "kernel":
            launches[r.name] += 1
        elif r.kind == "mesh" and r.name != "wait":
            ev = r.event
            counts[ev.kind] += 1
            if ev.kind == "exchange":
                directions.update(peer - r.rank for peer, _, _ in ev.sends)
                counts["messages"] += len(ev.sends)
            if ev.kind != "barrier":
                per_kind[ev.kind] += collective_bytes(r)
    if isinstance(trace, OpTrace):
        launches = Counter(trace.launches)
    launches["p2p"] = sum(n for k, n in launches.items() if k.startswith("p2p["))
    counts["directions"] = len(directions)
    collectives = sum(n for k, n in counts.items()
                      if k not in ("messages", "directions"))
    return {
        "flops": flops,
        "real_flops": real,
        "bytes": float(nbytes),
        "collective_bytes": float(sum(per_kind.values())),
        "per_kind": dict(per_kind),
        "count": int(collectives),
        "count_per_kind": dict(counts),
        "bytes_by_op": dict(by_op),
        "count_by_op": dict(count_by_op),
        "launches": dict(launches),
    }


def shape_dim_hits(trace, dim: int) -> list[OpRecord]:
    """The records with a tensor (input or output) that has a dimension of
    size ``dim``: the counterpart of ``shape_dim_pattern``, which the M2L
    staging checks use to pin the absence of ``(nb, 40p)`` buffers."""
    records = trace.records if isinstance(trace, OpTrace) else trace
    return [r for r in records
            if any(dim in s for s in r.in_shapes + r.out_shapes)]


def collective_issue_depths(trace, collectives=("all_gather", "exchange")
                            ) -> dict[str, list[int]]:
    """Each issue's depth, per kind in ``collectives``, in issue order: the
    aten operations and kernel launches recorded between the issue and the
    ``wait`` that completes it (to the end of the trace if none does).  The
    window is what the card can run while the messages are in flight."""
    records = trace.records if isinstance(trace, OpTrace) else list(trace)
    records = sorted(records, key=lambda r: r.seq)
    waits: dict[tuple, int] = {}
    for r in records:
        if r.kind == "mesh" and r.name == "wait":
            waits.setdefault((r.log, r.event.issue), r.seq)
    work = [r.seq for r in records if r.kind in ("op", "kernel")]
    out: dict[str, list[int]] = {k: [] for k in collectives}
    for r in records:
        if r.kind != "mesh" or r.name not in out:
            continue
        end = waits.get((r.log, r.index), float("inf"))
        out[r.name].append(sum(1 for s in work if r.seq < s < end))
    return out


# the host syncs that set_sync_debug_mode("error") lets pass on an H100
# (torch 2.11, CUDA 12.8; tests/test_torch_sync_debug.py holds the list):
# OpTrace records each call itself
UNSEEN_SYNCS = ("torch.cuda.synchronize", "Event.synchronize")
