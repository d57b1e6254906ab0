"""FMM-as-a-service: a batched multi-tenant evaluation engine on the card.

The port of ``src/repro/serve/fmm_service.py``.  Clients submit
:class:`FmmJob`s — (charges, optional probe grid, equation name,
depth/expansion order or ``"auto"``, RK2 step count for trajectory
sessions) — and the engine turns the single-tenant library underneath into
a serving path:

* **price** — every job is priced a priori with the paper's Eq 13-15 work
  model (:func:`~repro_torch.core.fmm.flops_estimate`) plus the plan-level
  communication model (:func:`~repro_torch.core.plan.plan_comm_cost`)
  BEFORE any device work is scheduled.  A job whose total modeled work
  exceeds ``ServiceBudget.max_job_flops`` is rejected with a typed
  :class:`JobRejected` carrying its :class:`JobPrice`; a job that would
  overflow the in-flight queue budget is deferred and promoted as budget
  frees up.
* **batch** — independent one-shot jobs are bin-packed into shape buckets
  (:class:`BucketKey`: tree level, pow2-rounded slot capacity, expansion
  order, equation, core size, probe capacity) and evaluated together:
  :func:`batched_fmm_eval` / :func:`batched_fmm_eval_targets` run the
  serial driver on trees with a leading batch axis, so a bucket of B jobs
  is ONE P2P launch and one M2L launch per level 2..L on the card (the
  batch is the kernels' ``gridDim.z``), where the reference runs ``vmap``
  of its driver as one device program.  The padding waste the dense batch
  pays is accounted with :func:`~repro_torch.core.cost_model.batch_padding_stats`.
* **amortize** — host-built artifacts (``build_tree`` results, plans) live
  in a keyed :class:`ArtifactCache` with hit/miss counters, shared between
  the one-shot lanes and the trajectory sessions
  (``VortexStepper(artifact_cache=...)``).
* **stream** — RK2 trajectory sessions yield their steps through
  :meth:`TrajectorySession.stream`, a bounded prefetch generator that
  computes step k+1 while the client consumes step k.

The engine runs on ``device`` (None: the CUDA card, which launches the
kernels; ``"cpu"`` runs their plain versions) or on every rank of a
:class:`~repro_torch.launch.mesh.RankMesh`, SPMD: every rank holds the same
engine and is fed the same jobs in the same order.  The batched lane then
runs replicated on every rank and sends no message; the sharded lane
(``parallel_fmm_evaluate`` under the priced plan) and the sessions
(``VortexStepper(mesh=...)``) are collective.  Every rank's results are
the same.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import queue as queue_mod
import threading
import time
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

from ..configs.backend import require_tensors, resolve_device
from ..core import equations as eqs
from ..core import parallel_fmm as pf
from ..core.cost_model import ModelParams, array_digest, batch_padding_stats
from ..core.fmm import fmm_evaluate, flops_estimate
from ..core.plan import plan_comm_cost, plan_from_counts
from ..core.quadtree import (Tree, build_tree, choose_level,
                             gather_particle_values)
from ..core.stepper import VortexStepper

__all__ = ["FmmJob", "JobPrice", "JobRejected", "JobResult", "ServiceBudget",
           "ArtifactCache", "BucketKey", "FmmServiceEngine",
           "TrajectorySession", "batched_fmm_eval", "batched_fmm_eval_targets",
           "batched_cache_entries", "ensure_device", "stack_trees",
           "BATCHED_ENTRIES", "TRACE_ENTRY_POINTS"]


# ---------------------------------------------------------------------------
# Jobs, prices, budgets
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FmmJob:
    """One client request.

    ``positions``/``strength`` are the charge set (unit-square coords, raw
    strengths — circulation for vortex/tracer, charge for laplace).
    ``targets`` is an optional (T, 2) probe set evaluated passively against
    the sources.  ``level``/``p`` accept ``"auto"`` (cost-model defaults)
    or explicit ints.  ``steps > 0`` requests an RK2 trajectory session
    (vortex only) instead of a one-shot evaluation.
    """

    positions: np.ndarray
    strength: np.ndarray
    equation: str = "vortex"
    targets: Optional[np.ndarray] = None
    level: int | str = "auto"
    p: int | str = "auto"
    steps: int = 0
    dt: float = 0.005
    sigma: float = 0.05
    tenant: str = "default"


@dataclasses.dataclass(frozen=True)
class JobPrice:
    """Eq 13-15 price computed at admission — BEFORE any device work."""

    flops_per_eval: float     # modeled work of one FMM evaluation
    total_flops: float        # x 2 evaluations/step x steps for sessions
    comm_cost: float          # plan_comm_cost bottleneck (0 off-mesh)
    level: int
    p: int
    slots: int
    steps: int
    lane: str                 # "batched" | "sharded" | "session"


class JobRejected(RuntimeError):
    """Typed admission failure; ``.price`` carries the cost-model price."""

    def __init__(self, message: str, price: JobPrice):
        super().__init__(message)
        self.price = price


@dataclasses.dataclass(frozen=True)
class ServiceBudget:
    """Admission-control knobs, all in Eq 13-15 flop units.

    ``max_job_flops`` rejects a single oversized job outright;
    ``max_queue_flops`` bounds the admitted-but-unexecuted backlog (excess
    jobs are deferred, then promoted as the queue drains — a deferred job
    is always promoted once the queue is empty, so admission never
    deadlocks); ``shard_threshold_flops`` routes jobs at least this
    expensive to the sharded latency lane when a mesh is attached.
    """

    max_job_flops: float = 5e9
    max_queue_flops: float = 2e10
    shard_threshold_flops: float = 1e8


@dataclasses.dataclass
class JobResult:
    job_id: int
    out: np.ndarray           # (N,) / (N, nout) at sources, or at targets
    price: JobPrice
    lane: str
    latency_s: float
    batch_capacity: int = 1


# ---------------------------------------------------------------------------
# Artifact cache (trees, plans) — keyed, counted, shared across tenants
# ---------------------------------------------------------------------------


class ArtifactCache:
    """Keyed store for host-built artifacts with hit/miss counters.

    Keys are value tuples (array digests + static config); values are
    whatever the builder returns (``(Tree, TreeIndex)`` pairs, plan
    objects).  The stepper consumes this duck-typed (``get(key, builder)``)
    so ``core`` never imports ``serve``.  A session's prefetch thread and
    the engine's own thread share it, so a lookup and its build are one
    locked step.
    """

    def __init__(self):
        self._store: dict = {}
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0

    def get(self, key, builder):
        with self._lock:
            try:
                value = self._store[key]
            except KeyError:
                self.misses += 1
                value = self._store[key] = builder()
                return value
            self.hits += 1
            return value

    def __contains__(self, key) -> bool:
        return key in self._store

    def __len__(self) -> int:
        return len(self._store)

    def clear(self):
        self._store.clear()

    def stats(self) -> dict:
        return {"entries": len(self._store), "hits": self.hits,
                "misses": self.misses}


# ---------------------------------------------------------------------------
# Shape buckets and the batched entry points
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BucketKey:
    """Static identity of one batched launch configuration (the
    bin-packing target).

    Slot capacities are rounded up to powers of two at admission, so jobs
    of nearby sizes share one bucket instead of keying a fresh one per
    exact occupancy.  ``sigma`` participates because the tree's core size
    is static metadata; ``tgt_slots == 0`` means no probe grid.
    """

    level: int
    slots: int
    p: int
    equation: str
    sigma: float
    tgt_slots: int = 0


def ensure_device(tree: Tree, device=None) -> Tree:
    """The service boundary: ``tree`` with its arrays on ``device`` (None:
    the CUDA card), whatever they were (host arrays, such as a reference
    tree's as numpy, or tensors on another device)."""
    dev = resolve_device(device)

    def put(a, dtype):
        # host arrays are copied: a reference tree's leaves are read-only
        return torch.as_tensor(a if isinstance(a, torch.Tensor) else np.array(a),
                               dtype=dtype, device=dev)
    return Tree(z=put(tree.z, torch.complex64), q=put(tree.q, torch.complex64),
                mask=put(tree.mask, torch.bool), level=tree.level,
                sigma=tree.sigma)


def stack_trees(trees: list, capacity: int):
    """Stack per-job leaf grids into (B, n, n, s) batch tensors on the
    first tree's device, padding to ``capacity`` with empty (all-masked-out)
    trees."""
    def stack(field):
        first = getattr(trees[0], field)
        out = first.new_zeros((capacity,) + tuple(first.shape))
        for b, t in enumerate(trees):
            out[b] = getattr(t, field)
        return out
    return stack("z"), stack("q"), stack("mask")


# The launch configurations each batched entry point has run: its counterpart
# of the reference's jit cache, keyed by what keys a compiled program there
# (the static arguments and the batch's shapes, so (BucketKey, capacity)),
# and the device.  Steady-state serving adds none.
BATCHED_ENTRIES: dict[str, set] = {"batched_fmm_eval": set(),
                                   "batched_fmm_eval_targets": set()}


def batched_cache_entries() -> int:
    """Distinct launch configurations across the batched entry points —
    the steady-state count the reference's trace-contract row pins."""
    return sum(len(v) for v in BATCHED_ENTRIES.values())


def batched_fmm_eval(z, q, mask, *, level: int, sigma: float, p: int, eq):
    """A whole bucket in one evaluation: the serial driver on (B, n, n, s)
    inputs, one P2P launch and one M2L launch per level 2..L on the card.
    Returns (B, n, n, s[, nout]).  Padded batch rows carry all-False masks,
    so every stage's occupancy and r2 guards zero them."""
    require_tensors(z, q, mask)
    eq = eqs.get_equation(eq)
    tree = Tree(z=z, q=q, mask=mask, level=level, sigma=sigma)
    out = fmm_evaluate(tree, p, eq=eq, device=z.device)
    BATCHED_ENTRIES["batched_fmm_eval"].add(
        (level, sigma, p, eq.name, tuple(z.shape), z.device.type))
    return out


def batched_fmm_eval_targets(z, q, mask, tz, tmask, *, level: int,
                             sigma: float, p: int, eq):
    """Probe-grid variant: passive targets (B, n, n, st) evaluated against
    the sources; output is per TARGET slot, (B, n, n, st[, nout])."""
    require_tensors(z, q, mask, tz, tmask)
    eq = eqs.get_equation(eq)
    src = Tree(z=z, q=q, mask=mask, level=level, sigma=sigma)
    tgt = Tree(z=tz, q=torch.zeros_like(tz), mask=tmask, level=level,
               sigma=sigma)
    out = fmm_evaluate(src, p, eq=eq, targets=tgt, device=z.device)
    BATCHED_ENTRIES["batched_fmm_eval_targets"].add(
        (level, sigma, p, eq.name, tuple(z.shape), tuple(tz.shape),
         z.device.type))
    return out


# The batched entry points by name, for the static-analysis layer
# (``analysis/``): its contracts trace them and its cache accounting
# watches ``BATCHED_ENTRIES`` across their calls.
TRACE_ENTRY_POINTS = {
    "batched_fmm_eval": batched_fmm_eval,
    "batched_fmm_eval_targets": batched_fmm_eval_targets,
}


# ---------------------------------------------------------------------------
# Engine internals
# ---------------------------------------------------------------------------


def _pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _leaf_counts(positions, level: int) -> np.ndarray:
    n = 1 << level
    ij = np.clip((np.asarray(positions, np.float64) * n).astype(np.int64),
                 0, n - 1)
    return np.bincount(ij[:, 1] * n + ij[:, 0],
                       minlength=n * n).reshape(n, n)


@dataclasses.dataclass
class _Admitted:
    """Internal record of an admitted (or deferred) one-shot job."""

    job_id: int
    job: FmmJob
    spec: eqs.EquationSpec
    price: JobPrice
    bucket: BucketKey
    tree_key: tuple
    tgt_key: Optional[tuple]
    submitted: float


class TrajectorySession:
    """One tenant's live RK2 trajectory: a stepper plus its cache keys.

    The engine owns the heavy artifacts through the shared
    :class:`ArtifactCache`; the session holds keys and re-resolves them
    every step (:meth:`FmmServiceEngine.step_session`), so steady-state
    stepping is a pure cache hit and an evicted/restored session
    repopulates from live state instead of rebuilding."""

    def __init__(self, session_id: int, stepper: VortexStepper,
                 engine: "FmmServiceEngine", price: JobPrice):
        self.id = session_id
        self.stepper = stepper
        self.engine = engine
        self.price = price

    def step(self):
        return self.engine.step_session(self.id)

    def particles(self):
        return self.stepper.particles()

    def stream(self, steps: int, prefetch: bool = True):
        """Yield ``(step_index, positions, StepRecord)`` per RK2 step.

        With ``prefetch`` (default) a worker thread runs the device steps
        ahead through a bounded queue: step k+1 computes while the client
        consumes step k.  The worker issues its work on the stream that was
        current here, so the device orders it after the consumer's, and it
        reads each step's positions to the host itself, after that step.
        Worker exceptions re-raise in the consumer; closing the generator
        stops the worker.  On a mesh of more than one rank the steps run
        in the consumer's thread: a session's messages and the engine's
        would otherwise cross in a different order on each rank.
        """
        mesh = self.stepper.mesh
        if not prefetch or (mesh is not None and mesh.size > 1):
            for i in range(steps):
                rec = self.step()
                pos, _ = self.particles()
                yield i, pos, rec
            return
        out: queue_mod.Queue = queue_mod.Queue(maxsize=2)
        stop = threading.Event()
        dev = self.stepper.device
        cuda_stream = (torch.cuda.current_stream(dev) if dev.type == "cuda"
                       else None)

        def run():
            for i in range(steps):
                if stop.is_set():
                    return
                rec = self.step()
                pos, _ = self.particles()
                out.put((i, pos, rec))

        def worker():
            try:
                if cuda_stream is None:
                    run()
                else:
                    with torch.cuda.stream(cuda_stream):
                        run()
                out.put(None)
            except BaseException as exc:       # noqa: BLE001 — re-raised
                out.put(exc)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = out.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while t.is_alive():               # unblock a worker at put()
                try:
                    out.get(timeout=0.1)
                except queue_mod.Empty:
                    pass
            t.join()


class FmmServiceEngine:
    """Multi-tenant FMM evaluation engine.

    One-shot jobs flow submit -> price -> admit/defer/reject -> bucket ->
    batch -> execute -> result; ``steps > 0`` jobs open a
    :class:`TrajectorySession` instead.  ``mesh=None`` serves everything
    through the batched serial lane on ``device`` (None: the CUDA card);
    with a :class:`~repro_torch.launch.mesh.RankMesh` (which brings the
    device), jobs priced at or above ``budget.shard_threshold_flops`` (and
    all sessions) run through the sharded driver/stepper on their own
    execution plan, and ``nparts`` is the mesh's world size.
    """

    def __init__(self, *, budget: Optional[ServiceBudget] = None, mesh=None,
                 batch_capacities: tuple = (1, 2, 4, 8),
                 target_per_box: float = 4.0,
                 cache: Optional[ArtifactCache] = None,
                 session_kwargs: Optional[dict] = None, device=None):
        if mesh is not None:
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            device = mesh.device
        self.device = resolve_device(device)
        self.budget = budget or ServiceBudget()
        self.mesh = mesh
        self.batch_capacities = tuple(sorted(set(batch_capacities)))
        self.target_per_box = float(target_per_box)
        self.cache = cache if cache is not None else ArtifactCache()
        self.session_kwargs = dict(session_kwargs or {})
        self.queue: list[_Admitted] = []
        self.deferred: list[_Admitted] = []
        self.results: dict[int, JobResult] = {}
        self.sessions: dict[int, TrajectorySession] = {}
        self._next_id = 0
        self._latencies: dict[str, list] = defaultdict(list)
        self.counters = {"submitted": 0, "admitted": 0, "rejected": 0,
                         "deferred": 0, "promoted": 0, "batches": 0,
                         "batched_jobs": 0, "sharded_jobs": 0,
                         "sessions": 0, "session_steps": 0,
                         "padding_paid_flops": 0.0,
                         "padding_useful_flops": 0.0}

    # -- admission: price first, schedule second ----------------------------

    @property
    def nparts(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape[self.mesh.axis]

    def _shard_min_level(self) -> int:
        return max(2, math.ceil(math.log2(max(2 * self.nparts, 4))))

    def _resolve_oneshot(self, job: FmmJob, spec: eqs.EquationSpec):
        """Resolve (level, p, slots, tgt_slots, counts) and the lane."""
        n = len(job.positions)
        p = spec.default_p if job.p == "auto" else int(job.p)
        level = (max(choose_level(n, self.target_per_box), 2)
                 if job.level == "auto" else int(job.level))
        lane = "batched"
        if self.mesh is not None:
            probe = flops_estimate(level, max(int(_leaf_counts(
                job.positions, level).max()), 1), p, eq=spec)["total"]
            if probe >= self.budget.shard_threshold_flops:
                lane = "sharded"
                level = max(level, self._shard_min_level())
        counts = _leaf_counts(job.positions, level)
        slots = _pow2(max(int(counts.max()), 2))
        tgt_slots = 0
        if job.targets is not None:
            tgt_slots = _pow2(max(int(_leaf_counts(job.targets,
                                                   level).max()), 2))
        return level, p, slots, tgt_slots, counts, lane

    def _price_oneshot(self, job, spec, level, p, slots, tgt_slots, counts,
                       lane) -> JobPrice:
        census = flops_estimate(level, slots, p, eq=spec)
        per_eval = census["total"]
        if tgt_slots:
            # passive probes add their own L2P + P2P at target capacity
            tc = flops_estimate(level, tgt_slots, p, eq=spec)
            per_eval += tc["l2p"] + tc["p2p"]
        comm = 0.0
        if lane == "sharded":
            params = ModelParams(level=level,
                                 cut=max(min(level - 1, 4), 1), p=p,
                                 slots=slots, nout=spec.nout)
            plan = self.cache.get(
                self._plan_key(counts, params),
                lambda: plan_from_counts(counts, params, self.nparts,
                                         method="model"))
            comm = float(plan_comm_cost(plan, counts, params).max())
        return JobPrice(flops_per_eval=float(per_eval),
                        total_flops=float(per_eval), comm_cost=comm,
                        level=level, p=p, slots=slots, steps=0, lane=lane)

    def _plan_key(self, counts, params) -> tuple:
        return ("plan", array_digest(counts), params, self.nparts,
                "model", None, True, True)

    def _tree_key(self, positions, strength, level, slots, sigma,
                  charge_scale) -> tuple:
        return ("tree", array_digest(positions, strength), level, slots,
                float(sigma), complex(charge_scale))

    def _price_session(self, job: FmmJob, spec: eqs.EquationSpec) -> JobPrice:
        """Price a trajectory session with the STEPPER's own default sizing
        rules (target_per_box=8, 2x slot headroom, mesh minimum level), so
        with those defaults the plan priced here is the very plan the
        stepper pulls from the shared cache at open."""
        n = len(job.positions)
        p = spec.default_p if job.p == "auto" else int(job.p)
        level = max(choose_level(n, 8.0), 2,
                    math.ceil(math.log2(max(2 * self.nparts, 4))))
        counts = _leaf_counts(job.positions, level)
        slots = max(int(math.ceil(int(counts.max()) * 2.0)), 2)
        params = ModelParams(level=level, cut=max(min(level - 1, 4), 1),
                             p=p, slots=slots)
        per_eval = float(flops_estimate(level, slots, p, eq=spec)["total"])
        comm = 0.0
        if self.mesh is not None:
            plan = self.cache.get(
                self._plan_key(counts, params),
                lambda: plan_from_counts(counts, params, self.nparts,
                                         method="model"))
            comm = float(plan_comm_cost(plan, counts, params).max())
        return JobPrice(flops_per_eval=per_eval,
                        total_flops=per_eval * 2.0 * job.steps,
                        comm_cost=comm, level=level, p=p, slots=slots,
                        steps=job.steps, lane="session")

    def _queued_flops(self) -> float:
        return sum(r.price.total_flops for r in self.queue)

    def submit(self, job: FmmJob) -> int:
        """Price, then admit/defer/reject.  Returns a job id (one-shots:
        claim the result after :meth:`drain`; sessions: pass to
        :meth:`session` / :meth:`step_session`).  Raises
        :class:`JobRejected` when the Eq 13-15 price blows the budget."""
        self.counters["submitted"] += 1
        spec = eqs.resolve_job_spec(job.equation,
                                    have_targets=job.targets is not None,
                                    steps=job.steps)
        if job.steps:
            price = self._price_session(job, spec)
        else:
            res = self._resolve_oneshot(job, spec)
            price = self._price_oneshot(job, spec, *res)
        if price.total_flops > self.budget.max_job_flops:
            self.counters["rejected"] += 1
            raise JobRejected(
                f"job priced at {price.total_flops:.3g} modeled flops "
                f"(level={price.level}, p={price.p}, slots={price.slots}, "
                f"steps={price.steps}) exceeds max_job_flops "
                f"{self.budget.max_job_flops:.3g}", price)
        self._next_id += 1
        jid = self._next_id
        if job.steps:
            self._open_session(jid, job, spec, price)
            return jid
        level, p, slots, tgt_slots, counts, lane = res
        rec = _Admitted(
            job_id=jid, job=job, spec=spec, price=price,
            bucket=BucketKey(level=level, slots=slots, p=p, equation=spec.name,
                             sigma=float(job.sigma), tgt_slots=tgt_slots),
            tree_key=self._tree_key(job.positions, job.strength, level, slots,
                                    job.sigma, spec.charge_scale),
            tgt_key=None if job.targets is None else self._tree_key(
                job.targets, np.zeros(len(job.targets)), level, tgt_slots,
                job.sigma, 0.0),
            submitted=time.perf_counter())
        if self.queue and \
                self._queued_flops() + price.total_flops \
                > self.budget.max_queue_flops:
            self.deferred.append(rec)
            self.counters["deferred"] += 1
        else:
            self.queue.append(rec)
            self.counters["admitted"] += 1
        return jid

    # -- execution: bucket -> batch -> one launch per kernel -----------------

    def _build_job_tree(self, rec: _Admitted):
        return build_tree(rec.job.positions, rec.job.strength,
                          rec.bucket.level, rec.job.sigma,
                          slots=rec.bucket.slots,
                          charge_scale=rec.spec.charge_scale,
                          device=self.device)

    def _build_target_tree(self, rec: _Admitted):
        return build_tree(rec.job.targets, np.zeros(len(rec.job.targets)),
                          rec.bucket.level, rec.job.sigma,
                          slots=rec.bucket.tgt_slots, device=self.device)

    @staticmethod
    def _gather(out_slot: torch.Tensor, index, nout: int) -> np.ndarray:
        if nout == 1:
            return gather_particle_values(out_slot, index).numpy()
        return np.stack([gather_particle_values(out_slot[..., c], index).numpy()
                         for c in range(nout)], axis=-1)

    def _finish(self, rec: _Admitted, out: np.ndarray, capacity: int):
        latency = time.perf_counter() - rec.submitted
        self._latencies[rec.price.lane].append(latency)
        self.results[rec.job_id] = JobResult(
            job_id=rec.job_id, out=out, price=rec.price,
            lane=rec.price.lane, latency_s=latency, batch_capacity=capacity)

    def _run_bucket(self, bucket: BucketKey, recs: list):
        spec = eqs.get_equation(bucket.equation)
        capacity = next(c for c in self.batch_capacities if c >= len(recs))
        pairs = [self.cache.get(r.tree_key,
                                functools.partial(self._build_job_tree, r))
                 for r in recs]
        z, q, m = stack_trees([ensure_device(t, self.device) for t, _ in pairs],
                              capacity)
        if bucket.tgt_slots:
            tpairs = [self.cache.get(r.tgt_key, functools.partial(
                self._build_target_tree, r)) for r in recs]
            tz, _, tm = stack_trees(
                [ensure_device(t, self.device) for t, _ in tpairs], capacity)
            out = batched_fmm_eval_targets(
                z, q, m, tz, tm, level=bucket.level, sigma=bucket.sigma,
                p=bucket.p, eq=spec)
            indices = [i for _, i in tpairs]
        else:
            out = batched_fmm_eval(z, q, m, level=bucket.level,
                                   sigma=bucket.sigma, p=bucket.p, eq=spec)
            indices = [i for _, i in pairs]
        out = out[:len(recs)].cpu()           # one host pull per batch
        for b, rec in enumerate(recs):
            self._finish(rec, self._gather(out[b], indices[b], spec.nout),
                         capacity)
        self.counters["batches"] += 1
        self.counters["batched_jobs"] += len(recs)
        pad = batch_padding_stats(recs[0].price.flops_per_eval, len(recs),
                                  capacity)
        self.counters["padding_paid_flops"] += pad["paid"]
        self.counters["padding_useful_flops"] += pad["useful"]

    def _run_sharded(self, rec: _Admitted):
        spec = rec.spec
        tree, index = self.cache.get(
            rec.tree_key, functools.partial(self._build_job_tree, rec))
        counts = index.counts
        params = ModelParams(level=rec.bucket.level,
                             cut=max(min(rec.bucket.level - 1, 4), 1),
                             p=rec.bucket.p, slots=rec.bucket.slots,
                             nout=spec.nout)
        plan = self.cache.get(
            self._plan_key(counts, params),
            lambda: plan_from_counts(counts, params, self.nparts,
                                     method="model"))
        targets = None
        out_index = index
        if rec.tgt_key is not None:
            targets, out_index = self.cache.get(
                rec.tgt_key, functools.partial(self._build_target_tree, rec))
            targets = ensure_device(targets, self.device)
        out = pf.parallel_fmm_evaluate(
            ensure_device(tree, self.device), rec.bucket.p, mesh=self.mesh,
            plan=plan, eq=spec, targets=targets)
        self._finish(rec, self._gather(out.cpu(), out_index, spec.nout), 1)
        self.counters["sharded_jobs"] += 1

    def run_once(self) -> list:
        """Execute the admitted queue (one pass), then promote deferred
        jobs into the freed budget.  Returns completed job ids."""
        batch, self.queue = self.queue, []
        done = []
        groups: dict[BucketKey, list] = defaultdict(list)
        for rec in batch:
            if rec.price.lane == "sharded":
                self._run_sharded(rec)
                done.append(rec.job_id)
            else:
                groups[rec.bucket].append(rec)
        cap_max = self.batch_capacities[-1]
        for bucket, recs in groups.items():
            for i in range(0, len(recs), cap_max):
                chunk = recs[i:i + cap_max]
                self._run_bucket(bucket, chunk)
                done.extend(r.job_id for r in chunk)
        still = []
        for rec in self.deferred:
            if not self.queue or self._queued_flops() + rec.price.total_flops \
                    <= self.budget.max_queue_flops:
                self.queue.append(rec)
                self.counters["promoted"] += 1
                self.counters["admitted"] += 1
            else:
                still.append(rec)
        self.deferred = still
        return done

    def drain(self) -> dict:
        """Run until the queue and deferred list are empty; returns the
        results dict (job id -> :class:`JobResult`)."""
        while self.queue or self.deferred:
            self.run_once()
        return self.results

    def result(self, job_id: int) -> JobResult:
        return self.results[job_id]

    # -- trajectory sessions -------------------------------------------------

    def _placement(self) -> dict:
        """Where a stepper runs: on the mesh (which brings the device), or
        on the engine's device."""
        if self.mesh is not None:
            return {"mesh": self.mesh}
        return {"device": self.device}

    def _open_session(self, sid: int, job: FmmJob, spec, price: JobPrice):
        kwargs = dict(p=price.p, dt=job.dt, artifact_cache=self.cache,
                      **self._placement())
        kwargs.update(self.session_kwargs)
        stepper = VortexStepper(job.positions, job.strength, job.sigma,
                                **kwargs)
        self.sessions[sid] = TrajectorySession(sid, stepper, self, price)
        self.counters["sessions"] += 1

    def session(self, session_id: int) -> TrajectorySession:
        return self.sessions[session_id]

    def restore_session(self, directory: str, **from_checkpoint_kwargs) -> int:
        """Reopen a session from its checkpoint directory (written by either
        package) through the SHARED artifact cache, onto the engine's
        device or mesh: the restored plan is pulled by value key (a hit
        when this engine built it)."""
        stepper = VortexStepper.from_checkpoint(
            directory, artifact_cache=self.cache, **self._placement(),
            **from_checkpoint_kwargs)
        price = JobPrice(
            flops_per_eval=float(flops_estimate(
                stepper.params.level, stepper.params.slots,
                stepper.p)["total"]),
            total_flops=0.0, comm_cost=0.0, level=stepper.params.level,
            p=stepper.p, slots=stepper.params.slots, steps=0, lane="session")
        self._next_id += 1
        sid = self._next_id
        self.sessions[sid] = TrajectorySession(sid, stepper, self, price)
        return sid

    def step_session(self, session_id: int):
        """Advance one RK2 step, re-resolving the session's heavy
        artifacts from the shared cache first (the cache is the owner;
        the session only holds keys).  Steady state: pure hits; after an
        eviction the live artifacts re-register under the same keys."""
        ses = self.sessions[session_id]
        stepper = ses.stepper
        for key, live in stepper.artifact_keys().items():
            self.cache.get(key, lambda value=live: value)
        record = stepper.step()
        self.counters["session_steps"] += 1
        self._latencies["session"].append(record.seconds)
        return record

    # -- observability -------------------------------------------------------

    def stats(self) -> dict:
        lat = {}
        for lane, xs in list(self._latencies.items()):
            a = np.asarray(xs, dtype=np.float64)
            lat[lane] = {"n": int(a.size),
                         "p50_ms": float(np.percentile(a, 50) * 1e3),
                         "p99_ms": float(np.percentile(a, 99) * 1e3)}
        paid = self.counters["padding_paid_flops"]
        useful = self.counters["padding_useful_flops"]
        return {**self.counters, "cache": self.cache.stats(),
                "latency": lat,
                "batch_utilization": (useful / paid) if paid else 1.0,
                "jit_entries": batched_cache_entries()}
