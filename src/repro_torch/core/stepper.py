"""Dynamic load-balanced vortex time stepping, with guarded execution.

``rk2_step`` runs the FMM velocity, the half kick, a device-side rebin
(``quadtree.rebuild_tree``), the second FMM, the full kick and a second
rebin, with no host round trip inside the step.  With a ``mesh`` (a
:class:`~repro_torch.launch.mesh.RankMesh`) each evaluation is the sharded
driver's (``core/parallel_fmm.py``) under the step's plan, and every rank
gets the whole velocity field: the kicks and rebins run replicated on
every rank, as the reference's global arrays imply (no particle
migration).

:class:`VortexStepper` owns the ``(tree, plan)`` pair and closes the
model -> execution -> measurement loop, on one device (``mesh=None``) or
on every rank of a mesh:

  * every ``replan_every`` steps the leaf occupancy is pulled, measured
    times (the host wall clock by default) are folded into the weights,
    and a new plan is adopted when the modeled Eq-20 bottleneck improves
    by more than ``replan_tol``;
  * an occupancy guard re-levels the tree on the host before a leaf box
    can overflow its slots mid-run;
  * with ``guard=True`` (default) every step also returns the device-side
    health word (``core/health.py``), and a fault walks the bounded
    :class:`RecoveryPolicy` ladder: plain retries -> halved dt -> host
    re-level -> root-box expansion (``quadtree.Domain``) -> plan fallback
    (block -> slab -> uniform, on a mesh of more than one rank) -> the
    kernels' plain versions on the serial route (on the CPU only) ->
    rollback to the last checkpoint -> typed :class:`StepperFaultError`
    carrying a structured :class:`FaultReport`.

On a mesh every host decision agrees across ranks: a step's recorded time
is the largest rank's (one ``all_reduce(MAX)``), and the re-plans,
re-levels and recovery rungs read only that time and the replicated tree.

Periodic snapshots go through ``checkpoint.manager.CheckpointManager`` in
the reference package's format (rank 0 writes, every rank reads);
``VortexStepper.from_checkpoint`` restores the tree and payload bit-exact
onto a mesh of any size and rebuilds the plan from the restored leaf
counts.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import spans
from ..checkpoint.manager import CheckpointManager, numpy_dtype, to_host
from ..configs.backend import check_finite, check_on, resolve_device
from . import faults as flt
from . import health as hw
from . import partition as pt
from .cost_model import ModelParams, array_digest
from .fmm import fmm_velocity
from .parallel_fmm import parallel_fmm_p2p_prefetch, parallel_fmm_velocity
from .plan import (BlockPlan, assignment_from_plan, autotune_plan,
                   candidate_grids, measured_row_scale, plan_from_counts,
                   plan_loads, plan_stats, replan, uniform_plan)
from .quadtree import (Domain, Tree, build_tree, choose_level, map_leaves,
                       rebuild_tree)

# 64-bit host dtypes and the 32-bit ones the reference's arrays take
# (jax without x64), so payloads and checkpoints agree between packages.
_TO_32 = {np.dtype(np.float64): np.float32, np.dtype(np.complex128): np.complex64,
          np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32}


def rk2_step(tree: Tree, dt: float, payload=None, *, p: int, mesh=None,
             plan=None, overlap: bool = True, pipeline: bool = True,
             guard: bool = False, faults: tuple = (), plain: bool = False,
             device=None):
    """One RK2 midpoint step; ``dz/dt = conj(W)`` (W = u - iv).

    ``payload`` is an optional tensor or nested tuple/list/dict of per-slot
    (n, n, s) tensors carried through both rebinnings.  ``device`` (None:
    the CUDA card) must hold the tree; a ``mesh`` brings its own device and
    runs both evaluations through the sharded driver under ``plan`` (None:
    the uniform slab), ``overlap`` and ``pipeline``; with ``pipeline`` the
    second evaluation's P2P exchange is issued as soon as the rebinned
    midpoint tree exists.  Returns ``(new_tree, new_payload, ok, occ,
    health)`` as device tensors: ``ok`` is False iff a leaf box
    overflowed its slots during either rebin and ``occ`` is the maximum
    leaf occupancy after the step.  ``guard=True`` also assembles the
    ``core/health.py`` word (driver sentinels, out-of-domain counts taken
    BEFORE the rebins clamp, dropped-particle count, the overflow bit and
    occupancy); ``guard=False`` returns ``health=None``.  ``faults`` is the
    tuple of active :class:`~repro_torch.core.faults.FaultSpec`s, injected
    after the first half kick (the empty tuple runs the injection-free
    step).  ``plain=True`` runs P2P, M2L, P2M and L2P through the kernels'
    plain versions, on the serial route and the CPU only.
    """
    if mesh is not None and plain:
        raise ValueError("plain=True runs the serial route: pass mesh=None")
    dev = mesh.device if mesh is not None else resolve_device(device)
    check_on(dev, tree.z, tree.q, tree.mask)

    def velocity(t, p2p_halo=None):
        if mesh is None:
            return fmm_velocity(t, p, with_health=guard, device=dev, plain=plain)
        return parallel_fmm_velocity(t, p, mesh, plan, overlap,
                                     with_health=guard, faults=faults,
                                     pipeline=pipeline, p2p_halo=p2p_halo)
    v1 = velocity(tree)
    w1, h1 = v1 if guard else (v1, None)
    with spans.span("rk2.kick"):
        z_mid = torch.where(tree.mask, tree.z + 0.5 * dt * torch.conj(w1), tree.z)
        z_mid = flt.corrupt_positions(z_mid, tree.mask, faults)
        check_finite("half_kick", z_mid)
    live0 = tree.mask.sum()
    aux = (tree.z, payload) if payload is not None else (tree.z,)
    with spans.span("rk2.rebin"):
        t_mid, aux, ok1 = rebuild_tree(tree, z_mid, aux=aux)
    z0 = aux[0]
    # the next evaluation's P2P exchange goes out as soon as its tree exists
    p2p_pre = None
    if pipeline and mesh is not None:
        p2p_pre = parallel_fmm_p2p_prefetch(t_mid, mesh, plan)
    ood1 = hw.out_of_domain_count(z_mid, tree.mask) if guard else None

    v2 = velocity(t_mid, p2p_pre)
    w2, h2 = v2 if guard else (v2, None)
    with spans.span("rk2.kick"):
        z_new = torch.where(t_mid.mask, z0 + dt * torch.conj(w2), t_mid.z)
        check_finite("full_kick", z_new)
    ood2 = hw.out_of_domain_count(z_new, t_mid.mask) if guard else None
    with spans.span("rk2.rebin"):
        t_new, aux, ok2 = rebuild_tree(t_mid, z_new,
                                       aux=aux[1] if payload is not None else None)
    with spans.span("rk2.health"):
        occ = t_new.mask.sum(dim=-1).max()
        health = None
        if guard:
            health = hw.merge(h1, h2)
            health = hw.with_count(health, hw.F_OOD, ood1 + ood2)
            # a rebin drop is live particles lost to capacity overflow
            health = hw.with_count(health, hw.F_DROPPED, live0 - t_new.mask.sum())
            health = hw.with_flag(health, hw.F_OVERFLOW, ~(ok1 & ok2))
            health = hw.with_flag(health, hw.F_OCC, occ)
    return t_new, aux, ok1 & ok2, occ, health


# The step by name, for the static-analysis layer (``analysis/``): its
# contracts trace "rk2_step" (no finiteness sentinel with guard=False, no
# write into an input: the recovery ladder retries from the intact pre-step
# tree) and its schedule verifier runs it on every rank id.
TRACE_ENTRY_POINTS = {"rk2_step": rk2_step}


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``, 64-bit dtypes narrowed as the reference's."""
    a = np.asarray(a)
    return torch.as_tensor(a.astype(_TO_32.get(a.dtype, a.dtype), copy=False),
                           device=device)


def robust_wall(samples, clip: float = 4.0) -> float:
    """Median/clip outlier filter for wall-clock samples.

    One corrupted sample (a scheduler stall inflating a step, or a garbage
    near-zero timer reading) must not thrash the measured-feedback loop.
    Samples outside ``[median/clip, median*clip]`` are discarded and the
    median of the survivors is returned, so a single outlier in either
    direction moves the estimate by at most one rank."""
    s = np.asarray(list(samples), dtype=np.float64)
    med = float(np.median(s))
    keep = s[(s >= med / clip) & (s <= med * clip)]
    return float(np.median(keep)) if keep.size else med


def clean_wall_samples(records) -> list[float]:
    """Steady-state wall-clock samples from a list of :class:`StepRecord`s.

    Drops every FLAGGED record (replanned, releveled, or recovered: those
    steps paid a host rebuild and/or recovery reruns inside their own
    timer) AND each flagged record's successor, the step that runs first
    on the adopted plan or tree."""
    flagged = [bool(r.replanned or r.releveled or r.recovered)
               for r in records]
    return [r.seconds for i, r in enumerate(records)
            if not flagged[i] and not (i > 0 and flagged[i - 1])]


def host_wallclock_times(stepper: "VortexStepper"):
    """Default ``measured_times_fn``: per-part times from the host-side
    step wall clock, attributed to parts in proportion to their modeled
    load (uniform rates, so the re-plan stays count-driven).  Flagged
    records and their successors are excluded (:func:`clean_wall_samples`)
    and the survivors go through :func:`robust_wall`.  Returns None until
    a clean steady-state step exists."""
    recent = clean_wall_samples(stepper.history)[-6:]
    if not recent:
        return None
    wall = robust_wall(recent)
    # maybe_replan stashes the counts it just pulled; pull fresh ones only
    # when called outside the replan path
    counts = getattr(stepper, "_counts_cache", None)
    if counts is None:
        counts = stepper.counts()
    loads = plan_loads(stepper.plan, counts, stepper.params)
    peak = max(float(loads.max()), 1e-30)
    return wall * np.asarray(loads, dtype=np.float64) / peak


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """The recovery ladder's knobs, in escalation order."""

    max_retries: int = 1          # rung 1: plain retries (transient faults)
    halve_dt: bool = True         # rung 2: two dt/2 substeps, same interval
    relevel: bool = True          # rung 3: host re-level at fresh capacity
    expand_domain: bool = True    # rung 4: grow the root box (OOD faults)
    domain_margin: float = 0.5    # relative margin of the expanded root box
    plan_fallback: bool = True    # rung 5: block -> slab -> uniform
    reference_route: bool = True  # rung 6: the kernels' plain versions (CPU)
    rollback: bool = True         # rung 7: restore the last checkpoint


@dataclasses.dataclass
class FaultReport:
    """Structured account of an exhausted recovery ladder."""

    step: int                     # 1-based index of the step that faulted
    attempts: list                # [{"rung": str, "health": {field: int}}]
    plan: str                     # plan descriptor at the time of the fault
    level: int
    dt: float

    def __str__(self) -> str:
        rungs = " -> ".join(a["rung"] for a in self.attempts)
        last = self.attempts[-1]["health"] if self.attempts else {}
        bad = {k: v for k, v in last.items()
               if v and k != "max_occupancy"}
        return (f"step {self.step} unrecoverable after [{rungs}]; "
                f"last health {bad}; plan={self.plan} level={self.level} "
                f"dt={self.dt}")


class StepperFaultError(RuntimeError):
    """Raised when every enabled recovery rung failed; carries the report."""

    def __init__(self, report: FaultReport):
        super().__init__(str(report))
        self.report = report


@dataclasses.dataclass
class StepRecord:
    """What one :meth:`VortexStepper.step` did.  ``seconds`` is the host
    time of the step's compute (its RK2 attempts, a recovery or re-level
    among them): it stops before the replan check and the checkpoint, so
    it misses :meth:`VortexStepper.maybe_replan`.  Dynamic re-planning
    reads it (:func:`host_wallclock_times`) as the time of the work it
    balances; the ``stepper.step`` span (``repro_torch.spans``) covers the
    whole call."""

    step: int
    seconds: float
    load_balance: float      # Eq (20) min/max on modeled band loads
    replanned: bool
    releveled: bool
    level: int
    recovered: str = ""      # recovery rung that rescued the step ("" = none)
    health: int = 0          # packed health word of the adopted attempt


class VortexStepper:
    """Owns ``(tree, plan)`` and advances the vortex system dynamically on
    one device (``device``; None: the CUDA card) or, with ``mesh``, on
    every rank of a :class:`~repro_torch.launch.mesh.RankMesh` (one stepper
    per rank, each holding the whole tree; the mesh brings the device).

    ``plan_method``: 'uniform' (strawman) or 'model' (a-priori cost-model
    plan), with ``dynamic=True`` adding re-planning from drifted counts and
    measured times (``measured_times_fn(stepper) -> (nparts,) seconds``,
    :func:`host_wallclock_times` by default).  ``plan_grid=(Pr, Pc)``
    schedules a 2-D :class:`BlockPlan` (``Pr * Pc`` must equal the mesh
    size) instead of row bands; ``"auto"`` lets the grid autotuner choose
    at build and every re-plan.  ``overlap`` and ``pipeline`` order the
    sharded driver's work.

    Guarded execution: ``guard=True`` (default) runs every step with the
    device-side health word and walks the :class:`RecoveryPolicy` ladder on
    a fault; ``guard=False`` keeps only the legacy overflow re-level.
    ``faults`` accepts a :class:`~repro_torch.core.faults.FaultInjector`.

    Checkpointing: ``checkpoint_dir`` + ``checkpoint_every=k`` snapshots
    (tree, payload, meta) every k adopted steps; the ladder's rollback rung
    restores the last snapshot bit-exact, and :meth:`from_checkpoint`
    rebuilds a stepper from the saved state.

    ``domain`` maps physical coordinates onto the solver's unit square
    (identity by default); the domain-expansion rung grows it when
    particles escape the root box.
    """

    def __init__(self, positions: np.ndarray, gamma: np.ndarray, sigma: float,
                 *, p: int = 12, dt: float = 0.005, mesh=None,
                 plan_method: str = "model", dynamic: bool = False,
                 plan_grid=None, overlap: bool = True, pipeline: bool = True,
                 replan_every: int = 4, replan_tol: float = 0.05,
                 target_per_box: float = 8.0, slots_headroom: float = 2.0,
                 occupancy_guard: float = 0.9, cut: Optional[int] = None,
                 payload=None,
                 measured_times_fn: Optional[Callable[["VortexStepper"],
                                                      np.ndarray]] = None,
                 guard: bool = True,
                 policy: Optional[RecoveryPolicy] = None,
                 faults: Optional[flt.FaultInjector] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0, checkpoint_keep: int = 3,
                 domain: Optional[Domain] = None,
                 artifact_cache=None, device=None):
        self._init_config(
            p=p, dt=dt, mesh=mesh, plan_method=plan_method, dynamic=dynamic,
            plan_grid=plan_grid, overlap=overlap, pipeline=pipeline,
            replan_every=replan_every,
            replan_tol=replan_tol, target_per_box=target_per_box,
            slots_headroom=slots_headroom, occupancy_guard=occupancy_guard,
            cut=cut, sigma=sigma, measured_times_fn=measured_times_fn,
            guard=guard, policy=policy, faults=faults,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            checkpoint_keep=checkpoint_keep, domain=domain,
            artifact_cache=artifact_cache, device=device)
        self._build_host(np.asarray(positions, np.float64),
                         np.asarray(gamma, np.float64),
                         payload_values=None if payload is None else payload)

    def _init_config(self, *, p, dt, mesh, plan_method, dynamic, plan_grid,
                     overlap, replan_every, replan_tol, target_per_box,
                     slots_headroom, occupancy_guard, cut, sigma,
                     measured_times_fn, guard, policy, faults, checkpoint_dir,
                     checkpoint_every, checkpoint_keep, domain, pipeline=True,
                     artifact_cache=None, device=None):
        if mesh is not None:
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            device = mesh.device
        self.mesh = mesh
        self.device = resolve_device(device)
        self.p, self.dt = p, float(dt)
        # externally-owned artifact cache (duck type: get(key, builder));
        # None builds everything locally
        self.artifact_cache = artifact_cache
        self._artifact_keys: dict = {}
        self.plan_method = plan_method
        self.dynamic = dynamic
        self.overlap = overlap
        self.pipeline = bool(pipeline)
        self.plan_grid = plan_grid if plan_grid in (None, "auto") \
            else tuple(plan_grid)
        self.replan_every = max(int(replan_every), 1)
        self.replan_tol = float(replan_tol)
        self.target_per_box = float(target_per_box)
        self.slots_headroom = float(slots_headroom)
        self.occupancy_guard = float(occupancy_guard)
        self._cut = cut
        self.sigma = float(sigma)           # PHYSICAL core size
        self.domain = domain or Domain()
        self.guard = bool(guard)
        self.policy = policy or RecoveryPolicy()
        self.faults = faults
        self.checkpoint_every = int(checkpoint_every)
        self._ckpt = (CheckpointManager(checkpoint_dir, keep=checkpoint_keep)
                      if checkpoint_dir else None)
        # rank 0 writes the snapshots; every rank reads them
        self._ckpt_writer = mesh is None or mesh.rank == 0
        self._rolled_back_steps: set[int] = set()
        # dynamic steppers default to the host wall-clock timer
        if measured_times_fn is None and dynamic:
            measured_times_fn = host_wallclock_times
        self.measured_times_fn = measured_times_fn
        self.step_count = 0
        self.history: list[StepRecord] = []

    # -- host-side (re)construction -----------------------------------------

    @property
    def nparts(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape[self.mesh.axis]

    def _min_level(self) -> int:
        # every part needs at least one parent row (2 leaf rows) on each of
        # its grid's axes; "auto" sizes for its most square candidate
        if self.plan_grid == "auto":
            need = max(min(2 * max(g) for g in candidate_grids(self.nparts)),
                       4)
        elif self.plan_grid is not None:
            need = max(2 * max(self.plan_grid), 4)
        else:
            need = max(2 * self.nparts, 4)
        return max(2, math.ceil(math.log2(need)))

    # -- externally-owned artifact cache (session re-entrancy) ---------------

    def _cached(self, key, builder):
        if self.artifact_cache is None:
            return builder()
        return self.artifact_cache.get(key, builder)

    def _plan_key(self, counts) -> tuple:
        return ("plan", array_digest(counts), self.params, self.nparts,
                self.plan_method, self.plan_grid, self.overlap, self.pipeline)

    def _build_plan(self, counts):
        """The deterministic a-priori plan build (cache-keyable; replans
        driven by MEASURED times never go through the cache)."""
        if self.plan_grid == "auto":
            return autotune_plan(counts, self.params, self.nparts,
                                 method=self.plan_method,
                                 overlap=self.overlap,
                                 pipeline=self.pipeline)
        return plan_from_counts(counts, self.params, self.nparts,
                                method=self.plan_method, grid=self.plan_grid)

    def artifact_keys(self) -> dict:
        """{cache_key: live_value} of the artifacts this stepper resolved
        through the external cache."""
        out = {}
        if "tree" in self._artifact_keys:
            out[self._artifact_keys["tree"]] = (self.tree, self.index)
        if "plan" in self._artifact_keys:
            out[self._artifact_keys["plan"]] = self.plan
        return out

    @spans.traced("stepper.plan")
    def _adopt_plan(self, counts) -> None:
        plan_key = self._plan_key(counts)
        self.plan = self._cached(plan_key, lambda: self._build_plan(counts))
        self._artifact_keys["plan"] = plan_key
        self.subtree_assign = assignment_from_plan(self.plan, self.params.cut)
        self._cached_lb = plan_stats(self.plan, counts,
                                     self.params)["load_balance"]

    @spans.traced("stepper.build")
    def _build_host(self, positions, gamma, payload_values=None):
        """(Re)bin PHYSICAL particles through the domain map (unit coords,
        scaled sigma/gamma — see :class:`quadtree.Domain`)."""
        size = self.domain.size
        positions = self.domain.to_unit(positions)
        gamma = np.asarray(gamma, np.float64) / size ** 2
        sigma_unit = self.sigma / size
        level = max(choose_level(len(positions), self.target_per_box),
                    self._min_level())
        n = 1 << level
        ij = np.clip((positions * n).astype(np.int64), 0, n - 1)
        occ = np.bincount(ij[:, 1] * n + ij[:, 0], minlength=n * n).max()
        slots = max(int(math.ceil(occ * self.slots_headroom)), 2)
        tree_key = ("tree", array_digest(positions, gamma), level, slots,
                    float(sigma_unit), complex(1.0 / (2j * np.pi)))
        self.tree, self.index = self._cached(
            tree_key, lambda: build_tree(positions, gamma, level, sigma_unit,
                                         slots=slots, device=self.device))
        self._artifact_keys = {"tree": tree_key}
        if payload_values is not None:
            def scatter(v):
                v = to_host(v)
                flat = np.zeros((n * n, slots), dtype=v.dtype)
                flat[self.index.box_of_particle,
                     self.index.slot_of_particle] = v
                return _to_device(flat.reshape(n, n, slots), self.device)
            self.payload = map_leaves(scatter, payload_values)
        else:
            self.payload = None
        cut = self._cut if self._cut is not None else min(level - 1, 4)
        self.params = ModelParams(level=level, cut=max(cut, 1), p=self.p,
                                  slots=slots)
        if self.plan_grid not in (None, "auto") and \
                self.plan_grid[0] * self.plan_grid[1] != self.nparts:
            raise ValueError(f"plan_grid {self.plan_grid} has "
                             f"{self.plan_grid[0] * self.plan_grid[1]} tiles"
                             f" for {self.nparts} devices")
        self._adopt_plan(self.index.counts)

    def counts(self) -> np.ndarray:
        return self.tree.mask.sum(dim=-1).to(torch.int32).cpu().numpy()

    def particles(self) -> tuple[np.ndarray, np.ndarray]:
        """(positions, gamma) of the live particles, host-side, PHYSICAL
        coordinates (the inverse of the domain map ``_build_host`` applies;
        an identity domain is bit-transparent)."""
        m = self.tree.mask.cpu().numpy().reshape(-1)
        z = self.tree.z.cpu().numpy().reshape(-1)[m]
        q = self.tree.q.cpu().numpy().reshape(-1)[m]
        pos = self.domain.from_unit(np.stack([z.real, z.imag], axis=1))
        gamma = np.real(q * 2j * np.pi) * self.domain.size ** 2
        return pos, gamma

    def _gather_payload_values(self):
        if self.payload is None:
            return None
        m = self.tree.mask.cpu().numpy().reshape(-1)
        return map_leaves(lambda a: to_host(a).reshape(-1)[m],
                           self.payload)

    @spans.traced("stepper.relevel")
    def _relevel(self):
        """Host rebuild at a freshly chosen level/capacity (overflow guard)."""
        pos, gamma = self.particles()
        self._build_host(pos, gamma,
                         payload_values=self._gather_payload_values())

    def _expand_domain(self, margin: Optional[float] = None):
        """Grow the root box and rebuild: the recovery rung for particles
        escaping the current domain.  The new domain covers the old one and
        is at least twice its size, so the escaping step gains real room."""
        margin = self.policy.domain_margin if margin is None else margin
        pos, gamma = self.particles()
        payload_values = self._gather_payload_values()
        new = Domain.covering(pos, margin=margin, at_least=self.domain)
        if new.size < 2.0 * self.domain.size:
            cx = new.origin[0] + new.size / 2.0
            cy = new.origin[1] + new.size / 2.0
            size = 2.0 * self.domain.size
            new = Domain(origin=(cx - size / 2.0, cy - size / 2.0), size=size)
        self.domain = new
        self._build_host(pos, gamma, payload_values=payload_values)

    # -- checkpointing -------------------------------------------------------

    @spans.traced("stepper.checkpoint")
    def save_checkpoint(self):
        """Snapshot (tree, payload, meta) through the checkpoint manager."""
        if self._ckpt is None:
            raise RuntimeError("stepper built without checkpoint_dir")
        trees = {"tree": {"z": self.tree.z, "q": self.tree.q,
                          "mask": self.tree.mask}}
        payload_spec = None
        if self.payload is not None:
            trees["payload"] = self.payload
            if isinstance(self.payload, dict):
                payload_spec = {k: str(numpy_dtype(v))
                                for k, v in self.payload.items()}
        meta = {"level": self.params.level, "cut": self.params.cut,
                "slots": self.params.slots, "p": self.p, "dt": self.dt,
                "sigma": self.sigma, "sigma_unit": float(self.tree.sigma),
                "domain_origin": list(self.domain.origin),
                "domain_size": self.domain.size,
                "plan_method": self.plan_method,
                "payload_spec": payload_spec}
        if self._ckpt_writer:
            self._ckpt.save(self.step_count, trees, meta)

    def wait_checkpoint(self) -> None:
        """Block until the last snapshot is on disk, on every rank."""
        if self._ckpt_writer:
            self._ckpt.wait()
        if self.mesh is not None:
            self.mesh.barrier()

    @staticmethod
    def _templates_from_meta(meta):
        n, s = 1 << meta["level"], meta["slots"]
        templates = {"tree": {"z": np.zeros((n, n, s), np.complex64),
                              "q": np.zeros((n, n, s), np.complex64),
                              "mask": np.zeros((n, n, s), bool)}}
        if meta.get("payload_spec"):
            templates["payload"] = {
                k: np.zeros((n, n, s), np.dtype(dt))
                for k, dt in meta["payload_spec"].items()}
        return templates

    def _adopt_restored(self, out, meta):
        """Install the restored arrays on the stepper's device and rebuild
        the plan from their counts (bit-exact: no host rebuild), on any
        number of parts whose least level the saved tree reaches; a tree
        too shallow for them is re-leveled on the host instead."""
        t = out["tree"]
        self.tree = Tree(z=torch.as_tensor(t["z"], device=self.device),
                         q=torch.as_tensor(t["q"], device=self.device),
                         mask=torch.as_tensor(t["mask"], device=self.device),
                         level=meta["level"], sigma=meta["sigma_unit"])
        self.payload = None
        if "payload" in out:
            self.payload = map_leaves(
                lambda a: torch.as_tensor(a, device=self.device), out["payload"])
        self.domain = Domain(origin=tuple(meta["domain_origin"]),
                             size=meta["domain_size"])
        self.sigma = meta["sigma"]
        self.params = ModelParams(level=meta["level"], cut=meta["cut"],
                                  p=self.p, slots=meta["slots"])
        self.step_count = meta["step"]
        self._counts_cache = None
        if meta["level"] < self._min_level():
            # too shallow for this many parts: the one restore that is not
            # bit-exact (a host rebuild)
            self._relevel()
            return
        # no host tree build on this path: only the plan key is live
        self._artifact_keys = {}
        self._adopt_plan(self.counts())

    def rollback(self, step: Optional[int] = None) -> int:
        """Restore the last (or a given) checkpoint bit-exact; returns the
        restored step index."""
        if self._ckpt is None:
            raise RuntimeError("stepper built without checkpoint_dir")
        self.wait_checkpoint()          # never race an in-flight save
        step = self._ckpt.latest_step() if step is None else step
        if step is None:
            raise RuntimeError("no checkpoint to roll back to")
        meta = self._ckpt.load_meta(step)
        out, meta = self._ckpt.restore(self._templates_from_meta(meta),
                                       step=step)
        self._adopt_restored(out, meta)
        return step

    @classmethod
    def from_checkpoint(cls, directory: str, *, mesh=None,
                        step: Optional[int] = None,
                        plan_method: str = None,
                        dynamic: bool = False, plan_grid=None,
                        overlap: bool = True, pipeline: bool = True,
                        replan_every: int = 4,
                        replan_tol: float = 0.05,
                        target_per_box: float = 8.0,
                        slots_headroom: float = 2.0,
                        occupancy_guard: float = 0.9,
                        measured_times_fn=None, guard: bool = True,
                        policy: Optional[RecoveryPolicy] = None,
                        faults: Optional[flt.FaultInjector] = None,
                        checkpoint_every: int = 0,
                        checkpoint_keep: int = 3,
                        artifact_cache=None, device=None) -> "VortexStepper":
        """Rebuild a stepper from a checkpoint directory (written by either
        package, on any number of parts): tree and payload restored bit-exact
        onto ``device`` or every rank of ``mesh``, the plan rebuilt from the
        restored leaf counts."""
        mgr = CheckpointManager(directory, keep=checkpoint_keep)
        step = mgr.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
        meta = mgr.load_meta(step)
        out, meta = mgr.restore(cls._templates_from_meta(meta), step=step)
        st = cls.__new__(cls)
        st._init_config(
            p=meta["p"], dt=meta["dt"], mesh=mesh,
            plan_method=plan_method or meta.get("plan_method", "model"),
            dynamic=dynamic, plan_grid=plan_grid, overlap=overlap,
            pipeline=pipeline,
            replan_every=replan_every, replan_tol=replan_tol,
            target_per_box=target_per_box, slots_headroom=slots_headroom,
            occupancy_guard=occupancy_guard, cut=meta["cut"],
            sigma=meta["sigma"], measured_times_fn=measured_times_fn,
            guard=guard, policy=policy, faults=faults,
            checkpoint_dir=directory, checkpoint_every=checkpoint_every,
            checkpoint_keep=checkpoint_keep, domain=None,
            artifact_cache=artifact_cache, device=device)
        st._adopt_restored(out, meta)
        return st

    # -- the dynamic loop ----------------------------------------------------

    @spans.traced("stepper.replan")
    def maybe_replan(self, measured_times: Optional[np.ndarray] = None,
                     occ: Optional[int] = None) -> str:
        """Re-level if occupancy approaches capacity; re-plan if it pays.

        ``occ`` (max leaf occupancy) is normally read off the step's own
        outputs, so the overflow guard costs no extra device sync; the
        counts grid is pulled once per replan interval to refresh the
        reported load balance and (when dynamic) drive the re-plan.
        Returns what was adopted: ``"relevel"``, ``"replan"`` or ``""``."""
        if occ is None:
            occ = int(self.tree.mask.sum(dim=-1).max())
        if occ >= self.occupancy_guard * self.params.slots:
            self._relevel()
            return "relevel"
        with spans.span("replan.counts"):
            counts = self.counts()
            self._counts_cache = counts     # reused by host_wallclock_times
        with spans.span("replan.balance"):
            self._cached_lb = plan_stats(self.plan, counts,
                                         self.params)["load_balance"]
        if not self.dynamic:
            return ""
        return self._replan(counts, measured_times)

    @spans.traced("replan.plan")
    def _replan(self, counts, measured_times) -> str:
        """The dynamic re-plan from fresh ``counts``: ``"replan"`` when a
        new plan was adopted, else ``""``."""
        if measured_times is None and self.measured_times_fn is not None:
            measured_times = self.measured_times_fn(self)
        new_plan = replan(counts, self.params, self.nparts,
                          prev_plan=self.plan, measured_times=measured_times,
                          method=self.plan_method, grid=self.plan_grid,
                          overlap=self.overlap, pipeline=self.pipeline)
        if new_plan == self.plan:
            return ""
        # adopt when the modeled bottleneck (measured-rate-weighted when
        # times are available) improves by more than the tolerance
        scale = None
        if measured_times is not None:
            scale = measured_row_scale(self.plan, counts, self.params,
                                       measured_times)
        old_max = plan_loads(self.plan, counts, self.params, scale).max()
        new_max = plan_loads(new_plan, counts, self.params, scale).max()
        if new_max > (1.0 - self.replan_tol) * old_max:
            return ""
        self.plan = new_plan
        self._cached_lb = plan_stats(new_plan, counts,
                                     self.params)["load_balance"]
        graph = pt.build_subtree_graph(counts, self.params)
        if measured_times is not None:
            self.subtree_assign = pt.rebalance(
                graph, assignment_from_plan(new_plan, self.params.cut),
                self.nparts, measured_times)
        else:
            self.subtree_assign = assignment_from_plan(new_plan,
                                                       self.params.cut)
        return "replan"

    def modeled_step_work(self) -> float:
        """Eq 13-15 modeled bottleneck of the current plan: the max
        per-partition load, in cost-model units."""
        counts = getattr(self, "_counts_cache", None)
        if counts is None:
            counts = self.counts()
            self._counts_cache = counts
        return float(plan_loads(self.plan, counts, self.params).max())

    def predicted_step_seconds(self) -> Optional[float]:
        """Robust-filtered steady-state step wall time, or None until a
        clean sample exists (:func:`clean_wall_samples`, then
        :func:`robust_wall` over the recent window)."""
        recent = clean_wall_samples(self.history)[-8:]
        if not recent:
            return None
        return robust_wall(recent)

    # -- guarded execution ---------------------------------------------------

    def _active_faults(self, attempt: int) -> tuple:
        if self.faults is None:
            return ()
        active = self.faults.active(self.step_count + 1, attempt)
        # teleport magnitudes are PHYSICAL; rk2 runs in unit coordinates,
        # so rescale by the current domain size (root-box expansion can
        # then genuinely cure a sticky teleport that fits the new domain)
        return tuple(dataclasses.replace(f,
                                         magnitude=f.magnitude
                                         / self.domain.size)
                     if f.site == "teleport" else f
                     for f in active)

    def _run_rk2(self, dt, faults=(), plan=None, reference=False):
        """One rk2 attempt from the CURRENT (tree, payload); adopts nothing.

        ``plan`` overrides the stepper's plan on a mesh.  ``reference=True``
        runs the serial route with the kernels' plain versions, the
        ladder's last compute rung (CPU only; on a mesh every rank runs it
        whole).  Waits for the device and takes
        ``ok``, ``occ`` and the health word to the host in one copy;
        returns ``(tree, payload, ok, occ, health)``."""
        mesh = None if reference else self.mesh
        with spans.span("stepper.rk2"):
            tree, payload, ok, occ, health = rk2_step(
                self.tree, dt, self.payload, p=self.p, mesh=mesh,
                plan=None if mesh is None else (plan or self.plan),
                overlap=self.overlap, pipeline=self.pipeline, guard=self.guard,
                faults=faults, plain=reference, device=self.device)
        with spans.span("stepper.wait"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            words = [ok.reshape(1).to(torch.int32), occ.reshape(1).to(torch.int32)]
            if health is not None:
                words.append(health)
            host = torch.cat(words).cpu().numpy()
        return (tree, payload, bool(host[0]), int(host[1]),
                None if health is None else host[2:])

    @spans.traced("stepper.recover")
    def _recover(self, first_health: np.ndarray):
        """Walk the recovery ladder for the step that just faulted.

        Returns ``(tree, payload, occ, health, rung, releveled, replanned)``
        with the recovered step's state, or ``(None, ..., "rollback", ...)``
        after a checkpoint rollback (the step did NOT advance), or raises
        :class:`StepperFaultError` once every enabled rung is exhausted.
        """
        pol = self.policy
        attempts = [{"rung": "step", "health": hw.describe(first_health)}]
        saw_ood = int(first_health[hw.F_OOD]) > 0
        attempt = 1

        def run(dt, **kw):
            nonlocal attempt
            f = self._active_faults(attempt)
            attempt += 1
            return self._run_rk2(dt, faults=f, **kw)

        def note(rung, h):
            nonlocal saw_ood
            attempts.append({"rung": rung, "health": hw.describe(h)})
            saw_ood = saw_ood or int(h[hw.F_OOD]) > 0

        # rung 1: bounded plain retries (the transient-fault model)
        for r in range(max(pol.max_retries, 0)):
            t = run(self.dt)
            note(f"retry_{r + 1}", t[4])
            if hw.ok(t[4]):
                return t[0], t[1], t[3], t[4], f"retry_{r + 1}", False, False
        # rung 2: halved dt, two half-steps covering the same interval, so
        # a recovered trajectory stays comparable to an unfaulted one
        if pol.halve_dt:
            t1 = run(self.dt / 2.0)
            note("half_dt_1", t1[4])
            if hw.ok(t1[4]):
                saved = (self.tree, self.payload)
                self.tree, self.payload = t1[0], t1[1]
                t2 = run(self.dt / 2.0)
                self.tree, self.payload = saved
                note("half_dt_2", t2[4])
                if hw.ok(t2[4]):
                    return t2[0], t2[1], t2[3], t2[4], "half_dt", False, False
        # rung 3: host re-level at freshly chosen depth/capacity
        if pol.relevel:
            self._relevel()
            t = run(self.dt)
            note("relevel", t[4])
            if hw.ok(t[4]):
                return t[0], t[1], t[3], t[4], "relevel", True, False
        # rung 4: root-box expansion (particles escaped the domain)
        if pol.expand_domain and saw_ood:
            self._expand_domain()
            t = run(self.dt)
            note("expand_domain", t[4])
            if hw.ok(t[4]):
                return t[0], t[1], t[3], t[4], "expand_domain", True, False
        # rung 5: plan fallback block -> slab -> uniform (bad plan/exchange)
        if pol.plan_fallback and self.mesh is not None and self.nparts > 1:
            for name, fb in self._fallback_plans():
                t = run(self.dt, plan=fb)
                note(f"plan_{name}", t[4])
                if hw.ok(t[4]):
                    self.plan = fb
                    self.plan_grid = None
                    counts = self.counts()
                    self.subtree_assign = assignment_from_plan(
                        fb, self.params.cut)
                    self._cached_lb = plan_stats(fb, counts,
                                                 self.params)["load_balance"]
                    return t[0], t[1], t[3], t[4], f"plan_{name}", False, True
        # rung 6: the kernels' plain versions, on the CPU only: on the card a
        # kernel that keeps failing the health check goes on to rollback or
        # StepperFaultError, whose report carries every attempt's health
        if pol.reference_route and self.device.type == "cpu":
            t = run(self.dt, reference=True)
            note("reference", t[4])
            if hw.ok(t[4]):
                return t[0], t[1], t[3], t[4], "reference", False, False
        # rung 7: rollback to the last good checkpoint (once per step)
        fault_step = self.step_count + 1
        if pol.rollback and self._ckpt is not None:
            self.wait_checkpoint()      # every rank sees the same snapshots
        if (pol.rollback and self._ckpt is not None
                and fault_step not in self._rolled_back_steps
                and self._ckpt.latest_step() is not None):
            self._rolled_back_steps.add(fault_step)
            self.rollback()
            return None, None, 0, first_health, "rollback", False, False
        raise StepperFaultError(FaultReport(
            step=fault_step, attempts=attempts,
            plan=self.plan.describe(), level=self.params.level, dt=self.dt))

    def _fallback_plans(self):
        """Simpler-plan candidates in escalation order, the current plan and
        infeasible geometries excluded (a slab needs 2 leaf rows a part)."""
        out = []
        if (1 << self.params.level) < 2 * self.nparts:
            return out
        if isinstance(self.plan, BlockPlan) and self.plan.grid[1] > 1:
            out.append(("slab", plan_from_counts(self.counts(), self.params,
                                                 self.nparts, method="model")))
        uni = uniform_plan(self.params.level, self.nparts)
        if uni != self.plan:
            out.append(("uniform", uni))
        return out

    # -- stepping ------------------------------------------------------------

    @spans.traced("stepper.step")
    def step(self) -> StepRecord:
        """Advance one RK2 step; time it; periodically re-plan.

        Guarded steppers check the device-side health word and walk the
        recovery ladder on any fault; a rollback record carries
        ``recovered="rollback"`` and does NOT advance ``step_count``."""
        t0 = time.perf_counter()
        recovered, releveled, fb_replanned = "", False, False
        tree, payload, ok, occ, health = self._run_rk2(
            self.dt, faults=self._active_faults(0))
        if self.guard:
            if not hw.ok(health):
                (tree, payload, occ, health, recovered, releveled,
                 fb_replanned) = self._recover(health)
                if tree is None:        # rolled back: step did not advance
                    seconds = self._step_seconds(t0)
                    rec = StepRecord(step=self.step_count, seconds=seconds,
                                     load_balance=self._cached_lb,
                                     replanned=False, releveled=False,
                                     level=self.params.level,
                                     recovered="rollback",
                                     health=hw.pack(health))
                    self.history.append(rec)
                    return rec
        elif not ok:
            # legacy (unguarded) overflow path: the old tree is still
            # intact — re-level on the host and redo the step safely.
            releveled = True
            self._relevel()
            tree, payload, ok, occ, health = self._run_rk2(self.dt)
            if not ok:
                raise RuntimeError(
                    "leaf box overflow persists after re-leveling; "
                    "increase slots_headroom or lower target_per_box")
        # the timer covers everything the step actually cost, including a
        # re-level/recovery when one happened
        seconds = self._step_seconds(t0)
        self.tree, self.payload = tree, payload
        self.step_count += 1
        if self.faults is not None:
            # host-side fault site: corrupt this step's wall-clock sample
            seconds *= self.faults.time_factor(self.step_count)
        replanned = fb_replanned
        self._counts_cache = None       # tree advanced: drop stale counts
        if self.step_count % self.replan_every == 0:
            # occ came to the host with the step's outputs: the check
            # itself syncs nothing extra
            action = self.maybe_replan(occ=int(occ))
            replanned = replanned or action == "replan"
            releveled = releveled or action == "relevel"
        rec = StepRecord(step=self.step_count, seconds=seconds,
                         load_balance=self._cached_lb,
                         replanned=replanned,
                         releveled=releveled or bool(recovered == "relevel"),
                         level=self.params.level, recovered=recovered,
                         health=0 if health is None else hw.pack(health))
        self.history.append(rec)
        if (self._ckpt is not None and self.checkpoint_every
                and self.step_count % self.checkpoint_every == 0):
            self.save_checkpoint()
        return rec

    def _step_seconds(self, t0: float) -> float:
        """Host seconds since ``t0``; on a mesh the largest rank's, so every
        rank records, and decides on, the same time."""
        seconds = time.perf_counter() - t0
        return seconds if self.mesh is None else self.mesh.all_reduce_max(seconds)

    def stats(self) -> dict:
        return plan_stats(self.plan, self.counts(), self.params)
