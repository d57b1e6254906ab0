"""Training loop: the step, fault tolerance, expert-load probing, on one
card or on a grid of ranks.

The reference's ``train/loop.py``:

* ``make_train_step`` differentiates ``make_loss_fn`` with
  ``torch.autograd.grad`` (the reference's ``jax.value_and_grad``); a
  parameter the loss does not reach gets a zero gradient, as under
  ``jax.grad``.  Gradient accumulation splits the batch on dim 0 and sums
  the microbatches' gradients into f32 buffers.  ``apply_updates`` writes
  the parameters and the optimizer state in place.
* ``Trainer`` checkpoints every ``ckpt_every`` steps through
  ``checkpoint/manager.py`` (atomic, async, keep-last-k; the reference's
  file format), the pipeline state in the checkpoint's meta, so a restart
  resumes the same stream; ``restore_reference`` resumes from a checkpoint
  that the reference's ``Trainer`` wrote.
* ``probe_expert_load`` counts layer 0's routed tokens per expert, the
  load that the reference's expert placement balances.

On a grid (``mesh``, a ``launch/mesh.py:GridMesh``) each rank holds its
blocks of the parameters and of the AdamW state (``parallel/sharding.py``)
and takes its data rank's rows of every global batch.  There is no
compiler to propagate shardings, so the forward writes out what GSPMD does
for the reference (``models/tensor_parallel.py``): each layer gathers its
dense weights inside its checkpoint, computes its attention heads, FFN
hidden dim and the loss's vocab on this rank's share of the model axis,
and reduces each weight's gradient in its own backward to this rank's
block; the experts stay blocks, which ``moe_layer`` gathers layer by
layer.  The loss is the global batch's mean (``lm_loss(mesh=)``).
Checkpoints hold full arrays, written by rank 0 in
the one-rank format, and a restore keeps each rank's blocks of them, so a
checkpoint of any grid restores onto any other (the elastic restore).
One card is a grid of one rank (:func:`one_rank_grid`), where a block is
the whole array and no collective is issued: one code path for both.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager, to_host
from ..configs.backend import resolve_device
from ..data.pipeline import PipelineState, advance, make_inputs
from ..launch.mesh import GridMesh, make_grid_mesh
from ..models.config import ModelConfig, ShapeConfig
from ..models.convert import params_from_jax
from ..models.layers import rms_norm
from ..models.transformer import forward, grid_specs, init_params, lm_loss, param_tensors
from ..optim.adamw import AdamWConfig, apply_updates, init_state
from ..models import moe as moe_mod
from ..parallel import sharding as shd


def make_loss_fn(cfg: ModelConfig, mesh=None, *, q_chunk: int = 512,
                 loss_chunk: int = 256, remat: bool = True):
    def loss_fn(params, batch):
        h, _ = forward(params, batch["tokens"], cfg,
                       patch_embeds=batch.get("patch_embeds"),
                       q_chunk=q_chunk, remat=remat, mesh=mesh)
        if cfg.num_patches:
            h = h[:, cfg.num_patches:]      # loss over text positions only
        return lm_loss(params, h, batch["labels"], cfg, chunk=loss_chunk, mesh=mesh)
    return loss_fn


def unflatten(template, leaves):
    """``leaves`` (in :func:`param_tensors`' order) in ``template``'s structure."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, torch.Tensor):
            return next(it)
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        return [build(v) for v in t]
    return build(template)


# ---------------------------------------------------------------------------
# The grid: specs, blocks
# ---------------------------------------------------------------------------


def one_rank_grid(device="meta") -> GridMesh:
    """A grid of one rank: the mesh of a step on one card.  It issues no
    collective, so its device is read only by a caller that moves data
    to it (``Trainer`` gives its own)."""
    return make_grid_mesh((1, 1), device=device)


def tree_specs(tree, by_name: dict) -> list[tuple]:
    """The specs of ``tree``'s leaves in :func:`param_tensors`' order (a
    tree's order is its dicts' order, which differs between trees built
    in different ways)."""
    return [by_name[n] for n, _ in shd.flat_names(tree)]


def _own(block: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """``block`` (:func:`shd.local_block` of ``full``) in storage of its
    own when it is a part of ``full``, so that ``full`` can be freed."""
    return block if block is full else block.clone()


def local_rows(batch: dict, mesh) -> dict:
    """This data rank's rows of a global batch (``batch_spec``)."""
    out = {}
    for k, v in batch.items():
        spec = shd.batch_spec(mesh, v.dim())
        if v.shape[0] % shd.axis_size(mesh, spec[0]):
            raise ValueError(f"batch of {v.shape[0]} rows does not split over "
                             f"{spec[0]}")
        out[k] = shd.local_block(v, spec, mesh)
    return out


def value_and_grad(loss_fn, params, batch):
    """(loss, gradients in :func:`param_tensors`' order): each gradient in its
    parameter's dtype, zero for a parameter the loss does not reach.

    With a grid ``loss_fn`` (``make_loss_fn(cfg, mesh)``), ``params`` are
    this rank's blocks and ``batch`` its data rank's rows, and the
    gradients are this rank's blocks of the global batch's gradient: the
    forward gathers and reduces them itself."""
    live = [t.detach().requires_grad_() for t in param_tensors(params)]
    with torch.enable_grad():
        loss = loss_fn(unflatten(params, live), batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    return loss.detach(), [torch.zeros_like(t) if g is None else g
                           for t, g in zip(live, grads)]


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh=None,
                    num_microbatches: int = 1, **loss_kw):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``num_microbatches > 1`` is gradient accumulation: the
    batch splits on dim 0, so live activations scale 1/n.  On a grid
    ``mesh`` (without one, a grid of one rank), the trees are this rank's
    blocks and ``batch`` its data rank's rows (a data rank's microbatch
    ``i`` is the ``i``-th share of its rows)."""
    mesh = one_rank_grid() if mesh is None else mesh
    loss_fn = make_loss_fn(cfg, mesh, **loss_kw)
    n = num_microbatches
    by_name = grid_specs(cfg, mesh)

    def train_step(params, opt_state, batch):
        specs = tree_specs(params, by_name)
        if n == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            B = batch["tokens"].shape[0]
            if B % n:
                raise ValueError(f"batch {B} does not split into {n} microbatches")
            grads = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                     for t in param_tensors(params)]
            loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            for i in range(n):
                mb = {k: v.reshape((n, B // n) + v.shape[1:])[i] for k, v in batch.items()}
                l, g = value_and_grad(loss_fn, params, mb)
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                loss = loss + l
                del g
            loss = loss / n
            grads = [acc.div_(n) for acc in grads]
        params, opt_state, metrics = apply_updates(params, unflatten(params, grads),
                                                   opt_state, opt_cfg, mesh, specs)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def probe_expert_load(params, batch, cfg: ModelConfig) -> np.ndarray:
    """Router token counts for layer 0's experts (drives expert placement),
    in f32 as the reference's f32 parameters give them."""
    if cfg.moe is None:
        raise ValueError(f"{cfg.name} has no experts")
    p0 = params["layers"][0]
    f32 = torch.float32
    x = rms_norm(params["embed"][batch["tokens"]].to(f32), p0["ln1"].to(f32), cfg.rms_eps)
    logits = x.reshape(-1, cfg.d_model) @ p0["moe"]["router"].to(f32)
    idx = torch.topk(logits, cfg.moe.top_k, dim=-1).indices
    return torch.bincount(idx.reshape(-1), minlength=cfg.moe.num_experts).cpu().numpy()


# ---------------------------------------------------------------------------
# Checkpoints: the port's own, and the reference's
# ---------------------------------------------------------------------------


def _nest(flat: dict) -> dict:
    """npz keys ``a/0/b`` -> nested dicts, a dict whose keys are all
    indices turned into a list."""
    root: dict = {}
    for key, arr in flat.items():
        *path, last = key.split("/")
        node = root
        for part in path:
            node = node.setdefault(part, {})
        node[last] = arr

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(root)


def read_reference_checkpoint(directory: str, cfg: ModelConfig, device=None,
                              step: Optional[int] = None):
    """``(params, opt_state, meta)`` of a checkpoint that the reference's
    ``Trainer`` wrote (its newest complete step by default), or None.

    Its parameters and AdamW ``mu``/``nu`` are in the reference's grouped
    ``(pattern, reps)`` layout; they are read into the port's flat one
    (``convert.params_from_jax``): the parameters in the dtype in which
    ``forward`` reads them, ``mu`` and ``nu`` in their own state dtype."""
    dev = resolve_device(device)
    step = CheckpointManager(directory).latest_step() if step is None else step
    if step is None:
        return None
    base = os.path.join(directory, f"step_{step}")
    trees = {}
    for name in ("params", "opt"):
        with np.load(os.path.join(base, f"{name}.npz")) as z:
            trees[name] = _nest({k: z[k] for k in z.files})
    with open(os.path.join(base, "meta.json")) as f:
        meta = json.load(f)
    opt = trees["opt"]
    opt_state = {"mu": params_from_jax(opt["mu"], cfg, dev, keep_dtype=True),
                 "nu": params_from_jax(opt["nu"], cfg, dev, keep_dtype=True),
                 "step": torch.tensor(int(opt["step"]), dtype=torch.int32, device=dev)}
    return params_from_jax(trees["params"], cfg, dev), opt_state, meta


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    keep: int = 3
    log_every: int = 10
    seed: int = 0
    rebalance_every: int = 0     # 0 = off; >0 = expert-load probe cadence


class Trainer:
    """End-to-end driver used by ``examples/torch_train_lm.py``,
    ``launch/train.py`` and the tests; on the card unless ``device="cpu"``.
    Weights are random, from a generator seeded with ``tcfg.seed``.

    With a grid ``mesh`` (``launch/mesh.py:make_grid_mesh``; every rank
    builds its own Trainer) each rank draws the full parameters from the
    seed and keeps its blocks, and so its blocks of the AdamW state; a step
    takes its data rank's rows of the global batch (module docstring).
    Without one, the Trainer runs on a grid of one rank, whose blocks are
    the whole arrays: one code path for every grid."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 opt_cfg: Optional[AdamWConfig] = None,
                 tcfg: Optional[TrainerConfig] = None, device=None,
                 remat: bool = True, mesh=None):
        if mesh is not None and not isinstance(mesh, GridMesh):
            raise TypeError(f"Trainer's mesh is a grid of ranks (launch.mesh."
                            f"GridMesh), not {type(mesh).__name__}")
        self.cfg = cfg
        self.shape = shape
        self.tcfg = tcfg or TrainerConfig()
        self.opt_cfg = opt_cfg or AdamWConfig(total_steps=self.tcfg.steps)
        self.mesh = one_rank_grid(resolve_device(device)) if mesh is None else mesh
        self.device = self.mesh.device
        self.ckpt = CheckpointManager(self.tcfg.ckpt_dir, keep=self.tcfg.keep)
        self.pipeline = PipelineState(seed=self.tcfg.seed, step=0)
        self.step_times: list[float] = []
        self.expert_assignment: Optional[np.ndarray] = None

        gen = torch.Generator(device=self.device if self.device.type == "cuda" else "cpu")
        gen.manual_seed(self.tcfg.seed)
        params = init_params(cfg, gen, self.device)
        self.specs = tree_specs(params, grid_specs(cfg, self.mesh))
        self.params = unflatten(params, [_own(shd.local_block(t, s, self.mesh), t)
                                         for t, s in zip(param_tensors(params), self.specs)])
        del params
        self.opt_state = init_state(self.params, self.opt_cfg)
        self._step_fn = make_train_step(cfg, self.opt_cfg, self.mesh, remat=remat)
        self.metrics_log: list[dict] = []

    # -- blocks and full arrays -----------------------------------------------

    def _load_blocks(self, tree, full) -> None:
        """Copy into ``tree`` (blocks in the parameters' structure) this
        rank's blocks of ``full``, a tree of whole arrays matched by leaf
        name (its order may differ)."""
        by_name = dict(shd.flat_names(full))
        for (name, t), spec in zip(shd.flat_names(tree), self.specs):
            whole = torch.as_tensor(by_name[name]).to(self.device)
            t.copy_(shd.local_block(whole, spec, self.mesh))

    def _full_tree(self, tree):
        """``tree`` (blocks in the parameters' structure) gathered whole on
        rank 0, and None elsewhere; every rank takes part.  A gathered leaf
        is a host array, a block that is already whole stays the tensor (the
        checkpoint's writer copies it to the host itself)."""
        host = []
        for t, spec in zip(param_tensors(tree), self.specs):
            full = shd.gather_full(t, spec, self.mesh)
            host.append((full if full is t else to_host(full))
                        if self.mesh.rank == 0 else None)
            del full
        return unflatten(tree, host) if self.mesh.rank == 0 else None

    # -- fault tolerance ----------------------------------------------------

    def try_restore(self) -> bool:
        # every rank reads the full arrays and keeps its blocks: any grid's
        # checkpoint restores onto any other
        full = init_params(self.cfg, torch.Generator(), "meta")
        out, meta = self.ckpt.restore({"params": full, "opt": {
            "mu": full, "nu": full, "step": torch.empty((), dtype=torch.int32,
                                                       device="meta")}})
        if out is None:
            return False
        self._load_blocks(self.params, out["params"])
        self._load_blocks(self.opt_state["mu"], out["opt"]["mu"])
        self._load_blocks(self.opt_state["nu"], out["opt"]["nu"])
        self.opt_state["step"].copy_(torch.as_tensor(out["opt"]["step"]))
        self.pipeline = PipelineState(seed=meta["pipeline_seed"],
                                      step=meta["pipeline_step"])
        return True

    def restore_reference(self, directory: str, step: Optional[int] = None) -> bool:
        """Resume from the reference ``Trainer``'s checkpoint in ``directory``
        (:func:`read_reference_checkpoint`)."""
        got = read_reference_checkpoint(directory, self.cfg, self.device, step)
        if got is None:
            return False
        params, opt_state, meta = got
        self._load_blocks(self.params, params)
        self._load_blocks(self.opt_state["mu"], opt_state["mu"])
        self._load_blocks(self.opt_state["nu"], opt_state["nu"])
        self.opt_state["step"].copy_(opt_state["step"])
        self.pipeline = PipelineState(seed=meta["pipeline_seed"],
                                      step=meta["pipeline_step"])
        return True

    def save(self, step: int):
        """Checkpoint ``step``; returns the trees written (``params`` and
        ``opt``, each leaf whole: :meth:`_full_tree`) on rank 0, and None on
        the others, which take part in the gather."""
        meta = {"pipeline_seed": self.pipeline.seed, "pipeline_step": self.pipeline.step}
        # every leaf gathered to rank 0, which writes the one-rank format
        params = self._full_tree(self.params)
        opt = {"mu": self._full_tree(self.opt_state["mu"]),
               "nu": self._full_tree(self.opt_state["nu"]),
               "step": self.opt_state["step"]}
        if self.mesh.rank != 0:
            return None
        trees = {"params": params, "opt": opt}
        self.ckpt.save(step, trees, meta=meta)
        return trees

    # -- main loop ----------------------------------------------------------

    def step(self, batch: dict) -> dict:
        """One step on the global ``batch`` (this rank takes its data rank's
        rows); returns the metrics as floats."""
        batch = local_rows(batch, self.mesh)
        self.params, self.opt_state, metrics = self._step_fn(
            self.params, self.opt_state, batch)
        return {k: float(v) for k, v in metrics.items()}

    def run(self, steps: Optional[int] = None) -> list[dict]:
        steps = steps or self.tcfg.steps
        start = int(self.opt_state["step"])
        for i in range(start, steps):
            batch = make_inputs(self.pipeline, self.cfg, self.shape, self.device)
            t0 = time.perf_counter()
            metrics = self.step(batch)
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            self.pipeline = advance(self.pipeline)
            metrics["step"] = i
            metrics["time_s"] = dt
            self.metrics_log.append(metrics)
            if self.tcfg.ckpt_every and (i + 1) % self.tcfg.ckpt_every == 0:
                self.save(i + 1)
            if (self.tcfg.rebalance_every and self.cfg.moe is not None
                    and (i + 1) % self.tcfg.rebalance_every == 0):
                self.refresh_expert_placement(local_rows(batch, self.mesh))
        self.ckpt.wait()
        return self.metrics_log

    # -- the paper's technique: dynamic load balancing for MoE --------------

    def refresh_expert_placement(self, batch) -> np.ndarray:
        """Layer 0's expert loads over the global batch (``batch`` is this
        rank's rows; the counts are summed over the batch axes).  With more
        than one model rank, ``expert_assignment`` becomes the cost-model
        placement's expert permutation, as in the reference; nothing applies
        it yet."""
        spec = dict(zip((n for n, _ in shd.flat_names(self.params)), self.specs))["embed"]
        embed = shd.gather_full(self.params["embed"], spec, self.mesh)
        counts = probe_expert_load({"embed": embed, "layers": self.params["layers"][:1]},
                                   batch, self.cfg)
        axes = shd.batch_axes(self.mesh)
        counts = self.mesh.all_reduce_sum(
            torch.from_numpy(counts).to(self.device), axes).cpu().numpy()
        ranks = self.mesh.shape.get("model", 1)
        if ranks > 1:
            coact = np.zeros((self.cfg.moe.num_experts,) * 2)
            assign = moe_mod.expert_placement(counts, coact, ranks)
            self.expert_assignment = moe_mod.placement_permutation(assign, ranks)
        return counts

