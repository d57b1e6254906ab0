"""Training loop on one card: the step, fault tolerance, expert-load probing.

The reference's ``train/loop.py`` without a mesh:

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
  load that the reference's expert placement balances; on one card there
  is nothing to place.

A ``mesh`` (sharded training over ranks) is not taken yet.
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

from ..checkpoint.manager import CheckpointManager
from ..configs.backend import resolve_device
from ..data.pipeline import PipelineState, advance, make_inputs
from ..models.config import ModelConfig, ShapeConfig
from ..models.convert import params_from_jax
from ..models.layers import rms_norm
from ..models.transformer import forward, init_params, lm_loss, param_tensors
from ..optim.adamw import AdamWConfig, apply_updates, init_state


def make_loss_fn(cfg: ModelConfig, *, q_chunk: int = 512, loss_chunk: int = 256,
                 remat: bool = True):
    def loss_fn(params, batch):
        h, _ = forward(params, batch["tokens"], cfg,
                       patch_embeds=batch.get("patch_embeds"),
                       q_chunk=q_chunk, remat=remat)
        if cfg.num_patches:
            h = h[:, cfg.num_patches:]      # loss over text positions only
        return lm_loss(params, h, batch["labels"], cfg, chunk=loss_chunk)
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


def value_and_grad(loss_fn, params, batch):
    """(loss, gradients in :func:`param_tensors`' order): each gradient in its
    parameter's dtype, zero for a parameter the loss does not reach."""
    live = [t.detach().requires_grad_() for t in param_tensors(params)]
    with torch.enable_grad():
        loss = loss_fn(unflatten(params, live), batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    return loss.detach(), [torch.zeros_like(t) if g is None else g
                           for t, g in zip(live, grads)]


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    num_microbatches: int = 1, **loss_kw):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  ``num_microbatches > 1`` is gradient accumulation: the
    batch splits on dim 0, so live activations scale 1/n."""
    loss_fn = make_loss_fn(cfg, **loss_kw)
    n = num_microbatches

    def train_step(params, opt_state, batch):
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
                                                   opt_state, opt_cfg)
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


def _load_into(tree, arrays) -> None:
    """Copy restored host arrays (``tree``'s structure) into ``tree``'s
    tensors, rounded to each tensor's dtype."""
    if isinstance(tree, torch.Tensor):
        tree.copy_(torch.from_numpy(np.asarray(arrays)))
        return
    for k, t in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        _load_into(t, arrays[k])


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
    Weights are random, from a generator seeded with ``tcfg.seed``."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 opt_cfg: Optional[AdamWConfig] = None,
                 tcfg: Optional[TrainerConfig] = None, device=None,
                 remat: bool = True, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "Trainer takes no mesh yet: training sharded over ranks is item "
                "4c of the port's roadmap; train on one device (mesh=None)")
        self.cfg = cfg
        self.shape = shape
        self.tcfg = tcfg or TrainerConfig()
        self.opt_cfg = opt_cfg or AdamWConfig(total_steps=self.tcfg.steps)
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(self.tcfg.ckpt_dir, keep=self.tcfg.keep)
        self.pipeline = PipelineState(seed=self.tcfg.seed, step=0)
        self.step_times: list[float] = []
        self.expert_assignment: Optional[np.ndarray] = None

        gen = torch.Generator(device=self.device if self.device.type == "cuda" else "cpu")
        gen.manual_seed(self.tcfg.seed)
        self.params = init_params(cfg, gen, self.device)
        self.opt_state = init_state(self.params, self.opt_cfg)
        self._step_fn = make_train_step(cfg, self.opt_cfg, remat=remat)
        self.metrics_log: list[dict] = []

    # -- fault tolerance ----------------------------------------------------

    def try_restore(self) -> bool:
        out, meta = self.ckpt.restore({"params": self.params, "opt": self.opt_state})
        if out is None:
            return False
        _load_into(self.params, out["params"])
        _load_into(self.opt_state, out["opt"])
        self.pipeline = PipelineState(seed=meta["pipeline_seed"],
                                      step=meta["pipeline_step"])
        return True

    def restore_reference(self, directory: str, step: Optional[int] = None) -> bool:
        """Resume from the reference ``Trainer``'s checkpoint in ``directory``
        (:func:`read_reference_checkpoint`)."""
        got = read_reference_checkpoint(directory, self.cfg, self.device, step)
        if got is None:
            return False
        self.params, self.opt_state, meta = got
        self.pipeline = PipelineState(seed=meta["pipeline_seed"],
                                      step=meta["pipeline_step"])
        return True

    def save(self, step: int):
        self.ckpt.save(step, {"params": self.params, "opt": self.opt_state},
                       meta={"pipeline_seed": self.pipeline.seed,
                             "pipeline_step": self.pipeline.step})

    # -- main loop ----------------------------------------------------------

    def run(self, steps: Optional[int] = None) -> list[dict]:
        steps = steps or self.tcfg.steps
        start = int(self.opt_state["step"])
        for i in range(start, steps):
            batch = make_inputs(self.pipeline, self.cfg, self.shape, self.device)
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
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
                self.refresh_expert_placement(batch)
        self.ckpt.wait()
        return self.metrics_log

    # -- the paper's technique: dynamic load balancing for MoE --------------

    def refresh_expert_placement(self, batch) -> np.ndarray:
        """Layer 0's expert loads.  On one card there is one rank, so no
        placement is assigned (``expert_assignment`` stays None)."""
        return probe_expert_load(self.params, batch, self.cfg)
