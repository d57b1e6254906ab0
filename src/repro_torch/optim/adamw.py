"""AdamW with a cosine schedule, global-norm clipping, and the int8
compression of a gradient with error feedback.

The reference's ``optim/adamw.py`` on one card.  Trees are the port's
parameter dicts (``models/transformer.py``); the state holds ``mu`` and
``nu`` of the parameters' structure and a 0-dim int32 ``step``, all on the
parameters' device, so the schedule, the norm and the clip scale stay
there too (no host sync).  The update keeps the reference's f32 upcasts
and order of operations, and writes its results into the given tensors
(in place, which saves a second copy of the weights and the state at
Yi-6B's size) rounded to each one's dtype.  A weight stored in bf16 is
therefore updated in f32 arithmetic and rounded once a step; there is no
f32 master copy beside it.

On a grid of ranks (``launch/mesh.py:GridMesh``) every tree holds this
rank's blocks (``parallel/sharding.py``).  ``apply_updates(mesh=, specs=)``
then clips by the norm of the global tree, every element counted once, and
updates the blocks elementwise; ``compressed_psum_mean`` is the reference's
int8-compressed mean over one axis, its wire f32 as the reference's is.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..models.transformer import param_tensors
from ..parallel.sharding import counted_once


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    state_dtype: str = "float32"   # "bfloat16" halves the optimizer's memory


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_ratio``; f32 on step's device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) /
                    max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init_state(params, cfg: "AdamWConfig | None" = None) -> dict:
    """Zero ``mu`` and ``nu`` in ``cfg.state_dtype`` (f32 without a config)
    and step 0, on the parameters' device."""
    dt = getattr(torch, cfg.state_dtype) if cfg is not None else torch.float32

    def zeros(tree):
        if isinstance(tree, torch.Tensor):
            return torch.zeros(tree.shape, dtype=dt, device=tree.device)
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        return [zeros(v) for v in tree]
    device = param_tensors(params)[0].device
    return {"mu": zeros(params), "nu": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree, mesh=None, specs=None) -> torch.Tensor:
    """The L2 norm of every element of ``tree``.  On a grid, ``tree`` holds
    this rank's blocks under ``specs`` (one a leaf): a rank adds the squares
    of its blocks, except that a leaf replicated over an axis is added only
    by the ranks at index 0 on it, and the sum over the whole grid is taken,
    so every rank has the same norm."""
    leaves = param_tensors(tree)
    if mesh is None or mesh.size == 1:
        return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                              for x in leaves))
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for x, spec in zip(leaves, specs):
        if counted_once(mesh, spec):
            total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(mesh.all_reduce_sum(total, mesh.axis_names))


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig, mesh=None, specs=None):
    """One AdamW step.  Returns (params, state, metrics): the given
    parameter and state tensors, written in place, and ``grad_norm`` and
    ``lr`` as 0-dim device tensors.  On a grid the trees are this rank's
    blocks under ``specs`` (:func:`global_norm`)."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads, mesh, specs)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(b1, stepf)
    c2 = 1.0 - torch.pow(b2, stepf)
    for p, g, mu, nu in zip(param_tensors(params), param_tensors(grads),
                            param_tensors(state["mu"]), param_tensors(state["nu"])):
        # the reference's expressions, each operation in its order, evaluated
        # into as few f32 buffers as they allow: a tied 655M-row embedding
        # takes 2.6 GB a buffer
        g = g.to(torch.float32) * scale
        m = mu.to(torch.float32) * b1                    # b1 * mu + (1 - b1) * g
        m.add_(g * (1 - b1))
        v = nu.to(torch.float32) * b2                    # b2 * nu + (1 - b2) * g * g
        g = (g * (1 - b2)).mul_(g)
        v.add_(g)
        del g
        mu.copy_(m)
        nu.copy_(v)
        m.div_(c1)                                       # mhat
        v.div_(c2).sqrt_().add_(cfg.eps)                 # sqrt(nhat) + eps
        m.div_(v)
        del v
        p32 = p.to(torch.float32)
        m.add_(p32 * cfg.weight_decay).mul_(lr)          # lr * (... + wd * p)
        p.copy_(p32.sub_(m))                             # p - lr * (...)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# Gradient compression (int8 quantized with error feedback)
# ---------------------------------------------------------------------------


def compress_decompress(g: torch.Tensor, err: torch.Tensor):
    """Quantize g + err to int8 (per-tensor absmax scale) and back.

    Returns (g_hat, new_err): the wire format of a compressed reduction is
    1 byte an element; error feedback keeps the scheme convergent (EF-SGD).
    """
    g32 = g.to(torch.float32) + err
    scale = torch.max(torch.abs(g32)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    g_hat = q.to(torch.float32) * scale
    return g_hat, g32 - g_hat


def compressed_psum_mean(grads, errors, mesh, axis):
    """int8-quantized mean over ``axis`` with error feedback: each leaf of
    ``grads`` plus its ``errors`` leaf through :func:`compress_decompress`,
    then the sum of the f32 ``g_hat`` over ``axis`` divided by its size (the
    reference's ``shard_map`` body, whose wire is f32 too).  Returns the
    mean tree and the new error tree, in ``grads``' structure."""
    n = mesh.shape[axis] if axis in mesh.axis_names else 1

    def walk(g, e):
        if isinstance(g, torch.Tensor):
            gh, ne = compress_decompress(g, e)
            return mesh.all_reduce_sum(gh, (axis,)) / n, ne
        keys = g.keys() if isinstance(g, dict) else range(len(g))
        pairs = {k: walk(g[k], e[k]) for k in keys}
        if isinstance(g, dict):
            return ({k: v[0] for k, v in pairs.items()},
                    {k: v[1] for k, v in pairs.items()})
        return [pairs[k][0] for k in keys], [pairs[k][1] for k in keys]
    return walk(grads, errors)
