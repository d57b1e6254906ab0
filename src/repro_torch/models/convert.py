"""Carry the reference's parameters across to the port.

``params_from_jax`` takes the pytree of the reference's ``init_params`` with
its leaves as numpy arrays (``jax.tree.map(np.asarray, params)``) and
returns the port's parameter dict (``transformer.init_params``'s layout),
so that both packages compute the same function.

The reference scans its layers in groups, ``params["groups"]``, one per
``(pattern, reps)`` of :func:`scan_groups`: a group with ``reps > 1`` holds
one tree per pattern slot whose leaves carry the repeats on a leading axis;
a group with ``reps == 1`` has no such axis.  Layer ``li + r * len(pattern)
+ j`` is repeat ``r`` of slot ``j``, ``li`` the group's first layer.

Each weight is stored in the dtype in which the reference's ``forward``
reads it: the reference keeps f32 masters and casts them to ``cfg.dtype``
at every use, so storing ``cfg.dtype`` (round to nearest even, as the
cast) gives the same bits.  ``lm_head``, ``embed`` when tied, and the
weights of ``transformer.F32_WEIGHTS`` stay f32, because they are read in
f32.

``keep_dtype=True`` keeps each array's own dtype (f32, or bf16) instead:
an AdamW state's ``mu`` and ``nu``, which mirror the parameters' structure
but are kept in the optimizer's state dtype, not in the weights'.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.backend import resolve_device
from .config import ModelConfig
from .transformer import F32_WEIGHTS, compute_dtype, layer_kinds


def scan_groups(kinds: list[str]) -> list[tuple[list[str], int]]:
    """The reference's grouping of layers into ``(pattern, reps)``: a
    uniform stack is one group; a periodic one is its pattern repeated and
    the rest as single layers; anything else single layers."""
    if len(set(kinds)) == 1:
        return [([kinds[0]], len(kinds))]
    for plen in range(1, len(kinds) + 1):
        pat = kinds[:plen]
        reps = len(kinds) // plen
        if reps > 1 and pat * reps == kinds[:plen * reps]:
            return [(pat, reps)] + [([k], 1) for k in kinds[plen * reps:]]
    return [([k], 1) for k in kinds]


def _own_dtype(a) -> torch.dtype:
    name = np.asarray(a).dtype.name
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"an optimizer state array is {name}, not float32 or bfloat16")
    return getattr(torch, name)


def params_from_jax(params_np: dict, cfg: ModelConfig, device=None,
                    keep_dtype: bool = False) -> dict:
    dev = resolve_device(device)
    wdt = compute_dtype(cfg)

    def tensor(a, dtype):
        return torch.tensor(np.asarray(a, dtype=np.float32),
                            dtype=_own_dtype(a) if keep_dtype else dtype, device=dev)

    def tree(t, r=None, name=None):
        if isinstance(t, dict):
            return {k: tree(sub, r, k) for k, sub in t.items()}
        return tensor(t if r is None else t[r],
                      torch.float32 if name in F32_WEIGHTS else wdt)

    layers = []
    for (pat, reps), gp in zip(scan_groups(layer_kinds(cfg)), params_np["groups"]):
        for r in range(reps):
            layers += [tree(gp[j], None if reps == 1 else r) for j in range(len(pat))]
    params = {
        "embed": tensor(params_np["embed"],
                        torch.float32 if cfg.tie_embeddings else wdt),
        "final_norm": tensor(params_np["final_norm"], wdt),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = tensor(params_np["lm_head"], torch.float32)
    if cfg.num_patches:
        params["patch_proj"] = tensor(params_np["patch_proj"], wdt)
    return params
