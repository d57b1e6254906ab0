"""Carry the reference's parameters across to the port.

``params_from_jax`` takes the pytree of the reference's ``init_params`` with
its leaves as numpy arrays (``jax.tree.map(np.asarray, params)``) and
returns the port's parameter dict (``transformer.init_params``'s layout),
so that both packages compute the same function.  The reference scans its
dense stack as one group whose leaves carry the layers on a leading axis
(no axis for a single layer).

Each weight is stored in the dtype in which the reference's ``forward``
reads it: the reference keeps f32 masters and casts them to ``cfg.dtype``
at every use, so storing ``cfg.dtype`` (round to nearest even, as the
cast) gives the same bits.  ``lm_head``, and ``embed`` when tied, stay
f32, because ``unembed`` reads them in f32.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.backend import resolve_device
from .config import ModelConfig
from .transformer import compute_dtype, layer_kinds


def params_from_jax(params_np: dict, cfg: ModelConfig, device=None) -> dict:
    dev = resolve_device(device)
    wdt = compute_dtype(cfg)
    L = len(layer_kinds(cfg))          # raises for a family not ported

    def tensor(a, dtype):
        return torch.tensor(np.asarray(a, dtype=np.float32), dtype=dtype, device=dev)

    def layer(tree, i):
        if isinstance(tree, dict):
            return {name: layer(sub, i) for name, sub in tree.items()}
        return tensor(tree[i] if L > 1 else tree, wdt)

    [[stack]] = params_np["groups"]
    params = {
        "embed": tensor(params_np["embed"],
                        torch.float32 if cfg.tie_embeddings else wdt),
        "final_norm": tensor(params_np["final_norm"], wdt),
        "layers": [layer(stack, i) for i in range(L)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = tensor(params_np["lm_head"], torch.float32)
    return params
