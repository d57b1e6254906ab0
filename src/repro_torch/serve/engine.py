"""Serving: prefill and decode steps and a batched greedy-decode engine.

The reference's ``serve/engine.py``, every family of its registry, on one
card or on a grid of ranks.  ``make_serve_fns`` returns plain callables
(PyTorch runs eagerly; there is no ``jit``), and both steps run under
``torch.inference_mode()``.  Prefill attention runs a flash-attention
kernel on the card (``models.layers.attention_core``); decode attends over
the bf16 KV cache, and recurrent layers step their states, in plain
PyTorch.

With ``mesh`` (a ``launch/mesh.py:GridMesh``) the parameters and the
caches are this rank's blocks (``serve/grid.py``: ``param_blocks``,
``init_cache_blocks``), the tokens and the logits the whole batch on every
rank; ``mesh=None`` is the one-card path.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..configs.backend import check_on, resolve_device
from ..models.config import ModelConfig
from ..models.transformer import forward, init_cache, param_tensors, unembed
from ..train.loop import grid_specs
from . import grid as sg


def _grid_step(params, tokens, caches, cfg, mesh, **kw):
    by_name = grid_specs(cfg, mesh)
    B = tokens.shape[0]
    pe = kw.pop("patch_embeds", None)
    h, caches = sg.grid_forward(params, sg.local_rows(tokens, mesh), cfg, mesh, by_name,
                                batch=B, caches=caches,
                                patch_embeds=None if pe is None else sg.local_rows(pe, mesh),
                                **kw)
    logits = sg.grid_unembed(params, h[:, -1:], cfg, mesh, by_name, sg.rows_split(mesh, B))
    return logits[:, 0], caches


@torch.inference_mode()
def prefill_step(params, tokens, caches, cfg: ModelConfig, mesh=None,
                 patch_embeds=None, q_chunk: int = 512):
    """Process the prompt, fill the caches.  Returns (last_logits, caches).

    A vlm's ``patch_embeds`` (B, P, patch_dim) go before the text tokens.
    On a grid ``mesh`` the parameters and caches are this rank's blocks and
    ``tokens`` the whole batch; the logits are the whole batch's."""
    if mesh is not None:
        return _grid_step(params, tokens, caches, cfg, mesh, patch_embeds=patch_embeds,
                          q_chunk=q_chunk)
    h, caches = forward(params, tokens, cfg, patch_embeds=patch_embeds,
                        caches=caches, q_chunk=q_chunk)
    logits = unembed(params, h[:, -1:], cfg)[:, 0]
    return logits, caches


@torch.inference_mode()
def decode_step(params, token, pos: int, caches, cfg: ModelConfig, mesh=None):
    """One token for every sequence.  token: (B, 1); pos: the position,
    uniform across the batch (slot-aligned batching).  On a grid as
    :func:`prefill_step`."""
    if mesh is not None:
        return _grid_step(params, token, caches, cfg, mesh, pos_scalar=pos)
    h, caches = forward(params, token, cfg, caches=caches, pos_scalar=pos)
    logits = unembed(params, h, cfg)[:, 0]
    return logits, caches


def make_serve_fns(cfg: ModelConfig, mesh=None, q_chunk: int = 512):
    pre = functools.partial(prefill_step, cfg=cfg, mesh=mesh, q_chunk=q_chunk)
    dec = functools.partial(decode_step, cfg=cfg, mesh=mesh)
    return pre, dec


class ServeEngine:
    """Batched greedy decoding: :meth:`step_all` is the serving API.

    Runs on ``device`` (the CUDA card unless ``device="cpu"``), where the
    parameters must already lie.  With a grid ``mesh`` (every rank builds
    its own engine) it runs on the mesh's device, ``params`` are this
    rank's blocks (``serve/grid.py:param_blocks``) and each call keeps its
    caches as this rank's blocks; every rank returns the whole batch's
    tokens.
    """

    def __init__(self, params, cfg: ModelConfig, batch_slots: int,
                 max_len: int, device=None, mesh=None):
        self.device = resolve_device(device) if mesh is None else mesh.device
        check_on(self.device, *param_tensors(params))
        self.params = params
        self.cfg = cfg
        self.mesh = mesh
        self.batch_slots = batch_slots
        self.max_len = max_len
        self.prefill_fn, self.decode_fn = make_serve_fns(cfg, mesh)

    def init_cache(self, batch: int):
        """Empty caches for ``batch`` sequences (this rank's blocks on a grid)."""
        if self.mesh is None:
            return init_cache(self.cfg, batch, self.max_len, device=self.device)
        return sg.init_cache_blocks(self.cfg, batch, self.max_len, self.mesh)

    def step_all(self, prompts: np.ndarray, max_new: int) -> np.ndarray:
        """Greedy-decode ``max_new`` tokens for a batch of equal-length
        prompts.  Returns (B, max_new) int32, the reference's loop: the
        position is uniform across the batch and ``argmax`` takes the first
        index on ties.  Text only, as the reference's: a vlm's patches
        enter through :func:`prefill_step`."""
        B, T = prompts.shape
        if T + max_new > self.max_len:
            raise ValueError(f"{T} prompt + {max_new} new tokens exceed "
                             f"max_len {self.max_len}")
        with torch.inference_mode():
            tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                                     device=self.device)
            caches = self.init_cache(B)
            logits, caches = self.prefill_fn(self.params, tokens, caches)
            tok = torch.argmax(logits, dim=-1)
            outs = []
            for t in range(max_new):
                outs.append(tok)
                logits, caches = self.decode_fn(self.params, tok[:, None], T + t,
                                                caches)
                tok = torch.argmax(logits, dim=-1)
            return torch.stack(outs, dim=1).to(torch.int32).cpu().numpy()
