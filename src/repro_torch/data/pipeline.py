"""Deterministic synthetic data pipeline (checkpointable).

The reference's ``data/pipeline.py`` under the same contract: a batch is a
function of ``(seed, step)`` alone, so a restart resumes the stream from
the pipeline state in a checkpoint, with no data files.  Tokens lie in
``[0, vocab)``; labels are the tokens shifted by one, the last -1 (masked).

The reference draws with ``jax.random``; the port draws from a CPU
``torch.Generator`` seeded with a fixed 64-bit mix of ``(seed, step,
stream)`` and then moves the batch to the device, so the same state gives
the same batch on the CPU and on the card.  The two packages' streams
differ: the tests feed one batch to both.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.backend import resolve_device
from ..models.config import ModelConfig, ShapeConfig

_M64 = (1 << 64) - 1


@dataclasses.dataclass
class PipelineState:
    seed: int
    step: int


def _generator(seed: int, step: int, stream: int) -> torch.Generator:
    """A CPU generator for one draw: splitmix64's finalizer over the three
    numbers packed into 64 bits (distinct for steps and seeds below 2^28)."""
    x = ((seed & 0xFFFFFFF) << 36 | (stream & 0xFF) << 28 | (step & 0xFFFFFFF)) & _M64
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    g = torch.Generator(device="cpu")
    g.manual_seed(x ^ (x >> 31))
    return g


def make_batch(state: PipelineState, cfg: ModelConfig, batch: int, seq_len: int,
               device=None):
    """Global batch for ``state.step``: int64 tokens (B, T) and labels (B, T)
    on ``device`` (the card by default).

    Labels are next-token shifted; the final position is masked (-1).
    """
    dev = resolve_device(device)
    tokens = torch.randint(0, cfg.vocab, (batch, seq_len),
                           generator=_generator(state.seed, state.step, 0))
    labels = torch.cat([tokens[:, 1:], torch.full((batch, 1), -1, dtype=tokens.dtype)],
                       dim=1)
    return tokens.to(dev), labels.to(dev)


def make_inputs(state: PipelineState, cfg: ModelConfig, shape: ShapeConfig,
                device=None) -> dict:
    """Family-aware inputs: ``tokens`` and ``labels``, and for a vlm f32
    ``patch_embeds`` (B, num_patches, patch_dim) before ``seq_len -
    num_patches`` text positions."""
    dev = resolve_device(device)
    b, t = shape.global_batch, shape.seq_len
    if cfg.num_patches:
        tokens, labels = make_batch(state, cfg, b, t - cfg.num_patches, dev)
        patches = torch.randn((b, cfg.num_patches, cfg.patch_dim),
                              generator=_generator(state.seed, state.step, 1))
        return {"tokens": tokens, "labels": labels, "patch_embeds": patches.to(dev)}
    tokens, labels = make_batch(state, cfg, b, t, dev)
    return {"tokens": tokens, "labels": labels}


def advance(state: PipelineState) -> PipelineState:
    return PipelineState(seed=state.seed, step=state.step + 1)
