"""The one traffic generator: every input of a cell, made from its seed.

A traffic mix is a JSON file under ``fmmbench/traffic/``; this module
reads its parameters and makes, on the host, what the program is handed:

* ``lattice``: the Lamb-Oseen vortex lattice of PetFMM section 7 (a
  frozen copy of ``src/repro_torch/core/vortex.py:lamb_oseen_particles``
  at commit 5f3f6255), its centre moved by up to ``centre_jitter_boxes``
  leaf boxes and every point by up to ``point_jitter`` of the spacing,
  both drawn from the seed.  Positions are rounded to float32 values, so
  the program's float32 tree holds them exactly and the reference sees the
  same points.  Every seed gives the same counts and sizes.
* ``probes``: a cell-centred ``side x side`` grid of passive targets.
* ``strengths``: one strength vector an evaluation, drawn on the card from
  ``(seed, evaluation)`` by :func:`evaluation_strengths`.

Nothing here imports the program.
"""
from __future__ import annotations

import numpy as np
import torch


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for the stream ``path`` of ``seed`` (any whole number)."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF, *map(int, path)]
    return int(np.random.SeedSequence(words).generate_state(2, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, *path: int) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *path))


def lattice(config: dict, params: dict, seed: int) -> dict:
    """The seed's vortex lattice: positions (N, 2) float64 holding float32
    values, circulations (N,) float64, the lattice's sigma and the vortex
    centre.  The unjittered lattice is ``lamb_oseen_particles``'s."""
    g = rng(seed, 1)
    m = int(config["n_side"])
    sigma0 = float(config.get("lattice_sigma", config.get("sigma")) or 0.0)
    h = sigma0 * float(config["spacing_ratio"])
    span = (m - 1) * h
    extent = float(config["extent"])
    scale = 1.0
    if span > extent:               # keep the lattice inside the unit domain
        scale = extent / span
        h *= scale
        span = extent
    box = 2.0 ** -int(config["level"])
    cx, cy = 0.5 + g.uniform(-1.0, 1.0, 2) * float(params["centre_jitter_boxes"]) * box
    xs = cx - span / 2 + h * np.arange(m)
    ys = cy - span / 2 + h * np.arange(m)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    pos = np.stack([X.ravel(), Y.ravel()], axis=1)
    pos += g.uniform(-1.0, 1.0, pos.shape) * float(params["point_jitter"]) * h
    pos = pos.astype(np.float32).astype(np.float64)
    r = np.hypot(pos[:, 0] - cx, pos[:, 1] - cy)
    gamma0, nu, t = (float(config.get(k, d)) for k, d in
                     (("gamma0", 1.0), ("nu", 5e-4), ("t0", 4.0)))
    omega = gamma0 / (4.0 * np.pi * nu * t) * np.exp(-r * r / (4.0 * nu * t))
    if len(pos) != int(config["num_particles"]):
        raise ValueError(f"lattice of {len(pos)} points, the configuration "
                         f"says {config['num_particles']}")
    return {"positions": pos, "gamma": omega * h * h, "sigma": sigma0 * scale,
            "centre": (float(cx), float(cy)), "spacing": h}


def probes(params: dict) -> np.ndarray:
    """The cell-centred probe grid, (side^2, 2) float64 holding float32
    values."""
    side = int(params["side"])
    ticks = (np.arange(side) + 0.5) / side
    return np.stack(np.meshgrid(ticks, ticks), axis=-1).reshape(-1, 2)


def evaluation_strengths(params: dict, base: torch.Tensor, seed: int,
                         evaluation: int, generator: torch.Generator) -> torch.Tensor:
    """Evaluation ``evaluation``'s strengths, (N,) float64 on ``base``'s
    device: uniform in [low, high), times ``base`` where ``times_base``.
    ``generator`` lives on that device and is re-seeded here, so the same
    ``(seed, evaluation)`` gives the same vector in the window and in the
    check."""
    if params.get("kind") != "uniform":
        raise ValueError(f"unknown strengths kind {params.get('kind')!r}")
    generator.manual_seed(sub_seed(seed, 2, evaluation))
    u = torch.rand(base.shape, generator=generator, device=base.device,
                   dtype=torch.float32).to(torch.float64)
    s = float(params["low"]) + (float(params["high"]) - float(params["low"])) * u
    return s * base if params.get("times_base") else s
