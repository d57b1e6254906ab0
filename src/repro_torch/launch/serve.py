"""Serving launcher: batched prefill and greedy decode on one card.

    python -m repro_torch.launch.serve --arch yi-6b            # full width, CUDA
    python -m repro_torch.launch.serve --arch mamba2-1.3b --local    # smoke config
    python -m repro_torch.launch.serve --arch granite-moe-1b-a400m --local --device cpu

Any LM architecture of the registry (``registry.lm_archs()``): dense, moe,
hybrid, ssm, audio, vlm (a vlm serves text only here, as ``step_all``
does).  Weights are random, drawn from a generator seeded with 0.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs.backend import resolve_device
from ..configs.registry import canonical, get_config, get_smoke_config, lm_archs
from ..models.transformer import init_params
from ..serve.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--local", action="store_true",
                    help="the arch's smoke-reduced config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if canonical(args.arch) not in lm_archs():
        ap.error(f"--arch {args.arch!r} is not a language model of the registry "
                 f"({', '.join(lm_archs())})")

    cfg = get_smoke_config(args.arch) if args.local else get_config(args.arch)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev if dev.type == "cuda" else "cpu")
    gen.manual_seed(0)
    params = init_params(cfg, gen, dev)
    engine = ServeEngine(params, cfg, batch_slots=args.batch,
                         max_len=args.prompt_len + args.new + 8, device=dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab,
                           (args.batch, args.prompt_len)).astype(np.int32)
    out = engine.step_all(prompts, args.new)
    print(f"[serve] generated {out.shape} tokens; first: {out[0][:8].tolist()}")
    return out


if __name__ == "__main__":
    main()
