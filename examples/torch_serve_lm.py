"""Serving example: batched prefill + greedy decode with a persistent cache,
on the PyTorch port.

Exercises the decode path of any family (the ring-buffer window cache of a
hybrid, the SSM and RG-LRU states, MoE routing) at the arch's smoke config,
random weights from a seeded generator.  Runs on the CUDA card unless
``--device cpu``.

Run:  python examples/torch_serve_lm.py [--arch yi-6b] [--new 16] [--device cpu]
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.backend import resolve_device  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev if dev.type == "cuda" else "cpu")
    gen.manual_seed(0)
    params = init_params(cfg, gen, dev)
    engine = ServeEngine(params, cfg, batch_slots=args.batch,
                         max_len=args.prompt_len + args.new + 8, device=dev)

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.perf_counter()
    out = engine.step_all(prompts, args.new)
    wall = time.perf_counter() - t0
    assert out.shape == (args.batch, args.new)
    print(f"arch={cfg.name} family={cfg.family} batch={args.batch} "
          f"prompt={args.prompt_len} new={args.new} device={dev.type}")
    print(f"generated (first seq): {out[0].tolist()}")
    print(f"wall {wall:.2f}s -> {args.batch * args.new / wall:.1f} tok/s "
          f"({dev.type}, first call)")
    print("OK")


if __name__ == "__main__":
    main()
