#!/usr/bin/env python3
"""Time the serving prefill of this checkout against other checkouts'.

Each architecture (``--arch``, repeatable; recurrentgemma-2b and
mamba2-1.3b by default) at its full config in bf16, random weights from a
generator seeded with 0, prefills 4 prompts of 2048 tokens through
``ServeEngine.prefill_fn`` (a decode cache of 2056 positions): two warm
calls, then ``--iters`` calls each timed with CUDA events.  Every checkout
(``--other``, repeatable, e.g. the parent unpacked by ``git archive`` under
``build/``) runs in a process of its own with its own ``src/`` on the
path, in turns: the others, this one twice, the others in reverse order.
One JSON line a turn, the card's name and power limit first.  Needs a CUDA
card:

    python3 tools/serve_prefill.py --other build/parent
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import turns

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["recurrentgemma-2b", "mamba2-1.3b"]


def worker(root: str, archs: list[str], iters: int) -> dict:
    sys.path.insert(0, str(Path(root).resolve() / "src"))
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_cache, init_params
    from repro_torch.serve.engine import ServeEngine

    dev = torch.device("cuda")
    out = {"checkout": root}
    for arch in archs:
        cfg = get_config(arch)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = init_params(cfg, gen, dev)
        engine = ServeEngine(params, cfg, batch_slots=4, max_len=2056, device=dev)
        tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (4, 2048)),
                                 device=dev).long()
        caches = init_cache(cfg, 4, 2056, device=dev)
        ms = []
        for i in range(2 + iters):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            engine.prefill_fn(params, tokens, caches)
            b.record()
            torch.cuda.synchronize()
            if i >= 2:
                ms.append(a.elapsed_time(b))
        out[arch] = {"median_ms": sorted(ms)[len(ms) // 2], "ms": ms}
        del params, engine, caches
        torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", action="append", help=f"default: {', '.join(ARCHS)}")
    ap.add_argument("--other", action="append", default=[],
                    help="another checkout's root (repeatable)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    archs = args.arch or ARCHS
    if args.worker:
        print(json.dumps(worker(args.worker, archs, args.iters)), flush=True)
        return
    print(turns.card(), flush=True)
    for root in turns.order(args.other, str(ROOT)):
        cmd = [sys.executable, __file__, "--worker", root, "--iters", str(args.iters)]
        for arch in archs:
            cmd += ["--arch", arch]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if r.returncode:
            sys.exit(f"{root}: exit {r.returncode}\n{r.stderr[-4000:]}")
        print(r.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
