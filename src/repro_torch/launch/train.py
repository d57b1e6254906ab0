"""Training launcher: the fault-tolerant loop on one card.

    python -m repro_torch.launch.train --arch yi-6b --local --steps 20
    python -m repro_torch.launch.train --arch mamba2-1.3b --local --device cpu --steps 4

Builds the arch's model (random weights from a generator seeded with 0),
restores the latest checkpoint in ``--ckpt-dir`` if there is one, and runs
the loop (atomic async checkpoints with the pipeline state, expert-load
probes for MoE archs).  ``--local`` takes the arch's smoke config at
``ShapeConfig("local", "train", 128, 4)``; without it the full config at
``--shape``.  Runs on the CUDA card unless ``--device cpu``.  The
reference's multi-host launch (``make_production_mesh``, ``--multi-pod``)
is not ported: it waits for the port's training over ranks.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from ..configs.registry import canonical, get_config, get_smoke_config, lm_archs
from ..models.config import SHAPES, ShapeConfig
from ..optim.adamw import AdamWConfig
from ..train.loop import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k", choices=sorted(SHAPES))
    ap.add_argument("--local", action="store_true",
                    help="the arch's smoke-reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: repro_torch_ckpt in the "
                         "temporary directory)")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--rebalance-every", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if canonical(args.arch) not in lm_archs():
        ap.error(f"--arch {args.arch!r} is not a language model of the registry "
                 f"({', '.join(lm_archs())})")

    if args.local:
        cfg = get_smoke_config(args.arch)
        shape = ShapeConfig("local", "train", 128, 4)
    else:
        cfg = get_config(args.arch)
        shape = SHAPES[args.shape]
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    tcfg = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every, ckpt_dir=ckpt_dir,
                         rebalance_every=args.rebalance_every)
    tr = Trainer(cfg, shape, AdamWConfig(total_steps=args.steps), tcfg, device=args.device)
    if tr.try_restore():
        print(f"[train] resumed at step {int(tr.opt_state['step'])}")
    log = tr.run()
    print(f"[train] done: {len(log)} steps on {tr.device.type}, final loss "
          f"{log[-1]['loss']:.4f}" if log else "[train] nothing to do")
    return log


if __name__ == "__main__":
    main()
