"""Training launcher: the fault-tolerant loop on one card, or on the
production grid of ranks.

    python -m repro_torch.launch.train --arch yi-6b --local --steps 20
    python -m repro_torch.launch.train --arch mamba2-1.3b --local --device cpu --steps 4
    torchrun --nnodes 32 --nproc-per-node 8 ... -m repro_torch.launch.train \
        --arch yi-6b --shape train_4k [--multi-pod] --ckpt-dir /shared/ckpt

Builds the arch's model (random weights from a generator seeded with 0),
restores the latest checkpoint in ``--ckpt-dir`` if there is one, and runs
the loop (atomic async checkpoints with the pipeline state, expert-load
probes for MoE archs).  ``--local`` takes the arch's smoke config at
``ShapeConfig("local", "train", 128, 4)``; without it the full config at
``--shape``.

In a world started by ``torchrun`` (``WORLD_SIZE`` set) and without
``--local``, every process joins the default group (NCCL on the cards,
gloo with ``--device cpu``; each process on ``cuda:LOCAL_RANK``), builds
``make_production_mesh(multi_pod=--multi-pod)`` (``(16, 16)`` on
``("data", "model")``, 256 ranks, or ``(2, 16, 16)`` on ``("pod", "data",
"model")``, 512) and runs ``Trainer(mesh=grid)``: each rank its blocks of
the parameters and the AdamW state, checkpoints gathered to rank 0.
Alone, the launcher runs on one card (the CUDA card unless ``--device
cpu``), and ``--multi-pod`` is refused: it needs the 512 ranks of a
``torchrun`` world.  ``launch/dryrun.py`` predicts what a rank of either
grid holds.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch
import torch.distributed as dist

from ..configs.registry import canonical, get_config, get_smoke_config, lm_archs
from ..models.config import SHAPES, ShapeConfig
from ..optim.adamw import AdamWConfig
from ..train.loop import Trainer, TrainerConfig
from .mesh import make_production_mesh


def production_grid(multi_pod: bool, device=None):
    """Join the ``torchrun`` world (``env://``) and build this process's
    production grid: NCCL on ``cuda:LOCAL_RANK``, gloo with ``device="cpu"``."""
    if device == "cpu":
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("gloo" if dev.type == "cpu" else "nccl")
    return make_production_mesh(multi_pod=multi_pod, device=dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k", choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (2, 16, 16) grid of 512 ranks (a torchrun world); "
                         "without it (16, 16), 256 ranks")
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

    grid = None
    if "WORLD_SIZE" in os.environ and not args.local:
        grid = production_grid(args.multi_pod, args.device)
    elif args.multi_pod:
        ap.error("--multi-pod trains on the (2, 16, 16) grid of 512 ranks: start "
                 "512 processes with torchrun, without --local (this process is "
                 + ("--local)" if "WORLD_SIZE" in os.environ else "alone: WORLD_SIZE "
                    "is not set)"))
    if args.local:
        cfg = get_smoke_config(args.arch)
        shape = ShapeConfig("local", "train", 128, 4)
    else:
        cfg = get_config(args.arch)
        shape = SHAPES[args.shape]
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    tcfg = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every, ckpt_dir=ckpt_dir,
                         rebalance_every=args.rebalance_every)
    tr = Trainer(cfg, shape, AdamWConfig(total_steps=args.steps), tcfg,
                 device=args.device if grid is None else None, mesh=grid)
    if tr.try_restore():
        print(f"[train] resumed at step {int(tr.opt_state['step'])}")
    log = tr.run()
    print(f"[train] done: {len(log)} steps on {tr.device.type}, final loss "
          f"{log[-1]['loss']:.4f}" if log else "[train] nothing to do")
    return log


if __name__ == "__main__":
    main()
