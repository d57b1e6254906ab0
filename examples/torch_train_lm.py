"""End-to-end training driver on the PyTorch port: train a small LM.

Presets:
  tiny  (~6M params,  default) — a full 300-step training on the CPU in
         minutes, with checkpointing every 100 steps and restart support.
  100m  (~100M params)         — the 'real' small-model config; same code
         path, sized for a single accelerator.
  Any --arch from the registry can be trained at its smoke-reduced size.

Runs on the CUDA card unless ``--device cpu``.

Run:  python examples/torch_train_lm.py --steps 300
      python examples/torch_train_lm.py --preset 100m --steps 200
      python examples/torch_train_lm.py --arch mamba2-1.3b --steps 20 --device cpu
"""
import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.models.config import ModelConfig, ShapeConfig  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train.loop import Trainer, TrainerConfig  # noqa: E402

PRESETS = {
    "tiny": ModelConfig(name="tiny-lm", family="dense", num_layers=4,
                        d_model=256, num_heads=4, num_kv_heads=2, d_ff=640,
                        vocab=2048, head_dim=64),
    "100m": ModelConfig(name="lm-100m", family="dense", num_layers=12,
                        d_model=768, num_heads=12, num_kv_heads=4, d_ff=2048,
                        vocab=32_000, head_dim=64),
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="tiny", choices=list(PRESETS))
    ap.add_argument("--arch", default=None, help="registry arch (smoke size)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: repro_torch_train_lm in the "
                         "temporary directory)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    if args.arch:
        from repro_torch.configs.registry import get_smoke_config
        cfg = get_smoke_config(args.arch)
    else:
        cfg = PRESETS[args.preset]
    print(f"model: {cfg.name}  params ~ {cfg.param_count/1e6:.1f}M")

    shape = ShapeConfig("example", "train", args.seq_len, args.batch)
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")
    tcfg = TrainerConfig(steps=args.steps, ckpt_every=100, ckpt_dir=ckpt_dir, log_every=20)
    opt = AdamWConfig(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(args.steps // 20, 1))
    tr = Trainer(cfg, shape, opt, tcfg, device=args.device)
    if args.resume and tr.try_restore():
        print(f"resumed from step {int(tr.opt_state['step'])}")

    log = tr.run()
    for m in log:
        if m["step"] % 20 == 0 or m["step"] == args.steps - 1:
            print(f"step {m['step']:4d}  loss {m['loss']:.4f}  "
                  f"gnorm {m['grad_norm']:.3f}  lr {m['lr']:.2e}  "
                  f"{m['time_s']*1e3:.0f} ms")
    if len(tr.step_times) > 2:
        print(f"tokens/s (steady state, {tr.device.type}): "
              f"{args.batch * args.seq_len / min(tr.step_times[2:]):,.0f}")
    print("OK")


if __name__ == "__main__":
    main()
