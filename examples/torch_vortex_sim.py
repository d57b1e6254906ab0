"""Vortex-method simulation on the PyTorch port (the paper's client
application, §3), on one CUDA card or, with ``--device cpu``, the CPU.

Advects Lamb-Oseen vortex particles with their FMM-computed Biot-Savart
velocity (inviscid step, RK2) through
:class:`repro_torch.core.stepper.VortexStepper`: each step runs FMM ->
half kick -> device rebin -> FMM -> full kick -> rebin on the device, with
no host tree rebuild, under the plan of choice:

  --plan uniform   equal-count row bands (the DPMTA-style strawman)
  --plan model     a-priori cost-model bands (paper §4-§5, static)
  --plan dynamic   model bands re-planned from the drifted particle
                   distribution every --replan-every steps (paper's title)

On one device the plan sets only the modeled load balance the steps print;
the sharded driver (``--devices > 1``, ``--plan-grid``) is not ported yet.

The vorticity field is a steady Euler solution up to core diffusion, so
particles should orbit the vortex center on (nearly) circular paths: the
initial radius is carried through every rebinning as a step payload and
the max radius drift is the correctness invariant.

Run:  python examples/torch_vortex_sim.py [--steps 10] [--n-side 80]
          [--plan dynamic] [--device cpu]
"""
import argparse
import sys
from pathlib import Path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--dt", type=float, default=0.005)
    ap.add_argument("--n-side", type=int, default=80)
    ap.add_argument("--p", type=int, default=12)
    ap.add_argument("--plan", choices=("uniform", "model", "dynamic"),
                    default="model")
    ap.add_argument("--plan-grid", default=None, metavar="PrxPc|auto",
                    help="2-D device grid of the sharded driver (not ported)")
    ap.add_argument("--devices", type=int, default=1,
                    help="shard over N devices (not ported: 1 only)")
    ap.add_argument("--replan-every", type=int, default=4)
    ap.add_argument("--debug-nans", action="store_true",
                    help="raise at the first stage of a step that makes a "
                         "non-finite value (guarded recovery is disabled so "
                         "the fault is not masked)")
    ap.add_argument("--no-guard", action="store_true",
                    help="disable the health word + recovery ladder")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="snapshot (tree, payload) here every "
                         "--checkpoint-every steps")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="restore from the latest checkpoint in "
                         "--checkpoint-dir instead of starting fresh")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch route; default the CUDA card")
    args = ap.parse_args()

    if args.devices > 1 or args.plan_grid is not None:
        sys.exit("the sharded driver (--devices > 1, --plan-grid) is not "
                 "ported yet; the port steps on one device")

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.configs import backend
    if args.debug_nans:
        # debug-NaN wants the raw failure, not a recovered one
        backend.set_debug_nan(True)
        args.no_guard = True
    import numpy as np

    from repro_torch.core.stepper import VortexStepper
    from repro_torch.core.vortex import lamb_oseen_particles

    pos, gamma, sigma = lamb_oseen_particles(args.n_side)
    r0 = np.hypot(pos[:, 0] - 0.5, pos[:, 1] - 0.5)

    common = dict(
        plan_method="uniform" if args.plan == "uniform" else "model",
        dynamic=(args.plan == "dynamic"),
        replan_every=args.replan_every,
        guard=not args.no_guard,
        checkpoint_every=args.checkpoint_every,
        device=args.device)
    if args.resume:
        if not args.checkpoint_dir:
            sys.exit("--resume needs --checkpoint-dir")
        stepper = VortexStepper.from_checkpoint(args.checkpoint_dir, **common)
        print(f"resumed from step {stepper.step_count} in "
              f"{args.checkpoint_dir}")
    else:
        stepper = VortexStepper(
            pos, gamma, sigma, p=args.p, dt=args.dt,
            checkpoint_dir=args.checkpoint_dir,
            payload={"r0": r0 + 0j}, **common)
    s0 = stepper.stats()
    print(f"plan={args.plan} devices={stepper.nparts} device={stepper.device} "
          f"level={stepper.params.level} bands={stepper.plan.describe()} "
          f"LB(min/max)={s0['load_balance']:.3f}")

    drift = 0.0
    for step in range(args.steps):
        rec = stepper.step()
        if step % 2 == 1 or step == args.steps - 1:
            m = stepper.tree.mask.cpu().numpy().reshape(-1)
            z = stepper.tree.z.cpu().numpy().reshape(-1)[m]
            rr0 = stepper.payload["r0"].cpu().numpy().reshape(-1)[m].real
            r = np.hypot(z.real - 0.5, z.imag - 0.5)
            sel = rr0 > 0.02
            drift = np.abs(r[sel] - rr0[sel]).max()
            flags = ("R" if rec.replanned else "") + ("L" if rec.releveled else "")
            if rec.recovered:
                flags += f" recovered on {rec.recovered}"
            print(f"step {rec.step:3d}: max |r - r0| = {drift:.2e}  "
                  f"LB={rec.load_balance:.3f}  {rec.seconds * 1e3:7.1f} ms {flags}")
    if stepper._ckpt is not None:
        stepper._ckpt.wait()
    assert drift < 5e-3, drift
    print("OK")


if __name__ == "__main__":
    main()
