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

``--ranks N`` runs the sharded driver on N rank processes (one
``torch.distributed`` world over gloo, every rank on the same device; on
one card the messages are staged through host memory, so the times are
not a scaling result).  ``--plan-grid PrxPc`` (e.g. ``2x2``) schedules a
2-D tile grid and implies ``--ranks Pr*Pc``; ``--plan-grid auto`` lets the
grid autotuner choose.  ``--no-overlap`` and ``--no-pipeline`` select the
sharded driver's monolithic and unpipelined orders.

The vorticity field is a steady Euler solution up to core diffusion, so
particles should orbit the vortex center on (nearly) circular paths: the
initial radius is carried through every rebinning as a step payload and
the max radius drift is the correctness invariant.

Run:  python examples/torch_vortex_sim.py [--steps 10] [--n-side 80]
          [--plan dynamic] [--ranks 4] [--device cpu]
"""
import argparse
import sys
from pathlib import Path


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--dt", type=float, default=0.005)
    ap.add_argument("--n-side", type=int, default=80)
    ap.add_argument("--p", type=int, default=12)
    ap.add_argument("--plan", choices=("uniform", "model", "dynamic"),
                    default="model")
    ap.add_argument("--plan-grid", default=None, metavar="PrxPc|auto",
                    help="2-D rank grid, e.g. 2x2 (implies --ranks Pr*Pc), "
                         "or 'auto' for the grid autotuner")
    ap.add_argument("--ranks", type=int, default=1,
                    help="run the sharded driver on N rank processes")
    ap.add_argument("--no-overlap", action="store_true",
                    help="the sharded driver's monolithic exchange order")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="no substep pipelining (P2P prefetch, gather overlap)")
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
    args = ap.parse_args(argv)
    args.grid = None
    if args.plan_grid is not None and args.plan_grid.lower() == "auto":
        args.grid = "auto"
    elif args.plan_grid is not None:
        parts = args.plan_grid.lower().split("x")
        if len(parts) != 2 or not all(x.isdigit() and int(x) >= 1 for x in parts):
            sys.exit(f"--plan-grid must look like 2x3 or auto, got "
                     f"{args.plan_grid!r}")
        args.grid = (int(parts[0]), int(parts[1]))
        nranks = args.grid[0] * args.grid[1]
        if args.ranks not in (1, nranks):
            sys.exit(f"--plan-grid {args.plan_grid} needs {nranks} ranks, "
                     f"--ranks says {args.ranks}")
        args.ranks = nranks
    if args.ranks < 1:
        sys.exit(f"--ranks must be at least 1, got {args.ranks}")
    if args.resume and not args.checkpoint_dir:
        sys.exit("--resume needs --checkpoint-dir")
    return args


def run(mesh, args) -> float:
    """The simulation on one rank (``mesh=None``: one device); rank 0
    prints.  Returns the last orbit drift."""
    from repro_torch.configs import backend
    if args.debug_nans:
        # debug-NaN wants the raw failure, not a recovered one
        backend.set_debug_nan(True)
        args.no_guard = True
    import numpy as np

    from repro_torch.core.stepper import VortexStepper
    from repro_torch.core.vortex import lamb_oseen_particles

    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)
    pos, gamma, sigma = lamb_oseen_particles(args.n_side)
    r0 = np.hypot(pos[:, 0] - 0.5, pos[:, 1] - 0.5)

    common = dict(
        mesh=mesh,
        plan_method="uniform" if args.plan == "uniform" else "model",
        dynamic=(args.plan == "dynamic"), plan_grid=args.grid,
        overlap=not args.no_overlap, pipeline=not args.no_pipeline,
        replan_every=args.replan_every,
        guard=not args.no_guard,
        checkpoint_every=args.checkpoint_every,
        device=None if mesh is not None else args.device)
    if args.resume:
        stepper = VortexStepper.from_checkpoint(args.checkpoint_dir, **common)
        say(f"resumed from step {stepper.step_count} in "
            f"{args.checkpoint_dir}")
    else:
        stepper = VortexStepper(
            pos, gamma, sigma, p=args.p, dt=args.dt,
            checkpoint_dir=args.checkpoint_dir,
            payload={"r0": r0 + 0j}, **common)
    s0 = stepper.stats()
    say(f"plan={args.plan} devices={stepper.nparts} device={stepper.device} "
        f"level={stepper.params.level} bands={stepper.plan.describe()} "
        f"LB(min/max)={s0['load_balance']:.3f}")
    if stepper.nparts > 1 and stepper.device.type == "cuda":
        say(f"{stepper.nparts} ranks share one card over gloo: the step "
            f"times are not a scaling result")

    drift = 0.0
    for step in range(args.steps):
        rec = stepper.step()
        if step % 2 == 1 or step == args.steps - 1:
            m = stepper.tree.mask.cpu().numpy().reshape(-1)
            z = stepper.tree.z.cpu().numpy().reshape(-1)[m]
            rr0 = stepper.payload["r0"].cpu().numpy().reshape(-1)[m].real
            r = np.hypot(z.real - 0.5, z.imag - 0.5)
            sel = rr0 > 0.02
            drift = float(np.abs(r[sel] - rr0[sel]).max())
            flags = ("R" if rec.replanned else "") + ("L" if rec.releveled else "")
            if rec.recovered:
                flags += f" recovered on {rec.recovered}"
            say(f"step {rec.step:3d}: max |r - r0| = {drift:.2e}  "
                f"LB={rec.load_balance:.3f}  {rec.seconds * 1e3:7.1f} ms {flags}")
    if stepper._ckpt is not None:
        stepper.wait_checkpoint()
    return drift


def main():
    args = parse()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    if args.ranks == 1:
        drift = run(None, args)
    else:
        from repro_torch.launch.mesh import spawn_world
        drift = spawn_world(run, args.ranks, device=args.device, args=(args,))[0]
    assert drift < 5e-3, drift
    print("OK")


if __name__ == "__main__":
    main()
