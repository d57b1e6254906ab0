"""Laplace charges and a probe-grid evaluation through the port's sharded
driver, on one CUDA card or, with ``--device cpu``, the CPU.

Point charges induce the 2-D Laplace potential ``q log|z - z_j|`` and field
``-q/(z - z_j)``; both come out of ONE downward sweep of the ``laplace``
equation, and a passive probe grid, binned into the same tree level as a
targets batch, is evaluated against the sources' local expansions and near
field, cut into rank tiles by the cost-model plan the vortex client uses.
Nothing here is vortex-specific: the drivers consume only the equation
spec.

``--ranks N`` evaluates on N rank processes (gloo; every rank on the same
device, each holding the whole tree and returning the whole result); rank
0 checks a probe subsample against the float64 direct sum.

Run:  python examples/torch_laplace_probe.py [--ranks 4] [--n-charges 4000]
          [--probe-side 48] [--plan model] [--device cpu]
"""
import argparse
import sys
from pathlib import Path


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-charges", type=int, default=4000)
    ap.add_argument("--probe-side", type=int, default=48,
                    help="probe grid resolution (probe-side^2 targets)")
    ap.add_argument("--p", type=int, default=12)
    ap.add_argument("--level", type=int, default=5)
    ap.add_argument("--sigma", type=float, default=0.01)
    ap.add_argument("--plan", choices=("uniform", "model"), default="model")
    ap.add_argument("--ranks", type=int, default=1,
                    help="evaluate on N rank processes")
    ap.add_argument("--check", type=int, default=400,
                    help="probe subsample size verified against the f64 "
                         "direct sum")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch route; default the CUDA card")
    args = ap.parse_args(argv)
    if args.ranks < 1:
        sys.exit(f"--ranks must be at least 1, got {args.ranks}")
    return args


def run(mesh, args) -> tuple[float, float]:
    """The evaluation on one rank (``mesh=None``: one device); rank 0
    prints and checks.  Returns the potential's and the field's rel error
    against the direct sum (NaN on the other ranks)."""
    import numpy as np

    from repro_torch.core import equations as eqs
    from repro_torch.core.cost_model import ModelParams
    from repro_torch.core.parallel_fmm import parallel_fmm_evaluate
    from repro_torch.core.plan import plan_from_counts, plan_stats
    from repro_torch.core.quadtree import build_tree, gather_particle_values

    lead = mesh is None or mesh.rank == 0
    device = args.device if mesh is None else mesh.device
    eq = eqs.LAPLACE
    rng = np.random.default_rng(0)

    # a +/- charge dipole pair of Gaussian clusters over a weak background
    n_half = args.n_charges // 2
    pos = np.concatenate([
        rng.normal((0.35, 0.5), 0.08, size=(n_half, 2)),
        rng.normal((0.65, 0.5), 0.08, size=(args.n_charges - n_half, 2)),
    ]).clip(0.01, 0.99)
    charge = np.concatenate([np.ones(n_half),
                             -np.ones(args.n_charges - n_half)])
    charge *= 1.0 + 0.1 * rng.normal(size=args.n_charges)

    # probe grid: passive targets binned into the SAME tree level
    xs = np.linspace(0.06, 0.94, args.probe_side)
    PX, PY = np.meshgrid(xs, xs, indexing="xy")
    probes = np.stack([PX.ravel(), PY.ravel()], axis=1)

    tree, index = build_tree(pos, charge, args.level, sigma=args.sigma,
                             charge_scale=eq.charge_scale, device=device)
    targets, tindex = build_tree(probes, np.zeros(len(probes)), args.level,
                                 sigma=args.sigma, device=device)

    nparts = 1 if mesh is None else mesh.size
    params = ModelParams(level=args.level, cut=min(args.level - 1, 4),
                         p=args.p, slots=tree.slots, nout=eq.nout)
    plan = plan_from_counts(index.counts, params, nparts, method=args.plan)
    lb = plan_stats(plan, index.counts, params)["load_balance"]
    if lead:
        print(f"plan={args.plan} ranks={nparts} device={tree.device} "
              f"bands={plan.describe()} LB(min/max)={lb:.3f}")

    out = parallel_fmm_evaluate(tree, args.p, mesh, plan=plan, eq=eq,
                                targets=targets, device=device)
    if not lead:
        return float("nan"), float("nan")
    pot = gather_particle_values(out[..., 0], tindex).real.cpu().numpy()
    fld = gather_particle_values(out[..., 1], tindex).cpu().numpy()
    print(f"probes={len(probes)} potential range "
          f"[{pot.min():+.3f}, {pot.max():+.3f}]  max|E|={np.abs(fld).max():.3f}")

    # verify a probe subsample against the f64 direct sum
    sel = rng.choice(len(probes), size=min(args.check, len(probes)),
                     replace=False)
    z_src = pos[:, 0] + 1j * pos[:, 1]
    z_prb = probes[sel, 0] + 1j * probes[sel, 1]
    exact = eqs.direct_sum(eq, z_prb, z_src, charge, sigma=args.sigma)
    err_pot = float(np.linalg.norm(pot[sel] - exact[:, 0].real)
                    / np.linalg.norm(exact[:, 0].real))
    err_fld = float(np.linalg.norm(fld[sel] - exact[:, 1])
                    / np.linalg.norm(exact[:, 1]))
    print(f"vs direct sum: potential rel err {err_pot:.2e}, "
          f"field rel err {err_fld:.2e}")
    return err_pot, err_fld


def main():
    args = parse()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    if args.ranks == 1:
        err_pot, err_fld = run(None, args)
    else:
        from repro_torch.launch.mesh import spawn_world
        err_pot, err_fld = spawn_world(run, args.ranks, device=args.device,
                                       args=(args,))[0]
    assert err_pot < 1e-4 and err_fld < 1e-4, (err_pot, err_fld)
    print("OK")


if __name__ == "__main__":
    main()
