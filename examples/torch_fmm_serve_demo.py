"""Multi-tenant serving drill of the port: the FMM-as-a-service acceptance
scenario, on the CUDA card or, with ``--device cpu``, the CPU.

Spins up :class:`repro_torch.serve.fmm_service.FmmServiceEngine` on
``--ranks`` rank processes (gloo, every rank on the same device, each fed
the same jobs) and drives a mixed workload from four tenants at once:

* two vortex RK2 trajectory sessions (streamed),
* a wave of laplace probe-grid one-shots,
* a wave of tracer (passive velocity probe) one-shots,
* an oversized job that must be REJECTED with its cost-model price.

Every result is asserted against its single-tenant reference: sessions
against a serial ``VortexStepper`` run of the same system, one-shots
against the f64 ``direct_sum`` oracle — so multi-tenancy, batching, and
sharding change nothing but throughput.  Steady-state serving is pinned:
the second wave of one-shots must not add a batched launch configuration.
Rank 0 checks and prints.

Run:  python examples/torch_fmm_serve_demo.py [--ranks 4] [--n 600]
          [--steps 3] [--p 8] [--device cpu]
"""
import argparse
import itertools
import sys
from pathlib import Path


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--n", type=int, default=600,
                    help="particles per session tenant")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--p", type=int, default=8)
    ap.add_argument("--sigma", type=float, default=0.02)
    ap.add_argument("--dt", type=float, default=1e-3)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch route; default the CUDA card")
    args = ap.parse_args(argv)
    if args.ranks < 1:
        ap.error(f"--ranks must be at least 1, got {args.ranks}")
    return args


def drill(mesh, args) -> bool:
    """The drill on one rank (``mesh=None``: one device); rank 0 checks and
    prints.  Returns True when every check held (on rank 0)."""
    import numpy as np

    from repro_torch.core import equations as eqs
    from repro_torch.core.stepper import VortexStepper
    from repro_torch.serve import fmm_service as svc

    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    engine = svc.FmmServiceEngine(mesh=mesh,
                                  device=args.device if mesh is None else None)
    say(f"== fmm_serve_demo: {engine.nparts} rank(s) on {engine.device}, "
        f"{args.steps}-step sessions, n={args.n}")
    rng = np.random.default_rng(11)

    # -- tenants 1+2: vortex RK2 trajectory sessions -------------------------
    session_inputs = []
    for t in range(2):
        pos = rng.uniform(0.25, 0.75, size=(args.n, 2))
        gam = 0.1 * rng.normal(size=args.n)     # gentle dynamics: the drill
        session_inputs.append((pos, gam))       # compares trajectories
    sids = [engine.submit(svc.FmmJob(
        positions=pos, strength=gam, steps=args.steps, p=args.p,
        dt=args.dt, sigma=args.sigma, tenant=f"vortex-{t}"))
        for t, (pos, gam) in enumerate(session_inputs)]

    # -- tenants 3+4: laplace probe one-shots + tracer jobs ------------------
    oneshot_jobs = []
    for w in range(3):
        n_src = 180 + 8 * w            # nearby sizes share one bucket
        src = rng.uniform(0.1, 0.9, size=(n_src, 2))
        q = rng.normal(size=n_src)
        tgt = rng.uniform(0.1, 0.9, size=(72, 2))
        for eq_name in ("laplace", "tracer"):
            jid = engine.submit(svc.FmmJob(
                positions=src, strength=q, equation=eq_name, targets=tgt,
                p=12, sigma=args.sigma, tenant=eq_name))
            oneshot_jobs.append((jid, eq_name, src, q, tgt))

    # -- oversized job: typed rejection with its Eq 13-15 price --------------
    big = rng.uniform(0.0, 1.0, size=(200_000, 2))
    try:
        engine.submit(svc.FmmJob(positions=big, strength=np.ones(len(big)),
                                 level=9, p=24, sigma=args.sigma,
                                 tenant="whale"))
        raise AssertionError("oversized job was not rejected")
    except svc.JobRejected as e:
        assert e.price.total_flops > engine.budget.max_job_flops
        say(f"   oversized job rejected as priced: "
            f"{e.price.total_flops:.3g} modeled flops "
            f"(budget {engine.budget.max_job_flops:.3g})")

    # -- serve everything concurrently ---------------------------------------
    # Pull the first step of each session stream to start both, then drain
    # the one-shot queue while (on one rank) the sessions' next steps
    # compute in their prefetch threads.
    streams = [engine.session(sid).stream(args.steps) for sid in sids]
    first = [next(s) for s in streams]
    engine.drain()
    finals = [None, None]
    for t, stream in enumerate(streams):
        for i, _pos, rec in itertools.chain([first[t]], stream):
            say(f"   session {t}: step {i} "
                f"({rec.seconds * 1e3:.1f} ms, lb={rec.load_balance:.3f})")
        finals[t] = engine.session(sids[t]).particles()[0]

    # -- references (rank 0) --------------------------------------------------
    def canon(a):
        # particles() returns (box, slot) order, which depends on the tree
        # level: compare position-sorted point sets
        return a[np.lexsort((a[:, 1], a[:, 0]))]

    if lead:
        for t, (pos, gam) in enumerate(session_inputs):
            ref = VortexStepper(pos, gam, args.sigma, p=args.p, dt=args.dt,
                                device=engine.device)
            for _ in range(args.steps):
                ref.step()
            err = np.abs(canon(finals[t]) - canon(ref.particles()[0])).max()
            say(f"   session {t} vs serial reference: max |dx| = {err:.2e}")
            assert err < 5e-4, f"session {t} diverged from reference: {err}"

        for jid, eq_name, src, q, tgt in oneshot_jobs:
            out = engine.result(jid).out
            ref = eqs.direct_sum(eq_name, tgt[:, 0] + 1j * tgt[:, 1],
                                 src[:, 0] + 1j * src[:, 1], q, args.sigma)
            if eq_name == "laplace":
                # Re of the potential channel is branch-cut exact; the field
                # channel compares as a full complex value
                err = max(np.abs(out[:, 0].real - ref[:, 0].real).max()
                          / np.abs(ref[:, 0].real).max(),
                          np.abs(out[:, 1] - ref[:, 1]).max()
                          / np.abs(ref[:, 1]).max())
            else:
                err = np.abs(out - ref).max() / np.abs(ref).max()
            assert err < 2e-3, f"{eq_name} job {jid}: rel err {err:.2e}"
            say(f"   {eq_name} job {jid} vs f64 direct sum: rel err = {err:.2e}")

    # -- steady state must not add a launch configuration ---------------------
    # second wave: same layouts (-> same buckets), FRESH charge strengths
    entries_warm = svc.batched_cache_entries()
    for jid, eq_name, src, q, tgt in oneshot_jobs:
        engine.submit(svc.FmmJob(positions=src,
                                 strength=rng.normal(size=len(src)),
                                 equation=eq_name, targets=tgt, p=12,
                                 sigma=args.sigma, tenant=eq_name))
    engine.drain()
    entries_steady = svc.batched_cache_entries()
    assert entries_steady == entries_warm, \
        f"steady-state serving added launch configurations: " \
        f"{entries_warm} -> {entries_steady}"
    say(f"   steady-state retraces: 0 "
        f"(batched launch configurations pinned at {entries_steady})")

    stats = engine.stats()
    say(f"   cache: {stats['cache']}  "
        f"batch_utilization={stats['batch_utilization']:.2f}")
    for lane, l in stats["latency"].items():
        say(f"   latency[{lane}]: p50={l['p50_ms']:.1f} ms "
            f"p99={l['p99_ms']:.1f} ms (n={l['n']})")
    return True


def main():
    args = parse()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    if args.ranks == 1:
        ok = drill(None, args)
    else:
        from repro_torch.launch.mesh import spawn_world
        ok = all(spawn_world(drill, args.ranks, device=args.device,
                             args=(args,)))
    assert ok
    print("== fmm_serve_demo: OK")


if __name__ == "__main__":
    main()
