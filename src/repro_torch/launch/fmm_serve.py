"""FMM serving launcher: price, admit, and serve a synthetic workload.

The CLI face of ``serve/fmm_service.py`` and the port of
``src/repro/launch/fmm_serve.py``: builds a
:class:`~repro_torch.serve.fmm_service.FmmServiceEngine` on the CUDA card
(or, with ``--device cpu``, the CPU; without a card and without that flag
it raises), on one rank or on ``--ranks N`` rank processes (gloo, every
rank on the same device, each fed the same jobs), submits a mixed one-shot
+ trajectory workload, and prints the per-job prices, admission decisions,
latency percentiles, cache hit/miss counters, and ``jit_entries``: the
distinct batched launch configurations run, which steady-state serving
does not grow.  Rank 0 prints.

Run:  PYTHONPATH=src python -m repro_torch.launch.fmm_serve [--ranks 4]
          [--jobs 8] [--n 300] [--steps 2] [--max-job-flops 5e9]
          [--device cpu]
"""
from __future__ import annotations

import argparse
import sys


def parse(argv=None):
    ap = argparse.ArgumentParser(description="FMM-as-a-service smoke/driver")
    ap.add_argument("--ranks", type=int, default=1,
                    help="serve on N rank processes (gloo)")
    ap.add_argument("--jobs", type=int, default=8,
                    help="one-shot jobs per equation wave")
    ap.add_argument("--n", type=int, default=300,
                    help="sources per one-shot job")
    ap.add_argument("--steps", type=int, default=2,
                    help="RK2 steps of the trajectory session (0 disables)")
    ap.add_argument("--p", type=int, default=8)
    ap.add_argument("--sigma", type=float, default=0.02)
    ap.add_argument("--max-job-flops", type=float, default=5e9)
    ap.add_argument("--max-queue-flops", type=float, default=2e10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch route; default the CUDA card")
    args = ap.parse_args(argv)
    if args.ranks < 1:
        ap.error(f"--ranks must be at least 1, got {args.ranks}")
    return args


def serve(mesh, args) -> dict:
    """The workload on one rank (``mesh=None``: one device); rank 0 prints.
    Returns the engine's stats."""
    import numpy as np

    from ..serve import fmm_service as svc

    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    engine = svc.FmmServiceEngine(
        mesh=mesh, device=args.device if mesh is None else None,
        budget=svc.ServiceBudget(max_job_flops=args.max_job_flops,
                                 max_queue_flops=args.max_queue_flops))
    rng = np.random.default_rng(args.seed)
    say(f"== fmm_serve: {engine.nparts} rank(s) on {engine.device}, budget "
        f"max_job={args.max_job_flops:.2g} "
        f"max_queue={args.max_queue_flops:.2g} flops")

    jids = []
    for i in range(args.jobs):
        n = args.n + 4 * (i % 3)
        pos = rng.uniform(0.1, 0.9, size=(n, 2))
        q = rng.normal(size=n)
        job = svc.FmmJob(positions=pos, strength=q,
                         equation="vortex" if i % 2 == 0 else "laplace",
                         p=args.p, sigma=args.sigma, tenant=f"t{i % 3}")
        try:
            jids.append(engine.submit(job))
        except svc.JobRejected as e:
            say(f"   job {i}: REJECTED at {e.price.total_flops:.3g} flops")
    if args.steps:
        pos = rng.uniform(0.3, 0.7, size=(args.n, 2))
        sid = engine.submit(svc.FmmJob(
            positions=pos, strength=0.1 * rng.normal(size=args.n),
            steps=args.steps, p=args.p, dt=1e-3, sigma=args.sigma,
            tenant="session"))
        for i, _pos, rec in engine.session(sid).stream(args.steps):
            say(f"   session step {i}: {rec.seconds * 1e3:.1f} ms")
    engine.drain()

    for jid in jids:
        r = engine.result(jid)
        say(f"   job {jid}: lane={r.lane} cap={r.batch_capacity} "
            f"price={r.price.total_flops:.3g} flops "
            f"(level={r.price.level}, p={r.price.p}, "
            f"slots={r.price.slots}) latency={r.latency_s * 1e3:.1f} ms")
    stats = engine.stats()
    say(f"   admitted={stats['admitted']} deferred={stats['deferred']} "
        f"promoted={stats['promoted']} rejected={stats['rejected']} "
        f"batches={stats['batches']}")
    say(f"   cache={stats['cache']} "
        f"batch_utilization={stats['batch_utilization']:.2f} "
        f"jit_entries={stats['jit_entries']}")
    for lane, l in stats["latency"].items():
        say(f"   latency[{lane}]: p50={l['p50_ms']:.1f} ms "
            f"p99={l['p99_ms']:.1f} ms (n={l['n']})")
    return stats


def main(argv=None):
    args = parse(argv)
    if args.ranks == 1:
        serve(None, args)
    else:
        from .mesh import spawn_world
        stats = spawn_world(serve, args.ranks, device=args.device, args=(args,))
        # every rank was fed the same jobs: all but the host clocks agree
        counted = [{k: v for k, v in s.items() if k != "latency"} for s in stats]
        if any(c != counted[0] for c in counted):
            raise RuntimeError("the ranks' engines disagree on their counters")
    print("== fmm_serve: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
