"""``python -m repro_torch.analysis.check``: run every static-analysis layer
over the port.

The counterpart of ``src/repro/analysis/check.py``, with its four sections
(each skippable):

* ``lint``      AST rules over ``src/repro_torch`` (:mod:`.lint`)
* ``contracts`` the trace contracts over the named entry points
  (:mod:`.contracts`): M2L no-staging and fewer bytes than the masked-40
  form, guard-free and sync-free traces of ``fmm_velocity``, ``rk2_step``
  and the batched entries, no write into ``rk2_step``'s inputs, no f64,
  the fused exchange's directions on the 2x2 grid and both degenerate
  ones, and the pipeline's issue depth on a 4-rank slab plan
* ``schedule``  the collective-schedule verifier on every rank id, both
  plan kinds, degenerate and odd worlds included (:mod:`.schedule`)
* ``retrace``   the scripted cache sessions (:mod:`.retrace`)

``--device`` picks the route: ``cuda`` (the default, as every entry point
of the port; it raises without a card) runs the kernels, under
``torch.cuda.set_sync_debug_mode("error")`` for the kernel wrappers, the
serial entry points and ``rk2_step``, and pins their launches in the trace:
one M2L launch for the wrapper, one P2P and ``L - 1`` M2L launches for an
evaluation, twice that for an RK2 step, no plain call.  ``cpu`` runs the
kernels' plain versions.  The ranks of the schedule and pipeline cases are
:class:`~.schedule.DryMesh`es in this process, so no process is spawned.

Exit status is nonzero on any violation.  ``--json PATH`` writes the
section summaries.  Run from the repository root with ``src`` on the path.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

SECTIONS = ("lint", "contracts", "schedule", "retrace")


# ---------------------------------------------------------------------------
# fixtures (the reference's sizes)
# ---------------------------------------------------------------------------


def fmm_fixture(level, p, n=2000, device="cpu", charge_scale=None):
    import numpy as np
    from ..core.quadtree import build_tree

    rng = np.random.default_rng(0)
    pos = rng.uniform(0.02, 0.98, size=(n, 2))
    return build_tree(pos, rng.normal(size=n), level, sigma=0.02,
                      charge_scale=charge_scale, device=device)


def plans(index, level, p, slots, nparts, grid):
    """The model slab plan over ``nparts`` and the block plan on ``grid``."""
    from ..core.cost_model import ModelParams
    from ..core.plan import block_plan_from_counts, plan_from_counts

    params = ModelParams(level=level, cut=min(4, level - 1), p=p, slots=slots)
    slab = plan_from_counts(index.counts, params, nparts, method="model")
    block = block_plan_from_counts(index.counts, params, grid, method="model")
    return slab, block


def fused_exchange(grid, *, mesh):
    """The packed P2P halo round on its own, on a small fixed tile: the
    fused exchange's directions depend on the rank grid only."""
    import torch
    from ..core import parallel_fmm as pf

    rmax = cmax = 4
    z = torch.ones((rmax, cmax, 2), dtype=torch.complex64, device=mesh.device)
    m = torch.ones((rmax, cmax, 2), dtype=torch.bool, device=mesh.device)
    buf = pf._tile_halo(pf._pack_particles(z, z, m), 1, rmax, cmax, mesh, grid)
    return pf._unpack_particles(buf.wait())


# ---------------------------------------------------------------------------
# sections
# ---------------------------------------------------------------------------


def run_lint_section(args):
    from . import lint

    root = os.path.join(os.path.dirname(__file__), "..")
    findings = lint.run_lint(os.path.abspath(root))
    print(lint.format_findings(findings))
    return {"checked": len(lint.DEFAULT_RULES), "violations": len(findings),
            "detail": [str(f) for f in findings]}


def run_contracts_section(args):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from . import contracts as C
    from .schedule import DryMesh
    from ..core import equations as eqs
    from ..core import expansions as ex
    from ..core import parallel_fmm as pf
    from ..core import stepper as stp
    from ..core.fmm import fmm_velocity
    from ..kernels import ops as kops
    from ..serve import fmm_service as svc

    dev = torch.device(args.device)
    card = dev.type == "cuda"
    quick = args.quick
    results = []

    # -- M2L staging/bytes ----------------------------------------------------
    level, p = (3, 12) if quick else (4, 17)
    n = 1 << level
    rng = np.random.default_rng(0)
    me = torch.as_tensor(rng.normal(size=(n, n, p)) + 1j * rng.normal(size=(n, n, p)),
                         dtype=torch.complex64, device=dev)
    kern = C.Traced(kops.m2l_apply, me, level, p, label="m2l_apply")
    # the two plain forms, compared for bytes (the masked-40 oracle copies
    # its parity masks from the host on every call)
    fold = C.Traced(lambda g: ex.m2l_folded(F.pad(g, (0, 0, 0, 0, 2, 2)), level, p),
                    me, label="m2l_folded", sync_debug=False)
    m40 = C.Traced(ex.m2l_masked40, me, level, p, label="m2l_masked40",
                   sync_debug=False)
    staging = [C.no_staging_dim(40 * p), C.no_f64_upcast()]
    results += C.evaluate(kern, staging + [C.no_host_callback()] + (
        [C.launch_count("m2l", 1)] if card else []))
    results += C.evaluate(fold, staging)
    results += C.evaluate(fold, [C.fewer_bytes("folded", "masked40")],
                          pair_with=m40)

    # -- the P2P wrapper, the serial driver and rk2_step ----------------------
    L = 3 if quick else 4
    tree, index = fmm_fixture(L, 6, device=dev)
    pad = (0, 0, 1, 1, 1, 1)
    p2p = C.Traced(kops.p2p_apply_slab, F.pad(tree.z, pad), F.pad(tree.q, pad),
                   F.pad(tree.mask, pad), tree.sigma, label="p2p_apply_slab")
    results += C.evaluate(p2p, [C.no_host_callback(), C.no_f64_upcast()] + (
        [C.launch_count("p2p", 1)] if card else []))
    per_eval = [C.launch_count("p2p", 1), C.launch_count("m2l", L - 1),
                C.no_plain_calls()] if card else []
    drv = C.Traced(fmm_velocity, tree, 6, device=dev, label="fmm_velocity")
    results += C.evaluate(drv, [C.sentinel_free(), C.no_host_callback(),
                                C.no_f64_upcast()] + per_eval)
    rk2 = C.Traced(stp.TRACE_ENTRY_POINTS["rk2_step"], tree, 1e-4, p=6,
                   device=dev, label="rk2_step[guard=False]")
    results += C.evaluate(rk2, [C.sentinel_free(), C.not_donated("rk2"),
                                C.no_host_callback(), C.no_f64_upcast()] + (
        [C.launch_count("p2p", 2), C.launch_count("m2l", 2 * (L - 1)),
         C.no_plain_calls()] if card else []))

    # -- the batched serving entries at batch 2 -------------------------------
    strees = [fmm_fixture(3, 6, n=300, device=dev)[0] for _ in range(2)]
    bz, bq, bm = svc.stack_trees(strees, 2)
    for name, xargs in (("batched_fmm_eval", (bz, bq, bm)),
                        ("batched_fmm_eval_targets", (bz, bq, bm, bz, bm))):
        traced = C.Traced(svc.TRACE_ENTRY_POINTS[name], *xargs, level=3,
                          sigma=0.02, p=6, eq=eqs.VORTEX, label=f"{name}[B2]")
        results += C.evaluate(traced, [C.sentinel_free(), C.no_host_callback(),
                                       C.no_f64_upcast()] + (
            [C.launch_count("p2p", 1), C.launch_count("m2l", 2),
             C.no_plain_calls()] if card else []))

    # -- the fused packed exchange: 4 directions on 2x2, 2 on degenerate axes -
    from ..launch.trace_analysis import OpTrace
    for grid, want in (((2, 2), 4), ((4, 1), 2), ((1, 4), 2)):
        with OpTrace() as tr:
            for r in range(4):
                fused_exchange(grid, mesh=DryMesh(4, r, dev))
        traced = C.Traced.from_trace(tr, label=f"p2p_exchange{grid[0]}x{grid[1]}")
        results += C.evaluate(traced, [C.collective_count("directions", want)])

    # -- the pipelined issue order on the sharded evaluation ------------------
    level, p = (5, 8) if quick else (6, 12)
    tree, index = fmm_fixture(level, p, n=4000 if quick else 20000, device=dev)
    slab, _ = plans(index, level, p, tree.slots, 4, (2, 2))
    evaluate_ep = pf.TRACE_ENTRY_POINTS["parallel_fmm_evaluate"]
    traced = {}
    for pipe in (True, False):
        traced[pipe] = C.Traced(evaluate_ep, tree, p, mesh=DryMesh(4, 0, dev),
                                plan=slab, pipeline=pipe, sync_debug=False,
                                label=f"fmm[pipeline={'on' if pipe else 'off'}]")
    results += C.evaluate(traced[True],
                          [C.issue_depth_grows("all_gather"),
                           C.min_issue_depth("all_gather", 8 if quick else 32)],
                          pair_with=traced[False])

    print(C.format_results(results))
    bad = C.violations(results)
    return {"checked": len(results), "violations": len(bad),
            "detail": [str(r) for r in bad]}


def schedule_cases(level, p, device):
    """``[(label, fn, world, args, kwargs)]``: the reference's schedule
    cases, each a host program to run on every rank id."""
    from ..core import parallel_fmm as pf
    from ..core import stepper as stp

    tree, index = fmm_fixture(level, p, device=device)
    evaluate_ep = pf.TRACE_ENTRY_POINTS["parallel_fmm_evaluate"]
    rk2 = stp.TRACE_ENTRY_POINTS["rk2_step"]
    slab, block = plans(index, level, p, tree.slots, 4, (2, 2))
    _, b41 = plans(index, level, p, tree.slots, 4, (4, 1))
    _, b14 = plans(index, level, p, tree.slots, 4, (1, 4))
    _, b23 = plans(index, level, p, tree.slots, 6, (2, 3))
    # the shrunken world: after a 4 -> 3 shrink the survivors run every
    # evaluation at the odd world size
    slab3, _ = plans(index, level, p, tree.slots, 3, (3, 1))
    targets, _ = fmm_fixture(level, p, n=500, device=device)
    cases = [(f"parallel_fmm[{label}]", evaluate_ep, world, (tree, p),
              {"plan": plan})
             for label, world, plan in (("slab_P4", 4, slab), ("block_2x2", 4, block),
                                        ("block_4x1", 4, b41), ("block_1x4", 4, b14),
                                        ("block_2x3", 6, b23),
                                        ("slab_P3_shrunk", 3, slab3))]
    cases += [("rk2_step[slab_P4]", rk2, 4, (tree, 1e-4), {"p": p, "plan": slab}),
              ("parallel_fmm[slab_P4_targets]", evaluate_ep, 4, (tree, p),
               {"plan": slab, "targets": targets}),
              ("rk2_step[slab_P3_shrunk]", rk2, 3, (tree, 1e-4),
               {"p": p, "plan": slab3})]
    return cases


def run_schedule_section(args):
    from . import schedule as S

    level, p = (4, 6) if args.quick else (5, 8)
    reports = [S.verify_entry(fn, *xargs, world=world, label=label,
                              device=args.device, **kw)
               for label, fn, world, xargs, kw in schedule_cases(level, p, args.device)]
    bad = [r for r in reports if not r.ok]
    for r in reports:
        print(r.diff_text() if not r.ok else
              f"schedule [{r.label}]: consistent, {S.counts_text(r.schedules[0])} "
              f"x {r.ranks} ranks")
    return {"checked": len(reports), "violations": len(bad),
            "detail": [r.diff_text() for r in bad]}


def run_retrace_section(args):
    from . import retrace as R

    events = R.run_session(level=3, p=4, device=args.device)
    events += R.run_serve_session(level=2, p=4, device=args.device)
    bad = [e for e in events if not e.ok]
    for e in events:
        print(f"retrace {e}")
    return {"checked": len(events), "violations": len(bad),
            "detail": [str(e) for e in bad]}


RUNNERS = {"lint": run_lint_section, "contracts": run_contracts_section,
           "schedule": run_schedule_section, "retrace": run_retrace_section}


def run(device: str = "cuda", quick: bool = False, skip=()) -> dict:
    """Run the sections not in ``skip``; returns ``{section: summary}``,
    each summary with ``checked``, ``violations``, ``detail`` and
    ``seconds``."""
    from ..configs.backend import resolve_device

    resolve_device(device)                  # the card, or raise: no fallback
    args = argparse.Namespace(device=device, quick=quick)
    summary = {}
    for name in SECTIONS:
        if name in skip:
            summary[name] = {"skipped": True}
            continue
        print(f"==== {name} ====", flush=True)
        t0 = time.perf_counter()
        res = RUNNERS[name](args)
        res["seconds"] = time.perf_counter() - t0
        summary[name] = res
        print(f"---- {name}: {res['checked']} checked, "
              f"{res['violations']} violation(s)\n", flush=True)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.check",
        description="lint + trace contracts + schedule verify + cache accounting")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="the route to check (default the card; it raises "
                         "without one)")
    ap.add_argument("--quick", action="store_true", help="smaller fixtures")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write section summaries as JSON")
    ap.add_argument("--skip", action="append", default=[],
                    choices=SECTIONS, help="skip a section (repeatable)")
    args = ap.parse_args(argv)

    summary = run(args.device, args.quick, args.skip)
    failed = sum(s.get("violations", 0) for s in summary.values())
    total = sum(s.get("checked", 0) for s in summary.values())
    print(f"==== total: {total} checks, {failed} violation(s) ====")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=2)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
