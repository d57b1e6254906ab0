"""Entry ``evaluate``: ``fmm_evaluate`` on a fixed tree, new strengths each call.

Set-up bins the seed's lattice (and, for passive targets, the traffic's
probe grid) with the program's ``build_tree`` and checks the tree it made.
Each evaluation of the window draws its strength vector on the card from
``(seed, evaluation)``, writes it into the tree's charge slots through the
tree's index, and runs ``fmm_evaluate`` (Laplace at the sources, or the
velocity kernel at the probes), ending in a device sync.

A sample of the window's evaluations, drawn from the seed as they come,
is kept by reference (strengths and output).  Once the window has closed
each is held at sampled targets to the float64 reference over every
source; the start check holds the tree's points to the inputs.
"""
from __future__ import annotations

import types

import numpy as np
import torch

from fmmbench import capture, counts, profiling, reference, traffic

SAMPLED_EVALUATIONS = 4
TARGETS = 2048


def _equation(cell):
    return "tracer" if "probes" in cell.traffic else cell.config["equation"]


def prepare(ctx):
    from repro_torch.core import equations, fmm, quadtree
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    eq = equations.get_equation(_equation(ctx.cell))
    inp = traffic.lattice(cfg, tr["lattice"], ctx.seed)
    sigma = None if cfg["sigma"] is None else inp["sigma"]
    level, slots = int(cfg["level"]), int(cfg["slots"])
    tree, index = quadtree.build_tree(inp["positions"], inp["gamma"], level, sigma,
                                      slots=slots, charge_scale=eq.charge_scale,
                                      device=ctx.device)
    flat = torch.as_tensor(index.box_of_particle * slots + index.slot_of_particle,
                           device=ctx.device)
    state = types.SimpleNamespace(
        trace=bool(ctx.trace), eq=eq, tree=tree, flat=flat, inputs=inp, sigma=sigma,
        level=level, probes=None, probe_pos=None, probe_flat=None, in_stretch=False,
        spans=None, base=torch.as_tensor(inp["gamma"], device=ctx.device),
        gen=torch.Generator(device=ctx.device), fmm=fmm, quadtree=quadtree)
    if "probes" in tr:
        pp = traffic.probes(tr["probes"])
        st = int(tr["probes"]["slots"])
        state.probes, pidx = quadtree.build_tree(pp, np.zeros(len(pp)), level, sigma,
                                                 slots=st, device=ctx.device)
        state.probe_pos = pp
        state.probe_flat = torch.as_tensor(pidx.box_of_particle * st + pidx.slot_of_particle,
                                           device=ctx.device)
    state.patches = capture.Patches()
    if ctx.trace:
        capture.trace_spans(state.patches, state)
        state.spans = profiling.Spans()
    state.recorder = capture.Recorder(SAMPLED_EVALUATIONS, traffic.rng(ctx.seed, 5))
    for i in range(int(tr["warmup_evaluations"])):
        _one(state, ctx, 10 ** 9 + i)
    state.recorder = capture.Recorder(SAMPLED_EVALUATIONS, traffic.rng(ctx.seed, 4))
    if ctx.trace:
        state.spans = profiling.Spans()
        profiling.Profile.warm()
    capture.sync(ctx.device)
    return state


def _one(state, ctx, e: int):
    """One evaluation: evaluation ``e``'s strengths into the charge slots,
    then ``fmm_evaluate``."""
    state.recorder.begin()
    t = state.tree
    s = traffic.evaluation_strengths(ctx.cell.traffic["strengths"], state.base, ctx.seed,
                                     e, state.gen)
    q = torch.zeros(t.q.numel(), dtype=torch.complex64, device=t.q.device)
    q[state.flat] = (s * state.eq.charge_scale).to(torch.complex64)
    tree_e = state.quadtree.Tree(z=t.z, q=q.view(t.q.shape), mask=t.mask,
                                 level=t.level, sigma=t.sigma)
    if state.trace:
        state.spans.begin_group()
    with torch.profiler.record_function("fmmbench.evaluation"):
        out = state.fmm.fmm_evaluate(tree_e, int(ctx.cell.config["p"]), eq=state.eq,
                                     targets=state.probes, device=ctx.device)
    if state.trace:
        state.spans.end_group()
    if state.recorder.current is not None:
        state.recorder.current.update(evaluation=e, strengths=s, out=out)
    state.recorder.commit()


def window(state, ctx) -> dict:
    times, window_s = capture.closed_loop(state, ctx, lambda i: _one(state, ctx, i))
    return {"step_s": times, "window_s": window_s, "attempted": len(times), "failed": 0}


def finish(state, ctx) -> dict | None:
    """Remove the wrappers; with ``--trace 1`` read spans, counters and the
    profile.  The tree and index stay: they are the check's start."""
    state.patches.remove()
    if not ctx.trace:
        return None
    cfg = ctx.cell.config
    desc = {"equation": state.eq.name, "level": state.level, "p": int(cfg["p"]),
            "singular": state.sigma is None, "src_counts": counts.counts_of(state.tree.mask)}
    if state.probes is not None:
        desc.update(tgt_counts=counts.counts_of(state.probes.mask))
    spans = {"expansions": state.spans.group_ms(),
             "p2p_kernel": state.spans.ms("p2p_kernel"),
             "m2l_kernel": state.spans.ms("m2l_kernel")}
    return state.stretch.trace(spans, [desc] * state.stretch.done, 0)


def judge(state, ctx, control: bool = False) -> dict:
    """The compared numbers, each {value, limit}; ``control`` puts the
    TF32 reference in place of the program's outputs."""
    limits = ctx.cell.spec["limits"]
    inp = state.inputs
    dev = state.tree.z.device
    z_in = torch.as_tensor(inp["positions"][:, 0] + 1j * inp["positions"][:, 1],
                           dtype=torch.complex64, device=dev)
    tree = state.tree
    start_off = int((tree.z.reshape(-1)[state.flat] != z_in).sum()) \
        + int((~tree.mask.reshape(-1)[state.flat]).sum()) \
        + abs(int(tree.mask.sum()) - len(z_in))
    targets = z_in
    if state.probes is not None:
        pz = torch.as_tensor(state.probe_pos[:, 0] + 1j * state.probe_pos[:, 1],
                             dtype=torch.complex64, device=dev)
        pr = state.probes
        start_off += int((pr.z.reshape(-1)[state.probe_flat] != pz).sum()) \
            + int((~pr.mask.reshape(-1)[state.probe_flat]).sum()) \
            + abs(int(pr.mask.sum()) - len(pz))
        targets = pz
    where = state.flat if state.probes is None else state.probe_flat
    laplace = state.eq.nout == 2
    kind = "laplace" if laplace else "vortex"
    worst = {"potential_rel_l2": 0.0, "field_rel_l2": 0.0} if laplace \
        else {"velocity_rel_l2": 0.0}
    sampled = [k for k in state.recorder.kept if k is not None]
    for cap in sampled:
        g = traffic.rng(ctx.seed, 3, cap["evaluation"])
        pick = torch.as_tensor(np.sort(g.choice(len(targets), min(TARGETS, len(targets)),
                                                replace=False)), device=dev)
        q = cap["strengths"] * state.eq.charge_scale
        args = (targets[pick], z_in, q, state.sigma, state.level)
        ref = reference.pair_sum(kind, *args)
        if control:
            got = reference.pair_sum(kind, *args, precision="tf32")
        else:
            got = cap["out"].reshape((-1, 2) if laplace else (-1,))[where[pick]]
        if laplace:
            worst["potential_rel_l2"] = max(worst["potential_rel_l2"],
                                            reference.rel_l2(got[:, 0].real, ref[:, 0].real))
            worst["field_rel_l2"] = max(worst["field_rel_l2"],
                                        reference.rel_l2(got[:, 1], ref[:, 1]))
        else:
            worst["velocity_rel_l2"] = max(worst["velocity_rel_l2"],
                                           reference.rel_l2(got, ref))
    if not sampled:
        worst = {k: float("inf") for k in worst}
    numbers = {**worst, "start_off": start_off}
    return {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
