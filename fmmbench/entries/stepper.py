"""Entry ``stepper``: ``VortexStepper.step()`` on the seed's vortex lattice.

Set-up builds the stepper as ``examples/torch_vortex_sim.py`` does on one
card (the traffic mix gives the plan, replanning, guard, tree and
payload), checks that it built the configuration's tree, and warms up with
whole steps.  The window steps it back to back.

The benchmark's wrappers around the program's ``fmm_velocity`` and
``rebuild_tree`` (module attributes of ``core/stepper.py``) keep
references to the inputs and outputs of a sample of the window's steps,
drawn from the seed as the window runs (reservoir sampling): no copy and
no device work.  With ``--trace 1`` they also time each rebin and the
expansion stages with CUDA events, and ``maybe_replan`` on the host.

Once the window has closed the check follows each sampled step from the
program's own state: both evaluations at sampled particles against the
float64 reference over every source, each kick at every particle, each
rebin as a multiset of (position, charge, payload) and its binning; then
the start (the first tree against the inputs), the hand-off from step to
step, every step's health word, and the orbit invariant at the end.
"""
from __future__ import annotations

import time
import types

import numpy as np
import torch

from fmmbench import capture, checks, counts, profiling, reference, traffic

SAMPLED_STEPS = 3
TARGETS = 2048
# the fault fields of a step's packed health word (core/health.py: bits 0-3
# the non-finite and overflow flags, 4-15 out of domain, 16-23 dropped);
# bits 24-31 are the occupancy gauge, not a fault
HEALTH_FAULTS = 0x00FFFFFF


def unhealthy(rec) -> bool:
    return bool(rec.health & HEALTH_FAULTS) or bool(rec.recovered)


def install(state) -> capture.Patches:
    """The benchmark's wrappers around the program's stepping calls."""
    from repro_torch.core import stepper as st_mod
    patches = capture.Patches()
    orig_velocity, orig_rebuild = st_mod.fmm_velocity, st_mod.rebuild_tree

    def fmm_velocity(tree, p, **kwargs):
        if state.first_eval_of_step:
            state.first_eval_of_step = False
            state.handoff.append(state.last_out is None or tree is state.last_out)
        if state.in_stretch:
            state.descs.append(tree.mask.sum(dim=-1, dtype=torch.int32))
        if state.trace:
            state.spans.begin_group()
        out = orig_velocity(tree, p, **kwargs)
        if state.trace:
            state.spans.end_group()
        cur = state.recorder.current
        if cur is not None:
            cur["evals"].append({"tree": tree,
                                 "w": out[0] if isinstance(out, tuple) else out})
        return out

    def rebuild_tree(tree, new_z, aux=None):
        if state.trace:
            with state.spans("rebin"):
                out = orig_rebuild(tree, new_z, aux=aux)
        else:
            out = orig_rebuild(tree, new_z, aux=aux)
        state.last_out = out[0]
        cur = state.recorder.current
        if cur is not None:
            cur["rebins"].append({"tree": tree, "new_z": new_z, "aux": aux,
                                  "out": out[0], "out_aux": out[1]})
        return out

    patches.set(st_mod, "fmm_velocity", fmm_velocity)
    patches.set(st_mod, "rebuild_tree", rebuild_tree)
    if state.trace:
        capture.trace_spans(patches, state)
    return patches


def prepare(ctx):
    from repro_torch.core.stepper import VortexStepper
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    inp = traffic.lattice(cfg, tr["lattice"], ctx.seed)
    pos, (cx, cy) = inp["positions"], inp["centre"]
    r0 = np.hypot(pos[:, 0] - cx, pos[:, 1] - cy)
    sp = tr["stepper"]
    if sp.get("payload") != "r0":
        raise ValueError(f"payload {sp.get('payload')!r}: this entry carries 'r0'")
    state = types.SimpleNamespace(
        trace=bool(ctx.trace), in_stretch=False, spans=None, descs=[], handoff=[],
        last_out=None, first_eval_of_step=False, inputs=inp, dt=float(sp["dt"]),
        recorder=None)
    state.stepper = VortexStepper(
        pos, inp["gamma"], inp["sigma"], p=int(cfg["p"]), dt=float(sp["dt"]),
        plan_method=sp["plan_method"], dynamic=bool(sp["dynamic"]),
        replan_every=int(sp["replan_every"]), guard=bool(sp["guard"]),
        target_per_box=float(sp["target_per_box"]),
        slots_headroom=float(sp["slots_headroom"]), cut=int(cfg["cut_level"]),
        payload={"r0": r0 + 0j}, device=ctx.device)
    got = (state.stepper.params.level, state.stepper.params.slots, state.stepper.params.cut)
    want = (int(cfg["level"]), int(cfg["slots"]), int(cfg["cut_level"]))
    if got != want:
        raise ValueError(f"the stepper built (level, slots, cut) {got}, the "
                         f"configuration says {want}")
    state.initial = state.stepper.tree
    if ctx.trace:
        state.spans = profiling.Spans()
        state.replan_ms = []
        orig = state.stepper.maybe_replan

        def maybe_replan(*args, **kwargs):     # chip_smoke.py:timed_method
            t0 = time.perf_counter()
            with torch.profiler.record_function("VortexStepper.maybe_replan"):
                out = orig(*args, **kwargs)
            state.replan_ms.append((time.perf_counter() - t0) * 1e3)
            return out
        state.stepper.maybe_replan = maybe_replan
    state.patches = install(state)
    # warm-up: whole steps, a replan check among them, captures as in the window
    state.recorder = capture.Recorder(SAMPLED_STEPS, traffic.rng(ctx.seed, 5))
    for _ in range(int(tr["warmup_steps"])):
        _one_step(state)
    state.recorder = capture.Recorder(SAMPLED_STEPS, traffic.rng(ctx.seed, 4))
    state.handoff = []
    if ctx.trace:
        state.spans = profiling.Spans()
        profiling.Profile.warm()
        state.replan_ms = []
    capture.sync(ctx.device)
    return state


def _one_step(state):
    state.recorder.begin()
    state.first_eval_of_step = True
    with torch.profiler.record_function("fmmbench.step"):
        rec = state.stepper.step()
    state.recorder.commit()
    return rec


def window(state, ctx) -> dict:
    from repro_torch.core.stepper import StepperFaultError
    state.records, state.fault = [], None

    def one(i):
        try:
            state.records.append(_one_step(state))
        except StepperFaultError as exc:
            state.fault = str(exc)
            return False
    times, window_s = capture.closed_loop(state, ctx, one)
    bad = sum(map(unhealthy, state.records)) + (state.fault is not None)
    return {"step_s": times, "window_s": window_s,
            "attempted": len(state.records) + (state.fault is not None), "failed": bad}


def finish(state, ctx) -> dict | None:
    """Take the program's state apart from the captures; with ``--trace 1``
    read the spans, counters and profile.  Returns the trace."""
    state.final = (state.stepper.tree, state.stepper.payload)
    state.level = int(state.stepper.params.level)
    state.patches.remove()
    del state.stepper
    if not ctx.trace:
        return None
    cfg = ctx.cell.config
    descs = [{"equation": "vortex", "level": state.level, "p": int(cfg["p"]),
              "singular": False, "src_counts": c.cpu().numpy()} for c in state.descs]
    spans = {"rebin": state.spans.ms("rebin"), "expansions": state.spans.group_ms(),
             "replan": list(state.replan_ms), "p2p_kernel": state.spans.ms("p2p_kernel"),
             "m2l_kernel": state.spans.ms("m2l_kernel")}
    return state.stretch.trace(spans, descs,
                               2 * counts.kick_ops(int(cfg["num_particles"])))


def judge(state, ctx, control: bool = False) -> dict:
    """The compared numbers, each {value, limit}; ``control`` puts the
    TF32 reference in place of the program's evaluations."""
    limits = ctx.cell.spec["limits"]
    sampled = [k for k in state.recorder.kept if k is not None]
    dt, level = state.dt, state.level
    g = traffic.rng(ctx.seed, 3)
    worst = 0.0
    kick_off = rebin_off = 0
    n = int(ctx.cell.config["num_particles"])
    for cap in sampled:
        evals, rebins = cap["evals"], cap["rebins"]
        if len(evals) != 2 or len(rebins) != 2:
            kick_off += n
            continue
        for ev in evals:
            worst = max(worst, _velocity_error(ev, level, g, control))
        t0, t_mid = rebins[0]["tree"], rebins[1]["tree"]
        if evals[0]["tree"] is not t0 or evals[1]["tree"] is not t_mid \
                or rebins[0]["out"] is not t_mid:
            kick_off += n
            continue
        w1 = evals[0]["w"].to(torch.complex128)
        w2 = evals[1]["w"].to(torch.complex128)
        z0_mid = rebins[0]["out_aux"][0]
        kick_off += checks.off_by_more_than_an_ulp(
            rebins[0]["new_z"], t0.z.to(torch.complex128) + 0.5 * dt * torch.conj(w1), t0.mask)
        kick_off += checks.off_by_more_than_an_ulp(
            rebins[1]["new_z"], z0_mid.to(torch.complex128) + dt * torch.conj(w2), t_mid.mask)
        for rb in rebins:
            src, out = rb["tree"], rb["out"]
            before = checks.rows(src.mask, [rb["new_z"], src.q, *checks.leaves(rb["aux"])])
            after = checks.rows(out.mask, [out.z, out.q, *checks.leaves(rb["out_aux"])])
            rebin_off += checks.multiset_mismatch(before, after)
            rebin_off += checks.misbinned(out.z, out.mask, level)
            rebin_off += abs(int(out.mask.sum()) - n)
    inp = state.inputs
    z_in = torch.as_tensor(inp["positions"][:, 0] + 1j * inp["positions"][:, 1],
                           dtype=torch.complex64, device=ctx.device)
    q_in = torch.as_tensor(inp["gamma"] * reference.VORTEX_SCALE,
                           dtype=torch.complex64, device=ctx.device)
    init = state.initial
    start_off = checks.multiset_mismatch(
        checks.rows(init.mask, [init.z, init.q]),
        checks.rows(torch.ones_like(z_in, dtype=torch.bool), [z_in, q_in]))
    after_fault = [bool(r.releveled or r.recovered) for r in state.records]
    handoff_off = sum(1 for i, ok in enumerate(state.handoff[:len(state.records)])
                      if not ok and not (i and after_fault[i - 1]))
    faults = sum(map(unhealthy, state.records)) \
        + (state.fault is not None) + (len(state.records) == 0)
    tree, payload = state.final
    cx, cy = inp["centre"]
    m = tree.mask
    r = torch.hypot(tree.z[m].real.double() - cx, tree.z[m].imag.double() - cy)
    r0 = payload["r0"][m].real.double()
    sel = r0 > 0.02
    drift = float((r[sel] - r0[sel]).abs().max()) if bool(sel.any()) else float("inf")
    numbers = {"velocity_rel_l2": worst if sampled else float("inf"),
               "kick_off": kick_off, "rebin_off": rebin_off, "start_off": start_off,
               "handoff_off": handoff_off, "unhealthy_steps": faults,
               "orbit_drift": drift}
    return {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}


def _velocity_error(ev, level, g, control) -> float:
    tree, w = ev["tree"], ev["w"]
    live = tree.mask.reshape(-1).nonzero().squeeze(1)
    pick = live[torch.as_tensor(np.sort(g.choice(len(live), min(TARGETS, len(live)),
                                                 replace=False)), device=live.device)]
    z = tree.z.reshape(-1)
    zs, qs = z[live], tree.q.reshape(-1)[live]
    ref = reference.pair_sum("vortex", z[pick], zs, qs, tree.sigma, level)
    got = (reference.pair_sum("vortex", z[pick], zs, qs, tree.sigma, level, "tf32")
           if control else w.reshape(-1)[pick])
    return reference.rel_l2(got, ref)
