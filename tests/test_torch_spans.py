"""The span recorder (``repro_torch/spans.py``) and the spans of the stepper,
the FMM driver and the set-up.

On the CPU: off, a span records nothing and makes no CUDA event and no
profiler range; on (or under ``torch.profiler``), a stepper step and an
evaluation record the span tree that the benchmark's readers and PERF.md
name; results are bit for bit the same either way; the lint, the
``rk2_step`` contracts and the benchmark's module-attribute wrappers work
with spans on; only the five spans that a reader times are device spans;
a running profiler's records are bounded.  The ``gpu`` case reads
CUDA-event times, their pool, and the profiler's ranges on the card.
"""
import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.analysis import check as CK
from repro_torch.analysis import lint as L
from repro_torch.core import fmm, quadtree
from repro_torch.core import stepper as stp

LEVEL, P = 3, 6


@pytest.fixture(autouse=True)
def _clean_recorder():
    """Each test starts and ends with the recorder off and empty."""
    spans.disable()
    spans.take()
    yield
    spans.disable()
    spans.take()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lattice(per_side=3, seed=0):
    """``per_side**2`` particles per leaf box of a level-3 grid, inside it."""
    n, h = 1 << LEVEL, quadtree.box_size(LEVEL)
    offs = np.linspace(0.3, 0.7, per_side)
    x = ((np.arange(n)[:, None] + offs[None, :]) * h).ravel()
    X, Y = np.meshgrid(x, x, indexing="xy")
    pos = np.stack([X.ravel(), Y.ravel()], axis=1)
    return pos, 0.01 * np.random.default_rng(seed).normal(size=len(pos))


def _stepper(**kw):
    pos, gamma = _lattice()
    r0 = np.hypot(pos[:, 0] - 0.5, pos[:, 1] - 0.5)
    args = dict(p=P, dt=0.01, target_per_box=9.0, slots_headroom=1.5,
                replan_every=1, dynamic=True, payload={"r0": r0 + 0j},
                device="cpu")
    args.update(kw)
    return stp.VortexStepper(pos, gamma, 0.02, **args)


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def _children(records, rec):
    return [r for r in records if r.parent == rec.id]


# ---------------------------------------------------------------------------
# off
# ---------------------------------------------------------------------------


def test_off_a_span_records_nothing_and_makes_no_event_or_range(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("made while tracing is off")
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(spans, "_range", refuse)
    ctx = spans.span("fmm.p2m", device=torch.device("cuda", 0), level=3)
    assert ctx is spans.span("stepper.step")        # one shared null context
    with ctx:
        pass
    st = _stepper()
    st.step()
    tree, _ = quadtree.build_tree(*_lattice(), LEVEL, 0.02, device="cpu")
    fmm.fmm_velocity(tree, P, device="cpu")
    assert spans.take() == []


def test_a_traced_function_is_one_host_span_and_unchanged_off():
    @spans.traced("test.whole")
    def whole(a, b=2):
        """doc"""
        with spans.span("test.inner"):
            return a + b
    assert whole.__name__ == "whole" and whole.__doc__ == "doc"
    assert whole(1) == 3 and spans.take() == []
    spans.enable()
    assert whole(1, b=5) == 6
    outer, inner = spans.take()
    assert (outer.name, inner.name) == ("test.whole", "test.inner")
    assert inner.parent == outer.id and outer.device_ms is None


# ---------------------------------------------------------------------------
# device spans
# ---------------------------------------------------------------------------

# the spans whose CUDA-event time a benchmark reader uses; the rest are
# host spans and record no event
DEVICE_SPANS = {"fmm.p2m", "fmm.l2p", "m2l.stage", "m2l.unstage", "p2p.stage"}


def test_one_root_in_every_few_is_timed_and_its_spans_with_it():
    tree, _ = quadtree.build_tree(*_lattice(), LEVEL, 0.02, device="cpu")
    spans.enable()
    for _ in range(2 * spans.TIMED_EVERY):
        fmm.fmm_velocity(tree, P, device="cpu")
    recs = spans.take()
    roots = {r.id: r for r in recs if r.parent is None}
    assert len(roots) == 2 * spans.TIMED_EVERY
    assert sum(r.timed for r in roots.values()) == 2
    assert all(r.timed == roots[r.root].timed for r in recs)


def test_only_the_spans_a_reader_times_are_given_a_device(monkeypatch):
    given = {}
    init = spans._Span.__init__

    def seen(self, name, device, level):
        given.setdefault(name, set()).add(device is not None)
        init(self, name, device, level)
    monkeypatch.setattr(spans._Span, "__init__", seen)
    st = _stepper()
    spans.enable()
    st.step()
    spans.take()
    assert {n for n, d in given.items() if True in d} == DEVICE_SPANS
    assert all(d == {True} for n, d in given.items() if n in DEVICE_SPANS)


# ---------------------------------------------------------------------------
# the span tree
# ---------------------------------------------------------------------------


def test_set_up_records_the_build_the_binning_and_the_plan():
    spans.enable()
    _stepper()
    recs = spans.take()
    names = _by_name(recs)
    (build,) = names["stepper.build"]
    assert build.parent is None and build.root == build.id
    for child in ("quadtree.build_tree", "stepper.plan"):
        (c,) = names[child]
        assert c.parent == build.id and c.root == build.id
        assert build.t0_ns <= c.t0_ns <= c.t1_ns <= build.t1_ns
    assert all(r.device_ms is None for r in recs)


def _check_evaluation(recs, ev):
    """The stage spans under one ``fmm.evaluate`` record (health word on)."""
    kids = _by_name(_children(recs, ev))
    assert sorted(kids) == ["fmm.health", "fmm.l2l", "fmm.l2p", "fmm.m2l", "fmm.m2m",
                            "fmm.p2m", "fmm.p2p"]
    assert [r.level for r in kids["fmm.m2l"]] == list(range(2, LEVEL + 1))
    assert [r.level for r in kids["fmm.l2l"]] == list(range(3, LEVEL + 1))
    for m2l in kids["fmm.m2l"]:
        staged = _children(recs, m2l)
        # the ghost rows (ops.m2l_apply), then the slicing and the parent
        # planes (expansions.m2l_folded), then the layout back
        assert [r.name for r in staged] == ["m2l.stage", "m2l.stage", "m2l.unstage"]
        assert all(r.level == m2l.level for r in staged)
    (p2p,) = kids["fmm.p2p"]
    assert [r.name for r in _children(recs, p2p)] == ["p2p.stage"]
    for r in _children(recs, ev):
        assert ev.t0_ns <= r.t0_ns <= r.t1_ns <= ev.t1_ns


def test_a_step_records_the_stepper_rk2_and_fmm_spans():
    st = _stepper()
    spans.enable()
    st.step()
    recs = spans.take()
    names = _by_name(recs)
    (step,) = names["stepper.step"]
    assert step.parent is None and all(r.root == step.id for r in recs)
    top = [r.name for r in _children(recs, step)]
    assert top == ["stepper.rk2", "stepper.wait", "stepper.replan"]
    (rk2,) = names["stepper.rk2"]
    assert [r.name for r in _children(recs, rk2)] == [
        "fmm.evaluate", "rk2.kick", "rk2.rebin", "fmm.evaluate", "rk2.kick",
        "rk2.rebin", "rk2.health"]
    for ev in names["fmm.evaluate"]:
        assert ev.parent == rk2.id
        _check_evaluation(recs, ev)
    (replan,) = names["stepper.replan"]
    assert [r.name for r in _children(recs, replan)] == [
        "replan.counts", "replan.balance", "replan.plan"]
    # self time: the step outside its compute and its wait, the replan
    # check inside it
    inner = sum(r.host_ms for r in _children(recs, step)
                if r.name in ("stepper.rk2", "stepper.wait"))
    self_ms = step.host_ms - inner
    assert replan.host_ms <= self_ms <= step.host_ms
    assert all(r.device_ms is None for r in recs)        # no card: no events


def test_an_evaluation_called_alone_is_its_own_root():
    tree, _ = quadtree.build_tree(*_lattice(), LEVEL, 0.02, device="cpu")
    spans.enable()
    fmm.fmm_velocity(tree, P, device="cpu", with_health=True)
    recs = spans.take()
    (ev,) = _by_name(recs)["fmm.evaluate"]
    assert ev.parent is None and ev.root == ev.id
    assert all(r.root == ev.id for r in recs)
    _check_evaluation(recs, ev)


def test_the_recovery_and_the_checkpoint_have_their_spans(tmp_path):
    from repro_torch.core.faults import FaultInjector, FaultSpec
    inj = FaultInjector(FaultSpec(site="teleport", step=1, magnitude=0.6))
    st = _stepper(faults=inj, checkpoint_dir=str(tmp_path), checkpoint_every=1)
    spans.enable()
    rec = st.step()
    st.wait_checkpoint()
    assert rec.recovered
    names = _by_name(spans.take())
    (step,) = names["stepper.step"]
    for name in ("stepper.recover", "stepper.checkpoint"):
        (r,) = names[name]
        assert r.parent == step.id


def test_under_the_profiler_spans_are_recorded_and_open_ranges():
    """With the recorder off, a running torch.profiler still gets the
    spans: as records, and as ranges of the same names on its timeline."""
    from torch.profiler import ProfilerActivity, profile
    tree, _ = quadtree.build_tree(*_lattice(), LEVEL, 0.02, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fmm.fmm_velocity(tree, P, device="cpu")
    recs = spans.take()
    assert "fmm.p2m" in {r.name for r in recs}
    ranges = {e.name for e in prof.events()}
    assert {"fmm.evaluate", "fmm.p2m", "fmm.m2l", "m2l.stage", "p2p.stage"} <= ranges
    fmm.fmm_velocity(tree, P, device="cpu")             # the profiler has stopped
    assert spans.take() == []


def test_under_the_profiler_alone_the_records_are_bounded(monkeypatch):
    """A profile that nobody takes from holds at most ``HELD`` records; its
    ranges are all opened still.  The enabled recorder has no bound."""
    from torch.profiler import ProfilerActivity, profile
    monkeypatch.setattr(spans, "HELD", 5)
    tree, _ = quadtree.build_tree(*_lattice(), LEVEL, 0.02, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fmm.fmm_velocity(tree, P, device="cpu")
        fmm.fmm_velocity(tree, P, device="cpu")
    recs = spans.take()
    assert len(recs) == 5
    assert [e.name for e in prof.events()].count("fmm.evaluate") == 2
    assert [e.name for e in prof.events()].count("fmm.l2p") == 2
    spans.enable()
    fmm.fmm_velocity(tree, P, device="cpu")
    assert len(spans.take()) > 5


# ---------------------------------------------------------------------------
# nothing else changes
# ---------------------------------------------------------------------------


def _run_steps(on: bool, n=3):
    st = _stepper()
    if on:
        spans.enable()
    recs = [st.step() for _ in range(n)]
    spans.disable()
    return st, recs


def test_outputs_tree_and_health_are_bit_identical_with_spans_on_and_off():
    off, recs_off = _run_steps(False)
    on, recs_on = _run_steps(True)
    assert spans.take()
    for a, b in ((off.tree.z, on.tree.z), (off.tree.q, on.tree.q),
                 (off.tree.mask, on.tree.mask), (off.payload["r0"], on.payload["r0"])):
        assert torch.equal(a, b)
    assert [(r.step, r.health, r.replanned, r.releveled, r.level, r.recovered)
            for r in recs_off] == [(r.step, r.health, r.replanned, r.releveled,
                                    r.level, r.recovered) for r in recs_on]
    tree, _ = quadtree.build_tree(*_lattice(), LEVEL, 0.02, device="cpu")
    w_off, h_off = fmm.fmm_velocity(tree, P, device="cpu", with_health=True)
    spans.enable()
    w_on, h_on = fmm.fmm_velocity(tree, P, device="cpu", with_health=True)
    assert torch.equal(w_off, w_on) and torch.equal(h_off, h_on)


def test_lint_and_the_rk2_step_contracts_pass_with_spans_on():
    import repro_torch
    from pathlib import Path
    spans.enable()
    findings = L.run_lint(Path(repro_torch.__file__).parent)
    assert findings == [], L.format_findings(findings)
    summary = CK.run("cpu", quick=True, skip=("schedule", "retrace"))
    assert summary["contracts"]["checked"] > 0
    assert sum(s.get("violations", 0) for s in summary.values()) == 0, summary
    assert "rk2.rebin" in {r.name for r in spans.take()}


def test_the_benchmarks_module_wrappers_still_see_every_call(monkeypatch):
    """A wrapper set as ``stepper.rebuild_tree`` or ``fmm.upward_sweep``
    (what the benchmark does) sees the calls inside the spans."""
    seen = {"rebuild_tree": 0, "upward_sweep": 0}

    def counted(name, orig):
        def call(*args, **kwargs):
            seen[name] += 1
            return orig(*args, **kwargs)
        return call
    monkeypatch.setattr(stp, "rebuild_tree", counted("rebuild_tree", stp.rebuild_tree))
    monkeypatch.setattr(fmm, "upward_sweep", counted("upward_sweep", fmm.upward_sweep))
    st = _stepper()
    spans.enable()
    st.step()
    assert seen == {"rebuild_tree": 2, "upward_sweep": 2}
    names = _by_name(spans.take())
    assert len(names["rk2.rebin"]) == 2 and len(names["fmm.p2m"]) == 2


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_device_spans_time_the_card_and_show_in_the_profile(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(spans, "TIMED_EVERY", 1)
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda", 0)
    tree, _ = CK.fmm_fixture(5, 12, n=20000, device=dev)
    fmm.fmm_velocity(tree, 12, device=dev)                  # builds the kernels
    torch.cuda.synchronize()
    spans.enable()
    whole = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    whole[0].record()
    fmm.fmm_velocity(tree, 12, device=dev, with_health=True)
    whole[1].record()
    recs = spans.take()
    timed = [r for r in recs if r.device_ms is not None]
    assert {r.name for r in timed} == DEVICE_SPANS
    assert all(r.device_ms > 0 for r in timed)
    # the device spans do not overlap: together they fit in the evaluation
    assert sum(r.device_ms for r in timed) <= whole[0].elapsed_time(whole[1]) * 1.01
    # a second evaluation reuses the pooled events: it creates none
    made = []

    class Counted(torch.cuda.Event):
        def __new__(cls, *args, **kwargs):
            made.append(1)
            return super().__new__(cls, *args, **kwargs)
    original = torch.cuda.Event
    torch.cuda.Event = Counted
    try:
        fmm.fmm_velocity(tree, 12, device=dev)
    finally:
        torch.cuda.Event = original
    assert len([r for r in spans.take() if r.device_ms is not None]) == len(timed)
    assert made == []
    spans.disable()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fmm.fmm_velocity(tree, 12, device=dev)
        torch.cuda.synchronize()
    assert {"fmm.p2m", "fmm.l2p"} <= {r.name for r in spans.take()}
    events = list(prof.events())
    assert {"fmm.evaluate", "fmm.p2m", "m2l.stage"} <= {e.name for e in events}
    # a range never shows on the device's timeline as work: where the build
    # puts it there at all, it is an annotation
    on_card = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name.startswith(("fmm.", "m2l.", "p2p."))]
    assert all(getattr(e, "is_user_annotation", False) for e in on_card), \
        [(e.name, getattr(e, "is_user_annotation", None)) for e in on_card[:4]]
