"""The readers of the program's spans: ``p2m_ms``, ``l2p_ms``, ``staging_ms``,
``stepper_self_ms`` (``fmmbench/program_spans.py``).

On hand-built traces, each reads its number and returns None where its
spans are missing; on the small cells on the CPU, they read the records
that the program leaves in its recorder while torch.profiler runs, as a
traced run's profiled stretch does on the card.
"""
from __future__ import annotations

import pytest

from fmmbench import manifest, program_spans
from fmmbench.tests import tiny

READERS = ("p2m_ms", "l2p_ms", "staging_ms", "stepper_self_ms")


def reader(name):
    return manifest.load_module(tiny.ROOT, "metrics", name)


def rec(name, i, parent=None, root=None, host_ms=0.0, device_ms=None, level=None,
        timed=True):
    return {"name": name, "id": i, "parent": parent, "root": root or i, "timed": timed,
            "host_ms": host_ms, "device_ms": device_ms, "level": level}


def evaluation(first: int, root: int, parent: int, scale: float = 1.0) -> list:
    """One evaluation's spans at level 3, ids from ``first``: device time
    on the device spans only, as the program records them."""
    e = first
    out = [rec("fmm.evaluate", e, parent, root, host_ms=50.0 * scale),
           rec("fmm.p2m", e + 1, e, root, device_ms=10.0 * scale),
           rec("fmm.m2m", e + 2, e, root, host_ms=1.0 * scale),
           rec("fmm.l2p", e + 3, e, root, device_ms=6.0 * scale),
           rec("fmm.p2p", e + 4, e, root, host_ms=0.5 * scale),
           rec("p2p.stage", e + 5, e + 4, root, device_ms=0.1 * scale)]
    i = e + 6
    for level in (2, 3):
        m = i
        out += [rec("fmm.m2l", m, e, root, host_ms=1.0 * scale, level=level),
                rec("m2l.stage", m + 1, m, root, device_ms=0.2 * scale, level=level),
                rec("m2l.stage", m + 2, m, root, device_ms=0.3 * scale, level=level),
                rec("m2l.unstage", m + 3, m, root, device_ms=0.4 * scale, level=level)]
        i += 4
    return out


def two_steps() -> list:
    """Two stepper steps, the second with a replan check, each with two
    evaluations under ``stepper.rk2``."""
    out = []
    for s, (step_ms, rk2_ms, wait_ms, replan_ms) in enumerate(
            ((120.0, 30.0, 88.0, 0.0), (180.0, 30.0, 90.0, 58.0))):
        root = 1000 * (s + 1)
        out += [rec("stepper.step", root, host_ms=step_ms),
                rec("stepper.rk2", root + 1, root, root, host_ms=rk2_ms),
                rec("stepper.wait", root + 2, root, root, host_ms=wait_ms)]
        if replan_ms:
            out.append(rec("stepper.replan", root + 3, root, root, host_ms=replan_ms))
        out += evaluation(root + 10, root, root + 1)
        out += evaluation(root + 40, root, root + 1, scale=2.0)
    return out


def test_readers_on_a_hand_built_trace():
    trace = {"program_spans": {"window": two_steps()}}
    got = {name: reader(name).read(trace) for name in READERS}
    assert got["p2m_ms"] == pytest.approx((10 + 20) * 2 / 4)
    assert got["l2p_ms"] == pytest.approx((6 + 12) * 2 / 4)
    # two levels of (0.2 + 0.3 + 0.4) and the halo pads, at scales 1 and 2
    assert got["staging_ms"] == pytest.approx((2 * 0.9 + 0.1) * 3 * 2 / 4)
    assert got["stepper_self_ms"] == pytest.approx(((120 - 118) + (180 - 120)) / 2)


def test_the_device_readers_read_the_timed_roots_alone():
    """The program times the device spans of one root in every few: an
    untimed root's evaluations count in no device reader's mean."""
    untimed = evaluation(101, 101, None, scale=5.0)
    for r in untimed:
        r["timed"], r["device_ms"] = False, None
    trace = {"program_spans": {"window": evaluation(1, 1, None) + untimed
                               + evaluation(201, 201, None, scale=2.0)}}
    assert reader("p2m_ms").read(trace) == pytest.approx((10 + 20) / 2)
    assert reader("staging_ms").read(trace) == pytest.approx(1.9 * 3 / 2)


def test_an_evaluation_alone_has_no_stepper_self_time():
    trace = {"program_spans": {"window": evaluation(1, 1, None)}}
    assert reader("p2m_ms").read(trace) == pytest.approx(10.0)
    assert reader("staging_ms").read(trace) == pytest.approx(1.9)
    assert reader("stepper_self_ms").read(trace) is None


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("spans", [None, {"window": None}, {"window": []},
                                   {"window": [rec("other.span", 1, host_ms=1.0)]}])
def test_each_reader_returns_none_without_its_spans(name, spans):
    assert reader(name).read({"program_spans": spans}) is None


@pytest.mark.parametrize("name", ("p2m_ms", "l2p_ms", "staging_ms"))
def test_a_device_reader_returns_none_where_a_span_has_no_device_time(name):
    recs = evaluation(1, 1, None)
    for r in recs:
        r["device_ms"] = None
    assert reader(name).read({"program_spans": {"window": recs}}) is None


def test_readers_without_the_key_take_the_programs_records_once():
    """A trace without ``program_spans`` is filled from the program's
    recorder (empty here: every reader gives None), once for all readers."""
    from repro_torch import spans
    spans.take()
    trace = {"spans": {}}
    assert all(reader(name).read(trace) is None for name in READERS)
    assert trace["program_spans"] == {"window": []}


@pytest.mark.parametrize("name", ("vortex_rk2", "vortex_probe_eval"))
def test_small_cells_under_the_profiler_leave_spans_the_readers_read(name):
    """The small cell's set-up and window on the CPU, under torch.profiler
    as the card's profiled stretch is: the readers find every step and
    evaluation.  On the CPU no span has device time, so the device readers
    give None; ``stepper_self_ms`` reads the host clock."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import spans
    spans.take()
    with profile(activities=[ProfilerActivity.CPU]):
        res = tiny.run_small(name, seconds=0.3)
    assert res["correct"], res["checks"]
    trace = {"spans": {}}
    recs = program_spans.window(trace)
    names = {r["name"] for r in recs}
    assert {"fmm.evaluate", "fmm.p2m", "fmm.l2p", "m2l.stage", "m2l.unstage",
            "p2p.stage", "quadtree.build_tree"} <= names
    assert all(r["device_ms"] is None for r in recs)
    for metric in ("p2m_ms", "l2p_ms", "staging_ms"):
        assert reader(metric).read(trace) is None
    self_ms = reader("stepper_self_ms").read(trace)
    if name == "vortex_rk2":
        assert "stepper.replan" in names and "stepper.build" in names
        steps = [r for r in recs if r["name"] == "stepper.step"]
        assert len(steps) >= len(res["window"]["step_s"])
        assert 0 < self_ms < max(r["host_ms"] for r in steps)
    else:
        assert self_ms is None
    assert spans.take() == []
