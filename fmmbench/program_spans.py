"""The program's own spans, for the per-layer readers that read them.

The port records its stage spans (``repro_torch/spans.py``) while
torch.profiler runs, so a traced run's profiled stretch leaves them in the
program's recorder.  :func:`window` takes them from there once, as plain
dicts (the record's fields and its ``host_ms``), and keeps them in the
trace under ``program_spans`` for the readers after it; a trace that
already carries ``program_spans`` is read as it is.  It returns None where
the program has no recorder (a checkout before it) or recorded nothing.
"""
from __future__ import annotations

import dataclasses


def _take():
    try:
        from repro_torch import spans
    except ImportError:
        return None
    return [dict(dataclasses.asdict(r), host_ms=r.host_ms) for r in spans.take()]


def window(trace: dict):
    """The span records of the traced window, or None."""
    if "program_spans" not in trace:
        trace["program_spans"] = {"window": _take()}
    return (trace["program_spans"] or {}).get("window") or None


def per_evaluation_ms(trace: dict, names) -> float | None:
    """CUDA-event ms of the spans named ``names``, summed over the timed
    roots of the window (the program times its device spans in one root of
    every few) and divided by their ``fmm.evaluate`` spans (one an
    evaluation); None where either is missing or a span has no device
    time."""
    recs = [r for r in window(trace) or () if r.get("timed")]
    evaluations = sum(r["name"] == "fmm.evaluate" for r in recs)
    ms = [r["device_ms"] for r in recs if r["name"] in names]
    if not evaluations or not ms or None in ms:
        return None
    return sum(ms) / evaluations
