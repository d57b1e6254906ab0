"""``stepper_self_ms``: host milliseconds a step in the program's
``stepper.step`` span outside its children ``stepper.rk2`` (issuing
``rk2_step``) and ``stepper.wait`` (the sync and the health word's copy):
the stepper's own host work, the replan check among it, the mean over the
steps of the profiled stretch."""
from fmmbench import program_spans


def read(trace: dict):
    recs = program_spans.window(trace)
    steps = [r for r in recs or () if r["name"] == "stepper.step"]
    if not steps:
        return None
    inner: dict = {}
    for r in recs:
        if r["name"] in ("stepper.rk2", "stepper.wait"):
            inner[r["parent"]] = inner.get(r["parent"], 0.0) + r["host_ms"]
    return sum(s["host_ms"] - inner.get(s["id"], 0.0) for s in steps) / len(steps)
