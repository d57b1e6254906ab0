"""``rebin_ms``: CUDA-event milliseconds per ``rebuild_tree`` call, the
mean over every rebin of the traced window (two a step)."""


def read(trace: dict):
    ms = trace.get("spans", {}).get("rebin") or []
    return sum(ms) / len(ms) if ms else None
