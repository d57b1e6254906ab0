"""``expansions_ms``: CUDA-event milliseconds an evaluation in the
expansion stages (``fmm.upward_sweep``: P2M and M2M; each L2L; L2P), the
mean over the evaluations of the traced window."""


def read(trace: dict):
    ms = trace.get("spans", {}).get("expansions") or []
    return sum(ms) / len(ms) if ms else None
