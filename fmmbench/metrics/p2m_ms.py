"""``p2m_ms``: CUDA-event milliseconds an evaluation in the program's
``fmm.p2m`` span (``core/fmm.py:upward_sweep``: the leaf multipole
expansions, their power table among them), the mean over the timed evaluations
of the profiled stretch (one root in every few)."""
from fmmbench import program_spans


def read(trace: dict):
    return program_spans.per_evaluation_ms(trace, ("fmm.p2m",))
