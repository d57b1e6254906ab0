"""``l2p_ms``: CUDA-event milliseconds an evaluation in the program's
``fmm.l2p`` span (``core/fmm.py:fmm_evaluate``: the leaf local expansions
at the targets, their power table among them), the mean over the
timed evaluations of the profiled stretch (one root in every few)."""
from fmmbench import program_spans


def read(trace: dict):
    return program_spans.per_evaluation_ms(trace, ("fmm.l2p",))
