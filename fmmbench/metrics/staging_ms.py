"""``staging_ms``: CUDA-event milliseconds an evaluation in the program's
staging spans: ``m2l.stage`` (the ghost rows of ``ops.m2l_apply``; the
slicing and the parent-plane relayout of ``expansions.m2l_folded``) and
``m2l.unstage`` (the layout back, the crop and the scale) at every level,
and ``p2p.stage`` (the halo pads of ``fmm.near_field``); the mean over the
timed evaluations of the profiled stretch (one root in every few)."""
from fmmbench import program_spans


def read(trace: dict):
    return program_spans.per_evaluation_ms(trace, ("m2l.stage", "m2l.unstage", "p2p.stage"))
