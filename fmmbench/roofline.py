"""Shared by ``p2p_roofline`` and ``m2l_roofline``: a kernel's bound over
its time in the profiled stretch, in percent.

The kernel's time is the profiler's device time under its name (the CUDA
events around its launches where the profiler saw none); its bound sums,
over the stretch's evaluations, max(bytes at 3.35 TB/s, operations at the
stage's rate), from ``fmmbench.counts`` on the points and occupied boxes of
each evaluation.  Nothing is read unless the launches counted in the
stretch are the ones its evaluations make.
"""
from fmmbench import counts, profiling


def roofline(trace: dict, stage: str, names: tuple, per_evaluation) -> float | None:
    stretch, prof = trace.get("stretch"), trace.get("profile")
    if not stretch or not stretch["evaluations"]:
        return None
    works = [counts.evaluation_work(d)[stage] for d in stretch["evaluations"]]
    if stretch["launches"][stage] != sum(per_evaluation(d) for d in stretch["evaluations"]):
        return None
    seconds = profiling.kernel_s(prof, *names) if prof else 0.0
    if seconds <= 0:
        seconds = sum(trace.get("spans", {}).get(f"{stage}_kernel") or []) / 1e3
    if seconds <= 0:
        return None
    if stage == "m2l":
        bound = sum(counts.bound_s(w["ops"], w["bytes"], w["rate"])
                    for work in works for w in work["levels"])
    else:
        bound = sum(counts.bound_s(w["ops"], w["bytes"], w["rate"]) for w in works)
    return 100.0 * bound / seconds
