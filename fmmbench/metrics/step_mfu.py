"""``step_mfu``: the least time of a step's counted work over the measured
step time, in percent.  The counted work is every stage of the step's
evaluations (``fmmbench.counts.evaluation_work``: P2M, M2M, M2L, L2L, L2P,
P2P) and its kicks, each at the fastest rate the card has for it at f32
accuracy (M2L's products as three TF32 passes, the rest FP32); the step
time is the host clock's mean over the traced window's steps outside the
profiled stretch."""
from fmmbench import counts


def read(trace: dict):
    stretch, step_s = trace.get("stretch"), trace.get("step_s") or []
    if not stretch or not stretch["evaluations"] or not stretch["steps"]:
        return None
    least = sum(counts.least_time_s(counts.evaluation_work(d))
                for d in stretch["evaluations"]) / stretch["steps"]
    least += trace.get("kick_ops_per_step", 0) / counts.FP32_FLOP_PER_S
    a = trace.get("stretch_start", 0)
    outside = [s for i, s in enumerate(step_s)
               if not a <= i < a + stretch["steps"]] or step_s
    if not outside:
        return None
    return 100.0 * least / (sum(outside) / len(outside))
