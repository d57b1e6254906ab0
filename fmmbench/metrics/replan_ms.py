"""``replan_ms``: host milliseconds per ``VortexStepper.maybe_replan``
call (the occupancy guard, the counts pulled to the host and the plan's
balance; one call every ``replan_every`` steps), the mean over the traced
window."""


def read(trace: dict):
    ms = trace.get("spans", {}).get("replan") or []
    return sum(ms) / len(ms) if ms else None
