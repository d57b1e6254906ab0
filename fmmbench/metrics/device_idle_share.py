"""``device_idle_share``: the share of the profiled stretch in which no
operation ran on the card, in percent (torch.profiler; the union of the
device's busy intervals against the stretch's host-clock length)."""


def read(trace: dict):
    prof = trace.get("profile")
    if not prof or not prof.get("window_s"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
