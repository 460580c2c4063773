"""device_idle_share.serve: the share of the profiled stretch in which no
kernel or copy ran on the card (arith/timeline), in %."""


def read(rec):
    t = rec["timeline"]
    if t is None or t["busy_s"] <= 0.0 or t["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
