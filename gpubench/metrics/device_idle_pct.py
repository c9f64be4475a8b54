"""device_idle_pct: the share of the traced window in which no kernel,
copy or set ran on the card, from ``torch.profiler``'s device trace
(CUPTI)."""
LAYER = "device"
MOVES = "fit_s"
UNIT = "%"


def read(record):
    trace = record.get("trace")
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
