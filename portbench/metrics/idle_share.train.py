"""The share of the traced training replays' window in which no kernel,
copy or fill ran on the card (the union of the profiler's device
intervals)."""

LAYER = "Device (one H100)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_steps_per_s"


def read(r):
    if not r.get("trace_window_s"):
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["trace_window_s"])
