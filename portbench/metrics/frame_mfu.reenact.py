"""A served frame's share of the card's peak: the frame's counted work (the
blend forward's pair work from the reference's pairs, and FLAME, at the
float32 peak; counts/) over the time per delivered frame of the traced
calls (their warm-up and capture included)."""

LAYER = "Served frame (models/fateavatar.py, render/)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "reenact_frames_per_s"


def read(r):
    if not r.get("trace_frames") or "ideal_frame_s" not in r:
        return None
    return 100.0 * r["ideal_frame_s"] / (r["trace_window_s"] / r["trace_frames"])
