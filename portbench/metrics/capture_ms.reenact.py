"""Host milliseconds per ``Reenactor.reenact`` call spent in the served
frame's graph warm-up and capture: a span from the harness, synchronized at
both ends, around ``Graph.capture`` in the trace run's window."""

LAYER = "Reenactor and graphs (train/loader.py, utils/graphs.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "clip_ms_p90"


def read(r):
    return r.get("capture_ms")
