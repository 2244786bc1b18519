"""Host milliseconds a ``Reenactor.reenact`` call of the window spends in
its served frame's graph warm-up, capture and instantiation, as the program
times it: the mean of the adds to its counter ``graph.capture_s``
(``utils/graphs.Graph.capture``, no synchronize of its own; one capture a
call) over the window's calls (``clips``). Set-up's call, before the
window, and the traced call after it are left out. Nothing where the
program keeps no such history or captured no graph (the CPU)."""

import sys

LAYER = "Reenactor and graphs (train/loader.py, utils/graphs.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "clip_ms_p90"


def read(r):
    from portbench.drivers.reenact import TRACE_CLIPS

    history = getattr(sys.modules.get("fateavatar_tpu_torch.utils.profiling"), "history", None)
    n = r.get("clips")
    if history is None or not n:
        return None
    h = history("graph.capture_s")
    if len(h) < n + TRACE_CLIPS:
        return None
    window = h[len(h) - n - TRACE_CLIPS:len(h) - TRACE_CLIPS]
    return 1e3 * sum(window) / n
