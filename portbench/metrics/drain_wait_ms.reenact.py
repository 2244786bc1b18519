"""Host milliseconds a ``Reenactor.reenact`` call of the window spends
bringing its served frames to the host once they are done on the card (the
ring copies to pageable memory, ``DRAIN`` frames each), as the program
times it: the mean of the adds to its counter ``reenact.drain_s`` (one a
call, ``train/loader.py``) over the window's calls (``clips``). Set-up's
call, before the window, and the traced call after it are left out.
Nothing where the program keeps no such history."""

import sys

LAYER = "Reenactor and graphs (train/loader.py, utils/graphs.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "reenact_frames_per_s"


def read(r):
    from portbench.drivers.reenact import TRACE_CLIPS

    history = getattr(sys.modules.get("fateavatar_tpu_torch.utils.profiling"), "history", None)
    n = r.get("clips")
    if history is None or not n:
        return None
    h = history("reenact.drain_s")
    if len(h) < n + TRACE_CLIPS:
        return None
    window = h[len(h) - n - TRACE_CLIPS:len(h) - TRACE_CLIPS]
    return 1e3 * sum(window) / n
