"""Profiling / tracing helpers.

Port of ``fateavatar_tpu/utils/profiling.py``. The reference's perf tooling
is wall-clock only (tools/util.py:235 measure_fps, CUDA events in
tools/gui.py:643-699). The JAX package standardizes on ``jax.profiler``
traces plus phase timers; here the trace is ``torch.profiler`` (CPU and
CUDA activity, written as a Chrome trace), a named region is
``torch.profiler.record_function``, and the timers fence with
``torch.cuda.synchronize()`` where JAX blocks until ready.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


def _fence():
    """Wait for the card's queued work: ``block_until_ready``'s
    counterpart. A no-op where CUDA is not initialized (CPU tensors are
    computed when the call returns)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace (CPU and, where there is a card, CUDA
    activity) and write it to ``log_dir/trace.json`` (Chrome / Perfetto).
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _fence()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named region inside a trace (shows up on the timeline)."""
    return torch.profiler.record_function(name)


class PhaseTimer:
    """Accumulating wall-clock phase timer with CUDA synchronize fencing."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, fence=None):
        t0 = time.perf_counter()
        yield
        if fence is not None:     # an output of the phase: wait for the card
            _fence()
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} {total:8.3f}s total  {1e3*total/max(n,1):8.2f} ms/call  x{n}")
        return "\n".join(lines)


def time_fn(fn, *args, warmup: int = 2, iters: int = 10):
    """Robust device timing of a callable: warmup, fence, repeat. Returns
    seconds per call."""
    for _ in range(warmup):
        fn(*args)
    _fence()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _fence()
    return (time.perf_counter() - t0) / iters
