"""One function captured as a CUDA graph and replayed.

The JAX package runs a training epoch as one compiled program (``lax.scan``
over the frames) and a served frame as one jitted program. PyTorch runs
eagerly, one launch per operation; the counterpart is a CUDA graph: the
launches of one call recorded once and replayed as a unit.

:class:`Graph` owns a function of no arguments that reads and writes only
tensors whose storage outlives it (its static buffers: the inputs it reads,
the outputs it writes, the state it updates in place). On a CUDA device the
first call warms the function up on a side stream (cuDNN's algorithm choice,
the blend kernels' scratch and occupancy queries and the losses' cached
constants happen there, outside the capture), putting the buffers back as
they were after each warm-up call, captures one call into a private memory
pool, and replays it; every later call replays. On the CPU a
call runs the function itself on the same buffers: the plain version, as
each CUDA kernel has one. A capture that fails raises; nothing falls back to
eager execution on the card.

Tracing (``utils/profiling.py``): a capture is the span ``graph.capture``
and adds to the counters ``graph.captures`` and ``graph.capture_s`` (host
seconds of warm-up, capture and instantiation); a call is the span
``graph.replay``. A graph captured with tracing on holds the stage marks
its function makes (its warm-up calls make none), so each replay stamps
them; one captured with tracing off holds none.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import torch

from fateavatar_tpu_torch.render.render import KERNEL_COUNTERS
from fateavatar_tpu_torch.utils import profiling

WARMUP = 3   # eager calls on a side stream before the capture


class Graph:
    """``fn()`` as a CUDA graph over ``buffers``.

    ``buffers``: every tensor ``fn`` updates in place; the warm-up calls'
    updates are undone before the capture, so the first replay starts from
    the state the caller left. The port's kernel wrappers count their
    launches while the graph is captured, not when it replays, so the
    capture's increments are recorded as ``launches_per_replay`` (kernel
    name -> launches), and ``replays`` counts the calls."""

    def __init__(self, fn: Callable[[], None], buffers: Sequence[torch.Tensor], name: str):
        self.fn = fn
        self.buffers = list(buffers)
        self.name = name
        self.device = self.buffers[0].device
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"graph {name}: runs on cuda or cpu, not {self.device}")
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.replays = 0
        self.launches_per_replay: dict = {}

    def __call__(self):
        if self.device.type == "cuda" and self.graph is None:
            self.capture()
        with profiling.span("graph.replay", graph=self.name):
            if self.graph is None:
                self.fn()
            else:
                self.graph.replay()
        self.replays += 1

    def capture(self):
        """Warm up (the buffers restored after each call), then capture.
        Raises, naming the graph, when the capture fails."""
        t0 = time.perf_counter()
        with profiling.span("graph.capture", graph=self.name):
            self._capture()
        profiling.count("graph.captures")
        profiling.count("graph.capture_s", time.perf_counter() - t0)

    def _capture(self):
        # the stage ring and the mark kernel cannot be made inside a capture
        profiling.prepare(self.device)
        # no_grad: a buffer may be a parameter that requires grad
        with torch.no_grad():
            saved = [b.clone() for b in self.buffers]
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        # the warm-up calls make no stage marks: only the replays are timed
        with torch.cuda.stream(side), profiling.tracing(False):
            for _ in range(WARMUP):
                self.fn()
                # each warm-up call starts from the caller's state
                with torch.no_grad():
                    for b, v in zip(self.buffers, saved):
                        b.copy_(v)
        main.wait_stream(side)
        del saved
        before = {k: c.launches for k, c in KERNEL_COUNTERS.items()}
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                self.fn()
        except Exception as err:   # any failure of the capture: name the graph
            raise RuntimeError(f"CUDA graph capture of {self.name} failed: {err}") from err
        self.launches_per_replay = {k: c.launches - before[k]
                                    for k, c in KERNEL_COUNTERS.items()
                                    if c.launches != before[k]}
        self.graph = graph
