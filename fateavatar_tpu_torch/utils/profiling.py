"""The port's tracing: spans, counters and device stage marks.

Port of ``fateavatar_tpu/utils/profiling.py``, which standardizes on
``jax.profiler`` traces; here the trace is ``torch.profiler`` (CPU and CUDA
activity, written as a Chrome trace by :func:`trace`). Every hot path of the
port is a CUDA graph replay (``utils/graphs.py``), and a host-side range
(``record_function``) does not reach inside a replay, so the program
carries three kinds of record:

* **Spans** (:func:`span`): named host intervals at the layer boundaries
  (``graph.capture``, ``reenact.call``, ...), each with
  its parent span and its ids (the epoch, the ``reenact`` call). With
  tracing on, a span opens ``record_function("fa." + name)``, so it lands on
  the profiler's clock beside the device trace, and keeps an in-memory
  record (:func:`spans`). With tracing off it is one bool check and a null
  context.
* **Counters** (:data:`COUNTERS`): host-side adds of ints and floats at the
  same boundaries, always on, never synchronizing; :func:`counters` takes a
  snapshot, or the deltas since one, and :func:`history` a counter's latest
  adds one by one (a reader after the run picks its window's calls or
  epochs from them).
* **Device stage marks** (:func:`mark`): with tracing on, one one-thread
  kernel (``csrc/stage_mark.cu``) that writes the card's ``%globaltimer``
  and the stage's id into a device ring. Launched inside a graph capture it
  becomes a node of the graph, so every replay stamps its stages with no
  host work; its name, ``stage_mark``, shows in a profiler trace, so each
  kernel of a traced replay can be put under its stage. On the CPU, the
  plain version appends ``perf_counter_ns``. :func:`stage_ms` fetches each
  ring once and gives each stage's milliseconds a pass (a pass starts at a
  ``forward`` mark; the host's marks and each card's are split apart, as
  their clocks differ). A graph captured with tracing off has no mark nodes.

One switch, :func:`set_tracing` (or the :func:`tracing` context), turns
spans and marks on; it is off by default.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading
import time
from collections import Counter, defaultdict, deque
from dataclasses import dataclass, field

import torch

# the stages a pass is marked with, in the order a training step runs them
# (``output``: the served frame's uint8 rounding and ring write); a stage
# lasts from its mark to the next one, ``end`` closes a pass
STAGES = ("forward", "raster_front", "blend", "loss", "backward", "optimizer", "output",
          "end")
_STAGE_ID = {s: i for i, s in enumerate(STAGES)}
RING = 1 << 16          # marks a device ring holds; older ones are overwritten
HISTORY = 4096          # adds a counter's history keeps

_ON = False
_NULL = contextlib.nullcontext()
_local = threading.local()
_records: list = []
_cpu_marks: list = []   # (perf_counter_ns, stage id) of the plain version
_rings: dict = {}       # device index -> int64 [1 + 2 * RING]: cursor, then (ns, id) pairs

COUNTERS: Counter = Counter()
_history: defaultdict = defaultdict(lambda: deque(maxlen=HISTORY))


def set_tracing(on: bool) -> None:
    """Turn spans and stage marks on or off (off by default)."""
    global _ON
    _ON = bool(on)


def is_tracing() -> bool:
    return _ON


@contextlib.contextmanager
def tracing(on: bool = True):
    """Tracing switched to ``on`` inside the block, as it was after it."""
    before = _ON
    set_tracing(on)
    try:
        yield
    finally:
        set_tracing(before)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

@dataclass
class SpanRecord:
    """A closed span: perf_counter seconds, the id of its parent (None at
    the top) and the ids it was opened with."""

    name: str
    start: float
    end: float
    id: int
    parent: int | None
    ids: dict = field(default_factory=dict)


class _Span:
    __slots__ = ("name", "ids", "rf", "start", "id", "parent")
    _next = 0

    def __init__(self, name: str, ids: dict):
        self.name, self.ids = name, ids

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        _Span._next += 1
        self.id = _Span._next
        self.rf = torch.profiler.record_function("fa." + self.name)
        self.rf.__enter__()
        stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        _stack().pop()
        self.rf.__exit__(*exc)
        _records.append(SpanRecord(self.name, self.start, end, self.id, self.parent,
                                   self.ids))
        return False


def _stack() -> list:
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


def span(name: str, **ids):
    """A named host interval; ``ids`` identify its request (``epoch=``,
    ``call=``) or say what it is (``graph=``, ``reason=``). A null context
    while tracing is off."""
    if not _ON:
        return _NULL
    return _Span(name, ids)


def spans() -> list:
    """The closed spans since the last :func:`reset`, in closing order."""
    return list(_records)


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

def count(name: str, value=1) -> None:
    COUNTERS[name] += value
    _history[name].append(value)


def history(name: str) -> list:
    """The latest adds to counter ``name`` (up to :data:`HISTORY`), oldest
    first."""
    return list(_history.get(name, ()))


def counters(since: dict | None = None) -> dict:
    """A snapshot of :data:`COUNTERS`; with ``since`` (an earlier snapshot),
    each counter's change from it."""
    now = dict(COUNTERS)
    if since is None:
        return now
    return {k: v - since.get(k, 0) for k, v in now.items()}


# ---------------------------------------------------------------------------
# stage marks
# ---------------------------------------------------------------------------

def _ring(device: torch.device) -> torch.Tensor:
    """The device's ring and its mark kernel, made and loaded on first use
    (outside a capture: :func:`prepare`)."""
    idx = torch.cuda.current_device() if device.index is None else device.index
    ring = _rings.get(idx)
    if ring is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a stage mark's first use on a device is inside a graph "
                               "capture: call profiling.prepare(device) before capturing")
        from fateavatar_tpu_torch.utils import cuda_build

        err = cuda_build.call("stage_mark", "stage_mark_load", (), (), ctypes.c_int)
        if err != 0:
            raise RuntimeError(f"stage_mark kernel failed to load: CUDA error {err}")
        ring = _rings[idx] = torch.zeros((1 + 2 * RING,), dtype=torch.int64,
                                         device=torch.device("cuda", idx))
    return ring


def prepare(device) -> None:
    """Make ``device``'s ring and load the mark kernel where tracing is on:
    a graph calls it before it captures, since neither can happen inside a
    capture."""
    device = torch.device(device)
    if _ON and device.type == "cuda":
        _ring(device)


def mark(stage: str, device) -> None:
    """Stamp the start of ``stage`` on ``device``'s stream, or on the host
    clock for a CPU device; nothing while tracing is off."""
    if not _ON:
        return
    sid = _STAGE_ID[stage]
    device = torch.device(device)
    if device.type != "cuda":
        _cpu_marks.append((time.perf_counter_ns(), sid))
        return
    from fateavatar_tpu_torch.utils import cuda_build

    ring = _ring(device)
    cuda_build.launch("stage_mark", "stage_mark_launch",
                      (ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p),
                      (ring.data_ptr(), RING, sid), device)


def _sources() -> list:
    """The recorded marks by clock, each list oldest first as (ns, stage
    name): the CPU's, then each device ring's (one fetch a ring, its latest
    ``RING`` marks)."""
    out = [[(t, STAGES[s]) for t, s in _cpu_marks]]
    for idx in sorted(_rings):
        buf = _rings[idx].cpu()
        n = int(buf[0])
        pairs = buf[1:].view(RING, 2)
        if n > RING:
            pairs = torch.cat([pairs[n % RING:], pairs[:n % RING]])
        else:
            pairs = pairs[:n]
        out.append([(int(t), STAGES[int(s)]) for t, s in pairs.tolist()])
    return out


def marks() -> list:
    """Every recorded mark as (ns, stage name): the CPU's, then each device
    ring's, each oldest first."""
    return [m for seq in _sources() for m in seq]


def stage_intervals(seq) -> dict:
    """{stage: [ns of each pass]} of a sequence of (ns, stage) marks: a stage
    lasts until the next mark, ``end`` lasts nothing, a pass starts at each
    ``forward``; a stage that occurs twice in a pass (two renders) adds up.
    Marks before the first ``forward`` are left out."""
    per: dict = {}
    p = -1
    for (t, s), (t_next, _) in zip(seq, list(seq[1:]) + [(None, None)]):
        if s == "forward":
            p += 1
        if p < 0 or s == "end" or t_next is None:
            continue
        passes = per.setdefault(s, {})
        passes[p] = passes.get(p, 0) + (t_next - t)
    return {s: list(v.values()) for s, v in per.items()}


def stage_ms() -> dict:
    """{stage: (mean ms a pass, passes)} over the marks since the last
    :func:`reset` (device ms on a card, host ms on the CPU), each clock's
    marks split into passes on their own: no stage spans two clocks."""
    per: dict = {}
    for seq in _sources():
        for s, ns in stage_intervals(seq).items():
            per.setdefault(s, []).extend(ns)
    return {s: (sum(ns) / len(ns) * 1e-6, len(ns)) for s, ns in per.items()}


def reset() -> None:
    """Drop the span records and the marks (the counters stay: read them as
    deltas)."""
    _records.clear()
    _cpu_marks.clear()
    for ring in _rings.values():
        ring.zero_()


# ---------------------------------------------------------------------------
# the exporter
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace (CPU and, where there is a card, CUDA
    activity) with tracing on, and write it to ``log_dir/trace.json``
    (Chrome / Perfetto). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with tracing(), profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
