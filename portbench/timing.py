"""The profiler's trace: what the benchmark measures on the device.

``device_union_us`` is a copy of the smoke run's (chip_smoke.py): the union
of the device intervals, overlaps counted once. The rest reads a
``torch.profiler`` trace into per-kernel time and the breakdown of the
result line. Windows are timed on the host clock around work closed by a
synchronize (``sync``).
"""

from __future__ import annotations

import torch

# the port's kernels by the marks in their names (the profiler prefixes
# them with their C++ namespace), and the convolutions' marks
FWD_KERNELS = ("blend_instances_fwd", "blend_instances_cut")
BWD_KERNELS = ("blend_instances_bwd",)
CONV_MARKS = ("conv", "fprop", "dgrad", "wgrad", "implicit_gemm")


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_intervals(prof):
    """Sorted (start, end) microseconds of every kernel, copy and fill the
    profiler saw on the device."""
    from torch.autograd import DeviceType

    return sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.device_type == DeviceType.CUDA)


def device_union_us(prof):
    """Microseconds the card was busy in a torch.profiler run: the union of
    the intervals of every kernel, copy and fill it saw (overlaps counted
    once)."""
    busy, end = 0.0, float("-inf")
    for a, b in device_intervals(prof):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def kernel_seconds(prof) -> dict:
    """Device seconds by kernel (or copy / fill) name, summed."""
    from torch.autograd import DeviceType

    out: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) * 1e-6
    return out


def seconds_of(ks: dict, marks, lower: bool = False) -> float:
    """Device seconds of the kernels whose names hold one of ``marks``."""
    return sum(v for k, v in ks.items() if any(m in (k.lower() if lower else k) for m in marks))


def idle_gaps(prof, top: int = 10) -> list:
    """The longest gaps between device work, each named by the shortest
    host operation of the trace that covers it (or overlaps it most):
    [[name, seconds], ...], longest first."""
    from torch.autograd import DeviceType

    spans, gaps, end = device_intervals(prof), [], None
    for a, b in spans:
        if end is not None and a > end:
            gaps.append((a - end, end, a))
        end = b if end is None else max(end, b)
    gaps = sorted(gaps, reverse=True)[:top]
    host = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
            if e.device_type == DeviceType.CPU]
    out = []
    for dur, a, b in gaps:
        cover = [(h1 - h0, name) for h0, h1, name in host if h0 <= a and h1 >= b]
        if cover:
            name = min(cover)[1]
        else:
            over = [(min(b, h1) - max(a, h0), name) for h0, h1, name in host
                    if h1 > a and h0 < b]
            name = max(over)[1] if over else "(no host operation)"
        out.append([name, dur * 1e-6])
    return out


def breakdown(prof, top: int = 10) -> dict:
    ks = sorted(kernel_seconds(prof).items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ks], "idle_gaps": idle_gaps(prof, top)}
