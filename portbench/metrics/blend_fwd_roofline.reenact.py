"""Kernel 1's share of its roofline in the traced reenactment calls: the
least time of the served frames' blend forward work (with frame 0 of each
call counted once more for each of the graph's warm-up calls; counts/) over
the device time of the ``blend_instances_fwd_*`` kernels."""

from portbench import counts

LAYER = "Kernels (csrc/blend_instances.cu, csrc/blend_instances_bwd.cu)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "reenact_frames_per_s"


def read(r):
    work = r.get("blend_fwd_work")
    if not work or not r.get("blend_fwd_s"):
        return None
    return 100.0 * counts.least_seconds(work["flops"], work["bytes"])[0] / r["blend_fwd_s"]
