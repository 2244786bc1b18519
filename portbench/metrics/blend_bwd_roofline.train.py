"""Kernel 2's share of its roofline in the traced training replays: the
least time of the frames' blend backward work (counts/) over the device
time of the ``blend_instances_bwd_*`` kernels."""

from portbench import counts

LAYER = "Kernels (csrc/blend_instances.cu, csrc/blend_instances_bwd.cu)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_steps_per_s"


def read(r):
    work = r.get("blend_bwd_work")
    if not work or not r.get("blend_bwd_s"):
        return None
    return 100.0 * counts.least_seconds(work["flops"], work["bytes"])[0] / r["blend_bwd_s"]
