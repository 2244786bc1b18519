"""Kernel 1's share of its roofline in the traced training replays: the
least time of the frames' blend forward work (counts/: pairs up to
termination from the reference's lists, float32 operations at 67 TFLOP/s
against bytes at 3.35 TB/s, the larger) over the device time of the
``blend_instances_fwd_*`` kernels."""

from portbench import counts

LAYER = "Kernels (csrc/blend_instances.cu, csrc/blend_instances_bwd.cu)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_steps_per_s"


def read(r):
    work = r.get("blend_fwd_work")
    if not work or not r.get("blend_fwd_s"):
        return None
    return 100.0 * counts.least_seconds(work["flops"], work["bytes"])[0] / r["blend_fwd_s"]
