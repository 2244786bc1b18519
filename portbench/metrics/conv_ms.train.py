"""Device milliseconds per step of the convolution kernels in the traced
replays: the perceptual loss's VGG16 stacks, picked by kernel name (the
frozen marks of timing.CONV_MARKS: conv, fprop, dgrad, wgrad,
implicit_gemm)."""

LAYER = "Loss (train/losses.py)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_steps_per_s"


def read(r):
    if not r.get("trace_replays") or not r.get("conv_s"):
        return None
    return 1e3 * r["conv_s"] / r["trace_replays"]
