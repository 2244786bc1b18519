"""Frozen operation and byte counts of the work a cell asks for, computed
from shapes and from the reference's own pair counts, never from the port's
lists or launch sizes; and the card's published peaks.

Peaks: one NVIDIA H100 SXM at its 700 W limit, NVIDIA's data sheet, dense:
989 TFLOP/s bf16, 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of
HBM.
"""

from __future__ import annotations

PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

# the blend forward per evaluated (splat, pixel) pair: the offset (2 sub),
# the quadratic form (8 mul/add), the exp, the opacity product, the clamp,
# the skip test, the transmittance step and the colour accumulate (21)
FWD_OPS_PER_EVALUATED = 21
# the blend backward: the forward's recompute up to alpha per evaluated
# pair (14), and per blended pair the transmittance step, the weight, the
# colour and transmittance cotangents, dalpha and the nine partials (41)
BWD_OPS_PER_EVALUATED = 14
BWD_OPS_PER_BLENDED = 41
SPLAT_CHANNELS = 9          # mean xy, conic abc, rgb, opacity (float32)

VGG_CONVS = ((224, 3, 64), (224, 64, 64), (112, 64, 128), (112, 128, 128),
             (56, 128, 256), (56, 256, 256), (56, 256, 256),
             (28, 256, 512), (28, 512, 512), (28, 512, 512))


def vgg_forward_flops(size: int = 224) -> float:
    """One image through VGG16 up to conv4_3: 2 x H x W x Cin x Cout x 9
    per 3x3 convolution (the pools and ReLUs are not counted)."""
    s = size / 224.0
    return sum(2.0 * (h * s) ** 2 * cin * cout * 9 for h, cin, cout in VGG_CONVS)


def vgg_loss_flops(train: bool) -> float:
    """The perceptual loss: the prediction's and the ground truth's stacks
    forward, and in training the input gradient of the prediction's stack
    (the same multiply-adds as its forward; the weights are frozen)."""
    return vgg_forward_flops() * (3.0 if train else 2.0)


def blend_fwd(pairs: dict) -> dict:
    """Operations and bytes of the blend forward of one frame: the
    evaluated pairs' operations; each visible splat's channels read once
    and each pixel's colour and transmittance written once."""
    return {"flops": FWD_OPS_PER_EVALUATED * pairs["evaluated"],
            "bytes": 4 * SPLAT_CHANNELS * pairs["visible"] + 16 * pairs["pixels"]}


def blend_bwd(pairs: dict) -> dict:
    """The blend backward: the splats' channels and each pixel's colour,
    transmittance and their two cotangents read once, each visible splat's
    nine gradients written once."""
    return {"flops": BWD_OPS_PER_EVALUATED * pairs["evaluated"]
            + BWD_OPS_PER_BLENDED * pairs["blended"],
            "bytes": 8 * SPLAT_CHANNELS * pairs["visible"] + 32 * pairs["pixels"]}


def least_seconds(flops: float, nbytes: float) -> tuple:
    """(least time, the bound that sets it): float32 operations at
    ``PEAK_FP32`` against bytes at ``PEAK_BYTES``."""
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
    return (t_ops, "fp32 ops") if t_ops >= t_bytes else (t_bytes, "bytes")


def flame_flops(n_verts: int, n_codes: int, passes: int = 2) -> float:
    """FLAME per pass: the blend shapes (2 V 3 codes), the pose correctives
    (2 x 36 x 3V) and the skinning (V x 5 joints x 16 + 3 x 3 x V x 2)."""
    per = 2.0 * n_verts * 3 * n_codes + 2.0 * 36 * 3 * n_verts + n_verts * (5 * 32 + 18)
    return passes * per


def step_mfu_seconds(flops_bf16: float, flops_fp32: float) -> float:
    """The ideal seconds of a step's counted work: bf16 work at the bf16
    peak plus float32 work at the float32 peak."""
    return flops_bf16 / PEAK_BF16 + flops_fp32 / PEAK_FP32
