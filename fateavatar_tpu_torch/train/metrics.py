"""Streaming evaluation meters (port of ``fateavatar_tpu/train/metrics.py``,
train/metrics.py:9-104 of the reference).

Meters are host-side running averages. The image metrics (PSNR, SSIM, L1,
L2) compute on the device in :func:`image_metrics`; the Trainer fetches
their values in one batch and feeds them in with :meth:`Meter.update`.
LPIPS needs calibrated network weights and is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from fateavatar_tpu_torch.train.losses import d_ssim, psnr

IMAGE_METRICS = ("psnr", "ssim", "l1", "l2")


class Meter:
    """Running average (train/metrics.py:9-35)."""

    def __init__(self, name: str):
        self.name = name
        self.V = 0.0
        self.N = 1e-6
        self.V_cur = 0.0

    def update(self, val, n: int = 1):
        val = float(val)
        self.V_cur = val
        self.V += val
        self.N += n

    def measure(self) -> float:
        return self.V / self.N


class LossMeter(Meter):
    def __init__(self, name: Optional[str] = None):
        super().__init__(name or "Loss")


def image_metrics(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """[4] device tensor: PSNR, SSIM, L1, L2 of pred against gt ([H,W,3])."""
    return torch.stack([psnr(pred, gt), 1.0 - d_ssim(pred, gt),
                        torch.mean(torch.abs(pred - gt)), torch.mean((pred - gt) ** 2)])


def default_meters() -> dict:
    return {k: Meter(k.upper()) for k in IMAGE_METRICS}
