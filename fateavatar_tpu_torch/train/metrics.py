"""Streaming evaluation meters (port of ``fateavatar_tpu/train/metrics.py``,
train/metrics.py:9-104 of the reference).

Meters are host-side running averages. The image meters compute their
metric from a prediction and a ground truth (:meth:`update`); the Trainer
computes all four on the device in one :func:`image_metrics` call per frame,
fetches the values in one batch and records them with
:meth:`Meter.update_value`. LPIPS (``train/lpips.py``) needs calibrated
network weights: without them its meter is unavailable and dropped, as the
JAX package drops it; with them the Trainer computes it on the device beside
the other four (:func:`image_metrics`).
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from fateavatar_tpu_torch.train.losses import d_ssim, psnr
from fateavatar_tpu_torch.train.lpips import load_lpips_from_torch, lpips_distance

IMAGE_METRICS = ("psnr", "ssim", "l1", "l2")


class Meter:
    """Running average (train/metrics.py:9-35)."""

    available = True

    def __init__(self, name: str):
        self.name = name
        self.clear()

    def clear(self):
        self.V = 0.0
        self.N = 1e-6
        self.V_cur = 0.0

    def update(self, val, n: int = 1):
        val = float(val)
        self.V_cur = val
        self.V += val
        self.N += n

    def update_value(self, val: float, n: int = 1):
        """Record an already-computed metric value."""
        Meter.update(self, val, n)

    def measure(self) -> float:
        return self.V / self.N

    def report(self) -> str:
        return f"{self.name.ljust(max(len(self.name), 10))} = {self.measure():.8f}"


class LossMeter(Meter):
    def __init__(self, name: Optional[str] = None):
        super().__init__(name or "Loss")


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


class PSNRMeter(Meter):
    def __init__(self):
        super().__init__("PSNR")

    def update(self, preds, truths):
        super().update(psnr(_t(preds), _t(truths)))


class L1Meter(Meter):
    def __init__(self):
        super().__init__("L1")

    def update(self, preds, truths):
        super().update(torch.mean(torch.abs(_t(preds) - _t(truths))))


class L2Meter(Meter):
    def __init__(self):
        super().__init__("L2")

    def update(self, preds, truths):
        super().update(torch.mean((_t(preds) - _t(truths)) ** 2))


class SSIMMeter(Meter):
    def __init__(self):
        super().__init__("SSIM")

    def update(self, preds, truths):
        super().update(1.0 - d_ssim(_t(preds), _t(truths)))


class LPIPSMeter(Meter):
    """LPIPS (train/metrics.py:65-74, net='alex' by default), on ``device``.
    Weights come from ``weights_path`` (a converted ``.npz``, a full LPIPS
    state dict, or the official lin-only file plus ``backbone_path``, a
    torchvision backbone) or as ``params``. Without weights, or when they
    fail to load (with a warning), the meter is unavailable and records
    NaN, as the JAX package's does."""

    def __init__(self, net: str = "alex", weights_path: Optional[str] = None,
                 backbone_path: Optional[str] = None, params=None, device="cuda"):
        super().__init__("LPIPS")
        if params is None and weights_path is not None:
            try:
                params = load_lpips_from_torch(weights_path, backbone=net,
                                               backbone_path=backbone_path, device=device)
            except Exception as e:  # weights missing or corrupt: stay disabled
                warnings.warn(f"LPIPS weights failed to load: {e}")
        self.params = params
        self.available = params is not None

    def distance(self, preds: torch.Tensor, truths: torch.Tensor) -> torch.Tensor:
        """The distance as a device scalar (the Trainer batches its fetch)."""
        return lpips_distance(self.params, preds, truths, normalize=True)

    def update(self, preds, truths):
        if not self.available:
            self.V_cur = float("nan")
            return
        dev = self.params.lins[0].device
        with torch.no_grad():
            super().update(self.distance(_t(preds).to(dev), _t(truths).to(dev)))


def image_metrics(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """[4] device tensor: PSNR, SSIM, L1, L2 of pred against gt ([H,W,3])."""
    return torch.stack([psnr(pred, gt), 1.0 - d_ssim(pred, gt),
                        torch.mean(torch.abs(pred - gt)), torch.mean((pred - gt) ** 2)])


def default_meters(lpips_weights_path: Optional[str] = None, device="cuda") -> dict:
    """The evaluation meters, unavailable ones (LPIPS without weights)
    dropped; LPIPS's network on ``device``."""
    meters = {
        "psnr": PSNRMeter(),
        "ssim": SSIMMeter(),
        "l1": L1Meter(),
        "l2": L2Meter(),
        "lpips": LPIPSMeter(weights_path=lpips_weights_path, device=device),
    }
    return {k: m for k, m in meters.items() if m.available}
