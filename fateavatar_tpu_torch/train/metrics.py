"""Streaming evaluation meters (port of ``fateavatar_tpu/train/metrics.py``,
train/metrics.py:9-104 of the reference).

Meters are host-side running averages. The image meters compute their
metric from a prediction and a ground truth (:meth:`update`); the Trainer
computes all four on the device in one :func:`image_metrics` call per frame,
fetches the values in one batch and records them with
:meth:`Meter.update_value`. LPIPS needs calibrated network weights, which the
port cannot load yet: without a weights path its meter is unavailable and
dropped, as the JAX package drops it.
"""

from __future__ import annotations

from typing import Optional

import torch

from fateavatar_tpu_torch.train.losses import d_ssim, psnr

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
    """LPIPS (train/metrics.py:65-74). Without weights it is unavailable
    and records NaN; a weights path raises, since the LPIPS network is not
    ported yet."""

    available = False

    def __init__(self, net: str = "alex", weights_path: Optional[str] = None):
        super().__init__("LPIPS")
        if weights_path is not None:
            raise NotImplementedError(
                f"LPIPS weights {weights_path!r}: the LPIPS network is not ported "
                "yet (ROADMAP Queue 1 item 10)")

    def update(self, preds, truths):
        self.V_cur = float("nan")


def image_metrics(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """[4] device tensor: PSNR, SSIM, L1, L2 of pred against gt ([H,W,3])."""
    return torch.stack([psnr(pred, gt), 1.0 - d_ssim(pred, gt),
                        torch.mean(torch.abs(pred - gt)), torch.mean((pred - gt) ** 2)])


def default_meters(lpips_weights_path: Optional[str] = None) -> dict:
    """The evaluation meters, unavailable ones (LPIPS without weights)
    dropped."""
    meters = {
        "psnr": PSNRMeter(),
        "ssim": SSIMMeter(),
        "l1": L1Meter(),
        "l2": L2Meter(),
        "lpips": LPIPSMeter(weights_path=lpips_weights_path),
    }
    return {k: m for k, m in meters.items() if m.available}
