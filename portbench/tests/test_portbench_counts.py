"""The frozen counts on scenes small enough to count by hand."""

import pytest
import torch

from portbench import counts
from portbench.reference import raster


def test_vgg_flops():
    # 2 x H x W x Cin x Cout x 9 over the ten convolutions to conv4_3
    assert counts.vgg_forward_flops() == pytest.approx(27_918_729_216.0)
    assert counts.vgg_loss_flops(train=True) == 3 * counts.vgg_forward_flops()


def _stack(n, opacity):
    """``n`` flat splats at the centre of tile 0 of a 32x32 frame, each
    blending opacity ``opacity`` at every pixel of the tile (zero conic)."""
    soa = torch.zeros((n, 9))
    soa[:, 0] = soa[:, 1] = 7.5
    soa[:, 5:8] = 0.5
    soa[:, 8] = opacity
    return soa, torch.arange(n, dtype=torch.float32) + 1.0, torch.full((n,), 8)


def test_pairs_stop_at_termination():
    # transmittance 0.05, 0.0025, 1.25e-4, 6.25e-6: the fourth entry would
    # take it below 1e-4, so each pixel evaluates 4 and blends 3
    pairs = raster.pair_counts(*_stack(5, 0.95), 32, 32)
    assert pairs == {"evaluated": 4 * 256, "blended": 3 * 256, "instances": 5,
                     "visible": 5, "pixels": 1024}
    fwd, bwd = counts.blend_fwd(pairs), counts.blend_bwd(pairs)
    assert fwd == {"flops": 21 * 1024, "bytes": 36 * 5 + 16 * 1024}
    assert bwd == {"flops": 14 * 1024 + 41 * 768, "bytes": 72 * 5 + 32 * 1024}


def test_skipped_entries_are_evaluated_not_blended():
    soa, depth, radius = _stack(3, 0.003)     # alpha < 1/255: skipped
    pairs = raster.pair_counts(soa, depth, radius, 32, 32)
    assert pairs["evaluated"] == 3 * 256 and pairs["blended"] == 0


def test_least_time_picks_the_larger_bound():
    t, which = counts.least_seconds(67e12, 1.0)
    assert t == pytest.approx(1.0) and which == "fp32 ops"
    t, which = counts.least_seconds(1.0, 3.35e12)
    assert t == pytest.approx(1.0) and which == "bytes"
