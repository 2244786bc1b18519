"""The reference's dense blend against a brute-force loop, one pixel at a
time in NumPy, on a scene of a few hundred splats."""

import math

import numpy as np
import torch

from portbench.reference import raster


def _scene(n=300, w=48, h=40, seed=3):
    g = torch.Generator().manual_seed(seed)
    mx = torch.rand(n, generator=g) * (w + 8) - 4
    my = torch.rand(n, generator=g) * (h + 8) - 4
    s = torch.rand(n, generator=g) * 3 + 0.7          # pixels
    th = torch.rand(n, generator=g) * math.pi
    c, si = torch.cos(th), torch.sin(th)
    sx, sy = s, s * (0.3 + torch.rand(n, generator=g))
    cxx = c * c * sx ** 2 + si * si * sy ** 2 + 0.3
    cyy = si * si * sx ** 2 + c * c * sy ** 2 + 0.3
    cxy = c * si * (sx ** 2 - sy ** 2)
    det = cxx * cyy - cxy * cxy
    soa = torch.stack([mx, my, cyy / det, -cxy / det, cxx / det,
                       torch.rand(n, generator=g), torch.rand(n, generator=g),
                       torch.rand(n, generator=g), torch.rand(n, generator=g) * 0.99], 1)
    mid = 0.5 * (cxx + cyy)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3 * torch.sqrt(lam)).to(torch.int64)
    radius[::17] = 0                                     # culled
    depth = torch.rand(n, generator=g) * 5 + 1
    return soa, depth, radius, w, h


def _loop(soa, depth, radius, w, h, bg):
    soa, depth, radius = soa.double().numpy(), depth.numpy(), radius.numpy()
    order = [i for i in np.argsort(depth, kind="stable") if radius[i] > 0]
    img = np.zeros((h, w, 3))
    tfin = np.ones((h, w))
    for y in range(h):
        for x in range(w):
            tx, ty = x // 16, y // 16
            T, col = 1.0, np.zeros(3)
            for i in order:
                mx, my, a, b, c, r, g, bb, o = soa[i]
                x0 = min(max(int((mx - radius[i]) / 16), 0), (w + 15) // 16)
                y0 = min(max(int((my - radius[i]) / 16), 0), (h + 15) // 16)
                x1 = min(max(int((mx + radius[i] + 15) / 16), 0), (w + 15) // 16)
                y1 = min(max(int((my + radius[i] + 15) / 16), 0), (h + 15) // 16)
                if not (x0 <= tx < x1 and y0 <= ty < y1):
                    continue
                dx, dy = mx - x, my - y
                power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
                if power > 0:
                    continue
                alpha = min(0.99, o * math.exp(power))
                if alpha < 1 / 255:
                    continue
                if T * (1 - alpha) < 1e-4:
                    break
                col += alpha * T * np.array([r, g, bb])
                T *= 1 - alpha
            img[y, x] = col + T * bg
            tfin[y, x] = T
    return img, tfin


def test_dense_blend_equals_the_pixel_loop():
    soa, depth, radius, w, h = _scene()
    bg = np.array([1.0, 1.0, 1.0])
    img, tfin = raster.blend(soa, depth, radius, w, h, torch.ones(3))
    want, want_t = _loop(soa, depth, radius, w, h, bg)
    assert np.abs(img.numpy() - want).max() < 2e-5
    assert np.abs(tfin.numpy() - want_t).max() < 2e-5
    assert (want_t < 0.5).mean() > 0.2, "the scene must cover much of the frame"


def test_dense_blend_gradient_through_the_blocks():
    soa, depth, radius, w, h = _scene(n=120)
    soa = soa.double().requires_grad_()
    img, _ = raster.blend(soa, depth, radius, w, h, torch.ones(3, dtype=torch.float64),
                          grad=True)
    g, = torch.autograd.grad(img.square().sum(), soa)
    img2, _ = raster.blend(soa, depth, radius, w, h, torch.ones(3, dtype=torch.float64))
    g2, = torch.autograd.grad(img2.square().sum(), soa)
    assert torch.allclose(g, g2, rtol=1e-10, atol=1e-12) and float(g.abs().max()) > 0
