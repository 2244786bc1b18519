"""FFHQ-style face alignment for the completion pipeline (stages ③ and ⑦).

Port of ``fateavatar_tpu/completion/alignment.py``. The numpy functions are
copied: :func:`eg3dcamparams`, :func:`get_crop_bound`,
:func:`quad_from_axes`, :func:`matrix2angle`, :func:`pose_reject`,
:func:`refine_quad`.

The JAX package runs :func:`crop_final` and :func:`paste_back_images` on
OpenCV. The port does not use OpenCV (the card's machine has none): the
calls are re-implemented here, in torch on the given device, after the
OpenCV 5.0 sources' arithmetic:

* ``getAffineTransform``: OpenCV's 6x6 system, solved in float64;
  ``invertAffineTransform``: its closed form;
* ``estimateAffine2D`` (RANSAC + refinement, all points inliers when quad
  -> bound is a similarity): the least-squares affine fit of all points;
* ``warpAffine``: bilinear (the default) and ``INTER_CUBIC`` (a = -0.75)
  on float32 weights from float32 source positions, zero border;
  ``INTER_LANCZOS4`` + ``BORDER_REFLECT`` on OpenCV's fixed point (source
  positions in 1/32 px, the 8x8 weight tables in 15 bits);
* ``resize``: ``INTER_AREA`` at an integer factor, ``INTER_CUBIC`` on
  uint8 (11-bit weights per axis) and bilinear on float32;
* ``blur``: the normalized box filter with ``BORDER_REFLECT_101``.

The u8 truncation ``(clip * 255).astype(uint8)`` is kept where the
reference has it. Measured against OpenCV 5.0 in
``tests/test_torch_completion.py``: the Lanczos4, bilinear and area warps
and resizes of uint8 and the box blurs are equal bit for bit; the cubic
warp and resize of uint8 within one level of 255 (on under 1e-4 of the
values: OpenCV's float32 sums run in another order); float32 bilinear
(the paste-back's validity mask) within 1e-5; the crops within one level
(float64 rounding of the affine matrix), the pasted images within one
level plus 1e-4.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

# stage-⑦ "magic numbers" (train/completion.py:746-750), also the defaults
# of crop_final (affine_util.py:87-90)
TOP_EXPAND = 0.1
LEFT_EXPAND = 0.05
BOTTOM_EXPAND = 0.0
RIGHT_EXPAND = 0.05


def eg3dcamparams(R_in: np.ndarray) -> np.ndarray:
    """25-d EG3D camera label: flattened cam2world (16) + intrinsics (9).

    ``R_in`` is a 4x4 world2cam rotation; the label adds the canonical
    camera distance 2.7 and normalized focal 4.2647 (affine_util.py:5-28).
    """
    camera_dist = 2.7
    intrinsics = np.array([[4.2647, 0, 0.5], [0, 4.2647, 0.5], [0, 0, 1]],
                          np.float32)
    R = np.asarray(R_in, np.float32).reshape(4, 4)
    t = np.eye(4, dtype=np.float32)
    t[2, 3] = -camera_dist
    convert = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    P = convert @ t @ R
    cam2world = np.linalg.inv(P)
    return np.concatenate([cam2world.reshape(16), intrinsics.reshape(9)])


def get_crop_bound(lm: np.ndarray, method: str = "ffhq"):
    """FFHQ crop quad from 68 (or 106) landmarks (affine_util.py:30-70).

    Returns (quad [4,2], center, x half-axis, y half-axis), quad rows in
    the order [c-x-y, c-x+y, c+x+y, c+x-y].
    """
    lm = np.asarray(lm, np.float64)
    if len(lm) == 106:
        left_e, right_e = lm[104], lm[105]
        nose = lm[49]
        left_m, right_m = lm[84], lm[90]
        center = (lm[1] + lm[31]) * 0.5
    elif len(lm) == 68:
        left_e = np.mean(lm[36:42], axis=0)
        right_e = np.mean(lm[42:48], axis=0)
        nose = lm[33]
        left_m, right_m = lm[48], lm[54]
        center = (lm[0] + lm[16]) * 0.5
    else:
        raise ValueError(f"unknown keypoint count {len(lm)}")

    if method == "ffhq":
        eye_to_eye = right_e - left_e
        eye_avg = (left_e + right_e) * 0.5
        mouth_avg = (left_m + right_m) * 0.5
        eye_to_mouth = mouth_avg - eye_avg
        x = eye_to_eye - np.flipud(eye_to_mouth) * [-1, 1]
        x /= np.hypot(*x)
        x *= max(np.hypot(*eye_to_eye) * 2.0, np.hypot(*eye_to_mouth) * 1.8)
        y = np.flipud(x) * [-1, 1]
        c = eye_avg + eye_to_mouth * 0.1
    elif method == "default":
        eye_to_eye = right_e - left_e
        eye_avg = (left_e + right_e) * 0.5
        eye_to_nose = nose - eye_avg
        x = eye_to_eye.copy()
        x /= np.hypot(*x)
        x *= max(np.hypot(*eye_to_eye) * 2.4, np.hypot(*eye_to_nose) * 2.75)
        y = np.flipud(x) * [-1, 1]
        c = center
    else:
        raise ValueError(f"unsupported crop method {method!r}")
    quad = np.stack([c - x - y, c - x + y, c + x + y, c + x - y])
    return quad.astype(np.float32), c, x, y


def quad_from_axes(c: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    return np.stack([c - x - y, c - x + y, c + x + y, c + x - y]).astype(np.float32)


def matrix2angle(R: np.ndarray) -> Tuple[float, float, float]:
    """(yaw, pitch, roll) in radians from a 3x3 rotation
    (affine_util.py:169-192)."""
    R = np.asarray(R, np.float64)
    if R[2, 0] > 0.998:
        z = 0.0
        x = math.pi / 2
        y = z + math.atan2(-R[0, 1], -R[0, 2])
    elif R[2, 0] < -0.998:
        z = 0.0
        x = -math.pi / 2
        y = -z + math.atan2(R[0, 1], R[0, 2])
    else:
        x = math.asin(R[2, 0])
        y = math.atan2(R[2, 1] / math.cos(x), R[2, 2] / math.cos(x))
        z = math.atan2(R[1, 0] / math.cos(x), R[0, 0] / math.cos(x))
    return x, y, z


@dataclass
class PoseFilter:
    """Rejection thresholds of train/completion.py:415-425 (degrees /
    normalized units)."""

    max_yaw: float = 90.0
    max_pitch: float = 80.0
    max_roll: float = 50.0
    min_scale: float = 0.7
    max_scale: float = 1.3
    max_t: float = 1.0


def pose_reject(R: np.ndarray, t3d: np.ndarray = None, s: float = 1.0,
                filt: PoseFilter = PoseFilter()) -> Optional[str]:
    """A rejection reason, or None if the view passes: the scale / pose /
    translation filters of train/completion.py:415-425."""
    if not (filt.min_scale <= s <= filt.max_scale):
        return f"scale {s:.2f}"
    yaw, pitch, roll = (a * 180.0 / math.pi for a in matrix2angle(R))
    if abs(yaw) > filt.max_yaw or abs(pitch) > filt.max_pitch \
            or abs(roll) > filt.max_roll:
        return f"pose ({yaw:.0f},{pitch:.0f},{roll:.0f})"
    if t3d is not None and (abs(t3d[0]) > filt.max_t or abs(t3d[1]) > filt.max_t):
        return f"t3d {t3d[:2]}"
    return None


def refine_quad(c: np.ndarray, x: np.ndarray, y: np.ndarray,
                center_px: np.ndarray, img_size: int = 512,
                s: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Recenter / rescale the quad on the head centre ``center_px``, given in
    the coordinates of the initial crop the quad defines
    (train/completion.py:428-433). Returns (quad, t3d[2]); t3d also feeds
    :func:`pose_reject`."""
    half = 0.5 * (img_size - 1)
    t0 = (center_px[0] - half) / half
    t1 = -((center_px[1] - half) / half)
    c = c + x * t0
    c = c - y * t1
    x = x * s
    y = y * s
    return quad_from_axes(c, x, y), np.array([t0, t1])


# ---------------------------------------------------------------------------
# the OpenCV calls, re-implemented
# ---------------------------------------------------------------------------

def get_affine_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """``cv2.getAffineTransform``: the 2x3 float64 map of 3 float32 points
    onto 3, from OpenCV's 6x6 system (LAPACK's LU here, OpenCV's own there:
    the two differ in the last bits of float64)."""
    src = np.asarray(src, np.float32).astype(np.float64)
    dst = np.asarray(dst, np.float32).astype(np.float64)
    a = np.zeros((6, 6))
    a[0::2, 0:2] = a[1::2, 3:5] = src
    a[0::2, 2] = a[1::2, 5] = 1.0
    return np.linalg.solve(a, dst.reshape(6)).reshape(2, 3)


def invert_affine_transform(M: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform`` (its closed form, float64)."""
    M = np.asarray(M, np.float64)
    D = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]
    D = 1.0 / D if D != 0 else 0.0
    A11, A22, A12, A21 = M[1, 1] * D, M[0, 0] * D, -M[0, 1] * D, -M[1, 0] * D
    b1 = -A11 * M[0, 2] - A12 * M[1, 2]
    b2 = -A21 * M[0, 2] - A22 * M[1, 2]
    return np.array([[A11, A12, b1], [A21, A22, b2]], np.float64)


def estimate_affine_2d(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """``cv2.estimateAffine2D`` where every point is an inlier (RANSAC then
    refinement on all of them): the least-squares affine map, float64."""
    src = np.asarray(src, np.float32).astype(np.float64)
    dst = np.asarray(dst, np.float32).astype(np.float64)
    A = np.concatenate([src, np.ones((len(src), 1))], axis=1)
    sol, *_ = np.linalg.lstsq(A, dst, rcond=None)
    return sol.T


def _cubic_weights(x: torch.Tensor):
    """OpenCV's ``interpolateCubic`` (a = -0.75), float32."""
    A = -0.75
    c0 = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1) - 4 * A
    c1 = ((A + 2) * x - (A + 3)) * x * x + 1
    c2 = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1
    return [c0, c1, c2, 1 - c0 - c1 - c2]


def _linear_weights(x: torch.Tensor):
    return [1 - x, x]


def _lanczos4(x: float):
    """OpenCV's ``interpolateLanczos4`` at one fraction (float32 results)."""
    s45 = 0.70710678118654752440084436210485
    cs = [(1, 0), (-s45, -s45), (0, 1), (s45, -s45), (-1, 0), (s45, s45), (0, -1), (-s45, s45)]
    f32 = np.float32
    y0 = -(x + 3) * math.pi * 0.25
    s0, c0 = math.sin(y0), math.cos(y0)
    coeffs, total = [], f32(0)
    for i in range(8):
        yi = f32(x + 3 - i)
        if abs(yi) >= 1e-6:
            y = -float(yi) * math.pi * 0.25
            c = f32((cs[i][0] * s0 + cs[i][1] * c0) / (y * y))
        else:
            c = f32(1e30)
        coeffs.append(c)
        total = f32(total + c)
    total = f32(1) / total
    return [f32(c * total) for c in coeffs]


@functools.lru_cache(maxsize=None)
def _lanczos4_table() -> np.ndarray:
    """OpenCV's ``initInterTab2D`` for Lanczos4 on uint8: [32*32, 8, 8]
    int64 weights in 15 bits per (y, x) fraction in 1/32, each summing to
    2^15 (the rounding error moved onto the largest / smallest centre tap)."""
    f32 = np.float32
    tab1 = [_lanczos4(float(f32(i / 32))) for i in range(32)]
    out = np.zeros((1024, 8, 8), np.int32)
    for i in range(32):
        for j in range(32):
            it = np.zeros((8, 8), np.int64)
            for k1 in range(8):
                for k2 in range(8):
                    it[k1, k2] = int(np.rint(f32(tab1[i][k1] * tab1[j][k2]) * f32(32768)))
            diff = int(it.sum()) - 32768
            if diff:
                mk = Mk = (4, 4)
                for k1 in (4, 5):
                    for k2 in (4, 5):
                        if it[k1, k2] < it[mk]:
                            mk = (k1, k2)
                        elif it[k1, k2] > it[Mk]:
                            Mk = (k1, k2)
                if diff < 0:
                    it[Mk] -= diff
                else:
                    it[mk] -= diff
            out[i * 32 + j] = it
    return out


def _reflect(p: torch.Tensor, n: int) -> torch.Tensor:
    """OpenCV's ``borderInterpolate`` for BORDER_REFLECT (fedcba|abcdef)."""
    if n == 1:
        return torch.zeros_like(p)
    period = 2 * n
    p = torch.remainder(p, period)
    return torch.where(p >= n, period - 1 - p, p)


def _reflect101(p: torch.Tensor, n: int) -> torch.Tensor:
    """BORDER_REFLECT_101 (gfedcb|abcdefgh|gfedcba)."""
    if n == 1:
        return torch.zeros_like(p)
    period = 2 * n - 2
    p = torch.remainder(p, period)
    return torch.where(p >= n, period - p, p)


def _as_hwc(img, device) -> Tuple[torch.Tensor, bool]:
    t = torch.as_tensor(np.ascontiguousarray(img), device=device)
    if t.dim() == 2:
        return t[..., None], True
    return t, False


def _out(t: torch.Tensor, squeeze: bool) -> np.ndarray:
    t = t[..., 0] if squeeze else t
    return t.cpu().numpy()


def warp_affine(img: np.ndarray, M: np.ndarray, dsize: Tuple[int, int],
                interp: str = "linear", border: str = "constant",
                device="cuda") -> np.ndarray:
    """``cv2.warpAffine(img, M, dsize, flags, borderMode)`` for uint8 or
    float32 [H, W(, C)] images: dst(x, y) = img(M^-1 (x, y)). ``interp`` is
    "linear" (zero border), "cubic" (zero border) or "lanczos4" (with
    ``border="reflect"``: uint8 only, OpenCV's fixed point)."""
    src, squeeze = _as_hwc(img, device)
    h, w, ch = src.shape
    ow, oh = dsize
    iM = invert_affine_transform(M)
    dev = src.device
    ys = torch.arange(oh, dtype=torch.float64, device=dev)[:, None].expand(oh, ow)
    xs = torch.arange(ow, dtype=torch.float64, device=dev)[None, :].expand(oh, ow)
    flat = src.reshape(h * w, ch)
    is_u8 = src.dtype == torch.uint8

    if interp == "lanczos4":
        if not is_u8 or border != "reflect":
            raise ValueError("warp_affine: lanczos4 is implemented for uint8 with "
                             "border='reflect'")
        # OpenCV's fixed point: positions in 1/1024 px rounded, then 1/32
        X0 = torch.round((iM[0, 1] * ys + iM[0, 2]) * 1024).to(torch.int64) + 16
        Y0 = torch.round((iM[1, 1] * ys + iM[1, 2]) * 1024).to(torch.int64) + 16
        X = (X0 + torch.round(iM[0, 0] * xs * 1024).to(torch.int64)) >> 5
        Y = (Y0 + torch.round(iM[1, 0] * xs * 1024).to(torch.int64)) >> 5
        tab = torch.from_numpy(_lanczos4_table()).to(dev)[(Y & 31) * 32 + (X & 31)]
        xi, yi = X >> 5, Y >> 5
        # |sum| <= 255 * sum|w| < 2^31: int32 holds OpenCV's int sums
        src32 = flat.to(torch.int32)
        acc = torch.zeros((oh, ow, ch), dtype=torch.int32, device=dev)
        for a in range(8):
            yy = _reflect(yi - 3 + a, h)
            for b in range(8):
                xx = _reflect(xi - 3 + b, w)
                acc += src32[yy * w + xx] * tab[:, :, a, b, None]
        out = torch.clamp((acc + (1 << 14)) >> 15, 0, 255).to(torch.uint8)
        return _out(out, squeeze)

    if border != "constant":
        raise ValueError(f"warp_affine: {interp} is implemented with border='constant'")
    # OpenCV 5's float path: source positions in float32
    m = torch.as_tensor(iM.astype(np.float32), device=dev)
    xs, ys = xs.to(torch.float32), ys.to(torch.float32)
    sx = m[0, 0] * xs + m[0, 1] * ys + m[0, 2]
    sy = m[1, 0] * xs + m[1, 1] * ys + m[1, 2]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    ax, ay = sx - x0, sy - y0
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
    weights, k = {"linear": (_linear_weights, 2), "cubic": (_cubic_weights, 4)}[interp]
    wx, wy = weights(ax), weights(ay)
    r = k // 2 - 1
    srcf = flat.to(torch.float32)
    acc = torch.zeros((oh, ow, ch), dtype=torch.float32, device=dev)
    for a in range(k):
        yy = y0 - r + a
        oky = (yy >= 0) & (yy < h)
        for b in range(k):
            xx = x0 - r + b
            ok = oky & (xx >= 0) & (xx < w)
            v = srcf[(yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1))]
            acc = acc + torch.where(ok[..., None], v, 0.0) * (wy[a] * wx[b])[..., None]
    if is_u8:
        acc = torch.clamp(torch.round(acc), 0, 255).to(torch.uint8)
    return _out(acc, squeeze)


def resize_area(img: np.ndarray, dsize: Tuple[int, int], device="cuda") -> np.ndarray:
    """``cv2.resize(img, dsize, interpolation=INTER_AREA)`` of uint8 at an
    integer shrink factor (OpenCV's ``resizeAreaFast``: the block mean,
    rounded; (sum + 2) >> 2 at factor 2)."""
    src, squeeze = _as_hwc(img, device)
    h, w, ch = src.shape
    ow, oh = dsize
    if h % oh or w % ow or src.dtype != torch.uint8:
        raise ValueError(f"resize_area: uint8 at an integer factor only, got "
                         f"{src.dtype} {w}x{h} -> {ow}x{oh}")
    fy, fx = h // oh, w // ow
    s = src.to(torch.int64).reshape(oh, fy, ow, fx, ch).sum(dim=(1, 3))
    if fx == 2 and fy == 2:
        out = (s + 2) >> 2
    else:
        out = torch.round(s.to(torch.float32) * (1.0 / (fx * fy)))
    return _out(out.clamp(0, 255).to(torch.uint8), squeeze)


def _resize_axis(n_in: int, n_out: int, dev, kind: str):
    """Source taps and float32 weights of one axis of ``cv2.resize``: the
    source position (i + 0.5) * scale - 0.5 in float32, taps clamped to the
    image."""
    scale = 1.0 / (n_out / n_in)
    f = ((torch.arange(n_out, dtype=torch.float64, device=dev) + 0.5) * scale - 0.5
         ).to(torch.float32)
    s = torch.floor(f)
    frac = f - s
    s = s.to(torch.int64)
    if kind == "linear":
        frac = torch.where(s < 0, 0.0, frac)
        frac = torch.where(s >= n_in - 1, 0.0, frac)
        s = s.clamp(0, n_in - 1)
        return [s, (s + 1).clamp(max=n_in - 1)], _linear_weights(frac)
    return [(s - 1 + k).clamp(0, n_in - 1) for k in range(4)], _cubic_weights(frac)


def resize(img: np.ndarray, dsize: Tuple[int, int], interp: str = "linear",
           device="cuda") -> np.ndarray:
    """``cv2.resize(img, dsize)`` bilinear on float32 and
    ``interpolation=INTER_CUBIC`` on uint8 (weights in 11 bits per axis,
    the horizontal pass in integers, (sum + 2^21) >> 22). The same size
    returns a copy, as OpenCV does."""
    src, squeeze = _as_hwc(img, device)
    h, w, _ = src.shape
    ow, oh = dsize
    if (ow, oh) == (w, h):
        return _out(src.clone(), squeeze)
    dev = src.device
    xi, wx = _resize_axis(w, ow, dev, interp)
    yi, wy = _resize_axis(h, oh, dev, interp)
    if interp == "cubic":
        if src.dtype != torch.uint8:
            raise ValueError("resize: cubic is implemented for uint8")
        iwx = [torch.round(c * 2048).to(torch.int64) for c in wx]
        iwy = [torch.round(c * 2048).to(torch.int64) for c in wy]
        s64 = src.to(torch.int64)
        rows = sum(s64[:, xi[k]] * iwx[k][None, :, None] for k in range(4))
        acc = sum(rows[yi[k]] * iwy[k][:, None, None] for k in range(4))
        out = ((acc + (1 << 21)) >> 22).clamp(0, 255).to(torch.uint8)
        return _out(out, squeeze)
    if src.dtype != torch.float32:
        raise ValueError("resize: bilinear is implemented for float32")
    rows = src[:, xi[0]] * wx[0][None, :, None] + src[:, xi[1]] * wx[1][None, :, None]
    out = rows[yi[0]] * wy[0][:, None, None] + rows[yi[1]] * wy[1][:, None, None]
    return _out(out, squeeze)


def box_blur(img: np.ndarray, k: int, device="cuda") -> np.ndarray:
    """``cv2.blur(img, (k, k))``: the normalized k x k box filter with
    BORDER_REFLECT_101. uint8 rounds the integer window sum over k^2 (odd k:
    no ties); float32 sums in float64, as OpenCV does."""
    src, squeeze = _as_hwc(img, device)
    h, w, _ = src.shape
    dev = src.device
    r = k // 2
    acc_t = torch.int64 if src.dtype == torch.uint8 else torch.float64
    x = src.to(acc_t)
    for dim, n in ((0, h), (1, w)):
        idx = _reflect101(torch.arange(-r, n + r, device=dev), n)
        p = torch.index_select(x, dim, idx)
        c = torch.cumsum(p, dim=dim)
        c = torch.cat([torch.zeros_like(c.narrow(dim, 0, 1)), c], dim=dim)
        x = c.narrow(dim, k, n) - c.narrow(dim, 0, n)
    if src.dtype == torch.uint8:
        out = ((2 * x + k * k) // (2 * k * k)).clamp(0, 255).to(torch.uint8)
    else:
        out = (x * (1.0 / (k * k))).to(torch.float32)
    return _out(out, squeeze)


# ---------------------------------------------------------------------------
# the crop and the paste-back
# ---------------------------------------------------------------------------

def crop_final(img: np.ndarray, size: int = 512, quad: np.ndarray = None,
               top_expand: float = TOP_EXPAND, left_expand: float = LEFT_EXPAND,
               bottom_expand: float = BOTTOM_EXPAND, right_expand: float = RIGHT_EXPAND,
               blur_kernel: Optional[int] = None, upsample: int = 2,
               min_size: Optional[int] = 256, device="cuda") -> Optional[np.ndarray]:
    """Expanded FFHQ crop with reflected borders and blurred out-of-source
    edges (affine_util.py:83-138). ``img`` float [0,1] HWC; returns float
    [0,1] of shape [crop_h, crop_w, 3], or None if the face is too small."""
    quad = np.asarray(quad, np.float32)
    orig_size = min(np.linalg.norm(quad[1] - quad[0]), np.linalg.norm(quad[2] - quad[1]))
    if min_size is not None and orig_size < min_size:
        return None

    crop_w = int(size * (1 + left_expand + right_expand))
    crop_h = int(size * (1 + top_expand + bottom_expand))
    crop_size = (crop_w, crop_h)
    top = int(size * top_expand)
    left = int(size * left_expand)
    size_m1 = size - 1
    bound = np.array(
        [[left, top], [left, top + size_m1], [left + size_m1, top + size_m1],
         [left + size_m1, top]], np.float32)
    mat = get_affine_transform(quad[:3], bound[:3])

    img_u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    if upsample is None or upsample == 1:
        crop_img = warp_affine(img_u8, mat, crop_size, "lanczos4", "reflect", device)
    else:
        large = (crop_w * upsample, crop_h * upsample)
        crop_img = warp_affine(img_u8, upsample * mat, large, "lanczos4", "reflect", device)
        crop_img = resize_area(crop_img, crop_size, device)

    # blur the regions that fell outside the source image
    empty = np.full_like(img_u8, 255)
    crop_mask = warp_affine(empty, mat, crop_size, device=device)
    mask_kernel = int(size * 0.02) * 2 + 1
    blur_kernel = int(size * 0.03) * 2 + 1 if blur_kernel is None else blur_kernel
    if crop_mask.mean() < 255:
        blur_mask = box_blur(crop_mask.astype(np.float32).mean(2), mask_kernel,
                             device)[..., None] / 255.0
        blurred_img = box_blur(crop_img, blur_kernel, device)
        crop_img = (crop_img * blur_mask + blurred_img * (1 - blur_mask)).astype(np.uint8)
    return crop_img.astype(np.float32) / 255.0


def paste_back_matrix(quad: np.ndarray, size: int = 512,
                      rescale_ratio: float = 1.0) -> np.ndarray:
    """The 2x3 affine mapping original-frame pixels -> crop pixels used by
    stage ⑦ (train/completion.py:744-778). ``rescale_ratio`` shrinks the
    bound towards the crop centre for rescaled NeRF scenes
    (completion.py:766-772: 2.7 / (2.7 + rescale_factor))."""
    top = int(size * TOP_EXPAND)
    left = int(size * LEFT_EXPAND)
    bound = np.array(
        [[left, top], [left, top + size - 1],
         [left + size - 1, top + size - 1], [left + size - 1, top]],
        np.float32)
    bound = (bound - 256.0) * rescale_ratio + 256.0
    return estimate_affine_2d(np.asarray(quad, np.float32), bound)


def paste_back_images(pseudo: np.ndarray, quad: np.ndarray, out_size: int = 512,
                      rescale_ratio: float = 1.0, bg_color: float = 1.0,
                      masks: Optional[np.ndarray] = None, device="cuda"):
    """Stage ⑦: warp provider outputs back into the original framing
    (train/completion.py:709-816).

    ``pseudo`` [V, h, w, 3] float [0,1] (any size: resized to the crop
    frame first). Returns (pasted [V, out_size, out_size, 3], valid mask
    [V, out_size, out_size]); the background fills with ``bg_color``."""
    size = out_size
    crop_w = int(size * (1 + LEFT_EXPAND + RIGHT_EXPAND))
    crop_h = int(size * (1 + TOP_EXPAND + BOTTOM_EXPAND))
    M = paste_back_matrix(quad, size, rescale_ratio)
    # warpAffine maps input -> output with M; stage ⑦'s PIL transform uses M
    # as output -> input, so invert for the same semantics
    Minv = invert_affine_transform(M)
    ones = np.ones((crop_h, crop_w), np.float32)

    out_imgs, out_masks = [], []
    for i, img in enumerate(pseudo):
        u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        u8 = resize(u8, (crop_w, crop_h), "cubic", device)
        warped = warp_affine(u8, Minv, (size, size), "cubic", device=device)
        valid = warp_affine(ones, Minv, (size, size), device=device)
        if masks is not None:
            m8 = resize(np.asarray(masks[i], np.float32), (crop_w, crop_h), device=device)
            valid = valid * warp_affine(m8, Minv, (size, size), device=device)
        valid = np.clip(valid, 0.0, 1.0)
        img_f = warped.astype(np.float32) / 255.0
        pasted = img_f * valid[..., None] + bg_color * (1 - valid[..., None])
        out_imgs.append(pasted)
        out_masks.append(valid)
    return np.stack(out_imgs), np.stack(out_masks)
