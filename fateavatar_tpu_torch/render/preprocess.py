"""Per-Gaussian preprocessing: projection, covariance, conic, radius, colour.

Port of ``fateavatar_tpu/render/preprocess.py``, the vectorized equivalent
of the CUDA ``preprocessCUDA`` kernel (forward.cu:154-256). Elementwise work
over [N] channel vectors; semantics mirror the CUDA reference:

* near-cull at view-space z <= 0.2           (auxiliary.h:139-164)
* EWA projection with 1.3*tanfov clamping    (forward.cu:82-87)
* +0.3 px low-pass on the 2D covariance      (forward.cu:110-111)
* radius = ceil(3 sigma_max) from eigenvalues (forward.cu:229-232)
* ndc2Pix(v, S) = ((v+1)*S - 1)/2            (auxiliary.h:41-44)
* SH -> RGB with +0.5 shift and clamp        (forward.cu:20-71)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fateavatar_tpu_torch.ops.camera import Camera
from fateavatar_tpu_torch.ops.sh import sh_to_color


class Preprocessed(NamedTuple):
    depth: torch.Tensor     # [N] view-space z
    radius: torch.Tensor    # [N] int32 pixel radius (0 == culled)
    visible: torch.Tensor   # [N] bool (radius > 0)
    soa: tuple              # 9 [N] channel vectors (mx, my, conic_a, conic_b,
                            # conic_c, r, g, b, opacity)


def compute_cov3d(scale, rotation_q, scale_modifier: float = 1.0):
    """3D covariance upper triangle (xx, xy, xz, yy, yz, zz) as a tuple of
    [N] vectors, from activated scale and quaternion (forward.cu:118-152)."""
    q = rotation_q / torch.linalg.norm(
        rotation_q, dim=-1, keepdim=True).clamp_min(1e-8)
    w, x, y, z = q.unbind(-1)
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    s0, s1, s2 = (scale * scale_modifier).unbind(-1)
    v0, v1, v2 = s0 * s0, s1 * s1, s2 * s2
    return (
        r00 * r00 * v0 + r01 * r01 * v1 + r02 * r02 * v2,
        r00 * r10 * v0 + r01 * r11 * v1 + r02 * r12 * v2,
        r00 * r20 * v0 + r01 * r21 * v1 + r02 * r22 * v2,
        r10 * r10 * v0 + r11 * r11 * v1 + r12 * r12 * v2,
        r10 * r20 * v0 + r11 * r21 * v1 + r12 * r22 * v2,
        r20 * r20 * v0 + r21 * r21 * v1 + r22 * r22 * v2,
    )


def compute_cov2d(mean3d, cov3d, view, focal_x, focal_y, tan_fovx, tan_fovy):
    """EWA splatting 3D->2D covariance (forward.cu:74-113). Returns
    (cov_xx, cov_xy, cov_yy) [N] vectors incl. the +0.3 low-pass."""
    t = mean3d @ view[:3, :3].T + view[:3, 3]
    tz = t[..., 2]
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    # CUDA gradient semantics for the EWA clamp (backward.cu:168-176,
    # 262-264): out of the limit, the x gradient is gated to zero and the
    # clamped t.x = ±lim*t.z is a constant w.r.t. t.z. Nothing
    # backpropagates in the serving path; the detach keeps the code right
    # for the training slice.
    txtz = t[..., 0] / tz
    tytz = t[..., 1] / tz
    in_x = (txtz >= -limx) & (txtz <= limx)
    in_y = (tytz >= -limy) & (tytz <= limy)
    tx_c = (torch.clamp(txtz, -limx, limx) * tz).detach()
    ty_c = (torch.clamp(tytz, -limy, limy) * tz).detach()
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    tx = tx_c + torch.where(in_x, t[..., 0] - t[..., 0].detach(), zero)
    ty = ty_c + torch.where(in_y, t[..., 1] - t[..., 1].detach(), zero)

    j00 = focal_x / tz
    j02 = -(focal_x * tx) / (tz * tz)
    j11 = focal_y / tz
    j12 = -(focal_y * ty) / (tz * tz)
    w00, w01, w02 = view[0, 0], view[0, 1], view[0, 2]
    w10, w11, w12 = view[1, 0], view[1, 1], view[1, 2]
    w20, w21, w22 = view[2, 0], view[2, 1], view[2, 2]
    # T = J @ W; J rows are [j00, 0, j02], [0, j11, j12]
    t00 = j00 * w00 + j02 * w20
    t01 = j00 * w01 + j02 * w21
    t02 = j00 * w02 + j02 * w22
    t10 = j11 * w10 + j12 * w20
    t11 = j11 * w11 + j12 * w21
    t12 = j11 * w12 + j12 * w22

    c0, c1, c2, c3, c4, c5 = cov3d
    # U = T @ V (V symmetric from the upper triangle)
    u00 = t00 * c0 + t01 * c1 + t02 * c2
    u01 = t00 * c1 + t01 * c3 + t02 * c4
    u02 = t00 * c2 + t01 * c4 + t02 * c5
    u10 = t10 * c0 + t11 * c1 + t12 * c2
    u11 = t10 * c1 + t11 * c3 + t12 * c4
    u12 = t10 * c2 + t11 * c4 + t12 * c5
    # cov = U @ T^T
    cov00 = u00 * t00 + u01 * t01 + u02 * t02
    cov01 = u00 * t10 + u01 * t11 + u02 * t12
    cov11 = u10 * t10 + u11 * t11 + u12 * t12
    return cov00 + 0.3, cov01, cov11 + 0.3


def preprocess(
    camera: Camera,
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    opacities: torch.Tensor,
    sh: torch.Tensor | None,
    sh_degree: int,
    colors_precomp: torch.Tensor | None = None,
    scale_modifier: float = 1.0,
    alive: torch.Tensor | None = None,
) -> Preprocessed:
    """Vectorized per-Gaussian preprocessing. ``colors_precomp`` [N, 3], when
    given, is the splats' colour as it is (no SH, no clamp; ``sh`` is then
    not read). ``alive`` masks dead capacity slots (dead => radius 0)."""
    W, H = camera.width, camera.height

    # projection
    p_hom = means3d @ camera.full_proj[:, :3].T + camera.full_proj[:, 3]
    p_w = 1.0 / (p_hom[..., 3] + 1e-7)
    p_proj = p_hom[..., :3] * p_w[..., None]
    p_view_z = means3d @ camera.view[2, :3] + camera.view[2, 3]

    in_frustum = p_view_z > 0.2

    cov3d = compute_cov3d(scales, rotations, scale_modifier)
    cov00, cov01, cov11 = compute_cov2d(
        means3d, cov3d, camera.view,
        camera.focal_x, camera.focal_y, camera.tan_fovx, camera.tan_fovy,
    )

    det = cov00 * cov11 - cov01 * cov01
    valid_det = det != 0.0
    det_inv = torch.where(valid_det, 1.0 / torch.where(valid_det, det, 1.0), 0.0)
    conic_a = cov11 * det_inv
    conic_b = -cov01 * det_inv
    conic_c = cov00 * det_inv

    mid = 0.5 * (cov00 + cov11)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    lambda1 = mid + disc
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lambda1, 1e-12)))

    mean_x = ((p_proj[..., 0] + 1.0) * W - 1.0) * 0.5
    mean_y = ((p_proj[..., 1] + 1.0) * H - 1.0) * 0.5

    if colors_precomp is not None:
        color = colors_precomp
    else:
        dirs = means3d - camera.campos
        dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True).clamp_min(1e-12)
        color = sh_to_color(sh_degree, sh, dirs)

    visible = in_frustum & valid_det
    if alive is not None:
        visible = visible & alive
    radius = torch.where(visible, radius_f, 0.0).to(torch.int32)

    opacity = opacities.reshape(-1)
    soa = (mean_x, mean_y, conic_a, conic_b, conic_c,
           color[..., 0], color[..., 1], color[..., 2], opacity)
    return Preprocessed(depth=p_view_z, radius=radius, visible=radius > 0, soa=soa)
