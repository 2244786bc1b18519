"""Quaternion / rotation utilities (wxyz, "real first").

Port of ``fateavatar_tpu/ops/quaternion.py``.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b for wxyz quaternions. Shapes broadcast."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(_EPS)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """wxyz quaternion -> 3x3 rotation matrix, ``q`` normalized first (the
    rotation of the CUDA rasterizer's ``computeCov3D``, forward.cu:126-138)."""
    w, x, y, z = quat_normalize(q).unbind(-1)
    m = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix -> wxyz quaternion (w >= 0), the branchless
    four-candidate construction of the JAX package."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22

    q0 = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    q1 = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    q2 = torch.stack([m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21], dim=-1)
    q3 = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11], dim=-1)

    # pick the candidate with the largest leading term (all are 4*q_k^2);
    # argmax returns the first maximum, as jnp.argmax does
    lead = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 + m11 - m00 - m22,
                        1.0 + m22 - m00 - m11], dim=-1)
    best = torch.argmax(lead, dim=-1, keepdim=True)
    cands = torch.stack([q0, q1, q2, q3], dim=-2)  # [..., 4, 4]
    q = torch.take_along_dim(cands, best[..., None], dim=-2).squeeze(-2)
    denom = 2.0 * torch.sqrt(torch.take_along_dim(lead, best, dim=-1).clamp_min(_EPS))
    q = q / denom
    q = torch.where(q[..., :1] < 0, -q, q)
    return quat_normalize(q)


def axis_angle_to_matrix(aa: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Rodrigues formula (FLAME's batch_rodrigues)."""
    angle = torch.linalg.norm(aa + eps, dim=-1, keepdim=True)
    axis = aa / angle
    rx, ry, rz = axis.unbind(-1)
    zeros = torch.zeros_like(rx)
    k = torch.stack(
        [zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros], dim=-1
    ).reshape(aa.shape[:-1] + (3, 3))
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    return eye + sin * k + (1.0 - cos) * (k @ k)


def quat_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    q = quat_normalize(q)
    w = q[..., 0]
    v = q[..., 1:]
    vnorm = torch.linalg.norm(v, dim=-1).clamp_min(_EPS)
    angle = 2.0 * torch.atan2(vnorm, w)
    # small-angle safe scale: angle / sin(angle/2) -> 2 as angle -> 0
    scale = torch.where(vnorm < 1e-6, torch.full_like(vnorm, 2.0), angle / vnorm)
    return v * scale[..., None]


def axis_angle_to_quat(aa: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Axis-angle -> wxyz quaternion; the norm is taken of ``aa + eps``, as
    in the JAX package, so a zero rotation gives (1, 0, 0, 0)."""
    angle = torch.linalg.norm(aa + eps, dim=-1, keepdim=True)
    half = 0.5 * angle
    w = torch.cos(half)
    xyz = aa / angle * torch.sin(half)
    return torch.cat([w, xyz], dim=-1)
