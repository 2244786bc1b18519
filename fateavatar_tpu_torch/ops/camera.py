"""Perspective camera model.

Port of ``fateavatar_tpu/ops/camera.py``: the 3DGS camera conventions, with
matrices stored in plain math convention (column vectors, ``M @ p``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def world_to_view(R: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """World->view matrix from the 3DGS (R, T) convention: W2V[:3,:3] = R^T,
    W2V[:3,3] = T."""
    Rt = torch.eye(4, dtype=torch.float32, device=R.device)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = T
    return Rt


def projection_matrix(znear: float, zfar: float, fovx: torch.Tensor,
                      fovy: torch.Tensor, shift: Optional[tuple] = None) -> torch.Tensor:
    """OpenGL-style frustum projection (graphics_utils.py:64-118).

    ``shift``, when given, is ``(focal_x, focal_y, cx, cy, width, height)``
    for a non-centred principal point (getProjectionMatrixShift): the
    focals and the principal point are tensors on the device (a graph
    captures the projection, so none of them is read to the host)."""
    tan_half_fovy = torch.tan(fovy / 2.0)
    tan_half_fovx = torch.tan(fovx / 2.0)

    top = tan_half_fovy * znear
    bottom = -top
    right = tan_half_fovx * znear
    left = -right

    if shift is not None:
        focal_x, focal_y, cx, cy, width, height = shift
        off_x = (cx - width / 2.0) / focal_x * znear
        off_y = (cy - height / 2.0) / focal_y * znear
        top = top + off_y
        bottom = bottom + off_y
        left = left + off_x
        right = right + off_x

    P = torch.zeros((4, 4), dtype=torch.float32, device=fovx.device)
    P[0, 0] = 2.0 * znear / (right - left)
    P[0, 2] = (right + left) / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[1, 2] = (top + bottom) / (top - bottom)
    # fill_, not P[i, j] = float: assigning a Python number to one element
    # copies it from the host, which a CUDA graph cannot capture
    P[2, 2].fill_(zfar / (zfar - znear))
    P[2, 3].fill_(-(zfar * znear) / (zfar - znear))
    P[3, 2].fill_(1.0)
    return P


@dataclass
class Camera:
    """A pinhole camera.

    view [4,4] world->view, proj [4,4] view->clip, full_proj [4,4]
    world->clip (proj @ view), campos [3] camera centre, fovx/fovy scalar
    tensors (radians), width/height pixel resolution.
    """

    view: torch.Tensor
    proj: torch.Tensor
    full_proj: torch.Tensor
    campos: torch.Tensor
    fovx: torch.Tensor
    fovy: torch.Tensor
    width: int
    height: int
    znear: float = 0.01
    zfar: float = 100.0

    @property
    def tan_fovx(self) -> torch.Tensor:
        return torch.tan(self.fovx * 0.5)

    @property
    def tan_fovy(self) -> torch.Tensor:
        return torch.tan(self.fovy * 0.5)

    @property
    def focal_x(self) -> torch.Tensor:
        return self.width / (2.0 * self.tan_fovx)

    @property
    def focal_y(self) -> torch.Tensor:
        return self.height / (2.0 * self.tan_fovy)


def make_camera(
    R,
    T,
    fovx,
    fovy,
    width: int,
    height: int,
    intrinsics=None,
    znear: float = 0.01,
    zfar: float = 100.0,
    device="cuda",
) -> Camera:
    """Build a :class:`Camera` the way volume_rendering/camera_3dgs.py:22-72
    does. ``R``/``T``/``fov*`` may be numpy arrays, floats or tensors.
    ``intrinsics`` (a 3x3 K, numpy or tensor) gives the principal-point-shift
    projection of the NeRSemble benchmark (benchmark/nersemble/
    fateavatar.py:182)."""
    R = torch.as_tensor(R, dtype=torch.float32, device=device)
    T = torch.as_tensor(T, dtype=torch.float32, device=device)
    fovx = torch.as_tensor(fovx, dtype=torch.float32, device=device)
    fovy = torch.as_tensor(fovy, dtype=torch.float32, device=device)
    view = world_to_view(R, T)
    shift = None
    if intrinsics is not None:
        K = torch.as_tensor(intrinsics, dtype=torch.float32, device=device)
        shift = (K[0, 0], K[1, 1], K[0, 2], K[1, 2], width, height)
    proj = projection_matrix(znear, zfar, fovx, fovy, shift)
    # camera centre = inverse(view)[:3, 3] = -R_view^T t_view (rigid)
    campos = -view[:3, :3].T @ view[:3, 3]
    return Camera(
        view=view,
        proj=proj,
        full_proj=proj @ view,
        campos=campos,
        fovx=fovx,
        fovy=fovy,
        width=width,
        height=height,
        znear=znear,
        zfar=zfar,
    )


def make_camera_np(
    R,
    T,
    fovx,
    fovy,
    width: int,
    height: int,
    intrinsics=None,
    znear: float = 0.01,
    zfar: float = 100.0,
    device="cuda",
) -> Camera:
    """:func:`make_camera` with the matrices built in numpy on the host (the
    JAX package's ``make_camera_np``, camera.py:166-227), then moved to
    ``device`` in one transfer per field: no device work before the copy."""
    import numpy as np

    R = np.asarray(R, np.float32)
    T = np.asarray(T, np.float32)
    fovx = np.float32(fovx)
    fovy = np.float32(fovy)

    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = R.T
    view[:3, 3] = T

    top = np.tan(fovy / 2.0) * znear
    bottom = -top
    right = np.tan(fovx / 2.0) * znear
    left = -right
    if intrinsics is not None:
        K = np.asarray(intrinsics, np.float32)
        off_x = (K[0, 2] - width / 2.0) / K[0, 0] * znear
        off_y = (K[1, 2] - height / 2.0) / K[1, 1] * znear
        top += off_y
        bottom += off_y
        left += off_x
        right += off_x
    P = np.zeros((4, 4), np.float32)
    P[0, 0] = 2.0 * znear / (right - left)
    P[0, 2] = (right + left) / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0

    def dev(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(device)

    return Camera(
        view=dev(view),
        proj=dev(P),
        full_proj=dev(P @ view),
        campos=dev(-view[:3, :3].T @ view[:3, 3]),
        fovx=dev(fovx),
        fovy=dev(fovy),
        width=width,
        height=height,
        znear=znear,
        zfar=zfar,
    )


def look_at_camera(eye, target, up, fovx: float, fovy: float, width: int, height: int,
                   device="cuda") -> Camera:
    """A camera at ``eye`` looking at ``target`` (camera.py:230-255 of the
    JAX package): +z forward in view space, as 3DGS has it; the rotation's
    columns are the camera's right, down and forward axes in world space."""
    eye = torch.as_tensor(eye, dtype=torch.float32, device=device)
    target = torch.as_tensor(target, dtype=torch.float32, device=device)
    up = torch.as_tensor(up, dtype=torch.float32, device=device)
    fwd = target - eye
    fwd = fwd / torch.linalg.norm(fwd)
    right = torch.linalg.cross(fwd, up)
    right = right / torch.linalg.norm(right)
    down = torch.linalg.cross(fwd, right)
    R_c2w = torch.stack([right, down, fwd], dim=1)
    # 3DGS convention: Camera(R, T) with R = c2w rotation, T = w2v translation
    T = -R_c2w.T @ eye
    return make_camera(R_c2w, T, fovx, fovy, width, height, device=device)
