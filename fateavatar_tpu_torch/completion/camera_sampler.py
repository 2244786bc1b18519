"""Orbit / look-at camera sampling for novel-view generation.

Port of ``fateavatar_tpu/completion/camera_sampler.py``
(tools/eg3d_utils/camera_eg3d.py:26-75 of the reference: LookAtPoseSampler +
create_cam2world_matrix): cameras on a sphere around the world origin,
looking at a point, parameterized by horizontal / vertical angles. Numpy,
plus the port's ``make_camera``.
"""

from __future__ import annotations

import numpy as np

from fateavatar_tpu_torch.ops.camera import make_camera


def cam2world_lookat(camera_origin: np.ndarray, lookat: np.ndarray) -> np.ndarray:
    """4x4 cam2world with the forward axis towards ``lookat`` (+y up)."""
    forward = lookat - camera_origin
    forward = forward / np.linalg.norm(forward).clip(1e-8)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(forward, up)
    right = right / np.linalg.norm(right).clip(1e-8)
    down = np.cross(forward, right)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = right
    m[:3, 1] = down
    m[:3, 2] = forward
    m[:3, 3] = camera_origin
    return m


def sample_orbit_pose(horizontal_mean: float, vertical_mean: float,
                      lookat: np.ndarray, radius: float = 2.7) -> np.ndarray:
    """One cam2world on the orbit sphere (camera_eg3d.py:26-54): h is the
    azimuth; v maps equal-area onto the polar angle, phi = arccos(1 - 2 v /
    pi); the sphere is centred at the world origin, not at ``lookat``, as
    the generators' camera labels were."""
    h, v = horizontal_mean, vertical_mean
    v = np.clip(v, 1e-5, np.pi - 1e-5)
    phi = np.arccos(1.0 - 2.0 * (v / np.pi))
    origin = np.array([
        radius * np.sin(phi) * np.cos(np.pi - h),
        radius * np.cos(phi),
        radius * np.sin(phi) * np.sin(np.pi - h),
    ])
    return cam2world_lookat(origin, np.asarray(lookat, np.float64))


def orbit_cameras(num_views: int, lookat, radius: float, fovx: float, fovy: float,
                  width: int, height: int, vertical: float = np.pi / 2,
                  h_range=(0.0, 2 * np.pi), device="cuda"):
    """A full orbit of cameras and their cam2world matrices [V, 4, 4]
    (the loop of train/completion.py:159-251)."""
    cams, c2ws = [], []
    for i in range(num_views):
        h = h_range[0] + (h_range[1] - h_range[0]) * i / max(num_views, 1)
        c2w = sample_orbit_pose(h, vertical, lookat, radius)
        w2c = np.linalg.inv(c2w)
        cams.append(make_camera(w2c[:3, :3].T, w2c[:3, 3], fovx, fovy, width, height,
                                device=device))
        c2ws.append(c2w)
    return cams, np.stack(c2ws)
