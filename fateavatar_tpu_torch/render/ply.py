"""3DGS-compatible PLY import/export for splats.

Port of ``fateavatar_tpu/render/ply.py`` (volume_rendering/gaussian_model.py:
204-269 of the reference, save_ply/load_ply): the de-facto interchange
format of the 3DGS ecosystem: x/y/z, normals (zeros), f_dc_*, f_rest_*,
opacity, scale_*, rot_* properties, binary little-endian. Only ALIVE splats
are exported. The file is byte-identical to the JAX package's for the same
splats, and each package reads the other's.
"""

from __future__ import annotations

import numpy as np
import torch

from fateavatar_tpu_torch.render.splats import Gaussians, make_gaussians


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_ply(path: str, gaussians: Gaussians, xyz=None) -> int:
    """Write alive splats. ``xyz`` overrides positions (e.g. posed).
    Returns the number of splats written."""
    alive = _np(gaussians.alive)
    xyz = _np(xyz if xyz is not None else gaussians.xyz)[alive]
    n = xyz.shape[0]
    f_dc = _np(gaussians.features_dc)[alive].reshape(n, -1)
    # 3DGS PLY stores rest coefficients channel-major
    f_rest = _np(gaussians.features_rest)[alive].transpose(0, 2, 1).reshape(n, -1)
    opacity = _np(gaussians.opacity)[alive].reshape(n, 1)
    scale = _np(gaussians.scaling)[alive]
    rot = _np(gaussians.rotation)[alive]

    props = (
        ["x", "y", "z", "nx", "ny", "nz"]
        + [f"f_dc_{i}" for i in range(f_dc.shape[1])]
        + [f"f_rest_{i}" for i in range(f_rest.shape[1])]
        + ["opacity"]
        + [f"scale_{i}" for i in range(3)]
        + [f"rot_{i}" for i in range(4)]
    )
    data = np.concatenate(
        [xyz, np.zeros_like(xyz), f_dc, f_rest, opacity, scale, rot], axis=1
    ).astype("<f4")

    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
        header += [f"property float {p}" for p in props]
        header += ["end_header", ""]
        f.write("\n".join(header).encode("ascii"))
        f.write(data.tobytes())
    return n


def load_ply(path: str, capacity: int = None, sh_degree: int = None,
             device="cuda") -> Gaussians:
    """Read a 3DGS PLY back into :class:`Gaussians` on ``device`` (padded
    to ``capacity`` with dead slots)."""
    with open(path, "rb") as f:
        props = []
        n = 0
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property float"):
                props.append(line.split()[-1])
            elif line == "end_header":
                break
        data = np.frombuffer(f.read(n * len(props) * 4), dtype="<f4")
        data = data.reshape(n, len(props))

    col = {p: i for i, p in enumerate(props)}
    xyz = data[:, [col["x"], col["y"], col["z"]]]
    n_dc = sum(1 for p in props if p.startswith("f_dc_"))
    n_rest = sum(1 for p in props if p.startswith("f_rest_"))
    f_dc = data[:, [col[f"f_dc_{i}"] for i in range(n_dc)]].reshape(n, 1, 3)
    if n_rest:
        f_rest = data[:, [col[f"f_rest_{i}"] for i in range(n_rest)]]
        f_rest = f_rest.reshape(n, 3, n_rest // 3).transpose(0, 2, 1)
    else:
        f_rest = np.zeros((n, 1, 3), np.float32)
    opacity = data[:, [col["opacity"]]]
    scale = data[:, [col[f"scale_{i}"] for i in range(3)]]
    rot = data[:, [col[f"rot_{i}"] for i in range(4)]]

    if sh_degree is None:
        k = n_rest // 3 + 1
        sh_degree = int(np.sqrt(k)) - 1

    cap = capacity or n

    def pad(x):
        return np.concatenate(
            [x, np.zeros((cap - n,) + x.shape[1:], x.dtype)], axis=0
        ) if cap > n else x[:cap]

    alive = pad(np.ones((n,), bool)) if cap > n else np.ones((cap,), bool)
    return make_gaussians(pad(xyz), pad(scale), pad(rot), pad(opacity), pad(f_dc),
                          pad(f_rest), alive, sh_degree=sh_degree, device=device)
