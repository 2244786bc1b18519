"""On-disk dataset layouts for the readers, written from given arrays:
IMAvatar (``<root>/<subj>_<mode>/flame_params.json`` + ``matted/<i>.png``)
and INSTA (``transforms_<mode>.json`` + ``images/`` + ``flame/*/<i>.txt``).
Shared by the CPU tests and chip_smoke.py; numpy only, with the PNG writer
passed in (PIL in the tests, the port's own where PIL is absent)."""

import json
import os

import numpy as np


def imavatar_world_mat(w2v: np.ndarray, fx_negative: bool = True) -> np.ndarray:
    """The 3x4 ``world_mat`` that the IMAvatar reader turns into the 4x4
    world->view matrix ``w2v``: its fixups (dataset.py:264-272, sign flips of
    rows, of column 2 and of the z translation) undone, translation x4."""
    wm = np.asarray(w2v, np.float64).copy()
    if fx_negative:
        wm[0, :] *= -1
    wm[:3, 2] *= -1
    wm[2, 3] *= -1
    wm[0, :] *= -1
    wm[1, :] *= -1
    wm = wm[:3]
    wm[:, 3] *= 4
    return wm


def orbit(n: int, distance: float = 0.4, spread: float = 0.6) -> np.ndarray:
    """[n, 4, 4] world->view matrices: yaw from -spread/2 to +spread/2 about
    the head, the camera ``distance`` in front (SyntheticDataset's views)."""
    wm = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        ang = (i / max(n, 1) - 0.5) * spread
        c, s = np.cos(ang), np.sin(ang)
        wm[i, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        wm[i, :3, 3] = [0, 0, distance]
    return wm


def write_imavatar(root, mode, images, w2v, expressions, poses, shape_params,
                   fov, write_png):
    """``root`` is the subject dir (its basename names ``<subj>_<mode>``);
    ``images`` uint8 [H, W, 3 or 4]; ``w2v`` [N, 4, 4] the world->view
    matrices the reader should return; square ``fov`` (radians) from
    normalized intrinsics with the IMAvatar fx < 0 convention."""
    inst = os.path.join(root, f"{os.path.basename(root)}_{mode}")
    os.makedirs(os.path.join(inst, "matted"), exist_ok=True)
    frames = []
    for i, img in enumerate(images):
        write_png(os.path.join(inst, "matted", f"{i}.png"), img)
        frames.append({
            "file_path": f"image/{i}",
            "world_mat": imavatar_world_mat(w2v[i]).tolist(),
            "expression": np.asarray(expressions[i], np.float64).tolist(),
            "pose": np.asarray(poses[i], np.float64).tolist(),
        })
    f = 0.5 / np.tan(fov / 2)
    meta = {"frames": frames,
            "shape_params": np.asarray(shape_params, np.float64).tolist(),
            "intrinsics": [-f, f, 0.5, 0.5]}
    with open(os.path.join(inst, "flame_params.json"), "w") as fh:
        json.dump(meta, fh)


def write_insta(root, mode, images, c2w, rng, write_png, n_exp=100, n_shape=300):
    """An INSTA subject: ``images`` uint8, ``c2w`` [N, 4, 4] camera->world,
    random expression / shape codes and near-identity 6d jaw and eye
    rotations from ``rng``."""
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    for sub in ("exp", "eyes", "jaw", "shape"):
        os.makedirs(os.path.join(root, "flame", sub), exist_ok=True)
    frames = []
    eye6d = np.eye(3)[:2].ravel()
    for i, img in enumerate(images):
        name = f"{i:05d}"
        write_png(os.path.join(root, "images", f"{name}.png"), img)
        np.savetxt(os.path.join(root, "flame", "exp", f"{name}.txt"), rng.normal(size=n_exp))
        np.savetxt(os.path.join(root, "flame", "eyes", f"{name}.txt"),
                   np.concatenate([eye6d, eye6d]) + rng.normal(size=12) * 0.05)
        np.savetxt(os.path.join(root, "flame", "jaw", f"{name}.txt"),
                   eye6d + rng.normal(size=6) * 0.05)
        np.savetxt(os.path.join(root, "flame", "shape", f"{name}.txt"), rng.normal(size=n_shape))
        frames.append({"file_path": f"images/{name}.png",
                       "exp_path": f"flame/exp/{name}.txt",
                       "transform_matrix": np.asarray(c2w[i]).tolist()})
    h, w = images[0].shape[:2]
    meta = {"frames": frames[::-1],     # the reader sorts by frame number
            "fl_x": 1.2 * w, "fl_y": 1.1 * h, "cx": w / 2 + 1.5, "cy": h / 2 - 0.5,
            "w": w, "h": h}
    with open(os.path.join(root, f"transforms_{mode}.json"), "w") as fh:
        json.dump(meta, fh)
