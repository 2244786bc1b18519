"""FLAME asset loading.

Port of ``fateavatar_tpu/flame/loader.py``:

* :func:`load_flame_pickle` reads the official ``generic_model.pkl`` without
  the ``chumpy`` package — a minimal stub module is registered so the legacy
  pickle deserializes into numpy arrays.
* :func:`load_landmark_embedding` reads the reference's
  ``landmark_embedding.npy`` (its ``full_lmk_*`` and ``dynamic_lmk_*``
  entries), which :func:`make_flame` attaches to the model.
* :func:`synthetic_flame_data` / :func:`synthetic_flame` build an
  internally-consistent random head model (same numpy draws as the JAX
  package for the same seed, the landmark embedding included), so the port
  runs without the licensed assets.
"""

from __future__ import annotations

import sys
import types
from typing import Optional

import numpy as np
import torch

from fateavatar_tpu_torch.flame.flame import FlameModel


def _install_chumpy_stub() -> None:
    """Register a minimal ``chumpy`` so legacy FLAME pickles unpickle.

    chumpy ``Ch`` objects pickle their data under ``x``; only the ndarray is
    needed.
    """
    if "chumpy" in sys.modules:
        return

    class Ch:  # noqa: D401 - stub
        def __init__(self, *args, **kwargs):
            self.x = args[0] if args else None

        def __setstate__(self, state):
            self.__dict__.update(state)

        @property
        def r(self):
            return np.asarray(self.x)

        def __array__(self, dtype=None):
            arr = np.asarray(self.x)
            return arr.astype(dtype) if dtype is not None else arr

    mod = types.ModuleType("chumpy")
    mod.Ch = Ch
    ch_mod = types.ModuleType("chumpy.ch")
    ch_mod.Ch = Ch
    reordering = types.ModuleType("chumpy.reordering")

    class _Stub(Ch):
        pass

    for name in ("transpose", "reshape", "Select", "concatenate", "Transpose", "Reshape"):
        setattr(reordering, name, _Stub)
        setattr(ch_mod, name, _Stub)
        setattr(mod, name, _Stub)
    mod.ch = ch_mod
    mod.reordering = reordering
    sys.modules["chumpy"] = mod
    sys.modules["chumpy.ch"] = ch_mod
    sys.modules["chumpy.reordering"] = reordering


def _to_np(x, dtype=np.float32):
    if "scipy.sparse" in str(type(x)):
        x = x.todense()
    return np.array(x, dtype=dtype)


def load_flame_pickle(path: str):
    """Load the raw FLAME pickle into a dict of numpy arrays. The pickle is
    a user-supplied model asset; only load files you trust."""
    import pickle

    _install_chumpy_stub()
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    return {
        "v_template": _to_np(data["v_template"]),
        "shapedirs": _to_np(data["shapedirs"]),
        "posedirs": _to_np(data["posedirs"]),
        "J_regressor": _to_np(data["J_regressor"]),
        "weights": _to_np(data["weights"]),
        "f": _to_np(data["f"], np.int32),
        "kintree_table": _to_np(data["kintree_table"], np.int64),
    }


def _tensor_to_np(x):
    """Entries of landmark_embedding.npy may be pickled torch tensors."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def load_landmark_embedding(path: str):
    """Read the reference's ``landmark_embedding.npy`` (FLAME.py:66-93): a
    pickled dict with the full-68 set (ordered [17 contour ++ 51 static]) and
    the dynamic contour table (79 yaw bins x 17), or plain [L, 4] rows of
    (face, b0, b1, b2). Returns (faces_idx [68] int32, bary [68, 3] float32,
    dynamic_faces [79, 17] int32 or None, dynamic_bary [79, 17, 3] float32
    or None). The file is a user-supplied asset; only load files you trust."""
    raw = np.load(path, allow_pickle=True)
    if raw.dtype == object:
        raw = raw[()]
    dyn_faces = dyn_bary = None
    if isinstance(raw, dict):
        faces = _tensor_to_np(raw["full_lmk_faces_idx"]).reshape(-1)
        bary = _tensor_to_np(raw["full_lmk_bary_coords"]).reshape(-1, 3)
        if "dynamic_lmk_faces_idx" in raw:
            dyn_faces = _tensor_to_np(raw["dynamic_lmk_faces_idx"]).reshape(79, -1).astype(np.int32)
            dyn_bary = _tensor_to_np(raw["dynamic_lmk_bary_coords"]).reshape(
                79, dyn_faces.shape[1], 3).astype(np.float32)
    else:
        faces = raw[:, 0]
        bary = raw[:, 1:4]
    return faces.astype(np.int32), bary.astype(np.float32), dyn_faces, dyn_bary


def make_flame(
    flame_data: dict,
    n_shape: int,
    n_exp: int,
    shape_params: Optional[np.ndarray] = None,
    canonical_expression: Optional[np.ndarray] = None,
    canonical_pose: float = 0.0,
    factor: float = 1.0,
    landmark_embedding: Optional[tuple] = None,
    device="cuda",
) -> FlameModel:
    """Assemble a :class:`FlameModel` the way flame/FLAME.py:56-129 does:
    slice shapedirs to [n_shape | 300:300+n_exp], bake the identity shape
    into v_template, reshape posedirs to [P, V*3], record the canonical
    expression / jaw pose, attach ``landmark_embedding`` (the tuple of
    :func:`load_landmark_embedding`). The assembly is numpy, as in the JAX
    package."""
    v_template = flame_data["v_template"].astype(np.float32) * factor
    shapedirs_full = flame_data["shapedirs"].astype(np.float32)
    total_shape = shapedirs_full.shape[-1]
    exp_start = 300 if total_shape > 300 else n_shape
    shapedirs = np.concatenate(
        [shapedirs_full[:, :, :n_shape],
         shapedirs_full[:, :, exp_start: exp_start + n_exp]],
        axis=2,
    ) * factor

    if shape_params is not None:
        shape_params = np.asarray(shape_params, np.float32).reshape(1, -1)[:, :n_shape]
        v_template = v_template + np.einsum(
            "bl,mkl->bmk", shape_params, shapedirs[:, :, :n_shape]
        )[0]

    # [V, 3, P] -> [V*3, P] -> [P, V*3] (the lbs.py:78 layout)
    posedirs = flame_data["posedirs"].astype(np.float32)
    posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T * factor

    parents = flame_data["kintree_table"][0].astype(np.int64).copy()
    parents[0] = -1

    if canonical_expression is None:
        canonical_exp = np.zeros((1, n_exp), np.float32)
    else:
        canonical_exp = np.asarray(canonical_expression, np.float32).reshape(1, -1)[:, :n_exp]
    cpose = np.zeros((1, 15), np.float32)
    cpose[0, 6] = canonical_pose  # jaw-open canonical pose (FLAME.py:104-105)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)

    lmk = list(landmark_embedding or ()) + [None] * 4
    lmk = [None if x is None else t(x, torch.int64 if i % 2 == 0 else torch.float32)
           for i, x in enumerate(lmk[:4])]

    return FlameModel(
        v_template=t(v_template),
        shapedirs=t(shapedirs),
        posedirs=t(posedirs),
        j_regressor=t(flame_data["J_regressor"]),
        lbs_weights=t(flame_data["weights"]),
        parents=tuple(int(p) for p in parents),
        faces=t(flame_data["f"], torch.int64),
        n_shape=n_shape,
        n_exp=n_exp,
        canonical_exp=t(canonical_exp),
        canonical_pose=t(cpose),
        lmk_faces_idx=lmk[0],
        lmk_bary_coords=lmk[1],
        dynamic_lmk_faces_idx=lmk[2],
        dynamic_lmk_bary_coords=lmk[3],
    )


def synthetic_flame_data(
    n_verts: int = 128,
    n_exp: int = 6,
    seed: int = 0,
):
    """The raw synthetic FLAME assets: a pickle-layout data dict (same keys
    as the official ``generic_model.pkl``) plus a landmark-embedding tuple.
    The same seed gives the same arrays as the JAX package's copy."""
    rng = np.random.default_rng(seed)

    # Fibonacci sphere vertices -> convex hull triangulation
    idx = np.arange(n_verts, dtype=np.float64)
    phi = np.arccos(1.0 - 2.0 * (idx + 0.5) / n_verts)
    theta = np.pi * (1.0 + 5.0**0.5) * idx
    pts = np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)],
        axis=-1,
    ) * 0.1  # head-sized (~10 cm radius)

    from scipy.spatial import ConvexHull

    hull = ConvexHull(pts)
    faces = hull.simplices.astype(np.int32)
    # orient faces outward
    tri = pts[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    c = tri.mean(axis=1)
    flip = (n * c).sum(-1) < 0
    faces[flip] = faces[flip][:, ::-1]

    J = 5
    j_reg = np.abs(rng.normal(size=(J, n_verts))).astype(np.float32)
    j_reg /= j_reg.sum(axis=1, keepdims=True)

    w = np.abs(rng.normal(size=(n_verts, J))).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)

    data = {
        "v_template": pts.astype(np.float32),
        "shapedirs": (rng.normal(size=(n_verts, 3, 300 + n_exp)) * 0.01).astype(np.float32),
        "posedirs": (rng.normal(size=(n_verts, 3, 36)) * 0.001).astype(np.float32),
        "J_regressor": j_reg,
        "weights": w,
        "f": faces,
        "kintree_table": np.array([[-1, 0, 1, 1, 1], [0, 1, 2, 3, 4]], np.int64),
    }
    lmk_faces = rng.integers(0, len(faces), size=68).astype(np.int32)
    lmk_bary = rng.dirichlet(np.ones(3), size=68).astype(np.float32)
    dyn_faces = rng.integers(0, len(faces), size=(79, 17)).astype(np.int32)
    dyn_bary = rng.dirichlet(np.ones(3), size=(79, 17)).astype(np.float32)
    return data, (lmk_faces, lmk_bary, dyn_faces, dyn_bary)


def synthetic_flame(
    n_verts: int = 128,
    n_shape: int = 8,
    n_exp: int = 6,
    seed: int = 0,
    canonical_pose: float = 0.2,
    device="cuda",
) -> FlameModel:
    """A small FLAME-shaped random model (5 joints, sphere-ish mesh) for
    tests and self-contained runs."""
    data, lmk = synthetic_flame_data(n_verts=n_verts, n_exp=n_exp, seed=seed)
    return make_flame(data, n_shape=n_shape, n_exp=n_exp,
                      canonical_pose=canonical_pose, landmark_embedding=lmk,
                      device=device)
