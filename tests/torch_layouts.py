"""On-disk dataset layouts for the readers, written from given arrays:
IMAvatar (``<root>/<subj>_<mode>/flame_params.json`` + ``matted/<i>.png``),
INSTA (``transforms_<mode>.json`` + ``images/`` + ``flame/*/<i>.txt``) and
the NeRSemble benchmark export (``calibration.json`` + per-sequence
``flame_params.json`` and train-serial images), a FLAME landmark
embedding with a face layout on a head mesh's front, and StyleGAN-family
network pickles in the upstream ``torch_utils.persistence`` format.
Shared by the CPU tests and chip_smoke.py; numpy only (torch for the
pickles' tensors), with the PNG writer passed in (PIL in the tests, the
port's own where PIL is absent)."""

import collections
import json
import os
import pickle
import sys
import types
from contextlib import contextmanager

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


def face_layout_68(eye_dx=40.0, mouth_dy=60.0) -> np.ndarray:
    """A frontal 68-point layout in image pixels around (0, 0), y down:
    jaw contour 0-16 from (-90, 10) through the chin, brows, nose, eyes
    (rings around (+-eye_dx, 0)) and mouth (corners at (+-25, mouth_dy)),
    the points ``tests/test_alignment.py::_frontal_landmarks`` places."""
    lm = np.zeros((68, 2))
    t = np.linspace(np.pi, 0, 17)
    lm[0:17] = np.stack([90 * np.cos(t), 10 + 100 * np.sin(t) * (t > 0)], -1)
    lm[0], lm[16] = [-90, 10], [90, 10]
    lm[17:22] = np.stack([np.linspace(-65, -15, 5), np.full(5, -25.0)], -1)
    lm[22:27] = np.stack([np.linspace(15, 65, 5), np.full(5, -25.0)], -1)
    lm[27:31] = np.stack([np.zeros(4), np.linspace(-10, 20, 4)], -1)
    lm[31:36] = np.stack([np.linspace(-12, 12, 5), np.full(5, 30.0)], -1)
    lm[33] = [0, 30]
    ring = np.stack([np.cos(np.arange(6) * np.pi / 3), np.sin(np.arange(6) * np.pi / 3)], -1)
    lm[36:42] = [-eye_dx, 0] + 8 * ring
    lm[42:48] = [eye_dx, 0] + 8 * ring
    mouth = np.stack([np.cos(np.arange(20) * np.pi / 10), np.sin(np.arange(20) * np.pi / 10)],
                     -1)
    lm[48:68] = [0, mouth_dy] + mouth * [25, 8]
    lm[48], lm[54] = [-25, mouth_dy], [25, mouth_dy]
    return lm


def face_landmark_embedding(verts, faces, scale):
    """A landmark embedding that puts :func:`face_layout_68` on the front
    (+z) of a head mesh: each point (x, -y) * ``scale`` in world units is
    cast along -z onto the front-most triangle it hits, with its barycentric
    weights. The dynamic contour table repeats the static contour in all 79
    yaw bins. Returns (faces [68], bary [68, 3], dyn_faces [79, 17],
    dyn_bary [79, 17, 3]), the tuple ``load_landmark_embedding`` returns."""
    v = np.asarray(verts, np.float64)
    f = np.asarray(faces, np.int64)
    tri = v[f]                                         # [F, 3, 3]
    pts = face_layout_68() * [1.0, -1.0] * scale       # [68, 2] world x, y
    a, b, c = tri[:, 0, :2], tri[:, 1, :2], tri[:, 2, :2]
    det = (b[:, 1] - c[:, 1]) * (a[:, 0] - c[:, 0]) + (c[:, 0] - b[:, 0]) * (a[:, 1] - c[:, 1])
    det = np.where(np.abs(det) < 1e-12, np.nan, det)
    out_f, out_b = [], []
    for p in pts:
        l0 = ((b[:, 1] - c[:, 1]) * (p[0] - c[:, 0]) + (c[:, 0] - b[:, 0]) * (p[1] - c[:, 1])) / det
        l1 = ((c[:, 1] - a[:, 1]) * (p[0] - c[:, 0]) + (a[:, 0] - c[:, 0]) * (p[1] - c[:, 1])) / det
        l2 = 1 - l0 - l1
        bary = np.stack([l0, l1, l2], -1)
        inside = np.all(bary >= -1e-9, axis=-1)
        z = np.where(inside, np.einsum("fk,fk->f", bary, tri[:, :, 2]), -np.inf)
        i = int(np.argmax(z))
        if not np.isfinite(z[i]):
            raise ValueError(f"landmark {p} misses the mesh")
        out_f.append(i)
        out_b.append(bary[i])
    lmk_f = np.asarray(out_f, np.int32)
    lmk_b = np.clip(np.asarray(out_b, np.float32), 0, 1)
    lmk_b /= lmk_b.sum(-1, keepdims=True)
    return (lmk_f, lmk_b, np.tile(lmk_f[:17], (79, 1)), np.tile(lmk_b[:17], (79, 1, 1)))


def write_landmark_embedding(path, embedding):
    """Save ``embedding`` as the reference's ``landmark_embedding.npy``: a
    pickled dict with its ``full_lmk_*`` and ``dynamic_lmk_*`` entries."""
    faces, bary, dyn_faces, dyn_bary = embedding
    np.save(path, np.array({"full_lmk_faces_idx": faces, "full_lmk_bary_coords": bary,
                            "dynamic_lmk_faces_idx": dyn_faces,
                            "dynamic_lmk_bary_coords": dyn_bary}, dtype=object),
            allow_pickle=True)


def nersemble_frames(rng, n, n_exp, legacy=False, rot=0.05, trans=0.01, expr=0.05):
    """``n`` frames of NeRSemble tracking for ``flame_params.json``: the
    FLAME2023 split (``expression``, ``jaw``, ``neck``, ``eyes`` and the head
    pose as ``rotation`` / ``translation``, at std ``rot`` / ``trans``), or
    with ``legacy`` the pre-composed ``pose`` [15]."""
    frames = []
    for i in range(n):
        fr = {"name": f"{i:05d}", "expression": (rng.normal(size=n_exp) * expr).tolist()}
        if legacy:
            fr["pose"] = (rng.normal(size=15) * 0.02).tolist()
        else:
            fr.update(jaw=(rng.normal(size=3) * 0.02).tolist(),
                      neck=(rng.normal(size=3) * 0.02).tolist(),
                      eyes=(rng.normal(size=6) * 0.02).tolist(),
                      rotation=(rng.normal(size=3) * rot).tolist(),
                      translation=(rng.normal(size=3) * trans).tolist())
        frames.append(fr)
    return frames


def write_nersemble(root, participant, calib, sequences, shape_params, write_png,
                    native=None, scale=1.0, n_shape=None, n_exp=None):
    """A NeRSemble benchmark export (the layout of
    ``scripts/prepare_nersemble.py``) under ``<root>/<participant>``.
    ``calib``: {serial: (K [3, 3], world2cam [4, 4])}; ``sequences``:
    {sequence name, or None for the legacy single-sequence layout at the
    participant directory: (frames, {serial: [uint8 images]})}; ``native``
    (width, height) of K's resolution, omitted from the files when None;
    ``n_shape`` / ``n_exp`` written only when given."""
    pdir = os.path.join(root, participant)
    os.makedirs(pdir, exist_ok=True)
    with open(os.path.join(pdir, "calibration.json"), "w") as fh:
        json.dump({s: {"K": np.asarray(K, np.float64).tolist(),
                       "world2cam": np.asarray(w2c, np.float64).tolist()}
                   for s, (K, w2c) in calib.items()}, fh)
    for seq, (frames, images) in sequences.items():
        sdir = pdir if seq is None else os.path.join(pdir, "sequences", seq)
        meta = {"frames": frames, "scale": scale,
                "shape_params": np.asarray(shape_params, np.float64).tolist()}
        if native is not None:
            meta["native_width"], meta["native_height"] = native
        if n_shape is not None:
            meta["n_shape"] = n_shape
        if n_exp is not None:
            meta["n_exp"] = n_exp
        os.makedirs(sdir, exist_ok=True)
        with open(os.path.join(sdir, "flame_params.json"), "w") as fh:
            json.dump(meta, fh)
        for serial, imgs in images.items():
            idir = os.path.join(sdir, "images", serial)
            os.makedirs(idir, exist_ok=True)
            for fr, img in zip(frames, imgs):
                write_png(os.path.join(idir, fr["name"] + ".png"), img)
    return pdir


# ---------------------------------------------------------------------------
# network pickles in the upstream persistence format
# ---------------------------------------------------------------------------

MODULE_SRC = "raise RuntimeError('embedded network source was executed!')\n"


@contextmanager
def persistence_writer():
    """Throwaway ``torch_utils.persistence`` / ``dnnlib`` modules, so that
    pickling records the real qualified names; yields the ``EasyDict``
    class. Removed on exit: a reader must not need them."""
    saved = {k: sys.modules.get(k) for k in
             ("torch_utils", "torch_utils.persistence", "dnnlib")}
    tu = types.ModuleType("torch_utils")
    pers = types.ModuleType("torch_utils.persistence")

    def _reconstruct_persistent_obj(meta):   # writer side: never called
        raise AssertionError("writer-side reconstructor invoked")

    # pickle records globals by (module, qualname): give the writer-side
    # function the real persistence names
    _reconstruct_persistent_obj.__module__ = "torch_utils.persistence"
    _reconstruct_persistent_obj.__qualname__ = "_reconstruct_persistent_obj"
    pers._reconstruct_persistent_obj = _reconstruct_persistent_obj
    tu.persistence = pers

    dnnlib = types.ModuleType("dnnlib")

    class EasyDict(dict):
        def __getattr__(self, k):
            return self[k]

    EasyDict.__module__ = "dnnlib"
    EasyDict.__qualname__ = "EasyDict"
    dnnlib.EasyDict = EasyDict
    sys.modules.update({"torch_utils": tu, "torch_utils.persistence": pers,
                        "dnnlib": dnnlib})
    try:
        yield EasyDict
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


class _Persisted:
    """Writer-side stand-in for a persistence-wrapped nn.Module: pickles
    exactly like one."""

    def __init__(self, meta):
        self.meta = meta

    def __reduce__(self):
        fn = sys.modules["torch_utils.persistence"]._reconstruct_persistent_obj
        return (fn, (self.meta,))


def nest_state_dict(flat, easydict, class_name="Generator"):
    """flat {'a.b.weight': array} -> a persistence module graph of torch
    tensors (inside :func:`persistence_writer`)."""
    import torch

    params = collections.OrderedDict()
    children = {}
    for k, v in flat.items():
        if "." in k:
            head, rest = k.split(".", 1)
            children.setdefault(head, {})[rest] = v
        else:
            params[k] = torch.from_numpy(np.asarray(v))
    modules = collections.OrderedDict(
        (name, nest_state_dict(sub, easydict, class_name=name))
        for name, sub in children.items())
    state = dict(_parameters=params, _buffers=collections.OrderedDict(),
                 _modules=modules, training=False)
    meta = easydict(type="class", version=6, module_src=MODULE_SRC,
                    class_name=class_name, state=state)
    return _Persisted(meta)


def write_network_pkl(path, nets, protocol=4):
    """An upstream network snapshot: ``nets`` {entry ("G", "G_ema", ...):
    (flat state dict, {attribute: value})}, each entry a persistence module
    graph carrying its attributes (EasyDicts for dict values), beside
    ``training_set_kwargs`` and ``augment_pipe = None``."""
    with persistence_writer() as easydict:
        data = {}
        for entry, (flat, attrs) in nets.items():
            mod = nest_state_dict(flat, easydict)
            for k, v in attrs.items():
                mod.meta["state"][k] = easydict(v) if isinstance(v, dict) else v
            data[entry] = mod
        data["training_set_kwargs"] = easydict(resolution=512)
        data["augment_pipe"] = None
        with open(path, "wb") as fh:
            pickle.dump(data, fh, protocol=protocol)
