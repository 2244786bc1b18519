"""Seeded inputs that both the port and the plain reference receive.

Nothing here imports the port. From ``--seed`` alone it makes:

* the FLAME assets (:func:`flame_data`): a FLAME-shaped model at FLAME's
  5,023 vertices on a head-sized sphere with smooth blend shapes and
  skinning (the repository ships no FLAME pickle), in the official
  pickle's key layout;
* the UV template (:func:`template`) on the same topology;
* random He-initialised VGG16 weights up to ``conv4_3`` (:func:`vgg16_weights`,
  the repository ships none), on the device;
* a trained-looking FateAvatar (:func:`fateavatar_avatar`): splats bound to
  the template's faces (area-weighted faces, uniform barycentric points),
  with seeded colour, opacity, offset, scale and rotation, on the device in
  a few large calls.

Host arrays come from ``numpy.random.default_rng(seed)``, device tensors from
a ``torch.Generator`` on the card seeded with ``seed``: the same seed gives
the same inputs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

N_VERTS = 5023           # FLAME's vertex count
N_JOINTS = 5
VGG_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512)


def _sphere(n_verts: int):
    """Fibonacci-sphere points (10 cm radius) and their outward-oriented
    convex-hull triangles."""
    from scipy.spatial import ConvexHull

    idx = np.arange(n_verts, dtype=np.float64)
    phi = np.arccos(1.0 - 2.0 * (idx + 0.5) / n_verts)
    theta = np.pi * (1.0 + 5.0 ** 0.5) * idx
    pts = np.stack([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta),
                    np.cos(phi)], axis=-1) * 0.1
    faces = ConvexHull(pts).simplices.astype(np.int32)
    tri = pts[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    flip = (n * tri.mean(axis=1)).sum(-1) < 0
    faces[flip] = faces[flip][:, ::-1]
    return pts, faces


# joint anchors of the head (metres): root, neck, jaw, left eye, right eye
JOINT_ANCHORS = np.array([[0.0, 0.0, 0.0], [0.0, -0.06, -0.01], [0.0, -0.04, 0.05],
                          [0.03, 0.02, 0.08], [-0.03, 0.02, 0.08]])


def _smooth_fields(rng, pts, n_fields: int, amp: float, waves: int = 4,
                   freq: float = 30.0) -> np.ndarray:
    """``n_fields`` smooth random displacement fields on ``pts`` [V, 3] as
    [V, 3, n_fields]: each a sum of ``waves`` plane waves per coordinate
    (spatial frequencies ~``freq`` rad/m, so neighbouring vertices move
    together, as FLAME's blend shapes do), of rms ``amp`` metres."""
    A = rng.normal(size=(n_fields, 3, waves)) * amp * math.sqrt(2.0 / waves)
    F = rng.normal(size=(n_fields, waves, 3)) * freq
    P = rng.uniform(0, 2 * math.pi, size=(n_fields, waves))
    arg = np.einsum("vd,kmd->vkm", pts, F) + P[None]
    return np.einsum("vkm,kcm->vck", np.sin(arg), A)


def flame_data(seed: int, n_shape_total: int = 300, n_exp_total: int = 100,
               n_verts: int = N_VERTS) -> dict:
    """FLAME assets in the pickle's layout: ``v_template`` [V, 3],
    ``shapedirs`` [V, 3, n_shape_total + n_exp_total] (the official model's
    300 shape then 100 expression columns), ``posedirs`` [V, 3, 36],
    ``J_regressor`` [5, V], ``weights`` [V, 5], ``f`` [F, 3],
    ``kintree_table`` [2, 5]. The blend shapes and pose correctives are
    smooth random fields (1 cm and 1 mm rms a unit code); the joint
    regressor and skinning weights fall off smoothly from joint anchors near
    FLAME's (jittered by the seed), so a posed or expressive head deforms
    smoothly, as FLAME's does."""
    rng = np.random.default_rng(seed)
    pts, faces = _sphere(n_verts)
    anchors = JOINT_ANCHORS + rng.normal(size=JOINT_ANCHORS.shape) * 0.003
    d2 = ((pts[:, None, :] - anchors[None]) ** 2).sum(-1)            # [V, 5]
    j_reg = np.exp(-d2.T / (2 * 0.02 ** 2))
    j_reg /= j_reg.sum(axis=1, keepdims=True)
    logits = -d2 / (2 * 0.05 ** 2)
    w = np.exp(logits - logits.max(axis=1, keepdims=True))
    w /= w.sum(axis=1, keepdims=True)
    return {
        "v_template": pts.astype(np.float32),
        "shapedirs": _smooth_fields(rng, pts, n_shape_total + n_exp_total, 0.01)
        .astype(np.float32),
        "posedirs": _smooth_fields(rng, pts, 36, 0.001).astype(np.float32),
        "J_regressor": j_reg.astype(np.float32),
        "weights": w.astype(np.float32),
        "f": faces,
        "kintree_table": np.array([[-1, 0, 1, 1, 1], [0, 1, 2, 3, 4]], np.int64),
    }


def template(data: dict):
    """(verts [V, 3], faces [F, 3], uvcoords [V, 2], uvfaces [F, 3]) of the
    head template on the FLAME topology: a spherical UV chart."""
    pts = data["v_template"].astype(np.float64)
    u = (np.arctan2(pts[:, 1], pts[:, 0]) / (2 * np.pi) + 0.5) * 0.98 + 0.01
    v = (pts[:, 2] / 0.1 * 0.5 + 0.5) * 0.98 + 0.01
    uv = np.stack([u, v], axis=-1).astype(np.float32)
    faces = data["f"].astype(np.int32)
    return data["v_template"], faces, uv, faces.copy()


def vgg16_weights(seed: int, device) -> list:
    """He-initialised VGG16 conv weights up to conv4_3 as [(w, b), ...] in
    float32 on ``device``, one ``randn`` per layer."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out, cin = [], 3
    for v in VGG_CFG:
        if v == "M":
            continue
        w = torch.randn((v, cin, 3, 3), generator=gen, device=device) * math.sqrt(2.0 / (cin * 9))
        out.append((w, torch.zeros((v,), device=device)))
        cin = v
    return out


def fateavatar_avatar(seed: int, data: dict, capacity: int, n_splats: int, n_codes: int,
                      device, sh_rest: int = 1) -> tuple:
    """A trained-looking FateAvatar as (params, state) dicts of tensors in
    the port's field names. ``n_splats`` live splats bound to the template:
    faces drawn by area, barycentric points uniform on each face; the dead
    capacity rows bound to face 0 with zero barycentrics, as the port pads
    them; ``n_codes`` is the FLAME model's shape + expression columns.
    Scales around the mean spacing of the splats on the surface, opacities
    around 0.7: an opaque head, as a trained avatar is.
    The FLAME personalization deltas start at zero, as a fresh avatar's do."""
    gen = torch.Generator(device=device).manual_seed(seed)
    verts = torch.as_tensor(data["v_template"], device=device)
    faces = torch.as_tensor(data["f"], dtype=torch.int64, device=device)
    tri = verts[faces]
    area = 0.5 * torch.linalg.norm(torch.linalg.cross(tri[:, 1] - tri[:, 0],
                                                      tri[:, 2] - tri[:, 0]), dim=-1)
    cdf = torch.cumsum(area.double(), 0)
    u = torch.rand((n_splats,), generator=gen, device=device, dtype=torch.float64) * cdf[-1]
    face_index = torch.clamp_max(torch.searchsorted(cdf, u), faces.shape[0] - 1)
    r = torch.rand((n_splats, 2), generator=gen, device=device)
    s = torch.sqrt(r[:, 0])
    bary = torch.stack([1.0 - s, s * (1.0 - r[:, 1]), s * r[:, 1]], dim=-1)
    spacing = math.sqrt(float(area.sum()) / n_splats)

    def noise(shape, std):
        return std * torch.randn(shape, generator=gen, device=device)

    def cap(x, fill=0):
        pad = x.new_full((capacity - n_splats,) + tuple(x.shape[1:]), fill)
        return torch.cat([x, pad])

    rot = torch.cat([torch.ones((n_splats, 1), device=device), noise((n_splats, 3), 0.1)], 1)
    v3 = verts.shape[0] * 3
    params = {
        "offset": cap(noise((n_splats, 1), 0.3)),
        "features_dc": cap(noise((n_splats, 1, 3), 0.8)),
        "features_rest": torch.zeros((capacity, sh_rest, 3), device=device),
        "scaling": cap(math.log(spacing) + noise((n_splats, 3), 0.15)),
        "rotation": cap(rot, 0.0),
        "opacity": cap(1.0 + noise((n_splats, 1), 1.0)),
        "delta_shapedirs": torch.zeros((verts.shape[0], 3, n_codes), device=device),
        "delta_posedirs": torch.zeros((36, v3), device=device),
        "delta_vertex": torch.zeros((verts.shape[0], 3), device=device),
    }
    # the rotation of dead rows is the identity, as the port initialises it
    params["rotation"][n_splats:, 0] = 1.0
    alive = torch.zeros((capacity,), dtype=torch.bool, device=device)
    alive[:n_splats] = True
    zeros = torch.zeros((capacity,), device=device)
    state = {
        "face_index": cap(face_index),
        "bary_coords": cap(bary),
        "alive": alive,
        "xyz_gradient_accum": zeros.clone(),
        "denom": zeros.clone(),
        "sample_flag": zeros.clone(),
        "max_radii2d": zeros.clone(),
    }
    return params, state


# MonoGaussianAvatar's point schedule (monogaussianavatar.py:430-467 of the
# reference): (epoch, points after that epoch's upsample)
MONO_SCHEDULE = ((5, 800), (10, 1600), (15, 3200), (20, 6400), (25, 10000),
                 (30, 20000), (40, 40000), (50, 80000), (60, 100000))


def mono_radius(epoch: int, n_init: int = 400) -> float:
    """The splat radius of MonoGaussianAvatar after ``epoch`` epochs: 0.15
    x 0.75^log2(n_init / 100) at the start, x 0.75 at epochs 5-30, 40 and
    50, x 0.9 at 60."""
    r = 0.15 * 0.75 ** math.log2(n_init / 100)
    for e in range(1, epoch + 1):
        if e in (5, 10, 15, 20, 25, 30, 40, 50):
            r *= 0.75
        elif e == 60:
            r *= 0.9
    return r


def mono_points(seed: int, n_init: int, n_points: int, device, scene_scale: float = 1.0):
    """``n_points`` points as MonoGaussianAvatar's schedule grows them:
    ``n_init`` points on a sphere of radius 0.5 / scene_scale, then at each
    upsample epoch clones of uniformly drawn points with uniform noise of
    the radius at that epoch, until ``n_points``. Returns (points, the
    radius after the last upsample's decay)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    p = torch.rand((n_init, 3), generator=gen, device=device) * 2 - 1
    pts = p / torch.linalg.norm(p, dim=-1, keepdim=True).clamp_min(1e-8) * (0.5 / scene_scale)
    epoch = 0
    for epoch, target in MONO_SCHEDULE:
        target = min(target, n_points)
        if target <= pts.shape[0]:
            continue
        k = target - pts.shape[0]
        src = torch.randint(0, pts.shape[0], (k,), generator=gen, device=device)
        u = torch.rand((k, 3), generator=gen, device=device)
        pts = torch.cat([pts, pts[src] + (u - 0.5) * mono_radius(epoch - 1, n_init)])
        if target >= n_points:
            break
    return pts, mono_radius(epoch, n_init)


def mono_weights(seed: int, shapes: dict, zero: tuple, device) -> dict:
    """Each network's weights by name from the seed: LeCun-normal weights
    (std 1 / sqrt(fan in)), zero biases, and zero weights for the names in
    ``zero`` (the deformer's blend-shape and skinning heads start at zero,
    as the family initialises them). ``shapes``: {net: {name: shape}}."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for net, named in shapes.items():
        out[net] = {}
        for name, shape in named.items():
            if name.endswith("bias") or f"{net}.{name}" in zero:
                out[net][name] = torch.zeros(shape, device=device)
            else:
                out[net][name] = torch.randn(shape, generator=gen, device=device) / math.sqrt(
                    shape[1])
    return out
