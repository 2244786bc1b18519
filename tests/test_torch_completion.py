"""The PyTorch port's completion path against the JAX package, on the CPU:
the orbit sampler, every alignment function (the port's numpy / torch
re-implementations against the JAX package's OpenCV calls, and against
OpenCV itself), the FLAME landmarks (static and dynamic) and their loader,
``add_default_points``, ``load_mask``, ``PseudoGenerator.run`` with the
mirror provider, ``PseudoDataset``, ``CompletionTrainer``'s re-seed and one
augmentation epoch, and both completion CLIs with ``--device cpu`` (the
mirror provider, then a tiny EG3D ``.pth``).

Sizes are small: a 96-vertex synthetic FLAME whose landmark embedding puts
a face layout on the template's front (``torch_layouts``), a tex-8 avatar
at a 192 capacity, 32x32 renders."""

import dataclasses
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_tracking import _jax_avatar
from torch_layouts import (face_landmark_embedding, face_layout_68, orbit, write_imavatar,
                           write_landmark_embedding, write_network_pkl)
from torch_single_thread import one_torch_thread  # noqa: F401 (autouse fixture)
from fateavatar_tpu.completion import camera_sampler as jcs
from fateavatar_tpu.completion import pseudo as jpseudo
from fateavatar_tpu.completion import trainer as jctrainer
from fateavatar_tpu.flame import flame as jflame
from fateavatar_tpu.flame import loader as jloader
from fateavatar_tpu.models import maintenance as jmaint
from fateavatar_tpu.render.render import RenderConfig as JRenderConfig
from fateavatar_tpu.train import datasets as jdatasets
from fateavatar_tpu.train import losses as jl
from fateavatar_tpu.train import optim as jopt
from fateavatar_tpu.train import step as jstep
from fateavatar_tpu.utils.obj_io import sphere_obj_mesh

from fateavatar_tpu_torch.cli import train_full_avatar, train_generate_pseudo, train_mono_avatar
from fateavatar_tpu_torch.completion import alignment as ta
from fateavatar_tpu_torch.completion import camera_sampler as tcs
from fateavatar_tpu_torch.completion import matting as tmat
from fateavatar_tpu_torch.completion import pseudo as tpseudo
from fateavatar_tpu_torch.completion import restoration as tres
from fateavatar_tpu_torch.completion import segmentation as tseg
from fateavatar_tpu_torch.completion import trainer as tctrainer
from fateavatar_tpu_torch.completion.eg3d import networks as tn
from fateavatar_tpu_torch.completion.eg3d.provider import EG3DPseudoProvider
from fateavatar_tpu_torch.flame import flame as tflame
from fateavatar_tpu_torch.flame import loader as tloader
from fateavatar_tpu_torch.models import fateavatar as tfa
from fateavatar_tpu_torch.models import maintenance as tmaint
from fateavatar_tpu_torch.render.render import RenderConfig
from fateavatar_tpu_torch.train import datasets as tdatasets
from fateavatar_tpu_torch.train import losses as tl
from fateavatar_tpu_torch.train import optim as topt
from fateavatar_tpu_torch.train import step as tstep
from fateavatar_tpu_torch.utils.png import write_png

cv2 = pytest.importorskip("cv2")
from fateavatar_tpu.completion import alignment as ja  # noqa: E402 (needs cv2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, TEX, CAP, NV, N_EXP = 32, 8, 192, 96, 4
# the face layout's pixels -> world units on the 0.1-radius synthetic head
FACE_SCALE = 0.1 / 256 * 2.0
# JAX through its XLA blend (nothing overflows), the port through its
# instance route
JRCFG = JRenderConfig(impl="xla", max_per_tile=256, chunk=32)
RCFG = RenderConfig()
NO_MAINT = dict(densify_interval=10**9, prune_interval=10**9, opacity_reset_interval=10**9)


def t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# ---------------------------------------------------------------------------
# the avatar, with a face-layout landmark embedding, in both packages
# ---------------------------------------------------------------------------

def _flame_assets(n_exp=N_EXP):
    data, _ = tloader.synthetic_flame_data(n_verts=NV, n_exp=n_exp, seed=0)
    return data, face_landmark_embedding(data["v_template"], data["f"], FACE_SCALE)


@pytest.fixture(scope="module")
def avatar():
    data, emb = _flame_assets()
    flame = tloader.make_flame(data, n_shape=6, n_exp=N_EXP, canonical_pose=0.2,
                               landmark_embedding=emb, device="cpu")
    cfg = tfa.FateAvatarConfig(tex_size=TEX, capacity=CAP, img_height=RES, img_width=RES,
                               normal_offset=0.02)
    m, p, s = tfa.init_fateavatar(sphere_obj_mesh(NV), flame, cfg, device="cpu")
    return _jax_avatar(m, p, s), (m, p, s)


@pytest.fixture(scope="module")
def pipelines(avatar, tmp_path_factory):
    """PseudoGenerator.run of both packages (mirror provider, 8 views,
    32x32 crops) on the same avatar."""
    (jm, jp, js), (m, p, s) = avatar
    d = tmp_path_factory.mktemp("pseudo")
    kw = dict(num_views=8, orbit_radius=0.5, crop_size=RES)
    jout = jpseudo.PseudoGenerator(jm, jp, js, jpseudo.PseudoGeneratorConfig(
        out_dir=str(d / "jax"), **kw), render_cfg=JRCFG).run(0.8, 0.8)
    tout = tpseudo.PseudoGenerator(m, p, s, tpseudo.PseudoGeneratorConfig(
        out_dir=str(d / "port"), **kw), render_cfg=RCFG).run(0.8, 0.8)
    return jout, tout, d


# ---------------------------------------------------------------------------
# orbit sampler
# ---------------------------------------------------------------------------

def test_orbit_sampler_matches_jax():
    """cam2world bit-equal (numpy in both); the cameras' view and full
    projection within 1e-6."""
    lookat = np.array([0.01, -0.02, 0.03])
    for h, v in ((0.3, np.pi / 2), (2.5, 1.1), (-1.0, 0.0)):
        np.testing.assert_array_equal(tcs.sample_orbit_pose(h, v, lookat, 2.7),
                                      jcs.sample_orbit_pose(h, v, lookat, 2.7))
    jc, jw = jcs.orbit_cameras(5, lookat, 0.5, 0.8, 0.7, RES, RES,
                               h_range=(np.pi / 2, np.pi / 2 + 2 * np.pi))
    tc_, tw = tcs.orbit_cameras(5, lookat, 0.5, 0.8, 0.7, RES, RES,
                                h_range=(np.pi / 2, np.pi / 2 + 2 * np.pi), device="cpu")
    np.testing.assert_array_equal(tw, jw)
    for a, b in zip(tc_, jc):
        np.testing.assert_allclose(a.view.numpy(), np.asarray(b.view), atol=1e-6)
        np.testing.assert_allclose(a.full_proj.numpy(), np.asarray(b.full_proj), atol=1e-6)


# ---------------------------------------------------------------------------
# alignment: the copied numpy functions, the OpenCV re-implementations
# ---------------------------------------------------------------------------

def test_alignment_numpy_functions_match_jax():
    """The functions copied from the JAX package give the same values."""
    rng = np.random.default_rng(0)
    lm = face_layout_68() * 1.3 + [200, 240] + rng.normal(size=(68, 2))
    for method in ("ffhq", "default"):
        for a, b in zip(ta.get_crop_bound(lm, method), ja.get_crop_bound(lm, method)):
            np.testing.assert_array_equal(a, b)
    lm106 = rng.random((106, 2)) * 300
    np.testing.assert_array_equal(ta.get_crop_bound(lm106)[0], ja.get_crop_bound(lm106)[0])
    for ang in (0.3, 1.5, np.pi / 2 + 0.01, -np.pi / 2 - 0.02):
        R = jcs.sample_orbit_pose(ang, 1.2, np.zeros(3))[:3, :3]
        assert ta.matrix2angle(R) == ja.matrix2angle(R)
        R4 = np.eye(4, dtype=np.float32)
        R4[:3, :3] = R
        np.testing.assert_array_equal(ta.eg3dcamparams(R4), ja.eg3dcamparams(R4))
        t3d = rng.normal(size=2)
        assert ta.pose_reject(R, t3d) == ja.pose_reject(R, t3d)
    for gimbal in (np.array([[0, 0, -1], [0, 1, 0], [1, 0, 0.0]]),
                   np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0.0]])):
        assert ta.matrix2angle(gimbal) == ja.matrix2angle(gimbal)
    quad, c, x, y = ja.get_crop_bound(lm)
    for a, b in zip(ta.refine_quad(c, x, y, np.array([300.0, 200.0]), 512, 1.1),
                    ja.refine_quad(c, x, y, np.array([300.0, 200.0]), 512, 1.1)):
        np.testing.assert_array_equal(a, b)


def _affine(rng, shift=5.0):
    ang, s = rng.random() * 0.6, 0.7 + rng.random() * 0.6
    return np.array([[s * np.cos(ang), -s * np.sin(ang), rng.random() * shift],
                     [s * np.sin(ang), s * np.cos(ang), rng.random() * shift]])


# name -> (port result, OpenCV result, the largest |difference| allowed) on
# seeded inputs; uint8 compared as integers
def _cv_cases():
    rng = np.random.default_rng(1)
    u8 = (rng.random((40, 50, 3)) * 255).astype(np.uint8)
    grey = (rng.random((40, 50)) * 255).astype(np.uint8)
    f32 = rng.random((40, 50)).astype(np.float32)
    M = _affine(rng)
    src3 = (rng.random((3, 2)) * 60).astype(np.float32)
    dst3 = (rng.random((3, 2)) * 60).astype(np.float32)
    quad = ja.get_crop_bound(face_layout_68() + [256, 256])[0]
    bound = np.array([[20, 30], [20, 540], [531, 540], [531, 30]], np.float32)
    dev = "cpu"
    return {
        # OpenCV 5's float path: the same float32 operations
        "warp_linear_u8": (ta.warp_affine(u8, M, (45, 38), device=dev),
                           cv2.warpAffine(u8, M, (45, 38)), 0),
        "warp_linear_grey": (ta.warp_affine(grey, M, (45, 38), device=dev),
                             cv2.warpAffine(grey, M, (45, 38)), 0),
        # float32 sums in another order: one level on < 1e-4 of the values
        "warp_cubic_u8": (ta.warp_affine(u8, M, (45, 38), "cubic", device=dev),
                          cv2.warpAffine(u8, M, (45, 38), flags=cv2.INTER_CUBIC), 1),
        # OpenCV's fixed point (1/32 px, 15-bit tables), emulated exactly
        "warp_lanczos4_reflect_u8": (
            ta.warp_affine(u8, M, (45, 38), "lanczos4", "reflect", device=dev),
            cv2.warpAffine(u8, M, (45, 38), flags=cv2.INTER_LANCZOS4,
                           borderMode=cv2.BORDER_REFLECT), 0),
        "warp_linear_f32": (ta.warp_affine(f32, M, (45, 38), device=dev),
                            cv2.warpAffine(f32, M, (45, 38)), 1e-5),
        "resize_area_x2": (ta.resize_area(u8, (25, 20), dev),
                           cv2.resize(u8, (25, 20), interpolation=cv2.INTER_AREA), 0),
        "resize_cubic_up": (ta.resize(u8, (71, 57), "cubic", dev),
                            cv2.resize(u8, (71, 57), interpolation=cv2.INTER_CUBIC), 1),
        "resize_cubic_down": (ta.resize(u8, (31, 23), "cubic", dev),
                              cv2.resize(u8, (31, 23), interpolation=cv2.INTER_CUBIC), 1),
        "resize_linear_f32": (ta.resize(f32, (71, 33), device=dev), cv2.resize(f32, (71, 33)),
                              1e-5),
        "blur_u8_k21": (ta.box_blur(u8, 21, dev), cv2.blur(u8, (21, 21)), 0),
        "blur_f32_k7": (ta.box_blur(f32, 7, dev), cv2.blur(f32, (7, 7)), 1e-6),
        "get_affine_transform": (ta.get_affine_transform(src3, dst3),
                                 cv2.getAffineTransform(src3, dst3), 1e-10),
        "invert_affine_transform": (ta.invert_affine_transform(M),
                                    cv2.invertAffineTransform(M), 0),
        "estimate_affine_2d": (ta.estimate_affine_2d(quad, bound),
                               cv2.estimateAffine2D(quad, bound)[0], 1e-8),
    }


CV_CASES = ["warp_linear_u8", "warp_linear_grey", "warp_cubic_u8", "warp_lanczos4_reflect_u8",
            "warp_linear_f32", "resize_area_x2", "resize_cubic_up", "resize_cubic_down",
            "resize_linear_f32", "blur_u8_k21", "blur_f32_k7", "get_affine_transform",
            "invert_affine_transform", "estimate_affine_2d"]


@pytest.fixture(scope="module")
def cv_cases():
    return _cv_cases()


@pytest.mark.parametrize("case", CV_CASES)
def test_opencv_reimplementation_matches_opencv(cv_cases, case):
    """Each OpenCV call the alignment makes, on seeded inputs, within the
    stated bound (integers for uint8)."""
    got, want, tol = cv_cases[case]
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    err = np.abs(got.astype(np.float64) - want.astype(np.float64)).max()
    assert err <= tol, f"{case}: {err} > {tol}"
    if case == "warp_cubic_u8":
        assert (got != want).mean() < 1e-3


def _smooth(rng, h, w):
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    base = np.stack([x, y, 0.5 * (x + y)], -1)
    return np.clip(base + 0.05 * rng.random((h, w, 3)), 0, 1).astype(np.float32)


def test_crop_and_paste_back_match_jax():
    """crop_final (upsampled x2 and not, a quad reaching past the image so
    the edge blur runs, the size rejection), paste_back_matrix,
    paste_back_images (with and without masks), and the single-image
    helpers against the JAX package's OpenCV versions: crops equal (one
    level allowed: float64 rounding of the affine matrix), pasted images
    within one level of 255 (the cubic warp's) plus 1e-4 (the float32
    validity mask), the masks within 1e-5, the matrices within 1e-8."""
    rng = np.random.default_rng(2)
    img = _smooth(rng, 64, 64)
    quad = ja.get_crop_bound(face_layout_68() * 0.3 + [30, 26])[0]
    for upsample in (2, 1):
        a = ta.crop_final(img, 64, quad, min_size=None, upsample=upsample, device="cpu")
        b = ja.crop_final(img, 64, quad, min_size=None, upsample=upsample)
        assert a.shape == b.shape == (70, 70, 3)
        assert np.abs(a - b).max() <= 1 / 255 + 1e-7
    assert ta.crop_final(img, 64, quad, min_size=1000, device="cpu") is None
    np.testing.assert_allclose(ta.paste_back_matrix(quad, 64), ja.paste_back_matrix(quad, 64),
                               atol=1e-8)
    pseudo = np.stack([_smooth(rng, 70, 70), _smooth(rng, 50, 60)[:50, :50]
                       .repeat(2, 0)[:70].repeat(2, 1)[:, :70]])
    masks = rng.random((2, 70, 70)).astype(np.float32)
    for m in (None, masks):
        pa, va = ta.paste_back_images(pseudo, quad, out_size=64, bg_color=0.3, masks=m,
                                      device="cpu")
        pb, vb = ja.paste_back_images(pseudo, quad, out_size=64, bg_color=0.3, masks=m)
        assert np.abs(pa - pb).max() <= 1 / 255 + 1e-4 and np.abs(va - vb).max() <= 1e-5
    sq = np.array([[10, 10], [10, 50], [50, 50], [50, 10]], np.float32)
    ca, Ma = tpseudo.PseudoGenerator.crop_with_quad(img, sq, 32, device="cpu")
    cb, Mb = jpseudo.PseudoGenerator.crop_with_quad(img, sq, 32)
    np.testing.assert_allclose(Ma, Mb, atol=1e-10)
    assert np.abs(ca - cb).max() <= 1 / 255 + 1e-7
    pa = tpseudo.PseudoGenerator.paste_back(img, ca, Ma, device="cpu")
    pb = jpseudo.PseudoGenerator.paste_back(img, cb, Mb)
    assert np.abs(pa - pb).max() <= 2 / 255


def test_alignment_runs_without_cv2(monkeypatch):
    """With cv2 hidden (an import of it raises), the port's crop and
    paste-back run, and no module of the port reads OpenCV."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        import cv2 as _  # noqa: F401
    rng = np.random.default_rng(3)
    img = _smooth(rng, 48, 48)
    quad = ta.get_crop_bound(face_layout_68() * 0.25 + [24, 20])[0]
    crop = ta.crop_final(img, 48, quad, min_size=None, device="cpu")
    pasted, valid = ta.paste_back_images(crop[None], quad, out_size=48, device="cpu")
    assert crop.shape == (52, 52, 3) and pasted.shape == (1, 48, 48, 3)
    assert np.isfinite(pasted).all() and 0 < valid.mean() <= 1 and valid.min() >= 0
    for mod in (ta, tpseudo, tctrainer, tn):
        src = open(mod.__file__).read()
        assert "import cv2" not in src and "import jax" not in src, mod.__name__


# ---------------------------------------------------------------------------
# FLAME landmarks and their loader
# ---------------------------------------------------------------------------

def test_flame_landmarks_match_jax(avatar, tmp_path):
    """vertices2landmarks / flame_landmarks, the yaw helpers and the dynamic
    contour selection on posed vertices, yaws from 0 to past +-39 degrees
    (rows 0..78): faces and bins equal, positions within 1e-6;
    load_landmark_embedding reads the same tuple as the JAX package's."""
    (jm, _, _), (m, _, _) = avatar
    data, _ = tloader.synthetic_flame_data(n_verts=NV, n_exp=N_EXP, seed=0)
    _, rand_emb = jloader.synthetic_flame_data(n_verts=NV, n_exp=N_EXP, seed=0)
    jf = jloader.make_flame(data, n_shape=6, n_exp=N_EXP, landmark_embedding=rand_emb)
    tf = tloader.make_flame(data, n_shape=6, n_exp=N_EXP, landmark_embedding=rand_emb,
                            device="cpu")
    rng = np.random.default_rng(4)
    B = 6
    expr = (rng.normal(size=(B, N_EXP)) * 0.3).astype(np.float32)
    pose = (rng.normal(size=(B, 15)) * 0.05).astype(np.float32)
    pose[:, 4] = [0.0, 0.3, -0.3, 0.8, -0.9, 0.05]        # neck yaw
    pose[:, 1] = [0.0, 0.2, -0.4, 0.1, -0.2, 0.3]         # root yaw
    R = np.stack([jcs.sample_orbit_pose(a, np.pi / 2, np.zeros(3))[:3, :3]
                  for a in np.linspace(0, 2 * np.pi, 12)]).astype(np.float32)

    def jax_side(e, q, r):
        v = jflame.flame_forward(jf, e, q)[0]
        return (v, jflame.flame_landmarks(jf, v), jflame.find_dynamic_lmk_idx_and_bcoords(jf, q),
                jflame.flame_landmarks_dynamic(jf, v, q), jflame.rot_mat_to_euler_y(r),
                jflame.dynamic_lmk_rows_from_rot(jf, r))

    jv, jl_, (jfi, jbi), jdyn, jyaw, jrows = jax.jit(jax_side)(
        jnp.asarray(expr), jnp.asarray(pose), jnp.asarray(R))
    tv = tflame.flame_forward(tf, t(expr), t(pose))[0]
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
    np.testing.assert_allclose(tflame.flame_landmarks(tf, tv).numpy(), np.asarray(jl_), atol=1e-6)
    tfi, tbi = tflame.find_dynamic_lmk_idx_and_bcoords(tf, t(pose))
    np.testing.assert_array_equal(tfi.numpy(), np.asarray(jfi))
    np.testing.assert_array_equal(tbi.numpy(), np.asarray(jbi))
    np.testing.assert_allclose(tflame.flame_landmarks_dynamic(tf, tv, t(pose)).numpy(),
                               np.asarray(jdyn), atol=1e-6)
    np.testing.assert_allclose(tflame.rot_mat_to_euler_y(t(R)).numpy(), np.asarray(jyaw),
                               atol=1e-6)
    for a, b in zip(tflame.dynamic_lmk_rows_from_rot(tf, t(R)), jrows):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the avatar's face-layout embedding: the static landmarks agree too
    np.testing.assert_allclose(
        tflame.flame_landmarks(m.flame, tv[:, :NV]).numpy(),
        np.asarray(jflame.flame_landmarks(jm.flame, jv)), atol=1e-6)
    path = str(tmp_path / "landmark_embedding.npy")
    write_landmark_embedding(path, face_landmark_embedding(data["v_template"], data["f"],
                                                           FACE_SCALE))
    for a, b in zip(tloader.load_landmark_embedding(path), jloader.load_landmark_embedding(path)):
        np.testing.assert_array_equal(a, b)
    rows = np.concatenate([rand_emb[0][:, None], rand_emb[1]], axis=1)
    np.save(str(tmp_path / "rows.npy"), rows)
    for a, b in zip(tloader.load_landmark_embedding(str(tmp_path / "rows.npy")),
                    jloader.load_landmark_embedding(str(tmp_path / "rows.npy"))):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# add_default_points, load_mask
# ---------------------------------------------------------------------------

def test_add_default_points_is_bit_exact(avatar):
    """After killing all but 32 splats (and with a full capacity), the
    re-seed writes the same slots, values and touched mask as JAX's."""
    (jm, jp, js), (m, p, s) = avatar
    for keep in (32, CAP):
        alive = np.arange(CAP) < keep
        js_k = js.replace(alive=jnp.asarray(alive))
        s_k = dataclasses.replace(s, alive=torch.from_numpy(alive))
        jp2, js2, jt = jmaint.add_default_points(jm, jp, js_k, seed=3)
        tp2, ts2, tt = tmaint.add_default_points(m, p, s_k, seed=3)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        for f in dataclasses.fields(tp2):
            np.testing.assert_array_equal(getattr(tp2, f.name).numpy(),
                                          np.asarray(getattr(jp2, f.name)), err_msg=f.name)
        for f in dataclasses.fields(ts2):
            a, b = getattr(ts2, f.name).numpy(), np.asarray(getattr(js2, f.name))
            np.testing.assert_array_equal(a.astype(b.dtype), b, err_msg=f.name)
        assert int(tt.sum()) == min(TEX * TEX, CAP - keep)


def test_load_mask_matches_jax(tmp_path):
    """Grey, RGB and RGBA masks written with the port's PNG writer: bit-equal
    with the JAX package's PIL reader at the native size and resized up and
    down (PIL's fixed-point bicubic)."""
    rng = np.random.default_rng(5)
    for i, ch in enumerate((1, 3, 4)):
        img = (rng.random((37, 29, ch)) * 255).astype(np.uint8)
        img[5:20, 4:15] = 255
        path = str(tmp_path / f"m{i}.png")
        write_png(path, img)
        for res in ((29, 37), (32, 32), (61, 45), (13, 17)):
            np.testing.assert_array_equal(tdatasets.load_mask(path, res),
                                          jdatasets.load_mask(path, res), err_msg=f"{ch} {res}")


# ---------------------------------------------------------------------------
# the pipeline, the pseudo set, the completion trainer
# ---------------------------------------------------------------------------

def test_pseudo_generator_run_matches_jax(pipelines):
    """run() with the mirror provider on the face-layout avatar: some front
    views aligned, the back ones rejected, in both packages the same.
    Renders within 1e-5, keypoints within 1e-4 px (float32 projection),
    the accepted indices equal, quads within 1e-4 px, labels within 1e-6,
    crops and pasted views within one level of 255, masks equal; the same
    files written."""
    jout, tout, d = pipelines
    np.testing.assert_allclose(tout["renders"], jout["renders"], atol=1e-5)
    np.testing.assert_allclose(tout["keypoints"], jout["keypoints"], atol=1e-4)
    ja_, ta_ = jout["aligned"], tout["aligned"]
    assert ta_["index"] == ja_["index"] and 0 < len(ta_["index"]) < 8
    np.testing.assert_allclose(np.stack(ta_["quad"]), np.stack(ja_["quad"]), atol=1e-4)
    np.testing.assert_allclose(ta_["label"], ja_["label"], atol=1e-6)
    np.testing.assert_allclose(ta_["front_quad"], ja_["front_quad"], atol=1e-4)
    assert np.abs(ta_["crop"] - ja_["crop"]).max() <= 1 / 255 + 1e-6
    for k in ("pseudo", "pasted"):
        assert np.abs(tout[k] - jout[k]).max() <= 1 / 255 + 1e-6, k
    np.testing.assert_array_equal(tout["masks"], jout["masks"])
    np.testing.assert_array_equal(tout["angles"], jout["angles"])
    for sub in ("image", "mask", "heatmap", "image_aligned", "affine", "novel_views"):
        assert sorted(os.listdir(d / "port" / sub)) == sorted(os.listdir(d / "jax" / sub)), sub


def test_pseudo_dataset_matches_jax(pipelines):
    """Both packages' PseudoDataset over the port's pseudo folder: the same
    frames (middle half), cameras, codes and ground truth."""
    _, _, d = pipelines
    kw = dict(img_res=(RES, RES), n_exp=N_EXP, orbit_radius=0.5,
              flame_canonical_pose=np.full((1, 15), 0.1, np.float32))
    tds = tctrainer.PseudoDataset(str(d / "port"), **kw)
    jds = jctrainer.PseudoDataset(str(d / "port"), **kw)
    assert len(tds) == len(jds) == 4
    for i in range(len(tds)):
        a, b = tds.sample(i), jds.sample(i)
        for k in ("cam_pose", "expression", "flame_pose"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_allclose(a["ground_truth"]["rgb"], b["ground_truth"]["rgb"],
                                   atol=1e-6)
        assert a["img_name"] == b["img_name"]


def test_completion_augmentation_matches_jax(avatar, pipelines, tmp_path):
    """CompletionTrainer on a 2-frame SyntheticDataset and the port's pseudo
    folder, both packages from the same avatar with all but 32 splats
    killed: add_default_points (alive rise the same), then one augmentation
    epoch (real, pseudo, real, pseudo steps, the pseudo draws and random
    backgrounds from the same seed, masks composited): every step's loss
    within 1e-4 relative, the params after within 1e-3 rel L2 each, alive
    equal; a checkpoint saved."""
    (jm, jp, js), (m, p, s) = avatar
    _, _, d = pipelines
    alive = np.arange(CAP) < 32
    js = js.replace(alive=jnp.asarray(alive))
    s = dataclasses.replace(s, alive=torch.from_numpy(alive))
    pkw = dict(img_res=(RES, RES), n_exp=N_EXP, orbit_radius=0.5)
    jtr = jctrainer.CompletionTrainer(
        name="comp", model=jm, params=jp, state=js,
        loss_fn=jl.FateAvatarLoss(jl.FateAvatarLossConfig(rgb_weight=1.0)),
        optimizer=jopt.fateavatar_optimizers({}),
        train_dataset=jdatasets.SyntheticDataset(num_frames=2, img_res=(RES, RES), n_exp=N_EXP),
        workspace=str(tmp_path / "jax"), maint_cfg=jstep.MaintenanceConfig(**NO_MAINT),
        render_cfg=JRCFG, snapshot_interval=10**9,
        pseudo_dataset=jctrainer.PseudoDataset(str(d / "port"), **pkw))
    ttr = tctrainer.CompletionTrainer(
        name="comp", model=m, params=p, state=s,
        loss_fn=tl.FateAvatarLoss(tl.FateAvatarLossConfig(rgb_weight=1.0)),
        optimizer=topt.fateavatar_optimizers({}),
        train_dataset=tdatasets.SyntheticDataset(num_frames=2, img_res=(RES, RES), n_exp=N_EXP),
        workspace=str(tmp_path / "port"), maint_cfg=tstep.MaintenanceConfig(**NO_MAINT),
        render_cfg=RCFG, snapshot_interval=10**9,
        pseudo_dataset=tctrainer.PseudoDataset(str(d / "port"), **pkw))
    jtr.add_default_points()
    ttr.add_default_points()
    n_alive = int(ttr.ts.state.alive.sum())
    assert n_alive == int(jnp.sum(jtr.ts.state.alive)) == 32 + TEX * TEX
    jlosses = []
    jstep_fn = jtr.train_step

    def record(ts, frame):
        ts, aux = jstep_fn(ts, frame)
        jlosses.append(float(aux["loss"]))
        return ts, aux

    jtr.train_step = record
    jtr.augmentation(1)
    ttr.augmentation(1)
    tlosses = [float(a["loss"]) for _, a in ttr.augment_aux]
    assert [k for k, _ in ttr.augment_aux] == ["real", "pseudo"] * 2
    assert ttr.global_step == jtr.global_step == 4
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    for f in dataclasses.fields(ttr.ts.params):
        a, b = getattr(ttr.ts.params, f.name).numpy(), np.asarray(getattr(jtr.ts.params, f.name))
        assert rel_l2(a, b) <= 1e-3, (f.name, rel_l2(a, b))
    np.testing.assert_array_equal(ttr.ts.state.alive.numpy(), np.asarray(jtr.ts.state.alive))
    assert os.listdir(tmp_path / "port" / "checkpoints")


# ---------------------------------------------------------------------------
# both CLIs
# ---------------------------------------------------------------------------

def _cli_assets(ws):
    data, emb = _flame_assets(n_exp=50)
    with open(os.path.join(ws, "flame.pkl"), "wb") as fh:
        pickle.dump(data, fh)
    write_landmark_embedding(os.path.join(ws, "landmarks.npy"), emb)
    mesh = sphere_obj_mesh(NV)
    with open(os.path.join(ws, "head.obj"), "w") as fh:
        fh.writelines(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n" for v in mesh.verts)
        fh.writelines(f"vt {uv[0]:.6f} {uv[1]:.6f}\n" for uv in mesh.uvcoords)
        fh.writelines("f " + " ".join(f"{i + 1}/{i + 1}" for i in f) + "\n"
                      for f in mesh.faces)
    rng = np.random.default_rng(0)
    root = os.path.join(ws, "imavatar", "subj")
    for mode, n in (("train", 2), ("test", 2)):
        imgs = [(rng.random((RES, RES, 4)) * 255).astype(np.uint8) for _ in range(n)]
        write_imavatar(root, mode, imgs, orbit(n), rng.normal(size=(n, 50)) * 0.05,
                       rng.normal(size=(n, 15)) * 0.05, np.zeros(100), 0.8, write_png)
    return root


def test_cli_pseudo_and_full_avatar(tmp_path, monkeypatch):
    """train_mono_avatar (one epoch), then train_generate_pseudo (8 views)
    and train_full_avatar (--finetune_epochs 1) with --device cpu on a
    32x32 IMAvatar layout: first with the mirror provider, then with a tiny
    EG3D G_ema .pth (2 + 2 PTI steps, finite losses). The pseudo folder
    (image/, mask/, heatmap/, trajectory.json), the aligned views, the
    re-seed (the autosized binning caps probed again after it: no instance
    dropped), 2 steps per real frame, finite losses, the orbit video and six
    fixed-view videos (GIFs where ffmpeg is missing). The CLIs crop at 512;
    here at 64 (a monkeypatch), so that the CPU warps 140^2, not 1,126^2.
    Then the plug-ins through the pseudo CLI: the G_ema as an official
    network pickle with GFPGAN (stage ④, at ``tiny_gfpgan_config()`` by a
    monkeypatch: the CLI loads ``GFPGANConfig()``) and MODNet, whose mattes
    win over BiSeNet's masks (stage ⑧); then BiSeNet alone (at infer_size
    64 by a monkeypatch), its binary head masks."""
    cfg_cls = tpseudo.PseudoGeneratorConfig
    monkeypatch.setattr(tpseudo, "PseudoGeneratorConfig",
                        lambda **k: cfg_cls(**{**k, "crop_size": 64}))
    ws = str(tmp_path)
    root = _cli_assets(ws)
    run = os.path.join(ws, "run")
    config = ["--config", os.path.join(REPO, "configs", "fateavatar.yaml")]
    overrides = [
        f"assets.flame_model_path={ws}/flame.pkl", f"assets.template_mesh_path={ws}/head.obj",
        f"assets.landmark_embedding_path={ws}/landmarks.npy",
        f"dataset.img_res=[{RES},{RES}]", "model.tex_size=8", "training.max_points_num=256",
        "loss.vgg_weight=0", "render.max_tiles_per_gaussian=16", f"dataset.root_path={root}",
    ]
    train_mono_avatar.main([*config, "--device", "cpu", "--epochs", "1", f"workspace={run}",
                            "training.epochs.finetune=1", *overrides])
    gcfg = tn.tiny_test_config()
    gen_sd = tn.EG3DGenerator(gcfg, tn.eg3d_random_params(
        torch.Generator().manual_seed(0), gcfg, device="cpu"), device="cpu").state_dict()
    torch.save(gen_sd, os.path.join(ws, "g_ema.pth"))
    for provider in ([], ["--eg3d_weights", os.path.join(ws, "g_ema.pth"),
                          "--pti_w_steps", "2", "--pti_g_steps", "2"]):
        gen = train_generate_pseudo.main([*config, "--device", "cpu", "--workspace", run,
                                          "--num_views", "8", *provider, *overrides])
        out, pdir = gen.result, os.path.join(run, "pseudo")
        assert out["renders"].shape == (8, RES, RES, 3) and out["keypoints"].shape == (8, 68, 3)
        assert 0 < len(out["aligned"]["index"]) < 8
        assert np.isfinite(out["aligned"]["label"]).all()
        for sub in ("image", "mask", "heatmap"):
            assert len(os.listdir(os.path.join(pdir, sub))) == 8, sub
        assert os.path.exists(os.path.join(pdir, "trajectory.json"))
        if provider:
            losses = gen.provider.losses
            assert len(losses["w"]) == len(losses["g"]) == 2
            assert all(np.isfinite([float(v) for v in losses["w"] + losses["g"]]))
        tr = train_full_avatar.main([*config, "--device", "cpu", "--workspace", run,
                                     "--finetune_epochs", "1", *overrides])
        assert int(tr.ts.state.alive.sum()) > 0 and tr.name.endswith("_fullhead")
        assert [k for k, _ in tr.augment_aux] == ["real", "pseudo"] * 2
        assert all(np.isfinite([float(a["loss"]) for _, a in tr.augment_aux]))
        # the caps were probed again on the re-seeded avatar: nothing dropped
        assert not tr.render_cfg.autosize and tr.autosized
        assert sum(int(a["overflow"]) for _, a in tr.augment_aux) == 0
        media = os.path.join(run, "media")
        assert any(os.path.exists(os.path.join(media, "fullhead_orbit" + e))
                   for e in (".mp4", ".gif"))
        assert len(os.listdir(os.path.join(media, "fixed_views"))) == 6

    # the plug-ins through the CLI, from seeded checkpoints in their public
    # layouts (the pickle, {"params_ema": ...}, "module." names, the
    # 79999_iter.pth state dict)
    write_network_pkl(os.path.join(ws, "g.pkl"),
                      {"G_ema": ({k: v.numpy() for k, v in gen_sd.items()}, {})})
    gen_pl = torch.Generator().manual_seed(1)
    torch.save({"params_ema": tres.gfpgan_random_params(gen_pl, tres.tiny_gfpgan_config(),
                                                        device="cpu")},
               os.path.join(ws, "gfpgan.pth"))
    torch.save({f"module.{k}": v for k, v in
                tmat.modnet_random_params(gen_pl, device="cpu").items()},
               os.path.join(ws, "modnet.ckpt"))
    torch.save({k: torch.from_numpy(v) for k, v in tseg.init_bisenet(0).items()},
               os.path.join(ws, "bisenet.pth"))
    tiny = tres.tiny_gfpgan_config()
    monkeypatch.setattr(tres, "GFPGANConfig", lambda: tiny)
    bisenet_fn = tseg.make_bisenet_matting_fn
    monkeypatch.setattr(tseg, "make_bisenet_matting_fn", lambda net: bisenet_fn(net, infer_size=64))
    plugins = ["--gfpgan_weights", os.path.join(ws, "gfpgan.pth"),
               "--modnet_weights", os.path.join(ws, "modnet.ckpt"),
               "--bisenet_weights", os.path.join(ws, "bisenet.pth")]
    gen = train_generate_pseudo.main([*config, "--device", "cpu", "--workspace", run,
                                      "--num_views", "8", "--eg3d_weights",
                                      os.path.join(ws, "g.pkl"), "--pti_w_steps", "1",
                                      "--pti_g_steps", "1", *plugins, *overrides])
    out = gen.result
    assert isinstance(gen.provider, EG3DPseudoProvider) and len(gen.provider.losses["w"]) == 1
    assert isinstance(gen.restorer_fn, tres.GFPGANRestorer)
    assert isinstance(gen.matting_fn, tmat.MODNetMatting)
    assert len(np.unique(out["masks"])) > 2          # soft mattes, not the fallback
    np.testing.assert_array_equal(out["masks"][0], gen.matting_fn(out["pasted"][0]))
    gen = train_generate_pseudo.main([*config, "--device", "cpu", "--workspace", run,
                                      "--num_views", "8", *plugins[4:], *overrides])
    assert isinstance(gen.matting_fn, tseg.BiSeNetMatting) and gen.restorer_fn is None
    masks = gen.result["masks"]
    assert set(np.unique(masks).tolist()) <= {0.0, 1.0}
    np.testing.assert_array_equal(masks[3], gen.matting_fn(gen.result["pasted"][3]))
