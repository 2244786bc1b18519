"""The PyTorch port's serving slice against the JAX package, on the CPU:
``init_fateavatar`` -> ``convert`` -> ``fateavatar_forward`` on a perturbed
avatar, and checkpoint -> ``Loader`` -> ``Reenactor`` through the config
helpers of ``cli/common``."""

import dataclasses
import json
import os
import pickle

import jax  # noqa: F401  (JAX on the CPU, set up by conftest)
import numpy as np
import pytest
import torch

from torch_single_thread import one_torch_thread  # noqa: F401 (autouse fixture)
from fateavatar_tpu.flame import synthetic_flame
from fateavatar_tpu.models import fateavatar as jfa
from fateavatar_tpu.ops.camera import make_camera as jmake_camera
from fateavatar_tpu.render.render import RenderConfig as JRenderConfig
from fateavatar_tpu.utils.obj_io import sphere_obj_mesh

from fateavatar_tpu_torch import convert
from fateavatar_tpu_torch.cli import common
from fateavatar_tpu_torch.flame.loader import synthetic_flame_data
from fateavatar_tpu_torch.models import fateavatar as tfa
from fateavatar_tpu_torch.ops.camera import make_camera
from fateavatar_tpu_torch.render.render import RenderConfig
from fateavatar_tpu_torch.train.checkpoints import CheckpointManager
from fateavatar_tpu_torch.train.loader import Loader, Reenactor, checkpoint_tree
from fateavatar_tpu_torch.utils.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, TEX, CAP, NV = 64, 16, 512, 96


def np_dict(obj):
    """A JAX dataclass as a dict of numpy arrays by field name (nested
    dataclasses as dicts, python scalars kept)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = np_dict(v)
        elif v is None or isinstance(v, (bool, int, float)):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


def perturb(params: dict, seed: int) -> dict:
    """Seeded perturbations of colour, opacity, offset, scale, rotation and
    the FLAME deltas, so the image is not flat grey."""
    rng = np.random.default_rng(seed)
    out = dict(params)
    for k, s in (("features_dc", 0.8), ("opacity", 1.5), ("offset", 1.0),
                 ("scaling", 0.3), ("rotation", 0.3), ("delta_shapedirs", 1e-3),
                 ("delta_posedirs", 1e-3), ("delta_vertex", 2e-3)):
        out[k] = (params[k] + rng.normal(size=params[k].shape) * s).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def avatar():
    flame = synthetic_flame(n_verts=NV, n_shape=8, n_exp=6, seed=0)
    mesh = sphere_obj_mesh(NV)
    cfg = jfa.FateAvatarConfig(tex_size=TEX, capacity=CAP, img_height=RES,
                               img_width=RES, normal_offset=0.02)
    model, params, state = jfa.init_fateavatar(mesh, flame, cfg)
    params = params.replace(**perturb(np_dict(params), seed=1))
    return mesh, model, params, state


def test_init_matches_jax(avatar):
    """The port's own init from the same template and FLAME: the seeded UV
    sampling is bit-exact, derived geometry equal to float32 rounding."""
    mesh, model, params, state = avatar
    flame = convert.flame_model(np_dict(model.flame), device="cpu")
    cfg = tfa.FateAvatarConfig(**dataclasses.asdict(model.cfg))
    m, p, s = tfa.init_fateavatar(mesh, flame, cfg, device="cpu")
    np.testing.assert_array_equal(s.face_index.numpy(), np.asarray(state.face_index))
    np.testing.assert_array_equal(s.bary_coords.numpy(), np.asarray(state.bary_coords))
    np.testing.assert_array_equal(s.alive.numpy(), np.asarray(state.alive))
    for f in ("uvcoords_sample", "mean_scaling", "face_scaling_canonical"):
        np.testing.assert_allclose(getattr(m, f).numpy(), np.asarray(getattr(model, f)),
                                   rtol=1e-5, atol=1e-7, err_msg=f)
    jp = np_dict(jfa.init_fateavatar(mesh, model.flame, model.cfg)[1])
    for f, v in jp.items():
        np.testing.assert_allclose(getattr(p, f).numpy(), v, rtol=1e-5, err_msg=f)


def _port_avatar(model, params, state):
    return (convert.fateavatar_model(np_dict(model), device="cpu"),
            convert.fateavatar_params(np_dict(params), device="cpu"),
            convert.fateavatar_state(np_dict(state), device="cpu"))


@pytest.mark.parametrize("frame", [0, 1])
def test_forward_matches_jax(avatar, frame):
    """The whole slice on a perturbed avatar, twotier binning at the
    config's R = 64, JAX through the Pallas instance kernel (interpret).

    Tolerance: FLAME's einsums and the projection sum in another order in
    the two frameworks (splat means differ by ~1e-6 px), and the blends
    take the transmittance product in another order, which can flip the
    instance that crosses T = 1e-4 at a pixel and move it by up to
    alpha * T <= 1e-4. So the image is held at atol 2e-4 per pixel and 1e-6
    in the mean (measured on these frames: ~6e-7 and ~4e-8); radii,
    overflow and visibility are exact."""
    _, model, params, state = avatar
    rng = np.random.default_rng(10 + frame)
    expr = (rng.normal(size=6) * 0.5).astype(np.float32)
    pose = (rng.normal(size=15) * 0.05).astype(np.float32)
    jcam = jmake_camera(np.eye(3), np.array([0.0, 0.0, 0.4]), 0.8, 0.8, RES, RES)
    ref = jfa.fateavatar_forward(
        model, params, state, expr, pose, jcam,
        render_cfg=JRenderConfig(impl="pallas_interpret", kernel="instances",
                                 binning="twotier", max_tiles_per_gaussian=64))
    m, p, s = _port_avatar(model, params, state)
    cam = make_camera(np.eye(3), [0.0, 0.0, 0.4], 0.8, 0.8, RES, RES, device="cpu")
    out = tfa.fateavatar_forward(
        m, p, s, torch.from_numpy(expr), torch.from_numpy(pose), cam,
        render_cfg=RenderConfig(binning="twotier", max_tiles_per_gaussian=64))
    img, img_ref = out["rgb_image"].numpy(), np.asarray(ref["rgb_image"])
    assert img.shape == (RES, RES, 3) and np.isfinite(img).all()
    assert img.std() > 0.02, "the perturbed avatar must not render flat"
    np.testing.assert_allclose(out["verts"].numpy(), np.asarray(ref["verts"]), atol=2e-6)
    np.testing.assert_array_equal(out["radii"].numpy(), np.asarray(ref["radii"]))
    np.testing.assert_array_equal(out["visibility_filter"].numpy(),
                                  np.asarray(ref["visibility_filter"]))
    assert int(out["overflow"]) == int(ref["overflow"])
    np.testing.assert_allclose(img, img_ref, atol=2e-4)
    assert np.abs(img - img_ref).mean() < 1e-6


def _write_assets(tmp_path):
    """A synthetic FLAME pickle in the 300 + n_exp layout and a matching
    UV template OBJ."""
    data, _ = synthetic_flame_data(n_verts=NV, n_exp=100, seed=2)
    pkl = tmp_path / "flame.pkl"
    with open(pkl, "wb") as fh:
        pickle.dump(data, fh)
    mesh = sphere_obj_mesh(NV)
    obj = tmp_path / "template.obj"
    with open(obj, "w") as fh:
        for v in mesh.verts:
            fh.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for uv in mesh.uvcoords:
            fh.write(f"vt {uv[0]:.6f} {uv[1]:.6f}\n")
        for fc in mesh.faces:
            fh.write("f " + " ".join(f"{i + 1}/{i + 1}" for i in fc) + "\n")
    return pkl, obj


def test_checkpoint_loader_reenactor_round_trip(tmp_path):
    """config -> construct_flame/model -> checkpoint -> Loader / Reenactor
    renders exactly what a direct forward of the saved avatar renders."""
    pkl, obj = _write_assets(tmp_path)
    ws = tmp_path / "ws"
    cfg = load_config(os.path.join(REPO, "configs", "fateavatar.yaml"), [
        f"assets.flame_model_path={pkl}", f"assets.template_mesh_path={obj}",
        f"workspace={ws}", f"model.tex_size={TEX}",
        f"training.max_points_num={CAP}", f"dataset.img_res=[{RES}, {RES}]",
    ])
    flame = common.construct_flame(cfg, device="cpu")
    assert (flame.n_shape, flame.n_exp) == (100, 50)
    model, params, state = common.construct_model(cfg, flame, device="cpu")
    rcfg = common.render_config(cfg)
    assert (rcfg.binning, rcfg.max_tiles_per_gaussian) == ("twotier", 64)

    saved = dataclasses.replace(params, **{
        k: torch.from_numpy(v) for k, v in perturb(
            {f.name: getattr(params, f.name).numpy()
             for f in dataclasses.fields(params)}, seed=3).items()})
    mgr = CheckpointManager(os.path.join(ws, "checkpoints"))
    for step in (1, 2, 3):   # only the newest two survive
        mgr.save(step, checkpoint_tree(saved if step == 3 else params, state,
                                       epoch=step))
    assert mgr.steps() == [2, 3]

    rng = np.random.default_rng(4)
    exprs = (rng.normal(size=(3, 50)) * 0.3).astype(np.float32)
    poses = (rng.normal(size=(3, 15)) * 0.05).astype(np.float32)
    cam = make_camera(np.eye(3), [0.0, 0.0, 0.4], 0.8, 0.8, RES, RES, device="cpu")

    re = Reenactor(model, params, state, str(ws), render_cfg=rcfg)
    assert re.epoch == 3
    frames = re.reenact(exprs, poses, None, cam,
                        out_path=str(tmp_path / "out.gif"))
    assert len(frames) == 3 and (tmp_path / "out.gif").exists()
    for e, p, frame in zip(exprs, poses, frames):
        direct = tfa.fateavatar_inference(model, saved, state, torch.from_numpy(e),
                                          torch.from_numpy(p), cam, render_cfg=rcfg)
        np.testing.assert_array_equal(
            Loader(model, params, state, str(ws), rcfg).render_frame(e, p, cam).numpy(),
            direct.numpy())
        u8 = torch.clamp(torch.round(direct * 255.0), 0, 255).to(torch.uint8).numpy()
        np.testing.assert_array_equal(frame, u8)
        assert frame.std() > 1.0


def test_forward_gradients_match_jax(avatar):
    """Gradients of fateavatar_forward's image (against seeded cotangents)
    w.r.t. every parameter and the screen-space probe, against JAX through
    the Pallas instance kernel (interpret), twotier binning at R = 64.
    Tolerance 1e-4 of each field's largest element and in relative L2 norm
    (FLAME's einsums, the scatter-adds and the blend sum in another order)."""
    _, model, params, state = avatar
    rng = np.random.default_rng(12)
    expr = (rng.normal(size=6) * 0.5).astype(np.float32)
    pose = (rng.normal(size=15) * 0.05).astype(np.float32)
    cot = rng.normal(size=(RES, RES, 3)).astype(np.float32)
    jcam = jmake_camera(np.eye(3), np.array([0.0, 0.0, 0.4]), 0.8, 0.8, RES, RES)
    jcfg = JRenderConfig(impl="pallas_interpret", kernel="instances",
                         binning="twotier", max_tiles_per_gaussian=64)

    def jloss(p, probe):
        out = jfa.fateavatar_forward(model, p, state, expr, pose, jcam,
                                     render_cfg=jcfg, means2d_probe=probe)
        return (out["rgb_image"] * cot).sum()

    jg, jprobe = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        params, np.zeros((2, CAP), np.float32))
    m, p, s = _port_avatar(model, params, state)
    leaves = {f.name: getattr(p, f.name).clone().requires_grad_()
              for f in dataclasses.fields(p)}
    probe = torch.zeros((2, CAP), requires_grad=True)
    cam = make_camera(np.eye(3), [0.0, 0.0, 0.4], 0.8, 0.8, RES, RES, device="cpu")
    out = tfa.fateavatar_forward(
        m, dataclasses.replace(p, **leaves), s, torch.from_numpy(expr),
        torch.from_numpy(pose), cam, means2d_probe=probe,
        render_cfg=RenderConfig(binning="twotier", max_tiles_per_gaussian=64))
    grads = torch.autograd.grad((out["rgb_image"] * torch.from_numpy(cot)).sum(),
                                [*leaves.values(), probe], allow_unused=True)
    refs = [np.asarray(getattr(jg, k)) for k in leaves] + [np.asarray(jprobe)]
    for name, got, ref in zip([*leaves, "probe"], grads, refs):
        got = np.zeros_like(ref) if got is None else got.numpy()
        if name == "features_rest":     # SH degree 0 reads no rest coefficient
            np.testing.assert_array_equal(got, 0.0)
            continue
        assert np.abs(ref).max() > 0, name
        np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max(), err_msg=name)
        assert np.linalg.norm(got - ref) <= 1e-4 * np.linalg.norm(ref), name


def test_training_config_helpers(tmp_path):
    """cli/common's training helpers read configs/fateavatar.yaml: the
    loss refuses vgg_weight > 0 without weights (as the JAX package does),
    autosize reaches the render settings, the maintenance intervals and
    the identity info round-trip."""
    from fateavatar_tpu_torch.train.datasets import SyntheticDataset

    cfg = load_config(os.path.join(REPO, "configs", "fateavatar.yaml"),
                      [f"workspace={tmp_path}"])
    with pytest.raises(ValueError):
        common.construct_loss(cfg, device="cpu")
    lcfg = common.loss_config(cfg)
    assert (lcfg.rgb_weight, lcfg.vgg_weight, lcfg.scale_weight,
            lcfg.scale_threshold, lcfg.laplacian_weight) == (1.0, 0.1, 0.1, 9.0, 1e5)
    no_vgg = load_config(os.path.join(REPO, "configs", "fateavatar.yaml"),
                         ["loss.vgg_weight=0"])
    assert common.construct_loss(no_vgg, device="cpu").vgg_params is None
    assert common.render_config(cfg).autosize
    mc = common.maintenance_config(cfg)
    assert (mc.densify_interval, mc.prune_interval, mc.opacity_reset_interval,
            mc.increase_num, mc.max_points_num) == (3000, 2000, 60000, 1000, 200_000)
    ds = SyntheticDataset(num_frames=2, img_res=(16, 16))
    info = common.save_identity_info(str(tmp_path), ds, cfg)
    assert common.load_identity_info(str(tmp_path)) == json.loads(json.dumps(info))
    assert info["n_exp"] == ds.n_exp and info["dataset_type"] == "synthetic"
