"""The NeRSemble benchmark slice of the PyTorch port against the JAX package,
on the CPU: the intrinsics-shift camera, the dataset on the v2, legacy and
mixed export layouts (written by ``tests/torch_layouts.py``), the forward
with K and a world transform, one train step with the LPIPS and
normal-consistency terms, the Trainer's scan epoch on NeRSemble frames
against its per-step epoch, the submission renders and the CLI end to end.

Sizes are small: a 96-vertex synthetic FLAME, a tex-8 avatar at a 128
capacity, 32x32 frames; JAX on ``impl="xla"`` (the plain blend), one jit
for its forward and its step."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_lpips import lpips_random_params_jax
from test_torch_model import np_dict, perturb
from torch_layouts import nersemble_frames, write_nersemble
from torch_single_thread import one_torch_thread  # noqa: F401 (autouse fixture)
from fateavatar_tpu.benchmark import nersemble as jners
from fateavatar_tpu.flame import synthetic_flame as jsynthetic_flame
from fateavatar_tpu.models import fateavatar as jfa
from fateavatar_tpu.ops import camera as jcam
from fateavatar_tpu.render.render import RenderConfig as JRenderConfig
from fateavatar_tpu.train import losses as jl
from fateavatar_tpu.utils.obj_io import sphere_obj_mesh

from fateavatar_tpu_torch import convert
from fateavatar_tpu_torch.benchmark import nersemble as tners
from fateavatar_tpu_torch.cli import run_nersemble_benchmark
from fateavatar_tpu_torch.flame.loader import synthetic_flame_data
from fateavatar_tpu_torch.ops import camera as tcam
from fateavatar_tpu_torch.render.render import RenderConfig
from fateavatar_tpu_torch.train import losses as tl
from fateavatar_tpu_torch.train import lpips as tlp
from fateavatar_tpu_torch.train import optim as topt
from fateavatar_tpu_torch.train import step as tstep
from fateavatar_tpu_torch.train.step import MaintenanceConfig, train_state_tensors
from fateavatar_tpu_torch.train.trainer import Trainer
from fateavatar_tpu_torch.utils.png import write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, TEX, CAP, NV, N_SHAPE, N_EXP, N_FRAMES = 32, 8, 128, 96, 6, 4, 3
TRAIN, HOLD = tners.DEFAULT_TRAIN_SERIAL, tners.DEFAULT_HOLD_OUT_SERIALS
NATIVE = (64, 48)        # K's resolution, rescaled per axis to RES x RES
JRC = JRenderConfig(impl="xla", max_per_tile=512, chunk=32)
TRC = RenderConfig()
LOSS_CFG = dict(rgb_weight=1.0, lpips_weight=0.1, normal_weight=0.05,
                laplacian_weight=1e5)
NO_MAINT = dict(densify_interval=10**9, prune_interval=10**9, opacity_reset_interval=10**9)
FIELDS = ("offset", "features_dc", "features_rest", "scaling", "rotation",
          "opacity", "delta_shapedirs", "delta_posedirs", "delta_vertex")


def t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


def native_K():
    """Off-centre principal point at the native resolution."""
    return np.array([[80.0, 0, NATIVE[0] / 2 + 4], [0, 60.0, NATIVE[1] / 2 - 3], [0, 0, 1]])


def world2cam(i):
    w2c = np.eye(4)
    a = 0.1 * i
    w2c[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    w2c[:3, 3] = [0.02 * i, 0.0, 0.4]
    return w2c


def write_layout(root, kind, serials=(TRAIN, HOLD[0]), seed=0):
    """``kind``: 'v2' (sequences SEQ-A and SEQ-B in the FLAME2023 split),
    'legacy' (one sequence at the participant dir, pre-composed poses, no
    native size), 'mixed' (SEQ-A split, SEQ-B legacy). Images for the
    first serial only."""
    rng = np.random.default_rng(seed)

    def seq(legacy):
        frames = nersemble_frames(rng, N_FRAMES, N_EXP, legacy=legacy)
        imgs = [(rng.random((RES, RES, 3)) * 255).astype(np.uint8) for _ in frames]
        return frames, {serials[0]: imgs}

    seqs = {"legacy": {None: seq(True)}, "v2": {"SEQ-A": seq(False), "SEQ-B": seq(False)},
            "mixed": {"SEQ-A": seq(False), "SEQ-B": seq(True)}}[kind]
    write_nersemble(root, "393", {s: (native_K(), world2cam(i)) for i, s in enumerate(serials)},
                    seqs, rng.normal(size=N_SHAPE) * 0.1, write_png,
                    native=None if kind == "legacy" else NATIVE, scale=1.03,
                    n_shape=N_SHAPE, n_exp=N_EXP)
    return root


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    base = tmp_path_factory.mktemp("nersemble")
    return {k: write_layout(str(base / k), k) for k in ("v2", "legacy", "mixed")}


def test_make_camera_intrinsics_matches_jax():
    """``make_camera(intrinsics=K)`` against JAX's ``make_camera`` and its
    numpy twin ``make_camera_np`` (1e-6), and ``focal2fov`` / ``fov2focal``."""
    assert tcam.focal2fov(40.0, 32) == jcam.focal2fov(40.0, 32)
    assert tcam.fov2focal(0.7, 48) == jcam.fov2focal(0.7, 48)
    assert abs(tcam.fov2focal(tcam.focal2fov(40.0, 32), 32) - 40.0) < 1e-9
    R, T = world2cam(2)[:3, :3].T, np.array([0.01, -0.02, 0.45])
    K = native_K()
    got = tcam.make_camera(R, T, 0.8, 0.7, NATIVE[0], NATIVE[1], intrinsics=K, device="cpu")
    for ref in (jcam.make_camera(R, T, 0.8, 0.7, NATIVE[0], NATIVE[1], intrinsics=K),
                jcam.make_camera_np(R, T, 0.8, 0.7, NATIVE[0], NATIVE[1], intrinsics=K)):
        for k in ("view", "proj", "full_proj", "campos"):
            np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(ref, k)),
                                       atol=1e-6, err_msg=k)
    centred = tcam.make_camera(R, T, 0.8, 0.7, NATIVE[0], NATIVE[1], device="cpu")
    assert float((got.proj - centred.proj).abs().max()) > 0.05


@pytest.mark.parametrize("kind", ["v2", "legacy", "mixed"])
def test_dataset_matches_jax(layouts, kind, capsys):
    """Both packages' datasets on one export: K rescaled per axis, FOVs,
    codes, composed poses, world transforms (the identity for legacy
    frames of a mixed layout, none for a pure legacy one), cameras (1e-6)
    and every sample; the missing-native-size warning on the legacy layout."""
    root = layouts[kind]
    j = jners.NersembleBenchmarkDataset(root, "393", TRAIN, (RES, RES))
    p = tners.NersembleBenchmarkDataset(root, "393", TRAIN, (RES, RES))
    out = capsys.readouterr().out
    assert out.count("lacks native_width") == (2 if kind == "legacy" else 0)
    assert len(p) == len(j) == (N_FRAMES if kind == "legacy" else 2 * N_FRAMES)
    assert (p.n_shape, p.n_exp, p.sequence_list) == (j.n_shape, j.n_exp, j.sequence_list)
    for k in ("K", "expressions", "flame_pose", "world_mats", "shape_params",
              "mean_expression", "var_expression"):
        np.testing.assert_array_equal(getattr(p, k), getattr(j, k), err_msg=k)
    assert (p.fovx, p.fovy) == (j.fovx, j.fovy)
    if kind == "legacy":
        assert p.world_transforms is None and j.world_transforms is None
    else:
        np.testing.assert_array_equal(p.world_transforms, j.world_transforms)
        np.testing.assert_array_equal(p.world_transforms[:N_FRAMES, 6], np.float32(1.03))
        np.testing.assert_array_equal(p.flame_pose[:N_FRAMES, :3], 0.0)
    if kind == "mixed":
        np.testing.assert_array_equal(p.world_transforms[N_FRAMES:],
                                      np.tile([0, 0, 0, 0, 0, 0, 1], (N_FRAMES, 1)))
    assert [r.img_name for r in p.records] == [r.img_name for r in j.records]
    for i in range(len(p)):
        a, b = p.sample(i), j.sample(i)
        assert sorted(a) == sorted(b)
        for k in ("intrinsics_K", "expression", "flame_pose", "cam_pose",
                  *(("world_transform",) if kind != "legacy" else ())):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(a["ground_truth"]["rgb"], b["ground_truth"]["rgb"])
    cp, cj = p.camera(1, RES, RES, device="cpu"), j.camera(1, RES, RES)
    for k in ("view", "proj", "full_proj", "campos"):
        np.testing.assert_allclose(getattr(cp, k).numpy(), np.asarray(getattr(cj, k)),
                                   atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# the forward and one step against JAX
# ---------------------------------------------------------------------------

def _frame_inputs(ds, i):
    s = ds.sample(i)
    w2c = s["cam_pose"]
    return dict(R=w2c[:3, :3].T, T=w2c[:3, 3], fovx=s["fovx"], fovy=s["fovy"],
                K=s["intrinsics_K"], wt=s["world_transform"], expr=s["expression"],
                pose=s["flame_pose"], rgb=s["ground_truth"]["rgb"])


@pytest.fixture(scope="module")
def pair(layouts):
    """Both packages on one avatar, one NeRSemble frame (K off-centre, a
    world transform) and the loss with LPIPS (alex) and normal consistency:
    JAX's image, losses and gradients from one jit; the port's forward and
    step."""
    flame = jsynthetic_flame(n_verts=NV, n_shape=N_SHAPE, n_exp=N_EXP, seed=0)
    cfg = jfa.FateAvatarConfig(tex_size=TEX, capacity=CAP, img_height=RES, img_width=RES,
                               normal_offset=0.02)
    # one jit (run eagerly, each of its ops compiles on its own); the
    # template and FLAME enter as constants, which XLA need not fold
    model, params, state = jax.jit(
        lambda: jfa.init_fateavatar(sphere_obj_mesh(NV), flame, cfg)).lower().compile(
            {"xla_disable_hlo_passes": "constant_folding"})()
    params = params.replace(**perturb(np_dict(params), seed=1))
    jlpips = lpips_random_params_jax(1, ("alex",))["alex"]
    ds = jners.NersembleBenchmarkDataset(layouts["v2"], "393", TRAIN, (RES, RES))
    f = _frame_inputs(ds, N_FRAMES + 1)

    def loss_fn(p, probe, lins_convs, x):
        jloss = jl.FateAvatarLoss(jl.FateAvatarLossConfig(**LOSS_CFG), faces=model.faces,
                                  lpips_params=jl_lpips(*lins_convs))
        cam = jcam.make_camera(x["R"], x["T"], x["fovx"], x["fovy"], RES, RES,
                               intrinsics=x["K"])
        out = jfa.fateavatar_forward(model, p, state, x["expr"], x["pose"], cam,
                                     render_cfg=JRC, means2d_probe=probe,
                                     world_transform=x["wt"])
        losses = jloss(out, {"rgb": x["rgb"]})
        return losses["loss"], (losses, out["rgb_image"])

    def jl_lpips(convs, lins):
        from fateavatar_tpu.train.lpips import LpipsParams
        return LpipsParams("alex", convs, lins)

    grad = jax.jit(jax.grad(loss_fn, argnums=(0, 1), has_aux=True))
    (jgrads, jprobe), (jlosses, jimg) = grad(
        params, jnp.zeros((2, CAP), jnp.float32), (jlpips.convs, jlpips.lins),
        {k: jnp.asarray(np.asarray(v, np.float32)) for k, v in f.items()})

    tmodel = convert.fateavatar_model(np_dict(model), device="cpu")
    tparams = convert.fateavatar_params(np_dict(params), device="cpu")
    tstate = convert.fateavatar_state(np_dict(state), device="cpu")
    tloss = tl.FateAvatarLoss(tl.FateAvatarLossConfig(**LOSS_CFG), faces=tmodel.faces,
                              lpips_params=convert.lpips_params_from_jax(jlpips, device="cpu"))
    ts = tstep.init_train_state(tparams, tstate, topt.fateavatar_optimizers({}))
    tds = tners.NersembleBenchmarkDataset(layouts["v2"], "393", TRAIN, (RES, RES))
    tf = _frame_inputs(tds, N_FRAMES + 1)
    cam = tcam.make_camera(tf["R"], tf["T"], tf["fovx"], tf["fovy"], RES, RES,
                           intrinsics=tf["K"], device="cpu")
    frame = tstep.Frame(expression=t(tf["expr"]), flame_pose=t(tf["pose"]), camera=cam,
                        rgb=t(tf["rgb"]), bg_color=tmodel.bg_color,
                        world_transform=t(tf["wt"]))
    step = tstep.make_train_step(tmodel, tloss, topt.fateavatar_optimizers({}),
                                 MaintenanceConfig(**NO_MAINT), TRC)
    tgrads, tprobe, _, tlosses = step.grads(ts, frame)
    return dict(jgrads=jgrads, jprobe=jprobe, jlosses=jlosses, jimg=np.asarray(jimg),
                tgrads=tgrads, tprobe=tprobe, tlosses=tlosses, model=tmodel, ts=ts,
                frame=frame, tds=tds)


def _image(pair, **kw):
    from fateavatar_tpu_torch.models.fateavatar import fateavatar_forward

    f = pair["frame"]
    kw = {"camera": f.camera, "world_transform": f.world_transform, **kw}
    with torch.no_grad():
        return fateavatar_forward(pair["model"], pair["ts"].params, pair["ts"].state,
                                  f.expression, f.flame_pose, render_cfg=TRC,
                                  **kw)["rgb_image"]


def test_forward_with_intrinsics_and_world_transform(pair):
    """The frame with K and its world transform within 5e-5 of JAX's; the
    identity transform renders what no transform renders (1e-6); a centred
    K and the identity transform each move the frame (> 1e-3)."""
    img = _image(pair)
    np.testing.assert_allclose(img.numpy(), pair["jimg"], atol=5e-5)
    assert float(img.std()) > 0.02
    ident = t([0, 0, 0, 0, 0, 0, 1])
    none = _image(pair, world_transform=None)
    np.testing.assert_allclose(_image(pair, world_transform=ident).numpy(), none.numpy(),
                               atol=1e-6)
    assert float((none - img).abs().max()) > 1e-3
    f = pair["frame"]
    c = f.camera
    centred = tcam.make_camera(c.view[:3, :3].T, c.view[:3, 3], c.fovx, c.fovy, RES, RES,
                               device="cpu")
    assert float((_image(pair, camera=centred) - img).abs().max()) > 1e-3


def test_train_step_matches_jax(pair):
    """One step's gradient phase on the NeRSemble frame, the loss with
    LPIPS and normal consistency: losses within 2e-6 relative; every
    gradient and the probe's within 8e-5 of each field's largest element
    (float32 sums in another order; see tests/test_torch_train.py)."""
    s = pair
    assert sorted(s["tlosses"]) == sorted(s["jlosses"])
    for k, v in s["jlosses"].items():
        assert float(v) > 0, k
        np.testing.assert_allclose(float(s["tlosses"][k].detach()), float(v), rtol=2e-6, err_msg=k)
    for f in FIELDS + ("probe",):
        ref = np.asarray(s["jprobe"] if f == "probe" else getattr(s["jgrads"], f))
        got = (s["tprobe"] if f == "probe" else getattr(s["tgrads"], f)).numpy()
        np.testing.assert_allclose(got, ref, atol=8e-5 * np.abs(ref).max(), err_msg=f)
        if f != "features_rest":   # SH degree 0 reads no rest coefficient
            assert np.abs(ref).max() > 0, f


# ---------------------------------------------------------------------------
# the Trainer, the submission renders and the CLI
# ---------------------------------------------------------------------------

def _trainer(root, pair, scan, lpips_path=None):
    """A Trainer on the v2 export's train serial (6 frames), the loss with
    LPIPS (alex, random) and normal consistency, densify every 4 and prune
    every 5 steps (so epoch 2's steps 10 and 12 run eagerly in scan mode)."""
    ds = tners.NersembleBenchmarkDataset(root, "393", TRAIN, (RES, RES))
    loss = tl.FateAvatarLoss(
        tl.FateAvatarLossConfig(**LOSS_CFG), faces=pair["model"].faces,
        lpips_params=tlp.lpips_random_params(torch.Generator().manual_seed(0), "alex",
                                             device="cpu"))
    ts = pair["ts"]
    tr = Trainer("n", pair["model"], ts.params, ts.state, loss, topt.fateavatar_optimizers({}),
                 ds, maint_cfg=MaintenanceConfig(densify_interval=4, prune_interval=5,
                                                 increase_num=8, max_points_num=CAP),
                 render_cfg=TRC, device_frame_cache="on", lpips_weights_path=lpips_path)
    tr._scan_disabled = not scan
    return tr


def test_scan_epoch_matches_per_step(layouts, pair, tmp_path):
    """Epoch 2 as the scan epoch (the frames' K and world transforms
    stacked on the device, the camera and transform read at the cursor)
    equals the per-step epoch bit for bit: losses, params, state, Adam
    moments and count. Evaluation with LPIPS weights reports a finite
    LPIPS beside the other four."""
    lpips_path = str(tmp_path / "alex.npz")
    tlp.save_lpips_npz(lpips_path, tlp.lpips_random_params(
        torch.Generator().manual_seed(2), "alex", device="cpu"))
    scan, ref = (_trainer(layouts["v2"], pair, s, lpips_path) for s in (True, False))
    for e in (1, 2):
        for tr in (scan, ref):
            tr.epoch = e
            tr.train_epoch()
    assert scan.last_epoch_stats["mode"] == "scan" and ref.last_epoch_stats["mode"] == "per-step"
    assert "intrinsics_K" in scan._scan_frames and "world_transform" in scan._scan_frames
    assert scan.epoch_losses == ref.epoch_losses
    for a, b in zip(train_state_tensors(scan.ts), train_state_tensors(ref.ts)):
        assert torch.equal(a, b)
    summary = scan.evaluate("train", save_media=False)
    assert sorted(summary) == ["l1", "l2", "lpips", "psnr", "ssim"]
    assert np.isfinite(summary["lpips"]) and summary["lpips"] > 0


def _gif_frames(path):
    from PIL import Image

    with Image.open(path) as im:
        return im.n_frames


def _video(path):
    """write_video's output: the mp4 where ffmpeg is installed, else a GIF."""
    gif = os.path.splitext(path)[0] + ".gif"
    return path if os.path.exists(path) else gif


def test_render_submission_and_hold_out_serials(layouts, pair, tmp_path):
    """Each hold-out frame through the frame's graph (the CPU runs its
    function) equals the eager forward clipped to [0, 1], bit for bit;
    ``render_submission`` writes one video per sequence x serial and
    ``render_hold_out_serials`` one per serial on the legacy layout, with
    every frame."""
    m, ts = pair["model"], pair["ts"]
    ds = tners.NersembleBenchmarkDataset(layouts["v2"], "393", HOLD[0], (RES, RES),
                                         sequence_list=["SEQ-B"], mode="test")
    frames = tners._render_sequence(m, ts.params, ts.state, ds, (RES, RES), TRC)
    cam = ds.camera(0, RES, RES, device="cpu")
    from fateavatar_tpu_torch.models.fateavatar import fateavatar_forward
    for i, fr in enumerate(frames):
        with torch.no_grad():
            ref = fateavatar_forward(m, ts.params, ts.state, t(ds.expressions[i]),
                                     t(ds.flame_pose[i]), cam, render_cfg=TRC,
                                     world_transform=t(ds.world_transforms[i]))["rgb_image"]
        np.testing.assert_array_equal(fr, torch.clamp(ref, 0, 1).numpy())
    assert len(frames) == N_FRAMES

    vids = tners.render_submission(m, ts.params, ts.state, layouts["v2"], "393",
                                   sequences=["SEQ-A", "SEQ-B"], serials=[TRAIN, HOLD[0]],
                                   img_res=(RES, RES), submit_dir=str(tmp_path / "sub"),
                                   render_cfg=TRC, log_fn=lambda msg: None)
    assert [os.path.relpath(v, tmp_path / "sub") for v in vids] == [
        os.path.join("393", q, f"cam_{s}.mp4")
        for q in ("SEQ-A", "SEQ-B") for s in (TRAIN, HOLD[0])]
    legacy = tners.render_hold_out_serials(m, ts.params, ts.state, layouts["legacy"], "393",
                                           (HOLD[0],), (RES, RES), str(tmp_path / "old"), TRC)
    assert [os.path.basename(v) for v in legacy] == [f"393_cam_{HOLD[0]}.mp4"]
    for v in vids + legacy:
        path = _video(v)
        assert os.path.exists(path), v
        if path.endswith(".gif"):
            assert _gif_frames(path) == N_FRAMES


def test_cli_end_to_end(tmp_path):
    """``cli/run_nersemble_benchmark`` with ``--device cpu`` on a v2 export
    with the default serials: 2 epochs over the train serial's 6 frames (the
    second as the scan epoch), then 2 sequences x (4 hold-outs + the train
    serial) submission videos."""
    ws = str(tmp_path)
    data, _ = synthetic_flame_data(n_verts=NV, n_exp=N_EXP, seed=0)
    with open(os.path.join(ws, "flame.pkl"), "wb") as fh:
        pickle.dump(data, fh)
    mesh = sphere_obj_mesh(NV)
    with open(os.path.join(ws, "head.obj"), "w") as fh:
        fh.writelines(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n" for v in mesh.verts)
        fh.writelines(f"vt {uv[0]:.6f} {uv[1]:.6f}\n" for uv in mesh.uvcoords)
        fh.writelines("f " + " ".join(f"{i + 1}/{i + 1}" for i in f) + "\n"
                      for f in mesh.faces)
    root = write_layout(os.path.join(ws, "export"), "v2", serials=(TRAIN, *HOLD))
    out = os.path.join(ws, "submission")
    (tr,) = run_nersemble_benchmark.main([
        "--config", os.path.join(REPO, "configs", "fateavatar.yaml"), "--root", root,
        "--participants", "393", "--epochs", "2", "--device", "cpu", "--out", out,
        f"assets.flame_model_path={ws}/flame.pkl", f"assets.template_mesh_path={ws}/head.obj",
        f"dataset.img_res=[{RES},{RES}]", "model.tex_size=8", "training.max_points_num=128",
        "loss.vgg_weight=0", "render.max_tiles_per_gaussian=16", f"workspace={ws}/run"])
    assert tr.global_step == 4 * N_FRAMES and tr.last_epoch_stats["mode"] == "scan"
    assert tr.model.flame.n_shape == N_SHAPE and tr.model.flame.n_exp == N_EXP
    for q in ("SEQ-A", "SEQ-B"):
        for s in (*HOLD, TRAIN):
            path = _video(os.path.join(out, "393", q, f"cam_{s}.mp4"))
            assert os.path.exists(path), path
    assert os.path.isdir(os.path.join(ws, "run", "nersemble_393", "checkpoints"))
