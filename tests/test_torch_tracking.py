"""The port's tracking refinement, snapshot renders and CLIs against the JAX
package, on the CPU: ``RowAdam``, one tracking step's row gradients,
``fateavatar_visualization``, ``render_mesh``, the Trainer's tracking epoch
and ``optimize_tracking``, and ``train_mono_avatar`` -> ``--resume`` ->
``avatar_reenact`` on a generated 32x32 IMAvatar layout."""

import dataclasses
import importlib.util
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import np_dict, perturb
from torch_layouts import orbit, write_imavatar
from torch_single_thread import one_torch_thread  # noqa: F401 (autouse fixture)
from fateavatar_tpu.flame.flame import FlameModel as JFlameModel
from fateavatar_tpu.models import fateavatar as jfa
from fateavatar_tpu.ops.camera import make_camera as jmake_camera
from fateavatar_tpu.render import mesh_render as jmesh
from fateavatar_tpu.render.render import RenderConfig as JRenderConfig
from fateavatar_tpu.train import losses as jl
from fateavatar_tpu.train import tracking as jtracking
from fateavatar_tpu.utils.obj_io import sphere_obj_mesh

from fateavatar_tpu_torch import convert
from fateavatar_tpu_torch.cli import avatar_reenact, train_mono_avatar
from fateavatar_tpu_torch.flame.loader import synthetic_flame as tsynthetic_flame
from fateavatar_tpu_torch.flame.loader import synthetic_flame_data
from fateavatar_tpu_torch.models import fateavatar as tfa
from fateavatar_tpu_torch.ops.camera import make_camera
from fateavatar_tpu_torch.render import mesh_render as tmesh
from fateavatar_tpu_torch.render import render as render_mod
from fateavatar_tpu_torch.render.render import RenderConfig
from fateavatar_tpu_torch.train import datasets as tdatasets
from fateavatar_tpu_torch.train import losses as tl
from fateavatar_tpu_torch.train import optim as topt
from fateavatar_tpu_torch.train import tracking as ttracking
from fateavatar_tpu_torch.train.loader import Loader
from fateavatar_tpu_torch.train.step import MaintenanceConfig
from fateavatar_tpu_torch.train.trainer import Trainer
from fateavatar_tpu_torch.utils.png import write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, TEX, CAP, NV = 32, 8, 128, 96
N_EXP = 6
# the flagship loss (configs/fateavatar.yaml), VGG in float32
LOSS_CFG = dict(rgb_weight=1.0, vgg_weight=0.1, scale_weight=0.1,
                scale_threshold=9.0, laplacian_weight=1e5)
NO_MAINT = dict(densify_interval=10**9, prune_interval=10**9,
                opacity_reset_interval=10**9)
K = 64    # the dense lists' K: above every tile's count here (64 splats)


def t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


def vgg_np(seed=0):
    """Seeded He-initialised VGG16 conv weights [(w [O,I,3,3], b [O])] in
    numpy, for both packages (jax.random's eager draw of 14.7 M weights
    costs seconds on a CPU)."""
    rng = np.random.default_rng(seed)
    layers, cin = [], 3
    for v in (64, 64, 128, 128, 256, 256, 256, 512, 512, 512):
        w = (rng.standard_normal((v, cin, 3, 3), np.float32) * np.sqrt(2.0 / (cin * 9)))
        layers.append((w.astype(np.float32), np.zeros((v,), np.float32)))
        cin = v
    return layers


# ---------------------------------------------------------------------------
# RowAdam
# ---------------------------------------------------------------------------

def _tables(rng, f=5, scale=1.0):
    return {"expression": (rng.normal(size=(f, N_EXP)) * scale).astype(np.float32),
            "flame_pose": (rng.normal(size=(f, 15)) * scale).astype(np.float32),
            "cam_t": (rng.normal(size=(f, 3)) * scale).astype(np.float32)}


@pytest.mark.parametrize("form", ["update_row", "update_rows"])
def test_row_adam_matches_jax(form):
    """Both forms on the same tables, moments, counts and gradients, two
    steps each, rtol 1e-6. update_rows gets a masked duplicate of a live row
    and a masked row of its own: the duplicate must not touch its row, the
    masked row must stay as it was."""
    rng = np.random.default_rng(0)
    tab, mu, nu = _tables(rng), _tables(rng, scale=0.1), _tables(rng, scale=0.1)
    nu = {k: np.abs(v) for k, v in nu.items()}
    count = np.array([0, 3, 1, 0, 7], np.int32)
    jopt, topt_ = jtracking.RowAdam(lr=5e-3), ttracking.RowAdam(lr=5e-3)
    jt = jtracking.TrackingTables(**{k: jnp.asarray(v) for k, v in tab.items()})
    js = jtracking.RowAdamState(
        mu=jtracking.TrackingTables(**{k: jnp.asarray(v) for k, v in mu.items()}),
        nu=jtracking.TrackingTables(**{k: jnp.asarray(v) for k, v in nu.items()}),
        count=jnp.asarray(count))
    tt = ttracking.TrackingTables(**{k: t(v) for k, v in tab.items()})
    ts = ttracking.RowAdamState(mu=ttracking.TrackingTables(**{k: t(v) for k, v in mu.items()}),
                                nu=ttracking.TrackingTables(**{k: t(v) for k, v in nu.items()}),
                                count=torch.from_numpy(count))
    jup = jax.jit(getattr(jopt, form))
    for it in range(2):
        if form == "update_row":
            g = {k: v[0] for k, v in _tables(rng).items()}
            idx = 1 + it
            jt, js = jup(jt, js, jtracking.TrackingTables(
                **{k: jnp.asarray(v) for k, v in g.items()}), jnp.int32(idx))
            tt, ts = topt_.update_row(tt, ts, ttracking.TrackingTables(
                **{k: t(v) for k, v in g.items()}), idx)
        else:
            g = {k: v[:4] for k, v in _tables(rng).items()}
            idxs = np.array([3, 1, 3, 4], np.int32)    # 3 again, masked; 4 masked
            mask = np.array([True, True, False, False])
            jt, js = jup(jt, js, jtracking.TrackingTables(
                **{k: jnp.asarray(v) for k, v in g.items()}), jnp.asarray(idxs), jnp.asarray(mask))
            tt, ts = topt_.update_rows(tt, ts, ttracking.TrackingTables(
                **{k: t(v) for k, v in g.items()}), torch.from_numpy(idxs), torch.from_numpy(mask))
    for name, a, b in (("tables", jt, tt), ("mu", js.mu, ts.mu), ("nu", js.nu, ts.nu)):
        for k in ttracking.FIELDS:
            np.testing.assert_allclose(getattr(b, k).numpy(), np.asarray(getattr(a, k)),
                                       rtol=1e-6, atol=1e-9, err_msg=f"{name}.{k}")
    np.testing.assert_array_equal(ts.count.numpy(), np.asarray(js.count))
    if form == "update_rows":
        assert ts.count.tolist() == [0, 5, 1, 2, 7]
        for k in ttracking.FIELDS:      # the masked row 4 is untouched
            np.testing.assert_array_equal(getattr(tt, k)[4].numpy(), tab[k][4])


# ---------------------------------------------------------------------------
# one avatar in both packages
# ---------------------------------------------------------------------------

def _jax_avatar(m, p, s):
    """The JAX package's containers holding the port's arrays (the port's
    init is held to JAX's in test_torch_model.py; building it this way
    skips seconds of JAX's op-by-op init on a CPU)."""
    def a(x):
        return jnp.asarray(x.numpy().astype(np.int32) if x.dtype == torch.int64 else x.numpy())

    def fields(obj, skip=()):
        return {f.name: a(getattr(obj, f.name)) for f in dataclasses.fields(obj)
                if f.name not in skip and getattr(obj, f.name) is not None}

    fl = m.flame
    jflame = JFlameModel(**fields(fl, ("parents", "n_shape", "n_exp")),
                         parents=jnp.asarray(fl.parents, jnp.int32),
                         n_shape=fl.n_shape, n_exp=fl.n_exp)
    model = jfa.FateAvatarModel(**fields(m, ("flame", "cfg")), flame=jflame,
                                cfg=jfa.FateAvatarConfig(**dataclasses.asdict(m.cfg)))
    return model, jfa.FateAvatarParams(**fields(p)), jfa.FateAvatarState(**fields(s))


@pytest.fixture(scope="module")
def avatar():
    """A perturbed avatar with densify statistics and sampled splats, in
    the port and in the JAX package."""
    flame = tsynthetic_flame(n_verts=NV, n_shape=8, n_exp=N_EXP, seed=0, device="cpu")
    cfg = tfa.FateAvatarConfig(tex_size=TEX, capacity=CAP, img_height=RES,
                               img_width=RES, normal_offset=0.02)
    m, p, s = tfa.init_fateavatar(sphere_obj_mesh(NV), flame, cfg, device="cpu")
    p = convert.fateavatar_params(perturb(np_dict(p), seed=1), device="cpu")
    rng = np.random.default_rng(7)
    alive = s.alive.numpy()
    s = dataclasses.replace(
        s, xyz_gradient_accum=t(np.where(alive, rng.random(CAP), 0.0)),
        denom=t(np.where(alive, 3.0, 0.0)), sample_flag=t(rng.random(CAP) < 0.2))
    return _jax_avatar(m, p, s), (m, p, s)


def _frame(seed):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=N_EXP) * 0.5).astype(np.float32),
            (rng.normal(size=15) * 0.05).astype(np.float32),
            np.array([0.01, -0.02, 0.4], np.float32),
            rng.random((RES, RES, 3)).astype(np.float32))


def test_tracking_step_gradients_match_jax(avatar):
    """One tracking step: the gradient of the frame's full loss (L1, VGG
    0.1 with the same random weights, scale 0.1, Laplacian 1e5) w.r.t. its
    expression, pose and camera-translation rows only, the port's Trainer
    loss (plain dense-list blend) against JAX's tracking loss (its XLA
    blend). Tolerance 1e-4 relative L2 per field: the rows' gradient sums
    over every splat and pixel, in another order in each framework, and the
    VGG loss routes near-tied elements (a max pool's top two inputs, a ReLU
    input at 0) differently within float32 rounding (ROADMAP Queue 3). The
    port's tracking step then moves the row as RowAdam does with that
    gradient, and only that row, and leaves the model untouched."""
    (model, params, state), (m, p, s) = avatar
    vgg = vgg_np()
    expr, pose, cam_t, gt = _frame(3)
    R = np.diag([1.0, 1.0, 1.0]).astype(np.float32)
    jrc = JRenderConfig(impl="xla", max_per_tile=K, chunk=32, max_tiles_per_gaussian=64)
    def jloss(e, po, ct, vgg_params, params, state):
        # weights, params and state enter as arguments: as constants of the
        # traced function they would be folded into the program, which slows
        # its compile
        loss_fn = jl.FateAvatarLoss(jl.FateAvatarLossConfig(**LOSS_CFG), vgg_params=vgg_params)
        cam = jmake_camera(R, ct, 0.8, 0.8, RES, RES)
        out = jfa.fateavatar_forward(model, params, state, e, po, cam,
                                     bg_color=jnp.ones(3), render_cfg=jrc)
        return loss_fn(out, {"rgb": gt})["loss"]

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        expr, pose, cam_t, [(jnp.asarray(w), jnp.asarray(b)) for w, b in vgg], params, state)

    ds = tdatasets.SyntheticDataset(num_frames=2, img_res=(RES, RES), n_exp=N_EXP)
    ds.optimize_tracking = True
    ds.expressions[1], ds.flame_pose[1] = expr, pose
    ds.world_mats[1, :3, :3], ds.world_mats[1, :3, 3] = R, cam_t
    tloss = tl.FateAvatarLoss(tl.FateAvatarLossConfig(**LOSS_CFG),
                              vgg_params=convert.vgg_params(vgg, device="cpu"))
    tr = Trainer("track", m, p, s, tloss, topt.fateavatar_optimizers({}), ds,
                 maint_cfg=MaintenanceConfig(**NO_MAINT),
                 render_cfg=RenderConfig(kernel="tiles", max_per_tile=K, chunk=32,
                                         max_tiles_per_gaussian=64))
    const = (R.T, 0.8, 0.8, t(gt), tr.ts.state, tr.ts.params)
    before = {k: v.clone() for k, v in dataclasses.asdict(tr.ts.params).items()}
    grads, row_gradients = [], ttracking.row_gradients

    def recorded(*args):
        grads.append(row_gradients(*args))
        return grads[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttracking, "row_gradients", recorded)
        tables, st = tr._tracking_step(tr.train_tables, tr.train_track_state, 1, const)
    g, = grads
    for k, ref in zip(ttracking.FIELDS, jg):
        ref, got = np.asarray(ref), getattr(g, k).numpy()
        assert np.abs(ref).max() > 0, k
        assert np.linalg.norm(got - ref) <= 1e-4 * np.linalg.norm(ref), k

    ref_t, _ = tr.track_opt.update_row(tr.train_tables, tr.train_track_state, g, 1)
    for k in ttracking.FIELDS:
        assert torch.equal(getattr(tables, k), getattr(ref_t, k)), k
        assert torch.equal(getattr(tables, k)[0], getattr(tr.train_tables, k)[0]), k
    assert st.count.tolist() == [0, 1]
    for k, v in before.items():
        assert torch.equal(getattr(tr.ts.params, k), v), k
    assert all(getattr(tr.ts.params, k).grad is None for k in before)


def test_visualization_matches_jax(avatar):
    """fateavatar_visualization's four renders (posed, canonical, gradient
    heat, sampled points) against JAX's, the same dense-list blend on both
    sides: atol 5e-5 (the golden suite's)."""
    (model, params, state), (m, p, s) = avatar
    expr, pose, cam_t, _ = _frame(4)
    jrc = JRenderConfig(impl="xla", max_per_tile=K, chunk=32, max_tiles_per_gaussian=64)
    jcam = jmake_camera(np.eye(3), cam_t, 0.8, 0.8, RES, RES)
    ref = jax.jit(lambda e, po, pa, st: jfa.fateavatar_visualization(
        model, pa, st, e, po, jcam, render_cfg=jrc))(expr, pose, params, state)
    cam = make_camera(np.eye(3), cam_t, 0.8, 0.8, RES, RES, device="cpu")
    out = tfa.fateavatar_visualization(
        m, p, s, t(expr), t(pose), cam,
        render_cfg=RenderConfig(kernel="tiles", max_per_tile=K, chunk=32,
                                max_tiles_per_gaussian=64))
    for k in ("rgb_image", "cano_image", "grad_image", "point_image"):
        got, want = out[k].numpy(), np.asarray(ref[k])
        assert got.shape == (RES, RES, 3) and want.std() > 0.01, k
        np.testing.assert_allclose(got, want, atol=5e-5, err_msg=k)
    np.testing.assert_allclose(out["verts"].numpy(), np.asarray(ref["verts"]), atol=2e-6)


def test_render_mesh_matches_jax(avatar):
    """render_mesh / overlay_mesh on the posed mesh: alpha equal but for
    edge pixels and colours within 1e-5 but for depth ties, at most 1% of
    the pixels in all. A pixel centre within float32 rounding of a
    triangle edge falls inside in one framework and outside in the other,
    and two faces at equal depth keep the brighter colour: both follow the
    vertex projection's rounding. Counted here: 0 of 1,024 pixels at this
    size."""
    (model, params, state), (m, p, s) = avatar
    expr, pose, cam_t, img = _frame(5)
    cam = make_camera(np.eye(3), cam_t, 0.8, 0.8, RES, RES, device="cpu")
    tverts = tfa.build_gaussians(m, p, s, t(expr), t(pose))[1][0]
    verts = jnp.asarray(tverts.numpy())
    jrgb, jalpha = jmesh.render_mesh(verts, jnp.asarray(model.faces),
                                     jmake_camera(np.eye(3), cam_t, 0.8, 0.8, RES, RES),
                                     RES, RES)
    trgb, talpha = tmesh.render_mesh(tverts, m.faces, cam, RES, RES)
    bad = ((talpha.numpy() != np.asarray(jalpha))
           | (np.abs(trgb.numpy() - np.asarray(jrgb)).max(-1) > 1e-5))
    assert np.asarray(jalpha).mean() > 0.2
    assert bad.mean() <= 0.01, int(bad.sum())
    over = tmesh.overlay_mesh(img, tverts, m.faces, cam).numpy()
    ok = ~bad[..., None]
    np.testing.assert_allclose(np.where(ok, over, 0), np.where(
        ok, np.asarray(jmesh.overlay_mesh(jnp.asarray(img), verts, jnp.asarray(model.faces),
                                          jmake_camera(np.eye(3), cam_t, 0.8, 0.8, RES, RES))),
        0), atol=1e-5)


# ---------------------------------------------------------------------------
# the Trainer with tracking, and the CLIs
# ---------------------------------------------------------------------------

def test_trainer_tracking_epoch_and_optimize(avatar):
    """The mirror of the JAX package's tracking test
    (tests/test_training.py::TestTracking): one epoch visits each train row
    once (SparseAdam counts 1, rows moved), and optimize_tracking(3, batch
    4) gives every test row 3 steps, as the JAX Trainer does."""
    _, (m, p, s) = avatar
    ds = tdatasets.SyntheticDataset(num_frames=3, img_res=(RES, RES), n_exp=N_EXP)
    ds.optimize_tracking = True
    test = tdatasets.SyntheticDataset(num_frames=2, img_res=(RES, RES), n_exp=N_EXP, seed=1)
    tr = Trainer("track", m, p, s, tl.FateAvatarLoss(tl.FateAvatarLossConfig(rgb_weight=1.0)),
                 topt.fateavatar_optimizers({}), ds, test,
                 maint_cfg=MaintenanceConfig(**NO_MAINT), render_cfg=RenderConfig())
    before = tr.train_tables.expression.clone()
    tr.epoch = 1
    tr.train_epoch()
    assert not torch.allclose(before, tr.train_tables.expression)
    assert tr.train_track_state.count.tolist() == [1, 1, 1]
    t_before = tr.test_tables.expression.clone()
    tr.optimize_tracking(optim_epoch=3, batch=4)
    assert not torch.allclose(t_before, tr.test_tables.expression)
    assert tr.test_track_state.count.tolist() == [3, 3]
    # a mid-run swap of the render settings reaches the train and tracking
    # steps: an epoch on the dense-list route visits each row once more
    tiles = RenderConfig(kernel="tiles", max_per_tile=K, chunk=32)
    tr.set_render_cfg(tiles)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfa, "render", lambda *a, config, **k: calls.append(config) or
                   render_mod.render(*a, config=config, **k))
        tr.epoch = 2
        tr.train_epoch()
    assert tr.train_track_state.count.tolist() == [2, 2, 2]
    assert len(calls) == 6 and all(c is tiles for c in calls)


def _cli_assets(ws):
    data, _ = synthetic_flame_data(n_verts=NV, n_exp=50, seed=0)
    with open(os.path.join(ws, "flame.pkl"), "wb") as fh:
        pickle.dump(data, fh)
    mesh = sphere_obj_mesh(NV)
    with open(os.path.join(ws, "head.obj"), "w") as fh:
        fh.writelines(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n" for v in mesh.verts)
        fh.writelines(f"vt {uv[0]:.6f} {uv[1]:.6f}\n" for uv in mesh.uvcoords)
        fh.writelines("f " + " ".join(f"{i + 1}/{i + 1}" for i in f) + "\n"
                      for f in mesh.faces)
    rng = np.random.default_rng(0)
    root = os.path.join(ws, "imavatar", "subj")
    for mode, n in (("train", 4), ("test", 2)):
        imgs = [(rng.random((RES, RES, 4)) * 255).astype(np.uint8) for _ in range(n)]
        write_imavatar(root, mode, imgs, orbit(n), rng.normal(size=(n, 50)) * 0.05,
                       rng.normal(size=(n, 15)) * 0.05, rng.normal(size=100) * 0.1, 0.8,
                       write_png)
    return root


def _video(stem):
    """write_video's output: an mp4 where ffmpeg is installed, else a GIF."""
    return any(os.path.exists(stem + ext) for ext in (".mp4", ".gif"))


def test_cli_train_resume_reenact(tmp_path):
    """train_mono_avatar on a generated 32x32 IMAvatar layout with
    --device cpu: 2 epochs with tracking, the test rows fitted
    (training.epochs.finetune=2) and evaluated, media written; --resume to
    epoch 3 (with --dp 1: one device) restores step and tables;
    avatar_reenact renders the test sequence into a GIF (an mp4 where
    ffmpeg is installed); Loader restores the train rows; --dp 2 in one
    process raises, naming torchrun."""
    ws = str(tmp_path)
    root = _cli_assets(ws)
    run = os.path.join(ws, "run")
    overrides = [
        f"assets.flame_model_path={ws}/flame.pkl", f"assets.template_mesh_path={ws}/head.obj",
        f"dataset.img_res=[{RES},{RES}]", "model.tex_size=8", "training.max_points_num=128",
        "loss.vgg_weight=0", "render.max_tiles_per_gaussian=16",
    ]
    train_args = ["--config", os.path.join(REPO, "configs", "fateavatar.yaml"),
                  "--device", "cpu", f"dataset.root_path={root}", f"workspace={run}",
                  "training.epochs.finetune=2", "training.snapshot_interval=8", *overrides]
    tr = train_mono_avatar.main(["--epochs", "2", *train_args])
    assert tr.global_step == 8 and tr.tracking_enabled
    assert tr.train_track_state.count.tolist() == [2] * 4
    assert tr.test_track_state.count.tolist() == [2, 2]
    media = os.path.join(run, "media")
    with open(os.path.join(media, "metrics", "test_epoch2.json")) as fh:
        summary = json.load(fh)["summary"]
    assert sorted(summary) == ["l1", "l2", "psnr", "ssim"] and np.isfinite(summary["psnr"])
    for rel in ("eval_images/test_epoch2_frame0.png", "snapshots/step00000008.png"):
        assert os.path.exists(os.path.join(media, rel)), rel
    # the metric plot, where matplotlib is installed
    assert os.path.exists(os.path.join(media, "metrics", "test_epoch2.png")) == (
        importlib.util.find_spec("matplotlib") is not None)
    assert _video(os.path.join(media, "eval_videos", "test_epoch2"))

    # --dp 1 trains on one device, as the JAX package does
    resumed = train_mono_avatar.main(["--epochs", "3", "--resume", "--dp", "1", *train_args])
    assert resumed.dp_mesh is None
    assert resumed.global_step == 12 and resumed.epoch == 3
    assert resumed.train_track_state.count.tolist() == [3] * 4
    assert os.path.exists(os.path.join(media, "metrics", "test_epoch3.json"))

    frames = avatar_reenact.main([
        "--config", os.path.join(REPO, "configs", "fateavatar.yaml"), "--device", "cpu",
        "--dst_workspace", run, "--src_root", root, *overrides])
    assert len(frames) == 2 and frames[0].shape == (RES, RES, 3)
    assert _video(os.path.join(media, "reenact"))

    m, p, s = resumed.model, resumed.ts.params, resumed.ts.state
    loader = Loader(m, p, s, run)
    for k in ttracking.FIELDS:
        assert torch.equal(getattr(loader.tables, k), getattr(resumed.train_tables, k)), k
    # --dp 2 outside a launcher of 2 ranks raises, saying how to launch
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        train_mono_avatar.main(["--epochs", "1", "--dp", "2", *train_args])
