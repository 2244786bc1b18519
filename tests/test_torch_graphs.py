"""The Trainer's scan-epoch mode, the fps test and the served frame through
the graph helper, on the CPU (where ``utils/graphs.Graph`` runs its
function as it is: the plain version of the CUDA graph).

The JAX package pins its scan epoch to its per-step mode
(tests/test_training.py::TestScanEpoch, ::TestTrackingScanEpoch); these
tests pin the port's the same way, bit for bit: the reference trainer has
``_scan_disabled`` set and trains on the same uint8 ground truth. The per-step
mode itself is held to the JAX step in tests/test_torch_train.py and
tests/test_torch_tracking.py. The card's half of these checks (graph against
eager on CUDA, atomics included) is in tests/test_torch_cuda.py and
chip_smoke.py's ``[graph]`` phase.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from torch_single_thread import one_torch_thread  # noqa: F401 (autouse fixture)
from fateavatar_tpu_torch.flame.loader import synthetic_flame
from fateavatar_tpu_torch.models import fateavatar as tfa
from fateavatar_tpu_torch.models import maintenance
from fateavatar_tpu_torch.ops.camera import make_camera
from fateavatar_tpu_torch.render import render as render_mod
from fateavatar_tpu_torch.render.render import RenderConfig
from fateavatar_tpu_torch.train import datasets as tdatasets
from fateavatar_tpu_torch.train import losses as tl
from fateavatar_tpu_torch.train import optim as topt
from fateavatar_tpu_torch.train.checkpoints import CheckpointManager
from fateavatar_tpu_torch.train.loader import Reenactor, checkpoint_tree
from fateavatar_tpu_torch.train.step import MaintenanceConfig, train_state_tensors
from fateavatar_tpu_torch.train.tracking import RowAdam, TrackingTables, tracking_tensors
from fateavatar_tpu_torch.train.trainer import Trainer
from fateavatar_tpu_torch.utils.graphs import Graph
from fateavatar_tpu_torch.utils.obj_io import sphere_obj_mesh

RES, TEX, CAP, NV, N_EXP = 32, 8, 128, 96, 4
# epoch 2 of 4 frames (steps 5-8) prunes at step 5 and densifies at step 6
MAINT = MaintenanceConfig(densify_interval=3, prune_interval=5, increase_num=16,
                          max_points_num=CAP)


def _avatar():
    flame = synthetic_flame(n_verts=NV, n_shape=6, n_exp=N_EXP, seed=0, device="cpu")
    cfg = tfa.FateAvatarConfig(tex_size=TEX, capacity=CAP, img_height=RES, img_width=RES,
                               normal_offset=0.02)
    return tfa.init_fateavatar(sphere_obj_mesh(NV), flame, cfg, device="cpu")


def _trainer(tracking=False, frames=4, scan=True, **kw):
    m, p, s = _avatar()
    ds = tdatasets.SyntheticDataset(num_frames=frames, img_res=(RES, RES), n_exp=N_EXP)
    ds.optimize_tracking = tracking
    loss = tl.FateAvatarLoss(tl.FateAvatarLossConfig(rgb_weight=1.0, scale_weight=0.1,
                                                     laplacian_weight=1e5))
    tr = Trainer("g", m, p, s, loss, topt.fateavatar_optimizers({}), ds, maint_cfg=MAINT,
                 render_cfg=RenderConfig(), device_frame_cache="on", **kw)
    tr._scan_disabled = not scan
    return tr


def _epoch(tr, e):
    tr.epoch = e
    tr.train_epoch()


@pytest.mark.parametrize("tracking", [False, True], ids=["plain", "tracking"])
def test_scan_epoch_matches_per_step(tracking):
    """Epoch 2 runs as the scan epoch (its prune and densify steps eagerly
    between replays); after two epochs params, state, Adam moments and count
    (with tracking: the tables, their moments and row counts) equal the
    per-step trainer's bit for bit, and so do the per-step losses."""
    tr_scan, tr_ref = _trainer(tracking), _trainer(tracking, scan=False)
    calls = {"uv_densify": [], "prune_low_opacity": []}
    with pytest.MonkeyPatch.context() as mp:
        for name, seen in calls.items():
            fn = getattr(maintenance, name)
            mp.setattr(maintenance, name,
                       lambda *a, _fn=fn, _seen=seen, **k: _seen.append(1) or _fn(*a, **k))
        for tr in (tr_scan, tr_ref):
            _epoch(tr, 1)
            assert tr.last_epoch_stats["mode"] == "per-step" and tr.last_epoch_aux is None
            for seen in calls.values():
                seen.clear()
            _epoch(tr, 2)
            assert {k: len(v) for k, v in calls.items()} == {
                "uv_densify": 1, "prune_low_opacity": 1}
    assert tr_scan.last_epoch_stats["mode"] == "scan" and tr_scan._scan_epoch is not None
    assert tr_ref.last_epoch_stats["mode"] == "per-step" and tr_ref._scan_epoch is None
    assert tr_scan._scan_epoch.tracking == tracking
    aux = tr_scan.last_epoch_aux
    assert {k: (v.shape, v.dtype) for k, v in aux.items()} == {
        "loss": ((4,), np.float32), "psnr": ((4,), np.float32), "overflow": ((4,), np.int32)}
    assert aux["loss"].tolist() == tr_ref.epoch_losses == tr_scan.epoch_losses
    assert not aux["overflow"].any() and np.isfinite(aux["psnr"]).all()
    assert tr_scan.global_step == tr_scan.ts.step == tr_ref.ts.step == 8
    for a, b in zip(train_state_tensors(tr_scan.ts), train_state_tensors(tr_ref.ts)):
        assert torch.equal(a, b)
    assert int(tr_scan.ts.state.alive.sum()) == int(_avatar()[2].alive.sum()) + 2 * 16
    assert torch.equal(tr_scan.ts.generator.get_state(), tr_ref.ts.generator.get_state())
    if tracking:
        assert tr_scan.train_track_state.count.tolist() == [2] * 4
        for a, b in zip(tracking_tensors(tr_scan.train_tables, tr_scan.train_track_state),
                        tracking_tensors(tr_ref.train_tables, tr_ref.train_track_state)):
            assert torch.equal(a, b)


def test_scan_mode_switches_back_to_per_step():
    """The JAX package's measured choice: the first scan epoch pays the
    capture and is not measured; once a later one runs below 0.9x the
    per-step steady rate, the Trainer logs why and trains per step."""
    tr = _trainer(frames=4)
    lines = []
    tr.log = lines.append
    _epoch(tr, 1)
    assert tr._per_step_its is not None and tr._per_step_its > 0
    tr._per_step_its = 1e12          # per-step mode "measured" faster than any scan
    _epoch(tr, 2)
    assert tr.last_epoch_stats["mode"] == "scan" and tr._scan_its is None
    assert not tr._scan_disabled
    _epoch(tr, 3)
    assert tr._scan_its is not None and tr._scan_disabled
    assert any(line.startswith("[scan] per-step mode is faster") for line in lines)
    _epoch(tr, 4)
    assert tr.last_epoch_stats["mode"] == "per-step" and tr.last_epoch_aux is None
    assert tr.global_step == 16


def test_set_render_cfg_rebuilds_the_scan_epoch():
    """A capacity swap drops the captured step and keeps the stacked
    frames; the next epoch captures anew on the new settings."""
    tr = _trainer(frames=3)
    _epoch(tr, 1)
    _epoch(tr, 2)
    old, frames = tr._scan_epoch, tr._scan_frames
    assert old is not None and frames["rgb"].dtype == torch.uint8
    assert tuple(frames["rgb"].shape) == (3, RES, RES, 3) and not tr._frame_cache
    tiles = RenderConfig(kernel="tiles", max_per_tile=64, chunk=32)
    tr.set_render_cfg(tiles)
    assert tr._scan_epoch is None and tr._scan_frames is frames
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfa, "render", lambda *a, config, **k: seen.append(config) or
                   render_mod.render(*a, config=config, **k))
        _epoch(tr, 3)
    assert tr.last_epoch_stats["mode"] == "scan"
    assert tr._scan_epoch is not None and tr._scan_epoch is not old
    assert len(seen) == 3 and all(c is tiles for c in seen)


def test_reenact_frames_equal_the_eager_loop(tmp_path):
    """Reenactor.reenact through the graph helper gives the frames of the
    eager loop (render_frame, round, clip to uint8) bit for bit, over more
    frames than one drain; a non-finite frame raises."""
    m, p, s = _avatar()
    gen = torch.Generator().manual_seed(0)
    p = dataclasses.replace(p, features_dc=p.features_dc + 0.8 * torch.randn(
        p.features_dc.shape, generator=gen), opacity=p.opacity + torch.randn(
        p.opacity.shape, generator=gen))
    CheckpointManager(os.path.join(tmp_path, "checkpoints")).save(1, checkpoint_tree(p, s))
    rng = np.random.default_rng(0)
    exprs = (rng.normal(size=(11, N_EXP + 2)) * 0.3).astype(np.float32)
    poses = (rng.normal(size=(11, 15)) * 0.05).astype(np.float32)
    delta = (rng.normal(size=N_EXP) * 0.1).astype(np.float32)
    cam = make_camera(np.eye(3), [0.0, 0.0, 0.4], 0.8, 0.8, RES, RES, device="cpu")
    rr = Reenactor(m, p, s, str(tmp_path))
    frames = rr.reenact(exprs, poses, delta, cam)
    assert rr.last_graph.replays == 11 and len(frames) == 11
    for e, pose, got in zip(exprs, poses, frames):
        e = e[:N_EXP] - delta
        img = rr.render_frame(e, pose, cam)
        want = torch.clamp(torch.round(img * 255.0), 0, 255).to(torch.uint8).numpy()
        assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert np.std(np.stack(frames).astype(np.float32)) > 1.0
    rr.params = dataclasses.replace(rr.params, features_dc=torch.full_like(p.features_dc,
                                                                           float("nan")))
    with pytest.raises(FloatingPointError, match="non-finite"):
        rr.reenact(exprs[:2], poses[:2], None, cam)


def test_fps_performance_test_runs():
    tr = _trainer(frames=2)
    lines = []
    tr.log = lines.append
    fps = tr.fps_performance_test(n=2)
    assert fps > 0 and lines[-1].startswith("[fps] ") and "ms/frame" in lines[-1]


def test_graph_helper_runs_the_function_on_the_cpu():
    """On the CPU a call is the function itself: no warm-up, no capture."""
    x = torch.zeros(3)
    g = Graph(lambda: x.add_(1.0), [x], "a counter")
    for _ in range(4):
        g()
    assert x.tolist() == [4.0] * 3 and g.replays == 4 and g.graph is None
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        Graph(lambda: None, [torch.zeros(1, device="meta")], "meta")


def test_cached_loss_constants_are_bit_identical():
    """The VGG normalization and D-SSIM blur constants are made once per
    device (a copy from the host inside a CUDA graph capture fails): the
    losses equal those with the constants made on every call."""
    rng = np.random.default_rng(3)
    a, b = (torch.from_numpy(rng.random((20, 24, 3)).astype(np.float32)) for _ in "ab")
    vgg = tl.vgg16_random_params(torch.Generator().manual_seed(0), device="cpu")
    assert tl._imagenet_stats(a.device) is tl._imagenet_stats(a.device)
    assert tl._blur_matrix(11, 20, a.device) is tl._blur_matrix(11, 20, a.device)

    def vgg_fresh(pred, gt):
        mean = torch.tensor(tl._IMAGENET_MEAN)[None, :, None, None]
        std = torch.tensor(tl._IMAGENET_STD)[None, :, None, None]
        x, y = ((t[None].permute(0, 3, 1, 2) - mean) / std for t in (pred, gt))
        fx = tl.vgg16_features(vgg, tl._bilinear_resize(x, 224))
        fy = tl.vgg16_features(vgg, tl._bilinear_resize(y, 224))
        loss = 0.0
        for u, v in zip(fx, fy):
            loss = loss + torch.mean(torch.abs(u - v))
        return loss

    def blur_fresh(s, n):
        return torch.as_tensor(tl._banded_blur_matrix(11, n))

    with torch.no_grad():
        assert torch.equal(tl.vgg_perceptual_loss(vgg, a, b), vgg_fresh(a, b))
        cached = tl.d_ssim(a, b)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tl, "_blur_matrix", lambda size, n, device: blur_fresh(size, n))
            assert torch.equal(cached, tl.d_ssim(a, b))


def test_update_row_takes_a_device_index():
    """RowAdam.update_row with a one-element device index tensor (the scan
    epoch's) equals the same step with a host int."""
    rng = np.random.default_rng(5)
    tables = TrackingTables(*(torch.from_numpy(rng.normal(size=(4, k)).astype(np.float32))
                              for k in (N_EXP, 15, 3)))
    grads = TrackingTables(*(torch.from_numpy(rng.normal(size=k).astype(np.float32))
                             for k in (N_EXP, 15, 3)))
    opt = RowAdam()
    state = opt.init(tables)
    a = opt.update_row(tables, state, grads, 2)
    b = opt.update_row(tables, state, grads, torch.tensor([2]))
    for x, y in zip(tracking_tensors(*a), tracking_tensors(*b)):
        assert torch.equal(x, y)
    assert a[1].count.tolist() == [0, 0, 1, 0]
