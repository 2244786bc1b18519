"""Card-only tests of the port's CUDA kernels: each kernel (the instance
blend's and the dense-list blend's forward and backward) against its plain
PyTorch version on the card; the CUDA graphs (the Trainer's scan epoch and
the served frame) against eager steps and frames; each baseline
family's step through the kernels against the plain blends; LPIPS on the
card against the CPU and the intrinsics-shift camera inside a graph. They skip on a host
without CUDA. They import nothing of JAX, so on a machine with a card and
no JAX they run as

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from torch_blend_cases import BLEND_CASES, blend_case
from torch_determinism import deterministic_sums
from torch_tile_cases import TILE_CASES, tile_case

from fateavatar_tpu_torch.render import blend_instances as tblend
from fateavatar_tpu_torch.render import blend_tiles as ttiles


def _cuda_inputs(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    inst, starts, bg, grid = blend_case(name)
    return (torch.from_numpy(inst).cuda(), torch.from_numpy(starts).cuda(),
            torch.from_numpy(bg).cuda(), grid)


@pytest.mark.cuda
@pytest.mark.parametrize("name", BLEND_CASES)
def test_blend_kernel_matches_plain_version(name):
    """Tolerance 2e-4: kernel and plain version take the transmittance
    product in another order, which can flip the instance that crosses
    T = 1e-4 at a pixel and move it by at most alpha * T <= 1e-4."""
    args = _cuda_inputs(name)
    before = tblend.blend_instances.launches
    img_k, tfin_k = tblend.blend_instances(*args)
    torch.cuda.synchronize()
    assert tblend.blend_instances.launches == before + 1
    img_p, tfin_p = tblend.blend_instances_reference(*args)
    assert (img_k - img_p).abs().max().item() <= 2e-4
    assert (tfin_k - tfin_p).abs().max().item() <= 2e-4
    if name == "empty":
        empty = (args[1][1:] - args[1][:-1]) == 0
        assert bool((tfin_k[empty] == 1.0).all())


def _cotangents(grid, seed=5):
    t = grid[0] * grid[1]
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(t, 3, 256)).astype(np.float32)).cuda(),
            torch.from_numpy(rng.normal(size=(t, 256)).astype(np.float32)).cuda())


def _close_rows(got, ref, rtol):
    """Each gradient row within ``rtol`` of that row's largest magnitude."""
    scale = ref[:9].abs().amax(dim=1, keepdim=True) + 1e-6
    return bool(((got[:9] - ref[:9]).abs() <= rtol * scale).all())


# Backward tolerance, relative to each gradient row's largest magnitude:
# the kernel sums each instance's 256 pixel terms in another order than the
# plain version (~1e-6 relative), and the two transmittance products can
# flip the instance that crosses T = 1e-4 at a pixel; that instance's term
# there carries T_j <= 1e-4 / (1 - 0.99), so 1e-3 covers one such flip.
BWD_RTOL = 1e-3


@pytest.mark.cuda
def test_blend_kernel_raises_on_cuda_grad():
    """The grad path on the card: autograd through blend_instances runs the
    forward and the backward kernel once each, and its gradients equal those
    of the plain versions (blend_instances_plain) within BWD_RTOL."""
    inst, starts, bg, grid = _cuda_inputs("empty")
    g_img, g_tfin = _cotangents(grid)

    def grads(blend):
        x, b = inst.clone().requires_grad_(), bg.clone().requires_grad_()
        img, tfin = blend(x, starts, b, grid)
        return torch.autograd.grad((img * g_img).sum() + (tfin * g_tfin).sum(), (x, b))

    f0, b0 = tblend.blend_instances.launches, tblend.blend_instances_bwd.launches
    gk, gbk = grads(tblend.blend_instances)
    torch.cuda.synchronize()
    assert tblend.blend_instances.launches == f0 + 1
    assert tblend.blend_instances_bwd.launches == b0 + 1
    gp, gbp = grads(tblend.blend_instances_plain)
    assert _close_rows(gk, gp, BWD_RTOL)
    assert (gbk - gbp).abs().max().item() <= 1e-3 * gbp.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("name", BLEND_CASES)
def test_blend_bwd_kernel_matches_plain_version(name):
    inst, starts, bg, grid = _cuda_inputs(name)
    img, tfin = tblend.blend_instances(inst, starts, bg, grid)
    g_img, g_tfin = _cotangents(grid)
    args = (inst, starts, bg, img, tfin, g_img, g_tfin, grid)
    before = tblend.blend_instances_bwd.launches
    gk = tblend.blend_instances_bwd(*args)
    torch.cuda.synchronize()
    assert tblend.blend_instances_bwd.launches == before + 1
    gp = tblend.blend_instances_backward_reference(*args)
    assert bool(torch.isfinite(gk).all())
    assert _close_rows(gk, gp, BWD_RTOL)
    assert bool((gk[9:] == 0).all())
    assert bool((gk[:, int(starts[-1]):] == 0).all()), "columns past the ranges"


@pytest.mark.cuda
def test_blend_bwd_kernel_writes_every_element():
    """A NaN-filled output buffer handed to the C entry point comes back
    finite and bit-equal to a clean call: no element is left unwritten."""
    inst, starts, bg, grid = _cuda_inputs("long")
    img, tfin = tblend.blend_instances(inst, starts, bg, grid)
    args = (inst, starts, bg, img, tfin, *_cotangents(grid), grid)
    clean = tblend.blend_instances_bwd(*args)
    dirty = tblend.blend_instances_bwd(*args, out=torch.full_like(clean, float("nan")))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(dirty).all())
    assert torch.equal(dirty, clean)


def _cuda_tile_inputs(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    data, valid, counts, bg, grid = tile_case(name)
    return (*(torch.from_numpy(x).cuda() for x in (data, valid, counts, bg)), grid)


@pytest.mark.cuda
@pytest.mark.parametrize("route, name", [("instances", n) for n in BLEND_CASES]
                         + [("tiles", n) for n in sorted(TILE_CASES)])
def test_blend_kernels_are_bit_identical_across_calls(route, name):
    """Each route's kernels (1 and 2 on the compact cases, 3 and 4 on the
    dense ones) give the same bits on every call: each column and pixel is
    owned by one unit, and partial sums combine in a fixed order, whatever
    order the blocks run in."""
    if route == "instances":
        fwd_args = _cuda_inputs(name)
        fwd, bwd = tblend.blend_instances, tblend.blend_instances_bwd
    else:
        fwd_args = _cuda_tile_inputs(name)
        fwd, bwd = ttiles.blend_tiles, ttiles.blend_tiles_bwd
    *inputs, grid = fwd_args
    img, tfin = fwd(*fwd_args)
    img2, tfin2 = fwd(*fwd_args)
    args = (*inputs, img, tfin, *_cotangents(grid), grid)
    g, g2 = bwd(*args), bwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(img, img2) and torch.equal(tfin, tfin2)
    assert torch.equal(g, g2)


@pytest.mark.cuda
def test_tile_and_instance_kernels_agree_bit_for_bit():
    """The same lists through kernels 1 and 3 (the ``boundary`` blend case
    and its dense layout, the tile case ``boundary``) give the same bits:
    both kernels run the same segments, counted from each tile's start."""
    inst, starts, bg, grid = _cuda_inputs("boundary")
    data, valid, counts, bg_t, _ = _cuda_tile_inputs("boundary")
    img_i, tfin_i = tblend.blend_instances(inst, starts, bg, grid)
    img_t, tfin_t = ttiles.blend_tiles(data, valid, counts, bg_t, grid)
    torch.cuda.synchronize()
    assert torch.equal(img_i, img_t) and torch.equal(tfin_i, tfin_t)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TILE_CASES))
def test_tile_kernel_matches_plain_version(name):
    """Kernel 3 against blend_tiles_reference, 2e-4 (a termination flip, as
    for the instance kernel); empty tiles keep T = 1."""
    args = _cuda_tile_inputs(name)
    before = ttiles.blend_tiles.launches
    img_k, tfin_k = ttiles.blend_tiles(*args)
    torch.cuda.synchronize()
    assert ttiles.blend_tiles.launches == before + 1
    img_p, tfin_p = ttiles.blend_tiles_reference(*args)
    assert (img_k - img_p).abs().max().item() <= 2e-4
    assert (tfin_k - tfin_p).abs().max().item() <= 2e-4
    assert bool((tfin_k[args[2] == 0] == 1.0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TILE_CASES))
def test_tile_bwd_kernel_matches_plain_version(name):
    """Kernel 4 against blend_tiles_backward_reference within BWD_RTOL of
    each row's largest element; zero past every list."""
    data, valid, counts, bg, grid = _cuda_tile_inputs(name)
    img, tfin = ttiles.blend_tiles(data, valid, counts, bg, grid)
    args = (data, valid, counts, bg, img, tfin, *_cotangents(grid), grid)
    before = ttiles.blend_tiles_bwd.launches
    gk = ttiles.blend_tiles_bwd(*args)
    torch.cuda.synchronize()
    assert ttiles.blend_tiles_bwd.launches == before + 1
    gp = ttiles.blend_tiles_backward_reference(*args)
    assert bool(torch.isfinite(gk).all())
    assert _close_rows(gk, gp, BWD_RTOL)
    k = data.shape[1] // counts.shape[0]
    past = torch.arange(k, device="cuda")[None, :] >= counts.clamp(max=k)[:, None]
    assert bool((gk[:, past.reshape(-1)] == 0).all()), "slots past the lists"


@pytest.mark.cuda
def test_tile_kernels_through_autograd():
    """Autograd through blend_tiles launches kernel 3 and kernel 4 once each,
    and its gradients equal those of the plain versions (blend_tiles_plain)
    within BWD_RTOL."""
    data, valid, counts, bg, grid = _cuda_tile_inputs("over_k")
    g_img, g_tfin = _cotangents(grid)

    def grads(blend):
        x, b = data.clone().requires_grad_(), bg.clone().requires_grad_()
        img, tfin = blend(x, valid, counts, b, grid)
        return torch.autograd.grad((img * g_img).sum() + (tfin * g_tfin).sum(), (x, b))

    f0, b0 = ttiles.blend_tiles.launches, ttiles.blend_tiles_bwd.launches
    gk, gbk = grads(ttiles.blend_tiles)
    torch.cuda.synchronize()
    assert ttiles.blend_tiles.launches == f0 + 1
    assert ttiles.blend_tiles_bwd.launches == b0 + 1
    gp, gbp = grads(ttiles.blend_tiles_plain)
    assert _close_rows(gk, gp, BWD_RTOL)
    assert (gbk - gbp).abs().max().item() <= 1e-3 * gbp.abs().max().item()


@pytest.mark.cuda
def test_tile_bwd_kernel_writes_every_element():
    """A NaN-filled output buffer comes back finite and bit-equal to a
    clean call: every slot of every list is written."""
    data, valid, counts, bg, grid = _cuda_tile_inputs("long")
    img, tfin = ttiles.blend_tiles(data, valid, counts, bg, grid)
    args = (data, valid, counts, bg, img, tfin, *_cotangents(grid), grid)
    clean = ttiles.blend_tiles_bwd(*args)
    dirty = ttiles.blend_tiles_bwd(*args, out=torch.full_like(clean, float("nan")))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(dirty).all())
    assert torch.equal(dirty, clean)


@pytest.mark.cuda
def test_png_codec_round_trip(tmp_path):
    """The port's PNG writer and reader on the card's host (the port needs no PIL):
    grey, RGB and RGBA round-trip exactly, and decode_image at the native
    size returns the bytes / 255."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fateavatar_tpu_torch.utils import png

    rng = np.random.default_rng(0)
    for c in (1, 3, 4):
        arr = (rng.random((37, 53, c)) * 255).astype(np.uint8)
        path = str(tmp_path / f"c{c}.png")
        png.write_png(path, arr)
        back = png.read_png(path)
        want = np.repeat(arr, 3, axis=2) if c == 1 else arr
        assert np.array_equal(back, want)
        rgba, src_c = png.decode_image(path, 53, 37)
        assert src_c == back.shape[2]
        assert np.array_equal(rgba[..., :src_c], want.astype(np.float32) * np.float32(1 / 255))


@pytest.mark.cuda
def test_tracking_step_kernels_match_plain():
    """One tracking step's row gradients (expression, pose, camera
    translation) through kernels 1 and 2 against the same step through the
    plain instance blend, on a small avatar: within 1e-2 relative L2 per
    field, the bound of chip_smoke.py's step comparisons (the two images
    differ by ~1e-6 a pixel, which an L1 residual near 0 turns into an O(1)
    change of that pixel's term). One forward and one backward launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from fateavatar_tpu_torch.flame.loader import synthetic_flame
    from fateavatar_tpu_torch.models import fateavatar as tfa
    from fateavatar_tpu_torch.ops.camera import make_camera
    from fateavatar_tpu_torch.render import render as render_mod
    from fateavatar_tpu_torch.render.render import RenderConfig
    from fateavatar_tpu_torch.train import losses as tl
    from fateavatar_tpu_torch.train.tracking import FIELDS, row_gradients
    from fateavatar_tpu_torch.utils.obj_io import sphere_obj_mesh

    dev, res = "cuda", 64
    flame = synthetic_flame(n_verts=96, n_shape=8, n_exp=6, seed=0, device=dev)
    cfg = tfa.FateAvatarConfig(tex_size=32, capacity=2048, img_height=res, img_width=res,
                               normal_offset=0.02)
    m, p, s = tfa.init_fateavatar(sphere_obj_mesh(96), flame, cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = dataclasses.replace(p, **{k: getattr(p, k) + sc * torch.randn(
        getattr(p, k).shape, generator=gen, device=dev)
        for k, sc in (("features_dc", 0.8), ("opacity", 1.5), ("offset", 1.0))})
    loss_fn = tl.FateAvatarLoss(tl.FateAvatarLossConfig(rgb_weight=1.0,
                                                        laplacian_weight=1e5))
    gt = torch.rand((res, res, 3), generator=gen, device=dev)
    rcfg = RenderConfig(binning="twotier", max_tiles_per_gaussian=64)

    def loss(e, po, ct):
        cam = make_camera(torch.eye(3, device=dev), ct, 0.8, 0.8, res, res, device=dev)
        out = tfa.fateavatar_forward(m, p, s, e, po, cam, render_cfg=rcfg)
        return loss_fn(out, {"rgb": gt})["loss"]

    rows = (torch.randn(6, generator=gen, device=dev) * 0.3,
            torch.randn(15, generator=gen, device=dev) * 0.05,
            torch.tensor([0.0, 0.0, 0.4], device=dev))
    f0, b0 = tblend.blend_instances.launches, tblend.blend_instances_bwd.launches
    gk = row_gradients(loss, *rows)
    torch.cuda.synchronize()
    assert tblend.blend_instances.launches == f0 + 1
    assert tblend.blend_instances_bwd.launches == b0 + 1
    orig = render_mod.blend_instances
    render_mod.blend_instances = tblend.blend_instances_plain
    try:
        gp = row_gradients(loss, *rows)
    finally:
        render_mod.blend_instances = orig
    for f in FIELDS:
        a, b = getattr(gk, f), getattr(gp, f)
        assert bool(torch.isfinite(a).all()) and float(b.norm()) > 0, f
        assert float((a - b).norm() / b.norm()) <= 1e-2, f


# ---------------------------------------------------------------------------
# CUDA graphs: the Trainer's scan epoch and the served frame
# ---------------------------------------------------------------------------

G_RES = 64
# epoch 2 of 4 frames (steps 5-8) densifies at step 6 and prunes at step 7,
# eagerly between the graph's replays
G_MAINT = dict(densify_interval=6, prune_interval=7, increase_num=64, max_points_num=2048)


def _graph_avatar(dev):
    import dataclasses

    from fateavatar_tpu_torch.flame.loader import synthetic_flame
    from fateavatar_tpu_torch.models import fateavatar as tfa
    from fateavatar_tpu_torch.utils.obj_io import sphere_obj_mesh

    flame = synthetic_flame(n_verts=96, n_shape=8, n_exp=6, seed=0, device=dev)
    cfg = tfa.FateAvatarConfig(tex_size=32, capacity=2048, img_height=G_RES,
                               img_width=G_RES, normal_offset=0.02)
    m, p, s = tfa.init_fateavatar(sphere_obj_mesh(96), flame, cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = dataclasses.replace(p, **{k: getattr(p, k) + sc * torch.randn(
        getattr(p, k).shape, generator=gen, device=dev)
        for k, sc in (("features_dc", 0.8), ("opacity", 1.5), ("offset", 1.0))})
    return m, p, s


def _graph_trainer(tracking, rcfg):
    from fateavatar_tpu_torch.train import datasets as tdatasets
    from fateavatar_tpu_torch.train import losses as tl
    from fateavatar_tpu_torch.train import optim as topt
    from fateavatar_tpu_torch.train.step import MaintenanceConfig
    from fateavatar_tpu_torch.train.trainer import Trainer

    m, p, s = _graph_avatar("cuda")
    ds = tdatasets.SyntheticDataset(num_frames=4, img_res=(G_RES, G_RES), n_exp=6)
    ds.optimize_tracking = tracking
    loss = tl.FateAvatarLoss(tl.FateAvatarLossConfig(rgb_weight=1.0, scale_weight=0.1,
                                                     laplacian_weight=1e5))
    return Trainer("g", m, p, s, loss, topt.fateavatar_optimizers({}), ds,
                   maint_cfg=MaintenanceConfig(**G_MAINT), render_cfg=rcfg,
                   device_frame_cache="on")


def _snapshot(tr):
    from fateavatar_tpu_torch.train.step import clone_train_state
    from fateavatar_tpu_torch.train.tracking import clone_tracking

    track = (clone_tracking(tr.train_tables, tr.train_track_state) if tr.tracking_enabled
             else None)
    return clone_train_state(tr.ts), tr.ts.generator.get_state(), tr.global_step, track


def _restore(tr, snap):
    """The Trainer back at ``snap``, in tensors of its own."""
    from fateavatar_tpu_torch.train.step import clone_train_state
    from fateavatar_tpu_torch.train.tracking import clone_tracking

    ts, gen, global_step, track = snap
    tr.ts = clone_train_state(ts)
    tr.ts.generator = torch.Generator(device="cuda")
    tr.ts.generator.set_state(gen)
    tr.global_step = global_step
    if track is not None:
        tr.train_tables, tr.train_track_state = clone_tracking(*track)


def _rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("route, tracking", [("instances", False), ("instances", True),
                                             ("tiles", False)])
def test_graph_epoch_matches_eager_epoch(route, tracking):
    """From one state, the scan epoch's graph against eager steps: one step
    (loss within 1e-6 relative: the forward kernels are deterministic; every
    parameter field, and with tracking every table, within 1e-4 relative L2:
    the backward sums with atomics) and a whole epoch with its maintenance
    steps (every step's loss within 1e-3 relative). One launch of each blend
    kernel per replay (two with the tracking step)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from fateavatar_tpu_torch.render.render import RenderConfig
    from fateavatar_tpu_torch.train.step import train_state_tensors
    from fateavatar_tpu_torch.train.tracking import tracking_tensors

    rcfg = RenderConfig(binning="twotier", max_tiles_per_gaussian=64)
    if route == "tiles":
        rcfg = dataclasses.replace(rcfg, kernel="tiles", max_per_tile=2048)
    tr = _graph_trainer(tracking, rcfg)
    tr.epoch = 1
    tr.train_epoch()                     # per step: fills the device frame cache
    snap = _snapshot(tr)

    # one eager step (and its tracking step), as the per-step epoch runs it
    sample = tr.train_dataset.sample(0)
    frame = tr._make_frame(sample, tr.train_tables)
    ts1, aux1 = tr.train_step(tr.ts, frame)
    if tracking:
        pose = np.asarray(sample["cam_pose"], np.float32)
        tables1, _ = tr._tracking_step(tr.train_tables, tr.train_track_state, sample["idx"],
                                       (pose[:3, :3].T, sample["fovx"], sample["fovy"],
                                        frame.rgb, ts1.state, ts1.params))
    # the same step as the graph's first replay
    _restore(tr, snap)
    scan = tr._maybe_scan_epoch()
    tr._load_scan_state(scan)
    scan.graph()
    torch.cuda.synchronize()
    loss_e, loss_g = float(aux1["loss"]), float(scan.aux["loss"][0])
    assert abs(loss_g - loss_e) <= 1e-6 * abs(loss_e), (loss_g, loss_e)
    for a, b in zip(train_state_tensors(scan.ts)[:9], train_state_tensors(ts1)[:9]):
        assert _rel_l2(a, b) <= 1e-4
    if tracking:
        for a, b in zip(tracking_tensors(scan.tables, scan.track_state)[:3],
                        tracking_tensors(tables1, scan.track_state)[:3]):
            assert _rel_l2(a, b) <= 1e-4
    fwd, bwd = f"blend_{route}_fwd", f"blend_{route}_bwd"
    per = 2 if tracking else 1
    assert scan.graph.launches_per_replay == {fwd: per, bwd: per}

    # a whole epoch each way from the same state
    _restore(tr, snap)
    tr._scan_disabled = True
    tr.epoch = 2
    tr.train_epoch()
    eager = np.asarray(tr.epoch_losses)
    assert tr.last_epoch_stats["mode"] == "per-step"
    _restore(tr, snap)
    tr._scan_disabled = False
    replays = scan.graph.replays
    tr.train_epoch()
    graph = tr.last_epoch_aux["loss"]
    assert tr.last_epoch_stats["mode"] == "scan" and tr._scan_epoch is scan
    assert scan.graph.replays == replays + 2          # steps 6 and 7 ran eagerly
    assert np.isfinite(graph).all() and abs(graph[0] - eager[0]) <= 1e-6 * abs(eager[0])
    assert (np.abs(graph - eager) <= 1e-3 * np.abs(eager)).all(), (graph, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["instances", "tiles"])
def test_served_frames_from_the_graph_equal_eager_frames(route, tmp_path):
    """Reenactor.reenact through the graph against the eager loop
    (render_frame, round, clip to uint8): the forward kernels are
    deterministic, so the frames are equal bit for bit; one forward launch
    per replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import os

    from fateavatar_tpu_torch.ops.camera import make_camera
    from fateavatar_tpu_torch.render.render import RenderConfig
    from fateavatar_tpu_torch.train.checkpoints import CheckpointManager
    from fateavatar_tpu_torch.train.loader import Reenactor, checkpoint_tree

    m, p, s = _graph_avatar("cuda")
    CheckpointManager(os.path.join(tmp_path, "checkpoints")).save(1, checkpoint_tree(p, s))
    rcfg = RenderConfig(binning="twotier", max_tiles_per_gaussian=64, kernel=route,
                        max_per_tile=2048)
    rr = Reenactor(m, p, s, str(tmp_path), render_cfg=rcfg)
    rng = np.random.default_rng(0)
    exprs = (rng.normal(size=(10, 6)) * 0.3).astype(np.float32)
    poses = (rng.normal(size=(10, 15)) * 0.05).astype(np.float32)
    cam = make_camera(np.eye(3), [0.0, 0.0, 0.4], 0.8, 0.8, G_RES, G_RES, device="cuda")
    frames = rr.reenact(exprs, poses, None, cam)
    assert rr.last_graph.replays == 10 and rr.last_graph.launches_per_replay == {
        f"blend_{route}_fwd": 1}
    for e, pose, got in zip(exprs, poses, frames):
        img = rr.render_frame(e, pose, cam)
        want = torch.clamp(torch.round(img * 255.0), 0, 255).to(torch.uint8).cpu().numpy()
        assert np.array_equal(got, want)
    assert np.std(np.stack(frames).astype(np.float32)) > 1.0


# ---------------------------------------------------------------------------
# neural baking: the bake step's graph, the lookup's transpose, the editor
# ---------------------------------------------------------------------------

def _bake_setup(decode_type="UNet"):
    """A small decoder of ``_graph_avatar`` (64 fresh samples) on the card:
    a UNet from a 32x32 const (the CLI's 512^2 one is fixed), or the
    512^2 feature map; a UVBaker over 4 synthetic frames."""
    from fateavatar_tpu_torch.models import unet as tunet
    from fateavatar_tpu_torch.models import uv_decoder as tuvd
    from fateavatar_tpu_torch.train import datasets as tdatasets
    from fateavatar_tpu_torch.train import losses as tl
    from fateavatar_tpu_torch.train.baker import UVBaker

    m, p, s = _graph_avatar("cuda")
    dec, net, const = tuvd.build_uv_decoder(m, p, s, decode_type=decode_type,
                                            fresh_samples=64, seed=0)
    if decode_type == "UNet":
        gen = torch.Generator(device="cuda").manual_seed(1)
        net = tunet.UNet(11, 11, device="cuda", generator=gen)
        const = torch.rand((1, 32, 32, 11), generator=gen, device="cuda") * 2 - 1
    ds = tdatasets.SyntheticDataset(num_frames=4, img_res=(G_RES, G_RES), n_exp=6)
    loss = tl.FateAvatarLoss(tl.FateAvatarLossConfig(rgb_weight=1.0, scale_weight=0.1,
                                                     laplacian_weight=1e5))
    return UVBaker(dec, net, const, loss, ds, reg_weight=0.1,
                   reg_attribute=("color", "opacity"))


@pytest.mark.cuda
def test_bake_step_graph_matches_eager():
    """From one state, the bake step eagerly and as the graph's replay: the
    first loss within 1e-6 relative, every trainable and BatchNorm
    statistic after the step within 1e-4 relative L2, an epoch's losses
    within 1e-3; one launch of kernels 1 and 2 per replay and per eager
    step; the replays count the steps. The pair runs with every sum in a
    fixed order (deterministic cuDNN, ``torch_determinism.deterministic_sums``,
    the graph captured under them), as chip_smoke.py's [bake] gate does:
    with atomic sums before one Adam step the state read 1.0-1.6e-4 in some
    runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    baker = _bake_setup()
    frame = baker._prep(baker.dataset.sample(1))
    snap = baker.snapshot()
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=torch.backends.cudnn.allow_tf32), \
            deterministic_sums():
        f0, b0 = tblend.blend_instances.launches, tblend.blend_instances_bwd.launches
        baker.eager = True
        loss_e = float(baker.step(frame)[0])
        assert (tblend.blend_instances.launches - f0,
                tblend.blend_instances_bwd.launches - b0) == (1, 1)
        after_e = baker.snapshot()
        baker.restore(snap)
        baker.eager = False
        loss_g = float(baker.step(frame)[0])
        assert baker.graph.launches_per_replay == {"blend_instances_fwd": 1,
                                                   "blend_instances_bwd": 1}
        assert abs(loss_g - loss_e) <= 1e-6 * abs(loss_e)
        n = len(baker.trainables) + len(baker.stats)
        for a, b in zip(baker.snapshot()[:n], after_e[:n]):
            assert _rel_l2(a, b) <= 1e-4
        losses = {}
        for mode in ("eager", "graph"):
            baker.restore(snap)
            baker.eager = mode == "eager"
            baker.bake_epoch()
            losses[mode] = np.asarray(baker.epoch_losses)
    assert baker.graph.replays == 1 + len(baker.dataset)
    rel = np.abs(losses["graph"] - losses["eager"]) / np.abs(losses["eager"])
    assert np.isfinite(losses["graph"]).all() and rel.max() <= 1e-3


@pytest.mark.cuda
def test_texture_lookup_transpose_matches_indexing_backward():
    """texture_lookup's gather from the flattened texture, whose backward
    is an index_add_, against the plain per-corner indexing (backward
    through index_put_ with accumulation) on the card: values equal,
    texture gradients within 1e-5 of the largest (the two sum colliding
    texels in other orders)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fateavatar_tpu_torch.models.uv_decoder import texture_lookup

    gen = torch.Generator(device="cuda").manual_seed(2)
    tex = torch.randn((64, 48, 12), generator=gen, device="cuda")
    uv = torch.rand((20000, 2), generator=gen, device="cuda") * 1.2 - 0.1
    cot = torch.randn((20000, 12), generator=gen, device="cuda")

    def plain(texture):
        h, w = texture.shape[:2]
        x = torch.clamp(uv[:, 0], 0, 1) * (w - 1)
        y = torch.clamp(uv[:, 1], 0, 1) * (h - 1)
        x0, y0 = torch.floor(x).long(), torch.floor(y).long()
        x1, y1 = torch.clamp(x0 + 1, max=w - 1), torch.clamp(y0 + 1, max=h - 1)
        fx, fy = (x - x0)[:, None], (y - y0)[:, None]
        return (texture[y0, x0] * (1 - fx) * (1 - fy) + texture[y0, x1] * fx * (1 - fy)
                + texture[y1, x0] * (1 - fx) * fy + texture[y1, x1] * fx * fy)

    outs = []
    for fn in (texture_lookup, lambda t: plain(t)):
        t = tex.clone().requires_grad_()
        v = fn(t, uv) if fn is texture_lookup else fn(t)
        (g,) = torch.autograd.grad((v * cot).sum(), t)
        outs.append((v.detach(), g))
    assert torch.equal(outs[0][0], outs[1][0])
    assert (outs[0][1] - outs[1][1]).abs().max() <= 1e-5 * outs[1][1].abs().max()


@pytest.mark.cuda
def test_editor_frame_against_the_unedited_avatar():
    """An unedited editor's frame equals the decoder's own eval-mode render
    of the same textures; a sticker changes the colour texture inside its
    square only and changes the frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fateavatar_tpu_torch.models import uv_decoder as tuvd
    from fateavatar_tpu_torch.ops.camera import make_camera
    from fateavatar_tpu_torch.train.baker import UVEditor

    baker = _bake_setup("feature_map")
    raw, _ = baker.textures()
    editor = UVEditor(baker.model, raw)
    cam = make_camera(np.eye(3, dtype=np.float32), np.array([0, 0, 0.4], np.float32), 0.8,
                      0.8, G_RES, G_RES, device="cuda")
    expr, pose = np.zeros(6, np.float32), np.zeros(15, np.float32)
    base = editor.render(expr, pose, cam)
    with torch.no_grad():
        ref = tuvd.uv_decoder_forward(baker.model, baker.net, baker.const,
                                      torch.zeros(6, device="cuda"),
                                      torch.zeros(15, device="cuda"), cam,
                                      train=False)["rgb_image"]
    assert torch.equal(base, ref)
    before = editor.act_textures["color"].clone()
    rng = np.random.default_rng(0)
    editor.sticker_editing(rng.random((128, 128, 3)).astype(np.float32),
                           np.ones((128, 128), np.float32), position=(192, 192), scale=1.0)
    changed = (editor.act_textures["color"] - before).abs().sum(-1) > 0
    ys, xs = torch.nonzero(changed, as_tuple=True)
    assert ys.numel() and int(ys.min()) >= 192 and int(ys.max()) < 320
    assert int(xs.min()) >= 192 and int(xs.max()) < 320
    assert float((editor.render(expr, pose, cam) - base).abs().max()) > 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["gaussianavatars", "flashavatar", "splattingavatar",
                                    "monogaussianavatar"])
def test_baseline_step_kernels_match_plain(family):
    """One baseline step's gradient phase (forward, loss, backward) through
    kernels 1 and 2 against the same phase through the plain instance
    blend, on a small model of each family: one forward and one backward
    launch; the losses within 1e-5 relative; every gradient tensor (the
    networks' weights and GA's probe included) within 1e-2 relative L2 and
    5e-2 of its largest element, the bound of chip_smoke.py's step
    comparisons; NaN at the same elements (SplattingAvatar's dead rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from fateavatar_tpu_torch.flame.loader import synthetic_flame
    from fateavatar_tpu_torch.ops.camera import make_camera
    from fateavatar_tpu_torch.render import render as render_mod
    from fateavatar_tpu_torch.render.render import RenderConfig
    from fateavatar_tpu_torch.train import registry
    from fateavatar_tpu_torch.train.adapters import make_family_adapter
    from fateavatar_tpu_torch.train.step import Frame
    from fateavatar_tpu_torch.utils.obj_io import sphere_obj_mesh

    dev, res = "cuda", 64
    flame = synthetic_flame(n_verts=96, n_shape=6, n_exp=4, seed=0, device=dev)
    cfg = dict(img_height=res, img_width=res, tex_size=16, capacity=1024, num_samples=512,
               n_init_points=256, max_points=1024, sh_degree=1, cam_scale=1.0,
               dataset_type="synthetic")
    entry = registry.get(family)
    bundle = entry.build_model(sphere_obj_mesh(96), flame, cfg)
    loss_fn = entry.build_loss({}, bundle)
    opt = entry.build_optimizer({})
    rcfg = RenderConfig(max_tiles_per_gaussian=16)
    adapter = make_family_adapter(family, bundle, loss_fn, opt, rcfg, {})
    ts = adapter.init_ts(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    # anisotropic splats: an isotropic one's loss does not depend on its
    # rotation, whose gradient is then float32 noise on both paths
    if family != "monogaussianavatar":
        ts.params = dataclasses.replace(ts.params, **{k: getattr(ts.params, k) + sc * torch.randn(
            getattr(ts.params, k).shape, generator=gen, device=dev)
            for k, sc in (("features_dc", 0.8), ("opacity", 1.0), ("scaling", 0.3),
                          ("rotation", 0.2))})
    frame = Frame(expression=torch.randn(4, generator=gen, device=dev) * 0.2,
                  flame_pose=torch.randn(15, generator=gen, device=dev) * 0.03,
                  camera=make_camera(torch.eye(3, device=dev), torch.tensor([0.0, 0.0, 0.4],
                                     device=dev), 0.8, 0.8, res, res, device=dev),
                  rgb=torch.rand((res, res, 3), generator=gen, device=dev),
                  bg_color=torch.ones(3, device=dev))
    f0, b0 = tblend.blend_instances.launches, tblend.blend_instances_bwd.launches
    gk = adapter.step.grads(ts, frame)
    torch.cuda.synchronize()
    assert tblend.blend_instances.launches == f0 + 1
    assert tblend.blend_instances_bwd.launches == b0 + 1
    assert int(gk[2]["overflow"]) == 0
    orig = render_mod.blend_instances
    render_mod.blend_instances = tblend.blend_instances_plain
    try:
        gp = adapter.step.grads(ts, frame)
    finally:
        render_mod.blend_instances = orig
    assert abs(float(gk[3]["loss"]) - float(gp[3]["loss"])) <= 1e-5 * float(gp[3]["loss"])

    def flat(g, probe):
        out = {}
        for f in dataclasses.fields(g):
            v = getattr(g, f.name)
            out.update({f"{f.name}.{k}": x for k, x in v.items()} if isinstance(v, dict)
                       else {f.name: v})
        if probe is not None:
            out["probe"] = probe
        return out

    a, b = flat(gk[0], gk[1]), flat(gp[0], gp[1])
    moved = 0
    for k in b:
        assert torch.equal(torch.isnan(a[k]), torch.isnan(b[k])), k
        ok = ~torch.isnan(b[k])
        x, y = a[k][ok], b[k][ok]
        if y.numel() == 0 or float(y.abs().max()) == 0.0:
            assert x.numel() == 0 or float(x.abs().max()) == 0.0, k
            continue
        moved += 1
        assert float((x - y).norm() / y.norm()) <= 1e-2, k
        assert float((x - y).abs().max() / y.abs().max()) <= 5e-2, k
    assert moved >= 4


@pytest.mark.cuda
@pytest.mark.parametrize("backbone", ["alex", "vgg"])
def test_lpips_on_the_card_matches_the_cpu(backbone):
    """LPIPS on the card (float32 cuDNN, TF32 off) against the same params
    on the CPU, two 128x128 frames: within 1e-4 relative; its gradient
    w.r.t. the prediction within 1e-3 in relative L2 norm."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fateavatar_tpu_torch.train import lpips as tlp

    p = tlp.lpips_random_params(torch.Generator().manual_seed(0), backbone, device="cpu")
    card = tlp.LpipsParams(backbone, [(w.cuda(), b.cuda()) for w, b in p.convs],
                           [x.cuda() for x in p.lins])
    rng = np.random.default_rng(1)
    a, b = (torch.from_numpy(rng.random((128, 128, 3)).astype(np.float32)) for _ in range(2))
    out = []
    for params, dev in ((p, "cpu"), (card, "cuda")):
        x = a.to(dev).requires_grad_()
        d = tlp.lpips_distance(params, x, b.to(dev))
        (g,) = torch.autograd.grad(d, [x])
        out.append((float(d.detach()), g.cpu()))
    (d_cpu, g_cpu), (d_card, g_card) = out
    assert d_cpu > 0 and abs(d_card - d_cpu) <= 1e-4 * d_cpu
    assert float((g_card - g_cpu).norm() / g_cpu.norm()) <= 1e-3


@pytest.mark.cuda
def test_intrinsics_camera_in_a_graph():
    """``make_camera(intrinsics=K)`` with K and the pose read at a device
    cursor from stacked static buffers, captured in a graph, gives each
    frame's eager projection bit for bit: the offsets never pass the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fateavatar_tpu_torch.ops.camera import make_camera
    from fateavatar_tpu_torch.utils.graphs import Graph

    rng = np.random.default_rng(2)
    n = 5
    K = np.tile(np.array([[600.0, 0, 270], [0, 420.0, 240], [0, 0, 1]], np.float32), (n, 1, 1))
    K[:, 0, 2] += rng.normal(size=n).astype(np.float32) * 10
    T = rng.normal(size=(n, 3)).astype(np.float32) * 0.01 + [0, 0, 0.4]
    Ks, Ts = torch.from_numpy(K).cuda(), torch.from_numpy(T.astype(np.float32)).cuda()
    R = torch.eye(3, device="cuda")
    fovx, fovy = torch.tensor(0.8, device="cuda"), torch.tensor(1.1, device="cuda")
    cursor = torch.zeros(1, dtype=torch.int64, device="cuda")
    out = torch.zeros((n, 4, 4), device="cuda")

    def frame():
        cam = make_camera(R, Ts.index_select(0, cursor)[0], fovx, fovy, 512, 512,
                          intrinsics=Ks.index_select(0, cursor)[0], device="cuda")
        out.index_copy_(0, cursor, cam.full_proj[None])
        cursor.add_(1)

    g = Graph(frame, [cursor, out], "the intrinsics camera")
    for _ in range(n):
        g()
    for i in range(n):
        ref = make_camera(R, T[i], fovx, fovy, 512, 512, intrinsics=K[i], device="cuda")
        assert torch.equal(out[i], ref.full_proj), i
    assert g.replays == n and float((out[1] - out[0]).abs().max()) > 0


@pytest.mark.cuda
def test_a_failed_capture_raises():
    """A function that waits on the device (``.item()``) cannot be
    captured: the helper raises, naming the graph, and runs nothing eagerly
    in its place; the card works on afterwards. (It stays the file's last
    test: the failed capture leaves PyTorch's default CUDA generator in its
    capture state, so a later draw from it raises.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fateavatar_tpu_torch.utils.graphs import Graph

    x = torch.zeros(4, device="cuda")
    g = Graph(lambda: x.add_(x.sum().item() + 1.0), [x], "a function that syncs")
    with pytest.raises(RuntimeError, match="capture of a function that syncs failed"):
        g()
    assert g.graph is None and g.replays == 0
    assert x.tolist() == [0.0] * 4      # the warm-up calls were undone
    assert torch.ones(3, device="cuda").sum().item() == 3.0

