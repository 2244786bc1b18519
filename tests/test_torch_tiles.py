"""The PyTorch port's ``kernel="tiles"`` route against the JAX package, on
the CPU: the dense binning (bit-exact), the plain dense-list blend and its
backward against the Pallas kernels in interpret mode, ``render()`` on the
golden scenes and its gradients against JAX's tiles route, the tiles route
against the instances route, and the slice as a whole (a served frame and
one train step). The CUDA kernels themselves are held against their plain
versions on the card by tests/test_torch_cuda.py."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_scenes import SCENES
from test_torch_model import RES, _port_avatar, avatar, np_dict  # noqa: F401 (fixture)
from test_torch_render import (
    _binning_inputs, _port_scene, assert_gradients_match_jax, assert_matches_golden, t)
from test_torch_train import CAP, FIELDS, LOSS_CFG, NO_MAINT, small_avatar, vgg  # noqa: F401
from torch_tile_cases import TILE_CASES, jax_layout, tile_case
from torch_single_thread import one_torch_thread  # noqa: F401 (autouse fixture)
from fateavatar_tpu.ops.camera import make_camera as jmake_camera
from fateavatar_tpu.render import binning as jbinning
from fateavatar_tpu.render.blend_tiles import blend_tiles_pallas, blend_tiles_xla
from fateavatar_tpu.render.render import RenderConfig as JRenderConfig
from fateavatar_tpu.train import losses as jl
from fateavatar_tpu.train import optim as jopt
from fateavatar_tpu.train import step as jstep
from fateavatar_tpu.train.checkpoints import CheckpointManager as JCheckpointManager
from fateavatar_tpu.train.loader import Reenactor as JReenactor

from fateavatar_tpu_torch import convert
from fateavatar_tpu_torch.ops.camera import make_camera
from fateavatar_tpu_torch.render import binning as tbinning
from fateavatar_tpu_torch.render import blend_tiles as tblend
from fateavatar_tpu_torch.render.render import RenderConfig, render
from fateavatar_tpu_torch.train import losses as tl
from fateavatar_tpu_torch.train import optim as topt
from fateavatar_tpu_torch.train import step as tstep
from fateavatar_tpu_torch.train.checkpoints import CheckpointManager
from fateavatar_tpu_torch.train.loader import Reenactor, checkpoint_tree

# ---------------------------------------------------------------------------
# binning
# ---------------------------------------------------------------------------

TILE_BINNING_CASES = {
    # (K, R, budget, dead): the default 6N budget, and each cap dropping
    "default": (1024, 32, 0, False),
    "over_budget": (64, 64, 300, False),
    "r_drops": (1024, 4, 0, False),
    "k_overflow": (16, 64, 0, False),
    "dead": (256, 32, 0, True),
}


def _tile_inputs(case, seed):
    grid = (5, 6)
    mx, my, depth, radius = _binning_inputs(400, seed=seed, grid=grid)
    if TILE_BINNING_CASES[case][3]:
        radius[200:] = 0           # dead splats: preprocess gives them radius 0
    return grid, mx, my, depth, radius


def _assert_lists_equal(got, ids, counts, overflow):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(ids))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(counts))
    assert int(got.overflow) == int(overflow)
    assert got.ids.dtype == got.counts.dtype == got.overflow.dtype == torch.int32


@pytest.mark.parametrize("case", sorted(TILE_BINNING_CASES))
def test_build_tile_lists_matches_jax_exactly(case):
    """ids, counts and overflow bit-exact with the JAX package on a scene
    with bit-equal depth ties, off-screen means, invisible splats and a
    heavy tail of large radii."""
    k, r, budget, _ = TILE_BINNING_CASES[case]
    grid, mx, my, depth, radius = _tile_inputs(case, seed=len(case))
    ref = jbinning.build_tile_lists(np.stack([mx, my], -1), depth, radius, grid,
                                    max_per_tile=k, max_tiles_per_gaussian=r,
                                    instance_budget=budget)
    got = tbinning.build_tile_lists(t(mx), t(my), t(depth), t(radius, torch.int32), grid,
                                    max_per_tile=k, max_tiles_per_gaussian=r,
                                    instance_budget=budget)
    _assert_lists_equal(got, ref.ids, ref.counts, ref.overflow)
    assert (int(ref.overflow) > 0) == (case in ("over_budget", "r_drops", "k_overflow"))


@pytest.mark.parametrize("block", [4096, 16])
@pytest.mark.parametrize("case", ["default", "dead", "r_drops", "k_overflow"])
def test_build_tile_lists_scan_matches_jax_exactly(case, block):
    """The sort-free scan binning bit-exact with the JAX package's, also
    where it departs from the sort (R drops leave reserved slots empty;
    rects clipped to zero width write past the counts)."""
    k, r, _, _ = TILE_BINNING_CASES[case]
    grid, mx, my, depth, radius = _tile_inputs(case, seed=len(case))
    ref = jbinning.build_tile_lists_scan(np.stack([mx, my], -1), depth, radius, grid,
                                         max_per_tile=k, max_tiles_per_gaussian=r,
                                         block=block)
    got = tbinning.build_tile_lists_scan(t(mx), t(my), t(depth), t(radius, torch.int32),
                                         grid, max_per_tile=k, max_tiles_per_gaussian=r,
                                         block=block)
    _assert_lists_equal(got, ref.ids, ref.counts, ref.overflow)


@pytest.mark.parametrize("block", [4096, 16])
def test_scan_binning_matches_sort_binning(block):
    """While nothing is dropped and every rect lies on screen, the scan
    binning gives the port's sorted lists exactly (the JAX package's own
    test_scan_binning_matches_sort_binning), dead splats included."""
    grid = (5, 6)
    mx, my, depth, radius = _binning_inputs(400, seed=4, grid=grid)
    mx = np.clip(mx, radius + 1.0, 16 * grid[1] - radius - 1.0).astype(np.float32)
    my = np.clip(my, radius + 1.0, 16 * grid[0] - radius - 1.0).astype(np.float32)
    radius[300:] = 0
    args = (t(mx), t(my), t(depth), t(radius, torch.int32), grid)
    a = tbinning.build_tile_lists(*args, max_per_tile=512, max_tiles_per_gaussian=128,
                                  instance_budget=400 * 128)
    b = tbinning.build_tile_lists_scan(*args, max_per_tile=512,
                                       max_tiles_per_gaussian=128, block=block)
    assert int(a.overflow) == 0
    _assert_lists_equal(b, a.ids, a.counts, a.overflow)


# ---------------------------------------------------------------------------
# the plain dense-list blend and its backward
# ---------------------------------------------------------------------------

def _port_case(name):
    data, valid, counts, bg, grid = tile_case(name)
    return (t(data), t(valid), t(counts, torch.int32), t(bg), grid), (data, valid, counts,
                                                                      bg, grid)


@pytest.mark.parametrize("name", sorted(TILE_CASES))
def test_plain_tile_blend_matches_jax(name):
    """blend_tiles on the CPU (the plain version) against
    blend_tiles_pallas (interpret) and blend_tiles_xla. Tolerance 2e-4: the
    three take the transmittance product in other orders (sequential
    cumprod per window, t_incl / (1 - alpha)), which can flip which slot
    crosses T = 1e-4 at a pixel and move it by at most alpha * T <= 1e-4."""
    args, (data, valid, counts, bg, grid) = _port_case(name)
    img, tfin = tblend.blend_tiles(*args)
    jarrs = jax_layout(data, valid, counts, grid)
    img_p, tfin_p = blend_tiles_pallas(*jarrs, counts, bg, grid, 64, True)
    img_x, tfin_x = blend_tiles_xla(*jarrs[:4], jarrs[4] > 0, bg, grid, chunk=64)
    for ref_img, ref_t in ((img_p, tfin_p), (img_x, tfin_x)):
        np.testing.assert_allclose(img.numpy(), np.asarray(ref_img), atol=2e-4)
        np.testing.assert_allclose(tfin.numpy(), np.asarray(ref_t), atol=2e-4)
    if name == "empty":
        np.testing.assert_array_equal(tfin.numpy()[counts == 0], 1.0)
    if name == "saturated":
        assert (np.asarray(tfin_p) < 1e-3).mean() > 0.2
    if name == "over_k":
        assert (counts > data.shape[1] // 12).any()


def _cotangents(grid, seed=5):
    n = grid[0] * grid[1]
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3, 256)).astype(np.float32),
            rng.normal(size=(n, 256)).astype(np.float32))


def _assert_rows_close(got, ref, rtol):
    """Each of the 9 gradient rows within ``rtol`` of its largest element."""
    for row in range(9):
        np.testing.assert_allclose(got[row], ref[row],
                                   atol=rtol * np.abs(ref[row]).max() + 1e-7,
                                   err_msg=f"row {row}")


@pytest.mark.parametrize("name", sorted(TILE_CASES))
def test_plain_tile_backward_matches_pallas_interpret(name):
    """blend_tiles_backward_reference against jax.vjp of blend_tiles_pallas
    (interpret), g_bg against _blend_bwd's einsum. Tolerance 1e-4 of each
    field's largest element: the two sum each slot's 256 pixel terms in
    another order and take the prefix as g . img - pu instead of per-channel
    suffixes; zero past every list exactly."""
    args, (data, valid, counts, bg, grid) = _port_case(name)
    g_img, g_tfin = _cotangents(grid)
    jarrs = jax_layout(data, valid, counts, grid)
    (_, _), vjp = jax.vjp(
        lambda m, c, cl, op, b: blend_tiles_pallas(m, c, cl, op, jarrs[4], counts, b, grid,
                                                   64, True),
        *jarrs[:4], bg)
    gm, gc, gcl, gop, g_bg_j = vjp((g_img, g_tfin))
    T, k = counts.shape[0], data.shape[1] // counts.shape[0]
    ref = np.concatenate([np.asarray(gm), np.asarray(gc), np.asarray(gcl),
                          np.asarray(gop)[..., None]], axis=-1).reshape(T * k, 9).T
    img, tfin = tblend.blend_tiles_reference(*args)
    got = tblend.blend_tiles_backward_reference(*args[:4], img, tfin, t(g_img),
                                                t(g_tfin), grid).numpy()
    _assert_rows_close(got, ref, 1e-4)
    in_list = (np.arange(k)[None, :] < np.minimum(counts, k)[:, None]).reshape(-1)
    np.testing.assert_array_equal(got[:, ~in_list], 0.0)
    g_bg = torch.einsum("tdp,tp->d", t(g_img), tfin).numpy()
    np.testing.assert_allclose(g_bg, np.asarray(g_bg_j), rtol=1e-5)


@pytest.mark.parametrize("name", sorted(TILE_CASES))
def test_plain_tile_backward_matches_autograd(name):
    """An independent check: torch.autograd through the plain forward
    (straight-through 0.99 clamp) gives the same g_data and g_bg as the
    hand-derived backward that blend_tiles runs on the CPU (no launch
    counted). Tolerance 5e-5 of each row's largest element (autograd sums
    the cumulative products' gradients in another order)."""
    (data, valid, counts, bg, grid), _ = _port_case(name)
    g_img, g_tfin = map(t, _cotangents(grid))

    def grads(blend):
        x, b = data.clone().requires_grad_(), bg.clone().requires_grad_()
        img, tfin = blend(x, valid, counts, b, grid)
        return torch.autograd.grad((img * g_img).sum() + (tfin * g_tfin).sum(), (x, b))

    ga, gba = grads(lambda *a: tblend.blend_tiles_reference(*a))
    before = tblend.blend_tiles_bwd.launches
    gk, gbk = grads(tblend.blend_tiles)
    assert tblend.blend_tiles_bwd.launches == before
    _assert_rows_close(gk.numpy(), ga.numpy(), 5e-5)
    np.testing.assert_allclose(gbk.numpy(), gba.numpy(), rtol=1e-5)
    assert gk[:9].abs().max() > 0


def test_blend_tiles_rejects_bad_inputs():
    (data, valid, counts, bg, grid), _ = _port_case("empty")
    for bad in ((data[:8], valid, counts, bg, grid),
                (data, valid[:-1], counts, bg, grid),
                (data, valid, counts.long(), bg, grid),
                (data[:, :-1], valid[:-1], counts, bg, grid)):
        with pytest.raises(ValueError):
            tblend.blend_tiles(*bad)


def test_pair_counts_stop_at_termination_and_the_lists():
    (data, valid, counts, bg, grid), _ = _port_case("saturated")
    evaluated, blended = tblend.pair_counts(data, valid, counts, grid)
    upper = int(np.minimum(counts.numpy(), data.shape[1] // 12).sum()) * 256
    assert 0 < blended < evaluated < upper


# ---------------------------------------------------------------------------
# render(kernel="tiles")
# ---------------------------------------------------------------------------

def _tiles_cfg(n, binning="onesort", **kw):
    return RenderConfig(kernel="tiles", binning=binning, max_per_tile=128,
                        max_tiles_per_gaussian=64, instance_budget=n * 64, **kw)


@pytest.mark.parametrize("binning", ["onesort", "scan"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_tiles_matches_goldens(name, binning):
    """The tiles route reproduces every golden scene at atol 5e-5, radii
    exact, through the sorted and the scan binning."""
    assert_matches_golden(name, lambda n: _tiles_cfg(n, binning))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_tiles_gradients_match_jax(name):
    """The tiles route's gradients, probe included, against JAX's tiles
    route through the Pallas kernel (interpret) on each golden scene (see
    assert_gradients_match_jax for the tolerance)."""
    assert_gradients_match_jax(name, lambda n: (_tiles_cfg(n), JRenderConfig(
        impl="pallas_interpret", kernel="tiles", max_per_tile=128,
        max_tiles_per_gaussian=64, instance_budget=n * 64)))


def test_tiles_route_matches_instances_route():
    """On one scene both routes bin the same depth-ordered splats per tile,
    so image and transmittance agree within 2e-4 (the plain blends group the
    transmittance product in windows of 64 and 128), and every gradient,
    probe included, within 1e-4 of its field's largest element; the tile
    counts are equal."""
    cam, g, bg, n = _port_scene("aniso")
    rng = np.random.default_rng(2)
    g_img = t(rng.normal(size=(cam.height, cam.width, 3)))
    fields = ("xyz", "scaling", "rotation", "opacity", "features_dc")

    def run(cfg):
        leaves = {f: getattr(g, f).clone().requires_grad_() for f in fields}
        probe = torch.zeros((2, n), requires_grad=True)
        out = render(cam, dataclasses.replace(g, **leaves), bg, config=cfg,
                     means2d_probe=probe)
        grads = torch.autograd.grad((out["render"] * g_img).sum() + out["t_final"].sum(),
                                    [*leaves.values(), probe])
        return out, grads

    tiles, g_tiles = run(_tiles_cfg(n))
    inst, g_inst = run(RenderConfig(instance_budget=n * 64, max_tiles_per_gaussian=64))
    assert int(tiles["overflow"]) == int(inst["overflow"]) == 0
    np.testing.assert_array_equal(tiles["tile_counts"].numpy(), inst["tile_counts"].numpy())
    for key in ("render", "t_final"):
        np.testing.assert_allclose(tiles[key].detach().numpy(), inst[key].detach().numpy(),
                                   atol=2e-4)
    for f, a, b in zip(fields + ("probe",), g_tiles, g_inst):
        assert b.abs().max() > 0, f
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4 * b.abs().max().item(),
                                   err_msg=f)


def test_tiles_settings_come_from_the_config():
    """cli/common.render_config passes max_per_tile and chunk from the
    yaml, as the JAX package's does; kernel stays the default."""
    from fateavatar_tpu_torch.cli import common
    from fateavatar_tpu_torch.utils.config import load_config

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(repo, "configs", "fateavatar.yaml"),
                      ["render.max_per_tile=4096", "render.chunk=32"])
    rc = common.render_config(cfg)
    assert (rc.max_per_tile, rc.chunk, rc.kernel) == (4096, 32, "instances")


# ---------------------------------------------------------------------------
# the slice as a whole: a served frame and one train step
# ---------------------------------------------------------------------------

K_SLICE = 256    # the tex-16 avatar's 256 splats fit any tile's list


def test_reenactor_tiles_matches_jax(avatar, tmp_path):  # noqa: F811
    """A checkpointed avatar served through Reenactor.render_frame with
    kernel="tiles" against the JAX package's Reenactor on its tiles route
    (Pallas kernel in interpret mode), twotier binning setting at R = 64.
    Tolerance as test_forward_matches_jax: atol 2e-4 per pixel (a
    termination flip) and 1e-6 in the mean (FLAME and the projection sum in
    another order)."""
    _, model, params, state = avatar
    jws, tws = tmp_path / "jax", tmp_path / "torch"
    jck = JCheckpointManager(str(jws / "checkpoints"))
    jck.save(1, {"ts": jstep.init_train_state(params, state, jopt.fateavatar_optimizers({})),
                 "epoch": 1, "global_step": 1})
    jck.close()
    jre = JReenactor(model, params, state, str(jws), render_cfg=JRenderConfig(
        impl="pallas_interpret", kernel="tiles", binning="twotier",
        max_tiles_per_gaussian=64, max_per_tile=K_SLICE))
    m, p, s = _port_avatar(model, params, state)
    CheckpointManager(str(tws / "checkpoints")).save(1, checkpoint_tree(p, s, epoch=1))
    tre = Reenactor(m, p, s, str(tws), render_cfg=RenderConfig(
        kernel="tiles", binning="twotier", max_tiles_per_gaussian=64,
        max_per_tile=K_SLICE))
    rng = np.random.default_rng(10)
    expr = (rng.normal(size=6) * 0.5).astype(np.float32)
    pose = (rng.normal(size=15) * 0.05).astype(np.float32)
    ref = np.asarray(jre.render_frame(expr, pose, jmake_camera(
        np.eye(3), np.array([0.0, 0.0, 0.4]), 0.8, 0.8, RES, RES)))
    img = tre.render_frame(expr, pose, make_camera(
        np.eye(3), [0.0, 0.0, 0.4], 0.8, 0.8, RES, RES, device="cpu")).numpy()
    assert img.shape == (RES, RES, 3) and img.std() > 0.02
    np.testing.assert_allclose(img, ref, atol=2e-4)
    assert np.abs(img - ref).mean() < 1e-6


def test_train_step_tiles_matches_jax(small_avatar, vgg):  # noqa: F811
    """One make_train_step with kernel="tiles" from the same TrainState as
    the JAX package's loss and gradients on its tiles route (Pallas kernel
    in interpret mode), the flagship loss, twotier binning setting at
    R = 64. Tolerances as test_train_step_matches_jax: losses rtol 2e-6,
    every gradient and the probe gradient within 2e-4 of its field's
    largest element and in relative L2 norm."""
    model, params, state = small_avatar
    rng = np.random.default_rng(3)
    expr = (rng.normal(size=6) * 0.5).astype(np.float32)
    pose = (rng.normal(size=15) * 0.05).astype(np.float32)
    gt = rng.random((RES, RES, 3)).astype(np.float32)
    jrc = JRenderConfig(impl="pallas_interpret", kernel="tiles", binning="twotier",
                        max_tiles_per_gaussian=64, max_per_tile=K_SLICE)
    jloss = jl.FateAvatarLoss(jl.FateAvatarLossConfig(**LOSS_CFG), vgg_params=vgg)
    ts0 = jstep.init_train_state(params, state, jopt.fateavatar_optimizers({}))
    jcam = jmake_camera(np.eye(3), np.array([0.0, 0.0, 0.4]), 0.8, 0.8, RES, RES)

    def jax_loss(p, probe):
        from fateavatar_tpu.models import fateavatar as jfa

        out = jfa.fateavatar_forward(model, p, ts0.state, jnp.asarray(expr),
                                     jnp.asarray(pose), jcam, bg_color=jnp.ones(3),
                                     render_cfg=jrc, means2d_probe=probe)
        losses = jloss(out, {"rgb": jnp.asarray(gt)})
        return losses["loss"], losses

    (jgrads, jprobe), jlosses = jax.jit(jax.grad(jax_loss, argnums=(0, 1), has_aux=True))(
        ts0.params, jnp.zeros((2, CAP), jnp.float32))

    tts0 = convert.train_state(np_dict(jax.tree.map(np.asarray, ts0)), device="cpu")
    ttrain = tstep.make_train_step(
        convert.fateavatar_model(np_dict(model), device="cpu"),
        tl.FateAvatarLoss(tl.FateAvatarLossConfig(**LOSS_CFG),
                          vgg_params=convert.vgg_params(vgg, device="cpu")),
        topt.fateavatar_optimizers({}), tstep.MaintenanceConfig(**NO_MAINT),
        RenderConfig(kernel="tiles", binning="twotier", max_tiles_per_gaussian=64,
                     max_per_tile=K_SLICE))
    tframe = tstep.Frame(
        expression=t(expr), flame_pose=t(pose),
        camera=make_camera(np.eye(3), [0.0, 0.0, 0.4], 0.8, 0.8, RES, RES, device="cpu"),
        rgb=t(gt), bg_color=torch.ones(3))
    tgrads, tprobe, _, tlosses = ttrain.grads(tts0, tframe)
    _, taux = ttrain(tts0, tframe)
    for k, v in jlosses.items():
        np.testing.assert_allclose(float(tlosses[k]), float(v), rtol=2e-6, err_msg=k)
        np.testing.assert_allclose(float(taux[k]), float(v), rtol=2e-6, err_msg=k)
    assert int(taux["overflow"]) == 0
    pairs = [(f, getattr(tgrads, f).numpy(), np.asarray(getattr(jgrads, f))) for f in FIELDS]
    for f, got, ref in pairs + [("probe", tprobe.numpy(), np.asarray(jprobe))]:
        if f == "features_rest":   # SH degree 0 reads no rest coefficient
            continue
        assert np.abs(ref).max() > 0, f
        np.testing.assert_allclose(got, ref, atol=2e-4 * np.abs(ref).max(), err_msg=f)
        assert np.linalg.norm(got - ref) <= 2e-4 * np.linalg.norm(ref), f
