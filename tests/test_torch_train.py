"""The PyTorch port's training slice against the JAX package, on the CPU:
each loss term (VGG included, with the same random weights through
``convert``), MultiAdam with its moment surgery, maintenance (densify given
JAX's own draws), one whole ``make_train_step`` from the same TrainState,
and the Trainer's epochs, checkpoint, resume and evaluation.

Sizes are small: a 64x64 frame, a tex-16 avatar at a 512 capacity, JAX on
``impl="pallas_interpret", kernel="instances"`` as its own tests run it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import np_dict, perturb
from torch_single_thread import one_torch_thread  # noqa: F401 (autouse fixture)
from fateavatar_tpu.flame import synthetic_flame
from fateavatar_tpu.models import fateavatar as jfa
from fateavatar_tpu.models import maintenance as jmaint
from fateavatar_tpu.ops.camera import make_camera as jmake_camera
from fateavatar_tpu.render.render import RenderConfig as JRenderConfig
from fateavatar_tpu.train import datasets as jdatasets
from fateavatar_tpu.train import losses as jl
from fateavatar_tpu.train import optim as jopt
from fateavatar_tpu.train import step as jstep
from fateavatar_tpu.utils.obj_io import sphere_obj_mesh

from fateavatar_tpu_torch import convert
from fateavatar_tpu_torch.models import maintenance as tmaint
from fateavatar_tpu_torch.ops.camera import make_camera
from fateavatar_tpu_torch.render.autosize import autosize_render_config
from fateavatar_tpu_torch.render.render import RenderConfig
from fateavatar_tpu_torch.train import datasets as tdatasets
from fateavatar_tpu_torch.train import losses as tl
from fateavatar_tpu_torch.train import optim as topt
from fateavatar_tpu_torch.train import step as tstep
from fateavatar_tpu_torch.train.trainer import Trainer

RES, TEX, CAP, NV = 64, 16, 512, 96
# the flagship config's loss (configs/fateavatar.yaml), VGG in float32
LOSS_CFG = dict(rgb_weight=1.0, vgg_weight=0.1, scale_weight=0.1,
                scale_threshold=9.0, laplacian_weight=1e5)
NO_MAINT = dict(densify_interval=10**9, prune_interval=10**9,
                opacity_reset_interval=10**9)
FIELDS = ("offset", "features_dc", "features_rest", "scaling", "rotation",
          "opacity", "delta_shapedirs", "delta_posedirs", "delta_vertex")


def t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


def grad_of(fn, *xs):
    """Value of ``fn`` and its gradient w.r.t. every tensor argument."""
    xs = [x.clone().requires_grad_() for x in xs]
    y = fn(*xs)
    return y, torch.autograd.grad(y, xs)


@pytest.fixture(scope="module")
def vgg():
    return jl.vgg16_random_params(jax.random.PRNGKey(0))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _images(h=RES, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((h, h, 3)).astype(np.float32),
            rng.random((h, h, 3)).astype(np.float32))


IMAGE_TERMS = {
    # name: (jax fn, torch fn, image size); tolerances in the test
    "l1": (jl.l1_loss, tl.l1_loss, RES),
    "l2": (jl.l2_loss, tl.l2_loss, RES),
    "psnr": (jl.psnr, tl.psnr, RES),
    "d_ssim": (jl.d_ssim, tl.d_ssim, RES),
    "vgg": (None, None, RES),
    "vgg_downsampled": (None, None, 320),
}


@pytest.mark.parametrize("name", sorted(IMAGE_TERMS))
def test_image_loss_terms_match_jax(name, vgg):
    """Value and gradient w.r.t. the prediction. Tolerance: float32 sums in
    another order (rtol 1e-5, gradient within 1e-5 of its largest element).
    VGG: ten convolutions accumulate in another order (value rtol 1e-4),
    and where the two largest inputs of a 2x2 max pool, or a ReLU input and
    0, differ by less than that rounding, the two frameworks route that
    window's gradient differently; so its gradient is held in relative L2
    norm, 5e-3 (measured 1e-3). ``vgg_downsampled`` feeds a 320-px image,
    so the 224 resize downsamples and its antialiasing is held against
    jax.image.resize."""
    jfn, tfn, h = IMAGE_TERMS[name]
    pred, gt = _images(h)
    if jfn is None:
        def jfn(p, g):
            return jl.vgg_perceptual_loss(vgg, p, g)
        tvgg = convert.vgg_params(vgg, device="cpu")

        def tfn(p, g):
            return tl.vgg_perceptual_loss(tvgg, p, g)
    vj, gj = jax.value_and_grad(jfn)(jnp.asarray(pred), jnp.asarray(gt))
    vt, (gt_,) = grad_of(lambda p: tfn(p, t(gt)), t(pred))
    gj = np.asarray(gj)
    if "vgg" in name:
        np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-4)
        assert np.linalg.norm(gt_.numpy() - gj) <= 5e-3 * np.linalg.norm(gj)
    else:
        np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-5)
        np.testing.assert_allclose(gt_.numpy(), gj, atol=1e-5 * np.abs(gj).max())


def test_resize_and_maxpool_match_jax():
    """The 512 -> 224 antialiased bilinear resize of the VGG loss against
    jax.image.resize (atol 1e-6 on [0, 1] inputs), and the 2x2 max pool's
    tie split (an input of equal values: each element gets a quarter)."""
    x = np.random.default_rng(1).random((1, 512, 512, 3)).astype(np.float32)
    ref = np.asarray(jl._bilinear_resize(jnp.asarray(x), 224))
    got = tl._bilinear_resize(t(x).permute(0, 3, 1, 2), 224).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    ones = np.ones((1, 2, 4, 4), np.float32)
    gj = jax.grad(lambda z: jnp.sum(jl._maxpool2x2(z)))(jnp.asarray(ones))
    _, (gt_,) = grad_of(lambda z: tl._maxpool2x2(z).sum(), t(ones))
    np.testing.assert_array_equal(gt_.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(gt_.numpy(), 0.25)


def _geometry_inputs(seed=2):
    rng = np.random.default_rng(seed)
    mesh = sphere_obj_mesh(NV)
    verts = (mesh.verts[None] + rng.normal(size=(1, NV, 3)) * 0.01).astype(np.float32)
    orig = (mesh.verts[None] + rng.normal(size=(1, NV, 3)) * 0.01).astype(np.float32)
    scale = np.exp(rng.normal(size=(200, 3)) * 1.5).astype(np.float32)
    rot = rng.normal(size=(200, 3)).astype(np.float32)
    alive = rng.random(200) > 0.2
    return mesh.faces, verts, orig, scale, rot, alive


GEOMETRY_TERMS = ("scale_anisotropy", "rotation", "laplacian_delta", "flame_delta")


@pytest.mark.parametrize("name", GEOMETRY_TERMS)
def test_geometry_loss_terms_match_jax(name):
    """Value and gradient; rtol 1e-5 (float32 sums in another order)."""
    faces, verts, orig, scale, rot, alive = _geometry_inputs()
    if name == "scale_anisotropy":
        jfn = lambda x: jl.scale_anisotropy_loss(x, alive, 3.0)        # noqa: E731
        tfn = lambda x: tl.scale_anisotropy_loss(x, t(alive, torch.bool), 3.0)  # noqa: E731
        x = scale
    elif name == "rotation":
        jfn = lambda x: jl.rotation_loss(x, alive)                     # noqa: E731
        tfn = lambda x: tl.rotation_loss(x, t(alive, torch.bool))      # noqa: E731
        x = rot
    elif name == "laplacian_delta":
        jfn = lambda x: jl.laplacian_delta_loss(x, orig, faces)        # noqa: E731
        tfn = lambda x: tl.laplacian_delta_loss(x, t(orig), t(faces, torch.int64))  # noqa: E731
        x = verts
    else:
        jfn = lambda x: jl.flame_delta_loss(x, orig)                   # noqa: E731
        tfn = lambda x: tl.flame_delta_loss(x, t(orig))                # noqa: E731
        x = verts
    vj, gj = jax.value_and_grad(jfn)(jnp.asarray(x))
    vt, (gt_,) = grad_of(tfn, t(x))
    assert float(vj) > 0
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-5)
    gj = np.asarray(gj)
    np.testing.assert_allclose(gt_.numpy(), gj, atol=1e-5 * np.abs(gj).max())


def test_meters_match_jax():
    """The evaluation metrics (image_metrics into the meters) against the
    JAX package's meters on the same images, averaged over two frames
    (rtol 1e-5)."""
    from fateavatar_tpu.train import metrics as jmetrics
    from fateavatar_tpu_torch.train import metrics as tmetrics

    jm = {k: v for k, v in jmetrics.default_meters().items() if k != "lpips"}
    tm = tmetrics.default_meters()
    assert sorted(jm) == sorted(tm) == sorted(tmetrics.IMAGE_METRICS)
    for seed in (0, 1):
        pred, gt = _images(32, seed)
        for k, v in zip(tmetrics.IMAGE_METRICS, tmetrics.image_metrics(t(pred), t(gt))):
            jm[k].update(pred, gt)
            tm[k].update_value(v)
    for k in jm:
        np.testing.assert_allclose(tm[k].measure(), jm[k].measure(), rtol=1e-5, err_msg=k)


def test_prefetcher_raises_worker_errors():
    """A sample that fails in the prefetch thread raises in the consumer
    (instead of leaving it waiting), after the frames before it."""
    class Broken(tdatasets.SyntheticDataset):
        def load_image(self, idx):
            if idx == 2:
                raise OSError("unreadable frame")
            return super().load_image(idx)

    seen = []
    with pytest.raises(OSError, match="unreadable"):
        for s in tdatasets.Prefetcher(Broken(num_frames=4, img_res=(8, 8)), np.arange(4)):
            seen.append(s["idx"])
    assert seen == [0, 1]


def test_fateavatar_loss_refuses_missing_weights():
    with pytest.raises(ValueError):
        tl.FateAvatarLoss(tl.FateAvatarLossConfig(vgg_weight=0.1))
    with pytest.raises(ValueError, match="lpips_params"):
        tl.FateAvatarLoss(tl.FateAvatarLossConfig(lpips_weight=0.1))


# ---------------------------------------------------------------------------
# MultiAdam
# ---------------------------------------------------------------------------

def _params_np(seed, n=6):
    rng = np.random.default_rng(seed)
    shapes = dict(offset=(n, 1), features_dc=(n, 1, 3), features_rest=(n, 1, 3),
                  scaling=(n, 3), rotation=(n, 4), opacity=(n, 1),
                  delta_shapedirs=(5, 3, 4), delta_posedirs=(36, 15),
                  delta_vertex=(5, 3))
    return {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}


def test_multi_adam_matches_jax():
    """Five updates with the flagship learning rates, moment-row surgery
    after step 2 and an opacity-moment reset after step 4, from the same
    gradients. Tolerance 1e-6 relative to each update's largest element
    (float32 rounding of the same arithmetic)."""
    lrs = dict(opacity_lr=0.05, offset_lr=0.0016, feature_dc_lr=0.0025,
               scaling_lr=0.005, rotation_lr=0.001)
    jo, to = jopt.fateavatar_optimizers(lrs), topt.fateavatar_optimizers(lrs)
    jp = jfa.FateAvatarParams(**{k: jnp.asarray(v) for k, v in _params_np(0).items()})
    tp = convert.fateavatar_params(_params_np(0), device="cpu")
    js, ts = jo.init(jp), to.init(tp)
    touched = np.array([True, False, True, False, False, True])
    for i in range(5):
        g = _params_np(10 + i)
        ju, js = jo.update(jfa.FateAvatarParams(**{k: jnp.asarray(v) for k, v in g.items()}),
                           js, jp)
        tu, ts = to.update(convert.fateavatar_params(g, device="cpu"), ts, tp)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
        if i == 1:
            js = jopt.zero_moment_rows(js, jnp.asarray(touched), jmaint.SPLAT_FIELDS)
            ts = topt.zero_moment_rows(ts, t(touched, torch.bool), tmaint.SPLAT_FIELDS)
        if i == 3:
            js, ts = jopt.zero_moment_field(js, "opacity"), topt.zero_moment_field(ts, "opacity")
            np.testing.assert_array_equal(ts.mu.opacity.numpy(), 0.0)
            assert float(ts.nu.offset[0, 0]) != 0.0
        for f in FIELDS:
            ref = np.asarray(getattr(ju, f))
            np.testing.assert_allclose(getattr(tu, f).numpy(), ref,
                                       atol=1e-6 * np.abs(ref).max() + 1e-12, err_msg=f)
            np.testing.assert_allclose(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)),
                                       rtol=1e-6, atol=1e-7, err_msg=f)
    assert int(ts.count) == int(js.count) == 5


# ---------------------------------------------------------------------------
# maintenance
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_avatar():
    flame = synthetic_flame(n_verts=NV, n_shape=8, n_exp=6, seed=0)
    cfg = jfa.FateAvatarConfig(tex_size=TEX, capacity=CAP, img_height=RES,
                               img_width=RES, normal_offset=0.02)
    model, params, state = jfa.init_fateavatar(sphere_obj_mesh(NV), flame, cfg)
    params = params.replace(**perturb(np_dict(params), seed=1))
    rng = np.random.default_rng(7)
    alive = np.asarray(state.alive)
    state = state.replace(
        xyz_gradient_accum=jnp.asarray(np.where(alive, rng.random(CAP), 0.0), jnp.float32),
        denom=jnp.asarray(np.where(alive, 3.0, 0.0), jnp.float32),
        max_radii2d=jnp.asarray(rng.integers(0, 9, CAP), jnp.float32))
    return model, params, state


MAINTENANCE_OPS = ("stats", "max_radii", "prune", "reset_opacity", "densify")


@pytest.mark.parametrize("op", MAINTENANCE_OPS)
def test_maintenance_matches_jax(small_avatar, op):
    """Each op on the same state; densify with the draws jax.random made
    (the generators differ, ROADMAP Queue 3 "Densify RNG"). Exact, but for
    the scale shift log(0.75) (float32 rounding, rtol 1e-6)."""
    _, params, state = small_avatar
    tp = convert.fateavatar_params(np_dict(params), device="cpu")
    ts = convert.fateavatar_state(np_dict(state), device="cpu")
    rng = np.random.default_rng(11)
    vis = rng.random(CAP) > 0.3
    if op == "stats":
        g = rng.normal(size=(2, CAP)).astype(np.float32)
        ref = jmaint.add_densification_stats(state, jnp.asarray(g), jnp.asarray(vis))
        got = tmaint.add_densification_stats(ts, t(g), t(vis, torch.bool))
    elif op == "max_radii":
        radii = rng.integers(0, 12, CAP).astype(np.int32)
        ref = jmaint.update_max_radii(state, jnp.asarray(radii), jnp.asarray(vis))
        got = tmaint.update_max_radii(ts, t(radii, torch.int32), t(vis, torch.bool))
    elif op == "prune":
        ref = jmaint.prune_low_opacity(params, state, 0.2)
        got = tmaint.prune_low_opacity(tp, ts, 0.2)
        assert 0 < int(ref.alive.sum()) < int(state.alive.sum())
    elif op == "reset_opacity":
        ref = jmaint.reset_opacity(params)
        got = tmaint.reset_opacity(tp)
    else:
        key = jax.random.PRNGKey(3)
        k = 40
        ref_p, ref_s, ref_touched = jmaint.uv_densify(key, params, state, increase_num=k)
        # jax.random's draws, as uv_densify makes them (maintenance.py:94-104)
        k_src, k_bary = jax.random.split(key)
        probs = jnp.where(state.alive, state.xyz_gradient_accum, 0.0)
        src = jax.random.categorical(k_src, jnp.log(jnp.maximum(probs, 1e-30)), shape=(k,))
        uvw = jax.random.uniform(k_bary, (k, 3))
        got_p, got_s, touched = tmaint.apply_densify(
            tp, ts, t(np.asarray(src), torch.int64), t(np.asarray(uvw / uvw.sum(-1, keepdims=True))))
        np.testing.assert_array_equal(touched.numpy(), np.asarray(ref_touched))
        assert int(touched.sum()) == k
        for f in tmaint.SPLAT_FIELDS:
            np.testing.assert_allclose(getattr(got_p, f).numpy(), np.asarray(getattr(ref_p, f)),
                                       rtol=1e-6, err_msg=f)
        ref, got = ref_s, got_s
    ref_d = np_dict(ref)
    for f, v in ref_d.items():
        np.testing.assert_allclose(getattr(got, f).numpy(), v, rtol=1e-6, err_msg=f)


def test_densify_draws_follow_the_gradient_accumulator():
    """The port's own draws: sources only where the accumulator is
    positive, in proportion to it (a 3:1 split within 5%), uniform over
    alive splats when every accumulator is 0, barycentrics on the simplex,
    and a full capacity drops writes instead of overwriting live splats."""
    n = 4096
    alive = torch.zeros(n, dtype=torch.bool)
    alive[:40] = True
    accum = torch.zeros(n)
    accum[5], accum[9] = 3.0, 1.0
    st = convert.fateavatar_state({
        "face_index": np.zeros(n), "bary_coords": np.full((n, 3), 1 / 3),
        "alive": alive.numpy(), "xyz_gradient_accum": accum.numpy(),
        "denom": np.ones(n), "sample_flag": np.zeros(n), "max_radii2d": np.zeros(n)},
        device="cpu")
    gen = torch.Generator().manual_seed(0)
    src, bary = tmaint.densify_draws(gen, st, 4000)
    assert set(src.tolist()) == {5, 9}
    assert abs(float((src == 5).float().mean()) - 0.75) < 0.05
    np.testing.assert_allclose(bary.sum(-1).numpy(), 1.0, rtol=1e-6)
    assert bool((bary >= 0).all())
    st0 = dataclasses.replace(st, xyz_gradient_accum=torch.zeros(n))
    src0, _ = tmaint.densify_draws(gen, st0, 4000)
    assert int(src0.max()) < 40 and len(set(src0.tolist())) == 40
    full = dataclasses.replace(st, alive=torch.ones(n, dtype=torch.bool))
    p = convert.fateavatar_params(_params_np(0, n=n), device="cpu")
    p2, s2, touched = tmaint.apply_densify(p, full, src[:8], bary[:8])
    assert not bool(touched.any())
    assert torch.equal(p2.offset, p.offset) and bool(s2.alive.all())


# ---------------------------------------------------------------------------
# one whole train step against the JAX step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def step_pair(small_avatar, vgg):
    """Both packages take the same step from the same TrainState: JAX's
    state after one step (nonzero Adam moments), converted."""
    model, params, state = small_avatar
    state = state.replace(xyz_gradient_accum=jnp.zeros_like(state.xyz_gradient_accum),
                          denom=jnp.zeros_like(state.denom))
    rng = np.random.default_rng(3)
    expr = (rng.normal(size=6) * 0.5).astype(np.float32)
    pose = (rng.normal(size=15) * 0.05).astype(np.float32)
    gt = rng.random((RES, RES, 3)).astype(np.float32)
    jrc = JRenderConfig(impl="pallas_interpret", kernel="instances", binning="twotier",
                        max_tiles_per_gaussian=64)
    jloss = jl.FateAvatarLoss(jl.FateAvatarLossConfig(**LOSS_CFG), vgg_params=vgg)
    jo = jopt.fateavatar_optimizers({})
    jframe = jstep.Frame(
        expression=jnp.asarray(expr), flame_pose=jnp.asarray(pose),
        camera=jmake_camera(np.eye(3), np.array([0.0, 0.0, 0.4]), 0.8, 0.8, RES, RES),
        rgb=jnp.asarray(gt), bg_color=jnp.ones(3))
    jtrain = jstep.make_train_step(model, jloss, jo, jstep.MaintenanceConfig(**NO_MAINT), jrc)
    ts0, _ = jtrain(jstep.init_train_state(params, state, jo), jframe)
    ts0_np = jax.tree.map(np.asarray, ts0)

    def jax_loss(p, probe):
        out = jfa.fateavatar_forward(model, p, ts0.state, jframe.expression,
                                     jframe.flame_pose, jframe.camera,
                                     bg_color=jframe.bg_color, render_cfg=jrc,
                                     means2d_probe=probe)
        losses = jloss(out, {"rgb": jframe.rgb})
        return losses["loss"], losses

    (jgrads, jprobe), jlosses = jax.jit(jax.grad(jax_loss, argnums=(0, 1), has_aux=True))(
        ts0.params, jnp.zeros((2, CAP), jnp.float32))
    ts1, jaux = jtrain(ts0, jframe)

    tmodel = convert.fateavatar_model(np_dict(model), device="cpu")
    tts0 = convert.train_state(np_dict(ts0_np), device="cpu")
    tloss = tl.FateAvatarLoss(tl.FateAvatarLossConfig(**LOSS_CFG),
                              vgg_params=convert.vgg_params(vgg, device="cpu"))
    ttrain = tstep.make_train_step(
        tmodel, tloss, topt.fateavatar_optimizers({}), tstep.MaintenanceConfig(**NO_MAINT),
        RenderConfig(binning="twotier", max_tiles_per_gaussian=64))
    tframe = tstep.Frame(
        expression=t(expr), flame_pose=t(pose),
        camera=make_camera(np.eye(3), [0.0, 0.0, 0.4], 0.8, 0.8, RES, RES, device="cpu"),
        rgb=t(gt), bg_color=torch.ones(3))
    tgrads, tprobe, _, tlosses = ttrain.grads(tts0, tframe)
    tts1, taux = ttrain(tts0, tframe)
    return dict(jgrads=jgrads, jprobe=jprobe, jlosses=jlosses, ts0=ts0_np, ts1=ts1,
                jaux=jaux, tgrads=tgrads, tprobe=tprobe, tlosses=tlosses, tts1=tts1,
                taux=taux)


STEP_PARTS = ("losses", "grads", "probe", "adam", "state")


@pytest.mark.parametrize("part", STEP_PARTS)
def test_train_step_matches_jax(step_pair, part):
    """One make_train_step of each package from the same TrainState, the
    flagship loss (L1, VGG 0.1, scale 0.1 at 9, Laplacian 1e5), twotier
    binning at R = 64. Tolerances:

    * losses: rtol 2e-6 (float32 sums; measured ~5e-7);
    * gradients and the probe gradient: within 2e-4 of each field's largest
      element and 2e-4 in relative L2 norm (FLAME's einsums, the
      scatter-adds and the VGG backward sum in another order, and the VGG
      max pools may route a near-tie differently, see
      test_image_loss_terms_match_jax; measured up to 8e-5 and 7e-5);
    * parameters after Adam: the update arithmetic on the same gradients
      agrees within 1e-6 lr. Across the whole steps, Adam divides by
      sqrt(v), so a gradient element at the float32 noise level of its
      field (~1e-4 of its largest; JAX's own two compilations of this
      gradient differ there) gets an update of noise: the steps agree
      within 1e-2 lr on all but 1% of the elements, and everywhere within
      Adam's bound (|update| <= lr, so 2 lr apart at most);
    * state: the densify accumulator is the probe gradient's norm (its
      tolerance); max radii, counts and alive are exact."""
    s = step_pair
    if part == "losses":
        for k, v in s["jlosses"].items():
            np.testing.assert_allclose(float(s["tlosses"][k]), float(v), rtol=2e-6, err_msg=k)
            np.testing.assert_allclose(float(s["taux"][k]), float(s["jaux"][k]),
                                       rtol=2e-6, err_msg=k)
        assert float(s["jlosses"]["vgg_loss"]) > 0 and float(s["jlosses"]["laplacian_loss"]) > 0
        assert int(s["taux"]["overflow"]) == int(s["jaux"]["overflow"]) == 0
    elif part == "grads":
        for f in FIELDS:
            ref = np.asarray(getattr(s["jgrads"], f))
            got = getattr(s["tgrads"], f).numpy()
            np.testing.assert_allclose(got, ref, atol=2e-4 * np.abs(ref).max(), err_msg=f)
            assert np.linalg.norm(got - ref) <= 2e-4 * np.linalg.norm(ref), f
            if f != "features_rest":   # SH degree 0 reads no rest coefficient
                assert np.abs(ref).max() > 0, f
    elif part == "probe":
        ref = np.asarray(s["jprobe"])
        assert np.abs(ref).max() > 0
        got = s["tprobe"].numpy()
        np.testing.assert_allclose(got, ref, atol=2e-4 * np.abs(ref).max())
        assert np.linalg.norm(got - ref) <= 2e-4 * np.linalg.norm(ref)
    elif part == "adam":
        # the update arithmetic alone: both optimizers on JAX's gradients
        ts0 = s["ts0"]
        ju, _ = jopt.fateavatar_optimizers({}).update(s["jgrads"], ts0.opt_state, ts0.params)
        tu, _ = topt.fateavatar_optimizers({}).update(
            convert.fateavatar_params(np_dict(s["jgrads"]), device="cpu"),
            convert.multi_adam_state(np_dict(ts0.opt_state), device="cpu"),
            convert.fateavatar_params(np_dict(ts0.params), device="cpu"))
        lrs = topt.fateavatar_optimizers({}).lr_tree
        for f in FIELDS:
            ref = np.asarray(getattr(ju, f))
            np.testing.assert_allclose(getattr(tu, f).numpy(), ref,
                                       atol=1e-6 * lrs[f] + 1e-12, err_msg=f)
            # the whole steps: within Adam's bound everywhere, and within
            # 1e-2 lr on all but the noise-level elements (< 1%)
            d = np.abs(getattr(s["tts1"].params, f).numpy()
                       - np.asarray(getattr(s["ts1"].params, f)))
            assert (d <= 2 * lrs[f] + 1e-6).all(), f
            assert (d > 1e-2 * lrs[f] + 1e-6).mean() < 0.01, f
        assert int(s["tts1"].opt_state.count) == int(s["ts1"].opt_state.count) == 2
        assert s["tts1"].step == int(s["ts1"].step) == 2
    else:
        for f in ("xyz_gradient_accum", "denom", "max_radii2d", "alive"):
            ref = np.asarray(getattr(s["ts1"].state, f))
            np.testing.assert_allclose(getattr(s["tts1"].state, f).numpy(), ref,
                                       atol=2e-4 * np.abs(ref).max(), err_msg=f)
        assert np.abs(np.asarray(s["ts1"].state.xyz_gradient_accum)).max() > 0


# ---------------------------------------------------------------------------
# the Trainer on the CPU
# ---------------------------------------------------------------------------

def test_synthetic_dataset_matches_jax():
    """The same seed gives the JAX package's frames, poses and cameras."""
    j = jdatasets.SyntheticDataset(num_frames=3, img_res=(16, 16), seed=4)
    p = tdatasets.SyntheticDataset(num_frames=3, img_res=(16, 16), seed=4)
    for i in range(3):
        a, b = j.sample(i), p.sample(i)
        for k in ("expression", "flame_pose", "cam_pose"):
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a["ground_truth"]["rgb"], b["ground_truth"]["rgb"])


def test_trainer_epochs_checkpoint_resume_eval(tmp_path):
    """Two epochs over a 4-frame SyntheticDataset with autosize and
    densify / prune firing, a checkpoint, a resumed Trainer that restores
    step, moments and generator and trains a third epoch, and a finite eval
    PSNR."""
    from fateavatar_tpu_torch.flame.loader import synthetic_flame as tsynthetic_flame
    from fateavatar_tpu_torch.models import fateavatar as tfa

    flame = tsynthetic_flame(n_verts=NV, n_shape=6, n_exp=4, seed=0, device="cpu")
    cfg = tfa.FateAvatarConfig(tex_size=TEX, capacity=CAP, img_height=RES,
                               img_width=RES, normal_offset=0.02)
    model, params, state = tfa.init_fateavatar(sphere_obj_mesh(NV), flame, cfg, device="cpu")
    ds = tdatasets.SyntheticDataset(num_frames=4, img_res=(RES, RES))
    loss = tl.FateAvatarLoss(tl.FateAvatarLossConfig(rgb_weight=1.0, scale_weight=0.1,
                                                     laplacian_weight=1e5))
    maint = tstep.MaintenanceConfig(densify_interval=3, prune_interval=5,
                                    increase_num=16, max_points_num=CAP)

    def trainer():
        return Trainer("t", model, params, state, loss, topt.fateavatar_optimizers({}),
                       ds, ds, workspace=str(tmp_path), maint_cfg=maint,
                       render_cfg=RenderConfig(binning="twotier",
                                               max_tiles_per_gaussian=64, autosize=True))

    tr = trainer()
    assert tr.render_cfg.instance_budget > 0 and not tr.render_cfg.autosize
    n0 = int(state.alive.sum())
    tr.train(2)
    assert tr.global_step == tr.ts.step == 8
    assert int(tr.ts.state.alive.sum()) == n0 + 2 * 16      # densify at steps 3 and 6
    assert tr.last_epoch_stats["overflow"] == 0
    assert all(np.isfinite(tr.epoch_losses))
    resumed = trainer()
    caps = ("instance_budget", "max_tiles_per_gaussian", "tail_k")
    before = {k: getattr(resumed.render_cfg, k) for k in caps}
    resumed.load_checkpoint()
    assert resumed.global_step == 8 and resumed.epoch == 2
    # the caps were probed again on the restored splats and only grown
    probe = autosize_render_config(model, resumed.ts.params, resumed.ts.state,
                                   resumed._probe_frames(), resumed.render_cfg)
    for k in caps:
        got = getattr(resumed.render_cfg, k)
        assert got == max(before[k], getattr(probe, k)), k
    big = dataclasses.replace(resumed.render_cfg, instance_budget=4 * before["instance_budget"])
    resumed.set_render_cfg(big)
    resumed.regrow_caps()
    assert resumed.render_cfg == big
    resumed.set_render_cfg(dataclasses.replace(big, **before))
    assert torch.equal(resumed.ts.opt_state.mu.opacity, tr.ts.opt_state.mu.opacity)
    assert torch.equal(resumed.ts.opt_state.count, tr.ts.opt_state.count)
    assert torch.equal(resumed.ts.generator.get_state(), tr.ts.generator.get_state())
    resumed.train(3)
    assert resumed.global_step == 12
    summary = resumed.evaluate()
    assert np.isfinite(summary["psnr"]) and 0 < summary["ssim"] <= 1
    assert (tmp_path / "media" / "metrics" / "test_epoch3.json").exists()
