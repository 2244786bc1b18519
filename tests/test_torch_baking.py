"""The PyTorch port's neural baking and texture editing against the JAX
package, on the CPU: the activations, ``texture_lookup`` and its texture
gradient, the decoder networks (flax variables carried across through
``convert``), ``build_uv_decoder``, the decoder forward, the textured
render and the export, one ``UVBaker`` step and a bake epoch with a pseudo
set, the files each package reads of the other's, ``UVEditor``, and both
CLIs with ``--device cpu``.

Sizes are small: ``tests/test_baking.py``'s decoder fixture (a tex-8 avatar
at a 96 capacity plus 64 fresh samples, 32x32 frames, ``feature_map``
decoding), a 32x32 UNet input."""

import dataclasses
import os
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_model import np_dict, perturb
from test_torch_tracking import _jax_avatar
from torch_layouts import orbit, write_imavatar
from torch_single_thread import one_torch_thread  # noqa: F401 (autouse fixture)
from fateavatar_tpu.models import unet as junet
from fateavatar_tpu.models import uv_decoder as juvd
from fateavatar_tpu.ops import quaternion as jquat
from fateavatar_tpu.ops import sh as jsh
from fateavatar_tpu.ops.camera import make_camera as jmake_camera
from fateavatar_tpu.render.render import RenderConfig as JRenderConfig
from fateavatar_tpu.train import baker as jbaker
from fateavatar_tpu.train import checkpoints as jckpt
from fateavatar_tpu.train import datasets as jdatasets
from fateavatar_tpu.train import losses as jl
from fateavatar_tpu.utils.obj_io import sphere_obj_mesh

from fateavatar_tpu_torch import convert
from fateavatar_tpu_torch.cli import avatar_edit_baked, train_mono_avatar, train_neural_baking
from fateavatar_tpu_torch.flame.loader import synthetic_flame as tsynthetic_flame
from fateavatar_tpu_torch.flame.loader import synthetic_flame_data
from fateavatar_tpu_torch.models import fateavatar as tfa
from fateavatar_tpu_torch.models import unet as tunet
from fateavatar_tpu_torch.models import uv_decoder as tuvd
from fateavatar_tpu_torch.ops import quaternion as tquat
from fateavatar_tpu_torch.ops import sh as tsh
from fateavatar_tpu_torch.ops.camera import make_camera
from fateavatar_tpu_torch.render.render import RenderConfig
from fateavatar_tpu_torch.train import baker as tbaker
from fateavatar_tpu_torch.train import checkpoints as tckpt
from fateavatar_tpu_torch.train import datasets as tdatasets
from fateavatar_tpu_torch.train import losses as tl
from fateavatar_tpu_torch.utils.png import read_png, write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, NV = 32, 96
# JAX through its XLA blend (dense tile lists, K large enough that nothing
# overflows); the port through its instance route, as the bake runs it
JRCFG = JRenderConfig(impl="xla", max_per_tile=256, chunk=32)
RCFG = RenderConfig()
BAKE_ATTRS = ("color", "opacity")
REG = dict(reg_weight=0.1, reg_attribute=("color", "opacity"))


def t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


def close(a, b, rtol, what=""):
    """Each element within ``rtol`` of the reference's largest magnitude."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = max(np.abs(b).max(), 1e-30)
    err = np.abs(a - b).max() / scale
    assert err <= rtol, f"{what}: {err:.2e} > {rtol:.0e}"


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# ---------------------------------------------------------------------------
# (a) activations, texture lookup, helpers
# ---------------------------------------------------------------------------

def test_activations_match_jax():
    rng = np.random.default_rng(0)
    x3 = rng.normal(size=(8, 8, 3)).astype(np.float32) * 2
    x1 = rng.normal(size=(8, 8, 1)).astype(np.float32) * 2
    ms, mx = np.float32(-4.5), np.float32(-3.9)
    for name, x in (("color", x3), ("opacity", x1), ("scaling", x3 * 3),
                    ("rotation", x3), ("offset", x1)):
        ref = juvd.activate_texture(name, jnp.asarray(x), ms, mx)
        got = tuvd.activate_texture(name, t(x), t(ms), t(mx))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    aa = np.concatenate([rng.normal(size=(16, 3)), np.zeros((1, 3))]).astype(np.float32)
    np.testing.assert_allclose(tquat.axis_angle_to_quat(t(aa)).numpy(),
                               np.asarray(jquat.axis_angle_to_quat(jnp.asarray(aa))),
                               rtol=1e-6, atol=1e-6)
    sh = rng.normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(tsh.sh_to_rgb(t(sh)).numpy(),
                               np.asarray(jsh.sh_to_rgb(jnp.asarray(sh))), rtol=1e-6,
                               atol=1e-6)


def test_texture_lookup_and_gradient_match_jax():
    """UVs inside, outside [0, 1] and at the exact corners and edges; the
    texture gradient is the gather's index_add_ transpose."""
    rng = np.random.default_rng(1)
    tex = rng.normal(size=(7, 9, 4)).astype(np.float32)
    uv = np.concatenate([
        rng.random((40, 2)), rng.random((10, 2)) * 3 - 1,
        [[0, 0], [1, 0], [0, 1], [1, 1], [0.5, 1], [1, 0.25], [-0.5, 2]]]).astype(np.float32)
    cot = rng.normal(size=(uv.shape[0], 4)).astype(np.float32)
    ref = juvd.texture_lookup(jnp.asarray(tex), jnp.asarray(uv))
    gref = jax.grad(lambda x: jnp.sum(juvd.texture_lookup(x, jnp.asarray(uv)) * cot))(
        jnp.asarray(tex))
    x = t(tex).requires_grad_()
    got = tuvd.texture_lookup(x, t(uv))
    (g,) = torch.autograd.grad(torch.sum(got * t(cot)), x)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(gref), rtol=1e-6, atol=1e-6)
    # corners hit exact texels (align_corners)
    np.testing.assert_array_equal(got[-7:-3].detach().numpy(),
                                  tex[[0, 0, -1, -1], [0, -1, 0, -1]])


# ---------------------------------------------------------------------------
# (b) the decoder networks, flax weights carried across
# ---------------------------------------------------------------------------

def _flax_vars(net, x, seed):
    """Seeded flax variables of ``net`` for input ``x`` (shapes from
    ``eval_shape``: no init pass): lecun-scaled kernels, BatchNorm scale /
    bias near 1 / 0, running statistics away from their init."""
    shapes = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), x, train=False))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            return rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        if name == "scale":
            return 1 + 0.1 * rng.normal(size=s.shape)
        if name == "var":
            return 0.5 + rng.random(s.shape)
        if name == "optim_texture":
            return rng.uniform(-1, 1, size=s.shape)
        return 0.1 * rng.normal(size=s.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, s: jnp.asarray(draw(p, s), jnp.float32), shapes)


NETS = {
    # name: (flax net, port net, input shape)
    "UNet": (junet.UNet(11), lambda: tunet.UNet(11, 11, device="cpu"), (1, 32, 32, 11)),
    "UNetDecoder": (junet.UNetDecoder(11), lambda: tunet.UNetDecoder(512, 11, device="cpu"),
                    (1, 2, 2, 512)),
    "FeatureMap": (junet.FeatureMap(11, tex_size=32),
                   lambda: tunet.FeatureMap(11, tex_size=32, device="cpu"), (1, 32, 32, 11)),
}


@pytest.mark.parametrize("name", NETS)
def test_decoder_net_matches_flax(name):
    """Train-mode outputs within 1e-4 of their largest element; the updated
    batch_stats within 1e-5 (flax: r = 0.99 r + 0.01 b with the BIASED batch
    variance; an unbiased update moves the 2x2 bottleneck's variance by
    4/3 of its batch share); eval-mode outputs from those statistics; for
    the UNet, the parameter and input gradients within 1e-4 relative L2."""
    jnet, make, shape = NETS[name]
    rng = np.random.default_rng(3)
    x = rng.normal(size=shape).astype(np.float32)
    v = _flax_vars(jnet, jnp.asarray(x), seed=4)
    out_shape = jax.eval_shape(lambda: jnet.apply(v, jnp.asarray(x), train=False)).shape
    cot = rng.normal(size=out_shape).astype(np.float32)

    def jloss(params, x):
        out, upd = jnet.apply({**v, "params": params}, x, train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, upd)

    # one compile: the train-mode output, the updated statistics, gradients
    (_, (y, upd)), (gp, gx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        v["params"], jnp.asarray(x))
    net = convert.load_flax_net(make(), v)
    xt = t(x).requires_grad_()
    yt = net(xt, True)
    close(yt.detach().numpy(), y, 1e-4, "train-mode output")
    got = dict(net.named_buffers())
    stats = convert.flax_net_state({"batch_stats": upd.get("batch_stats", {})})
    assert sorted(stats) == sorted(got)
    for k, ref in stats.items():
        close(got[k].numpy(), ref, 1e-5, k)
    ye = jax.jit(lambda v, x: jnet.apply(v, x, train=False))(
        {**v, "batch_stats": upd.get("batch_stats", {})}, jnp.asarray(x))
    close(net(t(x), False).detach().numpy(), ye, 1e-4, "eval-mode output")
    if name != "UNet":
        return
    params = dict(net.named_parameters())
    g = torch.autograd.grad(torch.sum(yt * t(cot)), [xt, *params.values()])
    ref = convert.flax_net_state({"params": gp})
    assert sorted(ref) == sorted(params)
    for k, gk in zip(params, g[1:]):
        assert rel_l2(gk.numpy(), ref[k]) <= 1e-4, k
    assert rel_l2(g[0].numpy(), gx) <= 1e-4


def test_batch_norm_is_not_torch_running_update():
    """torch.nn.BatchNorm2d's running update (unbiased variance, its own
    momentum convention) differs from flax's by more than the tolerance
    above on a 2x2 input: the check that pins the port's own update."""
    rng = np.random.default_rng(5)
    x = t(rng.normal(size=(1, 8, 2, 2)))
    ours, theirs = tunet.FlaxBatchNorm(8), torch.nn.BatchNorm2d(8, eps=1e-5, momentum=0.01)
    ours(x, True)
    theirs.train()(x)
    var = x.var(dim=(0, 2, 3), unbiased=False)
    np.testing.assert_allclose(ours.running_var.numpy(), (0.99 + 0.01 * var).numpy(),
                               rtol=1e-6)
    err = np.abs(theirs.running_var.numpy() - ours.running_var.numpy()).max()
    assert err / np.abs(ours.running_var.numpy()).max() > 1e-3


# ---------------------------------------------------------------------------
# the decoder bundle in both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bundle():
    """tests/test_baking.py's decoder fixture (tex 8, capacity 96) on a
    perturbed avatar, in both packages (the port's init, held to JAX's in
    test_torch_model.py, carried into the JAX containers); the port's net
    carries JAX's feature map."""
    flame = tsynthetic_flame(n_verts=NV, n_shape=6, n_exp=4, seed=0, device="cpu")
    cfg = tfa.FateAvatarConfig(tex_size=8, capacity=96, img_height=RES, img_width=RES,
                               normal_offset=0.02)
    m, p, s = tfa.init_fateavatar(sphere_obj_mesh(NV), flame, cfg, device="cpu")
    p = convert.fateavatar_params(perturb(np_dict(p), seed=2), device="cpu")
    model, params, state = _jax_avatar(m, p, s)
    jdec, jnet, jvars = juvd.build_uv_decoder(
        model, params, state, decode_type="feature_map", bake_attribute=BAKE_ATTRS,
        fresh_samples=64, seed=0)
    tdec, tnet, _ = tuvd.build_uv_decoder(m, p, s, decode_type="feature_map",
                                         bake_attribute=BAKE_ATTRS, fresh_samples=64, seed=0)
    convert.load_flax_net(tnet, jvars)
    const = t(jvars["const"])
    return types.SimpleNamespace(jdec=jdec, jnet=jnet, jvars=jvars, tdec=tdec, tnet=tnet,
                                 const=const, model=model, params=params, state=state,
                                 m=m, p=p, s=s)


def test_build_uv_decoder_matches_jax(bundle):
    """The doubled binding exact; UV samples and the scaling statistics
    within 1e-6 relative; the decoder model carried across equals the
    port's own. The fixture's 64 fresh samples rasterise the same 8x8 chart
    as the avatar's 64, so every alive point has a duplicate: the sample
    radius is 0, which each package returns as float32 rounding of
    |q|^2 - 2 q.p + |p|^2 (JAX exactly 0, so sqrt(1e-20))."""
    j, d = bundle.jdec, bundle.tdec
    for f in ("face_index", "bary_coords", "alive"):
        np.testing.assert_array_equal(getattr(d, f).numpy(), np.asarray(getattr(j, f)), f)
    for f in ("uv_sample", "mean_scaling", "std_scaling", "max_scaling", "prior_rotation"):
        np.testing.assert_allclose(getattr(d, f).numpy(), np.asarray(getattr(j, f)),
                                   rtol=1e-6, atol=1e-7, err_msg=f)
    assert float(j.sample_radius) < 1e-5 and float(d.sample_radius) < 1e-5
    assert d.face_index.shape[0] == 96 + 64 and d.bake_attribute == BAKE_ATTRS
    carried = convert.uv_decoder_model(np_dict(j), bundle.m, device="cpu")
    for f in dataclasses.fields(d):
        a, b = getattr(carried, f.name), getattr(d, f.name)
        if isinstance(a, torch.Tensor) and f.name != "sample_radius":
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7,
                                       err_msg=f.name)


def test_sample_radius_matches_jax(bundle):
    """With 100 fresh samples (a 10x10 raster: no point of it on the 8x8
    one) the sample radius within 1e-5 relative: the KNN's squared
    distances |q|^2 - 2 q.p + |p|^2 of neighbours 0.04 apart cancel about
    2.5 digits of terms near 0.5, and the two packages' products round
    differently (measured 2e-6)."""
    b = bundle
    j, _, _ = juvd.build_uv_decoder(b.model, b.params, b.state, decode_type="feature_map",
                                    fresh_samples=100, seed=0)
    d, _, _ = tuvd.build_uv_decoder(b.m, b.p, b.s, decode_type="feature_map",
                                    fresh_samples=100, seed=0)
    assert float(j.sample_radius) > 1e-3
    np.testing.assert_allclose(float(d.sample_radius), float(j.sample_radius), rtol=1e-5)


def _camera(pkg):
    R, T = np.eye(3, dtype=np.float32), np.array([0.0, 0.0, 0.4], np.float32)
    if pkg == "jax":
        return jmake_camera(R, T, 0.8, 0.8, RES, RES)
    return make_camera(R, T, 0.8, 0.8, RES, RES, device="cpu")


def _codes(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=4) * 0.3).astype(np.float32), \
        (rng.normal(size=15) * 0.05).astype(np.float32)


PAIRS = ("decode_color", "decode_opacity", "decode_scaling", "decode_rotation",
         "decode_offset", "prior_features_dc", "prior_opacity", "prior_scaling",
         "prior_rotation", "prior_offset", "prior_alive")


@pytest.mark.parametrize("train", [True, False])
def test_uv_decoder_forward_matches_jax(bundle, train):
    """Images at atol 5e-5; the decode / prior pairs within 1e-6."""
    b = bundle
    expr, pose = _codes(7)
    ref, _ = jax.jit(lambda v, e, p, cam: juvd.uv_decoder_forward(
        b.jdec, b.jnet, v, e, p, cam, render_cfg=JRCFG, train=train))(
            b.jvars, expr, pose, _camera("jax"))
    with torch.no_grad():
        out = tuvd.uv_decoder_forward(b.tdec, b.tnet, b.const, t(expr), t(pose),
                                      _camera("torch"), render_cfg=RCFG, train=train)
    assert int(ref["overflow"]) == 0 and int(out["overflow"]) == 0
    np.testing.assert_allclose(out["rgb_image"].numpy(), np.asarray(ref["rgb_image"]),
                               atol=5e-5)
    assert np.abs(np.asarray(ref["rgb_image"]) - 0.5).max() > 0.1   # not flat
    for k in PAIRS:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    # exp and atan2 of the decoded values round differently in the two
    for k in ("scale", "raw_rot"):
        close(out[k].numpy(), ref[k], 1e-5, k)
    for k in tuvd.TEXTURE_CHANNELS:
        np.testing.assert_allclose(out["act_texture_dict"][k].detach().numpy(),
                                   np.asarray(ref["act_texture_dict"][k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("activated", [True, False])
def test_render_from_texture_dict_matches_jax(bundle, activated):
    b = bundle
    expr, pose = _codes(8)
    raw, act, _ = juvd.decode_textures(b.jdec, b.jnet, b.jvars, train=False)
    tex = act if activated else {**raw, "color": act["color"]}
    tex = {k: np.asarray(v) for k, v in tex.items()}
    ref = jax.jit(lambda tex, e, p, cam: juvd.render_from_texture_dict(
        b.jdec, tex, e, p, cam, render_cfg=JRCFG, activated=activated))(
            tex, expr, pose, _camera("jax"))
    got = tuvd.render_from_texture_dict(b.tdec, {k: t(v) for k, v in tex.items()}, t(expr),
                                        t(pose), _camera("torch"), render_cfg=RCFG,
                                        activated=activated)
    np.testing.assert_allclose(got["rgb_image"].numpy(), np.asarray(ref["rgb_image"]),
                               atol=5e-5)


def test_export_avatar_params_matches_jax(bundle):
    b = bundle
    jp, js = juvd.export_avatar_params(b.jdec, b.jnet, b.jvars)
    tp, ts = tuvd.export_avatar_params(b.tdec, b.tnet, b.const)
    for f, v in np_dict(jp).items():
        np.testing.assert_allclose(getattr(tp, f).numpy(), v, rtol=1e-5, atol=1e-6, err_msg=f)
    for f, v in np_dict(js).items():
        np.testing.assert_allclose(getattr(ts, f).numpy(), v, rtol=1e-6, atol=0, err_msg=f)


# ---------------------------------------------------------------------------
# (e) the bake step
# ---------------------------------------------------------------------------

def _loss_cfg():
    return dict(rgb_weight=1.0, scale_weight=0.1, scale_threshold=9.0)


def _bakers(b, ds, workspace=None):
    """A JAX baker and a port baker from the same state."""
    jb = jbaker.UVBaker(b.jdec, b.jnet, jax.tree.map(jnp.array, b.jvars),
                        jl.FateAvatarLoss(jl.FateAvatarLossConfig(**_loss_cfg())), ds,
                        workspace=None if workspace is None else workspace + "/jax",
                        render_cfg=JRCFG, **REG)
    net = convert.load_flax_net(tunet.FeatureMap(11, device="cpu"), b.jvars)
    tb = tbaker.UVBaker(b.tdec, net, b.const,
                        tl.FateAvatarLoss(tl.FateAvatarLossConfig(**_loss_cfg())), ds,
                        workspace=None if workspace is None else workspace + "/torch",
                        render_cfg=RCFG, **REG)
    return jb, tb


@pytest.fixture(scope="module")
def bake_ds():
    return jdatasets.SyntheticDataset(num_frames=3, img_res=(RES, RES), n_exp=4)


def test_bake_step_matches_jax(bundle, bake_ds):
    """One step from the same state (feature_map, reg_weight 0.1 on colour
    and opacity), JAX's through its jitted step with an optimizer that
    returns the gradients, then its Adam: the loss and reg loss within 1e-5
    relative, the
    gradients within 1e-4 of each field's largest element, the Adam update
    within 1e-2 * lr on all but 0.3% of the elements (Adam divides each
    gradient by its own magnitude, so noise-level gradients move by up to
    lr)."""
    jb, tb = _bakers(bundle, bake_ds)
    sample = bake_ds.sample(1)
    jframe = jb._prep(sample)
    trainable = jb._trainable(jb.net_vars)
    # the JAX step with an optimizer whose state is the gradient itself
    grab = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    jg = jbaker.UVBaker(bundle.jdec, bundle.jnet, jb.net_vars, jb.loss_fn, bake_ds,
                        render_cfg=JRCFG, **REG)
    jg.opt = grab
    jg._step = jg._build_step()
    _, _, jgrads, jlosses = jg._step(trainable, jb.net_vars["batch_stats"],
                                     grab.init(trainable), *jframe)
    # the JAX baker's own Adam on those gradients
    updates, _ = jb.opt.update(jgrads, jb.opt_state, trainable)
    new = optax.apply_updates(trainable, updates)

    frame = tb._prep(tdatasets.SyntheticDataset(num_frames=3, img_res=(RES, RES),
                                                n_exp=4).sample(1))
    before = [p.detach().clone() for p in tb.trainables]
    grads, losses, out = tb.grads(frame)
    for k in ("loss", "reg_loss"):
        np.testing.assert_allclose(float(losses[k].detach()), float(jlosses[k]), rtol=1e-5,
                                   err_msg=k)
    assert int(out["overflow"]) == 0
    jflat = [jgrads["params"]["optim_texture"], jgrads["const"]]
    for g, ref, what in zip(grads, jflat, ("texture", "const")):
        if np.abs(np.asarray(ref)).max() == 0:
            assert float(g.abs().max()) == 0, what
        else:
            close(g.numpy(), ref, 1e-4, what)
    aux = tb.step(frame).numpy()
    np.testing.assert_allclose(aux[:2], [float(jlosses["loss"]), float(jlosses["reg_loss"])],
                               rtol=1e-5)
    assert int(tb.count) == 1
    jnew = [new["params"]["optim_texture"], new["const"]]
    for p, p0, ref, r0 in zip(tb.trainables, before, jnew,
                              [trainable["params"]["optim_texture"], trainable["const"]]):
        d = (p.detach() - p0).numpy() - (np.asarray(ref) - np.asarray(r0))
        assert np.mean(np.abs(d) > 1e-2 * tb.lr) <= 3e-3


def test_bake_epoch_with_pseudo_set_matches_jax(bundle, bake_ds, tmp_path):
    """An epoch with a pseudo SyntheticDataset: each real frame followed by
    a pseudo frame drawn with default_rng(epoch), the same indices as JAX;
    the epoch's mean loss within 1e-3 relative of JAX's logged one."""
    jb, tb = _bakers(bundle, bake_ds)
    drawn = {"jax": [], "torch": []}

    def recording(ds, key):
        orig = ds.sample

        def sample(i):
            drawn[key].append(i)
            return orig(i)
        ds.sample = sample
        return ds

    jpseudo = recording(jdatasets.SyntheticDataset(num_frames=5, img_res=(RES, RES), n_exp=4,
                                                   seed=3), "jax")
    tpseudo = recording(tdatasets.SyntheticDataset(num_frames=5, img_res=(RES, RES), n_exp=4,
                                                   seed=3), "torch")
    logs = []
    jb.logger.log = logs.append
    jb.epoch = tb.epoch = 2
    jb.bake_epoch(jpseudo)
    tb.bake_epoch(tpseudo)
    assert drawn["jax"] == drawn["torch"] and len(drawn["jax"]) == len(bake_ds)
    assert tb.last_epoch_stats["steps"] == 2 * len(bake_ds) and tb.global_step == 6
    assert tb.last_epoch_stats["overflow"] == 0
    jmean = float(logs[-1].split("loss=")[1].split()[0])
    np.testing.assert_allclose(tb.last_epoch_stats["loss"], jmean, rtol=1e-3)
    assert all(np.isfinite(tb.epoch_losses))


# ---------------------------------------------------------------------------
# (f) files, (g) the editor
# ---------------------------------------------------------------------------

def test_texture_dump_and_baked_npz_cross_read(bundle, bake_ds, tmp_path):
    """texture_dump: the same keys, shapes and [H, W, C] layout as JAX's;
    each package's baked.npz read by the other's load_pytree into its own
    templates equals the writer's export."""
    jb, tb = _bakers(bundle, bake_ds, str(tmp_path))
    jb.epoch = tb.epoch = 1
    jpath, tpath = jb.texture_dump(), tb.texture_dump()
    with np.load(jpath) as jd, np.load(tpath) as td:
        assert sorted(jd.files) == sorted(td.files) == sorted(tuvd.TEXTURE_CHANNELS)
        for k in jd.files:
            assert jd[k].shape == td[k].shape == (512, 512, tuvd.TEXTURE_CHANNELS[k])
            np.testing.assert_allclose(td[k], jd[k], rtol=1e-6, atol=1e-6, err_msg=k)
    png = read_png(str(tmp_path / "torch" / "bake_snapshots" / "texture_epoch1.png"))
    assert png.shape == (512, 3 * 512, 3)

    jp, js = jb.export_avatar()
    tp, ts = tb.export_avatar()
    # the port's file into JAX templates
    back = jckpt.load_pytree(str(tmp_path / "torch" / "checkpoints_baked" / "baked.npz"),
                             {"params": jp, "state": js})
    for part, obj in (("params", tp), ("state", ts)):
        for f in dataclasses.fields(obj):
            np.testing.assert_array_equal(np.asarray(getattr(back[part], f.name)),
                                          getattr(obj, f.name).numpy(), err_msg=f.name)
    # JAX's file into the port's templates
    back = tckpt.load_pytree(str(tmp_path / "jax" / "checkpoints_baked" / "baked.npz"),
                             {"params": tp, "state": ts})
    for part, obj in (("params", jp), ("state", js)):
        for f, v in np_dict(obj).items():
            got = getattr(back[part], f)
            assert got.dtype == getattr(tp if part == "params" else ts, f).dtype
            np.testing.assert_array_equal(got.numpy(), v.astype(got.numpy().dtype), err_msg=f)


def _editors(b):
    jraw, _, _ = juvd.decode_textures(b.jdec, b.jnet, b.jvars, train=False)
    je = jbaker.UVEditor(b.jdec, jraw, render_cfg=JRCFG)
    te = tbaker.UVEditor(b.tdec, {k: t(v) for k, v in jraw.items()}, render_cfg=RCFG)
    # the same activated colour in both (tanh rounds differently in the two)
    te.act_textures["color"] = t(je.act_textures["color"])
    return je, te


def test_sticker_editing_matches_jax(bundle):
    """The composited colour texture bit-equal to JAX's; the edited render
    at atol 5e-5 and different from the unedited one."""
    je, te = _editors(bundle)
    expr, pose = _codes(9)
    base = te.render(expr, pose, _camera("torch")).numpy()
    rng = np.random.default_rng(6)
    sticker = rng.random((64, 64, 3)).astype(np.float32)
    mask = rng.random((64, 64)).astype(np.float32)
    je.sticker_editing(sticker, mask, position=(100, 100), scale=4.0)
    te.sticker_editing(sticker, mask, position=(100, 100), scale=4.0)
    np.testing.assert_array_equal(te.act_textures["color"].numpy(),
                                  np.asarray(je.act_textures["color"]))
    ref = np.asarray(je.render(jnp.asarray(expr), jnp.asarray(pose), _camera("jax")))
    got = te.render(expr, pose, _camera("torch")).numpy()
    np.testing.assert_allclose(got, ref, atol=5e-5)
    assert np.abs(got - base).max() > 1e-3


def test_style_transfer_glue_matches_jax(bundle, monkeypatch):
    """The OpenCV glue of style_transfer with a stub ``cv2`` (a fixed
    per-channel map standing in for the network): the same colour texture
    in both packages."""
    class Net:
        def setInput(self, blob):
            self.blob = blob

        def forward(self):
            return np.tanh(self.blob / 64.0) * 80.0 + self.blob * 0.5

    def blob_from_image(img, scale, size, mean, swapRB, crop):
        assert size == img.shape[1::-1] and not swapRB and not crop
        return ((img.astype(np.float32) - np.asarray(mean, np.float32)) * scale
                ).transpose(2, 0, 1)[None]

    cv2 = types.SimpleNamespace(dnn=types.SimpleNamespace(
        readNetFromTorch=lambda path: Net(), blobFromImage=blob_from_image))
    monkeypatch.setitem(sys.modules, "cv2", cv2)
    je, te = _editors(bundle)
    je.style_transfer("style.t7")
    te.style_transfer("style.t7")
    ref = np.asarray(je.act_textures["color"])
    np.testing.assert_allclose(te.act_textures["color"].numpy(), ref, rtol=1e-6, atol=1e-6)
    assert np.abs(ref - np.asarray(_editors(bundle)[0].act_textures["color"])).max() > 0.1


# ---------------------------------------------------------------------------
# (h) both CLIs, (i) UNet bake steps
# ---------------------------------------------------------------------------

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
    for mode, n in (("train", 2), ("test", 2)):
        imgs = [(rng.random((RES, RES, 4)) * 255).astype(np.uint8) for _ in range(n)]
        write_imavatar(root, mode, imgs, orbit(n), rng.normal(size=(n, 50)) * 0.05,
                       rng.normal(size=(n, 15)) * 0.05, rng.normal(size=100) * 0.1, 0.8,
                       write_png)
    return root


def test_cli_bake_and_edit(tmp_path, monkeypatch):
    """train_mono_avatar (one epoch), then train_neural_baking
    (--decode_type feature_map, --epochs 1) and avatar_edit_baked with a
    sticker and mask written by the port's PNG writer, all with --device
    cpu on a 32x32 IMAvatar layout: the texture .npz / .png, baked.npz and
    media/edit_sticker.gif (an mp4 where ffmpeg is installed). The CLIs
    double the avatar with 256^2 fresh samples; here 256, so that the CPU
    renders hundreds of splats, not 65,000."""
    build = tuvd.build_uv_decoder
    monkeypatch.setattr(tuvd, "build_uv_decoder",
                        lambda *a, **k: build(*a, **{**k, "fresh_samples": 256}))
    ws = str(tmp_path)
    root = _cli_assets(ws)
    run = os.path.join(ws, "run")
    config = ["--config", os.path.join(REPO, "configs", "fateavatar.yaml")]
    overrides = [
        f"assets.flame_model_path={ws}/flame.pkl", f"assets.template_mesh_path={ws}/head.obj",
        f"dataset.img_res=[{RES},{RES}]", "model.tex_size=8", "training.max_points_num=128",
        "loss.vgg_weight=0", "render.max_tiles_per_gaussian=16", f"dataset.root_path={root}",
    ]
    train_mono_avatar.main([*config, "--device", "cpu", "--epochs", "1", f"workspace={run}",
                            "training.epochs.finetune=1", *overrides])
    baker = train_neural_baking.main([
        *config, "--device", "cpu", "--workspace", run, "--decode_type", "feature_map",
        "--bake_attribute", "color", "opacity", "--reg_weight", "0.1", "--epochs", "1",
        *overrides])
    assert baker.epoch == 1 and baker.last_epoch_stats["overflow"] == 0
    assert all(np.isfinite(baker.epoch_losses)) and len(baker.epoch_losses) == 2
    assert baker.model.face_index.shape[0] == 128 + 256
    for rel in ("textures/texture_epoch1.npz", "bake_snapshots/texture_epoch1.png",
                "checkpoints_baked/baked.npz"):
        assert os.path.exists(os.path.join(run, rel)), rel

    rng = np.random.default_rng(1)
    write_png(os.path.join(ws, "sticker.png"), (rng.random((24, 24, 3)) * 255).astype(np.uint8))
    write_png(os.path.join(ws, "mask.png"),
              np.repeat((rng.random((24, 24, 1)) * 255).astype(np.uint8), 3, axis=-1))
    before = {k: v.clone() for k, v in baker.textures()[1].items()}
    editor = avatar_edit_baked.main([
        *config, "--device", "cpu", "--workspace", run, "--sticker", f"{ws}/sticker.png",
        "--sticker_mask", f"{ws}/mask.png", "--sticker_pos", "300", "200",
        "--max_frames", "8", *overrides])
    media = os.path.join(run, "media")
    assert any(os.path.exists(os.path.join(media, "edit_sticker" + e)) for e in (".mp4", ".gif"))
    diff = (editor.act_textures["color"] - before["color"]).abs().sum(-1).numpy()
    ys, xs = np.nonzero(diff)
    assert ys.size and ys.min() >= 300 and ys.max() < 324 and xs.min() >= 200 and xs.max() < 224


def test_unet_bake_steps_lower_the_loss(bundle):
    """Port only: UNet bake steps from a small hand-built const (the CLI's
    512^2 const is fixed and too slow for the CPU) over one frame, with
    the step and its Adam as the card runs them, lower the loss."""
    b = bundle
    gen = torch.Generator().manual_seed(0)
    net = tunet.UNet(11, 11, device="cpu", generator=gen)
    const = torch.rand((1, 32, 32, 11), generator=gen) * 2 - 1
    dec = dataclasses.replace(b.tdec, decode_type="UNet")
    tb = tbaker.UVBaker(dec, net, const,
                        tl.FateAvatarLoss(tl.FateAvatarLossConfig(rgb_weight=1.0)),
                        tdatasets.SyntheticDataset(num_frames=1, img_res=(RES, RES), n_exp=4),
                        render_cfg=RCFG, lr=3e-3)
    frame = tb._prep(tb.dataset.sample(0))
    stats0 = [s.clone() for s in tb.stats]
    losses = [float(tb.step(frame)[0]) for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert int(tb.count) == 5
    assert any(not torch.equal(a, s) for a, s in zip(stats0, tb.stats))   # BatchNorm moved
