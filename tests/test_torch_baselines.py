"""The four baseline families of the PyTorch port against the JAX package, on
the CPU: each family's forward (image and model outputs, parameters carried
across by ``convert``), its loss terms and one training step (losses,
gradients, the densify accumulators); GaussianAvatars' densify / prune with
injected draws, the triangle walk, MonoGaussianAvatar's prune / upsample
with injected draws, the FLAME point functions, ``render``'s
``override_color``, the ties of the argmins and the stable argsort, the
registry, every family through the Trainer with an adapter, the baseline
CLI, and ``is_flashavatar``'s mouth masks.

Shapes of ``tests/test_baselines.py``: RES 32, a synthetic FLAME at 96
vertices; JAX renders through its plain blend (``impl="xla"``), the port
through the instance route's plain blends (the CPU's)."""

import dataclasses
import functools
import os
from concurrent.futures import ThreadPoolExecutor

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_tracking import _cli_assets
from torch_single_thread import one_torch_thread  # noqa: F401 (autouse fixture)
from fateavatar_tpu.flame import flame as jflame_mod
from fateavatar_tpu.flame import synthetic_flame
from fateavatar_tpu.models.baselines import flashavatar as jfa
from fateavatar_tpu.models.baselines import gaussianavatars as jga
from fateavatar_tpu.models.baselines import monogaussianavatar as jma
from fateavatar_tpu.models.baselines import splattingavatar as jsa
from fateavatar_tpu.ops.camera import make_camera as jmake_camera
from fateavatar_tpu.render.render import RenderConfig as JRenderConfig
from fateavatar_tpu.train import baseline_steps as jbs
from fateavatar_tpu.train import datasets as jdatasets
from fateavatar_tpu.train import losses as jl
from fateavatar_tpu.train import registry as jregistry
from fateavatar_tpu.train.optim import apply_updates as japply_updates
from fateavatar_tpu.train.step import Frame as JFrame
from fateavatar_tpu.utils.obj_io import sphere_obj_mesh

from fateavatar_tpu_torch import convert
from fateavatar_tpu_torch.cli import train_baseline
from fateavatar_tpu_torch.flame import flame as tflame_mod
from fateavatar_tpu_torch.models.baselines import flashavatar as tfa
from fateavatar_tpu_torch.models.baselines import gaussianavatars as tga
from fateavatar_tpu_torch.models.baselines import monogaussianavatar as tma
from fateavatar_tpu_torch.models.baselines import splattingavatar as tsa
from fateavatar_tpu_torch.ops.camera import make_camera
from fateavatar_tpu_torch.parallel.data_parallel import stack_frames
from fateavatar_tpu_torch.render.render import RenderConfig, render
from fateavatar_tpu_torch.render.splats import Gaussians
from fateavatar_tpu_torch.train import baseline_steps as tbs
from fateavatar_tpu_torch.train import datasets as tdatasets
from fateavatar_tpu_torch.train import losses as tl
from fateavatar_tpu_torch.train import registry as tregistry
from fateavatar_tpu_torch.train.adapters import make_family_adapter
from fateavatar_tpu_torch.train.step import Frame
from fateavatar_tpu_torch.train.trainer import Trainer
from fateavatar_tpu_torch.utils.png import write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, NV = 32, 96
CPU = "cpu"
# the JAX side's plain blend; K above every tile's count here
JRC = JRenderConfig(impl="xla", max_per_tile=512, chunk=32)
TRC = RenderConfig()
FAMILIES = ("gaussianavatars", "flashavatar", "splattingavatar", "monogaussianavatar")
# small models of each family (the registry's keys)
MODEL_CFG = dict(img_height=RES, img_width=RES, tex_size=8, capacity=256, num_samples=128,
                 n_init_points=64, max_points=256, sh_degree=1, cam_scale=1.0,
                 dataset_type="synthetic")
NO_MAINT = dict(densify_interval=10**9, densify_from_iter=10**9,
                opacity_reset_interval=10**9, triangle_walk_interval=10**9)


def t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


def to_np(obj):
    """A JAX dataclass / dict tree as nested dicts of numpy arrays (python
    scalars and None kept)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: to_np(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: to_np(v) for k, v in obj.items()}
    if obj is None or isinstance(obj, (bool, int, float, str, tuple)):
        return obj
    return np.asarray(obj)


def flat(tree, prefix=""):
    """{dotted name: numpy} of a params dataclass / dict tree (a torch
    params' network dicts are flat already)."""
    out = {}
    if dataclasses.is_dataclass(tree):
        tree = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
    for k, v in tree.items():
        if isinstance(v, dict) or dataclasses.is_dataclass(v):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)
    return out


def flax_names(tree: dict) -> dict:
    """A flat flax param dict's names and layouts as the port's:
    ``deformer.Dense_3.kernel`` -> ``deformer.dense.3.weight`` (transposed)."""
    out = {}
    for k, v in tree.items():
        parts = k.split(".")
        if len(parts) == 3 and parts[1].startswith("Dense_"):
            leaf = {"kernel": "weight", "bias": "bias"}[parts[2]]
            k = f"{parts[0]}.dense.{parts[1].split('_')[1]}.{leaf}"
            v = v.T if leaf == "weight" else v
        out[k] = v
    return out


@functools.lru_cache(maxsize=None)
def jframe(seed=0):
    rng = np.random.default_rng(seed)
    return JFrame(
        expression=jnp.asarray(rng.normal(size=4) * 0.2, jnp.float32),
        flame_pose=jnp.asarray(rng.normal(size=15) * 0.03, jnp.float32),
        camera=jmake_camera(np.eye(3), np.array([0.0, 0.0, 0.4]), 0.8, 0.8, RES, RES),
        rgb=jnp.asarray(rng.random((RES, RES, 3)), jnp.float32),
        bg_color=jnp.ones(3))


def tframe(f: JFrame) -> Frame:
    return Frame(expression=t(f.expression), flame_pose=t(f.flame_pose),
                 camera=make_camera(np.eye(3), [0.0, 0.0, 0.4], 0.8, 0.8, RES, RES, device=CPU),
                 rgb=t(f.rgb), bg_color=torch.ones(3))


@pytest.fixture(scope="module")
def flames():
    jf = synthetic_flame(n_verts=NV, n_shape=6, n_exp=4, seed=0)
    return jf, convert.flame_model(to_np(jf), device=CPU)


def _perturb(family, params):
    """Seeded perturbations so the image is neither flat nor background,
    every network head (the zero-initialised ones too) carries weight, and
    the splats sit off their bind points."""
    rng = np.random.default_rng(5)

    def jitter(x, s):
        return jnp.asarray(np.asarray(x) + rng.normal(size=np.shape(x)) * s, jnp.float32)

    ch = {"features_dc": 0.8, "opacity": 1.0, "scaling": 0.2, "rotation": 0.2}
    if family == "gaussianavatars":
        ch["xyz"] = 0.3
    if family == "splattingavatar":
        ch["uvd"] = 0.02
    if family == "monogaussianavatar":
        return params.replace(**{k: jax.tree.map(lambda x: jitter(x, 0.05), getattr(params, k))
                                 for k in ("deformer", "gaussian")})
    if family == "flashavatar":
        ch["deformer"] = 0.02
        params = params.replace(deformer=jax.tree.map(lambda x: jitter(x, 0.02), params.deformer))
        del ch["deformer"]
    return params.replace(**{k: jitter(getattr(params, k), s) for k, s in ch.items()})


def _jax_forward(family, bundle, params, state, f, probe=None):
    model = bundle[0]
    args = (f.expression, f.flame_pose, f.camera)
    kw = dict(bg_color=f.bg_color, render_cfg=JRC, means2d_probe=probe)
    if family == "gaussianavatars":
        return jga.ga_forward(model, params, state, *args, **kw)
    if family == "flashavatar":
        return jfa.flash_forward(model, params, bundle[2], *args, **kw)
    if family == "splattingavatar":
        return jsa.splat_forward(model, params, state, *args, **kw)
    return jma.mono_forward(model, params, state, bundle[3], *args, **kw)


def _port_nets(family, jbundle):
    if family == "flashavatar":
        return tfa.DeformMLP(jbundle[0].cano_embedded.shape[-1] + 4 + 9)
    if family == "monogaussianavatar":
        return {"geometry": tma.GeometryNetwork(), "deformer": tma.ForwardDeformer(4),
                "gaussian": tma.GaussianNetwork(), "rendering": tma.RenderingNetwork()}
    return None


class Pair:
    """One family on both sides: JAX's bundle (as built, and perturbed), its
    train state after one step (nonzero Adam moments), the port's converted
    copy, and one more step on each side with JAX's forward, losses and
    gradients at that state."""


def _jax_build(entry, jf):
    """JAX's ``entry.build_model`` under one jit (run eagerly, each of its
    ops compiles on its own); the networks, flax modules rather than
    arrays, are kept from the trace."""
    modules = {}

    def nets(x):
        leaves = jax.tree.leaves(x, is_leaf=lambda y: isinstance(y, flax_nn.Module))
        return bool(leaves) and all(isinstance(y, flax_nn.Module) for y in leaves)

    def arrays():
        built = entry.build_model(sphere_obj_mesh(NV), jf, MODEL_CFG)
        modules.update({i: x for i, x in enumerate(built) if nets(x)})
        return tuple(None if i in modules else x for i, x in enumerate(built))

    # the template and FLAME enter as constants: XLA would fold FlashAvatar's
    # KNN over them for many seconds
    out = jax.jit(arrays).lower().compile(
        {"xla_disable_hlo_passes": "constant_folding"})()
    return tuple(modules.get(i, x) for i, x in enumerate(out))


def _make_pair(family, flames):
    """JAX's steps here are the body of its baseline step with the
    maintenance off (densify, opacity reset and the walk are held apart
    below), eagerly around one jitted gradient function, so that each
    family compiles once."""
    jf, tf = flames
    entry = jregistry.get(family)
    built = _jax_build(entry, jf)
    jb = (built[0], _perturb(family, built[1]), *built[2:])
    jloss = entry.build_loss({}, jb)
    jopt = entry.build_optimizer({"lr": 1e-3})
    ga = family == "gaussianavatars"

    def loss_of(p, probe, state, f):
        out = _jax_forward(family, jb, p, state, f, probe if ga else None)
        losses = jloss(out, {"rgb": f.rgb})
        return losses["loss"], (out, losses)

    cap = jb[1].xyz.shape[0] if ga else 1
    probe0 = jnp.zeros((2, cap), jnp.float32)

    @jax.jit
    def jax_step(ts, f):
        (g, gprobe), (out, losses) = jax.grad(loss_of, argnums=(0, 1), has_aux=True)(
            ts.params, probe0, ts.state, f)
        state = ts.state
        if ga:     # baseline_steps.py:159-171
            gnorm = jnp.linalg.norm(gprobe, axis=0) * (2.0 / f.camera.width)
            vis = out["visibility_filter"] & state.alive
            state = state.replace(
                xyz_gradient_accum=state.xyz_gradient_accum + jnp.where(vis, gnorm, 0.0),
                denom=state.denom + jnp.where(vis, 1.0, 0.0),
                max_radii2d=jnp.where(vis, jnp.maximum(state.max_radii2d,
                                                       out["radii"].astype(jnp.float32)),
                                      state.max_radii2d))
        if family == "monogaussianavatar":     # :386
            state = state.replace(visible=state.visible | out["visible_now"])
        updates, opt_state = jopt.update(g, ts.opt_state, ts.params)
        ts = ts.replace(params=japply_updates(ts.params, updates), state=state,
                        opt_state=opt_state, step=ts.step + 1)
        return ts, (g, gprobe, out, losses)

    jstate = jb[2] if family != "flashavatar" else None
    f1 = jframe(1)
    init = jbs.BaselineTrainState(params=jb[1], state=jstate, opt_state=jax.jit(jopt.init)(jb[1]),
                                  step=jnp.int32(0), key=jax.random.PRNGKey(0))
    ts0, _ = jax_step(init, jframe(0))
    ts1, (g, gprobe, out, losses) = jax_step(ts0, f1)

    # JAX's own (jitted) step on the batched [2, ...] frame, from ts0
    batched = jax.tree.map(lambda *x: jnp.stack(x), jframe(0), f1)
    jfull = entry.build_step(jb, jloss, jopt, JRC, NO_MAINT)
    tsb, auxb = jfull(jax.tree.map(jnp.copy, ts0), batched)

    p = Pair()
    p.family, p.built, p.jb = family, built, jb
    p.tsb, p.auxb = to_np(tsb), jax.tree.map(np.asarray, auxb)
    p.ts0, p.ts1 = to_np(ts0), to_np(ts1)
    p.out, p.losses = jax.tree.map(np.asarray, out), jax.tree.map(np.asarray, losses)
    p.grads, p.gprobe = to_np(g), np.asarray(gprobe)

    # the port: the same model and state through convert
    tentry = tregistry.get(family)
    tmodel = convert.baseline_model(family, to_np(jb[0]), device=CPU)
    nets = _port_nets(family, jb)
    tb = (tmodel, None, nets) if family == "flashavatar" else (tmodel, None, None, nets)
    p.tloss = tentry.build_loss({}, tb)
    p.topt = tentry.build_optimizer({"lr": 1e-3})
    p.tstep = tentry.build_step(tb, p.tloss, p.topt, TRC, NO_MAINT)
    p.tts0 = convert.baseline_train_state(family, p.ts0, device=CPU)
    p.tframe = tframe(f1)
    p.tgrads, p.tprobe, p.tout, p.tlosses = p.tstep.grads(p.tts0, p.tframe)
    p.tts1, p.taux = p.tstep(p.tts0, p.tframe)
    p.ttsb, p.tauxb = p.tstep(p.tts0, stack_frames([tframe(jframe(0)), p.tframe]))
    return p


@pytest.fixture(scope="module")
def pairs(flames, one_torch_thread):
    """The four families' pairs, built in four threads: JAX's compiles run
    outside the GIL, so one family's compile overlaps another's tracing."""
    with ThreadPoolExecutor(len(FAMILIES)) as pool:
        return dict(zip(FAMILIES, pool.map(lambda f: _make_pair(f, flames), FAMILIES)))


@pytest.fixture(params=FAMILIES)
def pair(request, pairs):
    return pairs[request.param]


# the model output fields held against JAX's, by family (the rest are
# either the image or the inputs themselves)
OUT_FIELDS = {
    "gaussianavatars": ("scale", "xyz", "alive", "radii", "visibility_filter"),
    "flashavatar": ("radii", "visibility_filter"),
    "splattingavatar": ("scale", "alive", "radii", "visibility_filter"),
    "monogaussianavatar": ("radii", "visibility_filter", "visible_now", "index_batch",
                           "shapedirs", "posedirs", "lbs_weights", "alive"),
}


def test_forward_matches_jax(pair):
    """The forward at JAX's state after one step: the image within 5e-5
    (the blends sum in another order), radii, visibility, alive masks and
    Mono's nearest vertices exact, the other fields within 1e-5 relative to
    their largest element; no overflow; the image is neither flat nor the
    background."""
    img, ref = pair.tout["rgb_image"].detach().numpy(), pair.out["rgb_image"]
    np.testing.assert_allclose(img, ref, atol=5e-5)
    assert ref.std() > 0.01 and (np.abs(ref - 1.0) > 0.05).mean() > 0.05
    assert int(pair.tout["overflow"]) == int(pair.out["overflow"]) == 0
    for k in OUT_FIELDS[pair.family]:
        got, want = pair.tout[k].detach().numpy(), pair.out[k]
        if want.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), err_msg=k)


def _tensors(d):
    return {k: (t(v, torch.bool) if np.asarray(v).dtype == bool else
                t(v, torch.int64) if np.asarray(v).dtype.kind in "iu" else t(v))
            for k, v in d.items()}


def test_loss_terms_match_jax(pair, flames):
    """Each loss term of both packages on the same model output (JAX's, as
    numpy) within 2e-6 relative (float32 sums in another order); for
    MonoGaussianAvatar also with the shapedirs term weighted by an
    expression variance and with an INSTA dataset type (the registry builds
    neither)."""
    ref = pair.losses
    gt = {"rgb": t(np.asarray(jframe(1).rgb))}
    got = pair.tloss(_tensors(pair.out), gt)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=2e-6, atol=1e-9, err_msg=k)
    assert float(ref["loss"]) > 0
    if pair.family == "monogaussianavatar":
        var = np.random.default_rng(4).random((1, 4)).astype(np.float32) + 0.1
        for kind in ("insta", "synthetic"):
            j = jl.MonoGaussianAvatarLoss(jl.MonoGaussianAvatarLossConfig(dataset_type=kind),
                                          flames[0], var_expression=var)
            tt = tl.MonoGaussianAvatarLoss(tl.MonoGaussianAvatarLossConfig(dataset_type=kind),
                                           flames[1], var_expression=var)
            r = j({k: jnp.asarray(v) for k, v in pair.out.items()},
                  {"rgb": jnp.asarray(jframe(1).rgb)})
            g = tt(_tensors(pair.out), gt)
            np.testing.assert_allclose(float(g["shapedirs_loss"]), float(r["shapedirs_loss"]),
                                       rtol=2e-6, err_msg=kind)
            np.testing.assert_allclose(float(g["loss"]), float(r["loss"]), rtol=2e-6)


def test_step_matches_jax(pair):
    """One step of each package from the same train state (JAX's after one
    step, converted): losses within 2e-6 relative; every gradient (the
    networks' weights and GA's probe included) within 8e-5 of its field's
    largest element; the densify accumulators within that of their
    largest, max radii exact; Mono's visibility exact; parameters after Adam
    within Adam's bound everywhere and within 1e-2 lr on all but 1% of the
    elements (a gradient at its field's float32 noise level gets a noise
    update; tests/test_torch_train.py).

    Both gradients are NaN at the same elements of SplattingAvatar's dead
    capacity rows (their zero barycentrics make a zero quaternion and a zero
    normal, where the normalizations' gradients are 0/0); those rows never
    render. The NaNs are held to coincide and the rest is compared."""
    for k, v in pair.losses.items():
        np.testing.assert_allclose(float(pair.taux[k]), float(v), rtol=2e-6, atol=1e-9,
                                   err_msg=k)
    ref = flax_names(flat(pair.grads))
    got = flat(pair.tgrads)
    assert sorted(got) == sorted(ref)
    dead = ~pair.ts0["state"]["alive"] if pair.family == "splattingavatar" else None
    for k, want in ref.items():
        g = got[k]
        np.testing.assert_array_equal(np.isnan(g), np.isnan(want), err_msg=k)
        if np.isnan(want).any():
            assert dead is not None and not np.isnan(want[~dead]).any(), k
        ok = ~np.isnan(want)
        scale = np.abs(want[ok]).max()
        np.testing.assert_allclose(g[ok], want[ok], atol=8e-5 * scale + 1e-12, err_msg=k)
    # every field moves the loss but the SH rest coefficients (degree 0 is
    # rendered) and Mono's rendering network (never called, as in the
    # reference)
    for k, v in ref.items():
        if k != "features_rest" and not k.startswith("rendering."):
            assert np.nanmax(np.abs(v)) > 0, k
    if pair.family == "gaussianavatars":
        np.testing.assert_allclose(pair.tprobe.numpy(), pair.gprobe,
                                   atol=8e-5 * np.abs(pair.gprobe).max())
        st, ref_st = pair.tts1.state, pair.ts1["state"]
        for k in ("xyz_gradient_accum", "denom"):
            want = ref_st[k]
            assert np.abs(want).max() > 0
            np.testing.assert_allclose(getattr(st, k).numpy(), want,
                                       atol=8e-5 * np.abs(want).max(), err_msg=k)
        np.testing.assert_array_equal(st.max_radii2d.numpy(), ref_st["max_radii2d"])
    if pair.family == "monogaussianavatar":
        np.testing.assert_array_equal(pair.tts1.state.visible.numpy(),
                                      pair.ts1["state"]["visible"])
    lrs = pair.topt.lr_tree
    tp1 = flat(pair.tts1.params)
    for k, want in flax_names(flat(pair.ts1["params"])).items():
        lr = lrs[k.split(".")[0]]
        np.testing.assert_array_equal(np.isnan(tp1[k]), np.isnan(want), err_msg=k)
        d = np.abs(tp1[k] - want)[~np.isnan(want)]
        assert (d <= 2 * lr + 1e-6).all(), k
        assert (d > 1e-2 * lr + 1e-6).mean() < 0.01, k
    assert pair.tts1.step == int(pair.ts1["step"]) == 2


def test_batched_step_matches_jax(pair):
    """The step on a batched [2, ...] frame (frames 0 and 1) in one process
    against JAX's jitted step on the same batch, from the same state: the
    mean losses and the PSNR (GA: of the whole batch's error; the others:
    the mean of the frames') within 2e-6 relative; GA's accumulators, whose
    probe gradients are rescaled by (2 / W) * B, within 8e-5 of their
    largest, max radii exact; Mono's visibility (any frame) exact; the
    parameters within Adam's bound everywhere and 1e-2 lr on all but 1% of
    the elements (as in test_step_matches_jax)."""
    for k, v in pair.auxb.items():
        if k in pair.tauxb and np.ndim(v) == 0 and k not in ("num_alive", "overflow"):
            np.testing.assert_allclose(float(pair.tauxb[k]), float(v), rtol=2e-6, atol=1e-9,
                                       err_msg=k)
    assert "psnr" in pair.auxb and int(pair.tauxb["overflow"]) == 0
    st, ref_st = pair.ttsb.state, pair.tsb["state"]
    if pair.family == "gaussianavatars":
        for k in ("xyz_gradient_accum", "denom"):
            want = ref_st[k] - pair.ts0["state"][k]
            assert np.abs(want).max() > 0
            np.testing.assert_allclose(getattr(st, k).numpy() - pair.ts0["state"][k], want,
                                       atol=8e-5 * np.abs(want).max(), err_msg=k)
        np.testing.assert_array_equal(st.max_radii2d.numpy(), ref_st["max_radii2d"])
    if pair.family == "monogaussianavatar":
        np.testing.assert_array_equal(st.visible.numpy(), ref_st["visible"])
    lrs = pair.topt.lr_tree
    tp = flat(pair.ttsb.params)
    for k, want in flax_names(flat(pair.tsb["params"])).items():
        lr = lrs[k.split(".")[0]]
        np.testing.assert_array_equal(np.isnan(tp[k]), np.isnan(want), err_msg=k)
        d = np.abs(tp[k] - want)[~np.isnan(want)]
        assert (d <= 2 * lr + 1e-6).all(), k
        assert (d > 1e-2 * lr + 1e-6).mean() < 0.01, k
    assert pair.ttsb.step == int(pair.tsb["step"]) == 2


def test_init_matches_jax(pair, flames):
    """The port's own init from the same template, FLAME and seed: the
    numpy-seeded parts bit-exact (GA's colours, the samples' faces and
    barycentrics, Mono's sphere), derived geometry to float32 rounding; the
    networks' weights by name and shape (their draws are torch's)."""
    family, jb = pair.family, pair.built
    tb = tregistry.get(family).build_model(sphere_obj_mesh(NV), flames[1], MODEL_CFG)
    jp, tp = flax_names(flat(to_np(jb[1]))), flat(tb[1])
    assert sorted(jp) == sorted(tp)
    for k, v in jp.items():
        assert tp[k].shape == v.shape, k
        if "." not in k:
            np.testing.assert_allclose(tp[k], v, rtol=1e-6, atol=1e-7, err_msg=k)
    if family != "flashavatar":
        for k, v in flat(to_np(jb[2])).items():
            np.testing.assert_allclose(flat(tb[2])[k], v, rtol=1e-6, atol=1e-7, err_msg=k)
    jm, tm = to_np(jb[0]), tb[0]
    for f in dataclasses.fields(tm):
        if f.name not in ("flame", "cfg"):
            np.testing.assert_allclose(getattr(tm, f.name).numpy(), jm[f.name], rtol=1e-5,
                                       atol=1e-6, err_msg=f.name)


# ---------------------------------------------------------------------------
# maintenance with injected draws, the walk, the point functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["clone", "split", "prune"])
def test_densify_and_prune_matches_jax(flames, case):
    """GaussianAvatars' clone / split / prune from the same state, the split
    with jax.random's normal draws injected (ROADMAP Queue 3 "Densify RNG"):
    alive, binding and touched exact; parameters within float32 rounding."""
    jf, _ = flames
    model, params, state = jga.init_gaussianavatars(
        jf, jga.GAConfig(sh_degree=1, capacity=512, img_height=RES, img_width=RES))
    params = _perturb("gaussianavatars", params)
    rng = np.random.default_rng(3)
    # a second splat on 100 random faces (a copy of its first), so the
    # binding guard leaves something to prune
    F = jf.faces.shape[0]
    dup = rng.integers(0, F, 100)
    rows = np.concatenate([np.arange(F), dup])
    params = params.replace(**{f.name: getattr(params, f.name).at[:F + 100].set(
        getattr(params, f.name)[rows]) for f in dataclasses.fields(params)})
    # the copies faint: low opacity prunes them, and the guard keeps a face's
    # original where its copy goes
    params = params.replace(opacity=params.opacity.at[:F].add(3.0).at[F:].add(-3.0))
    alive = np.arange(512) < F + 100
    state = state.replace(
        alive=jnp.asarray(alive),
        binding=state.binding.at[F:F + 100].set(jnp.asarray(dup, jnp.int32)),
        xyz_gradient_accum=jnp.asarray(np.where(alive, rng.random(512), 0.0), jnp.float32),
        denom=jnp.asarray(np.where(alive, 1.0, 0.0), jnp.float32),
        max_radii2d=jnp.asarray(rng.integers(0, 30, 512), jnp.float32))
    kw = dict(clone=dict(max_grad=0.5, min_opacity=0.005, extent=100.0, budget=64,
                         max_screen_size=jnp.inf),
              split=dict(max_grad=0.5, min_opacity=0.005, extent=1e-6, budget=64,
                         max_screen_size=jnp.inf),
              prune=dict(max_grad=1e9, min_opacity=0.3, extent=100.0, budget=64,
                         max_screen_size=20.0))[case]
    key = jax.random.PRNGKey(7)
    jp, js, jt = jga.densify_and_prune(key, params, state, **kw)
    k1, k2 = jax.random.split(key)
    noise = tuple(t(np.asarray(jax.random.normal(k, (32, 3)))) for k in (k1, k2))
    tkw = {k: (float(v) if k == "max_screen_size" else v) for k, v in kw.items()}
    tp, ts, tt = tga.densify_and_prune(
        convert.baseline_params("gaussianavatars", to_np(params), CPU),
        convert.baseline_state("gaussianavatars", to_np(state), CPU), noise=noise, **tkw)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for k in ("alive", "binding", "xyz_gradient_accum", "denom", "max_radii2d"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(), np.asarray(getattr(js, k)),
                                      err_msg=k)
    for k, v in to_np(jp).items():
        np.testing.assert_allclose(getattr(tp, k).numpy(), v, rtol=1e-6, atol=1e-7, err_msg=k)
    n0, n1 = int(state.alive.sum()), int(ts.alive.sum())
    assert {"clone": n0 < n1 <= n0 + 64, "split": n1 == n0 + 32,
            "prune": F <= n1 < n0}[case], (case, n0, n1)


def test_reset_opacity_and_lr_schedule_match_jax(flames):
    jf, _ = flames
    _, params, _ = jga.init_gaussianavatars(jf, jga.GAConfig(capacity=256))
    params = _perturb("gaussianavatars", params)
    ref = jga.reset_opacity(params).opacity
    got = tga.reset_opacity(convert.baseline_params("gaussianavatars", to_np(params), CPU))
    np.testing.assert_allclose(got.opacity.numpy(), np.asarray(ref), rtol=1e-6)
    for args in ((0.005, 5e-5, 1000), (0.005, 5e-5, 1000, 0.01, 100)):
        js, ts = jga.expon_lr_schedule(*args), tga.expon_lr_schedule(*args)
        for step in (0, 50, 500, 1000, 2000):
            np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6)


def _walk_inputs(flames, n=64, seed=4):
    """A SplattingAvatar model on the canonical mesh (FLAME's template:
    the synthetic FLAME's canonical pose moves it by little) and random
    walks on it."""
    jf, _ = flames
    verts = np.asarray(jf.v_template)
    faces = np.asarray(jf.faces)
    model = jsa.SplatModel(
        flame=jf, faces=jnp.asarray(faces), cano_verts=jnp.asarray(verts),
        cano_norms=jnp.zeros_like(jnp.asarray(verts)),
        cano_face_areas=jnp.ones((faces.shape[0], 1)),
        face_adjacency=jnp.asarray(jsa.build_face_adjacency_table(faces)),
        bg_color=jnp.ones(3), cfg=jsa.SplatConfig(num_samples=n, capacity=n))
    rng = np.random.default_rng(seed)
    fidx = rng.integers(0, faces.shape[0], n)
    b = rng.random((n, 3)) + 0.05
    bary = (b / b.sum(-1, keepdims=True)).astype(np.float32)
    delta = (rng.normal(size=(n, 3)) * 0.08).astype(np.float32)
    delta[:4] = 0.0                       # inactive rows pass through
    return model, fidx, bary, delta


def test_triangle_walk_matches_jax(flames):
    """The walk on the canonical sphere: face indices exact, barycentrics
    within 1e-6; some walks cross edges (several in one call), zero
    displacements stay put; a border case on a single triangle (no
    neighbour) stops on the edge."""
    model, fidx, bary, delta = _walk_inputs(flames)
    jf_, jb_ = jsa.triangle_walk(model.cano_verts, model.faces, model.face_adjacency,
                                 jnp.asarray(fidx, jnp.int32), jnp.asarray(bary),
                                 jnp.asarray(delta))
    tf_, tb_ = tsa.triangle_walk(t(model.cano_verts), t(model.faces, torch.int64),
                                 t(model.face_adjacency, torch.int64), t(fidx, torch.int64),
                                 t(bary), t(delta))
    np.testing.assert_array_equal(tf_.numpy(), np.asarray(jf_))
    np.testing.assert_allclose(tb_.numpy(), np.asarray(jb_), atol=1e-6)
    assert (tf_.numpy() != fidx).sum() > len(fidx) // 8
    np.testing.assert_array_equal(tf_[:4].numpy(), fidx[:4])
    np.testing.assert_array_equal(tb_[:4].numpy(), bary[:4])
    # one triangle, no neighbours: a walk out of it stops at the border
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    faces = np.array([[0, 1, 2]])
    adj = np.full((1, 3), -1)
    d = np.array([[2.0, 0.0, 0.0], [0.1, 0.1, 0.0]], np.float32)
    b0 = np.full((2, 3), 1 / 3, np.float32)
    jres = jsa.triangle_walk(jnp.asarray(verts), jnp.asarray(faces, jnp.int32),
                             jnp.asarray(adj, jnp.int32), jnp.zeros(2, jnp.int32),
                             jnp.asarray(b0), jnp.asarray(d))
    tres = tsa.triangle_walk(t(verts), t(faces, torch.int64), t(adj, torch.int64),
                             torch.zeros(2, dtype=torch.int64), t(b0), t(d))
    np.testing.assert_array_equal(tres[0].numpy(), np.asarray(jres[0]))
    np.testing.assert_allclose(tres[1].numpy(), np.asarray(jres[1]), atol=1e-6)
    # the +x walk leaves through the edge opposite vertex 0 and stops there
    assert abs(float(tres[1][0, 0])) < 1e-6 and int(tres[0][0]) == 0


def test_walking_on_triangles_matches_jax(flames):
    """The walk of accumulated uvd along the canonical frames (dead rows
    do not move), uvd.xy zeroed, uvd.z kept."""
    model, fidx, bary, _ = _walk_inputs(flames)
    rng = np.random.default_rng(9)
    n = len(fidx)
    params = jsa.SplatParams(
        uvd=jnp.asarray(rng.normal(size=(n, 3)) * 0.05, jnp.float32),
        **{k: jnp.zeros((n, 1)) for k in ("features_dc", "features_rest", "scaling",
                                           "rotation", "opacity")})
    state = jsa.SplatState(
        sample_fidxs=jnp.asarray(fidx, jnp.int32), sample_bary=jnp.asarray(bary),
        alive=jnp.asarray(rng.random(n) > 0.2),
        **{k: jnp.zeros(n) for k in ("xyz_gradient_accum", "denom", "max_radii2d")})
    jp, js = jsa.walking_on_triangles(model, params, state)
    tmodel = convert.baseline_model("splattingavatar", to_np(model), CPU)
    tp, ts = tsa.walking_on_triangles(
        tmodel, convert.baseline_params("splattingavatar", to_np(params), CPU),
        convert.baseline_state("splattingavatar", to_np(state), CPU))
    np.testing.assert_array_equal(ts.sample_fidxs.numpy(), np.asarray(js.sample_fidxs))
    np.testing.assert_allclose(ts.sample_bary.numpy(), np.asarray(js.sample_bary), atol=1e-6)
    np.testing.assert_array_equal(tp.uvd.numpy(), np.asarray(jp.uvd))
    dead = ~np.asarray(state.alive)
    np.testing.assert_array_equal(ts.sample_fidxs.numpy()[dead], fidx[dead])
    assert (ts.sample_fidxs.numpy() != fidx).any()


def test_prune_and_upsample_matches_jax(flames):
    """Mono's prune / upsample with jax.random's categorical sources and
    uniforms injected: the written slots (dead first, in index order),
    points, alive and touched exact; the epoch maintenance's target and
    radius as JAX's schedule."""
    rng = np.random.default_rng(2)
    n = 512
    params = jma.MonoParams(points=jnp.asarray(rng.normal(size=(n, 3)), jnp.float32),
                            geometry={}, deformer={}, gaussian={}, rendering={})
    alive0 = np.arange(n) < 300
    vis = alive0 & (rng.random(n) > 0.3)
    state = jma.MonoState(alive=jnp.asarray(alive0), visible=jnp.asarray(vis),
                          radius=jnp.float32(0.1))
    key, target, scale = jax.random.PRNGKey(3), 400, 0.05
    jp, js, jt = jma.prune_and_upsample(key, params, state, target=target,
                                        noise_scale=jnp.asarray(scale))
    k1, k2 = jax.random.split(key)
    alive = np.asarray(state.alive) & vis
    probs = jnp.where(jnp.asarray(alive), 1.0, 0.0)
    src = jax.random.categorical(k1, jnp.log(jnp.maximum(probs, 1e-30)), shape=(target,))
    u = jax.random.uniform(k2, (target, 3))
    tp, ts, tt = tma.prune_and_upsample(
        convert.baseline_params("monogaussianavatar", to_np(params), CPU),
        convert.baseline_state("monogaussianavatar", to_np(state), CPU), target, scale,
        draws=(t(np.asarray(src), torch.int64), t(np.asarray(u))))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
    np.testing.assert_allclose(tp.points.numpy(), np.asarray(jp.points), rtol=1e-6, atol=1e-7)
    assert int(ts.alive.sum()) == target and not ts.visible.any()
    # the port's own draws: sources alive only, uniforms in [0, 1)
    g = torch.Generator().manual_seed(0)
    s2, u2 = tma.upsample_draws(g, t(alive, torch.bool), 1000)
    assert alive[s2.numpy()].all() and 0 <= float(u2.min()) and float(u2.max()) < 1
    for epoch in (4, 5, 12, 59, 60, 65, 130):
        assert tma.target_points_for_epoch(epoch, 100_000) == jma.target_points_for_epoch(
            epoch, 100_000)
        assert tma.radius_decay(epoch, 0.1) == jma.radius_decay(epoch, 0.1)


def test_flame_point_functions_match_jax():
    """forward_pts / inverse_pts (and their parts) on random per-point
    blendshapes, posedirs and softmax weights over 6 bones: within 1e-5
    relative; inverse(forward(p)) = p."""
    rng = np.random.default_rng(0)
    n, e = 50, 4
    tf = np.tile(np.eye(4), (n, 6, 1, 1))
    tf[:, :, :3, :] += rng.normal(size=(n, 6, 3, 4)) * 0.1
    w = rng.normal(size=(n, 6))
    w = np.exp(w) / np.exp(w).sum(-1, keepdims=True)
    args = [rng.normal(size=(n, 3)), rng.normal(size=(n, e)), tf, rng.normal(size=(n, 36)),
            rng.normal(size=(n, 3, e)) * 0.1, rng.normal(size=(n, 36, 3)) * 0.01, w]
    args = [np.asarray(a, np.float32) for a in args]
    for name in ("forward_pts", "inverse_pts"):
        ref = np.asarray(getattr(jflame_mod, name)(*map(jnp.asarray, args)))
        got = getattr(tflame_mod, name)(*map(t, args)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(), err_msg=name)
    back = tflame_mod.inverse_pts(tflame_mod.forward_pts(*map(t, args)), *map(t, args[1:]))
    np.testing.assert_allclose(back.numpy(), args[0], atol=1e-5)


def test_override_color():
    """render()'s override_color: the given colours in place of the SH
    colour, unclamped. Against the SH render of the same splats whose
    degree-0 coefficients give those colours (C0 dc + 0.5), bit for bit
    inside [0, 1]; a colour above 1 stays above 1 (the SH path clamps only
    below 0). JAX's override_color is held in MonoGaussianAvatar's forward
    (test_forward_matches_jax)."""
    from fateavatar_tpu_torch.ops.sh import C0

    rng = np.random.default_rng(1)
    n = 120
    g = dict(xyz=t(rng.normal(size=(n, 3)) * 0.05),
             scaling=torch.full((n, 3), -3.5),
             rotation=t(np.tile([1.0, 0, 0, 0], (n, 1))),
             opacity=torch.full((n, 1), 1.0),
             features_rest=torch.zeros((n, 1, 3)), alive=torch.ones(n, dtype=torch.bool))
    color = t(rng.random((n, 3)))
    cam = make_camera(np.eye(3), [0.0, 0.0, 0.4], 0.8, 0.8, RES, RES, device=CPU)
    sh = Gaussians(**g, features_dc=((color - 0.5) / C0)[:, None, :])
    other = Gaussians(**g, features_dc=t(rng.normal(size=(n, 1, 3))))
    got = render(cam, other, torch.ones(3), override_color=color)["render"]
    ref = render(cam, sh, torch.ones(3))["render"]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6)
    assert float((got - render(cam, other, torch.ones(3))["render"]).abs().max()) > 0.05
    bright = render(cam, other, torch.zeros(3), override_color=color + 2.0)["render"]
    assert float(bright.max()) > 1.5


def test_argmin_and_argsort_ties():
    """The ties the port relies on: torch.argmin gives the first of equal
    minima, as jnp.argmin (the walk's exit coordinate, all-inf rows
    included; Mono's nearest vertex); the stable argsort keeps index order
    among equal keys, as jnp.argsort (GA's slots, Mono's dead slots)."""
    u = np.array([[0.5, 0.5, 0.9], [np.inf, np.inf, np.inf], [0.7, 0.2, 0.2],
                  [np.inf, 0.3, 0.3]], np.float32)
    np.testing.assert_array_equal(torch.argmin(t(u), dim=-1).numpy(),
                                  np.asarray(jnp.argmin(jnp.asarray(u), axis=-1)))
    np.testing.assert_array_equal(torch.argmin(t(u), dim=-1).numpy(), [0, 0, 1, 1])
    pts = np.array([[0.0, 0.0, 0.0], [1.0, 1.0, 0.0]], np.float32)
    verts = np.array([[1.0, 0, 0], [0, 1.0, 0], [-1.0, 0, 0], [1.0, 1.0, 0.0]], np.float32)
    np.testing.assert_array_equal(tma.nearest_vertex(t(pts), t(verts)).numpy(), [0, 3])
    mask = np.random.default_rng(0).random(300) > 0.5
    ref = np.asarray(jnp.argsort(jnp.asarray(mask)))
    got = torch.argsort(t(mask, torch.bool).to(torch.int8), stable=True).numpy()
    np.testing.assert_array_equal(got, ref)
    idx, valid = tga._select_slots(t(mask, torch.bool), 64)
    jidx, jvalid = jga._select_slots(jnp.asarray(mask), 64)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


# ---------------------------------------------------------------------------
# registry, Trainer, CLI, readers
# ---------------------------------------------------------------------------

def test_registry_builds_all_five(flames):
    """Every family by name: model, loss, optimizer and a step that runs on
    a frame; an unknown name raises; fateavatar has no adapter; a batched
    frame raises naming the data-parallel item."""
    _, tf = flames
    frame = tframe(jframe(0))
    for name in ("fateavatar", *FAMILIES):
        entry = tregistry.get(name)
        bundle = entry.build_model(sphere_obj_mesh(NV), tf, MODEL_CFG)
        loss_fn = entry.build_loss({}, bundle)
        opt = entry.build_optimizer({})
        step = entry.build_step(bundle, loss_fn, opt, TRC,
                                dict(NO_MAINT, prune_interval=10**9))
        assert callable(step), name
    with pytest.raises(KeyError):
        tregistry.get("nonexistent")
    with pytest.raises(ValueError):
        make_family_adapter("fateavatar", bundle, loss_fn, opt, TRC, {})
    ad = make_family_adapter(name, bundle, loss_fn, opt, TRC, NO_MAINT)
    # a batched [2, ...] frame trains (the mean loss over its frames)
    ts, aux = ad.step(ad.init_ts(0), stack_frames([frame, tframe(jframe(1))]))
    assert ts.step == 1 and np.isfinite(float(aux["loss"])) and int(aux["overflow"]) == 0


MAINT_FIRES = dict(densify_interval=2, densify_from_iter=0, densify_grad_threshold=0.0,
                   opacity_reset_interval=10**9, triangle_walk_interval=2)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_through_trainer(tmp_path, flames, family):
    """Two epochs of two steps (GA's densify and Splat's walk firing at
    steps 2 and 4, Mono's epoch hook at epoch 2 with upsample_freq 2; epoch 2
    a scan epoch, its frames cached in epoch 1), evaluation with its metrics
    file, a snapshot (the scan epoch's, after the epoch that crosses the
    interval, as the JAX package's scan epoch takes it), the fps test, a
    checkpoint, and a fresh Trainer that resumes it and trains a third
    epoch; set_render_cfg raises for an adapter."""
    from fateavatar_tpu_torch.flame.loader import synthetic_flame as tsynth
    from fateavatar_tpu_torch.train.datasets import SyntheticDataset

    tf = tsynth(n_verts=NV, n_shape=6, n_exp=4, seed=0, device=CPU)
    entry = tregistry.get(family)

    def trainer():
        bundle = entry.build_model(sphere_obj_mesh(NV), tf, MODEL_CFG)
        loss_fn = entry.build_loss({}, bundle)
        opt = entry.build_optimizer({"lr": 1e-3})
        adapter = make_family_adapter(family, bundle, loss_fn, opt, TRC, MAINT_FIRES)
        if family == "monogaussianavatar":
            model = bundle[0]

            def hook(tr, epoch):
                tr.ts = tbs.mono_epoch_maintenance(tr.ts, model, epoch, upsample_freq=2)
            adapter.epoch_hook = hook
        state0 = bundle[2] if len(bundle) > 2 and not callable(bundle[2]) else None
        ds = SyntheticDataset(num_frames=2, img_res=(RES, RES), n_exp=4)
        return Trainer(family, bundle[0], bundle[1], state0, loss_fn, opt, ds,
                       SyntheticDataset(num_frames=2, img_res=(RES, RES), n_exp=4, seed=1),
                       workspace=str(tmp_path), render_cfg=TRC, snapshot_interval=3,
                       adapter=adapter)

    tr = trainer()
    alive0 = tr._alive()
    tr.train(2)
    assert tr.global_step == tr.ts.step == 4 and tr.last_epoch_stats["overflow"] == 0
    assert tr.last_epoch_stats["mode"] == "scan"
    assert all(np.isfinite(tr.epoch_losses))
    if family == "gaussianavatars":
        assert tr._alive() != alive0
    if family == "monogaussianavatar":
        assert tr._alive() == tma.target_points_for_epoch(2, 256) and tr._alive() != alive0
    summary = tr.evaluate("test")
    assert np.isfinite(summary["psnr"])
    assert (tmp_path / "media" / "metrics" / "test_epoch2.json").exists()
    assert (tmp_path / "media" / "snapshots" / "step00000004.png").exists()
    assert tr.fps_performance_test(2) > 0
    with pytest.raises(NotImplementedError):
        tr.set_render_cfg(TRC)
    resumed = trainer()
    resumed.load_checkpoint()
    assert resumed.global_step == resumed.ts.step == 4 and resumed.epoch == 2
    for k, v in flat(tr.ts.params).items():
        np.testing.assert_array_equal(flat(resumed.ts.params)[k], v, err_msg=k)
    assert torch.equal(resumed.ts.opt_state.count, tr.ts.opt_state.count)
    resumed.train(3)
    assert resumed.global_step == 6


def test_cli_train_resume(tmp_path):
    """cli/train_baseline on a generated 32x32 IMAvatar layout with --device
    cpu (tracking on): one epoch, then --resume to epoch 2, each evaluated
    (the test rows fitted first); workspace baseline_<model>."""
    ws = str(tmp_path)
    root = _cli_assets(ws)
    args = ["--model", "flashavatar", "--device", "cpu",
            "--config", os.path.join(REPO, "configs", "flashavatar.yaml"),
            f"dataset.root_path={root}", f"workspace={ws}/run",
            f"assets.flame_model_path={ws}/flame.pkl", f"assets.template_mesh_path={ws}/head.obj",
            f"dataset.img_res=[{RES},{RES}]", "model.tex_size=8"]
    tr = train_baseline.main(["--epochs", "1", *args])
    assert tr.tracking_enabled and tr.global_step == 4 and tr.adapter.name == "flashavatar"
    assert tr.test_track_state.count.tolist() == [50, 50]
    media = os.path.join(ws, "run", "baseline_flashavatar", "media")
    assert os.path.exists(os.path.join(media, "metrics", "test_epoch1.json"))
    resumed = train_baseline.main(["--epochs", "2", "--resume", *args])
    assert resumed.global_step == 8 and resumed.epoch == 2
    assert resumed.train_track_state.count.tolist() == [2] * 4
    assert os.path.exists(os.path.join(media, "eval_images", "test_epoch2_frame0.png"))


def test_is_flashavatar_reads_mouth_masks(tmp_path):
    """With is_flashavatar the INSTA reader's samples hold each frame's
    mouth mask (images/ -> parsing/, _mouth.png) as [H, W, 1], equal to the
    JAX package's; the FlashAvatar loss adds its 40x mouth term on it."""
    from test_torch_data import _pil_save
    from torch_layouts import write_insta

    rng = np.random.default_rng(0)
    root = str(tmp_path / "insta_subj")
    n = 2
    imgs = [(rng.random((RES, RES, 3)) * 255).astype(np.uint8) for _ in range(n)]
    write_insta(root, "train", imgs, np.tile(np.eye(4), (n, 1, 1)), rng, _pil_save)
    os.makedirs(os.path.join(root, "parsing"))
    for i in range(n):
        mask = np.zeros((RES + 8, RES + 8, 3), np.uint8)
        mask[10 + i:20, 12:24] = 255
        write_png(os.path.join(root, "parsing", f"{i:05d}_mouth.png"), mask)
    j = jdatasets.InstaDataset(root, "train", (RES, RES), is_flashavatar=True)
    p = tdatasets.InstaDataset(root, "train", (RES, RES), is_flashavatar=True)
    for i in range(n):
        a, b = j.sample(i)["ground_truth"], p.sample(i)["ground_truth"]
        assert b["mouth_mask"].shape == (RES, RES, 1) and b["mouth_mask"].max() > 0.5
        np.testing.assert_array_equal(b["mouth_mask"], a["mouth_mask"])
    gt = p.sample(0)["ground_truth"]
    pred = np.full((RES, RES, 3), 0.5, np.float32)
    with_mouth = {"rgb": t(gt["rgb"]), "mouth_mask": t(gt["mouth_mask"])}
    got = tl.FlashAvatarLoss()({"rgb_image": t(pred)}, with_mouth)
    ref = jl.FlashAvatarLoss()({"rgb_image": jnp.asarray(pred)},
                               {k: jnp.asarray(v.numpy()) for k, v in with_mouth.items()})
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]), rtol=2e-6)
    plain = tl.FlashAvatarLoss()({"rgb_image": t(pred)}, {"rgb": t(gt["rgb"])})
    assert float(got["loss"]) > float(plain["loss"])
