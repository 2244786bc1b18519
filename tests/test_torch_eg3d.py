"""The PyTorch port's EG3D generator, PTI and provider against the JAX
package, on the CPU, at ``tiny_test_config()``: the parameter names and
shapes (``state_dict`` keys), mapping, the backbone planes, ``sample_planes``
at D = 1 and D = 2, the rays and the importance sampler (its jitter
injected), ``synthesis`` (the whole render inside it) and the inversion loss's gradients with the JAX
params carried across, ``compute_w_stats`` on JAX's z, 3 ``project_w``
steps (random VGG16 weights) and 2 ``pti_finetune`` steps (the pyramid
fallback), the checkpoint round trips and ``infer_config``, and the
provider's glue (labels, resize, the frontal targets).

The JAX EG3D graph is compiled three times: one function returning the
synthesis outputs with the loss's gradients, ``project_w``, and
``pti_finetune``. The other pieces run un-jitted. Both packages get the
same seeded numpy parameters."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_tracking import vgg_np
from torch_layouts import write_network_pkl
from torch_single_thread import one_torch_thread  # noqa: F401 (autouse fixture)
from fateavatar_tpu.completion.camera_sampler import sample_orbit_pose
from fateavatar_tpu.completion.eg3d import convert as jconvert
from fateavatar_tpu.completion.eg3d import networks as jn
from fateavatar_tpu.completion.eg3d import provider as jprovider
from fateavatar_tpu.completion.eg3d import pti as jpti

from fateavatar_tpu_torch import convert
from fateavatar_tpu_torch.completion.eg3d import convert as tconvert
from fateavatar_tpu_torch.completion.eg3d import networks as tn
from fateavatar_tpu_torch.completion.eg3d import provider as tprovider
from fateavatar_tpu_torch.completion.eg3d import pti as tpti

CFG = jn.tiny_test_config()
TCFG = tn.EG3DConfig(**dataclasses.asdict(CFG))
N_W = 64          # w_avg samples of the PTI tests
# a few generator tensors whose gradients are compared
GRAD_NAMES = ("backbone.synthesis.b4.const", "backbone.synthesis.b16.conv0.weight",
              "backbone.synthesis.b32.torgb.affine.weight",
              "backbone.synthesis.b8.conv1.noise_strength", "decoder.net.0.weight",
              "superresolution.block0.conv1.weight", "superresolution.block0.torgb.bias")


def t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float32)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def params_np(cfg, seed=0):
    """Seeded numpy parameters at ``cfg`` under the checkpoint's names (unit
    normal weights as StyleGAN2 stores them, small random biases, noise
    strengths and w_avg, so every term is live)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, init) in tn.param_spec(cfg).items():
        x = rng.standard_normal(shape).astype(np.float32)
        if init == "mapping":
            x = x / 0.01
        elif init in ("zeros", "ones"):
            x = x * 0.1 + (1.0 if init == "ones" else 0.0)
        out[name] = x.astype(np.float32)
    return out


def label(angle, radius=2.7):
    return jn.eg3d_camera_label(sample_orbit_pose(np.pi / 2 + angle, np.pi / 2, np.zeros(3),
                                                  radius))


@pytest.fixture(scope="module")
def gens():
    p = params_np(CFG)
    return {k: jnp.asarray(v) for k, v in p.items()}, \
        tconvert.generator_from_dict(p, TCFG, device="cpu"), p


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    ws = (rng.standard_normal((1, CFG.num_ws, CFG.w_dim)) * 0.5).astype(np.float32)
    c = np.stack([label(a) for a in (0.0, 0.5)]).astype(np.float32)
    targets = (rng.random((2, CFG.sr_resolution, CFG.sr_resolution, 3)) * 2 - 1
               ).astype(np.float32)
    return ws, c, targets


PCFG = jpti.PTIConfig(w_steps=3, pti_steps=2, w_avg_samples=N_W)
TPCFG = tpti.PTIConfig(**dataclasses.asdict(PCFG))


@pytest.fixture(scope="module")
def jax_synth(gens, inputs):
    """One jitted JAX function: synthesis of a pivot ws at two views (its
    planes, image_raw, image_depth, image) and the inversion loss's
    gradients w.r.t. ws and GRAD_NAMES (the pyramid perceptual term)."""
    jp, _, _ = gens
    ws, c, targets = inputs

    def f(p, ws, c, targets):
        out = jn.synthesis(p, CFG, ws, c, return_raw=True)

        def loss(ws, sub):
            return jpti._inversion_loss({**p, **sub}, CFG, PCFG, ws, targets, c,
                                        ws[0, 0] * 0.5, None)[0]

        val, grads = jax.value_and_grad(loss, argnums=(0, 1))(
            ws, {k: p[k] for k in GRAD_NAMES})
        return out, val, grads

    out, val, (g_ws, g_p) = jax.jit(f)(jp, jnp.asarray(ws), jnp.asarray(c), jnp.asarray(targets))
    return jax.tree.map(np.asarray, (out, val, g_ws, g_p))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def test_param_names_shapes_and_state_dict_match_jax(gens):
    """The port's spec has the JAX init's names and shapes (at the tiny and
    the default config, a tri-grid too); the module's state_dict keys are
    those names, w_avg and noise_const are buffers; the seeded init is
    deterministic."""
    for cfg in (CFG, jn.EG3DConfig(), dataclasses.replace(CFG, triplane_depth=3)):
        want = jax.eval_shape(lambda c=cfg: jn.eg3d_random_params(jax.random.PRNGKey(0), c))
        spec = tn.param_spec(tn.EG3DConfig(**dataclasses.asdict(cfg)))
        assert {k: tuple(v.shape) for k, v in want.items()} == \
            {k: shape for k, (shape, _) in spec.items()}
    _, gen, p = gens
    assert set(gen.state_dict()) == set(p)
    buffers = {k for k, _ in gen.named_buffers()}
    assert buffers == {k for k in p if k.endswith("noise_const") or k.endswith("w_avg")}
    a = tn.eg3d_random_params(torch.Generator().manual_seed(3), TCFG, device="cpu")
    b = tn.eg3d_random_params(torch.Generator().manual_seed(3), TCFG, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["backbone.mapping.fc0.weight"].std()) > 50     # randn / 0.01


def test_mapping_matches_jax(gens):
    """z + c -> ws, plain and truncated (psi 0.7 towards w_avg): within
    1e-6 relative."""
    jp, gen, _ = gens
    rng = np.random.default_rng(2)
    z = rng.standard_normal((3, CFG.z_dim)).astype(np.float32)
    c = np.stack([label(a) for a in (0.0, 0.3, -1.0)]).astype(np.float32)
    for psi in (1.0, 0.7):
        want = np.asarray(jn.mapping_network(jp, CFG, jnp.asarray(z), jnp.asarray(c), psi))
        got = tn.mapping_network(gen.params(), TCFG, t(z), t(c), psi).detach().numpy()
        assert got.shape == want.shape == (3, CFG.num_ws, CFG.w_dim)
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


# ---------------------------------------------------------------------------
# synthesis and the inversion loss's gradients
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_synth(gens, inputs):
    _, gen, _ = gens
    ws, c, targets = inputs
    p = gen.params()
    with torch.no_grad():
        out = tn.synthesis(p, TCFG, t(ws), t(c), return_raw=True)
    wl = t(ws).requires_grad_()
    leaves = {k: p[k].detach().clone().requires_grad_() for k in GRAD_NAMES}
    val, _ = tpti._inversion_loss({**p, **leaves}, TCFG, TPCFG, wl, t(targets), t(c),
                                  wl[0, 0] * 0.5, None)
    g = torch.autograd.grad(val, [wl, *leaves.values()])
    return ({k: v.numpy() for k, v in out.items()}, float(val.detach()), g[0].numpy(),
            {k: gi.numpy() for k, gi in zip(GRAD_NAMES, g[1:])})


@pytest.mark.parametrize("key", ["planes", "image_raw", "image_depth", "image"])
def test_synthesis_matches_jax(jax_synth, port_synth, key):
    """A pivot ws at two views through the backbone (modulated grouped
    convs, the FIR upsample), the planes' sampling, the two-pass render
    (stable merge sort) and the super-resolution: each output within 1e-5
    of the reference's largest magnitude, layouts as JAX's (NHWC)."""
    got, want = port_synth[0][key], jax_synth[0][key]
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_inversion_loss_gradients_match_jax(jax_synth, port_synth):
    """The inversion loss (MSE + pyramid perceptual + w-norm) and its
    gradients w.r.t. ws and seven generator tensors: the loss within 1e-5
    relative, each gradient within 1e-3 rel L2."""
    _, jval, jg_ws, jg_p = jax_synth
    _, tval, tg_ws, tg_p = port_synth
    assert abs(tval - float(jval)) <= 1e-5 * abs(float(jval))
    assert rel_l2(tg_ws, jg_ws) <= 1e-3
    for k in GRAD_NAMES:
        assert np.linalg.norm(jg_p[k]) > 0, k
        assert rel_l2(tg_p[k], jg_p[k]) <= 1e-3, (k, rel_l2(tg_p[k], jg_p[k]))


@pytest.mark.parametrize("depth", [1, 2])
def test_sample_planes_matches_jax(depth):
    """F.grid_sample against the JAX package's bilinear gather, points
    inside and outside the box, tri-plane and tri-grid (plane i, slice d,
    channel c at NHWC channel i*D*C + d*C + c): within 1e-6."""
    cfg = dataclasses.replace(CFG, triplane_depth=depth)
    rng = np.random.default_rng(3)
    planes = rng.standard_normal((16, 16, 3 * depth * cfg.plane_channels)).astype(np.float32)
    coords = (rng.random((300, 3)) * 1.4 - 0.7).astype(np.float32)
    want = np.asarray(jn.sample_planes(cfg, jnp.asarray(planes), jnp.asarray(coords)))
    got = tn.sample_planes(tn.EG3DConfig(**dataclasses.asdict(cfg)), t(planes), t(coords))
    assert got.shape == want.shape == (300, 3, cfg.plane_channels)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_camera_rays_and_importance_sampling_match_jax():
    """camera_rays within 1e-6; the importance sampler, deterministic and
    with JAX's jitter draw injected, within 5e-5 of depths in [2, 4] (the
    float32 CDF's summation order moves a sample where a bin's weight is
    ~1e-5). The whole of render_rays is held in test_synthesis_matches_jax
    (image_raw and image_depth are its feature and depth)."""
    rng = np.random.default_rng(4)
    c = label(0.4)
    c2w, intr = c[:16].reshape(4, 4), c[16:].reshape(3, 3)
    jo, jd = jn.camera_rays(jnp.asarray(c2w), jnp.asarray(intr), 8)
    to, td = tn.camera_rays(t(c2w), t(intr), 8)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    w = rng.random((64, 11, 1)).astype(np.float32) ** 4
    d = np.sort(rng.random((64, 12, 1)).astype(np.float32) * 2 + 2, axis=1)
    key = jax.random.PRNGKey(5)
    jitter = np.asarray(jax.random.uniform(key, (64, 12), minval=-0.5 / 12, maxval=0.5 / 12))
    want = jn._sample_importance(key, jnp.asarray(w), jnp.asarray(d), 12)
    got = tn._sample_importance(t(w), t(d), 12, t(jitter))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)
    det = tn._sample_importance(t(w), t(d), 12)
    np.testing.assert_allclose(det.numpy(),
                               np.asarray(jn._sample_importance(None, jnp.asarray(w),
                                                                jnp.asarray(d), 12)), atol=5e-5)


# ---------------------------------------------------------------------------
# PTI
# ---------------------------------------------------------------------------

def test_compute_w_stats_on_jax_z(gens):
    """The W midpoint and spread from JAX's own z draw: within 1e-6
    relative."""
    jp, gen, _ = gens
    key = jax.random.PRNGKey(6)
    c = label(0.0).astype(np.float32)
    wa, ws_ = jpti.compute_w_stats(jp, CFG, key, jnp.asarray(c), N_W)
    z = np.asarray(jax.random.normal(key, (N_W, CFG.z_dim)))
    ta_, ts_ = tpti.compute_w_stats(gen.params(), TCFG, t(c), N_W, z=t(z))
    assert rel_l2(ta_, wa) <= 1e-6 and abs(float(ts_) - float(ws_)) <= 1e-6 * float(ws_)


def test_project_w_matches_jax(gens, inputs):
    """3 W steps with random VGG16 weights in the perceptual term (the
    first step's ramped rate is 0), on JAX's z: the pivot within 1e-5 rel
    L2, every step's loss logged and finite."""
    jp, gen, _ = gens
    _, c, targets = inputs
    vgg = vgg_np(0)
    key = jax.random.PRNGKey(7)
    want = jpti.project_w(jp, CFG, PCFG, jnp.asarray(targets), jnp.asarray(c), key,
                          vgg_params=[(jnp.asarray(w), jnp.asarray(b)) for w, b in vgg])
    z = np.asarray(jax.random.normal(key, (N_W, CFG.z_dim)))
    log = []
    got = tpti.project_w(gen.params(), TCFG, TPCFG, t(targets), t(c),
                         vgg_params=convert.vgg_params(vgg, device="cpu"), z=t(z),
                         loss_log=log)
    assert got.shape == want.shape == (1, CFG.num_ws, CFG.w_dim)
    assert rel_l2(got, want) <= 1e-5, rel_l2(got, want)
    assert len(log) == 3 and np.isfinite([float(x) for x in log]).all()


def test_pti_finetune_matches_jax(gens, inputs):
    """2 generator steps at a fixed pivot with the pyramid fallback: the
    trainable set is the same (synthesis with its const and noise
    strengths, super-resolution, decoder; no noise_const, no mapping), and
    each tuned tensor's change within 1e-3 rel L2 of JAX's (Adam's
    normalized first steps magnify rounding where gradients are tiny), the
    untouched ones bit-equal; the losses fall."""
    jp, gen, p_np = gens
    ws, c, targets = inputs
    want = jpti.pti_finetune(jp, CFG, PCFG, jnp.asarray(ws), jnp.asarray(targets),
                             jnp.asarray(c))
    log = []
    got = tpti.pti_finetune(gen.params(), TCFG, TPCFG, t(ws), t(targets), t(c), loss_log=log)
    assert set(got) == set(want)
    for k in want:
        delta_j = np.asarray(want[k]) - p_np[k]
        delta_t = got[k].numpy() - p_np[k]
        if not np.any(delta_j):
            np.testing.assert_array_equal(got[k].numpy(), p_np[k], err_msg=k)
            # the super-resolution layers add no noise: their strengths
            # get no gradient
            assert (not k.startswith(tpti.PTI_TRAINABLE) or "noise_const" in k
                    or k.startswith("superresolution") and "noise_strength" in k), k
        else:
            assert rel_l2(delta_t, delta_j) <= 1e-3, (k, rel_l2(delta_t, delta_j))
    losses = [float(x) for x in log]
    assert len(losses) == 2 and losses[1] < losses[0]


# ---------------------------------------------------------------------------
# checkpoints, the provider
# ---------------------------------------------------------------------------

def test_checkpoint_round_trips_and_infer_config(gens, tmp_path):
    """A .npz (the JAX dict, numpy) and a .pth (the port's state_dict) load
    back bit-equal with the inferred config equal to JAX's infer_config
    (and to the tiny config); infer_config agrees at the default and a
    tri-grid config (shapes only); a missing tensor raises naming it; the
    dict as an official network pickle (G_ema a persistence module graph)
    loads back bit-equal at the same config."""
    _, gen, p = gens
    np.savez(tmp_path / "g.npz", **p)
    torch.save(gen.state_dict(), tmp_path / "g.pth")
    for path in (tmp_path / "g.npz", tmp_path / "g.pth"):
        g2, cfg2 = tconvert.load_eg3d_from_torch(str(path), device="cpu")
        assert cfg2 == tn.EG3DConfig(**dataclasses.asdict(jconvert.infer_config(p)))
        assert all(torch.equal(g2.state_dict()[k], gen.state_dict()[k]) for k in p)
    jp2, jcfg2 = jconvert.load_eg3d_from_torch(str(tmp_path / "g.pth"))
    assert jcfg2 == jconvert.infer_config(p)
    for cfg in (jn.EG3DConfig(), dataclasses.replace(CFG, triplane_depth=2)):
        shapes = {k: np.broadcast_to(np.float32(0), s)
                  for k, (s, _) in tn.param_spec(tn.EG3DConfig(**dataclasses.asdict(cfg))).items()}
        assert dataclasses.asdict(tconvert.infer_config(shapes)) == \
            dataclasses.asdict(jconvert.infer_config(shapes))
    broken = {k: v for k, v in p.items() if k != "decoder.net.2.bias"}
    with pytest.raises(KeyError, match="decoder.net.2.bias"):
        tconvert.generator_from_dict(broken, TCFG, device="cpu")
    write_network_pkl(str(tmp_path / "g.pkl"), {"G_ema": (p, {})})
    g3, cfg3 = tconvert.load_eg3d_from_torch(str(tmp_path / "g.pkl"), device="cpu")
    assert cfg3 == cfg2
    assert all(torch.equal(g3.state_dict()[k], gen.state_dict()[k]) for k in p)


def test_provider_glue_matches_jax(gens, monkeypatch):
    """The provider's orbit label, its resize (down with antialiasing, and
    up) and invert's frontal targets (the views within 60 degrees, nearest
    first, at most 8; the nearest alone when none is) against the JAX
    provider's, whose PTI stages are stubbed to capture their inputs:
    labels bit-equal, targets within 1e-6."""
    jp, gen, _ = gens
    seen = {}

    def capture_w(p, cfg, pti_cfg, targets, labels, key, *a, **k):
        seen["targets"], seen["labels"] = np.asarray(targets), np.asarray(labels)
        return jnp.zeros((1, cfg.num_ws, cfg.w_dim))

    monkeypatch.setattr(jprovider, "project_w", capture_w)
    monkeypatch.setattr(jprovider, "pti_finetune", lambda p, *a, **k: p)
    jpro = jprovider.EG3DPseudoProvider(jp, CFG, jpti.PTIConfig(w_steps=1, pti_steps=1),
                                        jprovider.EG3DProviderConfig(max_target_views=3))
    tpro = tprovider.EG3DPseudoProvider(gen, tpti.PTIConfig(w_steps=1, pti_steps=1),
                                        tprovider.EG3DProviderConfig(max_target_views=3))
    for a in (0.0, 0.7, -2.5):
        np.testing.assert_array_equal(tpro._label(a), jpro._label(a))
    rng = np.random.default_rng(8)
    crops = rng.random((6, 48, 48, 3)).astype(np.float32)
    for size in (32, 80):
        np.testing.assert_allclose(tpro._resize(crops[:2], size).numpy(),
                                   np.asarray(jpro._resize(crops[:2], size)), atol=1e-6)
    for angles, labels in ((np.array([0.0, 0.5, -0.3, 3.0, 0.9, -1.2]), None),
                           (np.array([2.0, 2.5, 3.0, -2.0, -2.5, 1.5]), None),
                           (np.array([0.1, 0.2, 5.0, 6.0, 0.0, 1.0]),
                            rng.random((6, 25)).astype(np.float32))):
        jpro.invert(crops, angles, labels=labels)
        keep, _ = tpro.target_views(angles)
        want_labels = (np.stack([labels[i] for i in keep]) if labels is not None
                       else np.stack([tpro._label(((angles[i] + np.pi) % (2 * np.pi)) - np.pi)
                                      for i in keep]))
        np.testing.assert_array_equal(want_labels, seen["labels"])
        np.testing.assert_allclose(tpro._resize(crops[keep], CFG.sr_resolution).numpy(),
                                   seen["targets"], atol=1e-6)


def test_provider_generate_runs(gens):
    """The port's provider end to end at the tiny config (PTI 2 + 2 steps on
    3 frontal crops, 6 orbit views): the orbit at the crops' size, in
    [0, 1] and finite, every step's loss logged."""
    _, gen, _ = gens
    pro = tprovider.EG3DPseudoProvider(gen, tpti.PTIConfig(w_steps=2, pti_steps=2,
                                                           w_avg_samples=N_W))
    rng = np.random.default_rng(9)
    crops = rng.random((3, 40, 40, 3)).astype(np.float32)
    out = pro.generate(crops, np.array([0.0, 0.4, -0.4]),
                       out_angles=np.linspace(0, 2 * np.pi, 6, endpoint=False))
    assert out.shape == (6, 40, 40, 3) and np.isfinite(out).all()
    assert out.min() >= 0 and out.max() <= 1
    assert len(pro.losses["w"]) == len(pro.losses["g"]) == 2
