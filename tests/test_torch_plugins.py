"""The completion plug-ins against the JAX package, on the CPU: GFPGAN
(stage ④), MODNet and BiSeNet (stage ⑧) and the official-pickle reader.

Each network runs in both packages on the same weights. BiSeNet's are JAX's
own ``init_bisenet`` (numpy draws), carried across by
``convert.bisenet_state_dict`` (HWIO -> OIHW). GFPGAN's and MODNet's are
numpy draws at the scales of the JAX package's ``jax.random`` inits, whose
names and shapes are checked against ``jax.eval_shape`` of those inits (
drawing them under XLA costs 4-12 s of compile), carried across by
``convert.gfpgan_state_dict`` / ``modnet_state_dict``. Sizes: GFPGAN at
``tiny_gfpgan_config()`` (32^2), MODNet and BiSeNet at their real widths on
64^2 and 50x70 images. Each JAX forward compiles once, shared through
module-scoped fixtures.

Tolerances: 1e-4 of the output's largest magnitude (float32 convolutions
summed in another order). MODNet is compared on its pre-sigmoid fusion
logits, where a random net can saturate the sigmoid. BiSeNet's masks: at
least 99.9 % of pixels equal, every class flip at a pixel whose top-2 JAX
logits are within 1e-4."""

import dataclasses
import io
import os
import pickle
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_layouts import nest_state_dict, persistence_writer, write_network_pkl
from torch_single_thread import one_torch_thread  # noqa: F401 (autouse fixture)
from fateavatar_tpu.completion import matting as jm
from fateavatar_tpu.completion import restoration as jr
from fateavatar_tpu.completion import segmentation as js
from fateavatar_tpu.completion.eg3d import pkl_ingest as jpkl

from fateavatar_tpu_torch import convert
from fateavatar_tpu_torch.completion import matting as tm
from fateavatar_tpu_torch.completion import restoration as tr
from fateavatar_tpu_torch.completion import segmentation as ts
from fateavatar_tpu_torch.completion.eg3d import networks as teg3d
from fateavatar_tpu_torch.completion.eg3d import pkl_ingest as tpkl
from fateavatar_tpu_torch.completion.eg3d.convert import load_eg3d_from_torch

RTOL = 1e-4


def numpy_params(spec, seed):
    """Seeded numpy draws for a port spec: randn times the init's scale,
    zeros or ones."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, init) in spec.items():
        if init in ("zeros", "ones"):
            out[name] = (np.zeros if init == "zeros" else np.ones)(shape, np.float32)
        else:
            out[name] = (rng.standard_normal(shape) * init).astype(np.float32)
    return out


def shapes_of(tree):
    return {k: tuple(v.shape) for k, v in tree.items()}


def close(got, ref, rtol=RTOL):
    ref = np.asarray(ref)
    err = float(np.abs(np.asarray(got) - ref).max())
    assert err <= rtol * float(np.abs(ref).max()), (err, float(np.abs(ref).max()))


# ---------------------------------------------------------------------------
# GFPGAN
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gfpgan():
    jcfg = jr.tiny_gfpgan_config()
    cfg = tr.tiny_gfpgan_config()
    raw = numpy_params(tr.gfpgan_param_spec(cfg), seed=0)
    net = tr.GFPGAN(cfg, device="cpu")
    net.load_state_dict(convert.gfpgan_state_dict(raw))
    jrest = jr.GFPGANRestorer({k: jnp.asarray(v) for k, v in raw.items()}, jcfg)
    return jcfg, raw, net, jrest


def test_gfpgan_params_and_restore_match_jax(gfpgan):
    """Names and shapes as JAX's ``gfpgan_random_params``; a batch of two
    crops in [-1, 1] restored by the network within 1e-4."""
    jcfg, raw, net, jrest = gfpgan
    want = jax.eval_shape(lambda k: jr.gfpgan_random_params(k, jcfg), jax.random.PRNGKey(0))
    assert shapes_of(raw) == shapes_of(want)
    assert set(net.state_dict()) == set(raw)
    x = np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jrest._fn(jnp.asarray(x)))
    with torch.no_grad():
        out = net(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 32, 32, 3)
    close(out, ref)


@pytest.mark.parametrize("side", [24, 48], ids=["grow", "shrink"])
def test_gfpgan_restorer_resizes_crops(gfpgan, side):
    """``GFPGANRestorer`` on crops smaller (24^2) and larger (48^2) than the
    network's 32^2: resized there and back with antialias, as
    ``jax.image.resize(..., "linear")``."""
    _, _, net, jrest = gfpgan
    crops = np.random.default_rng(side).random((2, side, side, 3)).astype(np.float32)
    out = tr.GFPGANRestorer(net)(crops)
    assert out.shape == crops.shape
    close(out, np.asarray(jrest(crops)))


def test_load_gfpgan_from_torch(gfpgan, tmp_path):
    """The public checkpoint layout: ``params_ema`` with the training-time
    ``toRGB`` heads and the decoder's noise buffers, which are reported as
    unused."""
    _, raw, net, _ = gfpgan
    sd = {k: torch.from_numpy(v) for k, v in raw.items()}
    sd["toRGB.0.weight"] = torch.zeros(3, 4, 1, 1)
    sd["stylegan_decoder.noises.noise0"] = torch.zeros(1, 1, 4, 4)
    path = str(tmp_path / "GFPGANv1.4.pth")
    torch.save({"params_ema": sd, "params": {}}, path)
    loaded, cfg, unused = tr.load_gfpgan_from_torch(path, tr.tiny_gfpgan_config(), device="cpu")
    assert cfg == tr.tiny_gfpgan_config()
    assert unused == ["stylegan_decoder.noises.noise0", "toRGB.0.weight"]
    for k, v in net.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


# ---------------------------------------------------------------------------
# MODNet
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def modnet():
    """The port's net and JAX's ``modnet_matte`` jitted to return the
    fusion branch's pre-sigmoid output beside the matte (the last
    ``_conv_ibn_relu``'s value, recorded while tracing)."""
    raw = numpy_params(tm.modnet_param_spec(), seed=2)
    net = tm.MODNet(device="cpu")
    net.load_state_dict(convert.modnet_state_dict(raw))
    jp = {k: jnp.asarray(v) for k, v in raw.items()}
    seen = {}
    orig = jm._conv_ibn_relu

    def spy(p, name, x, **kw):
        y = orig(p, name, x, **kw)
        if name == "f_branch.conv_f.1":
            seen["logits"] = y
        return y

    def matte_and_logits(p, x):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jm, "_conv_ibn_relu", spy)
            return jm.modnet_matte(p, x), seen["logits"]

    return raw, net, jp, jax.jit(matte_and_logits)


def test_modnet_matches_jax_64(modnet):
    """Names and shapes as JAX's ``modnet_random_params``; a 64^2 image:
    fusion logits and matte within 1e-4 of their largest."""
    raw, net, jp, jfn = modnet
    want = jax.eval_shape(jm.modnet_random_params, jax.random.PRNGKey(0))
    assert shapes_of(raw) == shapes_of(want)
    img = np.random.default_rng(3).random((1, 64, 64, 3)).astype(np.float32)
    matte, logits = (np.asarray(a) for a in jfn(jp, jnp.asarray(img)))
    with torch.no_grad():
        got = tm.modnet_logits(net.params(), torch.from_numpy(img))
    close(got.numpy(), logits)
    close(torch.sigmoid(got).numpy(), matte)


def test_modnet_matting_pads_50x70(modnet):
    """``MODNetMatting`` on a 50x70 image: the [0,1] image padded with zeros
    to 64x96 before the network's ``*2-1``, the matte cropped back; JAX's
    plug-in runs on the fixture's compiled function."""
    raw, net, jp, jfn = modnet
    img = np.random.default_rng(4).random((50, 70, 3)).astype(np.float32)
    padded = np.zeros((1, 64, 96, 3), np.float32)
    padded[0, :50, :70] = img
    _, logits = jfn(jp, jnp.asarray(padded))
    with torch.no_grad():
        got = tm.modnet_logits(net.params(), F.pad(torch.from_numpy(img)[None],
                                                   (0, 0, 0, 26, 0, 14)))
    close(got.numpy(), np.asarray(logits))
    jmat = jm.MODNetMatting(jp)
    jmat._fn = lambda x: jfn(jp, x)[0]
    ref = np.asarray(jmat(img))
    out = tm.MODNetMatting(net)(img)
    assert out.shape == (50, 70)
    close(out, ref)


def test_torso_boundary():
    m = np.random.default_rng(5).random((40, 30)).astype(np.float32)
    m[:, :5] = 0.0        # empty columns give -1
    got = tm.torso_boundary(m, 0.7)
    np.testing.assert_array_equal(got, jm.torso_boundary(m, 0.7))
    assert (got[:5] == -1).all()


# ---------------------------------------------------------------------------
# BiSeNet
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bisenet():
    """JAX's ``init_bisenet`` carried across, a 50x70 image, its 64^2
    resize in both packages and JAX's logits there."""
    jp = js.init_bisenet(0)
    net = ts.BiSeNet(device="cpu")
    net.load_state_dict(convert.bisenet_state_dict(jp))
    img = np.random.default_rng(6).random((50, 70, 3)).astype(np.float32)
    x64 = jax.image.resize(jnp.asarray(img)[None], (1, 64, 64, 3), "bilinear")
    logits = np.asarray(jax.jit(js.bisenet_forward)(jp, x64))
    return jp, net, img, np.array(x64), logits


def test_bisenet_init_and_logits_match_jax(bisenet):
    """The port's ``init_bisenet`` gives JAX's arrays (OIHW); the 64^2
    input resize (bilinear, antialiased when it shrinks) within 1e-6; the
    logits within 1e-4 of their largest."""
    jp, net, img, x64, logits = bisenet
    mine = ts.init_bisenet(0)
    theirs = convert.bisenet_state_dict(jp)
    assert list(mine) == list(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(mine[k], v.numpy(), err_msg=k)
    t64 = F.interpolate(torch.from_numpy(img).permute(2, 0, 1)[None], size=(64, 64),
                        mode="bilinear", align_corners=False, antialias=True)
    np.testing.assert_allclose(t64.permute(0, 2, 3, 1).numpy(), x64, atol=1e-6)
    with torch.no_grad():
        got = net(torch.from_numpy(x64)).numpy()
    assert got.shape == (1, 64, 64, ts.N_CLASSES)
    close(got, logits)


def test_bisenet_mask_matches_jax(bisenet):
    """``make_bisenet_matting_fn`` at infer_size 64 on the 50x70 image: the
    head-class mask resized back nearest-exact (JAX's half-pixel nearest);
    >= 99.9 % of pixels equal to JAX's, and every class that differs from
    JAX's argmax sits where JAX's top-2 logits are within 1e-4."""
    jp, net, img, _, logits = bisenet
    ref = np.asarray(js.make_bisenet_matting_fn(jp, infer_size=64)(img))
    matting = ts.make_bisenet_matting_fn(net, infer_size=64)
    out = matting(img)
    assert out.shape == (50, 70) and set(np.unique(out)) <= {0.0, 1.0}
    assert (out == ref).mean() >= 0.999
    cls = matting.classes(img).numpy()
    top2 = np.sort(logits[0], axis=-1)[..., -2:]
    flips = cls != np.argmax(logits[0], axis=-1)
    assert (top2[..., 1] - top2[..., 0])[flips].max(initial=0.0) < 1e-4


def test_load_bisenet_from_torch(bisenet, tmp_path):
    """The public ``79999_iter.pth`` layout (OIHW, aux heads and BN
    counters beside the graph's tensors) loads into the same network."""
    _, net, _, _, _ = bisenet
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    sd["conv_out16.conv_out.weight"] = torch.zeros(19, 64, 1, 1)
    sd["cp.resnet.bn1.num_batches_tracked"] = torch.tensor(7)
    path = str(tmp_path / "79999_iter.pth")
    torch.save(sd, path)
    loaded = ts.load_bisenet_from_torch(path, device="cpu")
    for k, v in net.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    torch.save({"weights": torch.zeros(2)}, path)
    with pytest.raises(ValueError, match="face-parsing"):
        ts.load_bisenet_from_torch(path, device="cpu")


# ---------------------------------------------------------------------------
# the official network pickle
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def eg3d_flat():
    cfg = teg3d.tiny_test_config()
    p = teg3d.eg3d_random_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    return cfg, {k: v.numpy() for k, v in p.items()}


@pytest.mark.parametrize("protocol", [4, 2])
def test_pkl_reader(eg3d_flat, tmp_path, protocol):
    """An upstream snapshot (G and G_ema as persistence module graphs whose
    embedded source raises if run; pickle protocol 4 as upstream writes,
    and 2, the oldest in the wild): both packages' readers give the same
    tensors, exact, and G_ema's attributes; ``load_eg3d_from_pkl`` and
    ``load_eg3d_from_torch(".pkl")`` build the generator at the inferred
    config holding them."""
    cfg, flat = eg3d_flat
    path = str(tmp_path / "network-snapshot.pkl")
    write_network_pkl(path, {
        "G": (flat, {}),
        "G_ema": (flat, {"rendering_kwargs": {"ray_start": 2.35, "ray_end": 3.3},
                         "neural_rendering_resolution": cfg.neural_resolution})},
        protocol=protocol)
    nets = tpkl.load_network_pkl_tensors(path)
    theirs = jpkl.load_network_pkl_tensors(path)
    assert set(nets) == set(theirs) == {"G", "G_ema"}
    sd, attrs = nets["G_ema"]
    assert set(sd) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(sd[k], v)
        np.testing.assert_array_equal(theirs["G_ema"][0][k], v)
    assert attrs["rendering_kwargs"]["ray_start"] == 2.35
    assert attrs["neural_rendering_resolution"] == cfg.neural_resolution
    gen, got_cfg, _ = tpkl.load_eg3d_from_pkl(path, device="cpu")
    gen2, cfg2 = load_eg3d_from_torch(path, device="cpu")
    # the sample counts are not in the tensors: every other field is
    assert got_cfg == cfg2 and dataclasses.replace(
        got_cfg, depth_resolution=cfg.depth_resolution,
        depth_resolution_importance=cfg.depth_resolution_importance) == cfg
    for k, v in flat.items():
        assert torch.equal(gen.state_dict()[k], torch.from_numpy(v))
        assert torch.equal(gen2.state_dict()[k], torch.from_numpy(v))


def test_pkl_numpy_alias_blocked_global_and_zip(tmp_path):
    """A pickle naming numpy's deprecated ``numpy.core.multiarray`` loads
    without a warning; a global off the allowlist raises, at the top level
    and nested in a pickled storage's bytes; a torch.save zip is
    refused."""
    with persistence_writer() as easydict:
        mod = nest_state_dict({}, easydict)
        mod.meta["state"]["_parameters"]["w"] = np.arange(3, dtype=np.float32)
        data = pickle.dumps({"G_ema": mod}, protocol=2)
    data = data.replace(b"numpy._core.multiarray", b"numpy.core.multiarray")
    assert b"numpy.core.multiarray" in data
    path = str(tmp_path / "alias.pkl")
    with open(path, "wb") as fh:
        fh.write(data)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sd, _ = tpkl.load_network_pkl_tensors(path)["G_ema"]
    np.testing.assert_array_equal(sd["w"], np.arange(3, dtype=np.float32))

    evil = str(tmp_path / "evil.pkl")
    with open(evil, "wb") as fh:
        pickle.dump({"G_ema": os.system}, fh)
    with pytest.raises(pickle.UnpicklingError, match="blocked global"):
        tpkl.load_network_pkl_tensors(evil)

    # a pickled storage whose bytes nest code: torch's own
    # _load_from_bytes would run it, the reader's must refuse it
    marker = tmp_path / "ran"

    class Payload:
        def __reduce__(self):
            return os.system, (f"touch {marker}",)

    class NestedStorage:
        def __reduce__(self):
            buf = io.BytesIO()
            torch.save(Payload(), buf, _use_new_zipfile_serialization=False)
            return torch.storage._load_from_bytes, (buf.getvalue(),)

    nested = str(tmp_path / "nested.pkl")
    with open(nested, "wb") as fh:
        pickle.dump({"G_ema": NestedStorage()}, fh, protocol=4)
    with pytest.raises(pickle.UnpicklingError):
        tpkl.load_network_pkl_tensors(nested)
    assert not marker.exists()

    ckpt = str(tmp_path / "ckpt.pth")
    torch.save({"w": torch.zeros(3)}, ckpt)
    with pytest.raises(ValueError, match="zip archive"):
        tpkl.load_network_pkl_tensors(ckpt)
