"""LPIPS, the normal-consistency term and FateAvatarLoss's two new terms
against the JAX package, on the CPU.

LPIPS runs on the same random weights in both packages: JAX's
``lpips_random_params`` carried across through the shared ``.npz`` format
and through ``convert.lpips_params_from_jax``. Sizes are small: alex at
64x64, vgg at 32x32, a 96-vertex sphere for the mesh terms."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_single_thread import one_torch_thread  # noqa: F401 (autouse fixture)
from fateavatar_tpu.ops import mesh as jmesh
from fateavatar_tpu.train import losses as jl
from fateavatar_tpu.train import lpips as jlp
from fateavatar_tpu.train.metrics import LPIPSMeter as JLPIPSMeter
from fateavatar_tpu.utils.obj_io import sphere_obj_mesh

from fateavatar_tpu_torch import convert
from fateavatar_tpu_torch.ops import mesh as tmesh
from fateavatar_tpu_torch.train import losses as tl
from fateavatar_tpu_torch.train import lpips as tlp
from fateavatar_tpu_torch.train.metrics import LPIPSMeter

RES = {"alex": 64, "vgg": 32}
NV = 96

# torch state-dict indices of each backbone's convs: (slice of the full
# LPIPS layout, index in torchvision's ``features``)
TORCH_CONVS = {
    "alex": [(1, 0), (2, 3), (3, 6), (4, 8), (5, 10)],
    "vgg": [(1, 0), (1, 2), (2, 5), (2, 7), (3, 10), (3, 12), (3, 14), (4, 17), (4, 19),
            (4, 21), (5, 24), (5, 26), (5, 28)],
}


def t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float32)


def _images(res, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((res, res, 3)).astype(np.float32),
            rng.random((res, res, 3)).astype(np.float32))


def _arrays(p):
    """Every array of a params container (either package's), in order."""
    return ([np.asarray(a) for wb in p.convs for a in wb]
            + [np.asarray(lin).reshape(-1) for lin in p.lins])


def lpips_random_params_jax(seed, backbones):
    """JAX's ``lpips_random_params`` for each backbone, drawn under one jit
    from an ``rbg`` key (threefry's draws of VGG's 14.7 M weights take
    seconds on the CPU)."""
    def draw(key):
        return [(lambda p: (p.convs, p.lins))(
            jlp.lpips_random_params(jax.random.fold_in(key, i), b))
            for i, b in enumerate(backbones)]

    drawn = jax.jit(draw)(jax.random.key(seed, impl="rbg"))
    return {b: jlp.LpipsParams(b, *d) for b, d in zip(backbones, drawn)}


@pytest.fixture(scope="module")
def jparams():
    return lpips_random_params_jax(0, ("alex", "vgg"))


def _mesh(seed=0):
    mesh = sphere_obj_mesh(NV)
    rng = np.random.default_rng(seed)
    verts = (np.asarray(mesh.verts) * (1.0 + 0.1 * rng.normal(size=(NV, 1)))).astype(np.float32)
    return verts, np.asarray(mesh.faces)


LOSS_CFG = dict(rgb_weight=1.0, lpips_weight=0.1, normal_weight=0.05, laplacian_weight=1e3)


def _loss_inputs():
    verts, faces = _mesh(1)
    pred, gt = _images(RES["vgg"], 7)
    return verts, verts * 1.01, faces, pred, gt


@pytest.fixture(scope="module")
def jref(jparams):
    """Every JAX value the tests compare, from one jit: each backbone's
    distance and its gradient w.r.t. the prediction, the normal-consistency
    term and its gradient w.r.t. the vertices, and FateAvatarLoss's terms
    with the LPIPS (vgg) and normal terms on one output."""
    images = {b: _images(RES[b], 1) for b in RES}
    verts, orig, faces, pred, gt = _loss_inputs()
    adj = jmesh.build_face_adjacency(faces)

    # the weights go in as arguments: as closed-over constants XLA would
    # fold them at compile time
    def refs(weights, images, verts, orig, pred, gt):
        lp = {b: jlp.LpipsParams(b, *w) for b, w in weights.items()}
        out = {b: jax.value_and_grad(lambda x, b=b: jlp.lpips_distance(lp[b], x, y))(x)
               for b, (x, y) in images.items()}
        out["normal"] = jax.value_and_grad(
            lambda v: jmesh.mesh_normal_consistency(v, jnp.asarray(faces), adj))(verts)
        jloss = jl.FateAvatarLoss(jl.FateAvatarLossConfig(**LOSS_CFG), faces=faces,
                                  lpips_params=lp["vgg"])
        out["loss"] = jloss({"rgb_image": pred, "verts": verts[None], "verts_orig": orig[None],
                             "faces": jnp.asarray(faces)}, {"rgb": gt})
        return out

    weights = {b: (p.convs, p.lins) for b, p in jparams.items()}
    return jax.tree.map(np.asarray, jax.jit(refs)(weights, images, verts, orig, pred, gt))


@pytest.mark.parametrize("backbone", ["alex", "vgg"])
def test_lpips_matches_jax(backbone, jparams, jref, tmp_path):
    """JAX's random params reach the port through JAX's ``.npz`` and through
    ``convert``, equal; the port's ``.npz`` loads in JAX, equal. Distance
    within 1e-5 relative (float32 convolutions sum in another order); the
    gradient w.r.t. the prediction within 1e-4 in relative L2 norm (where a
    max pool's top two inputs, or a ReLU input and 0, sit within that
    rounding, the two frameworks route the window's gradient differently)."""
    jp = jparams[backbone]
    jlp.save_lpips_npz(str(tmp_path / "j.npz"), jp)
    tp = tlp.load_lpips_npz(str(tmp_path / "j.npz"), device="cpu")
    tp2 = convert.lpips_params_from_jax(jp, device="cpu")
    assert tp.backbone == tp2.backbone == backbone
    for a, b, ref in zip(_arrays(tp), _arrays(tp2), _arrays(jp)):
        np.testing.assert_array_equal(a, ref)
        np.testing.assert_array_equal(b, ref)
    tlp.save_lpips_npz(str(tmp_path / "t.npz"), tp)
    back = jlp.load_lpips_npz(str(tmp_path / "t.npz"))
    assert back.backbone == backbone
    for a, ref in zip(_arrays(back), _arrays(jp)):
        np.testing.assert_array_equal(a, ref)

    pred, gt = _images(RES[backbone], 1)
    vj, gj = jref[backbone]
    x = t(pred).requires_grad_()
    vt = tlp.lpips_distance(tp, x, t(gt))
    (gt_,) = torch.autograd.grad(vt, [x])
    assert float(vj) > 0
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-5)
    assert np.linalg.norm(gt_.numpy() - gj) <= 1e-4 * np.linalg.norm(gj)


def _state_dicts(backbone, seed):
    """A full LPIPS state dict with the ``lpips`` package's key layout
    (``net.slice{k}.{i}.weight``, ``lin{k}.model.1.weight``) and the same
    weights split as lin heads + a torchvision backbone (``features.{i}``)."""
    rng = np.random.default_rng(seed)
    specs, _, chans = tlp._conv_specs(backbone)
    full, tv = {}, {}
    for (out, cin, k, _, _), (s, i) in zip(specs, TORCH_CONVS[backbone]):
        w = torch.tensor(rng.normal(size=(out, cin, k, k)).astype(np.float32) * 0.05)
        b = torch.tensor(rng.normal(size=(out,)).astype(np.float32) * 0.01)
        full[f"net.slice{s}.{i}.weight"], full[f"net.slice{s}.{i}.bias"] = w, b
        tv[f"features.{i}.weight"], tv[f"features.{i}.bias"] = w, b
    lins = {f"lin{k}.model.1.weight": torch.tensor(
        np.abs(rng.normal(size=(1, c, 1, 1))).astype(np.float32)) for k, c in enumerate(chans)}
    full.update(lins)
    return full, lins, tv


@pytest.mark.parametrize("backbone", ["alex", "vgg"])
def test_load_lpips_from_torch_matches_jax(backbone, tmp_path):
    """Both torch layouts give JAX's loader's arrays; a lin-only file
    without a backbone raises, naming ``backbone_path``."""
    full, lins, tv = _state_dicts(backbone, 3)
    paths = {}
    for name, sd in (("full", full), ("lins", lins), ("tv", tv)):
        paths[name] = str(tmp_path / f"{name}.pth")
        torch.save(sd, paths[name])
    for kw in ({}, {"backbone_path": paths["tv"]}):
        src = paths["lins"] if kw else paths["full"]
        ref = jlp.load_lpips_from_torch(src, backbone=backbone, **kw)
        got = tlp.load_lpips_from_torch(src, backbone=backbone, device="cpu", **kw)
        assert len(got.convs) == len(ref.convs) and got.backbone == backbone
        for a, b in zip(_arrays(got), _arrays(ref)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="backbone_path"):
        tlp.load_lpips_from_torch(paths["lins"], backbone=backbone, device="cpu")


def test_lpips_batched_and_meter(jparams, tmp_path):
    """A batch of two equals the two single distances; ``LPIPSMeter`` with a
    full-layout ``.pth`` is available and records JAX's meter's value
    (1e-5); without weights it is unavailable and records NaN."""
    tp = convert.lpips_params_from_jax(jparams["alex"], device="cpu")
    (a, b), (c, d) = _images(64, 4), _images(64, 5)
    batch = tlp.lpips_distance(tp, t(np.stack([a, c])), t(np.stack([b, d])))
    single = [float(tlp.lpips_distance(tp, t(x), t(y))) for x, y in ((a, b), (c, d))]
    assert batch.shape == (2,)
    np.testing.assert_allclose(batch.numpy(), single, rtol=1e-5)

    path = str(tmp_path / "alex_full.pth")
    torch.save(_state_dicts("alex", 6)[0], path)
    m, jm = LPIPSMeter(weights_path=path, device="cpu"), JLPIPSMeter(weights_path=path)
    assert m.available and jm.available
    m.update(a, b)
    jm.update(a, b)
    assert np.isfinite(m.measure())
    np.testing.assert_allclose(m.V_cur, jm.V_cur, rtol=1e-5)
    off = LPIPSMeter(device="cpu")
    assert not off.available
    off.update(a, b)
    assert np.isnan(off.V_cur)


# ---------------------------------------------------------------------------
# normal consistency and the loss
# ---------------------------------------------------------------------------

def test_face_adjacency_and_normal_consistency_match_jax(jref):
    """``build_face_adjacency`` exact (the same pair order; ``[(0, 0)]`` for
    triangles that share no edge); ``mesh_normal_consistency`` within 1e-6
    relative and its gradient within 1e-5 in relative L2 norm."""
    verts, _, faces, _, _ = _loss_inputs()
    adj = tmesh.build_face_adjacency(faces)
    np.testing.assert_array_equal(adj, np.asarray(jmesh.build_face_adjacency(faces)))
    assert adj.shape == (3 * len(faces) // 2, 2)
    apart = np.array([[0, 1, 2], [3, 4, 5]])
    np.testing.assert_array_equal(tmesh.build_face_adjacency(apart), [[0, 0]])
    np.testing.assert_array_equal(np.asarray(jmesh.build_face_adjacency(apart)), [[0, 0]])

    vj, gj = jref["normal"]
    x = t(verts).requires_grad_()
    vt = tmesh.mesh_normal_consistency(x, torch.as_tensor(faces, dtype=torch.int64),
                                       torch.from_numpy(adj))
    (gt_,) = torch.autograd.grad(vt, [x])
    assert float(vj) > 0
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-6)
    assert np.linalg.norm(gt_.numpy() - gj) <= 1e-5 * np.linalg.norm(gj)


def test_fateavatar_loss_lpips_and_normal_match_jax(jparams, jref):
    """FateAvatarLoss with the LPIPS (vgg) and normal-consistency terms on
    one output: every term within 2e-6 relative of JAX's."""
    verts, orig, faces, pred, gt = _loss_inputs()
    tfaces = torch.as_tensor(faces, dtype=torch.int64)
    loss_fn = tl.FateAvatarLoss(tl.FateAvatarLossConfig(**LOSS_CFG), faces=tfaces,
                                lpips_params=convert.lpips_params_from_jax(jparams["vgg"],
                                                                           device="cpu"))
    tloss = loss_fn({"rgb_image": t(pred), "verts": t(verts)[None], "verts_orig": t(orig)[None],
                     "faces": tfaces}, {"rgb": t(gt)})
    jloss = jref["loss"]
    assert sorted(tloss) == sorted(jloss) == ["laplacian_loss", "loss", "lpips_loss",
                                               "normal_loss", "rgb_loss"]
    for k, v in jloss.items():
        assert float(v) > 0, k
        np.testing.assert_allclose(float(tloss[k]), float(v), rtol=2e-6, err_msg=k)
    with pytest.raises(ValueError, match="lpips_params"):
        tl.FateAvatarLoss(tl.FateAvatarLossConfig(lpips_weight=0.1))


def test_construct_loss_and_meters_read_lpips_weights(tmp_path):
    """``cli/common.construct_loss`` loads ``assets.lpips_weights_path``
    with the vgg backbone when ``loss.lpips_weight > 0`` (and raises, naming
    the key, without it) and builds the normal term's adjacency from the
    model's faces; ``default_meters`` keeps LPIPS given weights."""
    from fateavatar_tpu_torch.cli import common
    from fateavatar_tpu_torch.train.metrics import default_meters
    from fateavatar_tpu_torch.utils.config import load_config

    yaml = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "fateavatar.yaml")
    terms = ["loss.vgg_weight=0", "loss.lpips_weight=0.1", "loss.normal_weight=0.01"]
    with pytest.raises(ValueError, match="lpips_weights_path"):
        common.construct_loss(load_config(yaml, terms), device="cpu")
    vgg = tlp.lpips_random_params(torch.Generator().manual_seed(0), "vgg", device="cpu")
    path = str(tmp_path / "vgg.npz")
    tlp.save_lpips_npz(path, vgg)
    _, faces = _mesh()
    loss = common.construct_loss(load_config(yaml, [*terms, f"assets.lpips_weights_path={path}"]),
                                 faces=torch.as_tensor(faces), device="cpu")
    assert loss.lpips_params.backbone == "vgg" and len(loss.lpips_params.convs) == 13
    for a, b in zip(_arrays(loss.lpips_params), _arrays(vgg)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(loss.face_adjacency.numpy(),
                                  tmesh.build_face_adjacency(faces))
    alex = str(tmp_path / "alex.npz")
    tlp.save_lpips_npz(alex, tlp.lpips_random_params(torch.Generator().manual_seed(1), "alex",
                                                     device="cpu"))
    assert sorted(default_meters(device="cpu")) == ["l1", "l2", "psnr", "ssim"]
    assert sorted(default_meters(lpips_weights_path=alex, device="cpu")) == [
        "l1", "l2", "lpips", "psnr", "ssim"]
