"""The rasterizer's options in the PyTorch port against the JAX package, on
the CPU: every instance binning mode and layout (bit-exact, slots and groups
included), the three alternative gather transposes, the ``t_cutoff`` early
exit of the instance blend (the plain version against the Pallas kernels in
interpret mode, and through ``render()``), ``make_camera_np`` /
``look_at_camera``, and the occupancy probe. JAX compiles are shared: one
jit covers every binning mode, layout and scene, one every cutoff, blend
case and layout."""

import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_scenes import SCENES
from test_torch_model import _port_avatar
from test_torch_render import GRAD_FIELDS, _port_scene, assert_gradients_match_jax, t
from torch_blend_cases import CUT_WINDOW, aligned_layout, blend_case
from torch_single_thread import one_torch_thread  # noqa: F401 (autouse fixture)
from fateavatar_tpu.flame import synthetic_flame
from fateavatar_tpu.models import fateavatar as jfa
from fateavatar_tpu.ops import camera as jcamera
from fateavatar_tpu.render import autosize as jautosize
from fateavatar_tpu.render import binning as jbinning
from fateavatar_tpu.render.blend_instances import blend_instances_pallas
from fateavatar_tpu.render.render import RenderConfig as JRenderConfig
from fateavatar_tpu.render.render import _take_packed_sorted
from fateavatar_tpu.render.splats import inverse_sigmoid
from fateavatar_tpu.utils.obj_io import sphere_obj_mesh

from fateavatar_tpu_torch.ops import camera as tcamera
from fateavatar_tpu_torch.render import autosize as tautosize
from fateavatar_tpu_torch.render import binning as tbinning
from fateavatar_tpu_torch.render import blend_instances as tblend
from fateavatar_tpu_torch.render import render as render_mod
from fateavatar_tpu_torch.render.preprocess import preprocess
from fateavatar_tpu_torch.render.render import RenderConfig

# ---- make_camera_np / look_at_camera


def test_host_cameras_match_jax():
    """make_camera_np (with and without intrinsics) and look_at_camera
    against the JAX package's, within 1e-6; the port's come back as tensors
    on the device asked for."""
    rng = np.random.default_rng(0)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    T = rng.normal(size=3).astype(np.float32)
    K = np.array([[700.0, 0, 300.0], [0, 650.0, 260.0], [0, 0, 1]], np.float32)
    pairs = [(jcamera.make_camera_np(R, T, 0.8, 0.7, 512, 480, intrinsics=k),
              tcamera.make_camera_np(R, T, 0.8, 0.7, 512, 480, intrinsics=k, device="cpu"))
             for k in (None, K)]
    look_at = jax.jit(jcamera.look_at_camera, static_argnums=(5, 6))
    pairs.append((look_at(np.array([0.5, 0.3, -2.0]), np.array([0, 0.1, 0]),
                          np.array([0.0, 1, 0]), 0.9, 0.8, 64, 48),
                   tcamera.look_at_camera([0.5, 0.3, -2.0], [0, 0.1, 0], [0, 1, 0], 0.9, 0.8,
                                          64, 48, device="cpu")))
    for ref, got in pairs:
        for f in ("view", "proj", "full_proj", "campos", "fovx", "fovy"):
            x = getattr(got, f)
            assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
            np.testing.assert_allclose(x.numpy(), np.asarray(getattr(ref, f)), atol=1e-6,
                                       err_msg=f)
        assert (got.width, got.height, got.znear, got.zfar) == (
            ref.width, ref.height, ref.znear, ref.zfar)


# ---- instance binning: every mode x layout, bit-exact

BIN_SCENES = ("sh0_basic", "sh3_clamp", "aniso", "alpha_edges")
BIN_N = 64                 # each scene padded to this many splats (one compile)
BIN_GRID = (4, 4)          # the golden scenes' 64x64
BIN_KW = dict(max_tiles_per_gaussian=8, instance_budget=0, chunk=128, tail_r0=2, tail_k=8)
LAYOUTS = (("compact", "scatter"), ("aligned", "scatter"), ("aligned", "gather"))
FIELDS = ("instances", "tile_starts", "overflow", "slots", "group_counts", "group_tail")
# the JAX package's 'count' and 'gather' give the aligned layout whatever
# layout and relayout say: one JAX run each
ALIGNED_ONLY = ("count", "gather")


def _extras(mode, layout):
    """(return_slots, return_groups) where the JAX package gives them."""
    return (layout == "aligned" and mode in ("stable", "onesort"),
            mode in ("onesort", "twotier"))


@functools.lru_cache(maxsize=None)
def _screen_space(name):
    """The golden scene's screen-space means, depth and radius (the port's
    preprocess), padded with invisible splats to BIN_N; the padding's
    depths are distinct from the scene's."""
    cam, g, _, n = _port_scene(name)
    with torch.no_grad():
        prep = preprocess(cam, g.xyz, g.get_scaling, g.get_rotation, g.get_opacity,
                          g.get_features, g.sh_degree, alive=g.alive)
    pad = BIN_N - n
    mx, my, depth = (np.concatenate([x.numpy(), v]).astype(np.float32) for x, v in (
        (prep.soa[0], np.zeros(pad)), (prep.soa[1], np.zeros(pad)),
        (prep.depth, 100.0 + np.arange(pad))))
    radius = np.concatenate([prep.radius.numpy(), np.zeros(pad)]).astype(np.int32)
    return mx, my, depth, radius


def _jax_layouts(mode):
    return LAYOUTS[:1] if mode in ALIGNED_ONLY else LAYOUTS


@functools.cache
def _jax_binning():
    """One jit of JAX's build_instance_lists in every mode and layout; JAX
    uses its own default ``count_block``, which cannot change the result."""
    def lists(mx, my, depth, radius):
        out = {}
        for mode in tbinning.SORT_MODES:
            for layout, relayout in _jax_layouts(mode):
                slots, groups = _extras(mode, layout)
                r = jbinning.build_instance_lists(
                    (mx, my), depth, radius, BIN_GRID, sort_mode=mode, layout=layout,
                    relayout=relayout, return_slots=slots, return_groups=groups, **BIN_KW)
                out[mode, layout, relayout] = {f: getattr(r, f) for f in FIELDS}
        return out

    return jax.jit(lists)


@functools.cache
def _jax_binning_of(scene):
    return _jax_binning()(*_screen_space(scene))


@pytest.mark.parametrize("scene", BIN_SCENES)
@pytest.mark.parametrize("mode", tbinning.SORT_MODES)
def test_binning_modes_match_jax_exactly(mode, scene):
    """build_instance_lists in every sort mode, layout and relayout, with
    slots and groups where the JAX package gives them, equal to JAX's bit
    for bit (instances, tile_starts, overflow, slots, group_counts,
    group_tail) on a golden scene. 'count' and 'gather' give JAX's one
    aligned result in every layout. 'twokey' breaks depth ties its own way,
    so its scenes must have distinct depths."""
    mx, my, depth, radius = _screen_space(scene)
    if mode == "twokey":
        vis = radius > 0
        assert np.unique(depth[vis]).size == vis.sum(), "twokey needs distinct depths"
    ref = _jax_binning_of(scene)
    for layout, relayout in LAYOUTS:
        slots, groups = _extras(mode, layout)
        out = tbinning.build_instance_lists(
            t(mx), t(my), t(depth), t(radius, torch.int32), BIN_GRID, sort_mode=mode,
            layout=layout, relayout=relayout, return_slots=slots, return_groups=groups,
            **BIN_KW)
        want = ref[(mode, *_jax_layouts(mode)[0]) if mode in ALIGNED_ONLY
                   else (mode, layout, relayout)]
        for f in FIELDS:
            a, b = getattr(out, f), want[f]
            assert (a is None) == (b is None), (layout, relayout, f)
            if a is not None:
                assert a.dtype == torch.int32, (layout, relayout, f)
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=f"{layout}/{relayout} {f}")
    if mode in ALIGNED_ONLY:
        assert out.instances.shape[0] == BIN_N * 4 + 16 * 128


def test_binning_scenes_overflow():
    """The binning scenes drop instances (R = 8, the budget 4N), so the
    comparisons above cover overflow."""
    assert any(int(_jax_binning_of(s)["stable", "compact", "scatter"]["overflow"]) > 0
               for s in BIN_SCENES)


# ---- the gather transposes through render()

def _opaque_scene():
    """Golden scene sh0_basic grown opaque: each splat 6 times (small
    jitter) at 3x its scale, opacities 0.8-0.99, so tiles hold ~200-360
    instances and saturate; the early exit cuts some."""
    cam, g, bg = SCENES["sh0_basic"]()
    rng = np.random.default_rng(3)
    k = 6
    rep = lambda x: np.repeat(np.asarray(x), k, axis=0)     # noqa: E731
    xyz = rep(g.xyz) + rng.normal(size=(g.xyz.shape[0] * k, 3)) * 0.01
    opacity = inverse_sigmoid(jnp.asarray(rng.uniform(0.8, 0.99, (xyz.shape[0], 1))))
    return cam, g.replace(
        xyz=jnp.asarray(xyz, jnp.float32),
        scaling=jnp.asarray(rep(g.scaling) + np.log(3.0), jnp.float32),
        rotation=jnp.asarray(rep(g.rotation)), opacity=jnp.asarray(opacity, jnp.float32),
        features_dc=jnp.asarray(rep(g.features_dc)),
        features_rest=jnp.asarray(rep(g.features_rest)), alive=jnp.asarray(rep(g.alive))), bg


TRANSPOSES = {
    # transpose -> (scene, the config: the binning it needs). 'slots' runs
    # on sh0_basic grown opaque at t_cutoff 1e-2: render()'s early exit
    # against JAX's, from the same compile
    "slots": ("opaque", dict(binning="sort", layout="aligned", bwd_slots=True, t_cutoff=1e-2)),
    "grouped": ("sh0_basic", dict(binning="twotier", bwd_grouped=True, tail_r0=2,
                                  tail_k=8)),
}


def _sorted_transpose_is_slim():
    """bwd_sorted_scatter: the JAX package's transpose only reorders the
    slim one's sums, and the port runs the slim one. Its gradient against
    JAX's ``_take_packed_sorted`` VJP on a gather with repeated ids and the
    sentinel (1e-6 of the largest), and render()'s gradients under it equal
    the default's bit for bit."""
    rng = np.random.default_rng(6)
    n, m = 40, 300
    ids = rng.integers(0, n + 1, m).astype(np.int32)
    packed = rng.normal(size=(n + 1, 16)).astype(np.float32)
    g = rng.normal(size=(16, m)).astype(np.float32)
    _, vjp = jax.vjp(lambda p: _take_packed_sorted(p, ids), packed)
    ref = np.asarray(vjp(g)[0])[:n, :9]
    soa9 = t(packed[:n, :9]).requires_grad_()
    got, = torch.autograd.grad((render_mod._TakePackedSlim.apply(soa9, t(ids).long())
                                * t(g)).sum(), soa9)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6 * np.abs(ref).max())

    cam, gs, bg, n = _port_scene("sh0_basic")
    grads = []
    for cfg in (RenderConfig(instance_budget=n * 36),
                RenderConfig(instance_budget=n * 36, bwd_sorted_scatter=True)):
        leaves = {f: getattr(gs, f).clone().requires_grad_() for f in GRAD_FIELDS}
        out = render_mod.render(cam, dataclasses.replace(gs, **leaves), bg, config=cfg)
        grads.append(torch.autograd.grad(out["render"].square().sum(), list(leaves.values()),
                                         allow_unused=True))
    assert all(a is None and b is None or torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.parametrize("name", ["grouped", "slots", "sorted"])
def test_transpose_gradients_match_jax(name, monkeypatch):
    """render()'s image, transmittance (2e-4) and gradients (1e-4 of each
    field's largest, see assert_gradients_match_jax) under each transpose
    against JAX's render(impl="pallas_interpret") under the same config,
    and the transpose really ran. At t_cutoff 1e-2 ('slots') the exit cuts
    tiles of the scene and changes its image by more than 2e-4. 'sorted' is the slim
    transpose (see _sorted_transpose_is_slim)."""
    if name == "sorted":
        _sorted_transpose_is_slim()
        return
    scene, kw = TRANSPOSES[name]
    monkeypatch.setitem(SCENES, "opaque", _opaque_scene)
    cls = {"slots": "_TakePackedSlots", "grouped": "_TakePackedGrouped"}[name]
    used = []
    base = getattr(render_mod, cls)

    class Spy(base):
        @staticmethod
        def backward(ctx, g):
            used.append(name)
            return base.backward(ctx, g)

    monkeypatch.setattr(render_mod, cls, Spy)
    if kw.get("t_cutoff"):
        # the exit cuts tiles, and moves the image by more than the
        # comparison's tolerance, so the comparison tells it from none
        cam, g, bg, n = _port_scene(scene)
        cfg = RenderConfig(instance_budget=n * 36, **kw)
        seen = []
        blend = render_mod.blend_instances
        monkeypatch.setattr(render_mod, "blend_instances",
                            lambda *a, **k: seen.append(a) or blend(*a, **k))
        with torch.no_grad():
            cut = render_mod.render(cam, g, bg, config=cfg)
            exact = render_mod.render(cam, g, bg, config=dataclasses.replace(cfg, t_cutoff=0.0))
        monkeypatch.setattr(render_mod, "blend_instances", blend)
        inst, starts, _, grid = seen[0]
        assert (tblend.blend_cut(inst, starts, grid, kw["t_cutoff"]) < starts[1:]).any()
        assert (cut["render"] - exact["render"]).abs().max() > 2e-4
        assert int(cut["overflow"]) == 0
    assert_gradients_match_jax(scene, lambda n: (
        RenderConfig(instance_budget=n * 36, **kw),
        JRenderConfig(impl="pallas_interpret", kernel="instances", instance_budget=n * 36,
                      **kw)), outputs_atol=2e-4)
    assert used == [name]


# ---- the early exit of the plain blend against the Pallas kernels

CUTOFF_CASES = ("saturated", "long", "cutoff")
CUTOFFS = (1e-3, 1e-2)


@functools.cache
def _cutoff_inputs(name, layout):
    inst, starts, bg, grid = blend_case(name)
    if layout == "aligned":
        inst, starts = aligned_layout(inst, starts)
    return inst, starts, bg, grid


@functools.cache
def _cutoff_width():
    """One column count for every case and layout (zero columns past the
    last range change nothing), so one compile serves them all."""
    return max(_cutoff_inputs(n, lay)[0].shape[1] for n in CUTOFF_CASES
               for lay in ("compact", "aligned"))


@functools.cache
def _jax_cutoff_blend():
    """One jit for every cutoff: the Pallas forward (interpret) and its VJP
    at each."""
    def run(inst, starts, bg, g_img, g_tfin):
        out = {}
        for cutoff in CUTOFFS:
            res, vjp = jax.vjp(lambda a: blend_instances_pallas(a, starts, bg, (3, 4), True,
                                                                cutoff), inst)
            out[cutoff] = res, vjp((g_img, g_tfin))[0]
        return out

    return jax.jit(run)


@functools.cache
def _jax_cutoff_case(name, layout):
    """JAX's results for one case and layout at every cutoff, with the
    seeded cotangents and the inputs padded to the shared width."""
    inst, starts, bg, _ = _cutoff_inputs(name, layout)
    inst = np.pad(inst, ((0, 0), (0, _cutoff_width() - inst.shape[1])))
    rng = np.random.default_rng(5)
    g_img = rng.normal(size=(12, 3, 256)).astype(np.float32)
    g_tfin = rng.normal(size=(12, 256)).astype(np.float32)
    out = _jax_cutoff_blend()(inst, starts, bg, g_img, g_tfin)
    return inst, g_img, g_tfin, jax.tree_util.tree_map(np.asarray, out)


def _float64_cut(inst, starts, grid, cutoff):
    """The Pallas kernel's cut taken in float64: window_cut on float64
    data (the cases keep every decision far from the cutoff)."""
    x = torch.from_numpy(inst).double()
    s, e = torch.from_numpy(starts[:-1]).long(), torch.from_numpy(starts[1:]).long()
    return tblend.window_cut(x, x[9], s, e, grid, cutoff)


@pytest.mark.parametrize("cutoff", CUTOFFS)
@pytest.mark.parametrize("layout", ["compact", "aligned"])
@pytest.mark.parametrize("name", CUTOFF_CASES)
def test_cutoff_blend_matches_pallas(name, layout, cutoff):
    """The plain blend with the early exit against the Pallas kernels in
    interpret mode at the same cutoff: forward within 2e-4, backward within
    1e-3 of each row's largest element; the plain version's cut equals the
    kernel's cut taken in float64 on every tile, JAX's gradient is 0 past
    it, and, where JAX's gradient reaches into its last window, the cut
    derived from that equals it too."""
    _, starts, bg, grid = _cutoff_inputs(name, layout)
    inst, g_img, g_tfin, ref = _jax_cutoff_case(name, layout)
    (img_j, tfin_j), g_j = ref[cutoff]

    x = t(inst).requires_grad_()
    img, tfin = tblend.blend_instances(x, t(starts, torch.int32), t(bg), grid, cutoff=cutoff)
    g, = torch.autograd.grad((img * t(g_img)).sum() + (tfin * t(g_tfin)).sum(), x)
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(img_j), atol=2e-4)
    np.testing.assert_allclose(tfin.detach().numpy(), np.asarray(tfin_j), atol=2e-4)
    for row in range(9):
        np.testing.assert_allclose(g[row].numpy(), g_j[row],
                                   atol=1e-3 * np.abs(g_j[row]).max() + 1e-7,
                                   err_msg=f"row {row}")
    # the plain backward given the cut gives the gradient autograd took
    cut = tblend.blend_cut(t(inst), t(starts, torch.int32), grid, cutoff)
    explicit = tblend.blend_instances_backward_reference(
        t(inst), t(starts, torch.int32), t(bg), img.detach(), tfin.detach(), t(g_img),
        t(g_tfin), grid, cut=cut)
    assert torch.equal(explicit, g)
    cut = cut.numpy()
    np.testing.assert_array_equal(cut, _float64_cut(inst, starts, grid, cutoff).numpy())
    ends = starts[1:]
    derived = 0
    for tile in range(12):
        np.testing.assert_array_equal(g_j[:, cut[tile]:ends[tile]], 0.0)
        nz = np.flatnonzero(np.abs(g_j[:9, starts[tile]:cut[tile]]).sum(0))
        if nz.size:
            last = starts[tile] + nz[-1]
            # JAX's gradient reaches into the window that ends at the cut
            if last >= (cut[tile] - 1) // CUT_WINDOW * CUT_WINDOW:
                assert min(ends[tile], (last // CUT_WINDOW + 1) * CUT_WINDOW) == cut[tile]
                derived += 1
    assert derived >= 3
    if name != "long":
        assert (cut < ends).any(), "the exit cuts some tile"


# ---- the occupancy probe and autosize_from_trainstate


def test_occupancy_probe_matches_jax():
    """make_occupancy_probe, with the camera closed over and as an argument,
    against the JAX package's on one avatar (JAX's init under one jit with
    constant folding off: eagerly its ops compile one by one, ~6 s);
    autosize_from_trainstate gives autosize_render_config's caps."""
    flame = synthetic_flame(n_verts=96, n_shape=8, n_exp=6, seed=0)
    cfg = jfa.FateAvatarConfig(tex_size=16, capacity=512, img_height=64, img_width=64,
                               normal_offset=0.02)
    model, params, state = jax.jit(
        lambda: jfa.init_fateavatar(sphere_obj_mesh(96), flame, cfg)).lower().compile(
        {"xla_disable_hlo_passes": "constant_folding"})()
    m, p, s = _port_avatar(model, params, state)
    expr = (np.random.default_rng(4).normal(size=6) * 0.5).astype(np.float32)
    pose = np.zeros(15, np.float32)
    jcam = jcamera.make_camera(np.eye(3), np.array([0.0, 0.0, 0.4]), 0.8, 0.8, 64, 64)
    ref = [int(x) for x in jautosize.make_occupancy_probe(model, jcam)(params, state, expr,
                                                                      pose)]
    cam = tcamera.make_camera_np(np.eye(3), [0.0, 0.0, 0.4], 0.8, 0.8, 64, 64, device="cpu")
    e, q = torch.from_numpy(expr), torch.from_numpy(pose)
    closed = tautosize.make_occupancy_probe(m, cam)(p, s, e, q)
    passed = tautosize.make_occupancy_probe(m)(p, s, e, q, cam)
    assert list(closed) == list(passed) == ref and ref[0] > 0
    frame = SimpleNamespace(expression=e, flame_pose=q, camera=cam)
    base = RenderConfig(binning="twotier")
    assert (tautosize.autosize_from_trainstate(m, SimpleNamespace(params=p, state=s), frame,
                                               base)
            == tautosize.autosize_render_config(m, p, s, frame, base))
