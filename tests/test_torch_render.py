"""The PyTorch port's rasterizer against the JAX package, on the CPU:
instance binning (bit-exact), the plain instance blend and its backward
against the Pallas kernels in interpret mode, and ``render()`` and its
gradients against the recorded golden scenes and JAX. The CUDA kernels
themselves are held against their plain versions on the card by
tests/test_torch_cuda.py."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_scenes import SCENES
from torch_blend_cases import blend_case
from torch_single_thread import one_torch_thread  # noqa: F401 (autouse fixture)
from fateavatar_tpu.render import binning as jbinning
from fateavatar_tpu.render.blend_instances import blend_instances_pallas
from fateavatar_tpu.render.render import RenderConfig as JRenderConfig
from fateavatar_tpu.render.render import render as jrender

from fateavatar_tpu_torch.ops.camera import Camera
from fateavatar_tpu_torch.render import binning as tbinning
from fateavatar_tpu_torch.render import blend_instances as tblend
from fateavatar_tpu_torch.render.render import RenderConfig, render
from fateavatar_tpu_torch.render.splats import make_gaussians

GOLD_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _binning_inputs(n, seed, grid):
    """A screen-space scene: means partly off screen, bit-equal depth ties,
    invisible splats, and a heavy tail of large radii."""
    ty, tx = grid
    rng = np.random.default_rng(seed)
    mx = rng.uniform(-20, tx * 16 + 20, n).astype(np.float32)
    my = rng.uniform(-20, ty * 16 + 20, n).astype(np.float32)
    depth = rng.choice(rng.uniform(0.3, 3.0, n // 3), n).astype(np.float32)
    radius = rng.integers(1, 12, n).astype(np.int32)
    radius[rng.random(n) < 0.1] = 0
    radius[rng.random(n) < 0.05] = rng.integers(30, 90)
    return mx, my, depth, radius


BINNING_CASES = {
    # (sort_mode, R, budget, tail_r0, tail_k[, layout and options])
    "onesort": ("onesort", 16, 0, 4, 0),
    "onesort_over_budget": ("onesort", 16, 300, 4, 0),
    "onesort_r_cap_drops": ("onesort", 4, 0, 4, 0),
    "onesort_budget_above_nr": ("onesort", 4, 2000, 4, 0),
    "onesort_aligned_slots_over_budget": ("onesort", 16, 300, 4, 0,
                                          dict(layout="aligned", return_slots=True)),
    "onesort_aligned_groups_over_budget": ("onesort", 16, 300, 4, 0,
                                           dict(layout="aligned", return_groups=True)),
    "stable_aligned_slots_over_budget": ("stable", 16, 300, 4, 0,
                                         dict(layout="aligned", return_slots=True)),
    "twokey_over_budget": ("twokey", 16, 300, 4, 0),
    "twotier": ("twotier", 64, 0, 4, 0),
    "twotier_tail_drops": ("twotier", 64, 0, 2, 8),
    "twotier_over_budget": ("twotier", 32, 250, 4, 16),
}


@pytest.mark.parametrize("case", sorted(BINNING_CASES))
def test_build_instance_lists_matches_jax_exactly(case):
    mode, R, budget, r0, k, *opts = BINNING_CASES[case]
    opts = {"layout": "compact", **(opts[0] if opts else {})}
    grid = (5, 6)
    mx, my, depth, radius = _binning_inputs(400, seed=len(case), grid=grid)
    if mode == "twokey":
        # the JAX package's twokey sort is unstable: distinct depths only
        depth = np.random.default_rng(len(case)).permutation(
            np.linspace(0.3, 3.0, depth.size, dtype=np.float32))
    ref = jbinning.build_instance_lists(
        (mx, my), depth, radius, grid, max_tiles_per_gaussian=R,
        instance_budget=budget, chunk=128, sort_mode=mode, tail_r0=r0, tail_k=k, **opts)
    out = tbinning.build_instance_lists(
        t(mx), t(my), t(depth), t(radius, torch.int32), grid,
        max_tiles_per_gaussian=R, instance_budget=budget, chunk=128, sort_mode=mode,
        tail_r0=r0, tail_k=k, **opts)
    for f in ("instances", "tile_starts", "slots", "group_counts"):
        a, b = getattr(out, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == torch.int32, f
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    assert int(out.overflow) == int(ref.overflow)
    if "over_budget" in case or "drops" in case:
        assert int(ref.overflow) > 0


def test_compact_candidates_plain_matches_the_expansion():
    """compact_candidates' plain version against the [N, R] expansion it
    replaces, written out here: every candidate's tile by the float walk,
    the kept ones taken in (depth rank, r) order, then sentinels. One budget
    cuts inside a splat's candidates, one lies past them all."""
    grid, R = (5, 6), 16
    mx, my, depth, radius = (torch.as_tensor(x) for x in _binning_inputs(400, 7, grid))
    order = tbinning._depth_order(depth, radius > 0)
    rmin_x, rmin_y, rmax_x, rmax_y = tbinning.gaussian_rect(
        mx[order], my[order], radius[order], grid)
    w = torch.clamp_min(rmax_x - rmin_x, 1)
    touched = torch.where(radius[order] > 0, (rmax_x - rmin_x) * (rmax_y - rmin_y), 0)
    touched = torch.clamp_max(touched, R).to(torch.int32)
    offsets = (torch.cumsum(touched, 0) - touched).to(torch.int32)
    assert int(touched[200]) > 1
    r = torch.arange(R, dtype=torch.int32)[None, :]
    tile_all = tbinning._rect_walk(r, w[:, None], rmin_x[:, None], rmin_y[:, None], grid[1])
    gauss_all = order.to(torch.int32)[:, None].expand(-1, R)
    for budget in (int(offsets[200]) + 1, int(touched.sum()) + 7):
        tiles, gauss = tbinning.compact_candidates(rmin_x, rmin_y, w, touched, offsets,
                                                   order, budget, grid[1], 30, R)
        keep = ((r < touched[:, None]) & (offsets[:, None] + r < budget)).reshape(-1)
        pad = budget - int(keep.sum())
        want_t = torch.cat([tile_all.reshape(-1)[keep], torch.full((pad,), 30)])
        want_g = torch.cat([gauss_all.reshape(-1)[keep], torch.full((pad,), -1)])
        assert tiles.dtype == gauss.dtype == torch.int32
        assert torch.equal(tiles, want_t.to(torch.int32)), budget
        assert torch.equal(gauss, want_g.to(torch.int32)), budget


def test_rect_walk_float_formula_equals_integer_division():
    """The compaction kernel walks a rect with integer division; the JAX
    package (and the twotier tiers) with floor((r + 0.5) * (1 / w)) in
    float32. Equal at every r < 4,096 and every width up to 128 tiles (a
    512x512 frame's grid is 32 wide, R at most 1,024)."""
    r = torch.arange(4096, dtype=torch.int32)[None, :]
    w = torch.arange(1, 129, dtype=torch.int32)[:, None]
    zero = torch.zeros_like(w)
    walk = tbinning._rect_walk(r, w, zero, zero, 1 << 12)
    q = torch.div(r, w, rounding_mode="floor")
    assert torch.equal(walk, q * (1 << 12) + r - q * w)


def test_autosize_matches_jax():
    """occupancy_stats on a screen-space scene and size_caps /
    the pow2 rule of autosize_render_config, exactly as the JAX package
    computes them."""
    from fateavatar_tpu.render import autosize as jautosize
    from fateavatar_tpu_torch.render import autosize as tautosize

    grid = (5, 6)
    mx, my, depth, radius = _binning_inputs(400, seed=3, grid=grid)
    ref = jautosize.occupancy_stats((mx, my), depth, radius, grid, r0=4)
    got = tautosize.occupancy_stats((t(mx), t(my)), t(depth), t(radius, torch.int32),
                                    grid, r0=4)
    assert [int(x) for x in got] == [int(x) for x in ref]
    assert int(ref[2]) > 0
    for total, max_t, big in ((1000, 7, 12), (90000, 31, 700)):
        jc = jautosize.size_caps(total, max_t, 4096, 30, JRenderConfig(binning="twotier"),
                                 big_count=big)
        tc = tautosize.size_caps(total, max_t, 4096, 30, RenderConfig(binning="twotier"),
                                 big_count=big)
        assert (tc.instance_budget, tc.max_tiles_per_gaussian, tc.tail_k) == (
            jc.instance_budget, jc.max_tiles_per_gaussian, jc.tail_k)
    assert [tautosize._pow2ceil(x) for x in (1, 3, 64, 65)] == [1, 4, 64, 128]


def test_unported_binning_raises():
    """The refusals the JAX package keeps (binning.py:393-394, 584-587,
    607-608): slots with 'twotier' or the compact layout, groups outside
    'onesort' / 'twotier'; and an unknown sort_mode raises ValueError (the
    JAX package fails there with a NameError)."""
    args = (t([1.0]), t([1.0]), t([1.0]), t([2], torch.int32), (1, 1))
    for kw in (dict(sort_mode="twotier", layout="aligned", return_slots=True),
               dict(sort_mode="stable", layout="compact", return_slots=True),
               dict(sort_mode="onesort", layout="compact", return_slots=True),
               dict(sort_mode="stable", return_groups=True),
               dict(sort_mode="twokey", return_groups=True)):
        with pytest.raises(NotImplementedError):
            tbinning.build_instance_lists(*args, **kw)
    with pytest.raises(ValueError):
        tbinning.build_instance_lists(*args, sort_mode="radix")


@pytest.mark.parametrize("name", ["empty", "long", "saturated"])
def test_plain_blend_matches_pallas_interpret(name):
    """Tolerance 2e-4: the two take the transmittance product in another
    order (sequential vs exp(cumsum(log))), which can flip which instance
    crosses T = 1e-4 at a pixel; that moves the pixel by at most
    alpha * T <= 1e-4."""
    inst, starts, bg, grid = blend_case(name)
    img_j, tfin_j = blend_instances_pallas(inst, starts, bg, grid, True)
    img_t, tfin_t = tblend.blend_instances(t(inst), t(starts, torch.int32), t(bg), grid)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=2e-4)
    np.testing.assert_allclose(tfin_t.numpy(), np.asarray(tfin_j), atol=2e-4)
    if name == "saturated":
        assert (np.asarray(tfin_j) < 1e-3).mean() > 0.2
    if name == "empty":
        empty = np.diff(starts) == 0
        np.testing.assert_array_equal(tfin_t.numpy()[empty], 1.0)


def test_evaluated_pairs_counts_until_termination():
    inst, starts, bg, grid = blend_case("saturated")
    pairs, blended = tblend.pair_counts(t(inst), t(starts, torch.int32), grid)
    upper = int(np.sum(np.diff(starts))) * 256
    assert 0 < blended < pairs < upper


def test_blend_refuses_grad_and_bad_inputs():
    """The grad path on the CPU: autograd through blend_instances runs the
    plain backward (no launch is counted) and reaches the instance data and
    bg; malformed inputs still raise ValueError."""
    inst, starts, bg, grid = blend_case("empty")
    x, b = t(inst).requires_grad_(), t(bg).requires_grad_()
    before = tblend.blend_instances_bwd.launches
    img, tfin = tblend.blend_instances(x, t(starts, torch.int32), b, grid)
    gx, gb = torch.autograd.grad(img.sum() + tfin.sum(), (x, b))
    assert tblend.blend_instances_bwd.launches == before
    assert torch.isfinite(gx).all() and gx[:9].abs().max() > 0 and gb.abs().max() > 0
    with pytest.raises(ValueError):
        tblend.blend_instances(t(inst), t(starts, torch.int64), t(bg), grid)
    with pytest.raises(ValueError):
        tblend.blend_instances(t(inst[:9]), t(starts, torch.int32), t(bg), grid)


def _cotangents(grid, seed=5):
    n = grid[0] * grid[1]
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3, 256)).astype(np.float32),
            rng.normal(size=(n, 256)).astype(np.float32))


def _assert_rows_close(got, ref, rtol):
    """Gradient rows 0-8 each within ``rtol`` of the row's largest element;
    rows 9-15 and the columns past the last range exactly 0."""
    for row in range(9):
        np.testing.assert_allclose(got[row], ref[row],
                                   atol=rtol * np.abs(ref[row]).max() + 1e-7,
                                   err_msg=f"row {row}")
    np.testing.assert_array_equal(got[9:], 0.0)


@pytest.mark.parametrize("name", ["empty", "long", "saturated"])
def test_plain_backward_matches_pallas_interpret(name):
    """blend_instances_backward_reference against jax.vjp of the Pallas
    kernel (interpret mode), g_bg against _vjp_bwd's einsum. Tolerance 5e-5
    of each row's largest element: the two sum each instance's 256 pixel
    terms and the prefix pu in another order and take the transmittance
    product another way (measured <= 7e-6)."""
    inst, starts, bg, grid = blend_case(name)
    g_img, g_tfin = _cotangents(grid)
    (img_j, tfin_j), vjp = jax.vjp(
        lambda a, b: blend_instances_pallas(a, starts, b, grid, True), inst, bg)
    g_inst_j, g_bg_j = vjp((g_img, g_tfin))
    ts = t(starts, torch.int32)
    img, tfin = tblend.blend_instances_reference(t(inst), ts, t(bg), grid)
    got = tblend.blend_instances_backward_reference(
        t(inst), ts, t(bg), img, tfin, t(g_img), t(g_tfin), grid).numpy()
    _assert_rows_close(got, np.asarray(g_inst_j), 5e-5)
    np.testing.assert_array_equal(got[:, starts[-1]:], 0.0)
    g_bg = torch.einsum("tdp,tp->d", t(g_img), tfin).numpy()
    np.testing.assert_allclose(g_bg, np.asarray(g_bg_j), rtol=1e-5)


@pytest.mark.parametrize("name", ["empty", "long", "saturated"])
def test_plain_backward_matches_autograd(name):
    """An independent check: torch.autograd through the plain forward
    (straight-through 0.99 clamp) gives the same g_inst and g_bg as the
    hand-derived backward. Tolerance 5e-5 of each row's largest element
    (autograd sums the cumulative products' gradients in another order)."""
    inst, starts, bg, grid = blend_case(name)
    g_img, g_tfin = _cotangents(grid)
    x, b = t(inst).requires_grad_(), t(bg).requires_grad_()
    ts = t(starts, torch.int32)
    img, tfin = tblend.blend_instances_reference(x, ts, b, grid)
    ga, gba = torch.autograd.grad((img * t(g_img)).sum() + (tfin * t(g_tfin)).sum(), (x, b))
    y, c = t(inst).requires_grad_(), t(bg).requires_grad_()
    img2, tfin2 = tblend.blend_instances(y, ts, c, grid)
    gk, gbk = torch.autograd.grad((img2 * t(g_img)).sum() + (tfin2 * t(g_tfin)).sum(), (y, c))
    _assert_rows_close(gk.numpy(), ga.numpy(), 5e-5)
    np.testing.assert_allclose(gbk.numpy(), gba.numpy(), rtol=1e-5)
    if name == "saturated":   # the 0.99 clamp is active and passed straight through
        assert (inst[8] > 0.99).any()


def _port_scene(name):
    cam, g, bg = SCENES[name]()
    tcam = Camera(view=t(cam.view), proj=t(cam.proj), full_proj=t(cam.full_proj),
                  campos=t(cam.campos), fovx=t(cam.fovx), fovy=t(cam.fovy),
                  width=cam.width, height=cam.height)
    tg = make_gaussians(np.asarray(g.xyz), np.asarray(g.scaling),
                        np.asarray(g.rotation), np.asarray(g.opacity),
                        np.asarray(g.features_dc), np.asarray(g.features_rest),
                        np.asarray(g.alive), sh_degree=g.sh_degree, device="cpu")
    return tcam, tg, t(bg), g.xyz.shape[0]


def assert_matches_golden(name, config_of):
    """render() under ``config_of(N)`` reproduces the recorded golden scene
    ``name`` (N splats) at the golden suite's own tolerance (atol 5e-5),
    radii exact, nothing dropped."""
    cam, g, bg, n = _port_scene(name)
    out = render(cam, g, bg, config=config_of(n))
    gold = np.load(os.path.join(GOLD_DIR, f"{name}.npz"))
    np.testing.assert_allclose(out["render"].numpy(), gold["render"], atol=5e-5)
    np.testing.assert_allclose(out["t_final"].numpy(), gold["t_final"], atol=5e-5)
    np.testing.assert_array_equal(out["radii"].numpy(), gold["radii"])
    assert int(out["overflow"]) == 0


@pytest.mark.parametrize("binning", ["onesort", "twotier"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_matches_goldens(name, binning):
    """The port's render() reproduces every recorded golden scene at the
    golden suite's own tolerance (atol 5e-5), radii exact."""
    assert_matches_golden(name, lambda n: RenderConfig(
        instance_budget=n * 36, binning=binning, tail_r0=4, tail_k=n))


def test_render_refuses_unported_options():
    """render() refuses only what the JAX package's render() refuses: an
    unknown ``kernel``. The aligned layout and a t_cutoff above 1e-4 render
    (tests/test_torch_render_options.py holds them against JAX)."""
    cam, g, bg, n = _port_scene("sh0_basic")
    with pytest.raises(NotImplementedError):
        render(cam, g, bg, config=RenderConfig(kernel="dense"))
    for cfg in (RenderConfig(layout="aligned"), RenderConfig(t_cutoff=2e-4),
                RenderConfig(binning="scan")):
        assert torch.isfinite(render(cam, g, bg, config=cfg)["render"]).all()


GRAD_FIELDS = ("xyz", "scaling", "rotation", "opacity", "features_dc", "features_rest")


def assert_gradients_match_jax(name, configs_of, outputs_atol=None):
    """Gradients of render() (image and transmittance against seeded
    cotangents) w.r.t. every Gaussian attribute and the screen-space probe,
    on golden scene ``name`` of N splats: the port under ``cfg`` against
    JAX's render() under ``jcfg``, ``(cfg, jcfg) = configs_of(N)``.
    Tolerance 1e-4 of each field's largest element: the blend backward
    matches to ~1e-6 relative, and the gather's scatter-add and
    preprocess's backward sum in another order. With ``outputs_atol`` the
    image and transmittance are held against JAX's too, from the same
    compile."""
    cam, g, bg = SCENES[name]()
    n = g.xyz.shape[0]
    cfg, jcfg = configs_of(n)
    rng = np.random.default_rng(9)
    g_img = rng.normal(size=(cam.height, cam.width, 3)).astype(np.float32)
    g_t = rng.normal(size=(cam.height, cam.width)).astype(np.float32)

    def jloss(xyz, scaling, rotation, opacity, features_dc, features_rest, probe):
        gs = g.replace(xyz=xyz, scaling=scaling, rotation=rotation, opacity=opacity,
                       features_dc=features_dc, features_rest=features_rest)
        out = jrender(cam, gs, bg, config=jcfg, means2d_probe=probe)
        return (jnp.sum(out["render"] * g_img) + jnp.sum(out["t_final"] * g_t),
                (out["render"], out["t_final"]))

    jargs = [getattr(g, f) for f in GRAD_FIELDS] + [jnp.zeros((2, n), jnp.float32)]
    jgrads, jouts = jax.jit(jax.grad(jloss, argnums=tuple(range(7)), has_aux=True))(*jargs)

    tcam, tg, tbg, _ = _port_scene(name)
    leaves = {f: getattr(tg, f).clone().requires_grad_() for f in GRAD_FIELDS}
    probe = torch.zeros((2, n), requires_grad=True)
    gs = dataclasses.replace(tg, **leaves)
    out = render(tcam, gs, tbg, config=cfg, means2d_probe=probe)
    if outputs_atol is not None:
        for k, ref in zip(("render", "t_final"), jouts):
            np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(ref),
                                       atol=outputs_atol, err_msg=k)
    loss = (out["render"] * t(g_img)).sum() + (out["t_final"] * t(g_t)).sum()
    tgrads = torch.autograd.grad(loss, [*leaves.values(), probe], allow_unused=True)
    for f, got, ref in zip(GRAD_FIELDS + ("probe",), tgrads, jgrads):
        ref = np.asarray(ref).reshape(-1)
        if ref.size == 0:      # SH degree 0 keeps no rest coefficient
            continue
        got = np.zeros_like(ref) if got is None else got.numpy().reshape(-1)
        assert np.abs(ref).max() > 0, f
        np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max() + 1e-9,
                                   err_msg=f)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_gradients_match_jax(name):
    """render()'s gradients on each golden scene against JAX through the
    Pallas instance kernel (interpret), twotier binning (see
    assert_gradients_match_jax for the tolerance)."""
    assert_gradients_match_jax(name, lambda n: (
        RenderConfig(instance_budget=n * 36, binning="twotier", tail_r0=4, tail_k=n),
        JRenderConfig(impl="pallas_interpret", kernel="instances", binning="twotier",
                      instance_budget=n * 36, tail_r0=4, tail_k=n)))
