"""The port's multi-device training against the JAX package, on the CPU:
``parallel/splat_parallel``, ``parallel/data_parallel`` and
``parallel/mesh2d`` run in gloo ranks spawned from this process
(``tests/torch_parallel_workers.py``) against the JAX package's modules on
virtual CPU devices; the Trainer's data-parallel epoch with tracking, a
FlashAvatar data-parallel step and epoch, and ``train_mono_avatar --dp 2``
resumed by a single-process run and the other way round.

Sizes: 64x64 frames, 128 splats (a tex-8 avatar at capacity 128, or
``tests/test_splat_parallel.py``'s scene); JAX renders through its XLA
tile blend (``impl="xla"``), the port through the dense-list route's plain
blend (``kernel="tiles"``). Each parallel module compiles JAX once, in a
module fixture; the ranks run in two spawns (world 4 and world 2), whose
results the tests share."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from test_splat_parallel import make_scene
from test_torch_model import np_dict, perturb
from test_torch_tracking import REPO, _cli_assets
from torch_parallel_workers import _flash, finish, start
from torch_single_thread import one_torch_thread  # noqa: F401 (autouse fixture)
from fateavatar_tpu.flame import synthetic_flame
from fateavatar_tpu.models import fateavatar as jfa
from fateavatar_tpu.ops.camera import make_camera as jmake_camera
from fateavatar_tpu.parallel import data_parallel as jdp
from fateavatar_tpu.parallel import mesh2d as jmesh2d
from fateavatar_tpu.parallel.splat_parallel import render_splat_sharded
from fateavatar_tpu.render.render import RenderConfig as JRenderConfig
from fateavatar_tpu.train import losses as jl
from fateavatar_tpu.train import optim as jopt
from fateavatar_tpu.train import step as jstep
from fateavatar_tpu.utils.obj_io import sphere_obj_mesh

from fateavatar_tpu_torch import convert
from fateavatar_tpu_torch.cli import train_mono_avatar
from fateavatar_tpu_torch.parallel.data_parallel import stack_frames
from fateavatar_tpu_torch.train import tracking as ttracking

RES, NV, TEX, CAP = 64, 96, 8, 128
W_SCENE = 64
SHARD_KW = dict(max_per_tile=128, pair_budget=128 * 16, chunk=32)
LOSS_CFG = dict(rgb_weight=1.0, scale_weight=0.1)
# the meshes' caps: no instance is dropped
MESH_KW = dict(max_per_tile=128, chunk=32, pair_budget=2048)
MESH2D_LOSS = dict(rgb_weight=1.0, dssim_weight=0.25, scale_weight=0.1)
DENSIFY_SRC = [3, 70, 70, 120]     # injected densify sources (global ids)
MAINT_DUE = dict(densify_interval=2, prune_interval=2, opacity_reset_interval=10**9,
                 increase_num=8, max_points_num=CAP)


def _weights(shape):
    return np.linspace(0, 1, int(np.prod(shape)), dtype=np.float32).reshape(shape)


def _scene_np(g):
    return {k: np.asarray(getattr(g, k)) for k in
            ("xyz", "scaling", "rotation", "opacity", "features_dc")}


def _frames(seed=3, n=2):
    rng = np.random.default_rng(seed)
    return [dict(expression=(rng.normal(size=4) * 0.2).astype(np.float32),
                 flame_pose=(rng.normal(size=15) * 0.05).astype(np.float32),
                 T=np.array([0.0, 0.0, 0.4], np.float32), fov=np.float32(0.8),
                 rgb=rng.random((RES, RES, 3)).astype(np.float32)) for _ in range(n)]


def _jframes(frames):
    fs = [jstep.Frame(expression=jnp.asarray(f["expression"]),
                      flame_pose=jnp.asarray(f["flame_pose"]),
                      camera=jmake_camera(jnp.eye(3), jnp.asarray(f["T"]), f["fov"], f["fov"],
                                          RES, RES),
                      rgb=jnp.asarray(f["rgb"]), bg_color=jnp.ones(3)) for f in frames]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *fs)


@pytest.fixture(scope="module")
def avatar():
    flame = synthetic_flame(n_verts=NV, n_shape=6, n_exp=4, seed=0)
    cfg = jfa.FateAvatarConfig(tex_size=TEX, capacity=CAP, img_height=RES, img_width=RES,
                               normal_offset=0.02)
    model, params, state = jfa.init_fateavatar(sphere_obj_mesh(NV), flame, cfg)
    params = params.replace(**perturb(np_dict(params), seed=1))
    opt = jopt.fateavatar_optimizers({})
    return model, jstep.init_train_state(params, state, opt), opt


# ---------------------------------------------------------------------------
# the JAX references, one compile per module
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    cam, g, bg = make_scene(128)
    return cam, g, bg


@pytest.fixture(scope="module")
def jax_sharded(scene):
    """JAX's render_splat_sharded on 4 virtual devices: the image, the
    dropped count and the gradients of sum(image * weights)."""
    cam, g, bg = scene
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("gauss",))
    w = jnp.asarray(_weights((W_SCENE, W_SCENE, 3)))
    names = ("xyz", "scaling", "rotation", "opacity", "features_dc")
    gs = jax.device_put(g, NamedSharding(mesh, P("gauss")))

    def loss(leaves):
        img, dropped = render_splat_sharded(cam, gs.replace(**dict(zip(names, leaves))), bg,
                                            mesh, **SHARD_KW)
        return jnp.sum(img * w), (img, dropped)

    (_, (img, dropped)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        tuple(getattr(gs, k) for k in names))
    return dict(image=np.asarray(img), dropped=int(dropped),
                grads={k: np.asarray(v) for k, v in zip(names, grads)})


@pytest.fixture(scope="module")
def jax_dp(avatar):
    """JAX's make_dp_train_step at B = 2 on 2 virtual devices (no
    maintenance)."""
    model, ts, opt = avatar
    mesh = jdp.make_device_mesh(2)
    step = jdp.make_dp_train_step(
        model, jl.FateAvatarLoss(jl.FateAvatarLossConfig(**LOSS_CFG)), opt, mesh,
        jstep.MaintenanceConfig(densify_interval=10**9, prune_interval=10**9,
                                opacity_reset_interval=10**9),
        JRenderConfig(impl="xla", max_per_tile=128, chunk=32), enable_maintenance=False)
    ts1, aux = step(jdp.replicate(jax.tree.map(jnp.copy, ts), mesh),
                    jdp.shard_frames(_jframes(_frames()), mesh))
    return dict(loss=float(aux["loss"]), ts1=jax.tree.map(np.asarray, ts1))


@pytest.fixture(scope="module")
def jax_mesh2d(avatar):
    """JAX's 2x2 mesh step with return_grads (DSSIM on)."""
    model, ts, opt = avatar
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "gauss"))
    step = jmesh2d.make_mesh2d_train_step(model, opt, mesh, return_grads=True,
                                          **MESH_KW, **MESH2D_LOSS)
    batch = jax.device_put(_jframes(_frames()), NamedSharding(mesh, P("data")))
    ts1, aux = step(jmesh2d.place_mesh2d(jax.tree.map(jnp.copy, ts), mesh), batch)
    return dict(loss=float(aux["loss"]), overflow=int(aux["overflow"]),
                grads=np_dict(jax.device_get(aux["grads"])),
                probe=np.asarray(aux["probe_grad"]),
                state=np_dict(jax.device_get(ts1.state)))


# ---------------------------------------------------------------------------
# the ranks: two spawns, started before JAX compiles its references
# ---------------------------------------------------------------------------

def _cli_args(ws):
    root = _cli_assets(ws)
    run = os.path.join(ws, "run")
    return run, ["--config", os.path.join(REPO, "configs", "fateavatar.yaml"),
                 "--device", "cpu", f"dataset.root_path={root}", f"workspace={run}",
                 "training.epochs.finetune=1", "training.snapshot_interval=4",
                 f"assets.flame_model_path={ws}/flame.pkl",
                 f"assets.template_mesh_path={ws}/head.obj", "dataset.img_res=[32,32]",
                 "model.tex_size=8", "training.max_points_num=128", "loss.vgg_weight=0",
                 "render.max_tiles_per_gaussian=16"]


@pytest.fixture(scope="module")
def ranks(avatar, scene, tmp_path_factory):
    """Both spawns, running while the JAX references compile."""
    model, ts, _ = avatar
    cam, g, bg = scene
    model_np, ts_np = np_dict(model), np_dict(jax.tree.map(np.asarray, ts))
    tasks4 = [
        ("render_shard", dict(scene=_scene_np(g), res=W_SCENE, fov=0.9, bg=np.asarray(bg),
                              weights=_weights((W_SCENE, W_SCENE, 3)), **SHARD_KW)),
        ("mesh2d_step", dict(model=model_np, ts=ts_np, frames=_frames(), res=RES, data=2,
                             step_kw=dict(**MESH_KW, **MESH2D_LOSS),
                             densify_src=DENSIFY_SRC)),
        ("trainer_dp_tracking", dict(res=32, n_frames=10)),
        ("collectives_grads", {}),
    ]
    run, args = _cli_args(str(tmp_path_factory.mktemp("cli")))
    tasks2 = [
        ("dp_step", dict(model=model_np, ts=ts_np, frames=_frames(), res=RES,
                         loss_cfg=LOSS_CFG,
                         render_kw=dict(kernel="tiles", max_per_tile=128, chunk=32),
                         maint=MAINT_DUE)),
        ("flash_dp", dict(res=32, n_frames=3)),
        ("cli_dp", dict(args=args)),
    ]
    return {4: start(tasks4, 4, tmp_path_factory.mktemp("world4")),
            2: start(tasks2, 2, tmp_path_factory.mktemp("world2")),
            "cli": (run, args)}


@pytest.fixture(scope="module")
def world4(ranks, jax_sharded, jax_dp, jax_mesh2d):
    return finish(ranks[4])


@pytest.fixture(scope="module")
def world2(ranks, jax_sharded, jax_dp, jax_mesh2d):
    return finish(ranks[2])


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def test_collectives_and_their_gradients(world4):
    """At world 4, x_r = 100 r + [0..11] as [4, 3], rank r's loss
    sum(out * (r + 1)): all_to_all gives rank r the rows r of every rank
    and x_r's gradient row d is (d + 1), the reverse exchange;
    all_reduce_sum gives every rank the sum and x_r the sum of all the
    ranks' cotangents (10); all_gather gives every rank the 4 tensors in
    rank order and x_r the summed cotangents of its own slice (10)."""
    W = len(world4)
    base = np.arange(W * 3, dtype=np.float64).reshape(W, 3)
    for r, res in enumerate(world4):
        c = res["collectives_grads"]
        y, g = c["all_to_all"]
        np.testing.assert_array_equal(y, np.stack([base[r] + 100.0 * s for s in range(W)]))
        np.testing.assert_array_equal(g, np.repeat(np.arange(1.0, W + 1)[:, None], 3, 1))
        y, g = c["all_reduce_sum"]
        np.testing.assert_array_equal(y, W * base + 100.0 * sum(range(W)))
        np.testing.assert_array_equal(g, np.full_like(base, sum(range(1, W + 1))))
        y, g = c["all_gather"]
        np.testing.assert_array_equal(y, np.concatenate([base + 100.0 * s for s in range(W)]))
        np.testing.assert_array_equal(g, np.full_like(base, sum(range(1, W + 1))))


# ---------------------------------------------------------------------------
# splat-sharded rendering
# ---------------------------------------------------------------------------

def test_render_splat_sharded_matches_jax(world4, jax_sharded):
    """render_splat_sharded at world 4 against JAX's on 4 virtual devices:
    the image on every rank within 5e-5, no instance dropped on either
    side."""
    assert jax_sharded["dropped"] == 0
    for r in world4:
        res = r["render_shard"]
        np.testing.assert_allclose(res["image"], jax_sharded["image"], atol=5e-5)
        assert res["dropped"] == jax_sharded["dropped"]
    assert jax_sharded["image"].std() > 0.01


def test_render_splat_sharded_gradients_match_jax(world4, jax_sharded):
    """The gradients of sum(image * weights) through the all-gather, the
    reverse all-to-all and the dense blend's backward, each rank's shard
    concatenated: within 1e-4 of each field's largest element of JAX's."""
    for k, want in jax_sharded["grads"].items():
        got = np.concatenate([r["render_shard"]["grads"][k] for r in world4])
        assert np.abs(want).max() > 0, k
        np.testing.assert_allclose(got.reshape(want.shape), want,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)


# ---------------------------------------------------------------------------
# the data-parallel step
# ---------------------------------------------------------------------------

DP_PARTS = ("loss", "stats", "params", "replicas", "rank_draws")


@pytest.mark.parametrize("part", DP_PARTS)
def test_dp_step_matches_jax(world2, jax_dp, part):
    """make_dp_train_step at B = 2 against JAX's on 2 devices, from the same
    state: the loss within 1e-5 relative; the densify statistics within
    1e-4 of each field's largest (max radii exact); the parameters after
    the step within 1e-2 lr on all but 0.5% of the elements and within
    Adam's bound everywhere (Adam on float32 noise, ROADMAP Queue 3); the
    replicas bit-identical after the step and after a step that densifies
    and prunes; "rank_draws": bit-identical after a densify whose
    generators were seeded apart on the two ranks (every rank takes rank
    0's draws)."""
    r0 = world2[0]["dp_step"]
    if part == "loss":
        for r in world2:
            np.testing.assert_allclose(r["dp_step"]["loss"], jax_dp["loss"], rtol=1e-5)
        assert r0["overflow"] == 0
    elif part == "stats":
        for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
            want = np.asarray(getattr(jax_dp["ts1"].state, k))
            assert np.abs(want).max() > 0, k
            np.testing.assert_allclose(r0["state"][k], want,
                                       atol=1e-4 * np.abs(want).max(), err_msg=k)
        np.testing.assert_array_equal(r0["state"]["max_radii2d"],
                                      np.asarray(jax_dp["ts1"].state.max_radii2d))
    elif part == "params":
        lrs = jopt.fateavatar_optimizers({}).lr_tree
        for k, got in r0["params"].items():
            d = np.abs(got - np.asarray(getattr(jax_dp["ts1"].params, k)))
            assert (d <= 2 * lrs[k] + 1e-6).all(), k
            assert (d > 1e-2 * lrs[k] + 1e-6).mean() < 0.005, k
        assert r0["count"] == int(jax_dp["ts1"].opt_state.count) == 1
    elif part == "replicas":
        for i in range(2):
            assert len(set(r0["digests"][i])) == 1, r0["digests"]
        a1, a2, _ = r0["alive"]
        assert a2 != a1      # the second step densified (and pruned)
        assert np.isfinite(r0["loss2"])
    else:
        assert len(set(r0["digests"][2])) == 1, r0["digests"]
        assert r0["alive"][2] == r0["alive"][1] + MAINT_DUE["increase_num"]


# ---------------------------------------------------------------------------
# the 2-D mesh
# ---------------------------------------------------------------------------

def _gathered(world4, key, field):
    """A sharded field gathered over the gauss ranks of data row 0."""
    by = {r["mesh2d_step"]["coords"]: r["mesh2d_step"] for r in world4}
    return np.concatenate([by[(0, g)][key][field] for g in range(2)])


def test_mesh2d_step_matches_jax(world4, jax_mesh2d):
    """The 2x2 mesh step with return_grads (L1, scale, DSSIM on the gathered
    image) against JAX's on a 2x2 virtual mesh: the loss within 2e-4
    relative on every rank, no overflow, every gathered gradient within
    1e-4 of its field's largest element, the probe gradients and the
    accumulated statistics likewise."""
    for r in world4:
        np.testing.assert_allclose(r["mesh2d_step"]["loss"], jax_mesh2d["loss"], rtol=2e-4)
        assert r["mesh2d_step"]["overflow"] == jax_mesh2d["overflow"] == 0
    for k, want in jax_mesh2d["grads"].items():
        got = (world4[0]["mesh2d_step"]["grads"][k] if k.startswith("delta")
               else _gathered(world4, "grads", k))
        if k != "features_rest":
            assert np.abs(want).max() > 0, k
        np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max() + 1e-12,
                                   err_msg=k)
    by = {r["mesh2d_step"]["coords"]: r["mesh2d_step"] for r in world4}
    for d in range(2):
        got = np.concatenate([by[(d, g)]["probe_grad"] for g in range(2)], axis=1)
        want = jax_mesh2d["probe"][d]
        np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    for k in ("accum", "denom"):
        want = jax_mesh2d["state"]["xyz_gradient_accum" if k == "accum" else "denom"]
        got = np.concatenate([by[(0, g)][k] for g in range(2)])
        np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), err_msg=k)


def test_mesh2d_densify_and_tracking(world4, avatar):
    """The step's sharded densify with injected sources: each gauss shard
    writes its quota of the sources' rows (scale x0.75, same face; the
    rows as the step's Adam update left them) into its lowest dead slots,
    as many as it has, and alive grows by what was written;
    mesh2d_maintenance densifies 8 more on every rank alike, and so does
    the step's own sharded densify, each from generators seeded apart on
    the ranks (all take rank 0's draws); the tracking
    step's row update equals RowAdam on the single-device pixel-loss
    gradients of each frame."""
    r = world4[0]["mesh2d_step"]
    after, st = r["densified"], r["densified_state"]
    alive0 = np.asarray(avatar[1].state.alive)
    face0 = np.asarray(avatar[1].state.face_index)
    new = np.flatnonzero(st["alive"] & ~alive0)
    per, half = len(DENSIFY_SRC) // 2, CAP // 2
    written = 0
    for g in range(2):
        mine = new[(new >= g * half) & (new < (g + 1) * half)]
        k = min(per, int((~alive0[g * half:(g + 1) * half]).sum()))
        assert len(mine) == k and (mine == np.sort(mine)).all()
        src = DENSIFY_SRC[g * per:g * per + k]
        np.testing.assert_array_equal(st["face_index"][mine], face0[src])
        np.testing.assert_allclose(after["scaling"][mine], after["scaling"][src] + np.log(0.75),
                                   atol=1e-6)
        np.testing.assert_array_equal(after["opacity"][mine], after["opacity"][src])
        written += k
    assert written > 0 and r["num_alive"] == int(st["alive"].sum()) == alive0.sum() + written
    # mesh2d_maintenance (pruning nothing): 8 more alive, the same on every
    # rank, each holding its half
    # (generators seeded apart: the ranks take rank 0's draws), and the
    # step's own sharded densify likewise
    for other in world4:
        m = other["mesh2d_step"]
        assert m["local_n"] == CAP // 2
        np.testing.assert_array_equal(m["maintained_alive"], r["maintained_alive"])
        np.testing.assert_array_equal(m["maintained_face"], r["maintained_face"])
        for k, v in m["maintained"].items():
            np.testing.assert_array_equal(v, r["maintained"][k], err_msg=k)
        for k, v in m["own_draws"].items():
            np.testing.assert_array_equal(v, r["own_draws"][k], err_msg=k)
        for k, v in m["own_draws_state"].items():
            np.testing.assert_array_equal(v, r["own_draws_state"][k], err_msg=k)
    assert int(r["maintained_alive"].sum()) == int(st["alive"].sum()) + 8
    # (each shard writes its quota into the dead slots it has)
    assert int(r["own_draws_state"]["alive"].sum()) > int(r["maintained_alive"].sum())
    for other in world4[1:]:
        np.testing.assert_array_equal(other["mesh2d_step"]["track"]["expression"],
                                      r["track"]["expression"])
    assert (r["track_count"] == 1).all() and np.isfinite(r["track_loss"])
    _check_tracking_rows(r, avatar)


def _check_tracking_rows(r, avatar):
    from fateavatar_tpu_torch.models.fateavatar import fateavatar_forward
    from fateavatar_tpu_torch.ops.camera import make_camera
    from fateavatar_tpu_torch.render.render import RenderConfig

    model, ts, _ = avatar
    tm = convert.fateavatar_model(np_dict(model), device="cpu")
    tts = convert.train_state(np_dict(jax.tree.map(np.asarray, ts)), device="cpu")
    frames = _frames()
    rcfg = RenderConfig(kernel="tiles", **{k: MESH_KW[k] for k in ("max_per_tile", "chunk")})

    def pix(e, p, t_, f):
        cam = make_camera(torch.eye(3), t_, f["fov"], f["fov"], RES, RES, device="cpu")
        out = fateavatar_forward(tm, tts.params, tts.state, e, p, cam, bg_color=torch.ones(3),
                                 render_cfg=rcfg)
        return torch.mean(torch.abs(out["rgb_image"] - torch.as_tensor(f["rgb"]))) / 2

    tables = ttracking.TrackingTables(
        expression=torch.stack([torch.as_tensor(f["expression"]) for f in frames]),
        flame_pose=torch.stack([torch.as_tensor(f["flame_pose"]) for f in frames]),
        cam_t=torch.stack([torch.as_tensor(f["T"]) for f in frames]))
    grads = [ttracking.row_gradients(pix, tables.expression[i], tables.flame_pose[i],
                                     tables.cam_t[i], f) for i, f in enumerate(frames)]
    row = ttracking._map(lambda *g: torch.stack(g), *grads)
    opt = ttracking.RowAdam(lr=5e-4)
    want, _ = opt.update_rows(tables, opt.init(tables), row, torch.arange(2),
                              torch.ones(2, dtype=torch.bool))
    for k in ttracking.FIELDS:
        np.testing.assert_allclose(r["track"][k], getattr(want, k).numpy(), atol=5e-9, err_msg=k)


# ---------------------------------------------------------------------------
# the Trainer's data-parallel epochs and the CLI
# ---------------------------------------------------------------------------

def test_trainer_dp_tracking_epoch(world4):
    """10 frames over 4 ranks pad to 12: global_step 12 after 3 steps of
    B = 4, every row updated exactly once (the 2 wrapped repeats masked),
    every row moved, finite losses, the replicas (state and tables)
    bit-identical."""
    for r in world4:
        e = r["trainer_dp_tracking"]
        assert e["global_step"] == 12 and e["step"] == 3 and e["mode"] == "dp=4"
        assert (e["counts"] == 1).all(), e["counts"]
        assert e["moved"] and np.isfinite(e["losses"]).all()
        assert len(set(e["digest"])) == 1


def test_flashavatar_dp_step_and_epoch(world2):
    """FlashAvatar's data-parallel step at world 2 (frames 0 and 1, one a
    rank) against the one-process step on the [2, ...] frame from the same
    init: the loss and PSNR within 1e-5 relative, the parameters within
    1e-2 lr on all but 0.5% of the elements; then a Trainer epoch of 3
    frames padded to 4 (global_step 4), finite losses, bit-identical
    replicas."""
    from fateavatar_tpu_torch.train.datasets import SyntheticDataset
    from fateavatar_tpu_torch.train.trainer import Trainer

    bundle, loss_fn, opt, adapter = _flash(32)
    ds = SyntheticDataset(num_frames=3, img_res=(32, 32), n_exp=4)
    tr = Trainer("flash", bundle[0], bundle[1], None, loss_fn, opt, ds, adapter=adapter)
    batch = stack_frames([tr._make_frame(ds.sample(i), cache=False) for i in range(2)])
    ts1, aux = adapter.step(adapter.init_ts(0), batch)
    for r in world2:
        f = r["flash_dp"]
        np.testing.assert_allclose(f["loss"], float(aux["loss"]), rtol=1e-5)
        np.testing.assert_allclose(f["psnr"], float(aux["psnr"]), rtol=1e-5)
        assert f["global_step"] == 4 and np.isfinite(f["losses"]).all()
        assert len(set(f["digest"])) == 1
    got = world2[0]["flash_dp"]["params"]
    for k, v in dataclasses.asdict(ts1.params).items():
        lr = opt.lr_tree.get(k, 0.0)
        vals = v.values() if isinstance(v, dict) else [v]
        gots = got[k].values() if isinstance(v, dict) else [got[k]]
        for a, b in zip(gots, vals):
            d = np.abs(a - b.detach().numpy())
            assert (d <= 2 * lr + 1e-6).all(), k
            assert (d > 1e-2 * lr + 1e-6).mean() < 0.005, k


def test_cli_dp_resumes_both_ways(world2, ranks):
    """train_mono_avatar: one epoch with --dp 1 (one device, rank 0 alone),
    then --resume --dp 2 in two ranks to epoch 2 (4 frames: 2 steps of B =
    2, every tracking row updated once more, both ranks equal), then
    --resume in this process to epoch 3 from the ranks' checkpoint."""
    first = world2[0]["cli_dp"]["first"]
    assert first["dp_mesh"] is None and first["global_step"] == 4
    for r in world2:
        c = r["cli_dp"]
        assert c["global_step"] == 8 and c["epoch"] == 2
        assert c["counts"].tolist() == [2] * 4
    for k, v in world2[0]["cli_dp"]["params"].items():
        np.testing.assert_array_equal(world2[1]["cli_dp"]["params"][k], v, err_msg=k)
    run, args = ranks["cli"]
    third = train_mono_avatar.main(["--epochs", "3", "--resume", *args])
    assert third.global_step == 12 and third.epoch == 3
    assert third.train_track_state.count.tolist() == [3] * 4
    assert os.path.exists(os.path.join(run, "media", "metrics", "test_epoch2.json"))


def test_dp_without_ranks_raises():
    """--dp 2 in a process that is not one of 2 ranks raises, naming
    torchrun; it never trains on one process in silence."""
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        train_mono_avatar.main(["--dp", "2", "--device", "cpu"])
