"""The ranks of tests/test_torch_parallel.py: gloo process groups on the
CPU, spawned from the test process.

This module imports neither JAX nor the JAX package (``tests/conftest.py``
does, and it does not run in the children): every input comes in as numpy
from the test, and each rank's results go back through ``torch.save``.
The ranks meet through a ``FileStore`` under the test's ``tmp_path`` (TCP
ports would collide across xdist workers); each rank uses one intra-op
thread. :func:`spawn` runs a list of tasks, the functions below by name,
one after the other in every rank."""

import dataclasses
import datetime
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# the longest a spawn may run, and a collective may wait, in the tests
TIMEOUT_S = 240


def start(tasks, world: int, tmp_path):
    """Start ``tasks`` ([(name, kwargs)]) in ``world`` gloo ranks, without
    waiting: :func:`finish` collects them."""
    out = os.path.join(str(tmp_path), f"ranks{world}")
    os.makedirs(out, exist_ok=True)
    ctx = mp.start_processes(_entry, args=(world, os.path.join(out, "store"), tasks, out,
                                           list(sys.path)),
                             nprocs=world, start_method="spawn", join=False)
    return ctx, out, world


def finish(handle, timeout: float = TIMEOUT_S) -> list:
    """Wait for the ranks of :func:`start`, at most ``timeout`` seconds;
    each rank's {name: result}. A failed rank raises here (the others are
    stopped), and so does a rank still running at the deadline."""
    ctx, out, world = handle
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.terminate()
            raise TimeoutError(f"{world} ranks still running after {timeout} s")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def spawn(tasks, world: int, tmp_path) -> list:
    """:func:`start` and :func:`finish`."""
    return finish(start(tasks, world, tmp_path))


def _entry(rank, world, store, tasks, out, path):
    sys.path[:] = path
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        results = {name: globals()[name](rank, world, **kw) for name, kw in tasks}
        torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


def fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def np_tree(obj):
    """Tensors of a dataclass / dict tree as numpy (for torch.save)."""
    if dataclasses.is_dataclass(obj):
        return {k: np_tree(v) for k, v in fields(obj).items()}
    if isinstance(obj, dict):
        return {k: np_tree(v) for k, v in obj.items()}
    return obj.detach().cpu().numpy() if torch.is_tensor(obj) else obj


def frame_of(f: dict, res: int):
    """A port Frame from {expression, flame_pose, T, fov, rgb}."""
    from fateavatar_tpu_torch.ops.camera import make_camera
    from fateavatar_tpu_torch.train.step import Frame

    return Frame(expression=t(f["expression"]), flame_pose=t(f["flame_pose"]),
                 camera=make_camera(np.eye(3), f["T"], f["fov"], f["fov"], res, res,
                                    device="cpu"),
                 rgb=t(f["rgb"]), bg_color=torch.ones(3))


# ---------------------------------------------------------------------------
# the collectives' gradients
# ---------------------------------------------------------------------------

def collectives_grads(rank, world):
    """Each autograd collective on x_r = [world, 3] (rank r's values 100 r
    + its index), with rank r's loss sum(out * (r + 1)): the outputs and
    x_r's gradient."""
    from fateavatar_tpu_torch.parallel import collectives

    out = {}
    for name in ("all_to_all", "all_reduce_sum", "all_gather"):
        x = (torch.arange(world * 3, dtype=torch.float64).reshape(world, 3)
             + 100.0 * rank).requires_grad_()
        y = getattr(collectives, name)(x)
        (y * (rank + 1.0)).sum().backward()
        out[name] = (y.detach().numpy(), x.grad.numpy())
    return out


# ---------------------------------------------------------------------------
# splat-sharded rendering
# ---------------------------------------------------------------------------

def render_shard(rank, world, scene, res, fov, bg, weights, **kw):
    """This rank's shard of ``scene`` through render_splat_sharded; the
    gradient of sum(image * weights) / world (every rank computes that
    loss) w.r.t. the shard's xyz, opacity and colour."""
    from fateavatar_tpu_torch.ops.camera import make_camera
    from fateavatar_tpu_torch.parallel.splat_parallel import render_splat_sharded
    from fateavatar_tpu_torch.render.splats import make_gaussians

    n = scene["xyz"].shape[0] // world
    part = {k: t(v[rank * n:(rank + 1) * n]).requires_grad_()
            for k, v in scene.items()}
    g = make_gaussians(**part, device="cpu")
    cam = make_camera(np.eye(3), np.zeros(3), fov, fov, res, res, device="cpu")
    img, dropped = render_splat_sharded(cam, g, t(bg), **kw)
    (torch.sum(img * t(weights)) / world).backward()
    return {"image": img.detach().numpy(), "dropped": int(dropped),
            "grads": {k: v.grad.numpy() for k, v in part.items()}}


# ---------------------------------------------------------------------------
# the data-parallel step
# ---------------------------------------------------------------------------

def dp_step(rank, world, model, ts, frames, res, loss_cfg, render_kw, maint):
    """One make_dp_train_step from ``ts`` on this rank's frame; then with
    densify and prune due (``maint``) a second step; then a third that
    densifies with each rank's generator seeded apart (the replicas must
    take rank 0's draws); the replicas' digests after each."""
    from fateavatar_tpu_torch import convert
    from fateavatar_tpu_torch.parallel.data_parallel import (
        make_device_mesh, make_dp_train_step, replicate, stack_frames, state_digest)
    from fateavatar_tpu_torch.render.render import RenderConfig
    from fateavatar_tpu_torch.train import losses as tl
    from fateavatar_tpu_torch.train.optim import fateavatar_optimizers
    from fateavatar_tpu_torch.train.step import MaintenanceConfig

    mesh = make_device_mesh(world, device="cpu")
    tmodel = convert.fateavatar_model(model, device="cpu")
    tts = replicate(convert.train_state(ts, device="cpu"), mesh)
    loss = tl.FateAvatarLoss(tl.FateAvatarLossConfig(**loss_cfg))
    opt = fateavatar_optimizers({})
    rcfg = RenderConfig(**render_kw)
    batch = stack_frames([frame_of(f, res) for f in frames])
    no_maint = MaintenanceConfig(densify_interval=10**9, prune_interval=10**9,
                                 opacity_reset_interval=10**9)
    step = make_dp_train_step(tmodel, loss, opt, mesh, no_maint, rcfg)
    ts1, aux = step(tts, batch)
    digests = [state_digest(ts1, mesh)]
    maint_step = make_dp_train_step(tmodel, loss, opt, mesh, MaintenanceConfig(**maint), rcfg)
    ts2, aux2 = maint_step(ts1, batch)
    digests.append(state_digest(ts2, mesh))
    ts2.generator.manual_seed(1000 + rank)
    apart = make_dp_train_step(tmodel, loss, opt, mesh, MaintenanceConfig(
        **{**maint, "densify_interval": 1, "prune_interval": 10**9}), rcfg)
    ts3, _ = apart(ts2, batch)
    digests.append(state_digest(ts3, mesh))
    return {"loss": float(aux["loss"]), "overflow": int(aux["overflow"]),
            "params": np_tree(ts1.params), "state": np_tree(ts1.state),
            "count": int(ts1.opt_state.count), "digests": digests,
            "alive": [int(ts1.state.alive.sum()), int(ts2.state.alive.sum()),
                      int(ts3.state.alive.sum())],
            "loss2": float(aux2["loss"])}


# ---------------------------------------------------------------------------
# the 2-D mesh
# ---------------------------------------------------------------------------

def mesh2d_step(rank, world, model, ts, frames, res, data, step_kw, densify_src):
    """One 2-D step with return_grads, then a step whose sharded densify
    fires with the sources ``densify_src`` injected, and the tracking step
    on the same frames."""
    from fateavatar_tpu_torch import convert
    from fateavatar_tpu_torch.parallel.data_parallel import stack_frames
    from fateavatar_tpu_torch.parallel.mesh2d import (
        Mesh2D, gather_mesh2d, make_mesh2d_tracking_step, make_mesh2d_train_step,
        mesh2d_maintenance, place_mesh2d)
    from fateavatar_tpu_torch.train.optim import fateavatar_optimizers
    from fateavatar_tpu_torch.train.tracking import RowAdam, TrackingTables

    mesh = Mesh2D(data, world // data, "cpu")
    tmodel = convert.fateavatar_model(model, device="cpu")
    opt = fateavatar_optimizers({})
    full = convert.train_state(ts, device="cpu")
    local = place_mesh2d(full, mesh)
    batch = stack_frames([frame_of(f, res) for f in frames])
    step = make_mesh2d_train_step(tmodel, opt, mesh, return_grads=True, **step_kw)
    ts1, aux = step(local, batch)
    out = {"loss": float(aux["loss"]), "overflow": int(aux["overflow"]),
           "grads": np_tree(aux["grads"]), "probe_grad": aux["probe_grad"].numpy(),
           "accum": ts1.state.xyz_gradient_accum.numpy(), "denom": ts1.state.denom.numpy(),
           "coords": (mesh.d, mesh.g)}

    # the in-step densify with injected sources (every rank the same draws)
    src = torch.as_tensor(densify_src, dtype=torch.int64)
    bary = torch.full((src.shape[0], 3), 1.0 / 3.0)
    dstep = make_mesh2d_train_step(tmodel, opt, mesh, densify_interval=2,
                                   increase_num=src.shape[0], **step_kw,
                                   densify_draws=lambda g, s, m, k: (src, bary))
    ts2, aux2 = dstep(ts1, batch)
    whole = gather_mesh2d(ts2, mesh)
    out.update(densified=np_tree(whole.params), densified_state=np_tree(whole.state),
               num_alive=int(aux2["num_alive"]))
    # between phases: gather, densify and prune (nothing below opacity 0)
    # as on one device, place again; each rank's generator seeded apart,
    # so the ranks agree only by taking rank 0's draws
    ts2.generator.manual_seed(1000 + rank)
    ts3 = mesh2d_maintenance(ts2, mesh, increase_num=8, min_opacity=0.0)
    maintained = gather_mesh2d(ts3, mesh)
    out.update(maintained_alive=np_tree(maintained.state)["alive"],
               maintained=np_tree(maintained.params),
               maintained_face=maintained.state.face_index.numpy(),
               local_n=ts3.state.alive.shape[0])
    # the in-step sharded densify from its own draws, seeded apart as well
    ts3.generator.manual_seed(2000 + rank)
    own = make_mesh2d_train_step(tmodel, opt, mesh, densify_interval=1, increase_num=8,
                                 **step_kw)
    ts4, _ = own(ts3, batch)
    whole4 = gather_mesh2d(ts4, mesh)
    out.update(own_draws=np_tree(whole4.params),
               own_draws_state=np_tree(whole4.state))

    # tracking: the rows of the Bd frames
    tables = TrackingTables(expression=torch.stack([t(f["expression"]) for f in frames]),
                            flame_pose=torch.stack([t(f["flame_pose"]) for f in frames]),
                            cam_t=torch.stack([t(f["T"]) for f in frames]))
    track = RowAdam(lr=5e-4)
    tstate = track.init(tables)
    fc = {"R": torch.eye(3).expand(len(frames), 3, 3),
          "fovx": torch.stack([t(f["fov"]) for f in frames]),
          "fovy": torch.stack([t(f["fov"]) for f in frames]),
          "rgb": torch.stack([t(f["rgb"]) for f in frames]), "bg": torch.ones(len(frames), 3)}
    kw = {k: step_kw[k] for k in ("max_per_tile", "pair_budget", "chunk") if k in step_kw}
    tstep = make_mesh2d_tracking_step(tmodel, mesh, track, **kw)
    tables1, tstate1, tloss = tstep(tables, tstate, torch.arange(len(frames)),
                                    torch.ones(len(frames), dtype=torch.bool),
                                    local.params, local.state, fc)
    out.update(track=np_tree(tables1), track_count=tstate1.count.numpy(),
               track_loss=float(tloss))
    return out


# ---------------------------------------------------------------------------
# the Trainer's data-parallel epochs
# ---------------------------------------------------------------------------

def _avatar(res, cap=128, tex=8, nv=96):
    from fateavatar_tpu_torch.flame.loader import synthetic_flame
    from fateavatar_tpu_torch.models import fateavatar as tfa
    from fateavatar_tpu_torch.utils.obj_io import sphere_obj_mesh

    flame = synthetic_flame(n_verts=nv, n_shape=6, n_exp=4, seed=0, device="cpu")
    cfg = tfa.FateAvatarConfig(tex_size=tex, capacity=cap, img_height=res, img_width=res,
                               normal_offset=0.02)
    return tfa.init_fateavatar(sphere_obj_mesh(nv), flame, cfg, device="cpu")


def trainer_dp_tracking(rank, world, res, n_frames):
    """A tracking epoch of the Trainer at data_parallel=world on
    ``n_frames`` synthetic frames."""
    from fateavatar_tpu_torch.parallel.data_parallel import make_device_mesh, state_digest
    from fateavatar_tpu_torch.render.render import RenderConfig
    from fateavatar_tpu_torch.train import losses as tl
    from fateavatar_tpu_torch.train.datasets import SyntheticDataset
    from fateavatar_tpu_torch.train.optim import fateavatar_optimizers
    from fateavatar_tpu_torch.train.step import MaintenanceConfig
    from fateavatar_tpu_torch.train.trainer import Trainer

    model, params, state = _avatar(res)
    ds = SyntheticDataset(num_frames=n_frames, img_res=(res, res), n_exp=4)
    ds.optimize_tracking = True
    tr = Trainer("dp_track", model, params, state,
                 tl.FateAvatarLoss(tl.FateAvatarLossConfig(rgb_weight=1.0)),
                 fateavatar_optimizers({}), ds, workspace=None,
                 render_cfg=RenderConfig(max_tiles_per_gaussian=16),
                 maint_cfg=MaintenanceConfig(densify_interval=10**9, prune_interval=10**9,
                                             opacity_reset_interval=10**9),
                 snapshot_interval=10**9, data_parallel=world)
    before = tr.train_tables.expression.clone()
    tr.epoch = 1
    tr.train_epoch()
    mesh = make_device_mesh(world, device="cpu")
    return {"global_step": tr.global_step, "step": tr.ts.step,
            "counts": tr.train_track_state.count.numpy(),
            "moved": bool((tr.train_tables.expression != before).any(dim=1).all()),
            "losses": list(tr.epoch_losses), "mode": tr.last_epoch_stats["mode"],
            "digest": state_digest((tr.ts, tr.train_tables, tr.train_track_state), mesh)}


def _flash(res):
    from fateavatar_tpu_torch.flame.loader import synthetic_flame
    from fateavatar_tpu_torch.render.render import RenderConfig
    from fateavatar_tpu_torch.train import registry
    from fateavatar_tpu_torch.train.adapters import make_family_adapter
    from fateavatar_tpu_torch.utils.obj_io import sphere_obj_mesh

    tf = synthetic_flame(n_verts=96, n_shape=6, n_exp=4, seed=0, device="cpu")
    entry = registry.get("flashavatar")
    cfg = dict(img_height=res, img_width=res, tex_size=8, capacity=256, num_samples=128,
               n_init_points=64, max_points=256, sh_degree=1, cam_scale=1.0,
               dataset_type="synthetic")
    bundle = entry.build_model(sphere_obj_mesh(96), tf, cfg)
    loss_fn = entry.build_loss({}, bundle)
    opt = entry.build_optimizer({"lr": 1e-3})
    adapter = make_family_adapter("flashavatar", bundle, loss_fn, opt, RenderConfig(), {})
    return bundle, loss_fn, opt, adapter


def flash_dp(rank, world, res, n_frames):
    """FlashAvatar: one data-parallel step from the adapter's init on
    SyntheticDataset frame ``rank``, then a Trainer epoch at
    data_parallel=world."""
    from fateavatar_tpu_torch.parallel.data_parallel import make_device_mesh, state_digest
    from fateavatar_tpu_torch.train.datasets import SyntheticDataset
    from fateavatar_tpu_torch.train.trainer import Trainer

    bundle, loss_fn, opt, adapter = _flash(res)
    mesh = make_device_mesh(world, device="cpu")
    ds = SyntheticDataset(num_frames=n_frames, img_res=(res, res), n_exp=4)
    tr = Trainer("flash_dp", bundle[0], bundle[1], None, loss_fn, opt, ds, workspace=None,
                 adapter=adapter, data_parallel=world)
    frame = tr._make_frame(ds.sample(rank), cache=False)
    ts1, aux = adapter.step(adapter.init_ts(0), frame, mesh=mesh)
    tr.train(1)
    return {"loss": float(aux["loss"]), "psnr": float(aux["psnr"]),
            "params": np_tree(ts1.params), "global_step": tr.global_step,
            "losses": list(tr.epoch_losses), "digest": state_digest(tr.ts, mesh)}


def cli_dp(rank, world, args):
    """cli/train_mono_avatar: one epoch with --dp 1 in rank 0 alone (one
    device), then --resume --dp ``world`` to epoch 2 in every rank."""
    from fateavatar_tpu_torch.cli import train_mono_avatar

    first = None
    if rank == 0:
        tr = train_mono_avatar.main(["--epochs", "1", "--dp", "1", *args])
        first = {"dp_mesh": tr.dp_mesh, "global_step": tr.global_step}
    dist.barrier()
    tr = train_mono_avatar.main(["--epochs", "2", "--resume", "--dp", str(world), *args])
    return {"first": first, "global_step": tr.global_step, "epoch": tr.epoch,
            "counts": tr.train_track_state.count.numpy(),
            "params": np_tree(tr.ts.params)}
