"""The training step.

Port of ``fateavatar_tpu/train/step.py`` (the body of train/iteration.py:21-89
of the reference): forward with the screen-space probe, loss, backward
(``torch.autograd.grad`` over the parameters and the probe), densification
statistics, the per-attribute Adam update, then densify / prune /
opacity-reset when their intervals come due. The step counter lives on the
host, so the intervals are plain Python ``if``s; the loss and every other
aux value stay on the device, so a step never waits on the card.

:func:`make_inplace_step` is the same step in place, on static buffers, for
capture in a CUDA graph (the body of the JAX package's scan epoch).

With tracing on (``utils/profiling.py``) the step marks its stages on the
device: ``forward`` (the render adds ``raster_front`` and ``blend``),
``loss``, ``backward``, ``optimizer`` (the statistics, Adam, maintenance)
and ``end``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.distributed as dist

from fateavatar_tpu_torch.models import maintenance
from fateavatar_tpu_torch.models.fateavatar import (
    FateAvatarModel,
    FateAvatarParams,
    FateAvatarState,
    fateavatar_forward,
)
from fateavatar_tpu_torch.ops.camera import Camera
from fateavatar_tpu_torch.render.render import RenderConfig
from fateavatar_tpu_torch.train.losses import as_float_rgb
from fateavatar_tpu_torch.train.optim import (
    MultiAdam,
    MultiAdamState,
    apply_updates,
    map_leaves,
    zero_moment_field,
    zero_moment_rows,
)
from fateavatar_tpu_torch.utils import profiling

SPLAT_FIELDS = maintenance.SPLAT_FIELDS


@dataclass
class Frame:
    """One training sample (the collate output of train/dataset.py:283-319)."""

    expression: torch.Tensor   # [n_exp]
    flame_pose: torch.Tensor   # [15]
    camera: Camera
    rgb: torch.Tensor          # [H, W, 3] float32, or uint8 (device cache)
    bg_color: torch.Tensor     # [3]
    # [7] model-to-world (euler xyz, translation, scale): the NeRSemble
    # tracking's head pose, applied after posing
    world_transform: Optional[torch.Tensor] = None


@dataclass
class TrainState:
    params: FateAvatarParams
    state: FateAvatarState
    opt_state: MultiAdamState
    step: int                   # steps taken (host counter)
    generator: torch.Generator  # densify draws


@dataclass(frozen=True)
class MaintenanceConfig:
    densify_interval: int = 3000
    prune_interval: int = 2000
    opacity_reset_interval: int = 60000
    increase_num: int = 1000
    min_opacity: float = 0.005
    max_points_num: int = 200_000

    def due(self, step: int) -> bool:
        """Whether the step that brings the count to ``step`` densifies,
        prunes or resets opacity."""
        return (step % self.densify_interval == 0 or step % self.prune_interval == 0
                or step % self.opacity_reset_interval == 0)


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def make_train_step(
    model: FateAvatarModel,
    loss_fn: Callable,
    optimizer: MultiAdam,
    maint: MaintenanceConfig = MaintenanceConfig(),
    render_cfg: RenderConfig = RenderConfig(),
    mesh=None,
    return_grads: bool = False,
):
    """Build the step: (TrainState, Frame, maintain=True) -> (TrainState,
    aux dict of device scalars). Mirrors iteration_step_fateavatar
    (train/iteration.py:21-89); ``maintain=False`` skips the maintenance
    that would fall due (the in-place step runs it apart). The returned
    function also exposes ``grads(ts, frame)`` -> (param grads, probe grad,
    forward output, loss dict), the step's gradient phase alone, on this
    process's frame.

    With ``mesh`` (a ``parallel.data_parallel.DeviceMesh``) it is the
    data-parallel step of the JAX package's ``make_dp_train_step``, run by
    every rank on its own frame of a batch of B = ``mesh.size``: the
    gradients and statistics are reduced over the ranks
    (:func:`_reduce_over_ranks`) before the update, every rank applies the
    same update and maintenance (densify from rank 0's draws), and the
    opacity reset does not run
    (data_parallel.py:120-142 of the JAX package); aux then holds "loss",
    "psnr", "overflow" and "num_alive" only. ``return_grads`` adds "grads",
    the gradients the update took."""

    def grads(ts: TrainState, frame: Frame):
        dev = ts.params.offset.device
        profiling.mark("forward", dev)
        leaves = {k: v.detach().requires_grad_() for k, v in _fields(ts.params).items()}
        params = dataclasses.replace(ts.params, **leaves)
        probe = torch.zeros((2, ts.params.offset.shape[0]), dtype=torch.float32,
                            device=dev, requires_grad=True)
        out = fateavatar_forward(
            model, params, ts.state, frame.expression, frame.flame_pose,
            frame.camera, bg_color=frame.bg_color, render_cfg=render_cfg,
            means2d_probe=probe, world_transform=frame.world_transform,
        )
        profiling.mark("loss", dev)
        losses = loss_fn(out, {"rgb": frame.rgb})
        profiling.mark("backward", dev)
        g = torch.autograd.grad(losses["loss"], [*leaves.values(), probe],
                                allow_unused=True)
        param_grads = dataclasses.replace(ts.params, **{
            k: torch.zeros_like(v) if gk is None else gk
            for (k, v), gk in zip(leaves.items(), g[:-1])})
        return param_grads, g[-1], out, losses

    def step_fn(ts: TrainState, frame: Frame, maintain: bool = True):
        param_grads, probe_grad, out, losses = grads(ts, frame)
        profiling.mark("optimizer", ts.params.offset.device)
        with torch.no_grad():
            psnr = -10.0 * torch.log10(torch.mean(
                (out["rgb_image"] - as_float_rgb(frame.rgb)) ** 2))

        if mesh is None:
            # densification statistics from d(loss)/d(mean2d): the
            # viewspace_points.grad hook (train/iteration.py:54-57)
            state = maintenance.add_densification_stats(
                ts.state, probe_grad, out["visibility_filter"])
            state = maintenance.update_max_radii(state, out["radii"],
                                                 out["visibility_filter"])
            aux = {k: v.detach() for k, v in losses.items()}
            aux["overflow"] = out["overflow"]
            aux["psnr"] = psnr
        else:
            param_grads, state, aux = _reduce_over_ranks(
                mesh, ts.state, param_grads, probe_grad, out, losses["loss"].detach(), psnr)

        updates, opt_state = optimizer.update(param_grads, ts.opt_state, ts.params)
        params = apply_updates(ts.params, updates)
        step = ts.step + 1

        if maintain and step % maint.densify_interval == 0:   # train/iteration.py:63-72
            p2, s2, touched = maintenance.uv_densify(
                ts.generator, params, state, increase_num=maint.increase_num,
                share=None if mesh is None else mesh.broadcast)
            o2 = zero_moment_rows(opt_state, touched, SPLAT_FIELDS)
            # the capacity check stays on the device: no host round trip
            ok = torch.sum(state.alive) + maint.increase_num <= maint.max_points_num
            params, state, opt_state = (
                _select(ok, a, b) for a, b in
                ((p2, params), (s2, state), (o2, opt_state)))
        if maintain and step % maint.prune_interval == 0:     # train/iteration.py:74-79
            state = maintenance.prune_low_opacity(params, state, maint.min_opacity)
        if (maintain and mesh is None
                and step % maint.opacity_reset_interval == 0):   # :81-85
            params = maintenance.reset_opacity(params)
            opt_state = zero_moment_field(opt_state, "opacity")

        aux["num_alive"] = torch.sum(state.alive)
        if return_grads:
            aux["grads"] = param_grads
        profiling.mark("end", ts.params.offset.device)
        new_ts = TrainState(params=params, state=state, opt_state=opt_state,
                            step=step, generator=ts.generator)
        return new_ts, aux

    step_fn.grads = grads
    return step_fn


def _reduce_over_ranks(mesh, state: FateAvatarState, param_grads, probe_grad, out: dict,
                       loss, psnr):
    """The data-parallel step's reduction over the B = ``mesh.size`` ranks:
    the gradients of the mean loss over their frames (each rank's 1/B of
    its own; the probe's too, not rescaled by B: data_parallel.py:102-115
    of the JAX package), the densification statistics and the aux values
    in one all-reduce; ``max_radii2d`` takes the largest over the ranks.
    Returns (gradients, state, aux: "loss" and "psnr" the means over B,
    "overflow" summed)."""
    # imported here: parallel.data_parallel imports this module
    from fateavatar_tpu_torch.parallel.data_parallel import all_reduce_tree, scale_tree

    B = mesh.size
    vis = out["visibility_filter"] & state.alive
    gnorm = torch.linalg.norm(probe_grad / B, dim=0)
    grads, (accum, denom, loss, psnr, ovf) = all_reduce_tree(
        scale_tree(param_grads, 1.0 / B), mesh,
        extra=[torch.where(vis, gnorm, 0.0), vis.to(torch.float32), loss / B, psnr / B,
               out["overflow"].to(torch.float32)])
    radii = mesh.all_reduce(torch.where(vis, out["radii"].to(torch.float32), 0.0),
                            op=dist.ReduceOp.MAX)
    state = dataclasses.replace(
        state, xyz_gradient_accum=state.xyz_gradient_accum + accum,
        denom=state.denom + denom, max_radii2d=torch.maximum(state.max_radii2d, radii))
    return grads, state, {"loss": loss, "psnr": psnr,
                          "overflow": torch.round(ovf).to(torch.int32)}


def _select(cond: torch.Tensor, a, b):
    """Field-wise torch.where(cond, a, b) over dataclasses of tensors (and
    MultiAdamState's nested ones)."""
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(a, **{
            k: _select(cond, v, getattr(b, k)) for k, v in _fields(a).items()})
    return torch.where(cond, a, b)


def init_train_state(params: FateAvatarParams, state: FateAvatarState,
                     optimizer: MultiAdam, seed: int = 0) -> TrainState:
    """A fresh TrainState owning copies of ``params`` and ``state``; the
    densify generator on their device, seeded with ``seed``."""
    dev = params.offset.device
    params = dataclasses.replace(params, **{
        k: v.detach().clone() for k, v in _fields(params).items()})
    state = dataclasses.replace(state, **{
        k: v.detach().clone() for k, v in _fields(state).items()})
    return TrainState(params=params, state=state, opt_state=optimizer.init(params),
                      step=0, generator=torch.Generator(device=dev).manual_seed(seed))


def _tensors(obj) -> list:
    """The tensors of a dataclass of tensors and dicts of tensors (a
    network's weights by name), in field order; none of None."""
    if obj is None:
        return []
    out = []
    for v in _fields(obj).values():
        out.extend(v.values() if isinstance(v, dict) else [v])
    return out


def train_state_tensors(ts) -> list:
    """Every tensor of ``ts`` (a :class:`TrainState` or a family's
    ``BaselineTrainState``) in a fixed order: the parameters, the model
    state, the Adam moments and the Adam step count."""
    o = ts.opt_state
    return [*_tensors(ts.params), *_tensors(ts.state), *_tensors(o.mu), *_tensors(o.nu),
            o.count]


def clone_train_state(ts):
    """A train state like ``ts`` owning copies of every tensor of it (the
    static buffers of the in-place step); it shares the generator."""
    def copy(obj):
        if obj is None:
            return None
        return dataclasses.replace(obj, **{k: map_leaves(torch.clone, v)
                                           for k, v in _fields(obj).items()})

    o = ts.opt_state
    return dataclasses.replace(ts, params=copy(ts.params), state=copy(ts.state),
                               opt_state=MultiAdamState(mu=copy(o.mu), nu=copy(o.nu),
                                                        count=o.count.clone()))


def copy_train_state_(dst, src):
    """Copy every tensor of ``src`` into ``dst`` (a no-op where they are the
    same tensor)."""
    for d, s in zip(train_state_tensors(dst), train_state_tensors(src)):
        d.copy_(s)


# the per-step scalars an epoch of in-place steps records (the ys of the
# JAX package's scan epoch), with their types
EPOCH_AUX = {"loss": torch.float32, "psnr": torch.float32, "overflow": torch.int32}


def make_inplace_step(step_fn: Callable, static, frame_at: Callable,
                      aux: dict, cursor: torch.Tensor):
    """The step on static buffers, for capture in a CUDA graph: the body of
    the JAX package's scan epoch (``make_train_step(..., return_raw=True)``).

    ``run(step=None)`` builds its frame with ``frame_at(cursor)`` from
    device-resident stacked frames at the device cursor ([1] int64), runs
    ``step_fn`` on ``static`` (a :class:`TrainState`, or a family's
    ``BaselineTrainState`` and its step), copies the new train state's
    tensors into ``static``, writes loss, psnr and overflow into ``aux`` ([n] tensors of
    :data:`EPOCH_AUX`) at the cursor, advances the cursor and returns the
    frame. Without ``step`` it reads no host value and runs no maintenance,
    so one capture replays as every such step (the Adam step count lives
    on the device); ``step`` (the steps taken before this one) runs the
    maintenance that falls due, eagerly: densify draws from a
    ``torch.Generator``. ``static.step`` is left to the caller."""

    def run(step: Optional[int] = None):
        frame = frame_at(cursor)
        if step is None:
            new, a = step_fn(static, frame, maintain=False)
        else:
            new, a = step_fn(dataclasses.replace(static, step=step), frame)
        copy_train_state_(static, new)
        for k, buf in aux.items():
            buf.index_copy_(0, cursor, a[k].reshape(1).to(buf.dtype))
        cursor.add_(1)
        return frame

    return run
