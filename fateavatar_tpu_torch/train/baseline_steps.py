"""The baselines' training steps.

Port of ``fateavatar_tpu/train/baseline_steps.py`` (train/iteration.py:93-302
and train/optim.py:41-123 of the reference): each baseline's step is its
forward, loss, backward (``torch.autograd.grad`` over the parameter
tensors, the networks' included), the per-field Adam update and its
maintenance when due, on one :class:`BaselineTrainState`, so the Trainer
drives every family the same way. The step count lives on the host, so the
JAX package's ``lax.cond`` densify, opacity-reset and walk branches are
plain ``if``s here; the loss and every other aux value stay on the device.

Each step function also exposes ``grads(ts, frame)``: its gradient phase
alone, (parameter gradients, the probe's gradient or None, forward output,
loss dict), and ``due(step)``: whether the step that brings the count to
``step`` runs a host-gated branch (GaussianAvatars' densify or opacity
reset, SplattingAvatar's walk; never for FlashAvatar and
MonoGaussianAvatar, whose ``seen`` mask is device-only). Called with
``maintain=False``, a step branches on no host step count and runs none of
those branches, so one CUDA graph of it replays as every step that is not
due: the body of the JAX package's scan epoch (its ``.raw`` step), which
the Trainer runs the due steps of eagerly (``train/trainer.py``).
GaussianAvatars' ``xyz_lr_schedule(step)`` is a host value that a capture
would freeze: a step built with one has ``due`` None, and the Trainer then
keeps per-step epochs.

A batched frame ``[B, ...]`` (``parallel.data_parallel.stack_frames``)
trains on the mean loss over its B frames (the JAX package's ``vmap``
branch, baseline_steps.py:111-155). A step called with ``mesh=`` (a
``parallel.DeviceMesh``) is one rank of the data-parallel step: its frame's
gradients are summed over the ranks and divided by their number before the
update, so every rank applies the gradient of the mean loss over the whole
batch, and its statistics and aux values are reduced alike. GaussianAvatars'
densify statistic rescales each frame's probe gradient by ``(2 / W) * B``,
B the whole (global) batch, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from fateavatar_tpu_torch.models.baselines import flashavatar as FA
from fateavatar_tpu_torch.models.baselines import gaussianavatars as GA
from fateavatar_tpu_torch.models.baselines import monogaussianavatar as MA
from fateavatar_tpu_torch.models.baselines import splattingavatar as SA
from fateavatar_tpu_torch.render.render import RenderConfig
from fateavatar_tpu_torch.train.losses import as_float_rgb
from fateavatar_tpu_torch.train.optim import (
    MultiAdam,
    MultiAdamState,
    apply_updates,
    map_leaves,
    params_device,
    zero_moment_field,
    zero_moment_rows,
)
from fateavatar_tpu_torch.train.step import Frame
from fateavatar_tpu_torch.parallel.data_parallel import (
    all_reduce_tensors,
    all_reduce_tree,
    scale_tree,
    unstack_frames,
)
from fateavatar_tpu_torch.utils import profiling


@dataclass
class BaselineTrainState:
    params: Any
    state: Any                  # None for FlashAvatar
    opt_state: MultiAdamState
    step: int                   # steps taken (host counter)
    generator: torch.Generator  # densify / upsample draws


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _copy(obj):
    if obj is None:
        return None
    return dataclasses.replace(obj, **{
        k: map_leaves(lambda x: x.detach().clone(), v) for k, v in _fields(obj).items()})


def _init_ts(params, state, optimizer: MultiAdam, seed: int = 0) -> BaselineTrainState:
    """A fresh train state owning copies of ``params`` and ``state``; the
    draws' generator on their device, seeded with ``seed``."""
    params = _copy(params)
    return BaselineTrainState(
        params=params, state=_copy(state), opt_state=optimizer.init(params), step=0,
        generator=torch.Generator(device=params_device(params)).manual_seed(seed))


def _frames(frame: Frame) -> list:
    """The single frames of ``frame``: B of a batched ``[B, ...]`` one."""
    return unstack_frames(frame) if frame.rgb.dim() == 4 else [frame]


def _mean_losses(losses: list) -> dict:
    """The per-frame loss dicts' mean (the JAX package's ``tree.map(mean)``
    of the vmapped losses)."""
    if len(losses) == 1:
        return losses[0]
    return {k: torch.mean(torch.stack([l[k] for l in losses])) for k in losses[0]}


def _psnr(img, rgb):
    with torch.no_grad():
        return -10.0 * torch.log10(torch.mean((img - as_float_rgb(rgb)) ** 2))


def param_grads(params, loss_of: Callable, extra=()):
    """d loss / d every tensor of ``params`` (dict fields included) and of
    ``extra``: ``loss_of(params with leaves that require grad)`` ->
    (loss, aux). Returns (gradients like ``params``, gradients of ``extra``,
    aux); an unused tensor gets zeros."""
    leaves = []

    def leaf(x):
        x = x.detach().requires_grad_()
        leaves.append(x)
        return x

    p = dataclasses.replace(params, **{k: map_leaves(leaf, v)
                                       for k, v in _fields(params).items()})
    loss, aux = loss_of(p)
    profiling.mark("backward", params_device(params))
    g = torch.autograd.grad(loss, [*leaves, *extra], allow_unused=True)
    g = [torch.zeros_like(x) if gx is None else gx for x, gx in zip([*leaves, *extra], g)]
    it = iter(g)
    grads = dataclasses.replace(params, **{k: map_leaves(lambda _: next(it), v)
                                           for k, v in _fields(params).items()})
    return grads, list(it), aux


def _aux(losses: dict, out: dict, frame: Frame) -> dict:
    aux = {k: v.detach() for k, v in losses.items()}
    aux["psnr"] = _psnr(out["rgb_image"], frame.rgb)
    aux["overflow"] = out["overflow"]
    return aux


def _batch_aux(losses: dict, outs: list, frames: list, mesh=None,
               whole_batch_psnr: bool = False) -> dict:
    """The aux of one frame (:func:`_aux`), or of a batch: the mean losses,
    the overflow summed, and the PSNR of the whole batch's error
    (GaussianAvatars) or the mean of the frames' PSNRs (the others), as
    the JAX package's batched steps give them. With ``mesh``, each value is
    that of the batch over every rank."""
    if len(outs) == 1 and mesh is None:
        return _aux(losses, outs[0], frames[0])
    with torch.no_grad():
        mses = torch.stack([torch.mean((o["rgb_image"] - as_float_rgb(f.rgb)) ** 2)
                            for o, f in zip(outs, frames)])
        q = torch.mean(mses) if whole_batch_psnr else torch.mean(-10.0 * torch.log10(mses))
        ovf = torch.sum(torch.stack([o["overflow"] for o in outs])).to(torch.float32)
        vals = [v.detach() for v in losses.values()]
        if mesh is not None:
            *vals, q, ovf = all_reduce_tensors([*vals, q, ovf], mesh)
            vals, q = [v / mesh.size for v in vals], q / mesh.size
    aux = dict(zip(losses, vals))
    aux["psnr"] = -10.0 * torch.log10(q) if whole_batch_psnr else q
    aux["overflow"] = torch.round(ovf).to(torch.int32)
    return aux


def _reduce_grads(g, mesh):
    """The gradient of the mean loss over every rank's frames: each rank's
    own, summed over the ranks and divided by their number."""
    if mesh is None:
        return g
    return all_reduce_tree(scale_tree(g, 1.0 / mesh.size), mesh)[0]


# ---------------------------------------------------------------------------
# GaussianAvatars (train/iteration.py:128-199)
# ---------------------------------------------------------------------------

def gaussianavatars_optimizer(training_cfg: dict) -> MultiAdam:
    return MultiAdam(lr_tree=dict(
        xyz=training_cfg.get("position_lr_init", 0.005),
        opacity=training_cfg.get("opacity_lr", 0.05),
        features_dc=training_cfg.get("feature_dc_lr", 0.0025),
        features_rest=training_cfg.get("feature_dc_lr", 0.0025) / 20,
        rotation=training_cfg.get("rotation_lr", 0.001),
        scaling=training_cfg.get("scaling_lr", 0.017),
    ))


def make_gaussianavatars_step(
    model: GA.GAModel, loss_fn, optimizer: MultiAdam,
    render_cfg: RenderConfig = RenderConfig(),
    active_sh_degree: int = 0,
    densify_interval: int = 2000,
    densify_from: int = 10000,
    densify_until: int = 600_000,
    densify_grad_threshold: float = 0.0001,
    min_opacity: float = 0.005,
    extent: float = 2.0,
    size_threshold: float = 20.0,
    opacity_reset_interval: int = 60000,
    xyz_lr_schedule: Optional[Callable] = None,
    densify_budget: int = 8192,
):
    """The step with the screen-space probe; its gradient, scaled by 2 / W
    (the CUDA convention the threshold was tuned for: mean2D gradients in
    NDC half-units, backward.cu:399+), accumulates the densify statistic.
    ``xyz_lr_schedule(step)`` (host steps) rescales the xyz update."""

    def grads(ts: BaselineTrainState, frame: Frame):
        frames = _frames(frame)
        n = ts.params.xyz.shape[0]
        dev = ts.params.xyz.device
        profiling.mark("forward", dev)
        probe = torch.zeros((len(frames), 2, n), device=dev, requires_grad=True)

        def loss_of(p):
            outs, losses = [], []
            for f, pr in zip(frames, probe):
                out = GA.ga_forward(model, p, ts.state, f.expression, f.flame_pose, f.camera,
                                    active_sh_degree=active_sh_degree, bg_color=f.bg_color,
                                    render_cfg=render_cfg, means2d_probe=pr)
                outs.append(out)
                profiling.mark("loss", dev)
                losses.append(loss_fn(out, {"rgb": f.rgb}))
            losses = _mean_losses(losses)
            return losses["loss"], (outs, losses)

        g, (g_probe,), (outs, losses) = param_grads(ts.params, loss_of, [probe])
        if frame.rgb.dim() == 4:
            return g, g_probe, outs, losses
        return g, g_probe[0], outs[0], losses

    def densify_due(step: int) -> bool:
        return step % densify_interval == 0 and densify_from <= step < densify_until

    def reset_due(step: int) -> bool:
        return opacity_reset_interval > 0 and step % opacity_reset_interval == 0

    def step_fn(ts: BaselineTrainState, frame: Frame, mesh=None, maintain: bool = True):
        if not maintain and xyz_lr_schedule is not None:
            raise ValueError("a GaussianAvatars step with an xyz lr schedule reads the host "
                             "step count: it has no maintain=False form")
        g, g_probe, out, losses = grads(ts, frame)
        profiling.mark("optimizer", ts.params.xyz.device)
        frames, outs = _frames(frame), (out if isinstance(out, list) else [out])
        g_probe = g_probe.reshape(len(outs), 2, -1)
        world = 1 if mesh is None else mesh.size
        B = len(outs) * world
        # each frame's probe gradient of the mean loss over the B frames is
        # 1/B of its own: rescaled by B, so the statistic stays that of one
        # frame (the threshold was tuned for it)
        state = ts.state
        w = frame.camera.width
        vis = [o["visibility_filter"] & state.alive for o in outs]
        accum = sum(torch.where(v, torch.linalg.norm(gp / world, dim=0) * (2.0 / w) * B, 0.0)
                    for v, gp in zip(vis, g_probe))
        denom = sum(torch.where(v, 1.0, 0.0) for v in vis)
        radii = torch.amax(torch.stack([torch.where(v, o["radii"].to(torch.float32), 0.0)
                                        for v, o in zip(vis, outs)]), dim=0)
        if mesh is not None:
            g, (accum, denom) = all_reduce_tree(scale_tree(g, 1.0 / world), mesh,
                                                extra=[accum, denom])
            radii = mesh.all_reduce(radii, op=dist.ReduceOp.MAX)
        state = dataclasses.replace(
            state,
            xyz_gradient_accum=state.xyz_gradient_accum + accum,
            denom=state.denom + denom,
            max_radii2d=torch.maximum(state.max_radii2d, radii))
        updates, opt_state = optimizer.update(g, ts.opt_state, ts.params)
        if xyz_lr_schedule is not None:
            scale = xyz_lr_schedule(ts.step) / max(optimizer.lr_tree["xyz"], 1e-12)
            updates = dataclasses.replace(updates, xyz=updates.xyz * scale)
        params = apply_updates(ts.params, updates)
        step = ts.step + 1
        if maintain and densify_due(step):
            params, state, touched = GA.densify_and_prune(
                params, state, densify_grad_threshold, min_opacity, extent,
                max_screen_size=size_threshold if step > opacity_reset_interval else math.inf,
                budget=densify_budget, percent_dense=model.cfg.percent_dense,
                generator=ts.generator)
            opt_state = zero_moment_rows(opt_state, touched, GA.SPLAT_FIELDS)
        if maintain and reset_due(step):
            params = GA.reset_opacity(params)
            opt_state = zero_moment_field(opt_state, "opacity")
        aux = _batch_aux(losses, outs, frames, mesh, whole_batch_psnr=True)
        aux["num_alive"] = torch.sum(state.alive)
        profiling.mark("end", ts.params.xyz.device)
        return BaselineTrainState(params=params, state=state, opt_state=opt_state,
                                  step=step, generator=ts.generator), aux

    step_fn.grads = grads
    step_fn.due = (None if xyz_lr_schedule is not None
                   else lambda step: densify_due(step) or reset_due(step))
    return step_fn


# ---------------------------------------------------------------------------
# FlashAvatar (train/iteration.py:93-124)
# ---------------------------------------------------------------------------

def flashavatar_optimizer(training_cfg: dict) -> MultiAdam:
    return MultiAdam(lr_tree=dict(
        opacity=training_cfg.get("opacity_lr", 0.05),
        features_dc=training_cfg.get("feature_dc_lr", 0.0025),
        features_rest=training_cfg.get("feature_dc_lr", 0.0025) / 20,
        rotation=training_cfg.get("rotation_lr", 0.001),
        scaling=training_cfg.get("scaling_lr", 0.005),
        deformer=training_cfg.get("deformer_lr", 1e-4),
    ))


def _never(step: int) -> bool:
    return False


def _plain_step(grads_fn, optimizer: MultiAdam, after=None, due=_never):
    """forward, loss, backward and Adam; ``after(params, state, opt_state,
    maintain, outs, mesh)`` -> (params, state, opt_state) runs the family's
    upkeep (``outs``: the frames' forward outputs; ``maintain``: whether the
    host-gated part runs, ``due(step)`` of the new count, or False)."""

    def step_fn(ts: BaselineTrainState, frame: Frame, mesh=None, maintain: bool = True):
        g, _, out, losses = grads_fn(ts, frame)
        dev = params_device(ts.params)
        profiling.mark("optimizer", dev)
        outs = out if isinstance(out, list) else [out]
        g = _reduce_grads(g, mesh)
        updates, opt_state = optimizer.update(g, ts.opt_state, ts.params)
        params, state, step = apply_updates(ts.params, updates), ts.state, ts.step + 1
        if after is not None:
            params, state, opt_state = after(params, state, opt_state,
                                             maintain and due(step), outs, mesh)
        aux = _batch_aux(losses, outs, _frames(frame), mesh)
        profiling.mark("end", dev)
        return BaselineTrainState(params=params, state=state, opt_state=opt_state,
                                  step=step, generator=ts.generator), aux

    step_fn.grads = grads_fn
    step_fn.due = due
    return step_fn


def _grads(forward, loss_fn):
    """The gradient phase of a step without a probe: ``forward(params,
    state, frame)`` -> the model's output."""
    def grads(ts: BaselineTrainState, frame: Frame):
        frames = _frames(frame)
        dev = params_device(ts.params)
        profiling.mark("forward", dev)

        def loss_of(p):
            outs = [forward(p, ts.state, f) for f in frames]
            profiling.mark("loss", dev)
            losses = _mean_losses([loss_fn(o, {"rgb": f.rgb}) for o, f in zip(outs, frames)])
            return losses["loss"], (outs, losses)

        g, _, (outs, losses) = param_grads(ts.params, loss_of)
        return g, None, (outs if frame.rgb.dim() == 4 else outs[0]), losses

    return grads


def make_flashavatar_step(model, net, loss_fn, optimizer: MultiAdam,
                          render_cfg: RenderConfig = RenderConfig()):
    """The ground truth passed to the loss is ``{"rgb": ...}`` only
    (baseline_steps.py:251 of the JAX package), so the mouth term is not
    reached from here."""

    def forward(p, state, f: Frame):
        return FA.flash_forward(model, p, net, f.expression, f.flame_pose, f.camera,
                                bg_color=f.bg_color, render_cfg=render_cfg)

    return _plain_step(_grads(forward, loss_fn), optimizer)


# ---------------------------------------------------------------------------
# SplattingAvatar (train/iteration.py:241-302)
# ---------------------------------------------------------------------------

def splattingavatar_optimizer(training_cfg: dict) -> MultiAdam:
    return MultiAdam(lr_tree=dict(
        uvd=training_cfg.get("uvd_lr", 0.005),
        opacity=training_cfg.get("opacity_lr", 0.05),
        features_dc=training_cfg.get("feature_dc_lr", 0.0025),
        features_rest=training_cfg.get("feature_dc_lr", 0.0025) / 20,
        rotation=training_cfg.get("rotation_lr", 0.001),
        scaling=training_cfg.get("scaling_lr", 0.005),
    ))


def _zero_uv_moments(opt_state: MultiAdamState) -> MultiAdamState:
    """Zero the uvd.xy Adam moments (splattingavatar.py:685-695)."""
    def zero_xy(tree):
        u = tree.uvd
        return dataclasses.replace(tree, uvd=torch.cat([torch.zeros_like(u[:, :2]), u[:, 2:]], 1))

    return dataclasses.replace(opt_state, mu=zero_xy(opt_state.mu), nu=zero_xy(opt_state.nu))


def make_splattingavatar_step(model, loss_fn, optimizer: MultiAdam,
                              render_cfg: RenderConfig = RenderConfig(),
                              triangle_walk_interval: int = 100):
    """The step; every ``triangle_walk_interval`` steps the walk commits the
    in-plane uvd and the uvd.xy moments are zeroed."""

    def forward(p, state, f: Frame):
        return SA.splat_forward(model, p, state, f.expression, f.flame_pose, f.camera,
                                bg_color=f.bg_color, render_cfg=render_cfg)

    def walk(params, state, opt_state, due, outs, mesh):
        if due:
            params, state = SA.walking_on_triangles(model, params, state)
            opt_state = _zero_uv_moments(opt_state)
        return params, state, opt_state

    return _plain_step(_grads(forward, loss_fn), optimizer, walk,
                       due=lambda step: step % triangle_walk_interval == 0)


# ---------------------------------------------------------------------------
# MonoGaussianAvatar (train/iteration.py:203-237; the epoch-level prune /
# upsample runs from the Trainer's epoch hook)
# ---------------------------------------------------------------------------

def monogaussianavatar_optimizer(training_cfg: dict) -> MultiAdam:
    lr = training_cfg.get("lr", 1e-4)
    return MultiAdam(lr_tree=dict(points=lr, geometry=lr, deformer=lr, gaussian=lr,
                                  rendering=lr))


def make_monogaussianavatar_step(model, nets, loss_fn, optimizer: MultiAdam,
                                 render_cfg: RenderConfig = RenderConfig()):
    """The step; the points seen at or above the prune threshold this step
    (by any frame of the batch) are added to ``state.visible``."""

    def forward(p, state, f: Frame):
        return MA.mono_forward(model, p, state, nets, f.expression, f.flame_pose, f.camera,
                               bg_color=f.bg_color, render_cfg=render_cfg)

    def seen(params, state, opt_state, due, outs, mesh):
        now = torch.stack([o["visible_now"] for o in outs]).any(dim=0)
        if mesh is not None:
            now = mesh.all_reduce(now.to(torch.float32), op=dist.ReduceOp.MAX) > 0
        return params, dataclasses.replace(state, visible=state.visible | now), opt_state

    return _plain_step(_grads(forward, loss_fn), optimizer, seen)


def mono_epoch_maintenance(ts: BaselineTrainState, model, epoch: int,
                           upsample_freq: int = 5, draws=None,
                           share=None) -> BaselineTrainState:
    """The epoch-level prune and upsample (train/trainer.py:204-227 and
    monogaussianavatar.py:430-467 of the reference), every ``upsample_freq``
    epochs: the epoch's target point count, noise of the current radius (of
    0.004 past epoch 100), zeroed moments on the written rows, the radius
    decayed. ``draws``: the upsample's draws (``MA.upsample_draws``), else
    drawn from the state's generator; ``share`` as in
    ``MA.prune_and_upsample``."""
    if epoch % upsample_freq != 0:
        return ts
    target = MA.target_points_for_epoch(epoch, model.cfg.max_points)
    radius = float(ts.state.radius)
    params, state, touched = MA.prune_and_upsample(
        ts.params, ts.state, target, radius if epoch <= 100 else 0.004, draws=draws,
        generator=ts.generator, share=share)
    state = dataclasses.replace(state, radius=torch.tensor(
        MA.radius_decay(epoch, radius), dtype=torch.float32, device=state.alive.device))
    return dataclasses.replace(ts, params=params, state=state, opt_state=zero_moment_rows(
        ts.opt_state, touched, ("points",)))
