"""Data-parallel training over ``torch.distributed``.

Port of ``fateavatar_tpu/parallel/data_parallel.py``. The JAX package runs
one program over a device ``Mesh``: a batch of B frames is split over the
``data`` axis (one frame per chip), the splat state is replicated, and XLA
inserts the gradient reduction. Here each rank is a process of its own on
one device, with one frame of each batch of B = world size:

* its gradients of its frame's loss are summed over the ranks by one
  all-reduce and divided by B, which gives the gradient of the mean loss
  over the B frames;
* the densification statistics are summed over the ranks and
  ``max_radii2d`` takes the largest;
* every rank applies the same Adam update, and densify and prune run on
  every rank, so the replicas stay bit-identical (the JAX docstring's
  requirement). Every rank draws densify's sources from a generator seeded
  alike, and every rank takes rank 0's draws (:meth:`DeviceMesh.broadcast`):
  ``torch.multinomial`` on a card draws through a ``cumsum`` whose float
  sums are not reproducible from run to run, so two ranks' draws can differ
  from the same generator state.

The step is ``train.step.make_train_step`` with ``mesh=``;
:func:`make_dp_train_step` gives it this rank's frame.

Rank ``r`` sits on ``cuda:(local_rank % device_count)``, or on the CPU. The
backend is NCCL when every rank of the host has a card of its own, gloo
when ranks share a card or run on the CPU.

Launch N ranks with ``torchrun --nproc-per-node N`` (or any launcher that
sets ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``), or
initialize the default process group before :func:`make_device_mesh`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from fateavatar_tpu_torch.models.fateavatar import FateAvatarModel
from fateavatar_tpu_torch.parallel import collectives
from fateavatar_tpu_torch.render.render import RenderConfig
from fateavatar_tpu_torch.train.optim import MultiAdam, map_leaves
from fateavatar_tpu_torch.train.step import Frame, MaintenanceConfig, TrainState, make_train_step


def launch_hint(n: int) -> str:
    return (f"launch {n} ranks, e.g. `torchrun --nproc-per-node {n} -m "
            f"fateavatar_tpu_torch.cli.train_mono_avatar --dp {n} ...`")


@dataclass
class DeviceMesh:
    """The ranks of one data axis: this process's ``rank`` of ``size``, its
    ``device``, the ``backend`` and the process ``group`` (None: the
    default group). ``owns_group``: :func:`make_device_mesh` initialized
    the default group (:meth:`close` destroys it)."""

    size: int
    rank: int
    device: torch.device
    backend: str
    group: Optional[object] = None
    owns_group: bool = False

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        return collectives.all_reduce_raw(x, op=op, group=self.group)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along dim 0 in rank order (bool
        through uint8)."""
        if x.dtype == torch.bool:
            return collectives.all_gather_raw(x.to(torch.uint8), self.group).to(torch.bool)
        return collectives.all_gather_raw(x, self.group)

    def broadcast(self, *tensors: torch.Tensor) -> tuple:
        """Rank 0's ``tensors`` on every rank (copies): the replicas take one
        rank's random draws."""
        return collectives.broadcast_raw(*tensors, group=self.group)

    def barrier(self):
        dist.barrier(group=self.group)

    def close(self):
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
            self.owns_group = False


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:(LOCAL_RANK % device_count)`` for cuda,
    else ``device`` as it is."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def choose_backend(device) -> str:
    """NCCL when the device is a card and every rank of the host has one of
    its own (``LOCAL_WORLD_SIZE`` <= device count), else gloo."""
    device = torch.device(device)
    if device.type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def make_device_mesh(n_devices: Optional[int] = None, device="cuda") -> DeviceMesh:
    """The data axis over every rank of the default process group,
    initializing it from the launcher's environment (``env://``) when it is
    not yet. ``n_devices`` other than the world size raises, with how to
    launch."""
    owns = False
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
            raise RuntimeError(
                f"data parallel over {n_devices} devices needs one process per rank: "
                + launch_hint(n_devices or 2))
        dev = rank_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(choose_backend(device), init_method="env://")
        owns = True
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"data parallel over {n_devices} devices, but the process group "
                         f"has {world} ranks: " + launch_hint(n_devices))
    return DeviceMesh(size=world, rank=dist.get_rank(), device=rank_device(device),
                      backend=dist.get_backend(), owns_group=owns)


def _tensors(obj) -> list:
    """Every tensor of a tree of dataclasses, dicts, tuples and lists, in
    field order."""
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj) for t in _tensors(getattr(obj, f.name))]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    if isinstance(obj, (tuple, list)):
        return [t for v in obj for t in _tensors(v)]
    return [obj] if torch.is_tensor(obj) else []


def replicate(tree, mesh: DeviceMesh):
    """Copy rank 0's tensors of a tree (a TrainState, tracking tables; see
    :func:`_tensors`) into every rank's, in place, so the replicas start
    equal."""
    for t in _tensors(tree):
        src = t.detach()
        if t.device != mesh.device:
            raise ValueError(f"replicate: a tensor on {t.device}, the mesh is on {mesh.device}")
        dist.broadcast(src, 0, group=mesh.group)
    return tree


def stack_frames(frame_list) -> Frame:
    """B Frames as one batched Frame (every tensor with a leading B; the
    camera's size and planes from the first)."""
    f0 = frame_list[0]

    def stack(xs):
        return None if xs[0] is None else torch.stack(xs)

    cams = [f.camera for f in frame_list]
    camera = dataclasses.replace(f0.camera, **{
        k: torch.stack([getattr(c, k) for c in cams])
        for k in ("view", "proj", "full_proj", "campos", "fovx", "fovy")})
    return Frame(expression=stack([f.expression for f in frame_list]),
                 flame_pose=stack([f.flame_pose for f in frame_list]),
                 camera=camera, rgb=stack([f.rgb for f in frame_list]),
                 bg_color=stack([f.bg_color for f in frame_list]),
                 world_transform=stack([f.world_transform for f in frame_list]))


def frame_at(frames: Frame, i: int) -> Frame:
    """Frame ``i`` of a batched Frame."""
    cam = frames.camera
    camera = dataclasses.replace(cam, **{
        k: getattr(cam, k)[i] for k in ("view", "proj", "full_proj", "campos", "fovx", "fovy")})
    wt = frames.world_transform
    return Frame(expression=frames.expression[i], flame_pose=frames.flame_pose[i],
                 camera=camera, rgb=frames.rgb[i], bg_color=frames.bg_color[i],
                 world_transform=None if wt is None else wt[i])


def unstack_frames(frames: Frame) -> list:
    """A batched Frame as its B Frames."""
    return [frame_at(frames, i) for i in range(frames.rgb.shape[0])]


def shard_frames(frames: Frame, mesh: DeviceMesh) -> Frame:
    """This rank's frame of a batched Frame whose leading B is the mesh
    size (the JAX package places row r on chip r)."""
    if frames.rgb.shape[0] != mesh.size:
        raise ValueError(f"a batch of {frames.rgb.shape[0]} frames over {mesh.size} ranks")
    return frame_at(frames, mesh.rank)


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])


def _unflat(buf: torch.Tensor, like) -> list:
    out, pos = [], 0
    for t in like:
        n = t.numel()
        out.append(buf[pos:pos + n].reshape(t.shape).to(t.dtype))
        pos += n
    return out


def all_reduce_tensors(tensors: list, mesh: DeviceMesh) -> list:
    """Tensors summed over the ranks in ONE all-reduce (flattened into a
    float32 buffer, and back to their types)."""
    return _unflat(mesh.all_reduce(_flat(tensors)), tensors)


def all_reduce_tree(tree, mesh: DeviceMesh, extra=()):
    """A gradient dataclass (dict fields included) and ``extra`` tensors,
    each summed over the ranks, in one all-reduce. Returns (tree, list of
    extra)."""
    leaves = _tensors(tree)
    red = iter(all_reduce_tensors([*leaves, *extra], mesh))
    new = dataclasses.replace(tree, **{
        f.name: map_leaves(lambda _: next(red), getattr(tree, f.name))
        for f in dataclasses.fields(tree)})
    return new, list(red)


def scale_tree(tree, scale: float):
    """A gradient dataclass (dict fields included) times ``scale``."""
    return dataclasses.replace(tree, **{
        f.name: map_leaves(lambda x: x * scale, getattr(tree, f.name))
        for f in dataclasses.fields(tree)})


def make_dp_train_step(
    model: FateAvatarModel,
    loss_fn,
    optimizer: MultiAdam,
    mesh: DeviceMesh,
    maint: MaintenanceConfig = MaintenanceConfig(),
    render_cfg: RenderConfig = RenderConfig(),
    return_grads: bool = False,
):
    """The data-parallel step, run by every rank: (TrainState, Frame) ->
    (TrainState, aux), ``train.step.make_train_step`` with ``mesh`` on this
    rank's frame, or on row ``rank`` of a batched Frame of all B. The loss
    is the mean over the B frames; densify and prune run when due, the
    opacity reset does not. Maintenance is turned off through ``maint``'s
    intervals."""
    step = make_train_step(model, loss_fn, optimizer, maint, render_cfg, mesh=mesh,
                           return_grads=return_grads)

    def step_fn(ts: TrainState, frame: Frame):
        if frame.rgb.dim() == 4:
            frame = shard_frames(frame, mesh)
        return step(ts, frame)

    return step_fn


def state_digest(tree, mesh: DeviceMesh) -> list:
    """Every rank's digest of a tree's tensors (:func:`_tensors`) (the first 7 bytes
    of a SHA-256 of their bytes, in field order), gathered: equal entries
    mean bit-identical replicas."""
    h = hashlib.sha256()
    for t in _tensors(tree):
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    digest = torch.tensor([int.from_bytes(h.digest()[:7], "big")], dtype=torch.int64,
                          device=mesh.device)
    return [int(x) for x in mesh.all_gather(digest).cpu()]
