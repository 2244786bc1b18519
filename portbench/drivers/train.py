"""Training cells: the port's ``Trainer`` over a seeded subject, its epochs
as the scan epoch's CUDA graph (one captured step replayed per frame; the
steps with maintenance due run eagerly).

Set-up builds the kernels (cached in the checkout's ``_build/``), the
FLAME model and avatar of the configuration from the seed's assets, the
subject's frames on the device (given to the Trainer's device frame cache,
as its first epoch would have left them), the Trainer on the binning caps
the configuration states, and warms up and captures the scan epoch's graph. The window
then calls ``Trainer.train_epoch()`` until ``seconds`` have passed and
closes with a synchronize: ``train_steps_per_s`` is every step of those
epochs over the window. The window's first three steps are that same
object's first steps from the seed: the harness reads their losses, the
Adam moments after the first and the parameters after the third, and the
plain reference (``reference/fateavatar.py``) follows the same three steps
after the window. Every step the run drives (the window's and the traced
epoch's) has its binning overflow counted: the reference drops no instance,
so a step that drops one renders a wrong image.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np
import torch

from portbench import assets, check, counts, generator, timing
from portbench.reference import fateavatar as ref
from portbench.reference import geometry as G
from portbench.reference import raster

N_CHECKED = 3          # steps the reference follows
TRACE_FROM, TRACE_N = 100, 20   # the traced replays within an epoch


def lrs_of(training: dict) -> dict:
    """The configuration's learning rate per parameter field (the
    reference's two optimizer groups, train/optim.py of FateAvatar)."""
    return {"opacity": training["opacity_lr"], "offset": training["offset_lr"],
            "features_dc": training["feature_dc_lr"],
            "features_rest": training["feature_dc_lr"] / 20.0,
            "rotation": training["rotation_lr"], "scaling": training["scaling_lr"],
            "delta_shapedirs": training["delta_shapedirs_lr"],
            "delta_posedirs": training["delta_posedirs_lr"],
            "delta_vertex": training["delta_vertex_lr"]}


def _subject_dataset(mix: dict, subj: dict):
    """The subject as a FaceDataset of the port: metadata per frame, the
    ground truth read back from the device only when a sample's
    ``ground_truth`` is indexed (snapshots)."""
    from fateavatar_tpu_torch.train.datasets import FaceDataset, FrameRecord

    class Lazy(dict):
        def __init__(self, rgb):
            super().__init__()
            self.rgb = rgb

        def __missing__(self, key):
            if key == "rgb":
                return self.rgb.cpu().numpy().astype(np.float32) / 255.0
            if key == "object_mask":
                return np.ones(self.rgb.shape[:2] + (1,), np.float32)
            raise KeyError(key)

    class Subject(FaceDataset):
        type_name = "synthetic"
        optimize_tracking = bool(mix["tracking"])

        def __init__(self):
            super().__init__(mix["img_res"], cache_images=False)
            n = int(mix["frames"])
            self.n_shape, self.n_exp = int(mix["n_shape"]), int(mix["n_exp"])
            self.expressions, self.flame_pose = subj["expression"], subj["flame_pose"]
            self.world_mats = subj["world_mats"]
            self.fovx = self.fovy = subj["fov"]
            self.shape_params = np.zeros((1, self.n_shape), np.float32)
            self.mean_expression = np.zeros((1, self.n_exp), np.float32)
            self.var_expression = None
            self.records = [FrameRecord(image_path=f"portbench://{i}", mask_path=None,
                                        img_name=str(i)) for i in range(n)]

        def sample(self, idx):
            return {"idx": idx, "img_name": str(idx), "fovx": self.fovx, "fovy": self.fovy,
                    "expression": self.expressions[idx], "flame_pose": self.flame_pose[idx],
                    "cam_pose": self.world_mats[idx], "ground_truth": Lazy(subj["rgb"][idx])}

    return Subject()


def flat(obj) -> dict:
    """The tensors of a dataclass by field, a dict field's by
    ``<field>.<key>`` (a network's weights)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, dict):
            out.update({f"{f.name}.{k}": t.detach().clone() for k, t in v.items()})
        else:
            out[f.name] = v.detach().clone()
    return out


class _Observed:
    """The scan epoch's graph with the harness looking on: after replay 1 it
    keeps the Adam first moments, after replay ``N_CHECKED`` the parameters,
    then hands the graph back to the epoch."""

    def __init__(self, scan):
        self.scan, self.graph, self.n = scan, scan.graph, 0
        self.mu1 = self.p3 = None

    def __call__(self):
        self.graph()
        self.n += 1
        ts = self.scan.ts
        if self.n == 1:
            self.mu1 = flat(ts.opt_state.mu)
            if self.scan.tracking:
                self.mu1.update({f"tables.{k}": getattr(self.scan.track_state.mu, k)[0].clone()
                                 for k in ref.TRACK_FIELDS})
        if self.n == N_CHECKED:
            self.p3 = flat(ts.params)
            if self.scan.tracking:
                self.p3.update({f"tables.{k}": getattr(self.scan.tables, k)[:N_CHECKED].clone()
                                for k in ref.TRACK_FIELDS})
            self.scan.graph = self.graph

    def __getattr__(self, name):
        return getattr(self.graph, name)


class _Traced:
    """The graph with the profiler started before replay ``TRACE_FROM`` of
    the epoch (at most half the epoch in) and stopped after ``TRACE_N``
    replays; keeps the parameters and the frame cursor at the start."""

    def __init__(self, scan, device, n_frames):
        from torch.profiler import ProfilerActivity, profile

        self.scan, self.graph, self.device, self.n = scan, scan.graph, device, 0
        self.start = min(TRACE_FROM, n_frames // 2)
        self.count = min(TRACE_N, n_frames - self.start)
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.window_s = self.params = self.first_frame = None
        self.replays = 0

    def __call__(self):
        if self.n == self.start:
            ts = self.scan.ts
            self.params = flat(ts.params)
            self.first_frame = int(self.scan.cursor.item())
            timing.sync(self.device)
            self.prof.start()
            self.t0 = time.perf_counter()
        self.graph()
        self.n += 1
        if self.start <= self.n - 1 < self.start + self.count:
            self.replays += 1
        if self.n == self.start + self.count:
            timing.sync(self.device)
            self.window_s = time.perf_counter() - self.t0
            self.prof.stop()
            self.scan.graph = self.graph

    def __getattr__(self, name):
        return getattr(self.graph, name)


def _yaml_config(cfg_doc: dict, tmp: str):
    """The port's Config of the configuration file's ``yaml`` section,
    written out as YAML and read by the port's own loader, with its
    ``overrides``."""
    import yaml

    from fateavatar_tpu_torch.utils.config import load_config

    path = os.path.join(tmp, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg_doc["yaml"], f)
    return load_config(path, list(cfg_doc.get("overrides", [])))


def build(ctx):
    """Set-up of a FateAvatar training cell: returns the Trainer and what
    the check and the counts need."""
    from fateavatar_tpu_torch.cli import common
    from fateavatar_tpu_torch.flame.loader import make_flame
    from fateavatar_tpu_torch.train.losses import FateAvatarLoss
    from fateavatar_tpu_torch.train.optim import fateavatar_optimizers
    from fateavatar_tpu_torch.train.trainer import Trainer
    from fateavatar_tpu_torch.utils.config import config_to_dict
    from fateavatar_tpu_torch.utils.obj_io import ObjMesh

    dev, seed, mix = ctx.device, ctx.seed, ctx.mix
    cfg = _yaml_config(ctx.config, ctx.tmp)
    data = assets.flame_data(seed)
    subj = generator.subject(mix, seed, dev)
    n_shape, n_exp = int(mix["n_shape"]), int(mix["n_exp"])
    flame = make_flame(data, n_shape=n_shape, n_exp=n_exp,
                       shape_params=np.zeros((1, n_shape), np.float32),
                       canonical_expression=np.zeros((1, n_exp), np.float32),
                       canonical_pose=cfg.dataset.canonical_pose, device=dev)
    verts, faces, uv, uvfaces = assets.template(data)
    model, p0, s0 = common.construct_model(
        cfg, flame, template=ObjMesh(verts=verts, faces=faces, uvcoords=uv, uvfaces=uvfaces),
        device=dev)
    n_splats = cfg.model.tex_size ** 2
    params, state = assets.fateavatar_avatar(seed, data, cfg.training.max_points_num, n_splats,
                                             n_shape + n_exp, dev,
                                             sh_rest=p0.features_rest.shape[1])
    p0 = dataclasses.replace(p0, **params)
    s0 = dataclasses.replace(s0, **state)
    vgg = assets.vgg16_weights(seed, dev)
    ds = _subject_dataset(mix, subj)
    trainer = Trainer("portbench", model, p0, s0,
                      FateAvatarLoss(common.loss_config(cfg), faces=model.faces, vgg_params=vgg),
                      fateavatar_optimizers(config_to_dict(cfg.training)), ds,
                      workspace=os.path.join(ctx.tmp, "workspace"),
                      maint_cfg=common.maintenance_config(cfg),
                      render_cfg=common.render_config(cfg),
                      tracking_lr=cfg.training.tracking_lr, seed=seed,
                      device_frame_cache="on")
    # the device frame cache as the first (per-step) epoch leaves it
    trainer._frame_cache.update({i: subj["rgb"][i] for i in range(len(ds))})
    scan = trainer._maybe_scan_epoch()
    trainer._load_scan_state(scan)
    if dev.type == "cuda":
        scan.graph.capture()
    keep = {"data": data, "params0": params, "state": state, "vgg": vgg, "cfg": cfg,
            "frames": [(subj["expression"][i], subj["flame_pose"][i], subj["world_mats"][i],
                        subj["rgb"][i].clone()) for i in range(N_CHECKED)],
            "subj_codes": (subj["expression"], subj["flame_pose"], subj["world_mats"]),
            "fov": subj["fov"], "n_shape": n_shape, "n_exp": n_exp,
            "tracking": bool(mix["tracking"])}
    del subj
    return trainer, scan, keep


def _ref_avatar(keep, device, dtype=torch.float32):
    cfg = keep["cfg"]
    mcfg = {"canonical_pose": cfg.dataset.canonical_pose,
            "delta_blendshape": cfg.model.delta_blendshape,
            "delta_vertex": cfg.model.delta_vertex, "normal_offset": cfg.model.normal_offset,
            "resize_scale": cfg.model.resize_scale}
    return ref.Avatar(keep["data"], keep["n_shape"], keep["n_exp"], mcfg, device, dtype)


def _ref_frames(keep, device, dtype):
    def t(x):
        return torch.as_tensor(x, device=device).to(dtype)

    return [{"expr": t(expr), "pose": t(pose), "R": wm[:3, :3].T, "T": t(wm[:3, 3]),
             "fov": keep["fov"], "gt": (rgb.to(device).to(torch.float32) / 255.0).to(dtype)}
            for expr, pose, wm, rgb in keep["frames"]]


def initial(keep) -> dict:
    """The parameters before the first step (and the tracked rows of the
    checked frames where the mix tracks)."""
    out = _host(keep["params0"])
    if keep["tracking"]:
        fr = keep["frames"]
        out.update({"tables.expression": torch.as_tensor(np.stack([f[0] for f in fr])),
                    "tables.flame_pose": torch.as_tensor(np.stack([f[1] for f in fr])),
                    "tables.cam_t": torch.as_tensor(np.stack([f[2][:3, 3] for f in fr]))})
    return out


def reference_steps(keep, device, dtype=torch.float32, f8=False):
    """The reference's first ``N_CHECKED`` steps from the seed's avatar:
    (losses, first gradients, parameters after the last step)."""
    cfg = keep["cfg"]
    lcfg = {k: getattr(cfg.loss, k) for k in (
        "rgb_weight", "vgg_weight", "scale_weight", "scale_threshold", "laplacian_weight",
        "dssim_weight", "lpips_weight", "rot_weight", "normal_weight", "flame_weight")}
    if cfg.loss.rgb_type != "l1":
        raise ValueError("the reference's rgb term is l1")
    vgg_dtype = torch.bfloat16 if cfg.loss.vgg_dtype == "bfloat16" else torch.float32
    av = _ref_avatar(keep, device, dtype)
    p0 = {k: v.to(device).to(dtype) if v.is_floating_point() else v.to(device)
          for k, v in keep["params0"].items()}
    st = {k: v.to(device) for k, v in keep["state"].items()}
    return ref.train_steps(av, lcfg, lrs_of(dataclasses.asdict(cfg.training)), keep["vgg"], vgg_dtype,
                           p0, st, _ref_frames(keep, device, dtype), N_CHECKED, f8=f8,
                           track_lr=cfg.training.tracking_lr if keep["tracking"] else None)


def compare(prog: dict, refr: tuple, params0: dict) -> dict:
    """The three numbers of a training cell (program against reference)."""
    losses_r, g_r, p_r = refr
    g_p = {k: v / (1.0 - ref.B1) for k, v in prog["mu1"].items()}
    dp_p = {k: prog["p3"][k].double() - params0[k].double() for k in params0}
    dp_r = {k: p_r[k].double() - params0[k].double() for k in params0}
    grad_gap, grad_leaf = check.leaf_gaps(g_p, g_r, g_r)
    upd_gap, upd_leaf = check.leaf_gaps(dp_p, dp_r, g_r)
    return {"loss_gap": check.loss_gap(prog["losses"], losses_r), "grad_norm_gap": grad_gap,
            "update_norm_gap": upd_gap,
            "_leaves": f"grad {grad_leaf}, update {upd_leaf}"}


def first_steps(trainer, scan):
    """Drive the first ``N_CHECKED`` steps through the scan epoch's graph
    outside an epoch (the calibration's reading, no window): the same calls
    the epoch makes."""
    obs = _Observed(scan)
    for _ in range(N_CHECKED):
        obs()
    timing.sync(trainer.device)
    return {"mu1": obs.mu1, "p3": obs.p3, "losses": scan.aux["loss"][:N_CHECKED].tolist()}


def _host(d: dict) -> dict:
    return {k: v.cpu() for k, v in d.items()}


KERNEL_LIBS = ("blend_instances", "blend_instances_bwd")


def run(ctx, fam=None) -> dict:
    """One run of a training cell; ``fam`` the module of the family's
    ``build``, ``reference_steps``, ``initial`` and ``traced_work``
    (FateAvatar's: this one)."""
    fam = fam or sys.modules[__name__]
    dev = ctx.device
    if dev.type == "cuda":
        from fateavatar_tpu_torch.utils import cuda_build

        cuda_build.build_all(KERNEL_LIBS)
    trainer, scan, keep = fam.build(ctx)
    timing.sync(dev)
    setup_s = time.perf_counter() - ctx.t_start
    n = len(trainer.train_dataset)
    due = trainer._due()

    # ---- the window
    obs = _Observed(scan)
    scan.graph = obs
    graph = obs.graph
    r0, step0 = graph.replays, trainer.ts.step
    first_losses = None
    t0 = time.perf_counter()
    epochs = overflow = 0
    while True:
        trainer.train_epoch()
        epochs += 1
        if first_losses is None:
            first_losses = [float(x) for x in trainer.last_epoch_aux["loss"][:N_CHECKED]]
        overflow += int(np.sum(trainer.last_epoch_aux["overflow"]))
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    timing.sync(dev)
    window_s = time.perf_counter() - t0
    steps = epochs * n
    replays = graph.replays - r0
    eager = sum(1 for s in range(step0 + 1, step0 + steps + 1) if due(s))
    readings = {"steps": steps, "eager_steps": steps - replays, "eager_due": eager,
                "epochs": epochs, "window_s": window_s}

    traced = None
    if ctx.trace:
        traced = _Traced(scan, dev, n)
        scan.graph = traced
        trainer.train_epoch()
        overflow += int(np.sum(trainer.last_epoch_aux["overflow"]))
        readings.update(_trace_readings(traced))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    prog = {"mu1": _host(obs.mu1), "p3": _host(obs.p3), "losses": first_losses}
    traced_params = None if traced is None else _host(traced.params)
    traced_first = None if traced is None else traced.first_frame
    del trainer, scan, obs, graph, traced
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the check, after the window, the program's state freed
    t_ref = time.perf_counter()
    refr = fam.reference_steps(keep, dev)
    params0 = fam.initial(keep)
    numbers = compare(prog, tuple([refr[0], _host(refr[1]), _host(refr[2])]), params0)
    readings["leaves"] = numbers.pop("_leaves")
    # instances the binning caps dropped in every step the run drove
    numbers["overflow_window"] = float(overflow)
    readings["reference_s"] = time.perf_counter() - t_ref
    if traced_params is not None:
        work = fam.traced_work(keep, traced_params, traced_first, readings["trace_replays"],
                               dev)
        # each pass of a replay does a frame's work (the tracking step's
        # forward and backward on the same frame after the update)
        for k in ("blend_fwd_work", "blend_bwd_work"):
            work[k] = {q: v * readings["passes"] for q, v in work[k].items()}
        work["ideal_step_s"] *= readings["passes"]
        readings.update(work)
    return {"setup_s": setup_s, "e2e": {"train_steps_per_s": steps / window_s,
                                        "setup_s": setup_s},
            "numbers": numbers, "attempted": steps, "failed": 0, "memory_peak": peak,
            "readings": readings}


def _trace_readings(traced) -> dict:
    prof = traced.prof
    ks = timing.kernel_seconds(prof)
    busy = timing.device_union_us(prof) * 1e-6
    per = traced.graph.launches_per_replay
    return {"trace_replays": traced.replays, "trace_window_s": traced.window_s,
            # forward and backward passes a replay (2 each with the tracking step)
            "passes": max(1, per.get("blend_instances_fwd", 1)),
            "busy_s": busy, "kernels": ks, "breakdown": timing.breakdown(prof),
            "blend_fwd_s": timing.seconds_of(ks, timing.FWD_KERNELS),
            "blend_bwd_s": timing.seconds_of(ks, timing.BWD_KERNELS),
            "conv_s": timing.seconds_of(ks, timing.CONV_MARKS, lower=True)}


@torch.no_grad()
def traced_work(keep, params, first, n_traced, dev) -> dict:
    """The traced replays' work from the reference's own pairs: each traced
    frame's blend inputs worked out from the parameters at the start of
    the traced replays."""
    cfg = keep["cfg"]
    h, w = cfg.dataset.img_res
    av = _ref_avatar(keep, dev)
    p = {k: v.to(dev) for k, v in params.items()}
    st = {k: v.to(dev) for k, v in keep["state"].items()}
    exprs, poses, wms = keep["subj_codes"]
    n = len(exprs)
    fwd = {"flops": 0.0, "bytes": 0.0}
    bwd = {"flops": 0.0, "bytes": 0.0}
    for j in range(n_traced):
        i = (first + j) % n
        cam = G.camera(wms[i][:3, :3].T, wms[i][:3, 3], keep["fov"], keep["fov"], w, h, dev)
        soa, depth, radius = av.frame_soa(p, st, torch.as_tensor(exprs[i], device=dev),
                                          torch.as_tensor(poses[i], device=dev), cam)
        pairs = raster.pair_counts(soa, depth, radius, w, h)
        for acc, c in ((fwd, counts.blend_fwd(pairs)), (bwd, counts.blend_bwd(pairs))):
            acc["flops"] += c["flops"]
            acc["bytes"] += c["bytes"]
    n_codes = keep["n_shape"] + keep["n_exp"]
    fp32 = (fwd["flops"] + bwd["flops"]) / n_traced + 3 * counts.flame_flops(
        len(keep["data"]["v_template"]), n_codes)
    bf16 = counts.vgg_loss_flops(train=True) if cfg.loss.vgg_weight > 0 else 0.0
    return {"blend_fwd_work": fwd, "blend_bwd_work": bwd,
            "ideal_step_s": counts.step_mfu_seconds(bf16, fp32)}
