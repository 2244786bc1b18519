"""MonoGaussianAvatar training cells: the port's ``Trainer`` with the
family's adapter over a seeded subject, its epochs as the scan epoch's CUDA
graph (the family's step, no maintenance due inside an epoch), at the
configuration's 100,000 points.

Set-up builds the family through the port's registry, then gives it the
benchmark's weights and points: the networks from the seed, the points
grown from the seed by the family's own schedule (clones of drawn points
with noise of the radius at each upsample epoch) to ``max_points``, the
radius decayed as at the epoch that reaches it. The render caps are the
configuration's, read by the port's ``cli.common.render_config`` as
``cli/train_baseline.py`` reads them. The window and the check are the
training driver's (``drivers/train.py``); the plain reference is
``reference/mono.py``.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from portbench import assets, counts, generator
from portbench.drivers import train as T
from portbench.reference import mono as ref
from portbench.reference import raster

ZERO = ("deformer.dense.4.weight", "deformer.dense.6.weight")


def build(ctx):
    from fateavatar_tpu_torch.flame.loader import make_flame
    from fateavatar_tpu_torch.models.baselines import monogaussianavatar as MA
    from fateavatar_tpu_torch.train import registry
    from fateavatar_tpu_torch.train.adapters import make_family_adapter
    from fateavatar_tpu_torch.train.trainer import Trainer
    from fateavatar_tpu_torch.cli import common
    from fateavatar_tpu_torch.utils.config import config_to_dict
    from fateavatar_tpu_torch.utils.obj_io import ObjMesh

    dev, seed, mix = ctx.device, ctx.seed, ctx.mix
    cfg = T._yaml_config(ctx.config, ctx.tmp)
    h, w = cfg.dataset.img_res
    data = assets.flame_data(seed)
    subj = generator.subject(mix, seed, dev)
    n_shape, n_exp = int(mix["n_shape"]), int(mix["n_exp"])
    flame = make_flame(data, n_shape=n_shape, n_exp=n_exp,
                       shape_params=np.zeros((1, n_shape), np.float32),
                       canonical_expression=np.zeros((1, n_exp), np.float32),
                       canonical_pose=cfg.dataset.canonical_pose, device=dev)
    verts, faces, uv, uvfaces = assets.template(data)
    entry = registry.get("monogaussianavatar")
    model_cfg = dict(config_to_dict(cfg.model))
    model_cfg.update(img_height=h, img_width=w, capacity=cfg.training.max_points_num)
    model, params, state, nets = entry.build_model(
        ObjMesh(verts=verts, faces=faces, uvcoords=uv, uvfaces=uvfaces), flame, model_cfg)
    n_max = params.points.shape[0]
    pts, radius = assets.mono_points(seed, model.cfg.n_init_points, n_max, dev,
                                     model.cfg.scene_scale)
    shapes = {net: {k: tuple(v.shape) for k, v in getattr(params, net).items()}
              for net in MA.NETS}
    weights = assets.mono_weights(seed, shapes, ZERO, dev)
    params = dataclasses.replace(params, points=pts, **weights)
    state = dataclasses.replace(
        state, alive=torch.ones((n_max,), dtype=torch.bool, device=dev),
        visible=torch.zeros((n_max,), dtype=torch.bool, device=dev),
        radius=torch.tensor(radius, dtype=torch.float32, device=dev))
    ds = T._subject_dataset(mix, subj)
    bundle = (model, params, state, nets)
    loss_fn = entry.build_loss(config_to_dict(cfg.loss), bundle)
    opt = entry.build_optimizer(config_to_dict(cfg.training))
    rcfg = common.render_config(cfg)
    adapter = make_family_adapter("monogaussianavatar", bundle, loss_fn, opt, rcfg,
                                  config_to_dict(cfg.training))
    trainer = Trainer("portbench-mono", model, params, state, loss_fn, opt, ds,
                      workspace=os.path.join(ctx.tmp, "workspace"), render_cfg=rcfg,
                      tracking_lr=cfg.training.tracking_lr, seed=seed, adapter=adapter,
                      device_frame_cache="on")
    trainer._frame_cache.update({i: subj["rgb"][i] for i in range(len(ds))})
    scan = trainer._maybe_scan_epoch()
    trainer._load_scan_state(scan)
    if dev.type == "cuda":
        scan.graph.capture()
    keep = {"data": data, "points": pts, "weights": weights, "radius": radius,
            "cfg": cfg, "mcfg": model.cfg, "n_shape": n_shape, "n_exp": n_exp,
            "frames": [(subj["expression"][i], subj["flame_pose"][i], subj["world_mats"][i],
                        subj["rgb"][i].clone()) for i in range(T.N_CHECKED)],
            "subj_codes": (subj["expression"], subj["flame_pose"], subj["world_mats"]),
            "fov": subj["fov"], "tracking": False}
    del subj
    return trainer, scan, keep


def _mono(keep, dev, dtype):
    m = keep["mcfg"]
    return ref.Mono(keep["data"], keep["n_shape"], keep["n_exp"],
                    keep["cfg"].dataset.canonical_pose,
                    {"cam_scale": m.cam_scale, "scene_scale": m.scene_scale}, dev, dtype)


def _params(keep, dev, dtype):
    p = {"points": keep["points"].to(dev).to(dtype)}
    p.update({net: {k: v.to(dev).to(dtype) for k, v in ws.items()}
              for net, ws in keep["weights"].items()})
    return p


def _state(keep, dev, dtype):
    n = keep["points"].shape[0]
    return {"alive": torch.ones((n,), dtype=torch.bool, device=dev),
            "radius": torch.tensor(keep["radius"], device=dev).to(dtype)}


def _cam(keep, wm, dev, dtype):
    h, w = keep["cfg"].dataset.img_res
    return {"R": wm[:3, :3].T, "T": torch.as_tensor(wm[:3, 3], device=dev).to(dtype),
            "fov": keep["fov"], "w": w, "h": h}


def reference_steps(keep, device, dtype=torch.float32, f8=False):
    """The reference's first steps from the seed's points and weights."""
    lcfg = {"rgb_weight": 1.0, "dssim_weight": 0.25, "lbs_weight": 10.0,
            "dataset_type": "insta"}
    frames = [{"expr": torch.as_tensor(e, device=device).to(dtype),
               "pose": torch.as_tensor(p, device=device).to(dtype),
               "cam": _cam(keep, wm, device, dtype),
               "gt": (rgb.to(device).to(torch.float32) / 255.0).to(dtype)}
              for e, p, wm, rgb in keep["frames"]]
    lr = dataclasses.asdict(keep["cfg"].training).get("lr", 1e-4)
    return ref.train_steps(_mono(keep, device, dtype), lcfg, lr, _params(keep, device, dtype),
                           _state(keep, device, dtype), frames, T.N_CHECKED)


def initial(keep) -> dict:
    return {k: v.cpu() for k, v in ref._flat(_params(keep, "cpu", torch.float32)).items()}


@torch.no_grad()
def traced_work(keep, params, first, n_traced, dev) -> dict:
    mono = _mono(keep, dev, torch.float32)
    p = ref._nest({k: v.to(dev) for k, v in params.items()})
    st = _state(keep, dev, torch.float32)
    exprs, poses, wms = keep["subj_codes"]
    n = len(exprs)
    h, w = keep["cfg"].dataset.img_res
    fwd = {"flops": 0.0, "bytes": 0.0}
    bwd = {"flops": 0.0, "bytes": 0.0}
    for j in range(n_traced):
        i = (first + j) % n
        soa, depth, radius = mono.render(p, st, torch.as_tensor(exprs[i], device=dev),
                                         torch.as_tensor(poses[i], device=dev),
                                         _cam(keep, wms[i], dev, torch.float32), grad=None)
        pairs = raster.pair_counts(soa, depth, radius, w, h)
        for acc, c in ((fwd, counts.blend_fwd(pairs)), (bwd, counts.blend_bwd(pairs))):
            acc["flops"] += c["flops"]
            acc["bytes"] += c["bytes"]
    n_pts = keep["points"].shape[0]
    mlp = sum(2.0 * n_pts * v.shape[0] * v.shape[1] for ws in keep["weights"].values()
              for k, v in ws.items() if k.endswith("weight") and not k.startswith("rendering"))
    fp32 = ((fwd["flops"] + bwd["flops"]) / n_traced + 3 * mlp
            + 2.0 * n_pts * len(keep["data"]["v_template"]) * 3
            + 3 * counts.flame_flops(len(keep["data"]["v_template"]),
                                     keep["n_shape"] + keep["n_exp"], passes=1))
    return {"blend_fwd_work": fwd, "blend_bwd_work": bwd,
            "ideal_step_s": counts.step_mfu_seconds(0.0, fp32)}


def run(ctx) -> dict:
    return T.run(ctx, sys.modules[__name__])
