"""Reenactment cells: one client calling ``Reenactor.reenact`` back to back
(a closed loop) with driving clips, on an avatar restored from its
workspace's checkpoint by the port's ``Loader``.

Set-up builds the kernel (cached in the checkout's ``_build/``), the
serving FLAME model and the seed's avatar, writes its checkpoint into the
run's temporary workspace, restores the avatar through ``Reenactor`` on the
render settings the configuration states (read by ``cli.common.render_config``
as ``cli/avatar_reenact.py`` reads them) and serves one short clip to warm
up. The window serves clips in the mix's
order until ``seconds`` have passed; each call is timed from its start until
its uint8 frames are on the host. Two frames of every clip (one at a
position drawn from the seed, and the last) are kept; after the window a
sample of clips drawn from the seed, the longest served among them, is
rendered by the plain reference (``reference/fateavatar.py``) and compared
pixel by pixel.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from portbench import assets, counts, generator, timing
from portbench.drivers.train import _ref_avatar, _yaml_config
from portbench.reference import geometry as G
from portbench.reference import raster

N_SAMPLE = 12          # clips compared with the reference
TRACE_CLIPS = 1        # clips served under the profiler


def build(ctx):
    from fateavatar_tpu_torch.cli import common
    from fateavatar_tpu_torch.flame.loader import make_flame
    from fateavatar_tpu_torch.ops.camera import make_camera
    from fateavatar_tpu_torch.train.checkpoints import CheckpointManager
    from fateavatar_tpu_torch.train.loader import Reenactor, checkpoint_tree
    from fateavatar_tpu_torch.utils.obj_io import ObjMesh

    dev, seed, mix = ctx.device, ctx.seed, ctx.mix
    cfg = _yaml_config(ctx.config, ctx.tmp)
    data = assets.flame_data(seed)
    n_shape, n_exp = int(mix["n_shape"]), int(mix["n_exp"])
    flame = make_flame(data, n_shape=n_shape, n_exp=n_exp,
                       canonical_pose=cfg.dataset.canonical_pose, device=dev)
    verts, faces, uv, uvfaces = assets.template(data)
    model, p0, s0 = common.construct_model(
        cfg, flame, template=ObjMesh(verts=verts, faces=faces, uvcoords=uv, uvfaces=uvfaces),
        device=dev)
    params, state = assets.fateavatar_avatar(seed, data, cfg.training.max_points_num,
                                             cfg.model.tex_size ** 2, n_shape + n_exp, dev,
                                             sh_rest=p0.features_rest.shape[1])
    ws = os.path.join(ctx.tmp, "workspace")
    CheckpointManager(os.path.join(ws, "checkpoints")).save(
        1, checkpoint_tree(dataclasses.replace(p0, **params), dataclasses.replace(s0, **state),
                           epoch=1, global_step=1))
    traffic = generator.clips(mix, seed)
    h, w = cfg.dataset.img_res
    d = traffic["camera_distance"]
    cam = make_camera(np.eye(3, dtype=np.float32), np.array([0, 0, d], np.float32),
                      traffic["fov"], traffic["fov"], w, h, device=dev)
    reenactor = Reenactor(model, p0, s0, ws, render_cfg=common.render_config(cfg))
    keep = {"data": data, "params": params, "state": state, "cfg": cfg, "n_shape": n_shape,
            "n_exp": n_exp, "traffic": traffic, "h": h, "w": w}
    return reenactor, cam, keep


def _serve(reenactor, traffic, k, cam):
    s, n = int(traffic["starts"][k]), traffic["lengths"][k]
    return reenactor.reenact(traffic["expression"][s:s + n], traffic["flame_pose"][s:s + n],
                             traffic["delta"], cam)


def run(ctx) -> dict:
    dev = ctx.device
    if dev.type == "cuda":
        from fateavatar_tpu_torch.utils import cuda_build

        cuda_build.build_all(["blend_instances"])
    reenactor, cam, keep = build(ctx)
    traffic = keep["traffic"]
    s0 = int(traffic["starts"][0])
    reenactor.reenact(traffic["expression"][s0:s0 + 2], traffic["flame_pose"][s0:s0 + 2],
                      traffic["delta"], cam)
    timing.sync(dev)
    setup_s = time.perf_counter() - ctx.t_start

    captures, restore = ([], None) if not ctx.trace else _time_captures(dev)
    pos_rng = np.random.default_rng(ctx.seed)
    lat, kept, served = [], [], 0
    n_lengths = len(traffic["lengths"])
    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < ctx.seconds:
        c = k % n_lengths
        t1 = time.perf_counter()
        frames = _serve(reenactor, traffic, c, cam)
        lat.append((time.perf_counter() - t1) * 1e3)
        served += len(frames)
        j = int(pos_rng.integers(len(frames)))
        kept.append((c, j, frames[j], len(frames) - 1, frames[-1]))
        k += 1
    window_s = time.perf_counter() - t0
    readings = {"clips": len(lat), "frames": served, "window_s": window_s,
                "clip_ms_median": float(np.median(lat)), "latencies_ms": lat}
    if ctx.trace:
        restore()
        readings["capture_ms"] = float(np.mean([c[1] for c in captures])) if captures else None
        readings["captures"] = len(captures)
        readings.update(_traced(reenactor, traffic, k, cam, dev))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del reenactor
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    numbers = compare(keep, kept, ctx.seed, dev)
    readings["reference_s"] = time.perf_counter() - t_ref
    if ctx.trace:
        readings.update(_counts(keep, readings.pop("traced_clips"), dev))
    return {"setup_s": setup_s,
            "e2e": {"reenact_frames_per_s": served / window_s,
                    "clip_ms_p90": float(np.percentile(lat, 90)), "setup_s": setup_s},
            "numbers": numbers, "attempted": len(lat), "failed": 0, "memory_peak": peak,
            "readings": readings}


def reference_frame(av, keep, clip: int, j: int, dev, dtype=torch.float32):
    """The reference's float image of frame ``j`` of clip ``clip``."""
    t = keep["traffic"]
    i = int(t["starts"][clip]) + j
    n_exp = keep["n_exp"]
    e = np.zeros((n_exp,), np.float32)
    m = min(n_exp, t["expression"].shape[1])
    e[:m] = t["expression"][i, :m]
    dl = min(n_exp, len(t["delta"]))
    e[:dl] -= t["delta"][:dl]
    cam = G.camera(np.eye(3), [0.0, 0.0, t["camera_distance"]], t["fov"], t["fov"],
                   keep["w"], keep["h"], dev, dtype=dtype)
    p = {k: v.to(dtype) for k, v in keep["params"].items()}
    with torch.no_grad():
        img, _ = av.render(p, keep["state"], torch.as_tensor(e, device=dev).to(dtype),
                           torch.as_tensor(t["flame_pose"][i], device=dev).to(dtype), cam)
    return img.float()


def frame_gap(u8: np.ndarray, img: torch.Tensor) -> float:
    """The widest gap, in 1/255 steps, between a served uint8 frame and the
    reference's image scaled to [0, 255] (unrounded)."""
    want = torch.clamp(img * 255.0, 0, 255)
    return float((torch.as_tensor(u8, device=img.device).float() - want).abs().max())


def sample_clips(kept: list, seed: int) -> list:
    """Up to ``N_SAMPLE`` served clips drawn from the seed, the longest
    served clip among them."""
    longest = max(range(len(kept)), key=lambda i: kept[i][3])
    rest = [i for i in range(len(kept)) if i != longest]
    rng = np.random.default_rng(seed + 1)
    pick = rng.choice(len(rest), size=min(N_SAMPLE - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def compare(keep, kept, seed, dev, dtype=torch.float32) -> dict:
    av = _ref_avatar(keep, dev, dtype)
    gap = 0.0
    for i in sample_clips(kept, seed):
        c, j, fj, last, fl = kept[i]
        gap = max(gap, frame_gap(fj, reference_frame(av, keep, c, j, dev, dtype)),
                  frame_gap(fl, reference_frame(av, keep, c, last, dev, dtype)))
    return {"frame_gap": gap}


def _time_captures(dev):
    """Wrap ``Graph.capture`` in a synchronized host-clock span for the trace
    run: returns the list the (graph name, ms) spans go to, and the function
    that puts ``Graph.capture`` back."""
    from fateavatar_tpu_torch.utils import graphs

    spans = []
    orig = graphs.Graph.capture

    def capture(self):
        timing.sync(dev)
        t0 = time.perf_counter()
        orig(self)
        timing.sync(dev)
        spans.append((self.name, (time.perf_counter() - t0) * 1e3))

    def restore():
        graphs.Graph.capture = orig

    graphs.Graph.capture = capture
    return spans, restore


def _traced(reenactor, traffic, k, cam, dev) -> dict:
    from torch.profiler import ProfilerActivity, profile

    n_lengths = len(traffic["lengths"])
    clips = [(k + i) % n_lengths for i in range(TRACE_CLIPS)]
    timing.sync(dev)
    frames = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for c in clips:
            frames += len(_serve(reenactor, traffic, c, cam))
        timing.sync(dev)
        window = time.perf_counter() - t0
    ks = timing.kernel_seconds(prof)
    return {"trace_window_s": window, "trace_frames": frames, "kernels": ks,
            "busy_s": timing.device_union_us(prof) * 1e-6, "breakdown": timing.breakdown(prof),
            "blend_fwd_s": timing.seconds_of(ks, timing.FWD_KERNELS),
            "traced_clips": clips}


@torch.no_grad()
def _counts(keep, clips, dev) -> dict:
    """The blend work of the traced calls from the reference's own pairs:
    every served frame, and frame 0 of each call three times more for the
    graph's warm-up calls."""
    from fateavatar_tpu_torch.utils.graphs import WARMUP

    av = _ref_avatar(keep, dev, torch.float32)
    t = keep["traffic"]
    p = keep["params"]
    fwd = {"flops": 0.0, "bytes": 0.0}
    served = 0
    for c in clips:
        s, n = int(t["starts"][c]), t["lengths"][c]
        for j in range(n):
            i = s + j
            e = t["expression"][i] - t["delta"]
            cam = G.camera(np.eye(3), [0.0, 0.0, t["camera_distance"]], t["fov"], t["fov"],
                           keep["w"], keep["h"], dev)
            soa, depth, radius = av.frame_soa(p, keep["state"], torch.as_tensor(e, device=dev),
                                              torch.as_tensor(t["flame_pose"][i], device=dev),
                                              cam)
            c_ = counts.blend_fwd(raster.pair_counts(soa, depth, radius, keep["w"], keep["h"]))
            times = 1 + (WARMUP if j == 0 else 0)
            fwd["flops"] += times * c_["flops"]
            fwd["bytes"] += times * c_["bytes"]
            served += 1
    per_frame_fp32 = fwd["flops"] / (served + WARMUP * len(clips)) + counts.flame_flops(
        len(keep["data"]["v_template"]), keep["n_shape"] + keep["n_exp"])
    return {"blend_fwd_work": fwd, "ideal_frame_s": counts.step_mfu_seconds(0.0, per_frame_fp32)}
