#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

It builds every CUDA kernel of the port from ``fateavatar_tpu_torch/csrc``
(the instance blend's and the dense-list blend's forward and backward, one
nvcc each, in parallel), holds each against its plain PyTorch version on
the card, and drives the port's main paths at the full width of
``configs/fateavatar.yaml`` (65,536 splats at a 200,000 capacity, 512x512,
twotier binning setting R = 64) from seeded synthetic assets (a FLAME
pickle at FLAME's 5,023 vertices, a matching UV template, random VGG16
weights), each through both routes of ``RenderConfig.kernel``:

* serving: ``cli/common`` -> ``Loader`` -> ``Reenactor.reenact`` over 16
  frames of a checkpointed, perturbed avatar, through the instance blend,
  then through the dense-list blend (``kernel="tiles"``);
* training: the ``Trainer`` (per-step mode, autosize, the yaml's loss and
  learning rates, densify / prune intervals shortened so both fire) over a
  ``SyntheticDataset`` of 512x512 frames for one epoch, then ``evaluate``,
  ``save_checkpoint``, and a fresh Trainer that ``load_checkpoint``s and
  trains on; one train step's gradients with the kernels against the same
  step with both blends swapped for their plain versions; then the same
  epoch and step checks with ``kernel="tiles"``, and one step's gradients
  through the tiles route against the instances route;
* the CLIs (``[cli]``): an IMAvatar layout written to disk with the port's
  PNG writer (the serving checkpoint's renders as ground truth), then
  ``cli/train_mono_avatar`` with per-frame tracking refinement, snapshots,
  the test rows' fit, evaluation and its media, ``--resume``, and
  ``cli/avatar_reenact``; launches per step, tracking counts, media files,
  and one tracking step's row gradients with the kernels against the
  plain blends;
* CUDA graphs (``[graph]``): the Trainer's scan epoch (one captured step
  replayed per frame) on the ``[train]`` Trainer, on a Trainer of 8 frames
  through ``kernel="tiles"`` and on the ``[cli]`` Trainer with its
  tracking step: one step eager against the graph's first replay, a whole
  epoch each way from one state (maintenance steps eager in both), ms/step
  each way, the replays under the profiler; ``fps_performance_test``; and
  ``Reenactor.reenact``'s graph on both routes against the eager loop (bit
  for bit), with ms/frame each way;
* the rasterizer's options (``[options]``), on the serving cell at caps
  probed from its frame 0: every instance binning mode (onesort, twotier,
  stable, count, gather, twokey) in the compact layout and in the aligned
  one with either re-layout, bit-equal to the same mode's run on the CPU,
  with its ms and the frame rendered under each; one step's ``render()``
  gradients through the slots, grouped and sorted transposes against the
  slim one; the early exit of ``t_cutoff`` 1e-3 and 1e-2 in kernels 1 and
  2 against the plain versions on the served frame and on the same frame
  with every opacity raised to 0.9 (the cut per tile, the forward, the
  backward, a NaN-filled backward buffer, 1e-4 giving the bits of 0), with
  the kernels' ms, the cut's and the columns walked; and
  ``Reenactor.reenact``'s graph (count binning, aligned layout, t_cutoff
  1e-3) and one Trainer graph step at t_cutoff 1e-3, each bit-equal to
  eager; ``[baselines]`` adds the early exit's reading on
  MonoGaussianAvatar's deep lists;
* neural baking (``[bake]``): ``cli/train_neural_baking`` on the ``[cli]``
  workspace (the UNet decoder from its fixed 512x512 const, the avatar
  doubled to 265,536 splats, 2 epochs through the bake step's CUDA graph):
  launches per replay and per eager step, falling losses, the texture and
  baked-avatar files, one step's gradients with the kernels against the
  plain blends, graph against eager from one state, ms/step each way (and
  eagerly with cuDNN's TF32 on, which the port turns off), the stage split, the capture's cost, peak memory, and the
  baked textures' render against the splat render; then texture editing
  (``[edit]``): ``cli/avatar_edit_baked`` with a sticker written by the
  port's PNG writer, the edited frame against the unedited one, ms/frame;
* the tools (``[tools]``): the ``[cli]`` avatar through ``save_ply`` /
  ``load_ply``, then ``cli/avatar_gui.build_viewer`` on the ``[cli]``
  workspace with the ``[bake]`` phase's ``baked.npz`` and with the latest
  checkpoint and its tracking tables, each served in the background on
  port 0: a dozen HTTP POSTs covering every UI mode, each PNG equal to the
  eager frame of the same state quantized, the viewer's graph frame equal
  to the eager frame bit for bit, ms per round trip and per replay;
* full-head completion (``[pseudo]``): a landmark embedding in a face
  layout on the template's front, a seeded random ``G_ema`` at the default
  ``EG3DConfig`` written as an upstream network pickle (its generator
  renders the same bits as the same tensors from a .pth), and seeded
  random GFPGAN (512^2) and MODNet checkpoints, then
  ``cli/train_generate_pseudo --num_views 30 --eg3d_weights x.pkl
  --gfpgan_weights --modnet_weights`` on the ``[cli]`` workspace: 30 orbit
  renders through kernel 1, keypoints, alignment (front views aligned, the
  back rejected), GFPGAN on the aligned crops (stage ④), PTI (PTI_STEPS W
  and G steps on up to 8 frontal targets at 512^2), the orbit re-render,
  paste-back, MODNet's mattes as masks (stage ⑧), heatmaps; the EG3D
  graph on the card against the CPU at the tiny config; ms per W / G step
  with TF32 off and on, per orbit view, per restored crop and matte, peak
  memory; then (``[plugins]``) GFPGAN, MODNet and BiSeNet at full width on
  the card against the CPU, ms per crop, matte and parse, and
  ``cli/train_generate_pseudo --bisenet_weights`` (the mirror provider,
  six views); then (``[complete]``) ``cli/train_full_avatar
  --finetune_epochs 1``: the
  re-seed, one real and one pseudo step per real frame through kernels 1
  and 2, one pseudo step's gradients against the plain blends, the
  full-head checkpoint, the orbit and six fixed-view videos, ms per real
  and pseudo step; and a full-head bake epoch (``UVBaker.bake`` with the
  pseudo set) through the bake step's graph;
* the baselines (``[baselines]``): ``cli/train_baseline --model <family>
  --epochs 1``, then ``--resume --epochs 2`` and the test evaluation, for
  GaussianAvatars, FlashAvatar, SplattingAvatar and MonoGaussianAvatar at
  their yamls' sizes on the ``[cli]`` workspace (tracking on): the render
  caps from ``autosize.size_caps`` over a probe of the first run's Trainer
  where the yaml's overflow, and the maintenance intervals that fire inside
  the runs, printed as overrides; launches per step, densify and walk
  events, resume, the eval files; MonoGaussianAvatar upsampled to its
  100,000 points and trained at that size (its own caps); a walk of a
  seeded in-plane displacement at full width; ms per eager step with and
  without tracking, peak memory, a profile of three steps, one step's
  gradients against the plain blends at the timed size, and both against
  the same step with the blends in float64;
* LPIPS (``[lpips]``): LPIPS alex and vgg on two 512x512 frames on the
  card against the CPU, the LPIPS meter from a seeded state dict in
  ``Trainer.evaluate``, and the training step with the LPIPS (vgg) and
  normal-consistency terms through a per-step epoch and the scan epoch's
  graph, beside the same Trainer without them;
* the NeRSemble benchmark (``[nersemble]``): a generated export at 512x512
  (two sequences of the train serial, the four hold-out serials, K at the
  native 2200x3208 with the principal point off the centre, FLAME2023
  tracking with world transforms), ``cli/run_nersemble_benchmark --epochs
  3`` (per-step, then scan epochs, then every sequence x serial rendered
  through one graph per serial to a video), a hold-out frame and one step
  against the plain blends, K and the transform moving the frame, and the
  scan epoch's graph against eager steps on these frames;
* multi-device training (``[parallel]``), in ranks spawned on the one
  card (``torch.multiprocessing``, a ``FileStore``; the kernels built
  above, so the ranks load them): ``make_dp_train_step`` at world 1 over
  NCCL and at world 2 over gloo against the one-process step on the same
  frames (loss, all-reduced gradients, the replicas' digests after a step
  and after densify + prune), ``cli/train_mono_avatar --dp 2`` with
  tracking and FlashAvatar's Trainer at ``data_parallel=2`` on the
  ``[cli]`` workspace, the splat-sharded render at world 2 and 4 against
  ``render(kernel="tiles")`` (image, gradients, nothing dropped, its caps
  probed from the frame), and the 2x2 (data, gauss) mesh step against the
  one-device loss and gradients; ms per step of each (host clock) and the
  kernels' launches on each path, summed over its ranks.

Serving runs through ``Reenactor.reenact``'s CUDA graph: a wrapper counts the launches of the graph's warm-up calls and its capture,
and the graph reports its replays and launches per replay.

A ``[caps]`` line first reports what the machine offers the host side
(g++, the libpng and libjpeg headers, ffmpeg, PIL, matplotlib,
torchvision, cv2, scipy).

All four kernels run the segmented walk of ``csrc/blend_common.cuh``.
Kernels 1 and 2 (the instance blend) are also held against their plain
versions on the hand-built cases of ``tests/torch_blend_cases.py``
(``boundary`` puts pixels' termination at and around segment boundaries),
kernels 3 and 4 (the dense-list blend) on those of
``tests/torch_tile_cases.py`` (``boundary`` there is the same lists laid
out densely), and two calls of each, on those cases and on the full-width
frames, must return the same bits. Beside their times the script prints the
pairs the segmented walk evaluates (pass A's every pair of the ranges, pass
B's pairs before termination) and each of their launches' device time.

The tiles route's ``max_per_tile`` (K, the yaml's 1,024) is set per phase
from a probe of the phase's frames, 1.25x their longest tile rounded up to
a multiple of ``chunk``, and printed: the yaml's K overflows on the
synthetic avatar, and any overflow fails the run.

It prints, one per line: the kernels' ptxas reports, each check with its
numbers, every override of the config, the timings (each beside the card's
name and power limit), a ``{"kernels": [...]}`` JSON line, the nvidia-smi
name/power line and last a ``{"ok": true, "device": ...}`` JSON line. Any
failed check raises, and the script exits non-zero with no result line; so
does a host without CUDA. It imports nothing of JAX.
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from types import SimpleNamespace

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
TOL = 2e-4          # kernel vs plain version, see check_blend
N_FRAMES = 16
N_VERTS = 5023      # FLAME's vertex count
# per evaluated (instance, pixel) pair: ~20 fp32 operations + one exp
OPS_PER_PAIR = 21
# bytes per binned instance read (10 channels) and per pixel written
BYTES_PER_INSTANCE = 40
BYTES_PER_PIXEL = 16

# the backward kernel per evaluated pair: the forward's recompute up to
# alpha (2 sub, 8 mul/add, exp, mul, min: 14); per blended pair on top: the
# transmittance step, w, g.c, the prefix, dalpha, the 9 partials and a 32nd
# share of the warp's 9 x 5 shuffle-adds (41)
BWD_OPS_PER_EVALUATED = 14
BWD_OPS_PER_BLENDED = 41
# bytes: 40 per binned instance read, img + t_final + g_img + g_tfin (32)
# per pixel read, the whole [16, M] gradient (64 per column) written
BWD_BYTES_PER_PIXEL = 32
BWD_BYTES_PER_COLUMN = 64
# backward kernel vs plain version, relative to each gradient row's largest
# element: the two sum 256 pixel terms in another order (~1e-6), and a
# termination flip (see check_blend) moves the crossing instance's term at
# one pixel, which carries T_j <= 1e-4 / (1 - 0.99)
BWD_RTOL = 1e-3
# one train step with the kernels vs with the plain blends: every parameter
# gradient within 1e-2 in relative L2 norm and within 5e-2 of its field's
# largest element. The two images differ by ~1e-6 per pixel (see
# check_blend); the loss turns that into O(1) changes where an L1 residual,
# a VGG ReLU input or a max pool's top two sit within it, and against
# noise targets a splat's gradient is a sum of nearly cancelling terms.
# Measured on the H100 over four runs: up to 1.6e-3 in L2 and 5.8e-3 in
# max, while the same step twice differs by <= 5e-5 (atomic sum order); a
# wrong gradient shows as O(1)
STEP_RTOL_L2 = 1e-2
STEP_RTOL_MAX = 5e-2

N_TRAIN = 24        # frames of the training epoch = its steps
N_TEST = 4
N_RESUME = 4
# the synthetic blendshapes are uncorrelated per vertex; the dataset's codes
# (std 0.3) crumple the mesh, so they are scaled to the serving phase's 0.05
EXPR_SCALE = 0.05 / 0.3
# the yaml's 3000 / 2000 intervals never fire in one epoch
MAINT_OVERRIDES = {"densify_interval": 10, "prune_interval": 15}
# the tiles route's K: this much above the longest tile a probe of the
# phase's frames measures (training grows the avatar by densify)
TILE_K_HEADROOM = 1.25
# the dense-list backward writes its whole [9, T*K] gradient (36 B a slot)
TILE_BWD_BYTES_PER_SLOT = 36

# the [cli] phase: an IMAvatar layout of this many 512x512 frames, the test
# rows' tracking fit (training.epochs.finetune) and the snapshot cadence
CLI_TRAIN, CLI_TEST = 12, 4
CLI_FINETUNE = 3
CLI_SNAPSHOT = 6
# one tracking step's row gradients, kernels vs plain blends: relative L2
# per field. The two images differ by ~1e-6 a pixel (see check_blend), which
# the loss turns into O(1) changes of a pixel's term where an L1 residual,
# a VGG ReLU input or a max pool's top two sit within it (the bound of the
# whole step's comparison, STEP_RTOL_L2); a wrong gradient shows as O(1)
TRACK_RTOL_L2 = 1e-2

# the [graph] phase: the scan epoch's CUDA graph against eager steps from
# one state. The first step's loss within 1e-6 relative (the forward
# kernels are deterministic; cuDNN's choice of VGG algorithm and the
# Laplacian's index_add_ could differ); every parameter field and tracking
# table after one step within 1e-4 relative L2, and every step's loss over
# an epoch within 1e-3 relative (the backward sums with atomics: the same
# step twice differs by <= 5e-5, PERF.md)
GRAPH_LOSS0_RTOL = 1e-6
GRAPH_STEP_RTOL_L2 = 1e-4
GRAPH_EPOCH_RTOL = 1e-3
GRAPH_TILES_FRAMES = 8    # the tiles route's graph epoch
GRAPH_PROFILE = 8         # replays under the profiler
SERVE_LONG = 3            # the longer served sequence, in N_FRAMES

# the [bake] / [edit] phases: the UNet bake of the [cli] avatar through
# cli/train_neural_baking, then cli/avatar_edit_baked with a sticker
BAKE_EPOCHS = 2
BAKE_ARGS = ["--decode_type", "UNet", "--bake_attribute", "color", "opacity",
             "--reg_weight", "0.1", "--epochs", str(BAKE_EPOCHS)]
# one bake step with the kernels vs with the plain blends: the UNet's
# gradient (all its parameters as one vector) and the const's within 1e-2
# relative L2, the bound of the training step's comparison (STEP_RTOL_L2)
BAKE_GRAD_RTOL_L2 = STEP_RTOL_L2
BAKE_PSNR_FRAMES = 3      # test frames of the baked vs splat render
BAKE_PROFILE = 8          # replays under the profiler
EDIT_FRAMES = 8           # --max_frames of the edit
STICKER, STICKER_POS = 256, (128, 128)

SEGMENTED = ("segmented walk: one work unit per (tile, 256-column segment); pass A "
             "products, entry transmittance folded in segment order, pass B exact walk")
KERNELS = {
    # kernel name -> its fixed fields in the {"kernels": [...]} line; "pr"
    # is the PR that last designed it
    "blend_instances_fwd": {
        "route": "cuda",
        "source": "fateavatar_tpu_torch/csrc/blend_instances.cu",
        "replaces": "fateavatar_tpu/render/blend_instances.py:92",
        "design": SEGMENTED + "; t_cutoff > 1e-4: the cut first (each 128-column window's "
                  "products in parallel, then a scan a tile), then the walk up to the cut",
        "pr": 4,
    },
    "blend_instances_bwd": {
        "route": "cuda",
        "source": "fateavatar_tpu_torch/csrc/blend_instances_bwd.cu",
        "replaces": "fateavatar_tpu/render/blend_instances.py:183",
        "design": SEGMENTED + "; t_cutoff > 1e-4: the forward's cut, the columns past it "
                  "zeroed",
        "pr": 4,
    },
    "blend_tiles_fwd": {
        "route": "cuda",
        "source": "fateavatar_tpu_torch/csrc/blend_tiles.cu",
        "replaces": "fateavatar_tpu/render/blend_tiles.py:199",
        "design": SEGMENTED,
        "pr": 5,
    },
    "blend_tiles_bwd": {
        "route": "cuda",
        "source": "fateavatar_tpu_torch/csrc/blend_tiles_bwd.cu",
        "replaces": "fateavatar_tpu/render/blend_tiles.py:261",
        "design": SEGMENTED + "; zero tail past each list",
        "pr": 5,
    },
}


def log(*args):
    print(*args, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, reps, warmup=3):
    """Mean device milliseconds of ``fn()`` over ``reps`` back-to-back calls
    (CUDA events, after warm-up)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextmanager
def swapped_blend(fn, name="blend_instances"):
    """Route render()'s blend ``name`` (``blend_instances`` or
    ``blend_tiles``) through ``fn`` (a plain version, or a recorder) for the
    comparisons; restored on exit."""
    from fateavatar_tpu_torch.render import render as render_mod

    orig = getattr(render_mod, name)
    setattr(render_mod, name, fn)
    try:
        yield
    finally:
        setattr(render_mod, name, orig)


def edge_case_inputs(gen, device):
    """Compact blend inputs on a 4x4 tile grid covering the kernel's edges:
    empty tiles, a tile whose range spans > 30 windows of 128, saturated
    tiles that drive T below 1e-4, ranges that start and end mid-window,
    and invalid rows."""
    import torch

    counts = [0, 5, 0, 4000, 130, 0, 77, 300, 0, 3, 129, 0, 700, 0, 1, 257]
    saturated = {7, 12, 15}
    cols = []
    for tile, c in enumerate(counts):
        x0, y0 = (tile % 4) * 16.0, (tile // 4) * 16.0

        def u(lo, hi, n=c):
            return lo + (hi - lo) * torch.rand(n, generator=gen, device=device)

        sx, sy, rho = u(1, 8), u(1, 8), u(-0.8, 0.8)
        cxy = rho * sx * sy
        det = sx**2 * sy**2 - cxy**2
        if tile in saturated:
            op = u(0.95, 1.0)
        elif c > 1000:   # faint: pixels stay above T = 1e-4 through ~31 windows
            op = u(0.004, 0.01)
        else:
            op = u(0.02, 0.9)
        valid = (torch.rand(c, generator=gen, device=device) > 0.05).float()
        cols.append(torch.stack([
            x0 + u(-6, 22), y0 + u(-6, 22), sy**2 / det, -cxy / det, sx**2 / det,
            u(0, 1), u(0, 1), u(0, 1), op, valid,
        ]))
    inst = torch.cat(cols, dim=1)
    inst = torch.cat([inst, torch.zeros((6, inst.shape[1]), device=device)]).contiguous()
    starts = torch.tensor([0] + counts, device=device).cumsum(0).to(torch.int32)
    bg = torch.tensor([0.2, 0.5, 0.9], device=device)
    return inst, starts, bg, (4, 4)


def termination_flips(tfin_a, tfin_b):
    """Pixels whose T_final differs between two blends by more than 1e-3 of
    it: a termination flip (one instance more or fewer kept where T crosses
    1e-4) moves T_final by a factor 1 - alpha <= 254/255, a different
    rounding order by ~1e-6 of it. Returns (flips, the largest relative
    difference among the other pixels)."""
    rel = (tfin_a - tfin_b).abs() / tfin_b.abs().clamp_min(1e-30)
    flip = rel > 1e-3
    rest = rel[~flip]
    return int(flip.sum()), rest.max().item() if rest.numel() else 0.0


def check_blend(label, inputs, results, kernel=None, plain=None):
    """Kernel vs plain version on the same inputs (the instance blend unless
    ``kernel`` / ``plain`` are given). Tolerance 2e-4: the two take the
    transmittance product in another order, which can flip which instance
    crosses T = 1e-4 at a pixel and move that pixel by at most
    alpha * T <= 1e-4; every other quantity is computed to the same bits."""
    import torch

    from fateavatar_tpu_torch.render import blend_instances as bi

    img_k, tfin_k = (kernel or bi.blend_instances)(*inputs)
    torch.cuda.synchronize()
    img_p, tfin_p = (plain or bi.blend_instances_reference)(*inputs)
    d_img = (img_k - img_p).abs()
    d_t = (tfin_k - tfin_p).abs()
    err = max(d_img.max().item(), d_t.max().item())
    n_above = int((d_img.amax(dim=1) > 5e-5).sum() + (d_t > 5e-5).sum())
    flips, rel = termination_flips(tfin_k, tfin_p)
    log(f"[kernel] {label}: max|img diff| {d_img.max().item():.3e} "
        f"max|t_final diff| {d_t.max().item():.3e} pixels>5e-5 {n_above} "
        f"(of {tfin_k.numel()}); termination flips {flips}, other pixels' T_final "
        f"within {rel:.1e} relative")
    check(bool(torch.isfinite(img_k).all()), f"{label}: non-finite kernel output")
    check(err <= TOL, f"{label}: kernel vs plain {err:.3e} > {TOL}")
    results["max_abs_err"] = max(results.get("max_abs_err", 0.0), err)
    return tfin_k


def check_blend_bwd(label, args, results, kernel=None, plain=None, zero=None):
    """Backward kernel vs plain version on the same inputs (the instance
    blend's unless ``kernel`` / ``plain`` are given), each gradient row
    within BWD_RTOL of its largest element; the elements ``zero(g)`` selects
    (by default rows 9-15 and every column past the last range) must be 0."""
    import torch

    from fateavatar_tpu_torch.render import blend_instances as bi

    g_k = (kernel or bi.blend_instances_bwd)(*args)
    torch.cuda.synchronize()
    g_p = (plain or bi.blend_instances_backward_reference)(*args)
    d = (g_k - g_p).abs()
    scale = g_p[:9].abs().amax(dim=1, keepdim=True) + 1e-12
    rel = (d[:9] / scale).max().item()
    err = d.max().item()
    log(f"[kernel] {label}: backward max|diff| {err:.3e}, largest relative to its "
        f"row {rel:.3e}, row scales {[round(x, 6) for x in scale[:, 0].tolist()]}")
    check(bool(torch.isfinite(g_k).all()), f"{label}: non-finite backward output")
    check(rel <= BWD_RTOL, f"{label}: backward kernel vs plain {rel:.3e} > {BWD_RTOL}")
    if zero is None:
        total = int(args[1][-1])
        check(bool((g_k[9:] == 0).all()), f"{label}: rows 9-15 must be 0")
        check(bool((g_k[:, total:] == 0).all()), f"{label}: columns past the ranges must be 0")
    else:
        check(bool((zero(g_k) == 0).all()), f"{label}: slots past the lists must be 0")
    results["max_abs_err"] = max(results.get("max_abs_err", 0.0), err)
    return g_k


def check_repeatable(label, fn):
    """Two calls of ``fn`` (a kernel wrapper on fixed inputs) return the same
    bits: no result of the segmented walk may depend on the order blocks run
    in."""
    import torch

    a, b = fn(), fn()
    torch.cuda.synchronize()
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    check(all(torch.equal(x, y) for x, y in zip(a, b)), f"{label}: two calls differ")
    log(f"[kernel] {label}: two calls bit-identical")


def _tests_on_path():
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)


def instance_kernel_cases(rows):
    """Kernels 1 and 2 against their plain versions on the hand-built
    compact cases of tests/torch_blend_cases.py (a (3, 4) grid; empty
    tiles, a faint range over > 30 windows, saturated tiles, and
    ``boundary``: pixels crossing T = 1e-4 at and around the segmented
    walk's segment boundaries, a long tile that stops in its first segment,
    ranges of exactly one segment), each twice for bit-identical results."""
    import numpy as np
    import torch

    _tests_on_path()
    from torch_blend_cases import BLEND_CASES, blend_case

    from fateavatar_tpu_torch.render import blend_instances as bi

    rng = np.random.default_rng(1)
    for name in BLEND_CASES:
        inst, starts, bg, grid = blend_case(name)
        fwd = (torch.from_numpy(inst).cuda(), torch.from_numpy(starts).cuda(),
               torch.from_numpy(bg).cuda(), grid)
        tfin = check_blend(f"blend case {name} (counts {np.diff(starts).tolist()})", fwd,
                           rows["blend_instances_fwd"])
        check(bool((tfin[fwd[1][1:] == fwd[1][:-1]] == 1.0).all()),
              f"{name}: empty tiles keep T = 1")
        img = bi.blend_instances(*fwd)[0]
        g_img = torch.from_numpy(rng.normal(size=img.shape).astype(np.float32)).cuda()
        g_tfin = torch.from_numpy(rng.normal(size=tfin.shape).astype(np.float32)).cuda()
        args = (*fwd[:3], img, tfin, g_img, g_tfin, grid)
        check_blend_bwd(f"blend case {name}", args, rows["blend_instances_bwd"])
        check_repeatable(f"blend case {name} forward", lambda: bi.blend_instances(*fwd))
        check_repeatable(f"blend case {name} backward", lambda: bi.blend_instances_bwd(*args))


def segment_split(label, fn, card, n=10):
    """Device ms of each launch of a kernel wrapper (its plan, pass A, pass
    B, and the forward's combine or kernel 4's zero tail; the early exit's
    cut pass) over ``n`` calls under torch.profiler, printed and returned by
    kernel name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ks = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    split = {e.key.replace("(anonymous namespace)::", "").split("(")[0]:
             round(e.self_device_time_total / n / 1e3, 4) for e in ks}
    log(f"[kernel] {label} launches, device ms per call (torch.profiler, {n} calls): "
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items()) + f" [{card}]")
    return split


def past_lists(counts, k):
    """Selects the [9, T*K] gradient's slots past each tile's list."""
    import torch

    slot = torch.arange(k, device=counts.device)[None, :]
    mask = (slot >= counts.clamp(max=k)[:, None]).reshape(-1)
    return lambda g: g[:, mask]


def tile_kernel_cases(rows):
    """Kernels 3 and 4 against their plain versions on the hand-built
    dense-list cases of tests/torch_tile_cases.py (a (3, 4) grid; empty
    tiles, counts above K, saturated tiles, a faint list spanning > 60
    windows, ``boundary``: the blend case's crossings at segment boundaries
    laid out densely), each twice for bit-identical results, and a
    NaN-prefilled output of kernel 4."""
    import numpy as np
    import torch

    _tests_on_path()
    from torch_tile_cases import TILE_CASES, tile_case

    from fateavatar_tpu_torch.render import blend_tiles as bt

    dev = "cuda"
    rng = np.random.default_rng(0)
    for name in sorted(TILE_CASES):
        data, valid, counts, bg, grid = (torch.from_numpy(x).to(dev) if isinstance(x, np.ndarray)
                                         else x for x in tile_case(name))
        k = data.shape[1] // counts.shape[0]
        fwd = (data, valid, counts, bg, grid)
        tfin = check_blend(f"tile case {name} (K {k}, counts {counts.tolist()})", fwd,
                           rows["blend_tiles_fwd"], bt.blend_tiles, bt.blend_tiles_reference)
        check(bool((tfin[counts == 0] == 1.0).all()), f"{name}: empty tiles keep T = 1")
        if name == "saturated":
            check(int((tfin < 1e-3).sum()) > 0, "saturated tiles must terminate")
        img = bt.blend_tiles(*fwd)[0]
        g_img = torch.from_numpy(rng.normal(size=img.shape).astype(np.float32)).to(dev)
        g_tfin = torch.from_numpy(rng.normal(size=tfin.shape).astype(np.float32)).to(dev)
        args = (data, valid, counts, bg, img, tfin, g_img, g_tfin, grid)
        g_clean = check_blend_bwd(f"tile case {name}", args, rows["blend_tiles_bwd"],
                                  bt.blend_tiles_bwd, bt.blend_tiles_backward_reference,
                                  past_lists(counts, k))
        check_repeatable(f"tile case {name} forward", lambda: bt.blend_tiles(*fwd))
        check_repeatable(f"tile case {name} backward", lambda: bt.blend_tiles_bwd(*args))
        if name == "long":
            g_dirty = bt.blend_tiles_bwd(*args, out=torch.full_like(g_clean, float("nan")))
            torch.cuda.synchronize()
            check(torch.equal(g_dirty, g_clean),
                  "tile backward: a NaN-filled output buffer must come back equal")
            log("[kernel] tile case long: NaN-prefilled output buffer comes back finite "
                "and bit-equal to a clean call")


def longest_tile(model, params, state, views, rcfg):
    """The most instances any tile holds over ``views`` ((expression, pose,
    camera) on the device), binned as the tiles route bins them: the
    pre-truncation counts of build_tile_lists under ``rcfg``'s R and
    budget."""
    import torch

    from fateavatar_tpu_torch.models.fateavatar import build_gaussians
    from fateavatar_tpu_torch.render import binning
    from fateavatar_tpu_torch.render.preprocess import preprocess

    longest = 0
    with torch.no_grad():
        for e, p, cam in views:
            g = build_gaussians(model, params, state, e, p)[0]
            prep = preprocess(cam, g.xyz, g.get_scaling, g.get_rotation, g.get_opacity,
                              g.get_features, g.sh_degree, alive=g.alive)
            lists = binning.build_tile_lists(
                prep.soa[0], prep.soa[1], prep.depth, prep.radius,
                binning.tile_grid(cam.width, cam.height), max_per_tile=rcfg.chunk,
                max_tiles_per_gaussian=rcfg.max_tiles_per_gaussian,
                instance_budget=rcfg.instance_budget)
            longest = max(longest, int(lists.counts.max()))
    return longest


def tile_k(longest, chunk):
    """K = TILE_K_HEADROOM x the longest tile, a multiple of ``chunk``."""
    return max(chunk, -(-int(TILE_K_HEADROOM * longest) // chunk) * chunk)


def tile_kernel_timings(data, valid, counts, bg, grid, chunk, row, which, card, reps,
                        bwd_args=None):
    """ms per launch of kernel 3 (``which`` fwd) or 4 (bwd) and of its plain
    version on captured full-width inputs, with the bound, the pairs the
    segmented walk evaluates (derived from the inputs) and the device ms of
    each of its launches."""
    from fateavatar_tpu_torch.render import blend_tiles as bt

    T = grid[0] * grid[1]
    k = data.shape[1] // T
    n_slots = int(counts.clamp(max=k).sum())
    evaluated, blended = bt.pair_counts(data, valid, counts, grid)
    n_pix = T * 256

    def kernel():
        if which == "fwd":
            return bt.blend_tiles(data, valid, counts, bg, grid, chunk)
        return bt.blend_tiles_bwd(*bwd_args)

    ms = cuda_ms(kernel, reps=reps)
    if which == "fwd":
        plain_ms = cuda_ms(lambda: bt.blend_tiles_reference(data, valid, counts, bg, grid,
                                                            chunk), reps=2, warmup=1)
        bytes_moved = (BYTES_PER_INSTANCE * n_slots + 4 * T + 12 + BYTES_PER_PIXEL * n_pix)
        ops = OPS_PER_PAIR * evaluated
    else:
        plain_ms = cuda_ms(lambda: bt.blend_tiles_backward_reference(*bwd_args), reps=2,
                           warmup=1)
        bytes_moved = (BYTES_PER_INSTANCE * n_slots + 4 * T + BWD_BYTES_PER_PIXEL * n_pix
                       + TILE_BWD_BYTES_PER_SLOT * data.shape[1])
        ops = BWD_OPS_PER_EVALUATED * evaluated + BWD_OPS_PER_BLENDED * blended
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_OPS_PER_S * 1e3
    row.update(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=None)
    log(f"[kernel] {row['name']}: {ms:.4f} ms/launch (CUDA events, {reps} launches), "
        f"plain version {plain_ms:.3f} ms; T {T} K {k}, occupied slots {n_slots} "
        f"({n_slots / (T * k):.2%} of T*K), evaluated pairs {evaluated}, blended "
        f"{blended}; bound {row['bound_ms']:.5f} ms ({t_bytes:.5f} ms for {bytes_moved} B "
        f"at 3.35 TB/s, {t_ops:.5f} ms for {ops} ops at 67 TFLOP/s fp32) -> "
        f"{row['bound_ms'] / ms:.1%} of bound [{card}]")
    log(f"[kernel] {row['name']} segmented walk, pairs derived from the inputs (not "
        f"counted on the card): pass A evaluates every pair of the lists "
        f"({n_slots * 256}), pass B about the sequential walk's {evaluated} before "
        f"termination; {n_slots * 256 + evaluated} in all, "
        f"{(n_slots * 256 + evaluated) / evaluated:.2f}x the per-tile walk's")
    segment_split(row["name"], kernel, card)


def write_assets(ws, seed):
    """Seeded synthetic FLAME pickle, UV template and identity_info.json."""
    import numpy as np

    from fateavatar_tpu_torch.flame.loader import synthetic_flame_data
    from fateavatar_tpu_torch.utils.obj_io import sphere_obj_mesh

    data, _ = synthetic_flame_data(n_verts=N_VERTS, n_exp=100, seed=seed)
    pkl = os.path.join(ws, "generic_model.pkl")
    with open(pkl, "wb") as fh:
        pickle.dump(data, fh)
    mesh = sphere_obj_mesh(N_VERTS)
    obj = os.path.join(ws, "head_template.obj")
    with open(obj, "w") as fh:
        fh.writelines(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n" for v in mesh.verts)
        fh.writelines(f"vt {uv[0]:.6f} {uv[1]:.6f}\n" for uv in mesh.uvcoords)
        fh.writelines("f " + " ".join(f"{i + 1}/{i + 1}" for i in f) + "\n"
                      for f in mesh.faces)
    world = np.eye(4)
    world[2, 3] = 0.4   # the camera bench.py uses: R = I, T = [0, 0, 0.4]
    info = {"shape_params": [0.0] * 100, "mean_expression": [[0.0] * 50],
            "n_shape": 100, "n_exp": 50, "fovx": 0.8, "fovy": 0.8,
            "canonical_pose": 0.2, "img_res": [512, 512],
            "world_mat0": world.tolist(), "dataset_type": "synthetic"}
    with open(os.path.join(ws, "identity_info.json"), "w") as fh:
        json.dump(info, fh)
    return pkl, obj


def train_setup(ws):
    """What both training phases share: the yaml at full width with the
    seeded assets, its FLAME, model, datasets, loss and optimizer."""
    import torch

    from fateavatar_tpu_torch.cli import common
    from fateavatar_tpu_torch.train.datasets import SyntheticDataset
    from fateavatar_tpu_torch.train.losses import FateAvatarLoss, vgg16_random_params
    from fateavatar_tpu_torch.train.optim import fateavatar_optimizers
    from fateavatar_tpu_torch.utils.config import config_to_dict, load_config

    dev = "cuda"
    root = os.path.dirname(os.path.abspath(__file__))
    tws = os.path.join(ws, "train")
    cfg = load_config(os.path.join(root, "configs", "fateavatar.yaml"), [
        f"assets.flame_model_path={os.path.join(ws, 'generic_model.pkl')}",
        f"assets.template_mesh_path={os.path.join(ws, 'head_template.obj')}",
        f"workspace={tws}",
    ])
    h, w = cfg.dataset.img_res

    def dataset(n, seed):
        ds = SyntheticDataset(num_frames=n, img_res=(h, w), n_shape=100, n_exp=50, seed=seed)
        ds.expressions = ds.expressions * EXPR_SCALE
        return ds

    train_ds, test_ds = dataset(N_TRAIN, 0), dataset(N_TEST, 1)
    flame = common.construct_flame(cfg, train_ds, device=dev)
    model, params, state = common.construct_model(cfg, flame, device=dev)
    common.save_identity_info(tws, train_ds, cfg)
    # construct_loss's semantics, with seeded random VGG16 weights in place
    # of assets.vgg16_weights_path (the repository ships none)
    vgg = vgg16_random_params(torch.Generator(device=dev).manual_seed(0), device=dev)
    loss_cfg = common.loss_config(cfg)
    maint = dataclasses.replace(common.maintenance_config(cfg), **MAINT_OVERRIDES)
    return SimpleNamespace(
        cfg=cfg, tws=tws, h=h, w=w, dataset=dataset, train_ds=train_ds, test_ds=test_ds,
        model=model, params=params, state=state, vgg=vgg, loss_cfg=loss_cfg,
        loss_fn=FateAvatarLoss(loss_cfg, vgg_params=vgg),
        optimizer=fateavatar_optimizers(config_to_dict(cfg.training)), maint=maint)


def watch_maintenance(trainer, maint):
    """Wraps ``trainer.train_step`` to record each densify (alive before and
    after, slots written, their largest Adam moment) and prune; syncs only
    at those steps. Returns the event list and the unwrapped step."""
    from fateavatar_tpu_torch.models import maintenance

    events = []
    step_fn = trainer.train_step

    def watched(ts, frame):
        before = ts.state.alive
        ts2, aux = step_fn(ts, frame)
        if ts2.step % maint.densify_interval == 0:
            new = ts2.state.alive & ~before
            moments = max(float((getattr(o, f).reshape(new.shape[0], -1).abs()
                                 * new[:, None]).max())
                          for o in (ts2.opt_state.mu, ts2.opt_state.nu)
                          for f in maintenance.SPLAT_FIELDS)
            events.append(("densify", ts2.step, int(before.sum()),
                           int(ts2.state.alive.sum()), int(new.sum()), moments))
        if ts2.step % maint.prune_interval == 0:
            events.append(("prune", ts2.step, int(before.sum()),
                           int(ts2.state.alive.sum())))
        return ts2, aux

    trainer.train_step = watched
    return events, step_fn


def check_epoch(tag, trainer, events, maint):
    """The epoch's losses finite and falling, densify adding increase_num
    splats with zero Adam moments, prune firing, nothing dropped."""
    import numpy as np

    losses = trainer.epoch_losses
    for ev in events:
        log(f"[{tag}] {ev[0]} at step {ev[1]}: alive {ev[2]} -> {ev[3]}"
            + (f", {ev[4]} slots written, their largest Adam moment {ev[5]:.1e}"
               if ev[0] == "densify" else ""))
    check(len(losses) == N_TRAIN and all(np.isfinite(losses)), "finite loss every step")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(last < first, f"mean loss of the last 5 steps {last:.5f} below the first 5 {first:.5f}")
    dens = [ev for ev in events if ev[0] == "densify"]
    check(len(dens) >= 1 and all(ev[3] == ev[2] + maint.increase_num and ev[4] == maint.increase_num
                                 for ev in dens), "densify adds increase_num splats")
    check(all(ev[5] == 0.0 for ev in dens), "densified rows start with zero Adam moments")
    check(any(ev[0] == "prune" for ev in events), "prune fired")
    overflow = trainer.last_epoch_stats["overflow"]
    check(overflow == 0, f"overflow {overflow} in the training epoch")


def rel_errors(ga, pa, gb, pb):
    """Per parameter field and the probe: (name, relative L2, largest
    difference over the largest element) of gradients a against b."""
    out = []
    for f in [fl.name for fl in dataclasses.fields(ga)] + ["probe"]:
        a, b = (pa, pb) if f == "probe" else (getattr(ga, f), getattr(gb, f))
        if b.numel() == 0 or float(b.abs().max()) == 0.0:
            check(float(a.abs().max()) == 0.0, f"step gradient {f}: one side 0")
            continue
        out.append((f, float((a - b).norm() / b.norm()),
                    float((a - b).abs().max() / b.abs().max())))
    return out


def check_step_grads(tag, label, a, b):
    """Step gradients a (grads, probe, out, losses) within STEP_RTOL_L2 /
    STEP_RTOL_MAX of b."""
    worst = rel_errors(a[0], a[1], b[0], b[1])
    for f, l2, mx in worst:
        check(l2 <= STEP_RTOL_L2 and mx <= STEP_RTOL_MAX,
              f"step gradient {f}: {label} rel L2 {l2:.2e}, max {mx:.2e}")
    log(f"[{tag}] one step, {label}: loss {a[3]['loss'].item():.7f} vs "
        f"{b[3]['loss'].item():.7f}; per field (rel L2, max rel): "
        + ", ".join(f"{f} {l2:.1e}/{mx:.1e}" for f, l2, mx in worst))
    return worst


def train_phase(s, gen, rows, card):
    """The training slice at full width: Trainer epoch, eval, checkpoint,
    resume, kernel 2 on a captured training frame, the whole step against
    the plain blends, and the step's timings. Returns the Trainer."""
    import numpy as np
    import torch

    from fateavatar_tpu_torch.cli import common
    from fateavatar_tpu_torch.models import maintenance
    from fateavatar_tpu_torch.models.fateavatar import fateavatar_forward
    from fateavatar_tpu_torch.render import blend_instances as bi
    from fateavatar_tpu_torch.train.losses import FateAvatarLoss
    from fateavatar_tpu_torch.train.optim import apply_updates, zero_moment_rows
    from fateavatar_tpu_torch.train.step import make_train_step
    from fateavatar_tpu_torch.train.trainer import Trainer

    dev = "cuda"
    bwd_row = rows["blend_instances_bwd"]
    fwd_row = rows["blend_instances_fwd"]
    t_phase = time.perf_counter()
    cfg, tws, h, w = s.cfg, s.tws, s.h, s.w
    train_ds, test_ds, dataset = s.train_ds, s.test_ds, s.dataset
    model, params, state = s.model, s.params, s.state
    vgg, loss_cfg, loss_fn, optimizer, maint = s.vgg, s.loss_cfg, s.loss_fn, s.optimizer, s.maint
    log(f"[train] config overrides: {MAINT_OVERRIDES} (yaml: densify_interval "
        f"{cfg.training.densify_interval}, prune_interval {cfg.training.prune_interval}); "
        f"VGG16 weights random (seed 0) in place of assets.vgg16_weights_path; "
        f"SyntheticDataset expression codes scaled by {EXPR_SCALE:.4f} (std 0.05); "
        f"{N_TRAIN} train / {N_TEST} test frames of {h}x{w}")
    log(f"[train] loss {dataclasses.asdict(loss_cfg)}; lr {optimizer.lr_tree}; "
        f"cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, "
        f"matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32}")

    trainer = Trainer(cfg.name, model, params, state, loss_fn, optimizer, train_ds,
                      test_ds, workspace=tws, maint_cfg=maint,
                      render_cfg=common.render_config(cfg), seed=cfg.seed)
    rcfg = trainer.render_cfg
    log(f"[train] render config after autosize: budget {rcfg.instance_budget} "
        f"R {rcfg.max_tiles_per_gaussian} tail_k {rcfg.tail_k} binning {rcfg.binning}")

    events, step_fn = watch_maintenance(trainer, maint)
    torch.cuda.synchronize()
    # ---- the training path: counts to 0 just before, read just after
    bi.blend_instances.launches = 0
    bi.blend_instances_bwd.launches = 0
    t0 = time.perf_counter()
    trainer.train(1)                     # one epoch, then save_checkpoint
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    trainer.train_step = step_fn
    launches = {"blend_instances_fwd": bi.blend_instances.launches,
                "blend_instances_bwd": bi.blend_instances_bwd.launches}
    for name, n in launches.items():
        rows[name]["launches"] = n
        log(f"[train] {name} launches in the training epoch: {n} ({N_TRAIN} steps)")
        check(n == N_TRAIN, f"{name}: one launch per training step")
    log(f"[train] epoch of {N_TRAIN} steps in {epoch_s:.3f} s (host clock, incl. "
        f"maintenance and the checkpoint); per-step loss "
        f"{[round(x, 5) for x in trainer.epoch_losses]}")
    check_epoch("train", trainer, events, maint)

    # ---- evaluation (its forwards counted apart)
    bi.blend_instances.launches = 0
    bi.blend_instances_bwd.launches = 0
    summary = trainer.evaluate("test")
    torch.cuda.synchronize()
    log(f"[train] eval on {N_TEST} test frames: {summary}; forward launches "
        f"{bi.blend_instances.launches}, backward {bi.blend_instances_bwd.launches}")
    check(np.isfinite(summary["psnr"]), "finite eval PSNR")
    check(bi.blend_instances.launches == N_TEST and bi.blend_instances_bwd.launches == 0,
          "eval runs one forward per frame and no backward")

    # ---- resume: a fresh Trainer restores the checkpoint and trains on
    resumed = Trainer(cfg.name, model, params, state, loss_fn, optimizer,
                      dataset(N_RESUME, 2), test_ds, workspace=tws, maint_cfg=maint,
                      render_cfg=rcfg, seed=cfg.seed)
    resumed.load_checkpoint()
    ts, rs = trainer.ts, resumed.ts
    same = all(torch.equal(getattr(a, f), getattr(b, f))
               for a, b in ((ts.opt_state.mu, rs.opt_state.mu), (ts.opt_state.nu, rs.opt_state.nu),
                            (ts.params, rs.params))
               for f in maintenance.SPLAT_FIELDS)
    check(resumed.global_step == N_TRAIN and rs.step == N_TRAIN and same
          and torch.equal(ts.opt_state.count, rs.opt_state.count),
          "resume restores global_step, the step counter and the Adam moments")
    resumed.train(2)
    check(resumed.global_step == N_TRAIN + N_RESUME and all(np.isfinite(resumed.epoch_losses)),
          "the resumed trainer trains on")
    log(f"[train] resumed at step {N_TRAIN} with equal moments, trained to step "
        f"{resumed.global_step}, losses {[round(x, 5) for x in resumed.epoch_losses]}")

    # ---- kernel 2 on a captured full-width training frame
    frame = trainer._make_frame(train_ds.sample(0))
    captured = []

    def record(*args):
        img, tfin = bi.blend_instances(*args)
        captured.append((args, img.detach(), tfin.detach()))
        img.register_hook(lambda g: captured.append(g))
        return img, tfin

    with swapped_blend(record):
        trainer.train_step.grads(trainer.ts, frame)
    (inst, starts, bg, grid), img, tfin = captured[0]
    bwd_args = (inst.detach(), starts, bg, img, tfin, captured[1].contiguous(),
                torch.zeros_like(tfin), grid)
    n_inst = int(starts[-1])
    counts = (starts[1:] - starts[:-1]).float()
    log(f"[kernel] training frame: M {inst.shape[1]} binned instances {n_inst} "
        f"per-tile max {int(counts.max())} mean {counts.mean().item():.1f}")
    check_blend("training frame (forward)", (inst.detach(), starts, bg, grid), fwd_row)
    check_blend_bwd("training frame", bwd_args, bwd_row)
    check_repeatable("training frame backward", lambda: bi.blend_instances_bwd(*bwd_args))
    ms = cuda_ms(lambda: bi.blend_instances_bwd(*bwd_args), reps=20)
    plain_ms = cuda_ms(lambda: bi.blend_instances_backward_reference(*bwd_args),
                       reps=2, warmup=1)
    evaluated, blended = bi.pair_counts(inst.detach(), starts, grid)
    n_pix = grid[0] * grid[1] * 256
    bytes_moved = (BYTES_PER_INSTANCE * n_inst + 4 * starts.numel()
                   + BWD_BYTES_PER_PIXEL * n_pix + BWD_BYTES_PER_COLUMN * inst.shape[1])
    ops = BWD_OPS_PER_EVALUATED * evaluated + BWD_OPS_PER_BLENDED * blended
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_OPS_PER_S * 1e3
    bwd_row.update(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   library_ms=None)
    log(f"[kernel] blend_instances_bwd: {ms:.4f} ms/launch (CUDA events, 20 launches), "
        f"plain version {plain_ms:.3f} ms; evaluated pairs {evaluated}, blended "
        f"{blended}; bound {bwd_row['bound_ms']:.5f} ms ({t_bytes:.5f} ms for "
        f"{bytes_moved} B at 3.35 TB/s, {t_ops:.5f} ms for {ops} ops at 67 TFLOP/s "
        f"fp32) -> {bwd_row['bound_ms'] / ms:.1%} of bound [{card}]")
    log(f"[kernel] blend_instances_bwd segmented walk, pairs derived from the inputs "
        f"(not counted on the card): pass A evaluates every pair of the ranges "
        f"({n_inst * 256}), pass B about the sequential walk's {evaluated} before "
        f"termination; {n_inst * 256 + evaluated} in all, "
        f"{(n_inst * 256 + evaluated) / evaluated:.2f}x the per-tile walk's")
    segment_split("blend_instances_bwd", lambda: bi.blend_instances_bwd(*bwd_args), card)

    # ---- one whole step: kernels vs both blends plain, same state and frame.
    # The VGG stack runs in float32 with TF32 off and deterministic cuDNN
    # here, so that only the blends differ between the two.
    cmp_loss = FateAvatarLoss(dataclasses.replace(loss_cfg, vgg_dtype=None),
                              vgg_params=vgg)
    cmp_step = make_train_step(model, cmp_loss, optimizer, maint, rcfg)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        gk, pk, _, lk = cmp_step.grads(trainer.ts, frame)
        gk2, pk2, _, _ = cmp_step.grads(trainer.ts, frame)
        with swapped_blend(bi.blend_instances_plain):
            gp, pp, _, lp = cmp_step.grads(trainer.ts, frame)
    torch.cuda.synchronize()

    noise = rel_errors(gk2, pk2, gk, pk)
    check_step_grads("train", "kernels vs plain blends", (gk, pk, None, lk), (gp, pp, None, lp))
    log("[train] the same step twice with the kernels (run-to-run noise of the "
        "atomic scatter-adds): " + ", ".join(f"{f} {l2:.1e}/{mx:.1e}" for f, l2, mx in noise))

    # ---- timings of the step at full width
    never = 10**9    # steady steps: no maintenance falls due
    timing_step = make_train_step(model, loss_fn, optimizer, dataclasses.replace(
        maint, densify_interval=never, prune_interval=never,
        opacity_reset_interval=never), rcfg)
    frames = [trainer._make_frame(train_ds.sample(i)) for i in range(N_TRAIN)]
    ts = trainer.ts
    for f in frames[:3]:
        timing_step(ts, f)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    for f in frames[3:13]:
        ts, _ = timing_step(ts, f)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 10
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    s.step_ms = step_ms
    log(f"[train] ms/step {step_ms:.3f} (host clock, synchronized, 10 steady steps, "
        f"maintenance excluded), peak device memory {peak_gib:.3f} GiB "
        f"(resident before the steps {base_mem / 2**30:.3f} GiB) [{card}]")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    stages = ("forward", "loss", "backward", "adam", "maintenance")

    def split_step(f, host_ms, dev_ms=None):
        """One step in its five stages, each run alone (synchronized): host
        milliseconds per stage into ``host_ms``; with ``dev_ms``, each stage
        under its own torch.profiler and the device time of its kernels
        into ``dev_ms`` (index 5: kernel 2's part of the backward)."""
        box = {}

        def forward():
            leaves = {k.name: getattr(ts.params, k.name).detach().requires_grad_()
                      for k in dataclasses.fields(ts.params)}
            probe = torch.zeros((2, ts.params.offset.shape[0]), device=dev,
                                requires_grad=True)
            box.update(leaves=leaves, probe=probe, out=fateavatar_forward(
                model, dataclasses.replace(ts.params, **leaves), ts.state,
                f.expression, f.flame_pose, f.camera, bg_color=f.bg_color,
                render_cfg=rcfg, means2d_probe=probe))

        def loss():
            box["loss"] = loss_fn(box["out"], {"rgb": f.rgb})["loss"]

        def backward():
            box["g"] = torch.autograd.grad(box["loss"], [*box["leaves"].values(), box["probe"]])

        def adam():
            g, out = box["g"], box["out"]
            grads = dataclasses.replace(ts.params, **dict(zip(box["leaves"], g[:-1])))
            st = maintenance.add_densification_stats(ts.state, g[-1], out["visibility_filter"])
            box["state"] = maintenance.update_max_radii(st, out["radii"], out["visibility_filter"])
            upd, box["opt"] = optimizer.update(grads, ts.opt_state, ts.params)
            box["params"] = apply_updates(ts.params, upd)

        def maint_due():
            p3, s3, touched = maintenance.uv_densify(ts.generator, box["params"], box["state"],
                                                     maint.increase_num)
            zero_moment_rows(box["opt"], touched, maintenance.SPLAT_FIELDS)
            maintenance.prune_low_opacity(p3, s3, maint.min_opacity)

        for i, fn in enumerate((forward, loss, backward, adam, maint_due)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if dev_ms is None:
                fn()
            else:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    fn()
                    torch.cuda.synchronize()
                ks = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
                dev_ms[i] += sum(e.self_device_time_total for e in ks) / 1e3
                dev_ms[5] += sum(e.self_device_time_total for e in ks
                                 if "blend_instances_bwd" in e.key) / 1e3
            torch.cuda.synchronize()
            host_ms[i] += (time.perf_counter() - t0) * 1e3

    reps = 5
    host, dev_split = np.zeros(5), np.zeros(6)
    split_step(frames[0], np.zeros(5))                       # warm-up
    for f in frames[1:1 + reps]:
        split_step(f, host)
    for f in frames[1:1 + reps]:
        split_step(f, np.zeros(5), dev_split)
    host /= reps
    dev_split /= reps
    log(f"[train] stage split, host ms (each stage run alone, synchronized, {reps} "
        f"steps): " + ", ".join(f"{n} {host[i]:.3f}" for i, n in enumerate(stages))
        + f"; sum {host.sum():.3f} (maintenance = densify + moment reset + prune, "
        f"when due) [{card}]")
    log(f"[train] stage split, device ms (kernel time under torch.profiler, same "
        f"steps): " + ", ".join(f"{n} {dev_split[i]:.3f}" for i, n in enumerate(stages))
        + f"; blend_instances_bwd {dev_split[5]:.3f} of the backward's "
        f"{dev_split[2]:.3f} ({dev_split[5] / dev_split[2]:.1%}) [{card}]")

    box = {"ts": ts}

    def step(i):
        box["ts"], _ = timing_step(box["ts"], frames[13 + i])

    profile_top("3 train steps", step, 3, "step", card)
    log(f"[train] phase total {time.perf_counter() - t_phase:.1f} s")
    return trainer


def device_union_us(prof):
    """Microseconds the card was busy in a torch.profiler run: the union of
    the intervals of every kernel, copy and fill it saw (overlaps counted
    once)."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profile_top(label, fn, n, unit, card):
    """Wall and device-busy time of ``n`` calls of ``fn`` under
    torch.profiler, and the 10 kernels that took the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    sum_us = sum(e.self_device_time_total for e in kernels)
    busy_us = device_union_us(prof)
    n_launch = sum(e.count for e in kernels)
    check(busy_us > 0, f"the profiler saw device time in {label}")
    log(f"[profile] {label}: wall {wall_us / n / 1e3:.3f} ms/{unit}, device busy "
        f"{busy_us / n / 1e3:.3f} ms/{unit} (the union of the device intervals; "
        f"{busy_us / wall_us:.1%}, idle {1 - busy_us / wall_us:.1%}; their sum "
        f"{sum_us / n / 1e3:.3f}), {n_launch / n:.0f} kernels/{unit} (under the "
        f"profiler) [{card}]")
    for e in kernels[:10]:
        log(f"[profile]   {e.self_device_time_total / n / 1e3:8.4f} ms/{unit} "
            f"x{e.count // n:<4d} {e.key[:90]}")
    return {"wall_ms": wall_us / n / 1e3, "busy_ms": busy_us / n / 1e3,
            "kernel_sum_ms": sum_us / n / 1e3,
            "idle": 1 - busy_us / wall_us, "kernels": n_launch / n,
            "names": {e.key for e in kernels}}


def tiles_serve_phase(model, params, state, ws, rcfg, cam, exprs, poses, delta, rows, card):
    """The serving path through kernel="tiles": the same checkpoint served
    through Reenactor.reenact with the dense-list blend, frame by frame
    overflow, two frames against the plain tile blend, frame 0 against the
    instances route, and kernel 3 on the captured full-width inputs."""
    import numpy as np
    import torch

    from fateavatar_tpu_torch.models.fateavatar import fateavatar_forward
    from fateavatar_tpu_torch.render import blend_instances as bi
    from fateavatar_tpu_torch.render import blend_tiles as bt
    from fateavatar_tpu_torch.train.loader import Reenactor
    from fateavatar_tpu_torch.utils.graphs import WARMUP

    dev = "cuda"
    row = rows["blend_tiles_fwd"]
    t_phase = time.perf_counter()
    instances = Reenactor(model, params, state, ws, render_cfg=rcfg)
    views = [(torch.from_numpy(e).to(dev), torch.from_numpy(p).to(dev), cam)
             for e, p in zip(exprs, poses)]
    longest = longest_tile(model, instances.params, state, views, rcfg)
    k = tile_k(longest, rcfg.chunk)
    tcfg = dataclasses.replace(rcfg, kernel="tiles", max_per_tile=k)
    log(f"[tiles-serve] config override: max_per_tile {k} (yaml {rcfg.max_per_tile}): "
        f"the longest tile over the {N_FRAMES} frames holds {longest} instances, x "
        f"{TILE_K_HEADROOM} rounded up to a multiple of chunk {rcfg.chunk}; binning "
        f"{tcfg.binning} (build_tile_lists), R {tcfg.max_tiles_per_gaussian}, budget "
        f"{tcfg.instance_budget} (0 = 6N)")
    reenactor = Reenactor(model, params, state, ws, render_cfg=tcfg)
    reenactor.reenact(exprs[:2], poses[:2], delta, cam)      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: counts to 0 just before, read just after
    bi.blend_instances.launches = 0
    bt.blend_tiles.launches = 0
    t0 = time.perf_counter()
    frames = reenactor.reenact(exprs, poses, delta, cam)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    n = bt.blend_tiles.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    row["launches"] = n
    g = reenactor.last_graph
    log(f"[tiles-serve] blend_tiles_fwd launches in the serving path: {n} by the wrapper "
        f"({WARMUP} warm-up calls + the capture), then {g.replays} replays x "
        f"{g.launches_per_replay}; blend_instances_fwd {bi.blend_instances.launches}")
    check(n == WARMUP + 1 and g.replays == N_FRAMES
          and g.launches_per_replay == {"blend_tiles_fwd": 1}
          and bi.blend_instances.launches == 0,
          "one graph replay per frame, one dense-list blend launch each, no instance blend")
    check(len(frames) == N_FRAMES
          and all(f.shape == (cam.height, cam.width, 3) for f in frames),
          "16 frames of 512x512x3")
    spread = float(np.std(np.stack(frames).astype(np.float32)))
    check(spread > 5.0, f"frames must not be flat (pixel std {spread:.2f})")
    log(f"[tiles-serve] {N_FRAMES} frames in {serve_s * 1e3:.3f} ms: "
        f"{serve_s * 1e3 / N_FRAMES:.3f} ms/frame (host clock, uint8 frames on the "
        f"host, the graph's warm-up and capture included), peak device memory "
        f"{peak_gib:.3f} GiB, pixel std {spread:.2f} [{card}]")

    lat, overflow = [], []
    for e, p, c in views:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fateavatar_forward(model, reenactor.params, state, e, p, c, render_cfg=tcfg)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        overflow.append(int(out["overflow"]))
        check(bool(torch.isfinite(out["rgb_image"]).all()), "finite frame")
    log(f"[tiles-serve] per-frame forward ms (host clock, synchronized): median "
        f"{float(np.median(lat)):.3f} min {min(lat):.3f} max {max(lat):.3f}; overflow per "
        f"frame {overflow}")
    check(not any(overflow), "no instance dropped by the binning caps")

    for i in (0, N_FRAMES - 1):
        img_k = reenactor.render_frame(exprs[i], poses[i], cam)
        with swapped_blend(bt.blend_tiles_reference, "blend_tiles"):
            img_p = reenactor.render_frame(exprs[i], poses[i], cam)
        err = (img_k - img_p).abs().max().item()
        log(f"[tiles-serve] frame {i}: kernel vs plain tile blend pipeline max|diff| {err:.3e}")
        check(err <= TOL, f"frame {i} tile kernel vs plain {err:.3e} > {TOL}")
        row["max_abs_err"] = max(row.get("max_abs_err", 0.0), err)
    img_t = reenactor.render_frame(exprs[0], poses[0], cam)
    img_i = instances.render_frame(exprs[0], poses[0], cam)
    err = (img_t - img_i).abs().max().item()
    log(f"[tiles-serve] frame 0: kernel=\"tiles\" vs kernel=\"instances\" max|diff| "
        f"{err:.3e} (pixels differing: {int(((img_t - img_i).abs() > 0).sum())}); "
        f"bit-equal: {torch.equal(img_t, img_i)}")
    check(err <= TOL, f"frame 0 tiles vs instances {err:.3e} > {TOL}")

    # ---- kernel 3 on the real inputs of one full-width frame
    captured = []

    def record(*args):
        captured.append(args)
        return bt.blend_tiles(*args)

    with swapped_blend(record, "blend_tiles"):
        reenactor.render_frame(exprs[0], poses[0], cam)
    data, valid, counts, bg, grid, chunk = captured[0]
    log(f"[kernel] tiles frame 0: T*K {data.shape[1]} per-tile max {int(counts.max())} "
        f"mean {counts.float().mean().item():.1f}")
    check_blend("tiles frame 0 (serving inputs)", (data, valid, counts, bg, grid), row,
                bt.blend_tiles, bt.blend_tiles_reference)
    check_repeatable("tiles frame 0 forward",
                     lambda: bt.blend_tiles(data, valid, counts, bg, grid, chunk))
    tile_kernel_timings(data, valid, counts, bg, grid, chunk, row, "fwd", card, reps=50)

    e0, p0 = views[0][0], views[0][1]
    f_ms = cuda_ms(lambda: fateavatar_forward(model, reenactor.params, state, e0, p0, cam,
                                              render_cfg=tcfg), reps=20)
    log(f"[tiles-serve] forward {f_ms:.3f} ms (CUDA events, back to back), of which "
        f"kernel 3 {row['ms']:.3f} [{card}]")
    profile_top("4 tiles forwards", lambda i: fateavatar_forward(
        model, reenactor.params, state, e0, p0, cam, render_cfg=tcfg), 4, "frame", card)
    log(f"[tiles-serve] phase total {time.perf_counter() - t_phase:.1f} s")
    return tcfg


def tiles_train_phase(s, trainer_i, rows, card):
    """The training path through kernel="tiles": a Trainer epoch from the
    same initial avatar, kernel 4 on a captured training frame, one step's
    gradients against the plain tile blends and against the instances
    route, and the step's timings."""
    import torch

    from fateavatar_tpu_torch.cli import common
    from fateavatar_tpu_torch.render import blend_instances as bi
    from fateavatar_tpu_torch.render import blend_tiles as bt
    from fateavatar_tpu_torch.train.losses import FateAvatarLoss
    from fateavatar_tpu_torch.train.step import make_train_step
    from fateavatar_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    base = common.render_config(s.cfg)
    frames = [trainer_i._make_frame(s.train_ds.sample(i)) for i in range(N_TRAIN)]
    longest = longest_tile(s.model, s.params, s.state,
                           [(f.expression, f.flame_pose, f.camera) for f in frames], base)
    k = tile_k(longest, base.chunk)
    log(f"[tiles-train] config override: max_per_tile {k} (yaml {base.max_per_tile}): "
        f"the longest tile over the {N_TRAIN} training frames at the initial avatar holds "
        f"{longest} instances, x {TILE_K_HEADROOM} rounded up to a multiple of chunk "
        f"{base.chunk}; the other overrides as the instances phase")
    trainer = Trainer(s.cfg.name, s.model, s.params, s.state, s.loss_fn, s.optimizer,
                      s.train_ds, s.test_ds, workspace=os.path.join(s.tws, "tiles"),
                      maint_cfg=s.maint, seed=s.cfg.seed,
                      render_cfg=dataclasses.replace(base, kernel="tiles", max_per_tile=k))
    rcfg = trainer.render_cfg
    log(f"[tiles-train] render config after autosize: kernel {rcfg.kernel} K "
        f"{rcfg.max_per_tile} budget {rcfg.instance_budget} R {rcfg.max_tiles_per_gaussian}")
    events, step_fn = watch_maintenance(trainer, s.maint)
    torch.cuda.synchronize()
    # ---- the training path: counts to 0 just before, read just after
    counters = (bi.blend_instances, bi.blend_instances_bwd, bt.blend_tiles, bt.blend_tiles_bwd)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    trainer.train(1)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    trainer.train_step = step_fn
    launches = {"blend_tiles_fwd": bt.blend_tiles.launches,
                "blend_tiles_bwd": bt.blend_tiles_bwd.launches}
    for name, n in launches.items():
        rows[name]["launches"] = n
        log(f"[tiles-train] {name} launches in the training epoch: {n} ({N_TRAIN} steps)")
        check(n == N_TRAIN, f"{name}: one launch per training step")
    check(bi.blend_instances.launches == bi.blend_instances_bwd.launches == 0,
          "the tiles route launches no instance blend")
    log(f"[tiles-train] epoch of {N_TRAIN} steps in {epoch_s:.3f} s (host clock, incl. "
        f"maintenance and the checkpoint); per-step loss "
        f"{[round(x, 5) for x in trainer.epoch_losses]}")
    check_epoch("tiles-train", trainer, events, s.maint)

    # ---- kernel 4 on a captured full-width training frame
    frame = frames[0]
    captured = []

    def record(*args):
        img, tfin = bt.blend_tiles(*args)
        captured.append((args, img.detach(), tfin.detach()))
        img.register_hook(lambda g: captured.append(g))
        return img, tfin

    with swapped_blend(record, "blend_tiles"):
        trainer.train_step.grads(trainer.ts, frame)
    (data, valid, counts, bg, grid, chunk), img, tfin = captured[0]
    data = data.detach()
    kk = data.shape[1] // counts.shape[0]
    bwd_args = (data, valid, counts, bg, img, tfin, captured[1].contiguous(),
                torch.zeros_like(tfin), grid)
    log(f"[kernel] tiles training frame: T*K {data.shape[1]} per-tile max "
        f"{int(counts.max())} mean {counts.float().mean().item():.1f}")
    check_blend("tiles training frame (forward)", (data, valid, counts, bg, grid),
                rows["blend_tiles_fwd"], bt.blend_tiles, bt.blend_tiles_reference)
    check_blend_bwd("tiles training frame", bwd_args, rows["blend_tiles_bwd"],
                    bt.blend_tiles_bwd, bt.blend_tiles_backward_reference,
                    past_lists(counts, kk))
    check_repeatable("tiles training frame backward", lambda: bt.blend_tiles_bwd(*bwd_args))
    tile_kernel_timings(data, valid, counts, bg, grid, chunk, rows["blend_tiles_bwd"], "bwd",
                        card, reps=20, bwd_args=bwd_args)

    # ---- one whole step: tile kernels vs plain tile blends, and the tiles
    # route vs the instances route (the instances Trainer's autosized
    # config), same state and frame; float32 VGG, deterministic cuDNN
    cmp_loss = FateAvatarLoss(dataclasses.replace(s.loss_cfg, vgg_dtype=None),
                              vgg_params=s.vgg)
    cmp_t = make_train_step(s.model, cmp_loss, s.optimizer, s.maint, rcfg)
    cmp_i = make_train_step(s.model, cmp_loss, s.optimizer, s.maint, trainer_i.render_cfg)
    blends = {}

    def kept(name, fn):
        def run(*args):
            img, tfin = fn(*args)
            blends[name] = (img.detach(), tfin.detach())
            return img, tfin
        return run

    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        with swapped_blend(kept("tiles", bt.blend_tiles), "blend_tiles"):
            gk = cmp_t.grads(trainer.ts, frame)
        with swapped_blend(bt.blend_tiles_plain, "blend_tiles"):
            gp = cmp_t.grads(trainer.ts, frame)
        with swapped_blend(kept("instances", bi.blend_instances)):
            gi = cmp_i.grads(trainer.ts, frame)
    torch.cuda.synchronize()
    check(int(gk[2]["overflow"]) == int(gi[2]["overflow"]) == 0,
          "nothing dropped on the compared frame")
    check_step_grads("tiles-train", "tile kernels vs plain tile blends", gk, gp)
    worst = check_step_grads("tiles-train", "kernel=\"tiles\" vs kernel=\"instances\"",
                             gk, gi)
    # what the routes' blends differ by on that frame: kernels 3 and 1 run
    # the same segmented walk over the same sequences
    (img_t, tfin_t), (img_i, tfin_i) = blends["tiles"], blends["instances"]
    flips, rel = termination_flips(tfin_t, tfin_i)
    field, l2, _ = max(worst, key=lambda x: x[1])
    log(f"[tiles-train] the compared frame's blends, kernel 3 vs kernel 1: max|img diff| "
        f"{(img_t - img_i).abs().max().item():.3e}, bit-equal "
        f"{torch.equal(img_t, img_i) and torch.equal(tfin_t, tfin_i)}; termination flips "
        f"{flips} of "
        f"{tfin_t.numel()} pixels, the others' T_final within {rel:.1e} relative; the "
        f"step's largest gradient gap between the routes: {field} ({l2:.1e} rel L2)")

    # ---- timings of the step at full width
    never = 10**9
    timing_step = make_train_step(s.model, s.loss_fn, s.optimizer, dataclasses.replace(
        s.maint, densify_interval=never, prune_interval=never,
        opacity_reset_interval=never), rcfg)
    ts = trainer.ts
    for f in frames[:3]:
        timing_step(ts, f)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    for f in frames[3:13]:
        ts, _ = timing_step(ts, f)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 10
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"[tiles-train] ms/step {step_ms:.3f} (host clock, synchronized, 10 steady steps, "
        f"maintenance excluded), peak device memory {peak_gib:.3f} GiB (resident before "
        f"the steps {base_mem / 2**30:.3f} GiB) [{card}]")
    box = {"ts": ts}

    def step(i):
        box["ts"], _ = timing_step(box["ts"], frames[13 + i])

    profile_top("3 tiles train steps", step, 3, "step", card)
    log(f"[tiles-train] phase total {time.perf_counter() - t_phase:.1f} s")
    return rcfg


def graph_snapshot(tr):
    """The Trainer's state (train state, generator, step counters, tracking
    tables) in copies of its own."""
    from fateavatar_tpu_torch.train.step import clone_train_state
    from fateavatar_tpu_torch.train.tracking import clone_tracking

    track = (clone_tracking(tr.train_tables, tr.train_track_state) if tr.tracking_enabled
             else None)
    return (clone_train_state(tr.ts), tr.ts.generator.get_state(), tr.global_step,
            tr.epoch, track)


def graph_restore(tr, snap):
    """The Trainer back at ``snap``, in tensors of its own (so a scan epoch's
    static buffers never alias the snapshot)."""
    import torch

    from fateavatar_tpu_torch.train.step import clone_train_state
    from fateavatar_tpu_torch.train.tracking import clone_tracking

    ts, gen, tr.global_step, tr.epoch, track = snap
    tr.ts = clone_train_state(ts)
    tr.ts.generator = torch.Generator(device=tr.device)
    tr.ts.generator.set_state(gen)
    if track is not None:
        tr.train_tables, tr.train_track_state = clone_tracking(*track)


def rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


def timed(fn, n):
    """Host-clock and CUDA-event milliseconds per unit of ``fn()``, which
    does ``n`` units; synchronized before and after."""
    import torch

    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    t0 = time.perf_counter()
    ev[0].record()
    fn()
    ev[1].record()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n, ev[0].elapsed_time(ev[1]) / n


def zero_counts():
    from fateavatar_tpu_torch.render.render import KERNEL_COUNTERS

    for c in KERNEL_COUNTERS.values():
        c.launches = 0
    return KERNEL_COUNTERS


def graph_train(tag, tr, card, seen):
    """The scan epoch on the card for a Trainer whose device frame cache
    holds every training frame: one step eagerly and as the graph's first
    replay from one state; a whole epoch each way from that state (with the
    Trainer's maintenance intervals: those steps run eagerly in both); then,
    with no maintenance due, epochs in turns eager, graph (its capture),
    graph, eager, timed; and graph replays under the profiler (their kernel
    names into ``seen``). Returns the numbers for the summary."""
    import numpy as np
    import torch

    from fateavatar_tpu_torch.train.tracking import FIELDS
    from fateavatar_tpu_torch.utils.graphs import WARMUP

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    n = len(tr.train_dataset)
    route, tracking = tr.render_cfg.kernel, tr.tracking_enabled
    fwd, bwd = f"blend_{route}_fwd", f"blend_{route}_bwd"
    per = 2 if tracking else 1
    check(tr._frame_cache is not None and len(tr._frame_cache) == n,
          f"[{tag}] every training frame in the device cache")
    check(not tr.maint_cfg.due(tr.ts.step + 1), f"[{tag}] no maintenance at the compared step")
    snap = graph_snapshot(tr)
    first_step = tr.ts.step

    # ---- one step: eagerly, then as the graph's first replay
    sample = tr.train_dataset.sample(0)
    frame = tr._make_frame(sample, tr.train_tables)
    ts1, aux1 = tr.train_step(tr.ts, frame)
    if tracking:
        pose = np.asarray(sample["cam_pose"], np.float32)
        tables1, _ = tr._tracking_step(
            tr.train_tables, tr.train_track_state, sample["idx"],
            (pose[:3, :3].T, sample["fovx"], sample["fovy"], frame.rgb, ts1.state, ts1.params))
    graph_restore(tr, snap)
    counters = zero_counts()
    scan = tr._maybe_scan_epoch()
    tr._load_scan_state(scan)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scan.graph()
    torch.cuda.synchronize()
    capture_ms = (time.perf_counter() - t0) * 1e3
    g = scan.graph
    wrapper = {k: c.launches for k, c in counters.items() if c.launches}
    loss_e, loss_g = float(aux1["loss"]), float(scan.aux["loss"][0])
    rel0 = abs(loss_g - loss_e) / abs(loss_e)
    errs = {f.name: rel_l2(getattr(scan.ts.params, f.name), getattr(ts1.params, f.name))
            for f in dataclasses.fields(ts1.params)}
    if tracking:
        errs.update({f"tables.{f}": rel_l2(getattr(scan.tables, f), getattr(tables1, f))
                     for f in FIELDS})
    log(f"[{tag}] one step eager vs the graph's first replay (route {route}"
        f"{', with the tracking step' if tracking else ''}): loss {loss_e:.8f} vs "
        f"{loss_g:.8f} (rel {rel0:.1e}, bound {GRAPH_LOSS0_RTOL}); rel L2 after the step "
        + ", ".join(f"{k} {v:.1e}" for k, v in errs.items())
        + f" (bound {GRAPH_STEP_RTOL_L2})")
    log(f"[{tag}] capture: wrapper launches {wrapper} ({WARMUP} warm-up calls + the "
        f"capture), launches per replay {g.launches_per_replay}; warm-up, capture and "
        f"the first replay {capture_ms:.1f} ms")
    check(rel0 <= GRAPH_LOSS0_RTOL, f"[{tag}] first step's loss graph vs eager {rel0:.2e}")
    check(all(v <= GRAPH_STEP_RTOL_L2 for v in errs.values()),
          f"[{tag}] state after one step graph vs eager")
    check(g.launches_per_replay == {fwd: per, bwd: per}
          and wrapper == {fwd: (WARMUP + 1) * per, bwd: (WARMUP + 1) * per},
          f"[{tag}] {per} launch of kernels {fwd} and {bwd} per replay")

    # ---- a whole epoch each way from the same state
    graph_restore(tr, snap)
    tr._scan_disabled = True
    tr.epoch += 1
    tr.train_epoch()
    eager = np.asarray(tr.epoch_losses)
    check(tr.last_epoch_stats["mode"] == "per-step", f"[{tag}] the eager epoch runs per step")
    graph_restore(tr, snap)
    tr._scan_disabled = False
    tr.epoch += 1
    r0 = g.replays
    counters = zero_counts()
    tr.train_epoch()
    graph = tr.last_epoch_aux["loss"]
    due = [first_step + j + 1 for j in range(n) if tr.maint_cfg.due(first_step + j + 1)]
    rel = np.abs(graph - eager) / np.abs(eager)
    log(f"[{tag}] epoch of {n} steps from one state, eager vs graph: per-step loss rel diff "
        f"max {rel.max():.1e} (bound {GRAPH_EPOCH_RTOL}), step 1 {rel[0]:.1e}; graph "
        f"losses {[round(float(x), 5) for x in graph]}; {g.replays - r0} replays, steps "
        f"{due} eagerly (maintenance; wrapper launches {dict((k, c.launches) for k, c in counters.items() if c.launches)}); "
        f"mode {tr.last_epoch_stats['mode']}")
    check(tr.last_epoch_stats["mode"] == "scan" and tr._scan_epoch is scan,
          f"[{tag}] the captured epoch reports mode scan")
    check(g.replays - r0 == n - len(due), f"[{tag}] one replay per step without maintenance")
    check(bool(np.isfinite(graph).all()) and rel[0] <= GRAPH_LOSS0_RTOL
          and rel.max() <= GRAPH_EPOCH_RTOL, f"[{tag}] the epoch's losses graph vs eager")

    # ---- steady epochs without maintenance: eager, graph, graph, eager
    never = 10**9
    tr.maint_cfg = dataclasses.replace(tr.maint_cfg, densify_interval=never,
                                       prune_interval=never, opacity_reset_interval=never)
    tr.set_render_cfg(tr.render_cfg)    # rebuilds the step; drops the graph
    t = {}
    for i, mode in enumerate(("eager", "graph", "graph", "eager")):
        tr._scan_disabled = mode == "eager"
        tr.epoch += 1
        t[i] = timed(tr.train_epoch, n)
        check(tr.last_epoch_stats["mode"] == ("per-step" if mode == "eager" else "scan"),
              f"[{tag}] {mode} epoch mode")
    log(f"[{tag}] ms/step, no maintenance due (host clock / CUDA events, epochs of {n} "
        f"steps in turns): eager {t[0][0]:.3f} / {t[0][1]:.3f} (first, its frames "
        f"re-uploaded after the stacking), graph {t[1][0]:.3f} / {t[1][1]:.3f} (first: "
        f"warm-up and capture), graph {t[2][0]:.3f} / {t[2][1]:.3f}, eager {t[3][0]:.3f} / "
        f"{t[3][1]:.3f}; steady graph vs eager {t[3][0] / t[2][0]:.2f}x by the host clock "
        f"[{card}]")

    # ---- replays under the profiler
    scan = tr._scan_epoch
    tr._load_scan_state(scan)
    k = min(n, GRAPH_PROFILE)
    prof = profile_top(f"{k} replays of the {tag} graph", lambda i: scan.graph(), k,
                       "replay", card)
    seen.update(prof["names"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{tag}] peak device memory {peak:.3f} GiB (the Trainer's eager steps, two "
        f"captures; its graph's pool held); phase total {time.perf_counter() - t_phase:.1f} s")
    return {"eager_ms": t[3], "graph_ms": t[2], "capture_epoch_ms": t[1], "profile": prof,
            "per_replay": dict(scan.graph.launches_per_replay), "peak_gib": peak}


def graph_serve(tag, model, params, state, ws, rcfg, cam, exprs, poses, delta, card, seen):
    """Reenactor.reenact through its graph against the eager loop it
    replaced (render_frame, round and clip to uint8, a host copy every
    DRAIN frames) on the same sequence: frames equal bit for bit; ms per
    frame of the eager loop, of a whole call (its warm-up and capture
    included) over N_FRAMES and SERVE_LONG * N_FRAMES frames, and of the
    graph's replays alone (rewound to the first frame), which also run
    under the profiler."""
    import numpy as np
    import torch

    from fateavatar_tpu_torch.train.loader import DRAIN, Reenactor
    from fateavatar_tpu_torch.utils.graphs import WARMUP

    torch.cuda.reset_peak_memory_stats()
    rr = Reenactor(model, params, state, ws, render_cfg=rcfg)
    fwd = f"blend_{rcfg.kernel}_fwd"
    n_exp = model.flame.n_exp

    def eager(ex, po):
        frames, pending = [], []
        for expr, pose in zip(ex, po):
            e = np.zeros(n_exp, np.float32)
            m = min(n_exp, len(expr))
            e[:m] = expr[:m]
            e[:len(delta)] -= delta[:len(e)]
            img = rr.render_frame(e, pose, cam)
            pending.append(torch.clamp(torch.round(img * 255.0), 0, 255).to(torch.uint8))
            if len(pending) == DRAIN:
                frames.extend(torch.stack(pending).cpu().numpy())
                pending.clear()
        if pending:
            frames.extend(torch.stack(pending).cpu().numpy())
        return frames

    n = len(exprs)
    long_e, long_p = np.tile(exprs, (SERVE_LONG, 1)), np.tile(poses, (SERVE_LONG, 1))
    eager(exprs[:2], poses[:2])                                  # warm-up
    box = {}
    e_ms = timed(lambda: box.update(eager=eager(exprs, poses)), n)
    counters = zero_counts()
    g_ms = timed(lambda: box.update(graph=rr.reenact(exprs, poses, delta, cam)), n)
    g = rr.last_graph
    wrapper = {k: c.launches for k, c in counters.items() if c.launches}
    gl_ms = timed(lambda: rr.reenact(long_e, long_p, delta, cam), SERVE_LONG * n)
    e2_ms = timed(lambda: eager(exprs, poses), n)
    g = rr.last_graph
    cursor = g.buffers[0]          # the served frame's device cursor (train/loader.py)

    def replays():
        cursor.zero_()
        for _ in range(SERVE_LONG * n):
            g()

    r_ms = timed(replays, SERVE_LONG * n)
    same = all(np.array_equal(a, b) for a, b in zip(box["graph"], box["eager"]))
    log(f"[{tag}] {n} frames, graph vs eager loop: bit-equal {same}; wrapper launches "
        f"{wrapper} ({WARMUP} warm-up calls + the capture), {n} replays x "
        f"{g.launches_per_replay}")
    log(f"[{tag}] ms/frame (host clock / CUDA events): eager loop {e_ms[0]:.3f} / "
        f"{e_ms[1]:.3f} and {e2_ms[0]:.3f} / {e2_ms[1]:.3f}; reenact through the graph "
        f"over {n} frames {g_ms[0]:.3f} / {g_ms[1]:.3f} and over {SERVE_LONG * n} frames "
        f"{gl_ms[0]:.3f} / {gl_ms[1]:.3f} (warm-up and capture included); the graph's "
        f"{SERVE_LONG * n} replays alone {r_ms[0]:.3f} / {r_ms[1]:.3f} [{card}]")
    check(len(box["graph"]) == n and same, f"[{tag}] served frames graph == eager, bit for bit")
    check(g.launches_per_replay == {fwd: 1} and wrapper == {fwd: WARMUP + 1},
          f"[{tag}] one {fwd} launch per replay")
    cursor.zero_()
    prof = profile_top(f"{n} replays of the served frame's graph ({tag})", lambda i: g(), n,
                       "frame", card)
    seen.update(prof["names"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{tag}] peak device memory {peak:.3f} GiB")
    return {"eager_ms": e2_ms, "call_ms": g_ms, "long_call_ms": gl_ms, "replay_ms": r_ms,
            "profile": prof, "per_replay": dict(g.launches_per_replay), "peak_gib": peak}


def capabilities():
    """What the machine offers the host side: a C++ compiler, the libpng
    and libjpeg headers (for a copy of the JAX package's native loader),
    ffmpeg (mp4 videos), PIL, matplotlib (metric plots), torchvision, cv2
    (the JAX package's alignment runs on it; the port's re-implements it)
    and scipy."""
    import glob
    import importlib.util
    import shutil

    def header(name):
        return bool([p for d in ("/usr/include", "/usr/local/include")
                     for p in glob.glob(os.path.join(d, "**", name), recursive=True)][:1])

    caps = {"g++": shutil.which("g++") is not None, "png.h": header("png.h"),
            "jpeglib.h": header("jpeglib.h"), "ffmpeg": shutil.which("ffmpeg") is not None}
    for mod in ("PIL", "matplotlib", "torchvision", "cv2", "scipy"):
        caps[mod] = importlib.util.find_spec(mod) is not None
    return caps


@contextmanager
def counted(cls, names, record):
    """Wrap methods ``names`` of ``cls``: each call appends (name, kernel 1
    launches, kernel 2 launches, host seconds, synchronized) to ``record``."""
    import torch

    from fateavatar_tpu_torch.render import blend_instances as bi

    orig = {n: getattr(cls, n) for n in names}

    def wrap(name, fn):
        def inner(*args, **kwargs):
            torch.cuda.synchronize()
            f0, b0, t0 = bi.blend_instances.launches, bi.blend_instances_bwd.launches, \
                time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            record.append((name, bi.blend_instances.launches - f0,
                           bi.blend_instances_bwd.launches - b0, time.perf_counter() - t0))
            return out
        return inner

    for n, fn in orig.items():
        setattr(cls, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in orig.items():
            setattr(cls, n, fn)


def write_cli_layout(ws, model, params, state):
    """An IMAvatar subject under ``ws``: CLI_TRAIN + CLI_TEST frames at
    512x512, ground truth the RGBA renders of ``params`` (black background:
    colour / alpha, alpha = 1 - T_final) through the kernels, expression and
    pose codes of std 0.05, the cameras of SyntheticDataset's orbit, and
    seeded random VGG16 weights as an npz. Returns (root, vgg path, frame 0's
    binned instances, its share of covered pixels)."""
    import numpy as np
    import torch

    from fateavatar_tpu_torch.models.fateavatar import build_gaussians
    from fateavatar_tpu_torch.ops.camera import make_camera
    from fateavatar_tpu_torch.render.render import render
    from fateavatar_tpu_torch.train.losses import vgg16_random_params
    from fateavatar_tpu_torch.utils.png import write_png

    _tests_on_path()
    from torch_layouts import orbit, write_imavatar

    dev = "cuda"
    rng = np.random.default_rng(1)
    root = os.path.join(ws, "imavatar", "subj")
    h, w = model.cfg.img_height, model.cfg.img_width
    stats = {}
    for mode, n in (("train", CLI_TRAIN), ("test", CLI_TEST)):
        exprs = (rng.normal(size=(n, 50)) * 0.05).astype(np.float32)
        poses = (rng.normal(size=(n, 15)) * 0.05).astype(np.float32)
        views = orbit(n)
        imgs = []
        for i in range(n):
            cam = make_camera(views[i, :3, :3].T, views[i, :3, 3], 0.8, 0.8, w, h, device=dev)
            g = build_gaussians(model, params, state, torch.from_numpy(exprs[i]).to(dev),
                                torch.from_numpy(poses[i]).to(dev))[0]
            with torch.no_grad():
                out = render(cam, g, torch.zeros(3, device=dev))
            alpha = 1.0 - out["t_final"]
            rgb = out["render"] / alpha.clamp_min(1e-6)[..., None]
            rgba = torch.cat([rgb, alpha[..., None]], dim=-1).clamp(0, 1)
            imgs.append((rgba * 255.0).round().to(torch.uint8).cpu().numpy())
            check(bool(torch.isfinite(rgba).all()), f"finite ground truth {mode} {i}")
            if mode == "train" and i == 0:
                stats = {"instances": int(out["tile_counts"].sum()),
                         "covered": float((alpha > 0.5).float().mean())}
        write_imavatar(root, mode, imgs, views, exprs, poses, np.zeros(100), 0.8, write_png)
    vgg = vgg16_random_params(torch.Generator(device=dev).manual_seed(0), device=dev)
    vgg_path = os.path.join(ws, "vgg16_random.npz")
    np.savez(vgg_path, **{f"{k}{i}": x.cpu().numpy() for i, (wt, b) in enumerate(vgg)
                          for k, x in (("w", wt), ("b", b))})
    return root, vgg_path, stats


def cli_phase(ws, model, params, state, rows, card, train_step_ms):
    """The monocular-video path through the port's CLIs at full width: an
    IMAvatar layout on disk -> train_mono_avatar (one epoch with per-frame
    tracking, snapshots, the test rows' fit, eval, media, checkpoint) ->
    --resume to epoch 2 -> avatar_reenact on the test layout; then one
    tracking step's row gradients, kernels vs plain blends. Returns the
    Trainer, the workspace, the layout's root, and the CLI's config and
    asset arguments."""
    import numpy as np
    import torch

    from fateavatar_tpu_torch.cli import avatar_reenact, train_mono_avatar
    from fateavatar_tpu_torch.render import blend_instances as bi
    from fateavatar_tpu_torch.train import tracking
    from fateavatar_tpu_torch.train.losses import FateAvatarLoss
    from fateavatar_tpu_torch.train.trainer import Trainer
    from fateavatar_tpu_torch.utils.graphs import WARMUP
    from fateavatar_tpu_torch.utils.png import read_png

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cws = os.path.join(ws, "cli")
    root, vgg_path, gt0 = write_cli_layout(cws, model, params, state)
    log(f"[cli] IMAvatar layout {root}: {CLI_TRAIN} train / {CLI_TEST} test frames of "
        f"{model.cfg.img_height}x{model.cfg.img_width}, ground truth the serving "
        f"checkpoint's RGBA renders (codes std 0.05); frame 0 bins {gt0['instances']} "
        f"instances and covers {gt0['covered']:.1%} of its pixels "
        f"(built in {time.perf_counter() - t_phase:.1f} s)")
    check(gt0["instances"] > 0 and gt0["covered"] > 0.01,
          "frame 0 bins instances and differs from the background")

    run = os.path.join(cws, "run")
    yaml = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                        "fateavatar.yaml")
    device = ["--device", "cuda"]
    assets = [f"assets.flame_model_path={os.path.join(ws, 'generic_model.pkl')}",
              f"assets.template_mesh_path={os.path.join(ws, 'head_template.obj')}",
              f"assets.vgg16_weights_path={vgg_path}"]
    args = ["--config", yaml, *device, f"dataset.root_path={root}", f"workspace={run}",
            *assets, f"training.epochs.finetune={CLI_FINETUNE}",
            f"training.snapshot_interval={CLI_SNAPSHOT}",
            *(f"training.{k}={v}" for k, v in MAINT_OVERRIDES.items())]
    log(f"[cli] train_mono_avatar overrides: {args[4:]}")
    names = ("train_epoch", "save_snapshot", "optimize_tracking", "evaluate")
    media = os.path.join(run, "media")
    trainers = []
    for epochs, extra in ((1, []), (2, ["--resume"])):
        record = []
        # ---- the CLI path: counts to 0 just before, read just after
        bi.blend_instances.launches = 0
        bi.blend_instances_bwd.launches = 0
        t0 = time.perf_counter()
        with counted(Trainer, names, record):
            tr = train_mono_avatar.main(["--epochs", str(epochs), *extra, *args])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        fwd, bwd = bi.blend_instances.launches, bi.blend_instances_bwd.launches
        trainers.append(tr)
        rec = {n: [r for r in record if r[0] == n] for n in names}
        snaps = rec["save_snapshot"]
        ep = rec["train_epoch"][0]
        steps = len(tr.train_dataset)
        step_f = (ep[1] - sum(r[1] for r in snaps)) / steps
        step_b = (ep[2] - sum(r[2] for r in snaps)) / steps
        opt = rec["optimize_tracking"][0]
        ev = rec["evaluate"][0]
        tag = f"[cli] run {len(trainers)} (--epochs {epochs}{' --resume' if extra else ''})"
        log(f"{tag}: {run_s:.1f} s; per-step loss "
            f"{[round(x, 5) for x in tr.epoch_losses]}; launches per step: forward "
            f"{step_f:g}, backward {step_b:g} (train step + tracking step); snapshots "
            f"{len(snaps)} ({[(r[1], r[2]) for r in snaps]} launches, "
            f"{sum(r[3] for r in snaps):.2f} s); optimize_tracking {opt[1]} / {opt[2]} "
            f"launches, {opt[3] * 1e3 / CLI_FINETUNE:.2f} ms per batch of "
            f"{len(tr.test_dataset)} frames; evaluate {ev[1] - opt[1]} forward launches; "
            f"in all {fwd} forward, {bwd} backward")
        check(all(np.isfinite(tr.epoch_losses)) and len(tr.epoch_losses) == steps,
              "finite loss every step")
        check(step_f == 2 and step_b == 2, "a step launches kernels 1 and 2 twice "
              "(the train step, then the tracking step)")
        check(len(snaps) == 2 and all(r[1] == 4 and r[2] == 0 for r in snaps),
              "two snapshots of four renders each")
        n_test = len(tr.test_dataset)
        check(opt[1] == opt[2] == CLI_FINETUNE * n_test, "finetune steps per test row")
        check(ev[1] - opt[1] == n_test and ev[2] == opt[2], "one eval forward per test frame")
        check(fwd == 2 * steps + 8 + CLI_FINETUNE * n_test + n_test
              and bwd == 2 * steps + CLI_FINETUNE * n_test, "launch totals of the run")
        ds = tr.train_dataset
        moved = {f: int((getattr(tr.train_tables, f).cpu().numpy() != ref).any(axis=1).sum())
                 for f, ref in (("expression", ds.expressions), ("flame_pose", ds.flame_pose),
                                ("cam_t", ds.world_mats[:, :3, 3]))}
        shift = {f: float(np.abs(getattr(tr.train_tables, f).cpu().numpy() - ref).max())
                 for f, ref in (("expression", ds.expressions), ("flame_pose", ds.flame_pose),
                                ("cam_t", ds.world_mats[:, :3, 3]))}
        tc, vc = tr.train_track_state.count.tolist(), tr.test_track_state.count.tolist()
        log(f"{tag}: train rows moved {moved} of {steps} (largest shift {shift}); "
            f"tracking counts train {tc}, test {vc}")
        check(all(v == steps for v in moved.values()), "every train row moved")
        check(tc == [epochs] * steps and vc == [CLI_FINETUNE] * n_test,
              "tracking counts equal the visits")
        with open(os.path.join(media, "metrics", f"test_epoch{epochs}.json")) as fh:
            summary = json.load(fh)["summary"]
        log(f"{tag}: eval psnr {summary['psnr']:.4f} ssim {summary['ssim']:.4f} "
            f"l1 {summary['l1']:.5f}")
        check(all(np.isfinite(v) for v in summary.values()), "finite eval metrics")
        video = [f for f in (f"test_epoch{epochs}.mp4", f"test_epoch{epochs}.gif")
                 if os.path.exists(os.path.join(media, "eval_videos", f))]
        first = (epochs - 1) * steps
        files = [os.path.join(media, "eval_images", f"test_epoch{epochs}_frame0.png")] + [
            os.path.join(media, "snapshots", f"step{first + k:08d}.png")
            for k in (CLI_SNAPSHOT, 2 * CLI_SNAPSHOT)]
        check(len(video) == 1 and all(os.path.exists(f) for f in files),
              f"media of run {len(trainers)}")
        shapes = [read_png(f).shape for f in files]
        log(f"{tag}: media metrics/test_epoch{epochs}.json, eval_videos/{video[0]}, "
            + ", ".join(f"{os.path.relpath(f, media)} {sh[1]}x{sh[0]}"
                        for f, sh in zip(files, shapes)))
        h, w = model.cfg.img_height, model.cfg.img_width
        check(shapes[0] == (h, 2 * w, 3) and shapes[1] == shapes[2] == (2 * h, 4 * w, 3),
              "media sizes")
    check(trainers[1].global_step == 2 * CLI_TRAIN, "resumed to epoch 2")

    # ---- reenactment of the test layout
    out = os.path.join(cws, "reenact.mp4")
    bi.blend_instances.launches = 0
    frames = avatar_reenact.main(["--config", yaml, *device, "--dst_workspace", run,
                                  "--src_root", root, "--out", out, *assets])
    written = [f for f in (out, out[:-4] + ".gif") if os.path.exists(f)]
    log(f"[cli] avatar_reenact: {len(frames)} frames, {bi.blend_instances.launches} forward "
        f"launches by the wrapper (the graph's warm-up calls and capture), then "
        f"{CLI_TEST} replays; wrote {[os.path.basename(f) for f in written]}")
    check(len(frames) == CLI_TEST and bi.blend_instances.launches == WARMUP + 1
          and len(written) == 1, "reenacted frames and their video")

    phase_peak = torch.cuda.max_memory_allocated() / 2**30
    # ---- timings with tracking, the same trainer, no maintenance due
    tr = trainers[1]
    tr.snapshot_interval = 10**9
    never = 10**9
    tr.maint_cfg = dataclasses.replace(tr.maint_cfg, densify_interval=never,
                                       prune_interval=never, opacity_reset_interval=never)
    tr.set_render_cfg(tr.render_cfg)     # rebuilds the train step on maint_cfg
    tr._scan_disabled = True             # eager epochs here; [graph] captures them
    t_ms = {}
    torch.cuda.reset_peak_memory_stats()
    for label, enabled in (("with tracking", True), ("without tracking", False)):
        tr.tracking_enabled = enabled
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_epoch()
        torch.cuda.synchronize()
        t_ms[label] = (time.perf_counter() - t0) * 1e3 / CLI_TRAIN
    tr.tracking_enabled = True
    epoch_peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[cli] ms/step with tracking {t_ms['with tracking']:.3f}, without "
        f"{t_ms['without tracking']:.3f} (one epoch of {CLI_TRAIN} steps each, same trainer, "
        f"host clock, synchronized, frames in the device cache, maintenance excluded); "
        f"[train]'s ms/step "
        f"without tracking {train_step_ms:.3f}; peak device memory of these epochs "
        f"{epoch_peak:.3f} GiB [{card}]")

    samples = [tr.train_dataset.sample(i) for i in range(3)]

    def step_and_track(i):
        sample = samples[i]
        frame = tr._make_frame(sample, tr.train_tables)
        tr.ts, _ = tr.train_step(tr.ts, frame)
        pose = np.asarray(sample["cam_pose"], np.float32)
        tr.train_tables, tr.train_track_state = tr._tracking_step(
            tr.train_tables, tr.train_track_state, sample["idx"],
            (pose[:3, :3].T, sample["fovx"], sample["fovy"], frame.rgb, tr.ts.state,
             tr.ts.params))

    profile_top("3 train steps, each with its tracking step", step_and_track, 3, "step", card)

    # ---- one tracking step's row gradients, kernels vs plain blends. The
    # VGG stack runs in float32 with TF32 off and deterministic cuDNN here,
    # so that only the blends differ between the two.
    loss_fn = tr.loss_fn
    tr.loss_fn = FateAvatarLoss(dataclasses.replace(loss_fn.cfg, vgg_dtype=None),
                                vgg_params=loss_fn.vgg_params)
    sample = tr.train_dataset.sample(0)
    frame = tr._make_frame(sample, tr.train_tables)
    cam_pose = np.asarray(sample["cam_pose"], np.float32)
    const = (cam_pose[:3, :3].T, sample["fovx"], sample["fovy"], frame.rgb,
             tr.ts.state, tr.ts.params)
    rows_in = (tr.train_tables.expression[0], tr.train_tables.flame_pose[0],
               tr.train_tables.cam_t[0])
    captured = []

    def record(*a):
        img, tfin = bi.blend_instances(*a)
        captured.append((a, tfin.detach()))
        return img, tfin

    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        with swapped_blend(record):
            gk = tracking.row_gradients(tr._tracking_loss, *rows_in, const)
        with swapped_blend(bi.blend_instances_plain):
            gp = tracking.row_gradients(tr._tracking_loss, *rows_in, const)
    tr.loss_fn = loss_fn
    inputs, tfin_k = captured[0]
    with torch.no_grad():
        flips, rel_t = termination_flips(tfin_k, bi.blend_instances_reference(*inputs)[1])
    errs = {}
    for f in tracking.FIELDS:
        a, b = getattr(gk, f), getattr(gp, f)
        check(bool(torch.isfinite(a).all()) and float(b.norm()) > 0, f"tracking gradient {f}")
        errs[f] = float((a - b).norm() / b.norm())
    log(f"[cli] one tracking step, kernels vs plain blends: row gradients relative L2 "
        + ", ".join(f"{f} {e:.1e}" for f, e in errs.items())
        + f" (bound {TRACK_RTOL_L2}); the frame's termination flips {flips}, other pixels' "
        f"T_final within {rel_t:.1e} relative")
    check(all(e <= TRACK_RTOL_L2 for e in errs.values()),
          "tracking gradients kernels vs plain blends")
    for name in ("blend_instances_fwd", "blend_instances_bwd"):
        rows[name]["launches"] = fwd if name.endswith("fwd") else bwd
    log(f"[cli] peak device memory of the phase {phase_peak:.3f} GiB (the model's "
        f"init: its KNN takes the distances of 4,096 points to all at once); phase total "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return SimpleNamespace(trainer=tr, run=run, root=root, config=["--config", yaml],
                           assets=assets)


@contextmanager
def recorded(owner, name, record):
    """Wrap ``owner.name`` (a method or module function): each call appends
    (kernel 1 launches, kernel 2 launches, seconds, peak GiB during the
    call, the call's result) to ``record``, synchronized around it."""
    import torch

    from fateavatar_tpu_torch.render import blend_instances as bi

    orig = getattr(owner, name)

    def inner(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        f0, b0, t0 = bi.blend_instances.launches, bi.blend_instances_bwd.launches, \
            time.perf_counter()
        out = orig(*args, **kwargs)
        torch.cuda.synchronize()
        record.append((bi.blend_instances.launches - f0, bi.blend_instances_bwd.launches - b0,
                       time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30,
                       out))
        return out

    setattr(owner, name, inner)
    try:
        yield
    finally:
        setattr(owner, name, orig)


def device_busy_ms(fn, n):
    """Kernel time on the card per call of ``fn()`` (torch.profiler, ``n``
    calls after one warm-up), without the host's gaps between launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    check(us > 0, "the profiler saw device time")
    return us / n / 1e3


def busy_union_ms(fn):
    """One call of ``fn()`` under torch.profiler: its wall ms and the ms
    the card was busy in it (``device_union_us``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = device_union_us(prof)
    check(busy_us > 0, "the profiler saw device time")
    return wall_us / 1e3, busy_us / 1e3


def bake_stage_split(baker, frame, card):
    """Device busy ms (profiler) and CUDA-event ms of eager calls, forward
    and backward where the stage has a backward, of the bake step's stages
    on ``frame``: the UNet, the texture lookup, FLAME and the splat
    binding, render (kernels 1 and 2), the loss, Adam; and the UNet with
    cuDNN's TF32 the other way; the step's state restored after."""
    import torch

    from fateavatar_tpu_torch.models import uv_decoder as uvd
    from fateavatar_tpu_torch.ops.camera import make_camera
    from fateavatar_tpu_torch.render.render import render

    model, net, dev = baker.model, baker.net, baker.device
    snap = baker.snapshot()
    gen = torch.Generator(device=dev).manual_seed(1)
    cfg = model.avatar.cfg
    cam = make_camera(frame["R"], frame["T"], frame["fovx"], frame["fovy"], cfg.img_width,
                      cfg.img_height, device=dev)
    with torch.no_grad():
        tex = net(baker.const, True)
    g_tex = torch.randn(tex.shape, generator=gen, device=dev)
    params = list(net.parameters())

    def unet():
        out = net(baker.const, True)
        torch.autograd.grad(out, [*params, baker.const], g_tex, allow_unused=True)

    raw, act = uvd.decode_textures(model, net, baker.const.detach(), train=False)
    act = {k: v.detach().requires_grad_() for k, v in act.items()}
    dec = uvd.sample_attributes(model, act)
    g_dec = {k: torch.randn(v.shape, generator=gen, device=dev) for k, v in dec.items()}

    def lookup():
        d = uvd.sample_attributes(model, act)
        torch.autograd.grad([d[k] for k in d], list(act.values()), [g_dec[k] for k in d])

    values = uvd._merge_with_priors(model, {k: v.detach() for k, v in dec.items()})

    def flame():
        with torch.no_grad():
            uvd._assemble_gaussians(model, values, frame["expression"], frame["flame_pose"])

    gs = uvd._assemble_gaussians(model, values, frame["expression"], frame["flame_pose"])[0]
    leaves = {f: getattr(gs, f).detach().requires_grad_()
              for f in ("xyz", "scaling", "rotation", "opacity", "features_dc")}
    gs = dataclasses.replace(gs, **leaves)
    img = render(cam, gs, frame["bg"], config=baker.render_cfg)["render"]
    g_img = torch.randn(img.shape, generator=gen, device=dev)

    def rend():
        out = render(cam, gs, frame["bg"], config=baker.render_cfg)["render"]
        torch.autograd.grad(out, list(leaves.values()), g_img)

    with torch.no_grad():
        fwd = uvd.uv_decoder_forward(model, net, baker.const, frame["expression"],
                                     frame["flame_pose"], cam, bg_color=frame["bg"],
                                     render_cfg=baker.render_cfg, train=False)
    pred = fwd["rgb_image"].detach().requires_grad_()

    def loss():
        out = baker.loss_fn({**fwd, "rgb_image": pred}, {"rgb": frame["rgb"]})
        torch.autograd.grad(out["loss"], pred)

    grads = [torch.randn(p.shape, generator=gen, device=dev) * 1e-3 for p in baker.trainables]
    stages = (("UNet", unet), ("lookup", lookup), ("FLAME + binding", flame), ("render", rend),
              ("loss", loss), ("Adam", lambda: baker.adam_(grads)))
    busy = {name: device_busy_ms(fn, 5) for name, fn in stages}
    ms = {name: cuda_ms(fn, reps=10) for name, fn in stages}
    baker.restore(snap)
    tf32 = torch.backends.cudnn.allow_tf32
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                    allow_tf32=not tf32):
        unet_alt = device_busy_ms(unet, 5)
    baker.restore(snap)
    log("[bake] stage split, forward + backward where the stage has one, device busy ms "
        "(profiler, kernel time of 5 calls each): "
        + ", ".join(f"{k} {v:.3f}" for k, v in busy.items())
        + f"; sum {sum(busy.values()):.3f}; the UNet with cuDNN TF32 {'off' if tf32 else 'on'} "
        f"{unet_alt:.3f}; CUDA-event ms of 10 eager calls each (host gaps included): "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) + f" [{card}]")
    return busy, unet_alt


def bake_phase(cli, rows, card):
    """[bake]: cli/train_neural_baking (UNet, colour and opacity baked,
    reg 0.1 on colour, 2 epochs) on the [cli] phase's IMAvatar workspace
    with the yaml's loss and its random VGG16 weights; the launches of
    kernels 1 and 2 per bake step (the CLI's captured step: per replay, and
    per eager step), per-epoch losses, overflow, the files, the exported
    avatar through fateavatar_forward; one step with the kernels vs the
    plain blends; the graph vs eager from one state (one step, an epoch);
    ms/step each way (and eagerly with cuDNN's TF32 the other way), the
    stage split, the replays
    under the profiler, the capture's cost, peak memory (the KNN, the
    step), and the baked textures' render against the splat render.
    Returns the baker."""
    import numpy as np
    import torch

    _tests_on_path()
    from torch_determinism import deterministic_sums

    from fateavatar_tpu_torch.cli import train_neural_baking
    from fateavatar_tpu_torch.models import uv_decoder as uvd
    from fateavatar_tpu_torch.models.fateavatar import fateavatar_forward
    from fateavatar_tpu_torch.ops.camera import make_camera
    from fateavatar_tpu_torch.render import blend_instances as bi
    from fateavatar_tpu_torch.train.baker import UVBaker
    from fateavatar_tpu_torch.train.checkpoints import load_pytree
    from fateavatar_tpu_torch.train.loader import Loader
    from fateavatar_tpu_torch.train.losses import FateAvatarLoss
    from fateavatar_tpu_torch.utils.graphs import WARMUP, Graph
    from fateavatar_tpu_torch.utils.png import read_png

    t_phase = time.perf_counter()
    run = cli.run
    args = [*cli.config, "--device", "cuda", "--workspace", run, *BAKE_ARGS,
            f"dataset.root_path={cli.root}", *cli.assets]
    log(f"[bake] train_neural_baking {args[2:]}; cuDNN TF32 "
        f"{torch.backends.cudnn.allow_tf32}, matmul TF32 {torch.backends.cuda.matmul.allow_tf32} "
        "(the port's settings, made on import)")
    built, epochs = [], []
    # ---- the bake path: counts to 0 just before, read just after
    zero_counts()
    t0 = time.perf_counter()
    with recorded(uvd, "build_uv_decoder", built), recorded(UVBaker, "bake_epoch", epochs):
        baker = train_neural_baking.main(args)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    fwd, bwd = bi.blend_instances.launches, bi.blend_instances_bwd.launches
    g = baker.graph
    steps = BAKE_EPOCHS * len(baker.dataset)
    m = baker.model.face_index.shape[0]
    b = built[0]
    log(f"[bake] build_uv_decoder: M {m} splats ({int(baker.model.alive.sum())} alive), sample "
        f"radius {float(baker.model.sample_radius):.3e}, scaling mean "
        f"{float(baker.model.mean_scaling):.4f} std {float(baker.model.std_scaling):.4f}; "
        f"{b[2]:.2f} s, peak device memory {b[3]:.3f} GiB (the KNN's 4,096 x {m} distances "
        f"per chunk) [{card}]")
    per_epoch = [e[4] for e in epochs]      # bake_epoch returns its stats
    log(f"[bake] CLI run {run_s:.1f} s: {steps} steps in {BAKE_EPOCHS} epochs; per epoch "
        + "; ".join(f"loss {s['loss']:.5f} reg {s['reg_loss']:.5f} overflow {s['overflow']} "
                    f"{s['its']:.2f} it/s ({e[0]} / {e[1]} wrapper launches, peak "
                    f"{e[3]:.3f} GiB)" for s, e in zip(per_epoch, epochs))
        + f"; kernel launches by the wrapper {fwd} forward, {bwd} backward ({WARMUP} warm-up "
        f"calls + the capture), then {g.replays} replays x {g.launches_per_replay}")
    losses = [s["loss"] for s in per_epoch]
    check(len(per_epoch) == BAKE_EPOCHS and all(np.isfinite(losses))
          and all(np.isfinite(baker.epoch_losses)), "finite bake losses")
    check(losses[-1] < losses[0], f"bake loss falls over the epochs {losses}")
    check(all(s["overflow"] == 0 for s in per_epoch), "overflow 0 in the bake")
    check(g.replays == steps and g.launches_per_replay == {"blend_instances_fwd": 1,
                                                           "blend_instances_bwd": 1}
          and fwd == bwd == WARMUP + 1, "one launch of kernels 1 and 2 per replay of the "
          "bake step, one replay per step")
    files = [os.path.join(run, "textures", f"texture_epoch{BAKE_EPOCHS}.npz"),
             os.path.join(run, "bake_snapshots", f"texture_epoch{BAKE_EPOCHS}.png"),
             os.path.join(run, "checkpoints_baked", "baked.npz")]
    check(all(os.path.exists(f) for f in files), "the bake's files")
    with np.load(files[0]) as data:
        shapes = {k: data[k].shape for k in data.files}
    png = read_png(files[1]).shape
    check(shapes == {k: (512, 512, c) for k, c in uvd.TEXTURE_CHANNELS.items()}
          and png == (512, 3 * 512, 3), "texture dump shapes")
    p_exp, s_exp = uvd.export_avatar_params(baker.model, baker.net, baker.const)
    back = load_pytree(files[2], {"params": p_exp, "state": s_exp})
    check(all(torch.equal(getattr(back["params"], f.name), getattr(p_exp, f.name))
              for f in dataclasses.fields(p_exp)), "baked.npz reads back the export")

    test_ds = cli.trainer.test_dataset
    avatar = baker.model.avatar
    cfg = avatar.cfg

    def camera_of(s):
        pose = np.asarray(s["cam_pose"], np.float32)
        return make_camera(pose[:3, :3].T, pose[:3, 3], s["fovx"], s["fovy"], cfg.img_width,
                           cfg.img_height, device="cuda")

    s0 = test_ds.sample(0)
    e0 = torch.as_tensor(s0["expression"], device="cuda")
    p0 = torch.as_tensor(s0["flame_pose"], device="cuda")
    with torch.no_grad():
        img = fateavatar_forward(avatar, back["params"], back["state"], e0, p0,
                                 camera_of(s0))["rgb_image"]
    check(bool(torch.isfinite(img).all()), "the exported avatar renders finite")
    log(f"[bake] files: {[os.path.relpath(f, run) for f in files]}; texture shapes {shapes}, "
        f"snapshot {png[1]}x{png[0]}; baked.npz read back equal to the export, rendered "
        f"through fateavatar_forward: finite, pixel std {float(img.std()):.4f}")

    # ---- one step, kernels vs plain blends, float32 VGG, deterministic
    # cuDNN without TF32: only the blends differ between the two
    frame = baker._prep(baker.dataset.sample(0))
    snap = baker.snapshot()
    loss_fn = baker.loss_fn
    baker.loss_fn = FateAvatarLoss(dataclasses.replace(loss_fn.cfg, vgg_dtype=None),
                                   vgg_params=loss_fn.vgg_params)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        gk = baker.grads(frame)[0]
        baker.restore(snap)
        with swapped_blend(bi.blend_instances_plain):
            gp = baker.grads(frame)[0]
        baker.restore(snap)
    baker.loss_fn = loss_fn
    n_net = len(gk) - 1
    flat = [torch.cat([x.reshape(-1) for x in gl[:n_net]]) for gl in (gk, gp)]
    err_net, err_const = rel_l2(flat[0], flat[1]), rel_l2(gk[-1], gp[-1])
    names = [n for n, _ in baker.net.named_parameters()]
    worst = sorted(((rel_l2(a, b), n) for n, a, b in zip(names, gk, gp)), reverse=True)[:3]
    log(f"[bake] one step, kernels vs plain blends: UNet gradient rel L2 {err_net:.1e}, const "
        f"{err_const:.1e} (bound {BAKE_GRAD_RTOL_L2}); largest per tensor "
        + ", ".join(f"{n} {e:.1e}" for e, n in worst))
    check(err_net <= BAKE_GRAD_RTOL_L2 and err_const <= BAKE_GRAD_RTOL_L2,
          "bake step gradients kernels vs plain blends")

    # ---- graph vs eager from one state: one step, then an epoch
    zero_counts()
    baker.eager = True
    aux_e = baker.step(frame)
    state_e = baker.snapshot()
    eager_launches = (bi.blend_instances.launches, bi.blend_instances_bwd.launches)
    baker.restore(snap)
    baker.eager = False
    aux_g = baker.step(frame)
    loss_e, loss_g = float(aux_e[0]), float(aux_g[0])
    rel0 = abs(loss_g - loss_e) / abs(loss_e)
    n_state = len(baker.trainables) + len(baker.stats)
    errs = [rel_l2(a, b) for a, b in zip(baker.snapshot()[:n_state], state_e[:n_state])]
    log(f"[bake] one step eager vs a replay from one state: loss {loss_e:.8f} vs {loss_g:.8f} "
        f"(rel {rel0:.1e}, bound {GRAPH_LOSS0_RTOL}); trainables and BatchNorm statistics "
        f"after it: largest rel L2 {max(errs):.1e} (bound {GRAPH_STEP_RTOL_L2}); the eager "
        f"step launches kernels 1 / 2 {eager_launches}")
    check(eager_launches == (1, 1), "one launch of kernels 1 and 2 per eager bake step")
    check(rel0 <= GRAPH_LOSS0_RTOL, f"bake step loss graph vs eager {rel0:.2e}")
    check(max(errs) <= GRAPH_STEP_RTOL_L2, "bake state after one step graph vs eager")
    def fresh_graph(name):
        return Graph(baker._step, [*baker.state_tensors(), baker._aux], name)

    # an epoch each way from the same state, twice: as the bake runs (bf16
    # VGG, cuDNN's own algorithms, atomics), printed; then gated with
    # float32 VGG, deterministic cuDNN and every other sum in a fixed order
    # (deterministic_sums), in a graph captured under those settings. The
    # random UNet, bf16 VGG and Adam amplify any reordering of a sum: on the
    # H100 two eager epochs from one state drift up to 3.6e-3 apart in the
    # bake's own settings (PERF.md), past the gate's bound, so the gated
    # pair runs where two eager epochs agree, and that agreement is gated
    # too.
    n = len(baker.dataset)
    ep = {}

    def compare(tag):
        for mode in ("eager", "eager-again", "graph"):
            baker.restore(snap)
            baker.eager = mode != "graph"
            ep[f"{tag}-{mode}"] = timed(baker.bake_epoch, n)
            ep[f"{tag}-{mode}-losses"] = np.asarray(baker.epoch_losses)
        baker.eager = False
        base = ep[f"{tag}-eager-losses"]
        return (np.abs(ep[f"{tag}-graph-losses"] - base) / np.abs(base),
                np.abs(ep[f"{tag}-eager-again-losses"] - base) / np.abs(base))

    def fmt(r):
        return [float(f"{x:.1e}") for x in r]

    rel_b, rel_be = compare("bake")
    baker.loss_fn = FateAvatarLoss(dataclasses.replace(loss_fn.cfg, vgg_dtype=None),
                                   vgg_params=loss_fn.vgg_params)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=torch.backends.cudnn.allow_tf32), \
            deterministic_sums() as flagged:
        baker.graph = fresh_graph("the bake step (float32 VGG, every sum in a fixed order)")
        rel, rel_ee = compare("det")
    baker.loss_fn, baker.graph = loss_fn, g
    log(f"[bake] epochs of {n} steps from one state, per-step loss rel diff: as the bake runs, "
        f"graph vs eager {fmt(rel_b)} (max {rel_b.max():.1e}), eager vs eager again "
        f"{fmt(rel_be)} (max {rel_be.max():.1e}); float32 VGG, deterministic cuDNN and every "
        f"sum in a fixed order, graph vs eager {fmt(rel)} (max {rel.max():.1e}, bound "
        f"{GRAPH_EPOCH_RTOL}), eager vs eager again {fmt(rel_ee)} (max {rel_ee.max():.1e}, "
        f"bound {GRAPH_EPOCH_RTOL / 10:.0e}); ops torch still flagged nondeterministic there: "
        f"{flagged or 'none'}; ms/step as the bake runs, host clock / CUDA events: eager "
        f"{ep['bake-eager'][0]:.3f} / {ep['bake-eager'][1]:.3f}, graph "
        f"{ep['bake-graph'][0]:.3f} / {ep['bake-graph'][1]:.3f} "
        f"({ep['bake-eager'][0] / ep['bake-graph'][0]:.2f}x) [{card}]")
    check(rel_ee.max() <= GRAPH_EPOCH_RTOL / 10,
          "two eager bake epochs from one state agree with every sum in a fixed order")
    check(bool(np.isfinite(ep["bake-graph-losses"]).all()) and rel.max() <= GRAPH_EPOCH_RTOL,
          "bake epoch losses graph vs eager")

    # ---- timings: steady epochs in turns, TF32 off (eager), the capture
    # cuDNN's TF32 the other way round for one eager epoch: a measurement
    # only (the port sets it off on import)
    tf32 = torch.backends.cudnn.allow_tf32
    alt = f"TF32 {'off' if tf32 else 'on'}"
    t = {}
    for i, mode in enumerate(("graph", "eager", "eager-alt", "graph")):
        baker.restore(snap)
        baker.eager = mode != "graph"
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                        allow_tf32=tf32 != (mode == "eager-alt")):
            t[i] = timed(baker.bake_epoch, len(baker.dataset))
    baker.eager = False
    baker.restore(snap)
    baker.graph = fresh_graph("the bake step")
    with torch.no_grad():
        for k, buf in baker._in.items():
            buf.copy_(frame[k])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    baker.graph()
    torch.cuda.synchronize()
    capture_ms = (time.perf_counter() - t0) * 1e3
    replay = timed(lambda: [baker.graph() for _ in range(10)], 10)
    log(f"[bake] ms/step (host clock / CUDA events, epochs of {len(baker.dataset)} steps in "
        f"turns): graph {t[0][0]:.3f} / {t[0][1]:.3f}, eager {t[1][0]:.3f} / {t[1][1]:.3f}, "
        f"eager with cuDNN {alt} {t[2][0]:.3f} / {t[2][1]:.3f}, graph {t[3][0]:.3f} / "
        f"{t[3][1]:.3f}; replays alone {replay[0]:.3f} / {replay[1]:.3f}; a new graph's "
        f"warm-up, capture and first replay {capture_ms:.1f} ms (capture cost about "
        f"{capture_ms - replay[0]:.1f} ms) [{card}]")
    torch.cuda.reset_peak_memory_stats()
    baker.restore(snap)
    baker.eager = True
    baker.step(frame)
    baker.eager = False
    torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated() / 2**30

    # ---- stage split, the replays under the profiler
    baker.restore(snap)
    stages, unet_alt = bake_stage_split(baker, frame, card)
    prof = profile_top(f"{BAKE_PROFILE} bake replays", lambda i: baker.graph(), BAKE_PROFILE,
                       "replay", card)
    check(any("blend" in k for k in prof["names"]), "the blend kernels inside the bake replays")
    baker.restore(snap)

    # ---- the baked textures' render vs the splat render (the JAX package's
    # validation protocol, scripts/validate_tpu_training.py:412-503)
    loader = Loader(avatar, cli.trainer.ts.params, cli.trainer.ts.state, run)
    _, act = baker.textures()
    psnrs, net_psnrs = [], []
    with torch.no_grad():
        for i in np.linspace(0, len(test_ds) - 1, BAKE_PSNR_FRAMES).astype(int):
            s = test_ds.sample(int(i))
            e = torch.as_tensor(s["expression"], device="cuda")
            p = torch.as_tensor(s["flame_pose"], device="cuda")
            cam = camera_of(s)
            splat = fateavatar_forward(avatar, loader.params, loader.state, e, p,
                                       cam)["rgb_image"]
            baked = uvd.render_from_texture_dict(baker.model, act, e, p, cam)["rgb_image"]
            net_img = uvd.uv_decoder_forward(baker.model, baker.net, baker.const, e, p, cam,
                                             train=False)["rgb_image"]
            for img_b, out in ((baked, psnrs), (net_img, net_psnrs)):
                out.append(float(-10 * torch.log10(torch.mean((img_b - splat) ** 2))))
    log(f"[bake] baked textures' render vs the splat render on {BAKE_PSNR_FRAMES} test "
        f"frames: PSNR {[round(x, 3) for x in psnrs]} (mean {np.mean(psnrs):.3f} dB); the "
        f"network's eval-mode render {[round(x, 3) for x in net_psnrs]} (printed, not gated: "
        f"{steps} steps are not a converged bake)")
    for name in ("blend_instances_fwd", "blend_instances_bwd"):
        rows[name]["bake_launches"] = {
            "cli_run_wrapper": fwd if name.endswith("fwd") else bwd, "replays": steps,
            "per_eager_step": eager_launches[0 if name.endswith("fwd") else 1]}
        rows[name].setdefault("graph_launches_per_replay", {})["bake-step"] = \
            g.launches_per_replay.get(name, 0)
    log(f"[bake] peak device memory: build_uv_decoder {b[3]:.3f} GiB, an eager step "
        f"{step_peak:.3f} GiB (the UNet's 512^2 activations), the CLI's epochs "
        f"{max(e[3] for e in epochs):.3f} GiB; phase total {time.perf_counter() - t_phase:.1f} s "
        f"[{card}]")
    return {"baker": baker, "graph_ms": t[3], "eager_ms": t[1], "eager_tf32_toggled_ms": t[2],
            "replay_ms": replay, "capture_ms": capture_ms, "stages": stages,
            "unet_tf32_toggled_ms": unet_alt, "profile": {k: v for k, v in prof.items()
                                                   if k != "names"},
            "psnr": psnrs, "net_psnr": net_psnrs, "knn_peak_gib": b[3],
            "step_peak_gib": step_peak, "epoch_loss": losses}


def edit_phase(cli, card):
    """[edit]: cli/avatar_edit_baked on the baked workspace with a sticker
    and a disc mask written by the port's PNG writer (--max_frames 8): the
    video, the edited colour texture changed inside the sticker's square
    only, a test frame's edited render against the unedited one, one
    forward launch per frame, ms/frame."""
    import glob

    import numpy as np
    import torch

    from fateavatar_tpu_torch.cli import avatar_edit_baked
    from fateavatar_tpu_torch.ops.camera import make_camera
    from fateavatar_tpu_torch.render import blend_instances as bi
    from fateavatar_tpu_torch.train.baker import UVEditor
    from fateavatar_tpu_torch.utils.png import write_png

    t_phase = time.perf_counter()
    run = cli.run
    yy, xx = np.mgrid[:STICKER, :STICKER]
    checker = ((yy // 32 + xx // 32) % 2).astype(bool)
    sticker = np.where(checker[..., None], [255, 0, 255], [0, 255, 0]).astype(np.uint8)
    r = STICKER / 2
    disc = (yy - r + 0.5) ** 2 + (xx - r + 0.5) ** 2 <= r * r
    paths = [os.path.join(os.path.dirname(run), n) for n in ("sticker.png", "mask.png")]
    write_png(paths[0], sticker)
    write_png(paths[1], np.repeat((disc * 255).astype(np.uint8)[..., None], 3, axis=-1))
    args = [*cli.config, "--device", "cuda", "--workspace", run, "--sticker", paths[0],
            "--sticker_mask", paths[1], "--sticker_pos", *map(str, STICKER_POS),
            "--max_frames", str(EDIT_FRAMES), f"dataset.root_path={cli.root}", *cli.assets]
    anim = []
    zero_counts()
    t0 = time.perf_counter()
    with recorded(UVEditor, "run_animation", anim):
        editor = avatar_edit_baked.main(args)
    run_s = time.perf_counter() - t0
    fwd, _, anim_s, anim_peak, frames = anim[0]
    n = len(frames)
    media = os.path.join(run, "media")
    video = [f for f in ("edit_sticker.mp4", "edit_sticker.gif")
             if os.path.exists(os.path.join(media, f))]
    check(len(video) == 1 and n == min(EDIT_FRAMES, len(cli.trainer.test_dataset))
          and all(np.isfinite(f).all() for f in frames), "the edit's frames and video")
    check(fwd == n and bi.blend_instances_bwd.launches == 0,
          "one forward launch per edited frame, no backward")

    with np.load(sorted(glob.glob(os.path.join(run, "textures", "texture_epoch*.npz")))[-1]) as d:
        raw = {k: torch.from_numpy(d[k]).cuda() for k in d.files}
    plain = UVEditor(editor.model, raw, render_cfg=editor.render_cfg)
    changed = (editor.act_textures["color"] - plain.act_textures["color"]).abs().sum(-1) > 0
    ys, xs = torch.nonzero(changed, as_tuple=True)
    (y0, x0), side = STICKER_POS, STICKER
    check(ys.numel() > 0 and int(ys.min()) >= y0 and int(ys.max()) < y0 + side
          and int(xs.min()) >= x0 and int(xs.max()) < x0 + side,
          "the sticker changes the colour texture inside its square only")
    s = cli.trainer.test_dataset.sample(0)
    cfg = editor.model.avatar.cfg
    pose = np.asarray(s["cam_pose"], np.float32)
    cam = make_camera(pose[:3, :3].T, pose[:3, 3], s["fovx"], s["fovy"], cfg.img_width,
                      cfg.img_height, device="cuda")
    img_e = editor.render(s["expression"], s["flame_pose"], cam)
    img_p = plain.render(s["expression"], s["flame_pose"], cam)
    diff = (img_e - img_p).abs().amax(-1)
    log(f"[edit] avatar_edit_baked {args[2:]}: {run_s:.1f} s; {n} frames, {fwd} forward "
        f"launches; wrote media/{video[0]}; texels changed {int(changed.sum())} inside the "
        f"{side}x{side} square at {STICKER_POS}; test frame 0 edited vs unedited: max "
        f"|diff| {float(diff.max()):.4f}, {int((diff > 1e-3).sum())} pixels changed")
    check(float(diff.max()) > 1e-3, "the edited render differs from the unedited one")
    log(f"[edit] {anim_s * 1e3 / n:.3f} ms/frame (run_animation: eager render, host copy, "
        f"{n} frames, the video write included), peak device memory {anim_peak:.3f} GiB; "
        f"phase total {time.perf_counter() - t_phase:.1f} s [{card}]")
    return {"ms_per_frame": anim_s * 1e3 / n, "frames": n, "pixels_changed":
            int((diff > 1e-3).sum())}


# the [tools] phase: a dozen viewer states covering every UI mode (sliders,
# neck, orbit, zoom, fov, the three backgrounds, the canonical view, raw and
# tracked playback)
VIEWER_UI = (
    {},
    {"exp": [0.8, -0.5, 0.3, 0.2], "jaw": 0.2},
    {"neck": [0.15, -0.2, 0.05]},
    {"yaw": 0.6, "pitch": -0.3},
    {"zoom": 0.8},
    {"fov": 0.5},
    {"bg": "black", "yaw": -0.4},
    {"bg": "gray"},
    {"canonical": True, "yaw": 0.3},
    {"playing": True, "frame": 2},
    {"playing": True, "frame": 5, "tracked": True},
    {"playing": True, "frame": 7, "tracked": True, "yaw": 0.2, "zoom": 1.1},
)


# kernel 1 against the plain blend on the viewer's heaviest states (the
# closest camera, the widest orbit); host timings of a round trip's parts
VIEWER_PLAIN = ({"zoom": 0.8}, {"yaw": 0.6, "pitch": -0.3})
VIEWER_TIMED = 10


def viewer_host_split(srv, ui):
    """Median ms (host clock, VIEWER_TIMED calls each) of a round trip of
    ``ui`` to the running viewer ``srv`` and of its host parts one by one:
    the render callback (inputs copied in, the replay, its sync, the frame's
    copy to the host), the device-to-host copy of the frame alone, and
    quantize + PNG encode."""
    import numpy as np
    import torch

    from fateavatar_tpu_torch.utils.png import encode_png
    from fateavatar_tpu_torch.viewer.web import quantize

    fn = srv.render_fn
    img = fn(ui)[0]
    dev_img = torch.as_tensor(img, device="cuda")

    def median_ms(f):
        ts = []
        for _ in range(VIEWER_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    return {"round_trip": median_ms(lambda: post_json(srv.port, ui)),
            "callback": median_ms(lambda: fn(ui)),
            "copy": median_ms(lambda: dev_img.cpu().numpy().copy()),
            "encode": median_ms(lambda: encode_png(quantize(img)))}


def post_json(port, state):
    """POST ``state`` to the viewer's /render: (headers, body, round-trip ms
    on the host clock)."""
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/render",
                                 data=json.dumps(state).encode(), method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as r:
        body = r.read()
        headers = r.headers
    return headers, body, (time.perf_counter() - t0) * 1e3


def tools_phase(cli, rows, card):
    """[tools]: the [cli] avatar's splats of test frame 0 through
    ``save_ply`` / ``load_ply`` (alive splats back bit for bit); then
    ``cli/avatar_gui.build_viewer`` on the [cli] workspace twice: the
    [bake] phase's ``checkpoints_baked/baked.npz`` (``--variant baked``) and
    the latest training checkpoint with its tracking tables (``--variant
    latest``), each served in the background on port 0 and sent the
    VIEWER_UI states as HTTP POSTs: every served frame drops no instance
    (overflow 0), every decoded PNG equals the eager forward of the same
    state quantized to uint8, the graph's frame equals the eager frame bit
    for bit, and VIEWER_PLAIN's states render within TOL of the plain
    blend; launches (the graph's warm-up and capture, then one kernel-1
    launch per replay), ms per round trip and per replay, and a round
    trip's host parts timed one by one (the callback, the frame's copy to
    the host, quantize + PNG encode)."""
    import numpy as np
    import torch

    from fateavatar_tpu_torch.cli import avatar_gui, common
    from fateavatar_tpu_torch.models.fateavatar import build_gaussians
    from fateavatar_tpu_torch.render import blend_instances as bi
    from fateavatar_tpu_torch.render.ply import load_ply, save_ply
    from fateavatar_tpu_torch.utils.graphs import WARMUP
    from fateavatar_tpu_torch.utils.png import read_png
    from fateavatar_tpu_torch.viewer.web import quantize

    t_phase = time.perf_counter()
    ws = os.path.dirname(os.path.dirname(cli.run))
    tr = cli.trainer
    s0 = tr.test_dataset.sample(0)
    with torch.no_grad():
        g = build_gaussians(tr.model, tr.ts.params, tr.ts.state,
                            torch.as_tensor(s0["expression"], device="cuda"),
                            torch.as_tensor(s0["flame_pose"], device="cuda"))[0]
    path = os.path.join(ws, "avatar.ply")
    t0 = time.perf_counter()
    n = save_ply(path, g)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = load_ply(path, capacity=g.xyz.shape[0], device="cuda")
    t_load = time.perf_counter() - t0
    alive = g.alive
    same = [torch.equal(getattr(back, k)[:n], getattr(g, k)[alive])
            for k in ("xyz", "scaling", "rotation", "opacity", "features_dc")]
    rest_ok = (torch.equal(back.features_rest[:n], g.features_rest[alive])
               if g.features_rest.shape[1] else not bool(back.features_rest.any()))
    check(n == int(alive.sum()) and bool(back.alive[:n].all()) and not bool(back.alive[n:].any())
          and all(same) and rest_ok and back.sh_degree == g.sh_degree,
          "the PLY round trip gives the alive splats back bit for bit")
    log(f"[tools] PLY of the [cli] avatar posed at test frame 0: {n} alive splats of "
        f"{g.xyz.shape[0]}, {os.path.getsize(path) / 2**20:.2f} MiB, save {t_save * 1e3:.1f} ms, "
        f"load (padded to the capacity, on the card) {t_load * 1e3:.1f} ms; fields back bit "
        f"for bit")

    identity = common.load_identity_info(cli.run)
    dist = abs(float(identity["world_mat0"][2][3]))
    base = [*cli.config, "--device", "cuda", "--workspace", cli.run, "--port", "0",
            "--camera_distance", f"{dist}", f"dataset.root_path={cli.root}", *cli.assets]
    check(os.path.exists(os.path.join(cli.run, "checkpoints_baked", "baked.npz")),
          "the [bake] workspace holds baked.npz")
    summary = {}
    for variant in ("baked", "latest"):
        # ---- the viewer path: counts to 0 just before, read just after
        zero_counts()
        t0 = time.perf_counter()
        srv = avatar_gui.build_viewer(["--variant", variant, *base])
        build_s = time.perf_counter() - t0
        srv.serve_background()
        fn = srv.render_fn
        served, overflow = [], []
        try:
            for ui in VIEWER_UI:
                headers, body, rt = post_json(srv.port, ui)
                overflow.append(fn.overflow)
                served.append((ui, headers["Content-Type"], float(headers["X-Device-Ms"]),
                               body, rt))
            fwd, bwd = bi.blend_instances.launches, bi.blend_instances_bwd.launches
            graph = fn.graph
            replays = graph.replays
            split = viewer_host_split(srv, VIEWER_UI[0])
        finally:
            srv.shutdown()
        check(not any(overflow), f"[tools] {variant}: no served frame drops an instance "
              f"(overflow {overflow})")
        check(srv.variant == variant, f"build_viewer loaded the {variant} avatar")
        # a frame that overflows grows the caps: a capture more, a replay more
        regrows, overflow_grown = len(fn.growths), list(fn.growths)
        check(fwd == (WARMUP + 1) * (1 + regrows) and bwd == 0
              and replays == len(VIEWER_UI) + 1 + regrows
              and graph.launches_per_replay == {"blend_instances_fwd": 1},
              "the viewer: the graph's warm-up and capture (again at each growth of the "
              "caps), then one kernel-1 launch a replay")
        # the served frames against eager forwards of the same states
        png = os.path.join(ws, f"viewer_{variant}.png")
        stds = []
        for ui, ctype, _, body, _ in served:
            with open(png, "wb") as fh:
                fh.write(body)
            decoded = read_png(png)
            eager = fn.eager(ui)
            frame = fn(ui)[0]
            check(ctype == "image/png" and decoded.shape == eager.shape
                  and np.array_equal(decoded, quantize(eager)),
                  f"[tools] {variant} {ui}: the PNG is the eager frame quantized")
            check(np.array_equal(frame, eager), f"[tools] {variant} {ui}: graph frame == eager")
            stds.append(float(decoded.std()))
        distinct = len({body for _, _, _, body, _ in served})
        check(distinct == len(VIEWER_UI), f"[tools] {variant}: every UI state gives its own "
              f"frame ({distinct} distinct of {len(VIEWER_UI)})")
        if variant == "latest":
            raw = fn.eager({"playing": True, "frame": 5})
            check(not np.array_equal(raw, fn.eager(VIEWER_UI[10])),
                  "tracked playback reads the tracking tables")
        # kernel 1 against the plain blend on the heaviest states
        plain_err = []
        for ui in VIEWER_PLAIN:
            img_k = fn.eager(ui)
            with swapped_blend(bi.blend_instances_plain):
                img_p = fn.eager(ui)
            check(fn.overflow == 0, f"[tools] {variant} {ui}: the plain frame's overflow 0")
            plain_err.append(float(np.abs(img_k - img_p).max()))
        check(max(plain_err) <= TOL, f"[tools] {variant}: kernel 1 vs the plain blend "
              f"{plain_err} > {TOL}")
        rows["blend_instances_fwd"]["max_abs_err"] = max(
            rows["blend_instances_fwd"]["max_abs_err"], *plain_err)
        dev_ms = [d for _, _, d, _, _ in served]
        rts = [r for *_, r in served]
        log(f"[tools] viewer --variant {variant}: built (load, warm-up, capture) in "
            f"{build_s:.2f} s; {len(served)} POSTs over HTTP, every PNG the eager frame "
            f"quantized and every graph frame bit-equal to the eager one; ms per round trip "
            f"(host clock, PNG encoded and decoded by urllib) median "
            f"{float(np.median(rts)):.2f} min {min(rts):.2f} max {max(rts):.2f}; per replay "
            f"(X-Device-Ms, CUDA events) median {float(np.median(dev_ms)):.3f} min "
            f"{min(dev_ms):.3f} max {max(dev_ms):.3f}; PNG {len(served[0][3]) / 1024:.0f} KiB, "
            f"pixel std {min(stds):.1f}-{max(stds):.1f}; "
            f"kernel 1 launches {fwd} by the wrapper ({WARMUP} warm-up calls + the capture, "
            f"x {1 + regrows}), then {replays} replays x {graph.launches_per_replay}; the caps "
            f"grew {regrows} times (overflow of the frames before growth {overflow_grown}) "
            f"to instance_budget {fn.render_cfg.instance_budget}, R "
            f"{fn.render_cfg.max_tiles_per_gaussian}, tail_k {fn.render_cfg.tail_k}; overflow "
            f"0 on every served frame; kernel 1 vs the plain blend on {VIEWER_PLAIN}: max|diff| "
            f"{max(plain_err):.3e} (bound {TOL}) [{card}]")
        rest = split["round_trip"] - split["callback"] - split["encode"]
        log(f"[tools] viewer --variant {variant}, one round trip of {VIEWER_UI[0]} by parts "
            f"(host clock, median of {VIEWER_TIMED} each): round trip "
            f"{split['round_trip']:.2f} ms = render callback {split['callback']:.2f} (inputs "
            f"in, the replay, its sync, the frame to the host; a {img_k.shape[1]}x"
            f"{img_k.shape[0]}x3 float32 device-to-host copy alone {split['copy']:.2f}) + "
            f"quantize and PNG encode {split['encode']:.2f} + the rest (the HTTP server and "
            f"urllib, JSON, the threads) {rest:.2f}; shares "
            f"{split['callback'] / split['round_trip']:.1%} / "
            f"{split['encode'] / split['round_trip']:.1%} / {rest / split['round_trip']:.1%} "
            f"[{card}]")
        summary[variant] = {"launches": fwd, "replays": replays, "regrows": regrows,
                            "round_trip_ms": float(np.median(rts)),
                            "replay_ms": float(np.median(dev_ms)), "build_s": build_s,
                            "plain_err": max(plain_err),
                            "split_ms": split | {"rest": rest}}
        del srv, fn, graph
    rows["blend_instances_fwd"]["viewer_launches"] = {
        v: {"wrapper": d["launches"], "replays": d["replays"]} for v, d in summary.items()}
    rows["blend_instances_fwd"].setdefault("graph_launches_per_replay", {})["viewer-frame"] = 1
    log(f"[tools] summary {json.dumps(summary)}; phase total "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return summary


# the [pseudo] / [complete] phases: cli/train_generate_pseudo with a seeded
# random G_ema at the default EG3DConfig (PTI_STEPS W and G steps each: the
# phase's time, printed), then cli/train_full_avatar --finetune_epochs 1 and
# a full-head bake epoch with the pseudo set
PSEUDO_VIEWS = 30
PTI_STEPS = 10
PTI_TIMED = 3             # steps per TF32 setting of the PTI step timings
# the face layout's pixels -> world units on the 0.1-radius synthetic head
FACE_SCALE = 0.1 / 256 * 2.0
# the EG3D generator at the tiny config, the card against the CPU: outputs
# within 1e-4 of the largest magnitude, the W step's gradient within 1e-3
# rel L2 (float32 both sides, TF32 off; cuDNN's algorithms and the
# reductions' order differ)
EG3D_DEVICE_RTOL = 1e-4
EG3D_GRAD_RTOL_L2 = 1e-3
COMPLETE_TIMED = 4        # real and pseudo steps of the step timings
# the plug-ins (GFPGAN, MODNet, BiSeNet): card vs CPU within 1e-4 of the
# output's largest magnitude (float32 both sides, TF32 off)
PLUGIN_RTOL = 1e-4
PLUGIN_TIMED = 10         # forwards per plug-in timing
PLUGIN_VIEWS = 6          # the BiSeNet CLI run's orbit views (mirror provider)
STAGE8_TIMED = 3          # stage-⑧ views timed by parts


def eg3d_device_check(card):
    """The port's EG3D synthesis (tri-plane sampling by grid_sample, the
    grouped modulated convs, the stable merge sort) and one W step's
    gradient at the tiny config, on the card against the CPU."""
    import numpy as np
    import torch

    from fateavatar_tpu_torch.completion.eg3d import convert as eg3d_convert
    from fateavatar_tpu_torch.completion.eg3d import networks as eg3d
    from fateavatar_tpu_torch.completion.eg3d import pti

    cfg = eg3d.tiny_test_config()
    rng = np.random.default_rng(0)
    raw = {k: (rng.standard_normal(shape) / (0.01 if init == "mapping" else 1.0)).astype(
        np.float32) for k, (shape, init) in eg3d.param_spec(cfg).items()}
    ws = (rng.standard_normal((1, cfg.num_ws, cfg.w_dim)) * 0.5).astype(np.float32)
    c = np.stack([np.asarray(eg3d.eg3d_camera_label(np.linalg.inv(np.array(
        [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 2.7], [0, 0, 0, 1.0]]))), np.float32)] * 2)
    c[1, 3] += 0.3
    targets = (rng.random((2, cfg.sr_resolution, cfg.sr_resolution, 3)) * 2 - 1).astype(
        np.float32)
    res = {}
    for dev in ("cpu", "cuda"):
        p = eg3d_convert.generator_from_dict(raw, cfg, device=dev).params()

        def tt(x, d=dev):
            return torch.as_tensor(x, device=d)

        with torch.no_grad():
            out = eg3d.synthesis(p, cfg, tt(ws), tt(c), return_raw=True)
        w = tt(ws[:, 0]).requires_grad_()
        loss, _ = pti._inversion_loss(p, cfg, pti.PTIConfig(), w[:, None].expand(
            -1, cfg.num_ws, -1), tt(targets), tt(c), tt(ws[0, 0]), None)
        (g,) = torch.autograd.grad(loss, [w])
        res[dev] = ({k: v.cpu() for k, v in out.items()}, g.cpu())
    errs = {k: float((res["cuda"][0][k] - v).abs().max() / v.abs().max())
            for k, v in res["cpu"][0].items()}
    g_err = rel_l2(res["cuda"][1], res["cpu"][1])
    log(f"[pseudo] EG3D at the tiny config, card vs CPU: synthesis max err / max "
        + ", ".join(f"{k} {e:.1e}" for k, e in errs.items())
        + f" (bound {EG3D_DEVICE_RTOL}); one W step's gradient rel L2 {g_err:.1e} "
        f"(bound {EG3D_GRAD_RTOL_L2})")
    check(all(e <= EG3D_DEVICE_RTOL for e in errs.values()), "EG3D synthesis card vs CPU")
    check(g_err <= EG3D_GRAD_RTOL_L2, "the W step's gradient card vs CPU")
    return {"synthesis_err": errs, "w_grad_rel_l2": g_err}


def pti_step_ms(provider, steps):
    """ms per W step and per G step on the provider's last targets (host
    clock, synchronized, ``steps`` each), with the port's settings (TF32
    off) and with cuDNN and matmul TF32 on, in that order; peak memory of
    each stage. The settings are restored after."""
    import torch

    from fateavatar_tpu_torch.completion.eg3d import pti

    cfg = dataclasses.replace(provider.pti_cfg, w_steps=steps, pti_steps=steps)
    out = {}
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
            for stage in ("w", "g"):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                if stage == "w":
                    pti.project_w(provider.params, provider.cfg, cfg, provider.targets,
                                  provider.target_labels,
                                  torch.Generator(device="cuda").manual_seed(0),
                                  provider.vgg_params)
                else:
                    pti.pti_finetune(provider.params, provider.cfg, cfg, provider.ws,
                                     provider.targets, provider.target_labels,
                                     provider.vgg_params)
                torch.cuda.synchronize()
                out[(stage, tf32)] = ((time.perf_counter() - t0) * 1e3 / steps,
                                      torch.cuda.max_memory_allocated() / 2**30)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    return out


def pseudo_phase(cli, rows, card):
    """[pseudo]: cli/train_generate_pseudo on the [cli] workspace with a
    landmark embedding in a face layout on the head's front, a seeded
    random G_ema at the default EG3DConfig written as an upstream network
    pickle (and as a .pth: the two load to generators that render the same
    bits), and seeded random GFPGAN (GFPGANConfig(), 512^2) and MODNet
    checkpoints: 30 orbit renders through kernel 1, 30 keypoint sets, the
    FFHQ alignment (front views aligned, the back rejected), GFPGAN on the
    aligned crops (stage ④), PTI (PTI_STEPS W and G steps on up to 8
    frontal targets at 512^2), the orbit re-render, paste-back, MODNet's
    mattes as the masks (stage ⑧), heatmaps; the card's EG3D against the
    CPU's at the tiny config; ms per W / G step (TF32 off and on), per
    orbit view, per restored crop and per matte, one stage-⑧ view by parts
    (the matte under the profiler, the mask PNG), peak memory. Returns the
    pseudo folder, the plug-ins' checkpoints and the numbers."""
    import pickle as pkl

    import numpy as np
    import torch

    from fateavatar_tpu_torch.cli import train_generate_pseudo
    from fateavatar_tpu_torch.completion import matting, restoration
    from fateavatar_tpu_torch.completion import pseudo as pseudo_mod
    from fateavatar_tpu_torch.completion.eg3d import networks as eg3d
    from fateavatar_tpu_torch.completion.eg3d import provider as provider_mod
    from fateavatar_tpu_torch.completion.eg3d.convert import load_eg3d_from_torch
    from fateavatar_tpu_torch.completion.eg3d.pkl_ingest import load_eg3d_from_pkl
    from fateavatar_tpu_torch.render import blend_instances as bi
    from fateavatar_tpu_torch.utils.logging import save_image

    _tests_on_path()
    from torch_layouts import (
        face_landmark_embedding, write_landmark_embedding, write_network_pkl,
    )

    t_phase = time.perf_counter()
    h, w = cli.trainer.model.cfg.img_height, cli.trainer.model.cfg.img_width
    ws = os.path.dirname(os.path.dirname(cli.run))
    with open(os.path.join(ws, "generic_model.pkl"), "rb") as fh:
        data = pkl.load(fh)
    lmk = os.path.join(ws, "landmark_embedding.npy")
    write_landmark_embedding(lmk, face_landmark_embedding(data["v_template"], data["f"],
                                                          FACE_SCALE))
    cfg = eg3d.EG3DConfig()
    t0 = time.perf_counter()
    weights = os.path.join(ws, "g_ema_random.pth")
    weights_pkl = os.path.join(ws, "network-snapshot-random.pkl")
    gen = eg3d.EG3DGenerator(cfg, eg3d.eg3d_random_params(
        torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda"), device="cuda")
    sd = {k: v.cpu() for k, v in gen.state_dict().items()}
    torch.save(sd, weights)
    n_params = sum(v.numel() for v in sd.values())
    del gen
    t_pth = time.perf_counter() - t0
    t0 = time.perf_counter()
    write_network_pkl(weights_pkl, {"G_ema": (
        {k: v.numpy() for k, v in sd.items()},
        {"rendering_kwargs": {"ray_start": cfg.ray_start, "ray_end": cfg.ray_end,
                              "depth_resolution": cfg.depth_resolution},
         "neural_rendering_resolution": cfg.neural_resolution})})
    t_pkl = time.perf_counter() - t0
    log(f"[pseudo] a seeded random G_ema at the default EG3DConfig ({n_params} values: "
        f"backbone {cfg.backbone_resolution} x {cfg.plane_channels} tri-plane channels, "
        f"neural {cfg.neural_resolution} with {cfg.depth_resolution} + "
        f"{cfg.depth_resolution_importance} samples, SR to {cfg.sr_resolution}) written as a "
        f".pth in {t_pth:.1f} s and as an upstream persistence-format network pickle "
        f"({os.path.getsize(weights_pkl) / 2**20:.1f} MiB, G_ema only) in {t_pkl:.1f} s; "
        f"landmark embedding: a face layout on the template's front (scale "
        f"{FACE_SCALE:.3e} m/px)")
    # the pickle's generator against the .pth's: the same tensors, the same
    # rendered bits (deterministic cuDNN)
    t0 = time.perf_counter()
    g_pkl, cfg_pkl, attrs = load_eg3d_from_pkl(weights_pkl, device="cuda")
    t_read = time.perf_counter() - t0
    t0 = time.perf_counter()
    g_pth, _ = load_eg3d_from_torch(weights, device="cuda")
    check(cfg_pkl == cfg, f"the pickle's inferred config is the default EG3DConfig: {cfg_pkl}")
    check(attrs["neural_rendering_resolution"] == cfg.neural_resolution
          and attrs["rendering_kwargs"]["ray_start"] == cfg.ray_start, "the pickle's attrs")
    zg = torch.Generator(device="cuda").manual_seed(3)
    z = torch.randn((1, cfg.z_dim), generator=zg, device="cuda")
    c = torch.as_tensor(eg3d.eg3d_camera_label(np.linalg.inv(np.array(
        [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 2.7], [0, 0, 0, 1.0]])))[None],
        dtype=torch.float32, device="cuda")
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                                     deterministic=True, allow_tf32=False):
        imgs = [eg3d.render_full(g.params(), cfg, z, c)["image"] for g in (g_pkl, g_pth)]
    check(all(torch.equal(a, b) for a, b in zip(g_pkl.state_dict().values(),
                                                  g_pth.state_dict().values()))
          and torch.equal(imgs[0], imgs[1]) and bool(torch.isfinite(imgs[0]).all()),
          "the generator from the .pkl renders bit-equal to the .pth one")
    t_cmp = time.perf_counter() - t0
    log(f"[pseudo] {os.path.basename(weights_pkl)} read by the restricted unpickler in "
        f"{t_read:.1f} s (no embedded code run): config inferred {cfg_pkl == cfg and 'equal'} "
        f"to EG3DConfig(), attrs {sorted(attrs)}; its G_ema renders a {imgs[0].shape[1]}^2 "
        f"image bit-equal to the .pth generator's (max |value| "
        f"{float(imgs[0].abs().max()):.3f}); the .pth's load and the two renders "
        f"{t_cmp:.1f} s")
    del g_pkl, g_pth, imgs

    # the plug-ins' checkpoints at full width, seeded, in the public layouts
    t0 = time.perf_counter()
    pg_gen = torch.Generator(device="cuda").manual_seed(1)
    gf_cfg = restoration.GFPGANConfig()
    plugins = {"gfpgan": os.path.join(ws, "GFPGANv1.4_random.pth"),
               "modnet": os.path.join(ws, "modnet_random.ckpt")}
    gf = restoration.gfpgan_random_params(pg_gen, gf_cfg, device="cuda")
    torch.save({"params_ema": {k: v.cpu() for k, v in gf.items()}}, plugins["gfpgan"])
    md = matting.modnet_random_params(pg_gen, device="cuda")
    torch.save({f"module.{k}": v.cpu() for k, v in md.items()}, plugins["modnet"])
    log(f"[pseudo] seeded random GFPGANv1Clean at GFPGANConfig() ({gf_cfg.out_size}^2, "
        f"{sum(v.numel() for v in gf.values())} values, as {{'params_ema': ...}}) and MODNet "
        f"({sum(v.numel() for v in md.values())} values, DataParallel 'module.' names) "
        f"written in {time.perf_counter() - t0:.1f} s")
    del gf, md
    dev_check = eg3d_device_check(card)

    args = [*cli.config, "--device", "cuda", "--workspace", cli.run, "--num_views",
            str(PSEUDO_VIEWS), "--eg3d_weights", weights_pkl,
            "--gfpgan_weights", plugins["gfpgan"], "--modnet_weights", plugins["modnet"],
            "--pti_w_steps", str(PTI_STEPS),
            "--pti_g_steps", str(PTI_STEPS), f"dataset.root_path={cli.root}", *cli.assets,
            f"assets.landmark_embedding_path={lmk}"]
    log(f"[pseudo] train_generate_pseudo {args[2:]}: N = {PTI_STEPS} W and G steps (the "
        f"reference's 200 + 200 cut to the phase's time)")
    stages = {}
    zero_counts()
    t0 = time.perf_counter()
    with recorded(pseudo_mod.PseudoGenerator, "render_novel_view", stages.setdefault("①", [])), \
            recorded(pseudo_mod.PseudoGenerator, "execute_affine_transform",
                     stages.setdefault("③", [])), \
            recorded(provider_mod, "project_w", stages.setdefault("⑤W", [])), \
            recorded(provider_mod, "pti_finetune", stages.setdefault("⑤G", [])), \
            recorded(provider_mod.EG3DPseudoProvider, "render_orbit", stages.setdefault("⑥", [])), \
            recorded(pseudo_mod.PseudoGenerator, "execute_inverse_transform",
                     stages.setdefault("⑦", [])), \
            recorded(restoration.GFPGANRestorer, "__call__", stages.setdefault("④", [])), \
            recorded(pseudo_mod.PseudoGenerator, "retrieve_masks", stages.setdefault("⑧", [])):
        pg = train_generate_pseudo.main(args)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    fwd, bwd = bi.blend_instances.launches, bi.blend_instances_bwd.launches
    out, prov = pg.result, pg.provider
    st = {k: v[0] for k, v in stages.items()}
    aligned = out["aligned"]
    n_al = len(aligned["index"]) if aligned else 0
    log(f"[pseudo] CLI run {run_s:.1f} s; stage seconds " + ", ".join(
        f"{k} {v[2]:.2f}" for k, v in st.items()) + f"; kernel 1 launches {fwd} (stage ① "
        f"{st['①'][0]}), kernel 2 {bwd}; aligned views {n_al} of {PSEUDO_VIEWS}: "
        f"{aligned['index'] if aligned else []}")
    check(out["renders"].shape == (PSEUDO_VIEWS, h, w, 3)
          and np.isfinite(out["renders"]).all(), "30 finite orbit renders")
    check(st["①"][0] == PSEUDO_VIEWS and fwd == PSEUDO_VIEWS and bwd == 0,
          "one kernel-1 launch per orbit render, none elsewhere")
    check(out["keypoints"] is not None and out["keypoints"].shape == (PSEUDO_VIEWS, 68, 3),
          "30 keypoint sets")
    check(0 < n_al < PSEUDO_VIEWS, "some views aligned, the back ones rejected")
    check(np.isfinite(aligned["label"]).all() and aligned["label"].shape == (n_al, 25),
          "finite EG3D labels")
    # stage ④: GFPGAN restored the aligned crops that fed the provider
    check(isinstance(pg.restorer_fn, restoration.GFPGANRestorer) and len(stages["④"]) == 1,
          "stage ④ ran GFPGAN once, on the aligned crops")
    restored = st["④"][4]
    crop_change = float(np.abs(restored - aligned["crop"]).max())
    check(restored.shape == aligned["crop"].shape and np.isfinite(restored).all()
          and crop_change > 0.05, f"stage ④ changed the crops (max |change| {crop_change:.3f})")
    # stage ⑧: the masks are MODNet's mattes of the pasted views, not the
    # background-distance fallback
    check(isinstance(pg.matting_fn, matting.MODNetMatting), "stage ⑧'s matting is MODNet")
    bg = pg.model.bg_color.cpu().numpy()
    fallback = np.stack([(np.abs(img - bg).sum(-1) > 0.08).astype(np.float32)
                         for img in out["pasted"]])
    again = np.stack([pg.matting_fn(out["pasted"][i]) for i in (0, PSEUDO_VIEWS - 1)])
    check(np.array_equal(again, out["masks"][[0, PSEUDO_VIEWS - 1]])
          and not np.array_equal(out["masks"], fallback)
          and len(np.unique(out["masks"])) > 2,
          "stage ⑧'s masks are MODNet's (soft) mattes of the pasted views")
    log(f"[pseudo] stage ④ (GFPGAN on {restored.shape[0]} aligned {restored.shape[1]}^2 crops) "
        f"{st['④'][2]:.2f} s, {st['④'][2] * 1e3 / restored.shape[0]:.1f} ms a crop (host "
        f"clock, the host copies included), peak {st['④'][3]:.2f} GiB, max |change| "
        f"{crop_change:.3f}; stage ⑧ (MODNet on {PSEUDO_VIEWS} pasted {out['pasted'].shape[1]}"
        f"^2 views, the mask PNGs written) {st['⑧'][2]:.2f} s, "
        f"{st['⑧'][2] * 1e3 / PSEUDO_VIEWS:.1f} ms a view; mattes in "
        f"[{float(out['masks'].min()):.3f}, {float(out['masks'].max()):.3f}] (the fallback's "
        f"share of pixels that differ from them at 0.5: "
        f"{float(((out['masks'] > 0.5) != (fallback > 0.5)).mean()):.3f}) [{card}]")
    # one stage-⑧ view by parts: the matte (the image to the card, MODNet,
    # the matte back) under the profiler, wall and the card's busy time,
    # and the mask PNG's write on the host clock; medians of STAGE8_TIMED
    mattes = sorted(busy_union_ms(lambda: pg.matting_fn(out["pasted"][0]))
                    for _ in range(STAGE8_TIMED))
    matte_wall, matte_busy = mattes[STAGE8_TIMED // 2]
    png_ms = []
    for _ in range(STAGE8_TIMED):
        t0 = time.perf_counter()
        save_image(os.path.join(ws, "mask_timing.png"),
                   np.repeat(out["masks"][0][..., None], 3, axis=-1))
        png_ms.append((time.perf_counter() - t0) * 1e3)
    png_ms = float(np.median(png_ms))
    view_ms = st["⑧"][2] * 1e3 / PSEUDO_VIEWS
    log(f"[pseudo] one stage-⑧ view by parts (median of {STAGE8_TIMED}): the matte "
        f"{matte_wall:.1f} ms wall under the profiler, the card busy {matte_busy:.1f} ms of "
        f"it ({matte_busy / matte_wall:.1%}); the mask PNG written {png_ms:.1f} ms; their sum "
        f"{matte_wall + png_ms:.1f} ms of the stage's {view_ms:.1f} ms a view [{card}]")
    lw = [float(x) for x in prov.losses["w"]]
    lg = [float(x) for x in prov.losses["g"]]
    log(f"[pseudo] PTI on {prov.targets.shape[0]} targets of {prov.cfg.sr_resolution}^2: "
        f"W losses {[round(x, 4) for x in lw]}, G losses {[round(x, 4) for x in lg]}")
    check(len(lw) == len(lg) == PTI_STEPS and np.isfinite(lw + lg).all(), "finite PTI losses")
    check(lw[-1] < lw[0] and lg[-1] < lg[0], "the W and G losses fall")
    pdir = os.path.join(cli.run, "pseudo")
    with open(os.path.join(pdir, "trajectory.json")) as fh:
        traj = json.load(fh)
    counts = {sub: len(os.listdir(os.path.join(pdir, sub)))
              for sub in ("image", "mask", "heatmap", "image_aligned", "novel_views")}
    log(f"[pseudo] files: {counts}, trajectory.json {len(traj)} entries, affine/ "
        f"{len(os.listdir(os.path.join(pdir, 'affine'))) - 1} crops")
    check(all(v == PSEUDO_VIEWS for v in counts.values()) and len(traj) == PSEUDO_VIEWS,
          "image/, mask/, heatmap/ and trajectory.json complete")
    check(out["pasted"].shape == (PSEUDO_VIEWS, h, w, 3) and np.isfinite(out["pasted"]).all()
          and out["masks"].mean() > 0, "pasted views and masks")

    t = pti_step_ms(prov, PTI_TIMED)
    timed_cfg = dataclasses.replace(prov.pti_cfg, w_steps=PTI_TIMED, pti_steps=PTI_TIMED)
    from fateavatar_tpu_torch.completion.eg3d import pti

    # the device busy share of the same 3-step calls as the step times
    # (TF32 off), profiled once more: one call's union of device intervals
    # over its own wall time
    busy = {"w": busy_union_ms(lambda: pti.project_w(
        prov.params, prov.cfg, timed_cfg, prov.targets, prov.target_labels,
        torch.Generator(device="cuda").manual_seed(0), prov.vgg_params)),
        "g": busy_union_ms(lambda: pti.pti_finetune(
            prov.params, prov.cfg, timed_cfg, prov.ws, prov.targets, prov.target_labels,
            prov.vgg_params))}
    orbit_ms = st["①"][2] * 1e3 / PSEUDO_VIEWS
    eg3d_ms = st["⑥"][2] * 1e3 / PSEUDO_VIEWS
    log(f"[pseudo] ms per W step {t[('w', False)][0]:.1f} (TF32 on: {t[('w', True)][0]:.1f}), "
        f"per G step {t[('g', False)][0]:.1f} (TF32 on: {t[('g', True)][0]:.1f}) ({PTI_TIMED} "
        f"steps each, host clock, synchronized, {prov.targets.shape[0]} views); the CLI's "
        f"stages {st['⑤W'][2] * 1e3 / PTI_STEPS:.1f} / {st['⑤G'][2] * 1e3 / PTI_STEPS:.1f} "
        f"ms per step (first steps included); peak device memory W {st['⑤W'][3]:.2f} GiB, "
        f"G {st['⑤G'][3]:.2f} GiB; ms per orbit view: avatar render (stage ①, PNG "
        f"written) {orbit_ms:.2f}, EG3D re-render at {prov.cfg.sr_resolution}^2 (stage ⑥) "
        f"{eg3d_ms:.2f}; "
        f"alignment {st['③'][2]:.2f} s, paste-back {st['⑦'][2]:.2f} s; one {PTI_TIMED}-step "
        f"call each under the profiler, wall / device busy (union of the device intervals): W "
        f"{busy['w'][0]:.1f} / {busy['w'][1]:.1f} ms (busy {busy['w'][1] / busy['w'][0]:.1%}, "
        f"idle {1 - busy['w'][1] / busy['w'][0]:.1%}; the W stage's statistics of "
        f"{prov.pti_cfg.w_avg_samples} z included), G {busy['g'][0]:.1f} / {busy['g'][1]:.1f} "
        f"ms (busy {busy['g'][1] / busy['g'][0]:.1%}, idle {1 - busy['g'][1] / busy['g'][0]:.1%})"
        f"; phase total {time.perf_counter() - t_phase:.1f} s [{card}]")
    rows["blend_instances_fwd"]["pseudo_launches"] = fwd
    rows["blend_instances_bwd"]["pseudo_launches"] = bwd
    return {"dir": pdir, "plugins": plugins, "aligned": n_al,
            "targets": int(prov.targets.shape[0]),
            "restore_s": st["④"][2], "masks_s": st["⑧"][2], "crop_change": crop_change,
            "stage8_view_ms": {"matte_wall": matte_wall, "matte_busy": matte_busy,
                               "mask_png": png_ms, "stage": view_ms},
            "w_ms": t[("w", False)][0], "w_ms_tf32": t[("w", True)][0],
            "g_ms": t[("g", False)][0], "g_ms_tf32": t[("g", True)][0],
            "w_peak_gib": st["⑤W"][3], "g_peak_gib": st["⑤G"][3], "orbit_ms": orbit_ms,
            "w_call_wall_busy_ms": busy["w"], "g_call_wall_busy_ms": busy["g"],
            "eg3d_view_ms": eg3d_ms, "w_losses": lw, "g_losses": lg, "device": dev_check,
            "run_s": run_s}


def plugins_phase(cli, pseudo, rows, card):
    """[plugins]: GFPGAN (GFPGANConfig(), 512^2), MODNet and BiSeNet at full
    width, loaded on the card and on the CPU from the seeded checkpoints
    in their public layouts (BiSeNet's the JAX package's ``init_bisenet``
    draws as a ``79999_iter.pth`` state dict), on the same seeded 512^2
    inputs: outputs (MODNet's pre-sigmoid logits and matte, BiSeNet's
    logits) card vs CPU within PLUGIN_RTOL of the largest magnitude; ms per
    restored crop, matte and parse (CUDA events), one forward each under
    the profiler (wall and the card's busy time) and peak memory. Then
    cli/train_generate_pseudo with --bisenet_weights only (the mirror
    provider, PLUGIN_VIEWS views) on a copy of the [cli] workspace: the
    masks are BiSeNet's head masks of the pasted views."""
    import shutil

    import numpy as np
    import torch

    from fateavatar_tpu_torch.cli import train_generate_pseudo
    from fateavatar_tpu_torch.completion import matting, restoration, segmentation
    from fateavatar_tpu_torch.completion import pseudo as pseudo_mod
    from fateavatar_tpu_torch.render import blend_instances as bi

    t_phase = time.perf_counter()
    ws = os.path.dirname(os.path.dirname(cli.run))
    ckpts = dict(pseudo["plugins"], bisenet=os.path.join(ws, "79999_iter_random.pth"))
    torch.save({k: torch.from_numpy(v) for k, v in segmentation.init_bisenet(0).items()},
               ckpts["bisenet"])
    rng = np.random.default_rng(0)
    crop = rng.random((1, 512, 512, 3)).astype(np.float32)
    nets, outs = {}, {}
    for dev in ("cpu", "cuda"):
        gf = restoration.load_gfpgan_from_torch(ckpts["gfpgan"], device=dev)[0]
        md = matting.load_modnet_from_torch(ckpts["modnet"], device=dev)
        bs = segmentation.load_bisenet_from_torch(ckpts["bisenet"], device=dev)
        x = torch.as_tensor(crop, device=dev)
        with torch.no_grad():
            logits = matting.modnet_logits(md.params(), x)
            outs[dev] = {"gfpgan": gf(x * 2 - 1), "modnet_logits": logits,
                         "modnet_matte": torch.sigmoid(logits), "bisenet_logits": bs(x)}
        nets[dev] = (gf, md, bs, x)
    errs = {k: float((outs["cuda"][k].cpu() - v).abs().max() / v.abs().max())
            for k, v in outs["cpu"].items()}
    mx = {k: float(v.abs().max()) for k, v in outs["cpu"].items()}
    cls_agree = float((outs["cuda"]["bisenet_logits"].argmax(-1).cpu()
                       == outs["cpu"]["bisenet_logits"].argmax(-1)).float().mean())
    log(f"[plugins] card vs CPU on one seeded 512^2 image, max |diff| / max |value|: "
        + ", ".join(f"{k} {e:.1e} (max {mx[k]:.3f})" for k, e in errs.items())
        + f" (bound {PLUGIN_RTOL}); BiSeNet classes equal at {cls_agree:.5f} of pixels")
    check(all(e <= PLUGIN_RTOL for e in errs.values()), "the plug-ins card vs CPU")
    check(all(bool(torch.isfinite(v).all()) for v in outs["cuda"].values()),
          "finite plug-in outputs")

    gf, md, bs, x = nets["cuda"]
    del nets["cpu"], outs
    timing = {}
    for name, fn in (("gfpgan", lambda: gf(x * 2 - 1)), ("modnet", lambda: md(x)),
                     ("bisenet", lambda: bs(x))):
        with torch.no_grad():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(fn, reps=PLUGIN_TIMED)
            timing[name] = (ms, torch.cuda.max_memory_allocated() / 2**30,
                            *busy_union_ms(fn))
    log(f"[plugins] ms per restored 512^2 crop (GFPGAN) {timing['gfpgan'][0]:.3f}, per 512^2 "
        f"matte (MODNet) {timing['modnet'][0]:.3f}, per 512^2 parse (BiSeNet) "
        f"{timing['bisenet'][0]:.3f} (CUDA events, {PLUGIN_TIMED} forwards of one image, "
        f"float32, TF32 off); peak device memory {timing['gfpgan'][1]:.2f} / "
        f"{timing['modnet'][1]:.2f} / {timing['bisenet'][1]:.2f} GiB; one forward each under "
        f"the profiler, wall / the card busy: " + ", ".join(
            f"{k} {v[2]:.2f} / {v[3]:.2f} ms (busy {v[3] / v[2]:.1%})"
            for k, v in timing.items()) + f" [{card}]")
    del gf, md, bs, x

    # the BiSeNet path through the CLI, on a copy of the workspace so that
    # the [pseudo] folder stays for [complete]
    run2 = os.path.join(ws, "plugins_run")
    os.makedirs(run2)
    shutil.copy(os.path.join(cli.run, "identity_info.json"), run2)
    shutil.copytree(os.path.join(cli.run, "checkpoints"), os.path.join(run2, "checkpoints"))
    lmk = os.path.join(ws, "landmark_embedding.npy")
    args = [*cli.config, "--device", "cuda", "--workspace", run2, "--num_views",
            str(PLUGIN_VIEWS), "--bisenet_weights", ckpts["bisenet"],
            f"dataset.root_path={cli.root}", *cli.assets,
            f"assets.landmark_embedding_path={lmk}"]
    masks = []
    # ---- the BiSeNet CLI path: counts to 0 just before, read just after
    zero_counts()
    t0 = time.perf_counter()
    with recorded(pseudo_mod.PseudoGenerator, "retrieve_masks", masks):
        pg = train_generate_pseudo.main(args)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    fwd, bwd = bi.blend_instances.launches, bi.blend_instances_bwd.launches
    out = pg.result
    check(isinstance(pg.matting_fn, segmentation.BiSeNetMatting) and pg.restorer_fn is None
          and isinstance(pg.provider, pseudo_mod.MirrorPseudoProvider),
          "--bisenet_weights alone: BiSeNet masks, the mirror provider, no restorer")
    again = np.stack([pg.matting_fn(out["pasted"][i]) for i in (0, PLUGIN_VIEWS - 1)])
    m = out["masks"]
    check(m.shape == (PLUGIN_VIEWS, *out["pasted"].shape[1:3])
          and set(np.unique(m).tolist()) <= {0.0, 1.0}
          and np.array_equal(again, m[[0, PLUGIN_VIEWS - 1]]),
          "stage ⑧'s masks are BiSeNet's head masks of the pasted views")
    check(fwd == PLUGIN_VIEWS and bwd == 0, "one kernel-1 launch per orbit render")
    log(f"[plugins] train_generate_pseudo --bisenet_weights (mirror provider, {PLUGIN_VIEWS} "
        f"views; the phase's cut of the CLI's 30) {run_s:.1f} s: stage ⑧ {masks[0][2]:.2f} s "
        f"({masks[0][2] * 1e3 / PLUGIN_VIEWS:.1f} ms a view, mask PNGs written), head-class "
        f"share {float(m.mean()):.3f}; kernel 1 launches {fwd}, kernel 2 {bwd}; phase total "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    rows["blend_instances_fwd"]["plugins_launches"] = fwd
    return {"card_vs_cpu": errs, "ms": {k: v[0] for k, v in timing.items()},
            "profiled_wall_busy_ms": {k: v[2:] for k, v in timing.items()},
            "peak_gib": {k: v[1] for k, v in timing.items()}, "cli_s": run_s}


def complete_phase(cli, pseudo, rows, card):
    """[complete]: cli/train_full_avatar --finetune_epochs 1 on the [cli]
    workspace and the [pseudo] folder: the re-seed (alive rises), one real
    and one pseudo step per real frame, one launch of kernels 1 and 2 per
    step, finite losses, the checkpoint, the orbit video and six fixed-view
    videos; one pseudo step's gradients kernels vs plain blends; ms per
    real and pseudo step; then the full-head bake: UVBaker.bake(1 epoch,
    pseudo_dataset=PseudoDataset(the [pseudo] folder)) on the fine-tuned
    avatar through the bake step's CUDA graph."""
    import numpy as np
    import torch

    from fateavatar_tpu_torch.cli import common, train_full_avatar
    from fateavatar_tpu_torch.completion.trainer import CompletionTrainer, PseudoDataset
    from fateavatar_tpu_torch.models import uv_decoder as uvd
    from fateavatar_tpu_torch.render import blend_instances as bi
    from fateavatar_tpu_torch.train.baker import UVBaker
    from fateavatar_tpu_torch.train.losses import FateAvatarLoss
    from fateavatar_tpu_torch.train.step import make_train_step
    from fateavatar_tpu_torch.utils.config import load_config
    from fateavatar_tpu_torch.utils.graphs import WARMUP

    t_phase = time.perf_counter()
    args = [*cli.config, "--device", "cuda", "--workspace", cli.run, "--finetune_epochs", "1",
            f"dataset.root_path={cli.root}", *cli.assets]
    alive = []
    reseed = CompletionTrainer.add_default_points

    def add_default_points(self, *a, **k):
        alive.append(int(self.ts.state.alive.sum()))
        reseed(self, *a, **k)
        alive.append(int(self.ts.state.alive.sum()))

    names = ("augmentation", "render_dynamic_novel_view", "render_dynamic_fixed_view")
    record = []
    CompletionTrainer.add_default_points = add_default_points
    zero_counts()
    t0 = time.perf_counter()
    try:
        with counted(CompletionTrainer, names, record):
            tr = train_full_avatar.main(args)
    finally:
        CompletionTrainer.add_default_points = reseed
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    fwd, bwd = bi.blend_instances.launches, bi.blend_instances_bwd.launches
    rec = {r[0]: r for r in record}
    aug, orbit, fixed = (rec[n] for n in names)
    n_real = len(tr.train_dataset)
    kinds = [k for k, _ in tr.augment_aux]
    losses, overflow = torch.stack([torch.stack([a["loss"], a["overflow"].to(torch.float32)])
                                    for _, a in tr.augment_aux]).cpu().numpy().T
    log(f"[complete] train_full_avatar {args[2:]}: {run_s:.1f} s; alive {alive[0]} -> "
        f"{alive[1]} after the re-seed; {len(kinds)} steps ({kinds.count('real')} real, "
        f"{kinds.count('pseudo')} pseudo on {len(tr.pseudo_dataset)} pseudo frames), losses "
        f"{[round(float(x), 5) for x in losses]}, overflow {int(overflow.sum())}; launches: "
        f"augmentation {aug[1]} / {aug[2]}, "
        f"orbit video {orbit[1]} forward in {orbit[3]:.2f} s, fixed views {fixed[1]} forward "
        f"in {fixed[3]:.2f} s; in all {fwd} forward, {bwd} backward")
    check(alive[1] > alive[0], "alive splats rise after the re-seed")
    check(kinds == ["real", "pseudo"] * n_real, "2 steps per real frame")
    check(aug[1] == aug[2] == 2 * n_real, "one launch of kernels 1 and 2 per step")
    check(np.isfinite(losses).all(), "finite completion losses")
    check(overflow.sum() == 0, "no instance dropped by the binning caps in the fine-tune")
    n_fixed = 6 * min(50, len(tr.test_dataset))
    check(orbit[1] == 100 and fixed[1] == n_fixed and orbit[2] == fixed[2] == 0,
          "one forward launch per video frame")
    ckpt = os.path.join(cli.run, "checkpoints")
    media = os.path.join(cli.run, "media")
    videos = [f for f in os.listdir(os.path.join(media, "fixed_views"))
              if f.startswith("azimuth_")]
    orbit_video = [f for f in ("fullhead_orbit.mp4", "fullhead_orbit.gif")
                   if os.path.exists(os.path.join(media, f))]
    saved = sorted(os.listdir(ckpt))
    log(f"[complete] checkpoints {saved} (the full-head one at step {tr.global_step}), log "
        f"log_{tr.name}.txt; media {orbit_video} and fixed_views/{sorted(videos)}")
    check(any(str(tr.global_step) in f for f in saved)
          and os.path.exists(os.path.join(cli.run, f"log_{tr.name}.txt"))
          and tr.name.endswith("_fullhead"), "the _fullhead checkpoint")
    check(len(orbit_video) == 1 and len(videos) == 6, "the orbit video and six fixed views")

    # ---- one pseudo step's gradients, kernels vs plain blends (float32
    # VGG, deterministic cuDNN, TF32 off: only the blends differ)
    pd = tr.pseudo_dataset
    rng = np.random.default_rng(1)
    pframe = tr.pseudo_frame(pd.sample(0), rng.random(3).astype(np.float32))
    loss_fn = tr.loss_fn
    tr.loss_fn = FateAvatarLoss(dataclasses.replace(loss_fn.cfg, vgg_dtype=None),
                                vgg_params=loss_fn.vgg_params)
    step = make_train_step(tr.model, tr.loss_fn, tr.optimizer, tr.maint_cfg, tr.render_cfg)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        gk = step.grads(tr.ts, pframe)
        with swapped_blend(bi.blend_instances_plain):
            gp = step.grads(tr.ts, pframe)
    tr.loss_fn = loss_fn
    check_step_grads("complete", "a pseudo step, kernels vs plain blends", gk, gp)

    # ---- ms per real and per pseudo step (eager, synchronized)
    never = 10**9
    tr.maint_cfg = dataclasses.replace(tr.maint_cfg, densify_interval=never,
                                       prune_interval=never, opacity_reset_interval=never)
    tr.set_render_cfg(tr.render_cfg)
    n_timed = min(COMPLETE_TIMED, n_real)
    real = [tr._make_frame(tr.train_dataset.sample(i), tr.train_tables) for i in range(n_timed)]
    pseudo_frames = [tr.pseudo_frame(pd.sample(i % len(pd)), rng.random(3).astype(np.float32))
                     for i in range(n_timed)]
    ms = {}
    for label, frames in (("real", real), ("pseudo", pseudo_frames), ("real2", real)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in frames:
            tr.ts, _ = tr.train_step(tr.ts, f)
        torch.cuda.synchronize()
        ms[label] = (time.perf_counter() - t0) * 1e3 / len(frames)
    log(f"[complete] ms/step real {ms['real']:.2f} / {ms['real2']:.2f} (before / after), "
        f"pseudo {ms['pseudo']:.2f} (eager steps, {n_timed} each, host clock, "
        f"synchronized; a pseudo frame's ground truth uploads each step, uncached); videos "
        f"{orbit[3]:.2f} s for 100 orbit frames, {fixed[3]:.2f} s for {n_fixed} fixed-view "
        f"frames (render, host copy, video write) [{card}]")

    # ---- the full-head bake: one epoch with the pseudo set
    identity = common.load_identity_info(cli.run)
    pds = PseudoDataset(pseudo["dir"], img_res=[tr.model.cfg.img_height, tr.model.cfg.img_width],
                        n_exp=tr.train_dataset.n_exp,
                        flame_canonical_exp=tr.model.flame.canonical_exp.cpu().numpy(),
                        flame_canonical_pose=tr.model.flame.canonical_pose.cpu().numpy(),
                        fovx=identity["fovx"], fovy=identity["fovy"])
    dec, net, const = uvd.build_uv_decoder(tr.model, tr.ts.params, tr.ts.state,
                                           decode_type="UNet",
                                           bake_attribute=("color", "opacity"))
    # the bake CLI's render settings: the yaml's (the Trainer's autosized
    # budget is sized for the splats it trained, not the decoder's M)
    bake_rcfg = common.render_config(load_config(cli.config[1], []))
    baker = UVBaker(dec, net, const, tr.loss_fn, tr.train_dataset, workspace=None,
                    reg_weight=0.1, reg_attribute=("color",), render_cfg=bake_rcfg)
    zero_counts()
    t0 = time.perf_counter()
    baker.bake(max_epochs=1, pseudo_dataset=pds)
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t0
    bfwd, bbwd = bi.blend_instances.launches, bi.blend_instances_bwd.launches
    g = baker.graph
    replays, per_replay = g.replays, dict(g.launches_per_replay)
    stats = baker.last_epoch_stats
    steps = 2 * len(baker.dataset)
    log(f"[complete] full-head bake (UVBaker.bake, 1 epoch, pseudo_dataset of {len(pds)} "
        f"frames, M {baker.model.face_index.shape[0]} splats): {bake_s:.1f} s, {stats['steps']} "
        f"steps, losses {[round(x, 5) for x in baker.epoch_losses]}, overflow "
        f"{stats['overflow']}; wrapper launches {bfwd} / {bbwd} ({WARMUP} warm-up calls + the "
        f"capture), then {replays} replays x {per_replay}; "
        f"{bake_s * 1e3 / steps:.2f} ms/step (the capture included) [{card}]")
    check(stats["steps"] == steps and len(pds) > 0, "a pseudo frame after every real one")
    check(np.isfinite(baker.epoch_losses).all(), "finite full-head bake losses")
    check(stats["overflow"] == 0, "overflow 0 in the full-head bake")
    check(replays == steps and per_replay == {"blend_instances_fwd": 1,
                                              "blend_instances_bwd": 1}
          and bfwd == bbwd == WARMUP + 1, "one launch of kernels 1 and 2 per bake step")
    t_step = []
    frame = baker._prep(pds.sample(0), "pseudo")
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(COMPLETE_TIMED):
            baker.step(frame)
        torch.cuda.synchronize()
        t_step.append((time.perf_counter() - t0) * 1e3 / COMPLETE_TIMED)
    log(f"[complete] full-head bake step through its graph on a pseudo frame: "
        f"{t_step[-1]:.2f} ms/step ({COMPLETE_TIMED} replays, host clock, synchronized); "
        f"phase total {time.perf_counter() - t_phase:.1f} s [{card}]")
    for name, n, b, a in (("blend_instances_fwd", fwd, bfwd, aug[1]),
                          ("blend_instances_bwd", bwd, bbwd, aug[2])):
        rows[name]["complete_launches"] = {"cli_run": n, "per_step": a / len(kinds)}
        rows[name]["fullhead_bake_launches"] = {"wrapper": b, "replays": replays,
                                                "per_replay": per_replay.get(name, 0)}
    return {"ms_real": ms["real"], "ms_pseudo": ms["pseudo"], "alive": alive,
            "orbit_video_s": orbit[3], "fixed_video_s": fixed[3], "run_s": run_s,
            "bake_ms": t_step[-1], "bake_losses": baker.epoch_losses}


def graph_phase(s, trainer_i, tiles_cfg, cli_tr, serve, rows, card):
    """[graph]: the scan epoch's CUDA graph on the three training paths (the
    [train] Trainer, a Trainer of GRAPH_TILES_FRAMES frames on the tiles
    route, the [cli] IMAvatar Trainer with its tracking step), the fps test,
    the served frame's graph on both routes, the kernel names the profiler
    saw inside the replays, and peak memory with every graph's pool held."""
    import torch

    from fateavatar_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    seen = set()
    out = {"train": graph_train("graph-train", trainer_i, card, seen)}
    fps = trainer_i.fps_performance_test(100)
    log(f"[graph] fps_performance_test(100): {fps:.1f} frames/s, {1e3 / fps:.3f} ms/frame "
        f"(one captured forward of training frame 0, replayed) [{card}]")
    tiles_tr = Trainer(s.cfg.name, s.model, s.params, s.state, s.loss_fn, s.optimizer,
                       s.dataset(GRAPH_TILES_FRAMES, 0), None, maint_cfg=s.maint,
                       seed=s.cfg.seed, render_cfg=tiles_cfg)
    tiles_tr.epoch = 1
    tiles_tr.train_epoch()         # per step: fills the device frame cache
    out["tiles-train"] = graph_train("graph-tiles", tiles_tr, card, seen)
    out["train-tracking"] = graph_train("graph-track", cli_tr, card, seen)
    model, params, state, ws, rcfg, tcfg, cam, exprs, poses, delta = serve
    for route, cfg in (("instances", rcfg), ("tiles", tcfg)):
        out[f"serve-{route}"] = graph_serve(f"graph-serve-{route}", model, params, state, ws,
                                            cfg, cam, exprs, poses, delta, card, seen)
    for name in KERNELS:
        hit = sorted(k for k in seen if name in k)
        check(bool(hit), f"the profiler saw {name} inside a graph replay")
        log(f"[graph] {name}: inside the replays as {hit}")
        rows[name]["graph_launches_per_replay"] = {
            path: o["per_replay"][name] for path, o in out.items()
            if name in o.get("per_replay", {})}
    log(f"[graph] peak device memory of the phase "
        f"{max(o['peak_gib'] for o in out.values()):.3f} GiB (the largest of its parts'), "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated at its end with "
        f"three Trainers and their graphs' pools held, {torch.cuda.memory_reserved() / 2**30:.3f} "
        f"GiB reserved; phase total {time.perf_counter() - t_phase:.1f} s [{card}]")
    log("[graph] summary " + json.dumps({
        path: {k: (v if not isinstance(v, dict) else {kk: vv for kk, vv in v.items()
                                                      if kk != "names"})
               for k, v in o.items()} for path, o in out.items()} | {"fps": fps}))


# ---------------------------------------------------------------------------
# [options]: the rasterizer's remaining RenderConfig options at full width
# ---------------------------------------------------------------------------

OPTION_MODES = ("onesort", "twotier", "stable", "count", "gather", "twokey")
OPTION_LAYOUTS = (("compact", "scatter"), ("aligned", "scatter"), ("aligned", "gather"))
OPTION_CUTOFFS = (1e-3, 1e-2)
CUT_MARGIN = 1e-5         # tiles whose q is this close to the cutoff may cut elsewhere
OPAQUE_MIN = 0.9          # the opaque frame's smallest opacity
OPTION_GRAPH_FRAMES = 8   # served frames through the options' graph
OPTION_GRAPH_CUTOFF = 1e-2   # the options' graph: the opaque avatar cuts tiles here
# the Trainer's graph step takes the first of these that cuts a tile of its frame
TRAIN_GRAPH_CUTOFFS = (1e-3, 1e-2, 1e-1, 0.5, 0.9)
TRANSPOSE_RTOL = 1e-4     # each transpose's gradients vs slim, of each field's largest


def opaque_params(params):
    """The avatar with every opacity raised to at least OPAQUE_MIN."""
    import math

    lo = math.log(OPAQUE_MIN / (1 - OPAQUE_MIN))
    return dataclasses.replace(params, opacity=params.opacity.clamp_min(lo))


def tiles_cut_recorder(cutoff, counts):
    """A stand-in for render()'s blend (see swapped_blend) that appends to
    ``counts`` how many tiles the early exit at ``cutoff`` cuts on the
    inputs it is given (the cut pass alone, not a launch of kernel 1), then
    blends as render() would."""
    from fateavatar_tpu_torch.render import blend_instances as bi

    def record(inst, starts, bg, grid, **kw):
        counts.append(int((bi.blend_cut(inst.detach(), starts, grid, cutoff).long()
                           < starts[1:].long()).sum()))
        return bi.blend_instances(inst, starts, bg, grid, **kw)

    return record


def option_frames(model, params, state, cam, e0, p0, rcfg):
    """The blend inputs of the served frame 0 and of the same frame with
    every opacity raised to at least OPAQUE_MIN (the opaque frame), each
    captured from fateavatar_forward, whose overflow must be 0."""
    import torch

    from fateavatar_tpu_torch.models.fateavatar import fateavatar_forward
    from fateavatar_tpu_torch.render import blend_instances as bi

    out = {}
    for name, p in (("served", params), ("opaque", opaque_params(params))):
        captured = []

        def record(*args, **kw):
            captured.append(args)
            return bi.blend_instances(*args, **kw)

        with torch.no_grad(), swapped_blend(record):
            ovf = int(fateavatar_forward(model, p, state, e0, p0, cam, render_cfg=rcfg)["overflow"])
        check(ovf == 0, f"[options] {name} frame: overflow 0")
        out[name] = captured[0]
    return out


def cutoff_forward(label, inst, starts, bg, grid, cutoff):
    """Kernel 1 with the early exit (t_cutoff = ``cutoff``) against the plain
    version on the same inputs: the forward's cut equals the cut pass
    launched alone; it equals the plain version's cut on every tile whose
    margin (|max q - cutoff| / cutoff at the decisions taken) exceeds
    CUT_MARGIN; the forward is within TOL on the tiles whose cut agrees and
    within cutoff + TOL on every tile. Returns (img, t_final, cut, the plain
    cut, the tiles that agree, numbers for the summary)."""
    import torch

    from fateavatar_tpu_torch.render import blend_instances as bi

    s, e = starts[:-1].long(), starts[1:].long()
    img_k, tfin_k, cut = bi.blend_instances_fwd(inst, starts, bg, grid, cutoff=cutoff)
    cut_alone = bi.blend_cut(inst, starts, grid, cutoff)
    cut_p, margin = bi.window_cut(inst, inst[9], s, e, grid, cutoff, return_margin=True)
    check(torch.equal(cut, cut_alone), f"[options] {label}: the forward's cut == the cut "
          "pass alone")
    agree = cut.long() == cut_p
    sure = margin > CUT_MARGIN
    check(bool(agree[sure].all()), f"[options] {label}: cut == the plain cut on every tile "
          f"with margin > {CUT_MARGIN} ({int((~agree & sure).sum())} off)")
    img_p, tfin_p = bi.blend_instances_reference(inst, starts, bg, grid, cutoff=cutoff)
    d = torch.maximum((img_k - img_p).abs().amax(dim=(1, 2)), (tfin_k - tfin_p).abs().amax(dim=1))
    check(bool((d[agree] <= TOL).all()), f"[options] {label}: forward within {TOL} on the "
          f"tiles whose cut agrees ({float(d[agree].max()):.3e})")
    check(float(d.max()) <= cutoff + TOL, f"[options] {label}: forward within cutoff + {TOL} "
          f"on every tile ({float(d.max()):.3e})")
    stats = {"columns": int((torch.minimum(e, cut.long()) - s).sum()),
             "tiles_cut": int((cut.long() < e).sum()), "tiles_off": int((~agree).sum()),
             "tiles_near": int((~sure).sum()), "fwd_err": float(d[agree].max())}
    return img_k, tfin_k, cut, cut_p, agree, stats


def options_phase(model, params, state, ws, rcfg, cam, exprs, poses, delta, trainer, rows,
                  card):
    """[options]: the rasterizer's RenderConfig options at full width on the
    serving cell (the yaml's avatar, 512x512, 65,536 splats, the served
    codes): every binning mode and layout against the CPU, the gather
    transposes against the slim one, the early exit of kernels 1 and 2
    against the plain versions (the served and an opaque frame), and the
    options through the served frame's and the Trainer's CUDA graphs."""
    import numpy as np
    import torch

    _tests_on_path()
    from torch_determinism import deterministic_sums

    from fateavatar_tpu_torch.models.fateavatar import build_gaussians, fateavatar_forward
    from fateavatar_tpu_torch.render import autosize, binning
    from fateavatar_tpu_torch.render import blend_instances as bi
    from fateavatar_tpu_torch.render.preprocess import preprocess
    from fateavatar_tpu_torch.render.render import render
    from fateavatar_tpu_torch.train.loader import Reenactor
    from fateavatar_tpu_torch.utils.graphs import WARMUP

    t_phase = time.perf_counter()
    dev = "cuda"
    fwd_row, bwd_row = rows["blend_instances_fwd"], rows["blend_instances_bwd"]
    e0 = torch.from_numpy(exprs[0]).to(dev)
    p0 = torch.from_numpy(poses[0]).to(dev)
    with torch.no_grad():
        gaussians = build_gaussians(model, params, state, e0, p0)[0]
        prep = preprocess(cam, gaussians.xyz, gaussians.get_scaling, gaussians.get_rotation,
                          gaussians.get_opacity, gaussians.get_features, gaussians.sh_degree,
                          alive=gaussians.alive)
    grid = binning.tile_grid(cam.width, cam.height)
    T = grid[0] * grid[1]
    n = prep.depth.shape[0]
    total, max_t, n_big = (int(x) for x in autosize.occupancy_stats(
        (prep.soa[0], prep.soa[1]), prep.depth, prep.radius, grid))
    caps = autosize.size_caps(total, max_t, n, T, dataclasses.replace(rcfg, binning="twotier"),
                              big_count=n_big)
    log(f"[options] the served frame 0: {total} instances, up to {max_t} tiles a splat, "
        f"{n_big} splats over {caps.tail_r0} -> probed caps instance_budget "
        f"{caps.instance_budget}, R {caps.max_tiles_per_gaussian}, tail_k {caps.tail_k}")

    # ---- 1. binning modes: card vs CPU bit for bit, ms, rendered frames
    def cfg_of(mode, layout, relayout="scatter", **kw):
        return dataclasses.replace(caps, binning=mode, layout=layout, relayout=relayout, **kw)

    bg = model.bg_color
    args = (prep.soa[0], prep.soa[1], prep.depth, prep.radius, grid)
    cpu_args = tuple(x.cpu() for x in args[:4]) + (grid,)
    kw = dict(max_tiles_per_gaussian=caps.max_tiles_per_gaussian,
              instance_budget=caps.instance_budget, tail_r0=caps.tail_r0, tail_k=caps.tail_k,
              chunk=bi.CHUNK)
    runs, bin_ms, cpu_runs = [], {}, {}
    t0 = time.perf_counter()
    for mode in OPTION_MODES:
        for layout, relayout in OPTION_LAYOUTS:
            tag = f"{mode}/{layout}/{relayout}"
            run = dict(kw, sort_mode=mode, layout=layout, relayout=relayout)
            lists = binning.build_instance_lists(*args, **run)
            bin_ms[tag] = round(cuda_ms(lambda: binning.build_instance_lists(*args, **run),
                                        reps=5), 4)
            # 'count' and 'gather' give the aligned layout whatever it says
            key = (mode,) if mode in ("count", "gather") else (mode, layout, relayout)
            if key not in cpu_runs:
                cpu_runs[key] = binning.build_instance_lists(*cpu_args, **run)
            same = all(torch.equal(getattr(lists, f).cpu(), getattr(cpu_runs[key], f))
                       for f in ("instances", "tile_starts", "overflow"))
            check(same and int(lists.overflow) == 0,
                  f"[options] binning {tag}: card == CPU bit for bit, overflow 0")
            with torch.no_grad():
                img = render(cam, gaussians, bg, config=cfg_of(mode, layout, relayout))["render"]
            runs.append((tag, lists, img))
    classes = []          # runs with the same instance array
    for tag, lists, img in runs:
        for c in classes:
            if (torch.equal(lists.instances, c[0][1].instances)
                    and torch.equal(lists.tile_starts, c[0][1].tile_starts)):
                c.append((tag, lists, img))
                break
        else:
            classes.append([(tag, lists, img)])
    for c in classes:
        check(all(torch.equal(img, c[0][2]) for _, _, img in c),
              f"[options] frames of one instance array bit-equal: {[x[0] for x in c]}")
    compact_vs_aligned = torch.equal(runs[0][2], runs[1][2])
    log(f"[options] binning, each mode x layout x relayout on the card == the CPU's run "
        f"bit for bit (instances, tile_starts, overflow 0; {len(cpu_runs)} CPU runs, "
        f"{time.perf_counter() - t0:.1f} s with the renders); {len(classes)} distinct "
        f"instance arrays: {[[x[0] for x in c] for c in classes]}, each class's frames "
        f"bit-equal; onesort compact vs aligned frames bit-equal {compact_vs_aligned}")
    log(f"[options] binning ms (CUDA events, 5 calls): {json.dumps(bin_ms)} [{card}]")

    # ---- 2. the gather transposes: one step's render() gradients
    rng = np.random.default_rng(3)
    g_img = torch.from_numpy(rng.normal(size=(cam.height, cam.width, 3)).astype(np.float32)).to(dev)
    g_t = torch.from_numpy(rng.normal(size=(cam.height, cam.width)).astype(np.float32)).to(dev)
    fields = ("xyz", "scaling", "rotation", "opacity", "features_dc", "features_rest")

    def grads(cfg):
        leaves = {f: getattr(gaussians, f).detach().clone().requires_grad_() for f in fields}
        probe = torch.zeros((2, n), device=dev, requires_grad=True)
        out = render(cam, dataclasses.replace(gaussians, **leaves), bg, config=cfg,
                     means2d_probe=probe)
        check(int(out["overflow"]) == 0, "[options] transposes: overflow 0")
        loss = (out["render"] * g_img).sum() + (out["t_final"] * g_t).sum()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        g = torch.autograd.grad(loss, [*leaves.values(), probe], allow_unused=True)
        ev[1].record()
        torch.cuda.synchronize()
        return dict(zip(fields + ("probe",), g)), ev[0].elapsed_time(ev[1])

    transposes = {"slim": cfg_of(caps.binning, "compact"),
                  "slots": cfg_of("stable", "aligned", bwd_slots=True),
                  "grouped": cfg_of("twotier", "compact", bwd_grouped=True),
                  "sorted": cfg_of(caps.binning, "compact", bwd_sorted_scatter=True)}
    tr_out = {}
    for name, cfg in transposes.items():
        grads(cfg)                                             # warm-up
        (a, ms_a), (b, ms_b) = grads(cfg), grads(cfg)
        repeat = all(torch.equal(a[f], b[f]) for f in a if a[f] is not None)
        tr_out[name] = {"grads": a, "ms": round(min(ms_a, ms_b), 4), "bit_equal": repeat}
    worst = {}
    for name in ("slots", "grouped", "sorted"):
        rel = {}
        for f, ref in tr_out["slim"]["grads"].items():
            got = tr_out[name]["grads"][f]
            if ref is None or ref.numel() == 0 or float(ref.abs().max()) == 0.0:
                continue
            rel[f] = float((got - ref).abs().max() / ref.abs().max())
        worst[name] = max(rel.values())
        check(worst[name] <= TRANSPOSE_RTOL,
              f"[options] {name} transpose vs slim: {rel} (bound {TRANSPOSE_RTOL})")
    log(f"[options] one step's render() gradients under each transpose vs slim, the largest "
        f"difference over each field's largest element: {worst} (bound {TRANSPOSE_RTOL}); "
        f"ms of the backward (CUDA events, the faster of two, kernel 2 and preprocess's "
        f"backward included): " + ", ".join(
            f"{k} {v['ms']:.3f} (two runs bit-equal {v['bit_equal']})"
            for k, v in tr_out.items()) + f" [{card}]")
    del tr_out

    # ---- 3. the early exit of kernels 1 and 2 against the plain versions
    frames = option_frames(model, params, state, cam, e0, p0, rcfg)
    cut_rows = {}
    for fname, (inst, starts, bgc, grid_f) in frames.items():
        s, e = starts[:-1].long(), starts[1:].long()
        img0, tfin0 = bi.blend_instances(inst, starts, bgc, grid_f)
        img_e, tfin_e = bi.blend_instances(inst, starts, bgc, grid_f, cutoff=1e-4)
        check(torch.equal(img0, img_e) and torch.equal(tfin0, tfin_e),
              f"[options] {fname}: t_cutoff 1e-4 gives the bits of t_cutoff 0")
        gen = torch.Generator(device=dev).manual_seed(7)
        g_i = torch.randn(img0.shape, generator=gen, device=dev)
        g_f = torch.randn(tfin0.shape, generator=gen, device=dev)
        timing = {"0": {"fwd_ms": cuda_ms(lambda: bi.blend_instances(inst, starts, bgc, grid_f),
                                          reps=20),
                        "bwd_ms": cuda_ms(lambda: bi.blend_instances_bwd(
                            inst, starts, bgc, img0, tfin0, g_i, g_f, grid_f), reps=20),
                        "columns": int((e - s).sum())}}
        for c in OPTION_CUTOFFS:
            img_k, tfin_k, cut, cut_p, agree, fst = cutoff_forward(
                f"{fname} {c}", inst, starts, bgc, grid_f, c)
            g_k = bi.blend_instances_bwd(inst, starts, bgc, img_k, tfin_k, g_i, g_f, grid_f,
                                         cut=cut)
            g_p = bi.blend_instances_backward_reference(inst, starts, bgc, img_k, tfin_k, g_i,
                                                        g_f, grid_f, cut=cut_p)
            col = torch.arange(inst.shape[1], device=dev)
            tile_of = (torch.searchsorted(starts, col.to(torch.int32), right=True) - 1).clamp(
                0, T - 1)
            cols_ok = agree[tile_of] & (col < starts[-1])
            scale = g_p[:9, cols_ok].abs().amax(dim=1, keepdim=True) + 1e-12
            rel = float(((g_k[:9, cols_ok] - g_p[:9, cols_ok]).abs() / scale).max())
            check(rel <= BWD_RTOL, f"[options] {fname} {c}: backward within {BWD_RTOL} of "
                  f"each row's largest on the tiles whose cut agrees ({rel:.3e})")
            dirty = bi.blend_instances_bwd(inst, starts, bgc, img_k, tfin_k, g_i, g_f, grid_f,
                                           out=torch.full_like(g_k, float("nan")), cut=cut)
            past = (col >= cut[tile_of]) & (col < starts[tile_of + 1])
            check(torch.equal(dirty, g_k) and bool((dirty[:, past] == 0).all()),
                  f"[options] {fname} {c}: a NaN-filled backward buffer comes back equal, "
                  "0 past every cut")
            fwd_row["max_abs_err"] = max(fwd_row["max_abs_err"], fst["fwd_err"])
            bwd_row["max_abs_err"] = max(bwd_row["max_abs_err"],
                                         float((g_k[:, cols_ok] - g_p[:, cols_ok]).abs().max()))
            timing[str(c)] = dict(fst, **{
                "fwd_ms": cuda_ms(lambda: bi.blend_instances_fwd(inst, starts, bgc, grid_f,
                                                                 cutoff=c), reps=20),
                "bwd_ms": cuda_ms(lambda: bi.blend_instances_bwd(
                    inst, starts, bgc, img_k, tfin_k, g_i, g_f, grid_f, cut=cut), reps=20),
                "cut_ms": cuda_ms(lambda: bi.blend_cut(inst, starts, grid_f, c), reps=20),
                "bwd_rel": rel})
        segment_split(f"blend_instances_fwd {fname} t_cutoff 1e-3",
                      lambda: bi.blend_instances_fwd(inst, starts, bgc, grid_f, cutoff=1e-3),
                      card)
        cut_rows[fname] = timing
        log(f"[options] {fname} frame ({int((e - s).sum())} instances, deepest tile "
            f"{int((e - s).max())}): t_cutoff 1e-4 == 0 bit for bit; by t_cutoff "
            + "; ".join(f"{k}: kernel 1 {v['fwd_ms']:.4f} ms, kernel 2 {v['bwd_ms']:.4f} ms"
                        + (f", the cut pass alone {v['cut_ms']:.4f} ms, {v['tiles_cut']} of {T} "
                           f"tiles cut, columns walked {v['columns']} of "
                           f"{timing['0']['columns']}, tiles whose cut differs from the plain "
                           f"version's {v['tiles_off']} ({v['tiles_near']} within margin "
                           f"{CUT_MARGIN}), forward err {v['fwd_err']:.2e}, backward rel "
                           f"{v['bwd_rel']:.2e}" if k != "0" else "")
                        for k, v in timing.items()) + f" (CUDA events, 20 calls) [{card}]")
    fwd_row["cutoff"] = bwd_row["cutoff"] = cut_rows

    # ---- 4. the options through the CUDA graphs, each with tiles cut
    gc = OPTION_GRAPH_CUTOFF
    gcfg = dataclasses.replace(rcfg, binning="count", layout="aligned", t_cutoff=gc)
    rr = Reenactor(model, opaque_params(params), state, ws, render_cfg=gcfg)
    m = OPTION_GRAPH_FRAMES
    counters = zero_counts()
    served = rr.reenact(exprs[:m], poses[:m], delta, cam)
    wrapper = {k: c.launches for k, c in counters.items() if c.launches}
    g = rr.last_graph
    n_exp = model.flame.n_exp
    eager, ovf, cut_tiles = [], [], []
    for expr, pose in zip(exprs[:m], poses[:m]):
        ex = np.zeros(n_exp, np.float32)
        k = min(n_exp, len(expr))
        ex[:k] = expr[:k]
        ex[:len(delta)] -= delta[:len(ex)]
        with torch.no_grad(), swapped_blend(tiles_cut_recorder(gc, cut_tiles)):
            out = fateavatar_forward(model, rr.params, state, torch.from_numpy(ex).to(dev),
                                     torch.from_numpy(pose).to(dev), cam, render_cfg=gcfg)
        ovf.append(int(out["overflow"]))
        eager.append(torch.clamp(torch.round(out["rgb_image"] * 255.0), 0, 255)
                     .to(torch.uint8).cpu().numpy())
    same = all(np.array_equal(a, b) for a, b in zip(served, eager))
    log(f"[options] Reenactor.reenact of the opaque avatar with binning count, layout "
        f"aligned, t_cutoff {gc}: {m} frames through the graph vs eager forwards bit-equal "
        f"{same}, overflow {ovf}, tiles cut by each frame {cut_tiles} of {T}; wrapper "
        f"launches {wrapper} ({WARMUP} warm-up calls + the capture), {g.replays} replays x "
        f"{g.launches_per_replay}")
    check(same and not any(ovf) and g.launches_per_replay == {"blend_instances_fwd": 1},
          "[options] the served frames' graph under the options == eager, bit for bit")
    check(sum(cut_tiles) > 0, "[options] the options' graph replays frames with tiles cut")
    del rr

    tr = trainer
    keep_cfg = tr.render_cfg
    tr.regrow_caps()    # the caps of its current splats (densified since its autosize)
    tracking = tr.tracking_enabled
    tr.tracking_enabled = False
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=torch.backends.cudnn.allow_tf32), \
            deterministic_sums() as flagged:
        snap = graph_snapshot(tr)
        frame = tr._make_frame(tr.train_dataset.sample(0), tr.train_tables)
        # the blend's inputs do not depend on the cutoff: the tiles each
        # candidate cuts, from one eager step at the first
        tc = TRAIN_GRAPH_CUTOFFS[0]
        tr.set_render_cfg(dataclasses.replace(tr.render_cfg, t_cutoff=tc))
        seen = []
        with swapped_blend(lambda inst, starts, bg, grid, **kw: seen.append(
                (inst.detach(), starts, grid)) or bi.blend_instances(inst, starts, bg, grid,
                                                                     **kw)):
            ts1, aux1 = tr.train_step(tr.ts, frame)
        inst, starts, grid_t = seen[0]
        tr_cut = {c: int((bi.blend_cut(inst, starts, grid_t, c).long()
                          < starts[1:].long()).sum()) for c in TRAIN_GRAPH_CUTOFFS}
        t_tiles = starts.shape[0] - 1
        del seen, inst
        graph_restore(tr, snap)
        tc = next((c for c in TRAIN_GRAPH_CUTOFFS if tr_cut[c] > 0), tc)
        if tc != TRAIN_GRAPH_CUTOFFS[0]:
            tr.set_render_cfg(dataclasses.replace(tr.render_cfg, t_cutoff=tc))
            ts1, aux1 = tr.train_step(tr.ts, frame)
            graph_restore(tr, snap)
        counters = zero_counts()
        scan = tr._maybe_scan_epoch()
        tr._load_scan_state(scan)
        scan.graph()
        torch.cuda.synchronize()
    wrapper = {k: c.launches for k, c in counters.items() if c.launches}
    diff = {f.name: float((getattr(scan.ts.params, f.name) - getattr(ts1.params, f.name))
                          .abs().max())
            for f in dataclasses.fields(ts1.params)}
    loss_same = float(scan.aux["loss"][0]) == float(aux1["loss"])
    same = loss_same and all(v == 0.0 for v in diff.values())
    ovf = int(scan.aux["overflow"][0]) + int(aux1["overflow"])
    log(f"[options] one Trainer step at t_cutoff {tc} (tiles each t_cutoff cuts on its "
        f"frame: {tr_cut} of {t_tiles}; float32 sums in a fixed order, "
        f"deterministic cuDNN), eager vs the graph's first replay: loss "
        f"{float(aux1['loss']):.8f} vs {float(scan.aux['loss'][0]):.8f}, bit-equal {same} "
        f"(largest parameter difference {max(diff.values()):.1e}), overflow {ovf}; wrapper "
        f"launches {wrapper}, per replay {scan.graph.launches_per_replay}; ops torch still "
        f"flagged nondeterministic: {flagged or 'none'}")
    check(same and ovf == 0 and tr_cut[tc] > 0, f"[options] the Trainer's graph step at "
          f"t_cutoff {tc} == eager, bit for bit, overflow 0, tiles cut")
    graph_restore(tr, snap)
    tr.tracking_enabled = tracking
    tr.set_render_cfg(keep_cfg)
    log(f"[options] phase total {time.perf_counter() - t_phase:.1f} s [{card}]")
    return {"binning_ms": bin_ms, "cutoff": cut_rows}


# ---------------------------------------------------------------------------
# [baselines]: the four baseline families through cli/train_baseline
# ---------------------------------------------------------------------------

BASELINES = ("gaussianavatars", "flashavatar", "splattingavatar", "monogaussianavatar")
# overrides that make each family's maintenance fire inside the runs' 12 + 12
# steps (the yamls' intervals never do): GA densifies at steps 6, 12, 18 and
# 24 (from step 4, every 6; a threshold of 0 selects every visible splat:
# the yaml's 1e-4 against the statistic's 2 / W scaling selects none on this
# data), SplattingAvatar walks every 6 steps. MonoGaussianAvatar's
# upsample runs after the CLI, at BASELINE_MONO_EPOCH.
BASELINE_EVERY, BASELINE_FROM = 6, 4
BASELINE_OVERRIDES = {
    "gaussianavatars": [f"training.densify_from_iter={BASELINE_FROM}",
                        f"training.densify_interval={BASELINE_EVERY}",
                        "training.densify_grad_threshold=0.0"],
    "flashavatar": [],
    "splattingavatar": [f"training.triangle_walk_interval={BASELINE_EVERY}"],
    "monogaussianavatar": [],
}
# an epoch past UPSAMPLE_SCHEDULE, a multiple of the upsample frequency: its
# target is max_points (100,000 in the yaml)
BASELINE_MONO_EPOCH = 60
# the test rows' tracking fit of Trainer.evaluate (its default optim_epoch)
EVAL_FIT = 50
# ``size_caps``' slack over a probe taken before any step: the splats grow
# as they train, and on the [cli] workspace (NVIDIA H100) FlashAvatar's grow
# from its init probe's 45,546 instances to 78,419 within 12 steps, which
# size_caps' own 1.08 and autosize_render_config's one-shot 1.5 both drop;
# 2x the init probe held over all the phase's steps, as did R at 2x the
# widest splat
GROWTH = {"safety": 2.0, "r_slack": 2.0}
# the in-plane displacement of the card's walk check, in this FLAME's units
# (its edges are ~5e-3 long)
WALK_UVD = 0.01


@contextmanager
def maintenance_events(events):
    """Record each call of the baselines' maintenance (GA's densify and
    prune, SplattingAvatar's walk, MonoGaussianAvatar's prune and upsample)
    with the alive splats before and after; syncs only there."""
    from fateavatar_tpu_torch.models.baselines import gaussianavatars as GA
    from fateavatar_tpu_torch.models.baselines import monogaussianavatar as MA
    from fateavatar_tpu_torch.models.baselines import splattingavatar as SA

    def densify(fn):
        def inner(params, state, *a, **kw):
            p, s, touched = fn(params, state, *a, **kw)
            events.append(("densify", int(state.alive.sum()), int(s.alive.sum()),
                           int(touched.sum())))
            return p, s, touched
        return inner

    def walk(fn):
        def inner(model, params, state):
            p, s = fn(model, params, state)
            moved = state.alive & (s.sample_fidxs != state.sample_fidxs)
            events.append(("walk", int(state.alive.sum()), int(moved.sum()),
                           float((s.sample_bary - state.sample_bary).abs().max())))
            return p, s
        return inner

    def upsample(fn):
        def inner(params, state, *a, **kw):
            p, s, touched = fn(params, state, *a, **kw)
            events.append(("upsample", int(state.alive.sum()),
                           int((state.alive & state.visible).sum()), int(s.alive.sum())))
            return p, s, touched
        return inner

    patched = [(GA, "densify_and_prune", densify), (SA, "walking_on_triangles", walk),
               (MA, "prune_and_upsample", upsample)]
    orig = [getattr(mod, name) for mod, name, _ in patched]
    for (mod, name, wrap), fn in zip(patched, orig):
        setattr(mod, name, wrap(fn))
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(patched, orig):
            setattr(mod, name, fn)


def flat_grads(g) -> dict:
    """{field or field.weight name: tensor} of a params dataclass whose
    fields may be dicts of tensors (the networks)."""
    out = {}
    for f in dataclasses.fields(g):
        v = getattr(g, f.name)
        out.update({f"{f.name}.{k}": x for k, x in v.items()} if isinstance(v, dict)
                   else {f.name: v})
    return out


def probe_views(tr, ts=None):
    """(most instances, most tiles a splat spans) over the training views:
    ``autosize.probe_gaussians`` on the splats the family's forward renders
    from ``ts`` (default the Trainer's own), with no gradient."""
    import torch

    from fateavatar_tpu_torch.models.baselines import flashavatar as FA
    from fateavatar_tpu_torch.models.baselines import gaussianavatars as GA
    from fateavatar_tpu_torch.models.baselines import monogaussianavatar as MA
    from fateavatar_tpu_torch.models.baselines import splattingavatar as SA
    from fateavatar_tpu_torch.render.autosize import probe_gaussians

    ts = ts or tr.ts
    mod = {"gaussianavatars": GA, "flashavatar": FA, "splattingavatar": SA,
           "monogaussianavatar": MA}[tr.adapter.name]
    counts, orig = [], mod.render

    def probing(camera, gaussians, *a, **kw):
        counts.append(probe_gaussians(camera, gaussians))
        return orig(camera, gaussians, *a, **kw)

    mod.render = probing
    try:
        with torch.no_grad():
            for i in range(len(tr.train_dataset)):
                f = tr._make_frame(tr.train_dataset.sample(i), cache=False)
                tr._forward(ts.params, ts.state, f.expression, f.flame_pose, f.camera)
    finally:
        mod.render = orig
    return max(c[0] for c in counts), max(c[1] for c in counts)


def render_caps(tr, upsample_epoch=None):
    """The render caps a Trainer's steps need, as ``render.*`` overrides ([]
    where the config's suffice): ``autosize.size_caps`` of what
    :func:`probe_views` measures, with the slack its training's growth
    needs (GROWTH), each cap overridden only where it exceeds the config's
    (the synthetic FLAME's crumpled faces stretch GA's face-bound splats,
    MonoGaussianAvatar's carry the init radius 0.084, 40% of this FLAME's
    head). The adapter closes over the render config, as the JAX package's
    does, so caps come from the command line and a Trainer that needs them
    is built again. ``upsample_epoch``: probe a copy of MonoGaussianAvatar's
    state through ``mono_epoch_maintenance`` at that epoch, the size its
    later steps reach (its generator restored after, so the upsample that
    follows draws the same)."""
    import torch

    from fateavatar_tpu_torch.render import binning
    from fateavatar_tpu_torch.render.autosize import size_caps
    from fateavatar_tpu_torch.train import baseline_steps as BS

    ts = tr.ts
    if upsample_epoch is not None:
        rng = ts.generator.get_state()
        ts = BS.mono_epoch_maintenance(ts, tr.model, upsample_epoch)
        ts.generator.set_state(rng)
    total, max_t = probe_views(tr, ts)
    cfg = tr.render_cfg
    grid = binning.tile_grid(tr.model.cfg.img_width, tr.model.cfg.img_height)
    # the splat slots: the rows of the params' first field
    n_slots = getattr(ts.params, dataclasses.fields(ts.params)[0].name).shape[0]
    default_m = cfg.instance_budget or min(4 * n_slots, n_slots * cfg.max_tiles_per_gaussian)
    sized = size_caps(total, max_t, n_slots, grid[0] * grid[1], cfg, **GROWTH)
    caps = {k: getattr(sized, k) for k, have in (("max_tiles_per_gaussian",
                                                   cfg.max_tiles_per_gaussian),
                                                  ("instance_budget", default_m))
            if getattr(sized, k) > have}
    alive = getattr(ts.state, "alive", None)
    n_alive = n_slots if alive is None else int(alive.sum())
    log(f"[baselines] {tr.adapter.name} probe at {n_alive} splats over "
        f"{len(tr.train_dataset)} training views: instances up to {total} "
        f"(budget {default_m}), tiles per splat up to {max_t} (R "
        f"{cfg.max_tiles_per_gaussian}, {grid[0] * grid[1]} tiles) -> size_caps "
        f"R {sized.max_tiles_per_gaussian}, budget {sized.instance_budget}")
    del ts
    torch.cuda.empty_cache()
    return [f"render.{k}={v}" for k, v in caps.items()]


def splat_walk(tr, card):
    """The triangle walk at full width on the card: the trained
    SplattingAvatar with a seeded in-plane uvd of std WALK_UVD committed by
    ``walking_on_triangles``: splats crossing into other faces, barycentrics
    on the simplex, dead rows unmoved, ms (host clock, synchronized)."""
    import torch

    from fateavatar_tpu_torch.models.baselines import splattingavatar as SA

    p, s = tr.ts.params, tr.ts.state
    gen = torch.Generator(device="cuda").manual_seed(0)
    xy = torch.randn(p.uvd[:, :2].shape, generator=gen, device="cuda") * WALK_UVD
    p = dataclasses.replace(p, uvd=torch.cat([xy, p.uvd[:, 2:]], dim=1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p2, s2 = SA.walking_on_triangles(tr.model, p, s)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    moved = int((s.alive & (s2.sample_fidxs != s.sample_fidxs)).sum())
    dead_still = bool((s2.sample_fidxs[~s.alive] == s.sample_fidxs[~s.alive]).all())
    simplex = float((s2.sample_bary[s.alive].sum(-1) - 1).abs().max())
    log(f"[baselines] splattingavatar walk of a seeded uvd.xy (std {WALK_UVD}) over "
        f"{int(s.alive.sum())} alive splats: {moved} crossed into another face, "
        f"|sum(bary) - 1| <= {simplex:.1e}, dead rows unmoved {dead_still}, uvd.xy zeroed "
        f"{bool((p2.uvd[:, :2] == 0).all())}; {ms:.3f} ms [{card}]")
    check(moved > 0 and dead_still and simplex < 1e-5 and bool((p2.uvd[:, :2] == 0).all()),
          "splattingavatar: the walk crosses faces, keeps barycentrics on the simplex")
    return {"moved": moved, "ms": ms}


def blend_float64(inst, starts, bg, grid):
    """render()'s instance blend through the plain versions in float64
    (inputs cast up, outputs and gradients cast back to float32): the
    yardstick both float32 blends are read against."""
    import torch

    from fateavatar_tpu_torch.render import blend_instances as bi

    class Float64Blend(torch.autograd.Function):
        @staticmethod
        def forward(ctx, inst, bg):
            x = inst.double()
            s, e = starts[:-1].long(), starts[1:].long()
            img, t_final, _, _ = bi.blend_windows(x, x[9], s, e, bg.double(), grid, bi.CHUNK)
            ctx.save_for_backward(x, img, t_final)
            return img.float(), t_final.float()

        @staticmethod
        def backward(ctx, g_img, g_tfin):
            x, img, t_final = ctx.saved_tensors
            s, e = starts[:-1].long(), starts[1:].long()
            g_img = g_img.double()
            g = bi.backward_windows(x, x[9], s, e, img, t_final, g_img, g_tfin.double(), grid,
                                    bi.CHUNK, bi.ROW)
            return g.float(), torch.einsum("tdp,tp->d", g_img, t_final).float()

    return Float64Blend.apply(inst, bg)


def deep_cutoff_reading(tag, inst, starts, bg, grid, card):
    """Kernels 1 and 2 at t_cutoff 0 and 1e-3 on one training frame's deep
    lists (MonoGaussianAvatar at its timed size): ms per call (CUDA
    events), each launch's device ms (pass A's share of the walk), the cut
    pass's own ms and the columns the exit walks; the cutoff forward gated
    against the plain version as in [options]. A reading: how much of pass
    A's work lies past the point where a tile saturates."""
    import torch

    from fateavatar_tpu_torch.render import blend_instances as bi

    s, e = starts[:-1].long(), starts[1:].long()
    gen = torch.Generator(device="cuda").manual_seed(11)
    img0, tfin0 = bi.blend_instances(inst, starts, bg, grid)
    g_i = torch.randn(img0.shape, generator=gen, device="cuda")
    g_f = torch.randn(tfin0.shape, generator=gen, device="cuda")
    res = {}
    for c in (0.0, 1e-3):
        if c:
            img, tfin, cut, _, _, row = cutoff_forward(f"{tag} {c}", inst, starts, bg, grid, c)
            row["cut_ms"] = cuda_ms(lambda: bi.blend_cut(inst, starts, grid, c), reps=10)
        else:
            img, tfin, cut, row = img0, tfin0, None, {"columns": int((e - s).sum())}

        def fwd():
            return bi.blend_instances_fwd(inst, starts, bg, grid, cutoff=c)

        def bwd():
            return bi.blend_instances_bwd(inst, starts, bg, img, tfin, g_i, g_f, grid, cut=cut)

        row.update(fwd_ms=cuda_ms(fwd, reps=10), bwd_ms=cuda_ms(bwd, reps=10),
                   fwd_split=segment_split(f"{tag} kernel 1 at t_cutoff {c}", fwd, card),
                   bwd_split=segment_split(f"{tag} kernel 2 at t_cutoff {c}", bwd, card))
        for d in ("fwd", "bwd"):
            split = row[f"{d}_split"]
            row[f"{d}_pass_a_share"] = sum(v for k, v in split.items()
                                           if k.endswith(f"{d}_products")) / sum(split.values())
        res[str(c)] = row
    a, b = res["0.0"], res["0.001"]
    log(f"{tag} the early exit on frame 0's lists ({a['columns']} instances, the deepest tile "
        f"{int((e - s).max())}): t_cutoff 0 -> 1e-3: kernel 1 {a['fwd_ms']:.4f} -> "
        f"{b['fwd_ms']:.4f} ms (pass A's share {a['fwd_pass_a_share']:.1%} -> "
        f"{b['fwd_pass_a_share']:.1%}), kernel 2 {a['bwd_ms']:.4f} -> {b['bwd_ms']:.4f} ms "
        f"(pass A {a['bwd_pass_a_share']:.1%} -> {b['bwd_pass_a_share']:.1%}); the cut pass "
        f"alone {b['cut_ms']:.4f} ms; columns walked {b['columns']} of {a['columns']} "
        f"({b['columns'] / max(a['columns'], 1):.1%}), {b['tiles_cut']} tiles cut, "
        f"{b['tiles_off']} cut elsewhere than the plain version ({b['tiles_near']} within "
        f"margin {CUT_MARGIN}), forward err {b['fwd_err']:.2e} (CUDA events, 10 calls) [{card}]")
    return res


def baseline_family(fam, cli, bws, card):
    """One family: cli/train_baseline --epochs 1 (its main without the
    evaluation: parse_args, build_trainer, train), then main itself with
    --resume --epochs 2 and the test evaluation; the gates; then
    (MonoGaussianAvatar) the upsample to max_points; ms per eager step with
    and without tracking; one step's gradients with the kernels against the
    plain blends at that size. Returns the family's summary and its
    launches."""
    import numpy as np
    import torch

    from fateavatar_tpu_torch.cli import train_baseline
    from fateavatar_tpu_torch.render import blend_instances as bi
    from fateavatar_tpu_torch.train import baseline_steps as BS
    from fateavatar_tpu_torch.train.trainer import Trainer
    from fateavatar_tpu_torch.utils.png import read_png

    t_fam = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tag = f"[baselines] {fam}"
    yaml = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", f"{fam}.yaml")
    args = ["--model", fam, "--config", yaml, "--device", "cuda",
            f"dataset.root_path={cli.root}", *cli.assets[:2], f"workspace={bws}",
            *BASELINE_OVERRIDES[fam]]
    # ---- the first run's Trainer, probed as built; built again with the
    # caps where it needs them
    t0 = time.perf_counter()
    tr = train_baseline.build_trainer(train_baseline.parse_args(["--epochs", "1", *args]))
    caps = render_caps(tr)
    if caps:
        del tr
        torch.cuda.empty_cache()
        args += caps
        tr = train_baseline.build_trainer(train_baseline.parse_args(["--epochs", "1", *args]))
    over = [*BASELINE_OVERRIDES[fam], *caps]
    log(f"{tag} overrides: {over} (probe and build {time.perf_counter() - t0:.1f} s)")
    names = ("train_epoch", "optimize_tracking", "evaluate")
    launches = {"blend_instances_fwd": 0, "blend_instances_bwd": 0}
    events, runs = [], []
    with maintenance_events(events):
        for epochs, extra in ((1, []), (2, ["--resume"])):
            record = []
            # ---- the baseline CLI: counts to 0 just before, read just after
            bi.blend_instances.launches = 0
            bi.blend_instances_bwd.launches = 0
            t0 = time.perf_counter()
            with counted(Trainer, names, record):
                if extra:
                    tr = train_baseline.main(["--epochs", str(epochs), *extra, *args])
                else:
                    tr.train(epochs)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            fwd, bwd = bi.blend_instances.launches, bi.blend_instances_bwd.launches
            launches["blend_instances_fwd"] += fwd
            launches["blend_instances_bwd"] += bwd
            runs.append(tr)
            rec = {n: [r for r in record if r[0] == n] for n in names}
            steps, n_test = len(tr.train_dataset), len(tr.test_dataset)
            ep = rec["train_epoch"][0]
            stats = tr.last_epoch_stats
            log(f"{tag} run {len(runs)} (--epochs {epochs}{' --resume' if extra else ''}): "
                f"{run_s:.1f} s; epoch {tr.epoch} per-step loss "
                f"{[round(x, 5) for x in tr.epoch_losses]}; mean {stats['loss']:.5f}, PSNR "
                f"{stats['psnr']:.3f}, alive {stats['alive']}, overflow {stats['overflow']}; "
                f"launches per step forward {ep[1] / steps:g}, backward {ep[2] / steps:g} "
                f"(train step + tracking step); in all {fwd} forward, {bwd} backward")
            check(all(np.isfinite(tr.epoch_losses)) and len(tr.epoch_losses) == steps,
                  f"{fam}: finite loss every step")
            if stats["overflow"]:
                log(f"{tag} overflow: the probe over the training views now counts up to "
                    f"{probe_views(tr)[0]} instances; budget {tr.render_cfg.instance_budget}")
            check(stats["overflow"] == 0, f"{fam}: overflow {stats['overflow']}")
            check(ep[1] == ep[2] == 2 * steps, f"{fam}: a step launches kernels 1 and 2 "
                  "twice (the train step, then the tracking step)")
            if not extra:
                check(not rec["evaluate"] and fwd == bwd == 2 * steps,
                      f"{fam}: launch totals of run 1 (no evaluation)")
                continue
            opt, ev = rec["optimize_tracking"][0], rec["evaluate"][0]
            log(f"{tag} run 2: optimize_tracking {opt[1]} / {opt[2]} launches, evaluate "
                f"{ev[1] - opt[1]} forward, {ev[3]:.1f} s")
            check(opt[1] == opt[2] == EVAL_FIT * n_test and ev[1] - opt[1] == n_test
                  and ev[2] == opt[2], f"{fam}: the test rows' fit and one eval forward "
                  "per test frame")
            check(fwd == 2 * steps + (EVAL_FIT + 1) * n_test
                  and bwd == 2 * steps + EVAL_FIT * n_test, f"{fam}: launch totals of run 2")
            media = os.path.join(bws, f"baseline_{fam}", "media")
            with open(os.path.join(media, "metrics", f"test_epoch{epochs}.json")) as fh:
                summary = json.load(fh)["summary"]
            video = [f for f in (f"test_epoch{epochs}.mp4", f"test_epoch{epochs}.gif")
                     if os.path.exists(os.path.join(media, "eval_videos", f))]
            frame0 = os.path.join(media, "eval_images", f"test_epoch{epochs}_frame0.png")
            check(all(np.isfinite(v) for v in summary.values()) and len(video) == 1
                  and read_png(frame0).shape == (tr.model.cfg.img_height,
                                                  2 * tr.model.cfg.img_width, 3),
                  f"{fam}: eval metrics and media of run 2")
            log(f"{tag} run 2: eval psnr {summary['psnr']:.4f} ssim "
                f"{summary['ssim']:.4f} l1 {summary['l1']:.5f}; media "
                f"metrics/test_epoch{epochs}.json, eval_videos/{video[0]}, "
                f"eval_images/test_epoch{epochs}_frame0.png")
    tr = runs[1]
    first, last = runs[0].last_epoch_stats["loss"], tr.last_epoch_stats["loss"]
    check(tr.global_step == tr.ts.step == 2 * steps and tr.epoch == 2,
          f"{fam}: resumed from step {steps} to {2 * steps}")
    check(last < first, f"{fam}: epoch mean loss {first:.5f} -> {last:.5f} falls")
    for ev in events:
        log(f"{tag} {ev[0]}: " + {
            "densify": "alive {1} -> {2}, {3} slots written",
            "walk": "alive {1}, {2} splats crossed into another face, largest barycentric "
                    "change {3:.3f}",
            "upsample": "alive {1}, visible {2}, -> {3}"}[ev[0]].format(*ev))
    due = [k for k in range(1, 2 * steps + 1) if k % BASELINE_EVERY == 0]
    if fam == "gaussianavatars":
        due = [k for k in due if k >= BASELINE_FROM]
        check(len(events) == len(due) and all(ev[2] > ev[1] for ev in events),
              f"{fam}: densify at steps {due} adds splats")
    if fam == "splattingavatar":
        # the forward reads uvd.z only (splattingavatar.py:224 of the JAX
        # package), so uvd.xy gets no gradient and these walks commit nothing
        check(len(events) == len(due) and all(ev[2] == 0 for ev in events),
              f"{fam}: the walk at steps {due}, with nothing to commit")
        out_walk = splat_walk(tr, card)

    out = {"first_epoch_loss": first, "last_epoch_loss": last, "alive": tr._alive(),
           "eval_psnr": summary["psnr"], "overrides": over}
    if fam == "splattingavatar":
        out["walk"] = out_walk
    if fam == "monogaussianavatar":
        # ---- the upsample to max_points, then steps at that size: the caps
        # of that size, on a Trainer built with them that resumes run 2
        caps = render_caps(tr, BASELINE_MONO_EPOCH)
        if caps:
            over += caps
            log(f"{tag} overrides at {tr.model.cfg.max_points} points: {caps}")
            del tr, runs
            torch.cuda.empty_cache()
            tr = train_baseline.build_trainer(train_baseline.parse_args(
                ["--epochs", "2", *args, *caps]))
            tr.load_checkpoint()
        events.clear()
        with maintenance_events(events):
            tr.ts = BS.mono_epoch_maintenance(tr.ts, tr.model, BASELINE_MONO_EPOCH)
        check(tr._alive() == tr.model.cfg.max_points,
              f"{fam}: upsampled to max_points ({tr._alive()})")
        log(f"{tag} mono_epoch_maintenance(epoch {BASELINE_MONO_EPOCH}): alive {events[0][1]}, "
            f"visible {events[0][2]} -> {events[0][3]}; radius now "
            f"{float(tr.ts.state.radius):.5f}")
    # ---- ms per eager step: an epoch with tracking, then one without (the
    # maintenance that falls due runs in it)
    t_ms = {}
    for label, enabled in (("with tracking", True), ("without tracking", False)):
        tr.tracking_enabled = enabled
        torch.cuda.synchronize()
        # ---- a timed epoch: counts to 0 just before, read just after
        bi.blend_instances.launches = 0
        bi.blend_instances_bwd.launches = 0
        t0 = time.perf_counter()
        tr.train_epoch()
        torch.cuda.synchronize()
        t_ms[label] = (time.perf_counter() - t0) * 1e3 / steps
        fwd, bwd = bi.blend_instances.launches, bi.blend_instances_bwd.launches
        launches["blend_instances_fwd"] += fwd
        launches["blend_instances_bwd"] += bwd
        per = 2 if enabled else 1
        check(fwd == bwd == per * steps, f"{fam}: {per} launch(es) of kernels 1 and 2 per "
              f"step {label} ({fwd}, {bwd} in {steps} steps)")
        check(tr.last_epoch_stats["overflow"] == 0 and np.isfinite(tr.last_epoch_stats["loss"]),
              f"{fam}: the timed epoch {label}: overflow 0, finite loss")
    tr.tracking_enabled = True
    out["alive"] = tr._alive()
    peak = torch.cuda.max_memory_allocated() / 2**30
    samples = [tr.train_dataset.sample(i) for i in range(3)]

    def step_and_track(i):
        sample = samples[i]
        frame = tr._make_frame(sample, tr.train_tables)
        tr.ts, _ = tr.train_step(tr.ts, frame)
        pose = np.asarray(sample["cam_pose"], np.float32)
        tr.train_tables, tr.train_track_state = tr._tracking_step(
            tr.train_tables, tr.train_track_state, sample["idx"],
            (pose[:3, :3].T, sample["fovx"], sample["fovy"], frame.rgb, tr.ts.state,
             tr.ts.params))

    prof = profile_top(f"{fam}: 3 train steps, each with its tracking step", step_and_track,
                       3, "step", card)
    out["profile"] = {k: v for k, v in prof.items() if k != "names"}
    log(f"{tag} ms/step {t_ms['with tracking']:.3f} with tracking, "
        f"{t_ms['without tracking']:.3f} without (an epoch of {steps} steps each, host clock, "
        f"synchronized, at {tr._alive()} alive); peak device memory {peak:.3f} GiB [{card}]")

    # the caps' margin at the end: the probe again over the training views
    total, max_t = probe_views(tr)
    budget = tr.render_cfg.instance_budget
    log(f"{tag} after the timed epochs: instances up to {total} of the budget "
        f"{budget or 'default'}" + (f" ({budget / total:.2f}x)" if budget else "")
        + f", tiles per splat up to {max_t} of R {tr.render_cfg.max_tiles_per_gaussian}")

    # ---- one step's gradients, kernels vs plain blends, at the size the
    # timed epochs ran (Mono's 100,000 points)
    frame = tr._make_frame(tr.train_dataset.sample(0), tr.train_tables)
    depth = []

    inputs = []

    def recording(inst, starts, bg, grid):
        depth.append((int(starts[-1]), int((starts[1:] - starts[:-1]).max())))
        inputs.append((inst.detach(), starts, bg.detach(), grid))
        return bi.blend_instances(inst, starts, bg, grid)

    with swapped_blend(recording):
        gk = tr.train_step.grads(tr.ts, frame)
    t0 = time.perf_counter()
    with swapped_blend(bi.blend_instances_plain):
        gp = tr.train_step.grads(tr.ts, frame)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    worst = []
    a, b = flat_grads(gk[0]), flat_grads(gp[0])
    if gk[1] is not None:
        a["probe"], b["probe"] = gk[1], gp[1]
    for k in a:
        x, y = a[k], b[k]
        check(torch.equal(torch.isnan(x), torch.isnan(y)), f"{fam}: NaN gradients at the "
              f"same elements of {k}")
        ok = ~torch.isnan(y)
        x, y = x[ok], y[ok]
        if y.numel() == 0 or float(y.abs().max()) == 0.0:
            check(x.numel() == 0 or float(x.abs().max()) == 0.0, f"{fam}: gradient {k} one side 0")
            continue
        l2, mx = float((x - y).norm() / y.norm()), float((x - y).abs().max() / y.abs().max())
        worst.append((k, l2, mx))
        check(l2 <= STEP_RTOL_L2 and mx <= STEP_RTOL_MAX,
              f"{fam}: step gradient {k} kernels vs plain rel L2 {l2:.2e}, max {mx:.2e}")
    top = sorted(worst, key=lambda w: -w[1])[:6]
    log(f"{tag} one step at {tr._alive() or 'all'} splats, kernels vs plain blends: frame "
        f"0's {depth[0][0]} instances, the deepest tile {depth[0][1]}; loss "
        f"{gk[3]['loss'].item():.7f} vs {gp[3]['loss'].item():.7f}; {len(worst)} gradient "
        f"tensors, the largest rel L2 / max: "
        + ", ".join(f"{k} {l2:.1e}/{mx:.1e}" for k, l2, mx in top)
        + f"; the plain step {plain_s:.2f} s")
    # ---- the same step with the blends in float64 (a reading, no gate):
    # how far each float32 blend's gradients are from it
    with swapped_blend(blend_float64):
        g64 = flat_grads(tr.train_step.grads(tr.ts, frame)[0])
    far = {}
    for side, g in (("kernels", a), ("plain", b)):
        rel = [(k, float((g[k] - g64[k]).nan_to_num().norm() / g64[k].nan_to_num().norm()))
               for k in g64 if float(g64[k].nan_to_num().norm()) > 0.0]
        far[side] = max(rel, key=lambda r: r[1])
    log(f"{tag} the same step with the blends in float64: the largest gradient rel L2 from "
        f"it, kernels {far['kernels'][1]:.2e} ({far['kernels'][0]}), plain float32 "
        f"{far['plain'][1]:.2e} ({far['plain'][0]})")
    out["float64_rel_l2"] = {side: r[1] for side, r in far.items()}
    if fam == "monogaussianavatar":
        out["cutoff"] = deep_cutoff_reading(tag, *inputs[0], card)
    torch.cuda.empty_cache()
    out.update(ms_step_tracking=t_ms["with tracking"], ms_step=t_ms["without tracking"],
               peak_gib=peak, worst_rel_l2=max(w[1] for w in worst), launches=launches,
               grads_instances=depth[0][0], grads_deepest_tile=depth[0][1],
               seconds=time.perf_counter() - t_fam)
    return out


def baselines_phase(cli, rows, card):
    """The four baseline families through ``cli/train_baseline`` at the yamls'
    sizes on the ``[cli]`` IMAvatar workspace (12 + 4 frames at 512x512,
    tracking on); their launches are added to kernels 1 and 2's."""
    import torch

    t_phase = time.perf_counter()
    bws = os.path.join(os.path.dirname(cli.run), "baselines")
    summary = {}
    for fam in BASELINES:
        summary[fam] = baseline_family(fam, cli, bws, card)
        torch.cuda.empty_cache()
    for name in ("blend_instances_fwd", "blend_instances_bwd"):
        by_family = {f: s["launches"][name] for f, s in summary.items()}
        rows[name]["launches"] += sum(by_family.values())
        rows[name]["launches_baselines"] = by_family
    log(f"[baselines] phase total {time.perf_counter() - t_phase:.1f} s [{card}]")
    log("[baselines] summary " + json.dumps(summary))
    return summary


# ---------------------------------------------------------------------------
# [lpips]: LPIPS on the card, its meter, and a full-width step with the
# LPIPS and normal-consistency terms
# ---------------------------------------------------------------------------

LPIPS_RTOL = 1e-4         # LPIPS on the card vs the CPU, relative
LPIPS_WEIGHT = 0.1        # the step's two extra terms (the yaml weights them 0)
NORMAL_WEIGHT = 0.01
LPIPS_FRAMES = 8          # frames of the phase's two Trainers
# the lpips package's state-dict layout: (slice, index in features) per conv
LPIPS_ALEX_KEYS = ((1, 0), (2, 3), (3, 6), (4, 8), (5, 10))


def lpips_state_dict(seed):
    """A seeded full LPIPS(alex) state dict in the ``lpips`` package's key
    layout (``net.slice{k}.{i}.weight``, ``lin{k}.model.1.weight``)."""
    import numpy as np
    import torch

    from fateavatar_tpu_torch.train.lpips import _conv_specs

    rng = np.random.default_rng(seed)
    specs, _, chans = _conv_specs("alex")
    sd = {}
    for (out, cin, k, _, _), (sl, i) in zip(specs, LPIPS_ALEX_KEYS):
        sd[f"net.slice{sl}.{i}.weight"] = torch.tensor(
            rng.normal(size=(out, cin, k, k)).astype(np.float32) * np.sqrt(2.0 / (cin * k * k)))
        sd[f"net.slice{sl}.{i}.bias"] = torch.zeros(out)
    for k, c in enumerate(chans):
        sd[f"lin{k}.model.1.weight"] = torch.tensor(
            np.abs(rng.normal(size=(1, c, 1, 1))).astype(np.float32) / c)
    return sd


def lpips_phase(s, ws, rows, card):
    """LPIPS alex and vgg at 512x512 on the card against the CPU; the LPIPS
    meter from a seeded full-layout .pth in ``Trainer.evaluate``; then the
    yaml's loss with LPIPS (vgg, random weights) and normal consistency
    added, at full width: a per-step epoch and the scan epoch's graph
    against eager steps (graph_train), each beside the same Trainer without
    the two terms."""
    import numpy as np
    import torch

    from fateavatar_tpu_torch.cli import common
    from fateavatar_tpu_torch.train import lpips as lp
    from fateavatar_tpu_torch.train.losses import FateAvatarLoss
    from fateavatar_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    dev = "cuda"
    rng = np.random.default_rng(11)
    imgs = [torch.from_numpy(rng.random((s.h, s.w, 3)).astype(np.float32)) for _ in range(2)]
    on_card = [x.to(dev) for x in imgs]
    params = {}
    for i, backbone in enumerate(("alex", "vgg")):
        p = lp.lpips_random_params(torch.Generator(device=dev).manual_seed(20 + i), backbone,
                                   device=dev)
        params[backbone] = p
        cpu = lp.LpipsParams(backbone, [(w.cpu(), b.cpu()) for w, b in p.convs],
                             [x.cpu() for x in p.lins])
        with torch.no_grad():
            d_card = float(lp.lpips_distance(p, *on_card))
            t0 = time.perf_counter()
            d_cpu = float(lp.lpips_distance(cpu, *imgs))
            cpu_s = time.perf_counter() - t0
            ms = cuda_ms(lambda: lp.lpips_distance(p, *on_card), reps=10)
        rel = abs(d_card - d_cpu) / abs(d_cpu)
        log(f"[lpips] {backbone} on two {s.h}x{s.w} frames: card {d_card:.7f}, CPU "
            f"{d_cpu:.7f} (rel {rel:.1e}, bound {LPIPS_RTOL}); {ms:.3f} ms a distance on "
            f"the card (CUDA events, 10 calls, no grad, TF32 off), {cpu_s * 1e3:.0f} ms "
            f"on the host's CPU [{card}]")
        check(d_card > 0 and rel <= LPIPS_RTOL, f"LPIPS {backbone} card vs CPU")

    pth = os.path.join(ws, "lpips_alex_full.pth")
    torch.save(lpips_state_dict(12), pth)
    terms_cfg = dataclasses.replace(s.loss_cfg, lpips_weight=LPIPS_WEIGHT,
                                    normal_weight=NORMAL_WEIGHT)
    with_terms = FateAvatarLoss(terms_cfg, faces=s.model.faces, vgg_params=s.vgg,
                                lpips_params=params["vgg"])
    out = {}
    launches = {}
    for tag, loss_fn, weights in (("terms", with_terms, pth), ("base", s.loss_fn, None)):
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(s.cfg.name, s.model, s.params, s.state, loss_fn, s.optimizer,
                     s.dataset(LPIPS_FRAMES, 0), s.test_ds, maint_cfg=s.maint, seed=s.cfg.seed,
                     render_cfg=common.render_config(s.cfg), lpips_weights_path=weights)
        counters = zero_counts()
        tr.epoch = 1
        tr.train_epoch()         # per step: fills the device frame cache
        launches[tag] = {k: c.launches for k, c in counters.items() if c.launches}
        losses = tr.epoch_losses
        check(len(losses) == LPIPS_FRAMES and all(np.isfinite(losses))
              and tr.last_epoch_stats["overflow"] == 0,
              f"[lpips] {tag}: finite losses, overflow 0")
        check(launches[tag] == {"blend_instances_fwd": LPIPS_FRAMES,
                                "blend_instances_bwd": LPIPS_FRAMES},
              f"[lpips] {tag}: one launch of kernels 1 and 2 a step")
        frame = tr._make_frame(tr.train_dataset.sample(0), cache=False)
        terms = tr.train_step.grads(tr.ts, frame)[3]
        log(f"[lpips] {tag}: loss terms of frame 0 "
            + ", ".join(f"{k} {float(v.detach()):.6f}" for k, v in terms.items())
            + f"; per-step losses {[round(x, 5) for x in losses]}; launches "
            f"{launches[tag]}")
        if tag == "terms":
            check(all(float(terms[k].detach()) > 0 for k in ("lpips_loss", "normal_loss")),
                  "[lpips] the LPIPS and normal terms are on")
            summary = tr.evaluate("test", save_media=False)
            log(f"[lpips] Trainer.evaluate with the LPIPS meter (alex, seeded .pth): "
                + " ".join(f"{k}={v:.5f}" for k, v in summary.items()))
            check(tr._lpips.available and "lpips" in summary
                  and np.isfinite(summary["lpips"]) and summary["lpips"] > 0,
                  "[lpips] the meter is available and finite in evaluate")
        out[tag] = graph_train(f"lpips-{tag}", tr, card, set())
        del tr
        torch.cuda.empty_cache()
    for name in ("blend_instances_fwd", "blend_instances_bwd"):
        rows[name]["launches"] += launches["terms"].get(name, 0)
        rows[name]["launches_lpips"] = launches["terms"].get(name, 0)
    t, b = out["terms"], out["base"]
    log(f"[lpips] ms/step with / without the LPIPS (vgg, 512x512) and normal terms "
        f"(host clock / CUDA events): graph {t['graph_ms'][0]:.3f} / {t['graph_ms'][1]:.3f} "
        f"vs {b['graph_ms'][0]:.3f} / {b['graph_ms'][1]:.3f}, eager {t['eager_ms'][0]:.3f} / "
        f"{t['eager_ms'][1]:.3f} vs {b['eager_ms'][0]:.3f} / {b['eager_ms'][1]:.3f}; peak "
        f"{t['peak_gib']:.3f} vs {b['peak_gib']:.3f} GiB; phase total "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    summary = {tag: {k: v for k, v in o.items() if k != "profile"} for tag, o in out.items()}
    log("[lpips] summary " + json.dumps(summary))
    return summary


# ---------------------------------------------------------------------------
# [nersemble]: cli/run_nersemble_benchmark on a synthetic export at full width
# ---------------------------------------------------------------------------

NERS_PARTICIPANT = "393"
NERS_SEQS = {"SEQ-1": 1.05, "SEQ-2": 0.95}     # sequence -> the tracking's scale
NERS_FRAMES = 12          # train-serial frames per sequence
NERS_EPOCHS = 3           # one per-step epoch, then scan epochs
NERS_NATIVE = (2200, 3208)                   # NeRSemble's native width, height
# native K: square pixels, the principal point off the centre
NERS_K = ((2600.0, 0.0, 1160.0), (0.0, 2600.0, 1524.0), (0.0, 0.0, 1.0))
NERS_YAWS = (0.0, -0.3, -0.15, 0.15, 0.3)    # the train serial, then the hold-outs


def write_nersemble_export(root, cfg):
    """A NeRSemble export at the yaml's width: one participant, NERS_SEQS
    with NERS_FRAMES frames each of FLAME2023 split tracking (codes std
    0.05, head rotations ~0.05, translations ~0.01, the scales of
    NERS_SEQS, n_shape 300 and n_exp 100 by default), the train serial and
    four hold-outs at NERS_YAWS, K at 2200x3208 (rescaled per axis to the
    working size). The train serial's images are renders of a perturbed
    copy of the avatar the CLI will build, through the kernels, with K and
    each frame's world transform, at binning caps probed over every frame
    of every serial (``autosize_render_config``: 1.5x the instances, R 2x
    the widest splat's tiles, rounded up to a power of 2). Returns the
    dataset of the train serial and the caps as ``render.*`` overrides
    where they exceed the config's (the hold-out renders use the config's
    caps, as in the JAX package)."""
    import numpy as np
    import torch

    from fateavatar_tpu_torch.benchmark import nersemble as tners
    from fateavatar_tpu_torch.cli import common
    from fateavatar_tpu_torch.flame.loader import load_flame_pickle, make_flame
    from fateavatar_tpu_torch.models.fateavatar import fateavatar_forward
    from fateavatar_tpu_torch.render.autosize import autosize_render_config
    from fateavatar_tpu_torch.train.step import Frame
    from fateavatar_tpu_torch.utils.obj_io import load_obj
    from fateavatar_tpu_torch.utils.png import write_png

    _tests_on_path()
    from torch_layouts import nersemble_frames, write_nersemble

    dev = "cuda"
    rng = np.random.default_rng(5)
    serials = (tners.DEFAULT_TRAIN_SERIAL, *tners.DEFAULT_HOLD_OUT_SERIALS)
    calib = {}
    for serial, yaw in zip(serials, NERS_YAWS):
        w2c = np.eye(4)
        c, sn = np.cos(yaw), np.sin(yaw)
        w2c[:3, :3] = [[c, 0, sn], [0, 1, 0], [-sn, 0, c]]
        w2c[2, 3] = 0.4
        calib[serial] = (np.asarray(NERS_K), w2c)
    # the synthetic blendshapes are uncorrelated per vertex: a larger
    # identity shape crumples the mesh (ROADMAP "Synthetic expression scale")
    shape = rng.normal(size=300) * 0.005
    for seq, scale in NERS_SEQS.items():
        write_nersemble(root, NERS_PARTICIPANT, calib,
                        {seq: (nersemble_frames(rng, NERS_FRAMES, 100), {})}, shape,
                        write_png, native=NERS_NATIVE, scale=scale)
    ds = tners.NersembleBenchmarkDataset(root, NERS_PARTICIPANT, tners.DEFAULT_TRAIN_SERIAL,
                                         cfg.dataset.img_res)
    flame = make_flame(load_flame_pickle(cfg.assets.flame_model_path), n_shape=ds.n_shape,
                       n_exp=ds.n_exp, shape_params=ds.shape_params,
                       canonical_expression=ds.mean_expression,
                       canonical_pose=cfg.dataset.canonical_pose, device=dev)
    model, params, state = common.construct_model(
        cfg, flame, template=load_obj(cfg.assets.template_mesh_path), device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)

    def jitter(x, scale):
        return x + scale * torch.randn(x.shape, generator=gen, device=dev)

    target = dataclasses.replace(params, features_dc=jitter(params.features_dc, 0.8),
                                 opacity=jitter(params.opacity, 1.0),
                                 scaling=jitter(params.scaling, 0.1))
    h, w = cfg.dataset.img_res
    base = common.render_config(cfg)
    views = []
    for serial in serials:
        d = tners.NersembleBenchmarkDataset(root, NERS_PARTICIPANT, serial, (h, w))
        views += [Frame(expression=torch.as_tensor(d.expressions[i], device=dev),
                        flame_pose=torch.as_tensor(d.flame_pose[i], device=dev),
                        camera=d.camera(i, w, h, device=dev), rgb=None, bg_color=model.bg_color,
                        world_transform=torch.as_tensor(d.world_transforms[i], device=dev))
                  for i in range(len(d))]
    rcfg = autosize_render_config(model, target, state, views,
                                  dataclasses.replace(base, autosize=False),
                                  probe_views=len(views), log_fn=log)
    overrides = [f"render.{k}={getattr(rcfg, k)}"
                 for k in ("instance_budget", "max_tiles_per_gaussian")
                 if getattr(rcfg, k) > (getattr(base, k) or 4 * model.cfg.capacity)]
    covered = []
    for i, rec in enumerate(ds.records):
        wt = torch.as_tensor(ds.world_transforms[i], device=dev)
        with torch.no_grad():
            out = fateavatar_forward(model, target, state, torch.as_tensor(ds.expressions[i],
                                                                           device=dev),
                                     torch.as_tensor(ds.flame_pose[i], device=dev),
                                     ds.camera(i, w, h, device=dev), render_cfg=rcfg,
                                     world_transform=wt)
        check(int(out["overflow"]) == 0 and bool(torch.isfinite(out["rgb_image"]).all()),
              f"[nersemble] ground truth {rec.img_name}: finite, overflow 0")
        img = out["rgb_image"]
        covered.append(float((img.min(dim=-1).values < 0.95).float().mean()))
        os.makedirs(os.path.dirname(rec.image_path), exist_ok=True)
        write_png(rec.image_path, (img.clamp(0, 1) * 255).round().to(torch.uint8).cpu().numpy())
    log(f"[nersemble] export {root}: {len(NERS_SEQS)} sequences x {NERS_FRAMES} frames of "
        f"the train serial, {len(serials) - 1} hold-out serials; K at {NERS_NATIVE} rescaled "
        f"to {w}x{h}: fx {ds.K[0, 0]:.2f} fy {ds.K[1, 1]:.2f} cx {ds.K[0, 2]:.2f} cy "
        f"{ds.K[1, 2]:.2f} (fovx {ds.fovx:.4f}, fovy {ds.fovy:.4f}); ground truth the renders "
        f"of a perturbed avatar with K and the world transforms, covering "
        f"{min(covered):.1%}-{max(covered):.1%} of the pixels; caps probed over "
        f"{len(views)} views: budget {rcfg.instance_budget}, R {rcfg.max_tiles_per_gaussian}, "
        f"tail_k {rcfg.tail_k}; overrides {overrides}")
    check(min(covered) > 0.01, "[nersemble] the ground truth shows the head")
    return ds, overrides


def nersemble_phase(ws, cli, rows, card):
    """The NeRSemble benchmark through ``cli/run_nersemble_benchmark --epochs
    3`` on a synthetic export at the yaml's width (the [cli] phase's FLAME,
    template and random VGG16 weights): per-step epoch 1, scan epochs 2-3
    as CUDA graphs, then 2 sequences x 5 serials of hold-out renders
    through one graph per serial. Gates: launches, overflow, modes, the
    videos and their frames, a hold-out frame kernels vs plain, K and the
    world transform each moving the frame, one step's gradients kernels vs
    plain blends, and the scan epoch's graph against eager steps on these
    frames (graph_train). Its launches are added to kernels 1 and 2's."""
    import numpy as np
    import torch

    _tests_on_path()
    from torch_determinism import deterministic_sums

    from fateavatar_tpu_torch.benchmark import nersemble as tners
    from fateavatar_tpu_torch.cli import run_nersemble_benchmark
    from fateavatar_tpu_torch.models.fateavatar import fateavatar_forward
    from fateavatar_tpu_torch.ops.camera import make_camera
    from fateavatar_tpu_torch.render import blend_instances as bi
    from fateavatar_tpu_torch.train.losses import FateAvatarLoss
    from fateavatar_tpu_torch.train.step import make_train_step
    from fateavatar_tpu_torch.train.trainer import Trainer
    from fateavatar_tpu_torch.utils.config import load_config
    from fateavatar_tpu_torch.utils.graphs import WARMUP

    t_phase = time.perf_counter()
    dev = "cuda"
    nws = os.path.join(ws, "nersemble")
    root, out_dir = os.path.join(nws, "export"), os.path.join(nws, "submission")
    args = [*cli.config, "--device", "cuda", *cli.assets, f"workspace={nws}/run"]
    cfg = load_config(cli.config[1], [a for a in args if "=" in a])
    h, w = cfg.dataset.img_res
    _, caps = write_nersemble_export(root, cfg)
    args += caps
    serials = (*tners.DEFAULT_HOLD_OUT_SERIALS, tners.DEFAULT_TRAIN_SERIAL)

    # each epoch's stats and each serial's render (its launches, seconds and
    # frames, synchronized around it) are recorded as the CLI runs
    renders, epochs = [], []
    orig_epoch, orig_render = Trainer.train_epoch, tners._render_sequence

    def train_epoch(self):
        orig_epoch(self)
        epochs.append(dict(self.last_epoch_stats))

    def render_sequence(*a, **kw):
        torch.cuda.synchronize()
        f0, b0, t = (counters["blend_instances_fwd"].launches,
                     counters["blend_instances_bwd"].launches, time.perf_counter())
        frames = orig_render(*a, **kw)
        torch.cuda.synchronize()
        renders.append((counters["blend_instances_fwd"].launches - f0,
                        counters["blend_instances_bwd"].launches - b0,
                        time.perf_counter() - t, len(frames)))
        return frames

    # ---- the main path: counts to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    counters = zero_counts()
    t0 = time.perf_counter()
    Trainer.train_epoch, tners._render_sequence = train_epoch, render_sequence
    try:
        (tr,) = run_nersemble_benchmark.main(
            ["--root", root, "--participants", NERS_PARTICIPANT, "--epochs",
             str(NERS_EPOCHS), "--out", out_dir, *args])
    finally:
        Trainer.train_epoch, tners._render_sequence = orig_epoch, orig_render
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items() if c.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = len(tr.train_dataset)
    n_videos = len(NERS_SEQS) * len(serials)
    log(f"[nersemble] run_nersemble_benchmark --epochs {NERS_EPOCHS}: {run_s:.1f} s; epochs "
        + "; ".join(f"{e['epoch']} {e['mode']} loss {e['loss']:.5f} psnr {e['psnr']:.3f} "
                    f"overflow {e['overflow']} {e['its']:.1f} it/s" for e in epochs)
        + f"; launches by the wrappers {launches}; caps R {tr.render_cfg.max_tiles_per_gaussian}"
        f" budget {tr.render_cfg.instance_budget}; peak device memory {peak:.3f} GiB [{card}]")
    check([e["mode"] for e in epochs] == ["per-step"] + ["scan"] * (NERS_EPOCHS - 1),
          "[nersemble] one per-step epoch, then scan epochs")
    check(all(np.isfinite(e["loss"]) and e["overflow"] == 0 for e in epochs),
          "[nersemble] finite losses, overflow 0 in every epoch")
    check(epochs[-1]["loss"] < epochs[0]["loss"], "[nersemble] the loss falls")
    per_render = WARMUP + 1
    check(launches == {"blend_instances_fwd": n + per_render + n_videos * per_render,
                       "blend_instances_bwd": n + per_render},
          "[nersemble] launches: the per-step epoch, the scan graph's warm-up and "
          "capture, each serial's render graph's warm-up and capture")
    check(len(renders) == n_videos and all(r[1] == 0 and r[0] == per_render for r in renders),
          "[nersemble] one render graph per sequence x serial")
    check(all(r[3] == NERS_FRAMES for r in renders), "[nersemble] every frame rendered")
    ms_frame = [r[2] * 1e3 / r[3] for r in renders]

    # ---- the videos: the card has no ffmpeg, so GIFs with every frame
    from PIL import Image

    counts = {}
    for seq in NERS_SEQS:
        for serial in serials:
            stem = os.path.join(out_dir, NERS_PARTICIPANT, seq, f"cam_{serial}")
            if os.path.exists(stem + ".mp4"):
                counts[f"{seq}/{serial}"] = "mp4"
                continue
            with Image.open(stem + ".gif") as im:
                counts[f"{seq}/{serial}"] = (im.n_frames, im.size)
    log(f"[nersemble] videos (frames, size): {counts}")
    check(len(counts) == n_videos and all(v == "mp4" or v == (NERS_FRAMES, (w, h))
                                          for v in counts.values()),
          "[nersemble] one video per sequence x serial with every frame")

    # ---- one hold-out frame: kernels vs plain, K and the world transform
    ds = tners.NersembleBenchmarkDataset(root, NERS_PARTICIPANT,
                                         tners.DEFAULT_HOLD_OUT_SERIALS[0], (h, w),
                                         sequence_list=[list(NERS_SEQS)[1]], mode="test")
    params, state = tr.ts.params, tr.ts.state
    e0, p0 = (torch.as_tensor(x[0], device=dev) for x in (ds.expressions, ds.flame_pose))
    wt0 = torch.as_tensor(ds.world_transforms[0], device=dev)
    cam = ds.camera(0, w, h, device=dev)
    rcfg = tr.render_cfg

    def frame(camera=cam, wt=wt0):
        with torch.no_grad():
            return fateavatar_forward(tr.model, params, state, e0, p0, camera,
                                      render_cfg=rcfg, world_transform=wt)

    out_k = frame()
    with swapped_blend(bi.blend_instances_reference):
        img_p = frame()["rgb_image"]
    img_k = out_k["rgb_image"]
    err = float((img_k - img_p).abs().max())
    rows["blend_instances_fwd"]["max_abs_err"] = max(rows["blend_instances_fwd"]["max_abs_err"],
                                                     err)
    w2c = ds.world_mats[0]
    centred = make_camera(w2c[:3, :3].T, w2c[:3, 3], ds.fovx, ds.fovy, w, h, device=dev)
    moved_k = float((frame(camera=centred)["rgb_image"] - img_k).abs().max())
    moved_wt = float((frame(wt=torch.tensor([0, 0, 0, 0, 0, 0, 1.0], device=dev))
                      ["rgb_image"] - img_k).abs().max())
    e_ms = cuda_ms(lambda: frame(), reps=12)
    log(f"[nersemble] hold-out frame (serial {ds.serial}, {ds.records[0].img_name}): overflow "
        f"{int(out_k['overflow'])}, kernels vs plain blend max|diff| {err:.3e} (bound {TOL}); "
        f"a centred K moves it by {moved_k:.3e}, the identity world transform by "
        f"{moved_wt:.3e} (bound > 1e-3); hold-out ms/frame through the graphs "
        f"{min(ms_frame):.3f}-{max(ms_frame):.3f} (host clock per serial of {NERS_FRAMES} "
        f"frames, warm-up, capture and the host copies included), eager forward "
        f"{e_ms:.3f} (CUDA events, 12 calls) [{card}]")
    check(int(out_k["overflow"]) == 0 and err <= TOL, "[nersemble] hold-out frame kernels vs plain")
    check(moved_k > 1e-3 and moved_wt > 1e-3,
          "[nersemble] K and the world transform reach the frame")

    # ---- one step's gradients, kernels vs plain blends (float32 VGG,
    # deterministic cuDNN and every sum in a fixed order: only the blends
    # differ, and the same step twice agrees bit for bit)
    tframe = tr._make_frame(tr.train_dataset.sample(NERS_FRAMES + 1), cache=False)
    cmp_loss = FateAvatarLoss(dataclasses.replace(tr.loss_fn.cfg, vgg_dtype=None),
                              faces=tr.model.faces, vgg_params=tr.loss_fn.vgg_params)
    step = make_train_step(tr.model, cmp_loss, tr.optimizer, tr.maint_cfg, rcfg)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False), deterministic_sums() as flagged:
        gk = step.grads(tr.ts, tframe)
        gk2 = step.grads(tr.ts, tframe)
        with swapped_blend(bi.blend_instances_plain):
            gp = step.grads(tr.ts, tframe)
    repeat = rel_errors(gk2[0], gk2[1], gk[0], gk[1])
    log(f"[nersemble] the same step twice with the kernels, sums in a fixed order: "
        + ", ".join(f"{f} {l2:.1e}/{mx:.1e}" for f, l2, mx in repeat)
        + f"; ops torch still flagged as nondeterministic: {flagged}")
    check_step_grads("nersemble", "kernels vs plain blends", gk, gp)

    # ---- the scan epoch's graph against eager steps on these frames: a
    # per-step epoch refills the device frame cache, the graph is rebuilt
    tr._scan_disabled = True
    tr.epoch += 1
    tr.train_epoch()
    check(tr.last_epoch_stats["overflow"] == 0, "[nersemble] overflow 0 in the eager epoch")
    tr._scan_disabled = False
    tr.set_render_cfg(tr.render_cfg)
    g = graph_train("nersemble-graph", tr, card, set())
    for name in ("blend_instances_fwd", "blend_instances_bwd"):
        rows[name]["launches"] += launches.get(name, 0)
        rows[name]["launches_nersemble"] = launches.get(name, 0)
        rows[name].setdefault("graph_launches_per_replay", {})["nersemble-scan"] = \
            g["per_replay"].get(name, 0)
    log(f"[nersemble] phase total {time.perf_counter() - t_phase:.1f} s [{card}]")
    summary = {"run_s": run_s, "epochs": epochs, "launches": launches, "peak_gib": peak,
               "holdout_ms_frame": ms_frame, "eager_frame_ms": e_ms, "plain_err": err,
               "moved": {"K": moved_k, "world_transform": moved_wt}, "videos": len(counts),
               "graph": {k: v for k, v in g.items() if k != "profile"}}
    log("[nersemble] summary " + json.dumps(summary))
    return summary


# ---------------------------------------------------------------------------
# [parallel]: data parallel, the splat-sharded render and the 2-D mesh, in
# ranks spawned on the one card (NCCL at world 1, gloo when ranks share it)
# ---------------------------------------------------------------------------

PAR_DP_RTOL = 1e-6        # the DP loss against the one-process batched loss
PAR_GRAD_RL2 = 1e-2       # gradients, relative L2 by field (the atomics' order)
PAR_NOISE = 1e-3          # a field whose reference moves more than this between two
                          # runs of itself is at the atomics' noise floor: not gated
PAR_IMG_ATOL = 2e-4       # the sharded image against render(kernel="tiles")
PAR_BWD_RTOL = 1e-3       # its gradients, of each field's largest
PAR_MESH_RTOL = 2e-4      # the 2-D mesh loss (tests/test_splat_parallel.py's bound)
PAR_TIMED = 3             # timed steps / frames of each path
PAR_MAINT = {"densify_interval": 2, "prune_interval": 2, "increase_num": 1000}
PAR_FIELDS = ("xyz", "scaling", "rotation", "opacity", "features_dc")
PAR_TIMEOUT_S = 300       # a collective that waits longer fails the rank


def _par_rank(rank, world, backend, store, tasks, out):
    """One spawned rank: the process group over ``store``, then each task,
    its results saved for the parent."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=PAR_TIMEOUT_S))
    try:
        res = {name: globals()[name](rank, world, **kw) for name, kw in tasks}
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def par_spawn(tasks, world, backend, ws):
    """Run ``tasks`` ([(function name, kwargs)]) in ``world`` ranks on the
    card; returns (each rank's results, wall seconds). A rank that fails
    fails the call (the others are stopped)."""
    import torch
    import torch.multiprocessing as mp

    out = tempfile.mkdtemp(prefix=f"ranks{world}_", dir=ws)
    t0 = time.perf_counter()
    mp.start_processes(_par_rank, args=(world, backend, os.path.join(out, "store"), tasks,
                                        out), nprocs=world, start_method="spawn")
    wall = time.perf_counter() - t0
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)], wall


def _par_inputs(path):
    import torch

    return torch.load(path, weights_only=False, map_location="cuda:0")


def _par_launches():
    """The wrappers' launches since the last zero_counts()."""
    from fateavatar_tpu_torch.render.render import KERNEL_COUNTERS

    return {k: c.launches for k, c in KERNEL_COUNTERS.items() if c.launches}


def _par_timed(fn, n=PAR_TIMED):
    """Host milliseconds per call of ``fn`` over ``n`` synchronized calls."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def _summed_launches(res) -> dict:
    """Every rank's launches of a path, summed."""
    out = {}
    for r in res:
        for k, v in r["launches"].items():
            out[k] = out.get(k, 0) + v
    return out


def _cpu_fields(obj) -> dict:
    return {f.name: getattr(obj, f.name).detach().cpu() for f in dataclasses.fields(obj)}


def _field_gate(got: dict, want: dict, again: dict):
    """Each gradient field of ``got`` against the reference ``want``,
    relative L2, over the fields whose reference is not 0 and moves at most
    PAR_NOISE between two runs of itself (``again``): (errors by field,
    the reference's run-to-run noise by field, the fields skipped as
    noise). The gate fails if a per-splat field is skipped."""
    errs, noise, skipped = {}, {}, []
    for k, v in want.items():
        if float(v.double().norm()) == 0:
            continue
        noise[k] = rel_l2(again[k], v)
        if noise[k] > PAR_NOISE:
            skipped.append(k)
        else:
            errs[k] = rel_l2(got[k], v)
    return errs, noise, skipped


def _field_gate_ok(errs: dict, skipped: list) -> bool:
    from fateavatar_tpu_torch.models.maintenance import SPLAT_FIELDS

    return (all(e <= PAR_GRAD_RL2 for e in errs.values())
            and not set(skipped) & set(SPLAT_FIELDS))


def _fmt(d: dict) -> str:
    return json.dumps({k: f"{v:.1e}" for k, v in d.items()})


def par_dp_step(rank, world, inputs, frames):
    """make_dp_train_step with the kernels, every rank one of ``frames``:
    its loss and all-reduced gradients, the replicas' digests after the
    step, after a step that densifies and prunes, and after a densify from
    generators seeded apart on the ranks (the replicas take rank 0's
    draws), launches, ms/step."""
    import torch

    from fateavatar_tpu_torch.parallel.data_parallel import (
        make_device_mesh, make_dp_train_step, state_digest)
    from fateavatar_tpu_torch.train.step import MaintenanceConfig, init_train_state

    d = _par_inputs(inputs)
    mesh = make_device_mesh(world, device="cuda")
    frame = d["frames"][frames[rank]]
    ts = init_train_state(d["params"], d["state"], d["optimizer"], 0)
    none = MaintenanceConfig(densify_interval=10**9, prune_interval=10**9,
                             opacity_reset_interval=10**9)
    step = make_dp_train_step(d["model"], d["loss_fn"], d["optimizer"], mesh, none,
                              d["render_cfg"], return_grads=True)
    zero_counts()
    ts1, aux = step(ts, frame)
    torch.cuda.synchronize()
    launches = _par_launches()
    digests = [state_digest(ts1, mesh)]
    dstep = make_dp_train_step(d["model"], d["loss_fn"], d["optimizer"], mesh,
                               dataclasses.replace(none, **PAR_MAINT), d["render_cfg"])
    alive = int(ts1.state.alive.sum())
    ts2, _ = dstep(ts1, frame)
    digests.append(state_digest(ts2, mesh))
    ts2.generator.manual_seed(1000 + rank)
    apart = make_dp_train_step(d["model"], d["loss_fn"], d["optimizer"], mesh,
                               dataclasses.replace(none, densify_interval=1,
                                                   increase_num=PAR_MAINT["increase_num"]),
                               d["render_cfg"])
    ts3, _ = apart(ts2, frame)
    digests.append(state_digest(ts3, mesh))
    box = [ts3]

    def again():
        box[0] = step(box[0], frame)[0]

    ms = _par_timed(again)
    return {"loss": float(aux["loss"]), "overflow": int(aux["overflow"]),
            "grads": _cpu_fields(aux["grads"]) if rank == 0 else None,
            "digests": digests,
            "alive": [alive, int(ts2.state.alive.sum()), int(ts3.state.alive.sum())],
            "launches": launches, "ms": ms, "backend": mesh.backend}


def par_shard_render(rank, world, inputs, caps):
    """render_splat_sharded with the kernels: this rank's shard of the
    frame's splats, the image, dropped, the gradients of
    sum(image * weights) / world w.r.t. the shard, launches, ms of a
    forward and backward."""
    import torch

    from fateavatar_tpu_torch.parallel.splat_parallel import render_splat_sharded

    d = _par_inputs(inputs)
    g0 = d["gaussians"]
    n = g0.xyz.shape[0] // world
    sl = slice(rank * n, (rank + 1) * n)

    def shard():
        leaves = {k: getattr(g0, k)[sl].clone().requires_grad_() for k in PAR_FIELDS}
        g = dataclasses.replace(g0, **leaves, features_rest=g0.features_rest[sl],
                                alive=g0.alive[sl])
        return g, leaves

    def run():
        g, leaves = shard()
        img, dropped = render_splat_sharded(d["camera"], g, d["bg"], **caps)
        (torch.sum(img * d["weights"]) / world).backward()
        return img, dropped, leaves

    zero_counts()
    img, dropped, leaves = run()
    torch.cuda.synchronize()
    launches = _par_launches()
    ms = _par_timed(run)
    return {"image": img.detach().cpu() if rank == 0 else None, "dropped": int(dropped),
            "grads": {k: v.grad.cpu() for k, v in leaves.items()}, "launches": launches,
            "ms": ms}


def par_mesh2d(rank, world, inputs, caps, loss_kw):
    """The 2x2 mesh step with the kernels and return_grads: loss, this
    rank's gradients, launches, ms/step."""
    import torch

    from fateavatar_tpu_torch.parallel.data_parallel import stack_frames
    from fateavatar_tpu_torch.parallel.mesh2d import (
        Mesh2D, make_mesh2d_train_step, place_mesh2d)
    from fateavatar_tpu_torch.train.step import init_train_state

    d = _par_inputs(inputs)
    mesh = Mesh2D(2, world // 2, "cuda:0")
    ts = place_mesh2d(init_train_state(d["params"], d["state"], d["optimizer"], 0), mesh)
    batch = stack_frames(d["frames"][:2])
    step = make_mesh2d_train_step(d["model"], d["optimizer"], mesh, return_grads=True,
                                  vgg_params=d["vgg"], **caps, **loss_kw)
    zero_counts()
    ts1, aux = step(ts, batch)
    torch.cuda.synchronize()
    launches = _par_launches()
    box = [ts1]

    def again():
        box[0] = step(box[0], batch)[0]

    ms = _par_timed(again)
    return {"loss": float(aux["loss"]), "overflow": int(aux["overflow"]),
            "grads": _cpu_fields(aux["grads"]), "coords": (mesh.d, mesh.g),
            "launches": launches, "ms": ms}


def par_cli(rank, world, argv):
    """cli/train_mono_avatar --dp world in this rank: the tracking counts,
    steps, the replicas' digest, launches, the epoch's ms/step."""
    import torch

    from fateavatar_tpu_torch.cli import train_mono_avatar
    from fateavatar_tpu_torch.parallel.data_parallel import make_device_mesh, state_digest
    from fateavatar_tpu_torch.train.trainer import Trainer

    zero_counts()
    record = []
    with counted(Trainer, ("train_epoch",), record):
        tr = train_mono_avatar.main(argv)
    torch.cuda.synchronize()
    mesh = make_device_mesh(world, device="cuda")
    ep = record[0]
    stats = tr.last_epoch_stats
    return {"counts": tr.train_track_state.count.cpu().tolist(),
            "global_step": tr.global_step, "step": tr.ts.step, "mode": stats["mode"],
            "losses": tr.epoch_losses, "overflow": stats["overflow"],
            "digest": state_digest((tr.ts, tr.train_tables, tr.train_track_state), mesh),
            "epoch_launches": {"blend_instances_fwd": ep[1], "blend_instances_bwd": ep[2]},
            "launches": _par_launches(), "epoch_s": ep[3]}


def par_flash(rank, world, argv):
    """FlashAvatar through cli/train_baseline's Trainer at data_parallel =
    world (caps probed as [baselines] probes them): one epoch; its losses,
    steps, the replicas' digest, launches."""
    import torch

    from fateavatar_tpu_torch.cli import train_baseline
    from fateavatar_tpu_torch.parallel.data_parallel import make_device_mesh, state_digest

    probe = train_baseline.build_trainer(train_baseline.parse_args(argv))
    caps = render_caps(probe)
    del probe
    torch.cuda.empty_cache()
    tr = train_baseline.build_trainer(train_baseline.parse_args([*argv, *caps]),
                                      data_parallel=world)
    zero_counts()
    t0 = time.perf_counter()
    tr.train(1)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    return {"losses": tr.epoch_losses, "global_step": tr.global_step,
            "overflow": tr.last_epoch_stats["overflow"], "caps": caps,
            "digest": state_digest(tr.ts, make_device_mesh(world, device="cuda")),
            "launches": _par_launches(), "epoch_s": epoch_s}


def _par_frames(s, idxs):
    """Frames of the [train] setup's training set (float ground truth) on
    the card."""
    import numpy as np
    import torch

    from fateavatar_tpu_torch.ops.camera import make_camera
    from fateavatar_tpu_torch.train.step import Frame

    out = []
    for i in idxs:
        smp = s.train_ds.sample(i)
        pose = np.asarray(smp["cam_pose"], np.float32)
        out.append(Frame(
            expression=torch.as_tensor(smp["expression"], dtype=torch.float32, device="cuda"),
            flame_pose=torch.as_tensor(smp["flame_pose"], dtype=torch.float32, device="cuda"),
            camera=make_camera(pose[:3, :3].T, pose[:3, 3], smp["fovx"], smp["fovy"], s.w, s.h,
                               device="cuda"),
            rgb=torch.as_tensor(np.asarray(smp["ground_truth"]["rgb"], np.float32),
                                device="cuda"),
            bg_color=torch.ones(3, device="cuda")))
    return out


def _par_shard_caps(camera, g, worlds):
    """The sharded render's caps for this frame, probed so nothing drops:
    R the most tiles a splat spans, K the longest tile's list (from a
    ``kernel="tiles"`` render at a K above it), each destination's send
    buffer the most instances one shard sends one owner, over ``worlds``."""
    import torch

    from fateavatar_tpu_torch.render import binning
    from fateavatar_tpu_torch.render.preprocess import preprocess

    grid = binning.tile_grid(camera.width, camera.height)
    with torch.no_grad():
        prep = preprocess(camera, g.xyz, g.get_scaling, g.get_rotation, g.get_opacity,
                          g.get_features, g.sh_degree, alive=g.alive)
        mx, my = prep.soa[:2]
        x0, y0, x1, y1 = binning.gaussian_rect(mx, my, prep.radius, grid)
        touched = torch.where(prep.visible, (x1 - x0) * (y1 - y0), 0)
        R = int(touched.max())
        # every (gaussian, tile) candidate's tile row
        r = torch.arange(R, device=mx.device)[None, :]
        w = torch.clamp_min(x1 - x0, 1)[:, None]
        rows = y0[:, None] + torch.div(r, w, rounding_mode="floor")
        ok = r < touched[:, None]
        counts = torch.zeros(grid[0] * grid[1], dtype=torch.int64, device=mx.device)
        cols = x0[:, None] + r % w
        counts.index_add_(0, (rows * grid[1] + cols)[ok].long(),
                          torch.ones_like(rows[ok], dtype=torch.int64))
        K = int(counts.max())
        n = g.xyz.shape[0]
        pair = {}
        for D in worlds:
            shard = (torch.arange(n, device=mx.device) // (n // D))[:, None].expand_as(rows)
            owner = rows // (grid[0] // D)
            per = torch.bincount((shard * D + owner)[ok].long(), minlength=D * D)
            pair[D] = int(per.max())
    return R, K, pair


def parallel_phase(s, trainer, cli, ws, rows, card):
    """[parallel]: the DP step at world 1 (NCCL) and world 2 (gloo, ranks
    sharing the card) against the one-process batched step; the replicas'
    digests; cli/train_mono_avatar --dp 2 with tracking and FlashAvatar's
    Trainer at data_parallel = 2 on the [cli] workspace; the sharded render
    at world 2 and 4 against render(kernel="tiles"); the 2x2 mesh step
    against the one-device loss and gradients. Launches per path go into
    the kernels' rows."""
    import numpy as np
    import torch

    from fateavatar_tpu_torch.models.fateavatar import build_gaussians, fateavatar_forward
    from fateavatar_tpu_torch.render.render import RenderConfig, render
    from fateavatar_tpu_torch.train.losses import vgg_perceptual_loss
    from fateavatar_tpu_torch.train.step import init_train_state, make_train_step

    t_phase = time.perf_counter()
    pws = tempfile.mkdtemp(prefix="parallel_", dir=ws)
    rcfg = trainer.render_cfg
    frames = _par_frames(s, range(2))
    model, state = s.model, s.state
    # the init's scales made anisotropic (seeded; each axis shrunk by its
    # own draw, so no splat covers more tiles), so that the rotations'
    # gradients are not 0 in the DP step and the 2-D mesh
    with torch.no_grad():
        shrink = torch.randn(s.params.scaling.shape, device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(7)).abs()
        params = dataclasses.replace(s.params, scaling=s.params.scaling - 0.3 * shrink)

    # ---- the one-process references, with the kernels, each twice (the
    # second run measures the atomics' noise floor of each field)
    ts = init_train_state(params, state, s.optimizer, 0)
    single = make_train_step(model, s.loss_fn, s.optimizer, s.maint, rcfg)
    ref_grads, ref_again, ref_loss = [], [], []
    for f in frames:
        for into in (ref_grads, ref_again):
            g, _, _, losses = single.grads(ts, f)
            into.append(_cpu_fields(g))
        ref_loss.append(float(losses["loss"].detach()))
    del ts, single
    # the sharded render: frame 0's splats, their scales made anisotropic
    # (seeded) so that the rotations' gradients are not 0; caps probed for
    # world 2 and 4
    f0 = frames[0]
    with torch.no_grad():
        g0 = build_gaussians(model, params, state, f0.expression, f0.flame_pose)[0]
        noise = torch.randn(g0.scaling.shape, generator=torch.Generator(device="cuda")
                            .manual_seed(6), device="cuda")
        g0 = dataclasses.replace(g0, scaling=g0.scaling + 0.3 * noise)
    R, K, pair = _par_shard_caps(f0.camera, g0, (2, 4))
    K = -(-K // 64) * 64
    tiles_cfg = RenderConfig(kernel="tiles", max_per_tile=K, max_tiles_per_gaussian=R)
    weights = torch.rand((s.h, s.w, 3), generator=torch.Generator(device="cuda").manual_seed(5),
                         device="cuda")
    leaves = {k: getattr(g0, k).clone().requires_grad_() for k in PAR_FIELDS}
    out = render(f0.camera, dataclasses.replace(g0, **leaves), f0.bg_color, config=tiles_cfg)
    torch.sum(out["render"] * weights).backward()
    ref_img = out["render"].detach()
    ref_shard_grads = {k: v.grad.detach() for k, v in leaves.items()}
    check(int(out["overflow"]) == 0, "[parallel] the reference render drops nothing")
    # the 2-D mesh: the yaml's L1, VGG and scale terms over frames 0 and 1
    mesh_loss = {"rgb_weight": s.loss_cfg.rgb_weight, "vgg_weight": s.loss_cfg.vgg_weight,
                 "scale_weight": s.loss_cfg.scale_weight,
                 "scale_threshold": s.loss_cfg.scale_threshold}
    R2, K2 = R, K
    with torch.no_grad():
        g1 = build_gaussians(model, params, state, frames[1].expression,
                             frames[1].flame_pose)[0]
    r1, k1, pair1 = _par_shard_caps(frames[1].camera, g1, (2,))
    R2, K2 = max(R2, r1), max(K2, -(-k1 // 64) * 64)
    mesh_caps = {"max_tiles_per_gaussian": R2, "max_per_tile": K2,
                 "pair_budget": max(pair[2], pair1[2]), "chunk": 64}
    mcfg = RenderConfig(kernel="tiles", max_per_tile=K2, max_tiles_per_gaussian=R2)

    def mesh_reference():
        mleaves = {f.name: getattr(params, f.name).clone().requires_grad_()
                   for f in dataclasses.fields(params)}
        mparams = dataclasses.replace(params, **mleaves)
        total = 0.0
        for f in frames:
            img = fateavatar_forward(model, mparams, state, f.expression, f.flame_pose,
                                     f.camera, bg_color=f.bg_color,
                                     render_cfg=mcfg)["rgb_image"]
            sc = torch.exp(mparams.scaling)
            ratio = sc.amax(-1) / sc.amin(-1).clamp_min(1e-12)
            reg = torch.sum(torch.where(state.alive, (ratio - mesh_loss["scale_threshold"])
                                        .clamp_min(0.0), 0.0)) / state.alive.shape[0]
            total = total + (mesh_loss["rgb_weight"] * torch.mean(torch.abs(img - f.rgb))
                             + mesh_loss["vgg_weight"] * vgg_perceptual_loss(s.vgg, img, f.rgb)
                             + mesh_loss["scale_weight"] * reg) / len(frames)
        grads = torch.autograd.grad(total, list(mleaves.values()))
        return dict(zip(mleaves, (x.detach().cpu() for x in grads))), float(total)

    mesh_ref_grads, mesh_ref_loss = mesh_reference()
    mesh_ref_again = mesh_reference()[0]

    inputs = os.path.join(pws, "inputs.pt")
    torch.save({"model": model, "params": params, "state": state, "optimizer": s.optimizer,
                "loss_fn": s.loss_fn, "render_cfg": rcfg, "frames": frames, "vgg": s.vgg,
                "gaussians": dataclasses.replace(g0, **{k: getattr(g0, k).detach()
                                                        for k in PAR_FIELDS}),
                "camera": f0.camera, "bg": f0.bg_color, "weights": weights}, inputs)
    torch.cuda.empty_cache()
    log(f"[parallel] references in one process (the kernels): frame losses "
        f"{[round(x, 6) for x in ref_loss]}; sharded-render caps R {R}, K {K}, send "
        f"buffers {pair}; 2-D mesh caps {mesh_caps}, loss {mesh_ref_loss:.7f} "
        f"({time.perf_counter() - t_phase:.1f} s)")

    cli_args = [*cli.config, "--device", "cuda", f"dataset.root_path={cli.root}",
                f"workspace={os.path.join(pws, 'cli_dp')}", *cli.assets,
                f"training.epochs.finetune={CLI_FINETUNE}", "training.snapshot_interval=6",
                *(f"training.{k}={v}" for k, v in MAINT_OVERRIDES.items())]
    flash_args = ["--model", "flashavatar", "--config",
                  os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                               "flashavatar.yaml"), "--device", "cuda",
                  f"dataset.root_path={cli.root}", *cli.assets[:2],
                  f"workspace={os.path.join(pws, 'flash_dp')}",
                  *BASELINE_OVERRIDES["flashavatar"]]
    shard = lambda D: dict(max_tiles_per_gaussian=R, max_per_tile=K,  # noqa: E731
                           pair_budget=pair[D], chunk=64)
    runs = {}
    runs[1], w1 = par_spawn([("par_dp_step", dict(inputs=inputs, frames=[0]))], 1, "nccl", pws)
    runs[2], w2 = par_spawn([
        ("par_dp_step", dict(inputs=inputs, frames=[0, 1])),
        ("par_shard_render", dict(inputs=inputs, caps=shard(2))),
        ("par_cli", dict(argv=["--epochs", "1", "--dp", "2", *cli_args])),
        ("par_flash", dict(argv=["--epochs", "1", *flash_args])),
    ], 2, "gloo", pws)
    runs[4], w4 = par_spawn([
        ("par_shard_render", dict(inputs=inputs, caps=shard(4))),
        ("par_mesh2d", dict(inputs=inputs, caps=mesh_caps, loss_kw=mesh_loss)),
    ], 4, "gloo", pws)
    log(f"[parallel] spawns: world 1 (nccl) {w1:.1f} s, world 2 (gloo) {w2:.1f} s, "
        f"world 4 (gloo) {w4:.1f} s, ranks' start included [{card}]")
    summary = {"spawn_s": {1: round(w1, 1), 2: round(w2, 1), 4: round(w4, 1)}}
    per_path = {}

    # ---- (a) the DP step
    for world in (1, 2):
        res = [r["par_dp_step"] for r in runs[world]]
        want_loss = float(np.mean(ref_loss[:world]))
        want = {k: sum(g[k] for g in ref_grads[:world]) / world for k in ref_grads[0]}
        again = {k: sum(g[k] for g in ref_again[:world]) / world for k in ref_again[0]}
        errs, noise, skipped = _field_gate(res[0]["grads"], want, again)
        norms = {k: float(v.double().norm()) for k, v in want.items()}
        loss_rel = max(abs(r["loss"] - want_loss) / abs(want_loss) for r in res)
        same = all(len(set(dg)) == 1 for dg in res[0]["digests"])
        log(f"[parallel] DP step, world {world} ({res[0]['backend']}): loss "
            f"{res[0]['loss']:.7f} vs one process {want_loss:.7f} (rel {loss_rel:.1e}, "
            f"bound {PAR_DP_RTOL}); gradients rel L2 by field {_fmt(errs)} (bound "
            f"{PAR_GRAD_RL2}; the reference's run-to-run noise {_fmt(noise)}, skipped above "
            f"{PAR_NOISE}: {skipped}; norms {_fmt(norms)}); "
            f"overflow {res[0]['overflow']}; replicas' digests after the step, after "
            f"densify + prune and after a densify from generators seeded apart "
            f"{res[0]['digests']} (alive {res[0]['alive']}); launches per "
            f"step {res[0]['launches']}; {res[0]['ms']:.2f} ms/step (host clock, "
            f"synchronized, {PAR_TIMED} steps) [{card}]")
        check(loss_rel <= PAR_DP_RTOL and _field_gate_ok(errs, skipped)
              and res[0]["overflow"] == 0, f"[parallel] DP step world {world} vs one process")
        check(same, f"[parallel] DP world {world}: replicas bit-identical after a step, a "
                    f"densify and a densify from generators seeded apart "
                    f"(digests {res[0]['digests']})")
        check(res[0]["alive"][1] != res[0]["alive"][0]
              and res[0]["alive"][2] == res[0]["alive"][1] + PAR_MAINT["increase_num"],
              f"[parallel] DP world {world}: both densify steps added splats "
              f"(alive {res[0]['alive']})")
        per_path[f"dp_step_w{world}"] = _summed_launches(res)
        summary[f"dp_ms_w{world}"] = res[0]["ms"]
    cl = [r["par_cli"] for r in runs[2]]
    n_train = len(cl[0]["counts"])
    log(f"[parallel] train_mono_avatar --dp 2 on the [cli] workspace: {n_train} frames, "
        f"global_step {cl[0]['global_step']}, steps {cl[0]['step']}, mode {cl[0]['mode']}, "
        f"losses {[round(x, 5) for x in cl[0]['losses']]}, tracking counts "
        f"{cl[0]['counts']}, overflow {cl[0]['overflow']}; digests {cl[0]['digest']}; epoch "
        f"{cl[0]['epoch_s']:.2f} s ({cl[0]['epoch_s'] * 1e3 / cl[0]['step']:.1f} ms per "
        f"step of B = 2 with tracking), launches in the epoch {cl[0]['epoch_launches']}, "
        f"in the run {cl[0]['launches']} [{card}]")
    check(all(c == 1 for c in cl[0]["counts"]) and cl[0]["global_step"] == n_train
          and len(set(cl[0]["digest"])) == 1 and cl[0]["overflow"] == 0
          and all(np.isfinite(cl[0]["losses"])),
          "[parallel] --dp 2: every row one update, replicas equal, finite losses")
    per_path["cli_dp2"] = _summed_launches(cl)
    summary["cli_dp2_ms_per_step"] = cl[0]["epoch_s"] * 1e3 / cl[0]["step"]
    fl = [r["par_flash"] for r in runs[2]]
    log(f"[parallel] FlashAvatar at data_parallel 2: losses "
        f"{[round(x, 5) for x in fl[0]['losses']]}, global_step {fl[0]['global_step']}, "
        f"overflow {fl[0]['overflow']}, caps {fl[0]['caps']}, digests {fl[0]['digest']}, "
        f"launches {fl[0]['launches']}, epoch {fl[0]['epoch_s']:.2f} s [{card}]")
    check(len(set(fl[0]["digest"])) == 1 and fl[0]["overflow"] == 0
          and all(np.isfinite(fl[0]["losses"])),
          "[parallel] FlashAvatar DP epoch: finite losses, replicas equal")
    per_path["flash_dp2"] = _summed_launches(fl)

    # ---- (b) the sharded render
    for world in (2, 4):
        res = [r["par_shard_render"] for r in runs[world]]
        err = float((res[0]["image"].cuda() - ref_img).abs().max())
        gerr = {}
        for k, want in ref_shard_grads.items():
            got = torch.cat([r["grads"][k] for r in res]).cuda()
            gerr[k] = float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))
        dropped = [r["dropped"] for r in res]
        log(f"[parallel] sharded render, world {world} (gloo): image max err {err:.2e} "
            f"(bound {PAR_IMG_ATOL}), gradients max err / largest "
            f"{json.dumps({k: f'{v:.1e}' for k, v in gerr.items()})} (bound {PAR_BWD_RTOL}), "
            f"dropped {dropped}; launches a rank per forward + backward "
            f"{res[0]['launches']}; {res[0]['ms']:.2f} ms a frame forward + backward "
            f"(host clock, synchronized) [{card}]")
        check(err <= PAR_IMG_ATOL and max(gerr.values()) <= PAR_BWD_RTOL
              and not any(dropped), f"[parallel] sharded render world {world}")
        per_path[f"shard_w{world}"] = _summed_launches(res)
        summary[f"shard_ms_w{world}"] = res[0]["ms"]

    # ---- (c) the 2-D mesh
    res = [r["par_mesh2d"] for r in runs[4]]
    loss_rel = max(abs(r["loss"] - mesh_ref_loss) / abs(mesh_ref_loss) for r in res)
    by = {r["coords"]: r for r in res}
    gots = {k: (by[(0, 0)]["grads"][k] if k.startswith("delta")
                else torch.cat([by[(0, g)]["grads"][k] for g in range(2)]))
            for k in mesh_ref_grads}
    errs, noise, skipped = _field_gate(gots, mesh_ref_grads, mesh_ref_again)
    log(f"[parallel] 2x2 mesh step (4 ranks, gloo): loss {res[0]['loss']:.7f} vs one "
        f"device {mesh_ref_loss:.7f} (rel {loss_rel:.1e}, bound {PAR_MESH_RTOL}); "
        f"gradients rel L2 by field {_fmt(errs)} (bound {PAR_GRAD_RL2}; the reference's "
        f"run-to-run noise {_fmt(noise)}, skipped above {PAR_NOISE}: {skipped}); overflow "
        f"{res[0]['overflow']}; launches a rank per step {res[0]['launches']}; "
        f"{res[0]['ms']:.2f} ms/step (host clock) [{card}]")
    check(loss_rel <= PAR_MESH_RTOL and _field_gate_ok(errs, skipped)
          and res[0]["overflow"] == 0, "[parallel] 2x2 mesh vs one device")
    per_path["mesh2d_2x2"] = _summed_launches(res)
    summary["mesh2d_ms"] = res[0]["ms"]

    for name in rows:
        by_path = {p: n.get(name, 0) for p, n in per_path.items() if n.get(name, 0)}
        if by_path:
            rows[name]["launches"] += sum(by_path.values())
            rows[name]["launches_parallel"] = by_path
    log(f"[parallel] phase total {time.perf_counter() - t_phase:.1f} s [{card}]")
    log("[parallel] summary " + json.dumps(summary | {"launches": per_path}))
    for n in ("blend_instances_fwd", "blend_instances_bwd", "blend_tiles_fwd",
              "blend_tiles_bwd"):
        check(any(n in p for p in per_path.values()),
              f"[parallel] {n} launched on the parallel paths")
    return summary


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from fateavatar_tpu_torch.cli import common
    from fateavatar_tpu_torch.models.fateavatar import build_gaussians, fateavatar_forward
    from fateavatar_tpu_torch.ops.camera import make_camera
    from fateavatar_tpu_torch.render import blend_instances as bi
    from fateavatar_tpu_torch.render.render import render
    from fateavatar_tpu_torch.train.checkpoints import CheckpointManager
    from fateavatar_tpu_torch.train.loader import Reenactor, checkpoint_tree
    from fateavatar_tpu_torch.utils import cuda_build
    from fateavatar_tpu_torch.utils.config import load_config
    from fateavatar_tpu_torch.utils.graphs import WARMUP

    dev = "cuda"
    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    log(f"[caps] {json.dumps(capabilities())}")

    # ---- build every kernel, one nvcc per source, all at once
    t0 = time.perf_counter()
    libs = cuda_build.build_all(["blend_instances", "blend_instances_bwd", "blend_tiles",
                                 "blend_tiles_bwd"])
    log(f"[setup] kernels built in {time.perf_counter() - t0:.1f} s")
    for name, so in libs.items():
        for line in so.with_suffix(".log").read_text().splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "smem")):
                log(f"[ptxas] {name}: {line.strip()}")
    rows = {name: {"name": name, **spec} for name, spec in KERNELS.items()}
    blend_row = rows["blend_instances_fwd"]
    bwd_row = rows["blend_instances_bwd"]

    # ---- kernel phase 1: edge cases
    gen = torch.Generator(device=dev).manual_seed(0)
    edge = edge_case_inputs(gen, dev)
    tfin = check_blend("edge cases (4x4 tiles, 30+ windows, saturation, "
                       "mid-window ranges)", edge, blend_row)
    empty = (edge[1][1:] - edge[1][:-1]) == 0
    check(bool((tfin[empty] == 1.0).all()), "empty tiles must keep T = 1")
    check(int((tfin < 1e-3).sum()) > 0, "saturated tiles must terminate")
    # the backward kernel on the same inputs, with seeded cotangents
    img_e = bi.blend_instances(*edge)[0]
    g_img = torch.randn(img_e.shape, generator=gen, device=dev)
    g_tfin = torch.randn(tfin.shape, generator=gen, device=dev)
    bwd_args = (*edge[:3], img_e, tfin, g_img, g_tfin, edge[3])
    g_clean = check_blend_bwd("edge cases", bwd_args, bwd_row)
    g_dirty = bi.blend_instances_bwd(*bwd_args, out=torch.full_like(g_clean, float("nan")))
    torch.cuda.synchronize()
    check(torch.equal(g_dirty, g_clean),
          "a NaN-filled output buffer must come back equal to a clean call")
    log("[kernel] edge cases: NaN-prefilled output buffer comes back finite and "
        "bit-equal to a clean call")
    instance_kernel_cases(rows)
    tile_kernel_cases(rows)

    # ---- serve phase: seeded workspace, checkpoint, reenactment
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as ws:
        t0 = time.perf_counter()
        pkl, obj = write_assets(ws, seed=0)
        cfg = load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                       "configs", "fateavatar.yaml"), [
            f"assets.flame_model_path={pkl}", f"assets.template_mesh_path={obj}",
            f"workspace={ws}",
        ])
        flame = common.construct_flame(cfg, device=dev)
        model, params, state = common.construct_model(cfg, flame, device=dev)
        rcfg = common.render_config(cfg)
        n_alive = int(state.alive.sum())
        log(f"[serve] capacity {params.offset.shape[0]} alive {n_alive} "
            f"img {cfg.dataset.img_res} binning {rcfg.binning} "
            f"R {rcfg.max_tiles_per_gaussian} (built in {time.perf_counter() - t0:.1f} s)")
        check(n_alive == 65536 and params.offset.shape[0] == 200_000,
              "full-width avatar: 65,536 splats at a 200,000 capacity")

        # a trained-looking avatar: seeded perturbations so the frame is
        # neither flat grey nor empty
        def jitter(x, scale):
            return x + scale * torch.randn(x.shape, generator=gen, device=dev)

        saved = type(params)(**{
            **{k: getattr(params, k) for k in params.__dataclass_fields__},
            "features_dc": jitter(params.features_dc, 0.8),
            "opacity": jitter(params.opacity, 1.0),
            "offset": jitter(params.offset, 0.3),
            "scaling": jitter(params.scaling, 0.1),
        })
        CheckpointManager(os.path.join(ws, "checkpoints")).save(
            1, checkpoint_tree(saved, state, epoch=1, global_step=1))

        identity = common.load_identity_info(ws)
        wm = np.asarray(identity["world_mat0"], np.float32)
        h, w = identity["img_res"]
        cam = make_camera(wm[:3, :3].T, wm[:3, 3], identity["fovx"],
                          identity["fovy"], w, h, device=dev)
        reenactor = Reenactor(model, params, state, ws, render_cfg=rcfg)
        rng = np.random.default_rng(0)
        # the synthetic blendshapes are uncorrelated per vertex, so large
        # codes crumple the mesh and balloon the splats; 0.05 keeps every
        # frame inside the config's binning caps (overflow 0)
        exprs = (rng.normal(size=(N_FRAMES, 50)) * 0.05).astype(np.float32)
        poses = (rng.normal(size=(N_FRAMES, 15)) * 0.05).astype(np.float32)
        delta = np.zeros((50,), np.float32)

        reenactor.reenact(exprs[:2], poses[:2], delta, cam)      # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # ---- the main path: counts to 0 just before, read just after
        bi.blend_instances.launches = 0
        t0 = time.perf_counter()
        frames = reenactor.reenact(exprs, poses, delta, cam)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = {"blend_instances_fwd": bi.blend_instances.launches}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        g = reenactor.last_graph
        for name, n in launches.items():
            rows[name]["launches"] = n
            log(f"[serve] {name} launches in the serving path: {n} by the wrapper "
                f"({WARMUP} warm-up calls + the capture), then {g.replays} replays of the "
                f"served frame's CUDA graph x {g.launches_per_replay.get(name, 0)}")
            check(n > 0, f"{name} never launched on the main path")
        check(launches["blend_instances_fwd"] == WARMUP + 1 and g.replays == N_FRAMES
              and g.launches_per_replay == {"blend_instances_fwd": 1},
              "one graph replay per frame, one blend launch each")
        check(len(frames) == N_FRAMES and all(f.shape == (h, w, 3) for f in frames),
              "16 frames of 512x512x3")
        spread = float(np.std(np.stack(frames).astype(np.float32)))
        check(spread > 5.0, f"frames must not be flat (pixel std {spread:.2f})")
        log(f"[serve] {N_FRAMES} frames in {serve_s * 1e3:.3f} ms: "
            f"{serve_s * 1e3 / N_FRAMES:.3f} ms/frame (host clock, uint8 "
            f"frames on the host, the graph's warm-up and capture included), peak "
            f"device memory {peak_gib:.3f} GiB, pixel std {spread:.2f}")

        # per-frame latency, overflow and finiteness, frame by frame
        lat, overflow = [], []
        for e, p in zip(exprs, poses):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fateavatar_forward(model, reenactor.params, state,
                                     torch.from_numpy(e).to(dev),
                                     torch.from_numpy(p).to(dev), cam, render_cfg=rcfg)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            overflow.append(int(out["overflow"]))
            check(bool(torch.isfinite(out["rgb_image"]).all()), "finite frame")
        log(f"[serve] per-frame forward ms (host clock, synchronized): "
            f"median {float(np.median(lat)):.3f} min {min(lat):.3f} max {max(lat):.3f}")
        log(f"[serve] overflow per frame: {overflow}")
        check(not any(overflow), "no instance dropped by the binning caps")

        # 2 frames against the same pipeline with the plain blend
        for i in (0, N_FRAMES - 1):
            img_k = reenactor.render_frame(exprs[i], poses[i], cam)
            with swapped_blend(bi.blend_instances_reference):
                img_p = reenactor.render_frame(exprs[i], poses[i], cam)
            err = (img_k - img_p).abs().max().item()
            log(f"[serve] frame {i}: kernel vs plain pipeline max|diff| {err:.3e}")
            check(err <= TOL, f"frame {i} kernel vs plain {err:.3e} > {TOL}")
            blend_row["max_abs_err"] = max(blend_row["max_abs_err"], err)

        # ---- kernel phase 2: the real inputs of one full-width frame
        captured = []

        def record(*args):
            captured.append(args)
            return bi.blend_instances(*args)

        with swapped_blend(record):
            reenactor.render_frame(exprs[0], poses[0], cam)
        inputs = captured[0]
        inst, starts, bg, grid = inputs
        n_inst = int(starts[-1])
        counts = (starts[1:] - starts[:-1]).float()
        log(f"[kernel] frame 0: M {inst.shape[1]} binned instances {n_inst} "
            f"tiles {grid} per-tile max {int(counts.max())} "
            f"mean {counts.mean().item():.1f}")
        check_blend("frame 0 (serving inputs)", inputs, blend_row)
        check_repeatable("frame 0 forward", lambda: bi.blend_instances(*inputs))

        ms = cuda_ms(lambda: bi.blend_instances(*inputs), reps=50)
        plain_ms = cuda_ms(lambda: bi.blend_instances_reference(*inputs), reps=3,
                           warmup=1)
        pairs = bi.pair_counts(inst, starts, grid)[0]
        n_pix = grid[0] * grid[1] * 256
        bytes_moved = (BYTES_PER_INSTANCE * n_inst + 4 * starts.numel() + 12
                       + BYTES_PER_PIXEL * n_pix)
        t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
        t_ops = OPS_PER_PAIR * pairs / PEAK_FP32_OPS_PER_S * 1e3
        blend_row.update(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else "operations",
                         library_ms=None)
        log(f"[kernel] blend_instances_fwd: {ms:.4f} ms/launch (CUDA events, 50 "
            f"launches), plain version {plain_ms:.3f} ms; evaluated pairs {pairs} "
            f"(of {n_inst * 256} without termination); bound "
            f"{blend_row['bound_ms']:.5f} ms ({t_bytes:.5f} ms for {bytes_moved} B "
            f"at 3.35 TB/s, {t_ops:.5f} ms for {OPS_PER_PAIR} ops/pair at 67 "
            f"TFLOP/s fp32) -> {blend_row['bound_ms'] / ms:.1%} of bound [{card}]")
        log(f"[kernel] blend_instances_fwd segmented walk, pairs derived from the inputs "
            f"(not counted on the card): pass A evaluates every pair of the ranges "
            f"({n_inst * 256}), pass B about the sequential walk's {pairs} before "
            f"termination; {n_inst * 256 + pairs} in all, "
            f"{(n_inst * 256 + pairs) / pairs:.2f}x the per-tile walk's")
        segment_split("blend_instances_fwd", lambda: bi.blend_instances(*inputs), card)

        # stage split of one frame (CUDA events, 20 reps each)
        e0 = torch.from_numpy(exprs[0]).to(dev)
        p0 = torch.from_numpy(poses[0]).to(dev)
        params_r = reenactor.params
        g_ms = cuda_ms(lambda: build_gaussians(model, params_r, state, e0, p0), reps=20)
        gaussians = build_gaussians(model, params_r, state, e0, p0)[0]
        r_ms = cuda_ms(lambda: render(cam, gaussians, model.bg_color, config=rcfg),
                       reps=20)
        f_ms = cuda_ms(lambda: fateavatar_forward(model, params_r, state, e0, p0, cam,
                                                  render_cfg=rcfg), reps=20)
        log(f"[serve] stage ms (CUDA events, back to back): forward {f_ms:.3f} = "
            f"build_gaussians {g_ms:.3f} + render {r_ms:.3f} (of which the blend "
            f"kernel {ms:.3f}, preprocess + binning + gather {r_ms - ms:.3f})")

        # device busy share and kernel time by name over 4 forwards
        profile_top("4 forwards", lambda i: fateavatar_forward(
            model, params_r, state, e0, p0, cam, render_cfg=rcfg), 4, "frame", card)

        # wall seconds of each phase, from the end of the one before
        laps, t_lap = {}, [t_start]

        def lap(name):
            now = time.perf_counter()
            laps[name] = round(now - t_lap[0], 1)
            t_lap[0] = now

        lap("build, kernels, serve")
        tcfg = tiles_serve_phase(model, params, state, ws, rcfg, cam, exprs, poses, delta,
                                 rows, card)
        lap("tiles-serve")
        setup = train_setup(ws)
        trainer = train_phase(setup, gen, rows, card)
        lap("train")
        tiles_train_cfg = tiles_train_phase(setup, trainer, rows, card)
        lap("tiles-train")
        cli = cli_phase(ws, model, saved, state, rows, card, setup.step_ms)
        lap("cli")
        graph_phase(setup, trainer, tiles_train_cfg, cli.trainer,
                    (model, params, state, ws, rcfg, tcfg, cam, exprs, poses, delta),
                    rows, card)
        lap("graph")
        options = options_phase(model, reenactor.params, state, ws, rcfg, cam, exprs, poses,
                                delta, trainer, rows, card)
        lap("options")
        log("[options] summary " + json.dumps(options))
        bake = bake_phase(cli, rows, card)
        lap("bake")
        edit = edit_phase(cli, card)
        lap("edit")
        log("[bake] summary " + json.dumps({k: v for k, v in bake.items() if k != "baker"}
                                           | {"edit": edit}))
        tools = tools_phase(cli, rows, card)
        lap("tools")
        pseudo = pseudo_phase(cli, rows, card)
        lap("pseudo")
        plugins = plugins_phase(cli, pseudo, rows, card)
        lap("plugins")
        log("[plugins] summary " + json.dumps(plugins | {"tools": tools}))
        complete = complete_phase(cli, pseudo, rows, card)
        lap("complete")
        log("[complete] summary " + json.dumps({"pseudo": pseudo, "complete": complete}))
        baselines_phase(cli, rows, card)
        lap("baselines")
        lpips_phase(setup, ws, rows, card)
        lap("lpips")
        nersemble_phase(ws, cli, rows, card)
        lap("nersemble")
        parallel_phase(setup, trainer, cli, ws, rows, card)
        lap("parallel")

    log(f"[setup] seconds by phase {json.dumps(laps)}")
    log(f"[setup] total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": list(rows.values())}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
