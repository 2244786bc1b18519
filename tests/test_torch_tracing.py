"""The port's tracing (``utils/profiling.py``) on the CPU at tiny sizes:
spans nest and carry their ids, counters give deltas, the plain stage marks
record nothing with tracing off and one mark per stage per pass with it on,
the Trainer's step counters agree with the count the benchmark derives
(steps less ``Graph.replays``), and ``Reenactor.reenact`` counts its calls,
frames, drains and the instances its frames dropped, and warns of them.
One card-only case captures the ``stage_mark`` kernel in a ``Graph``; it
skips here and runs on the card with
``python -m pytest --noconftest -q tests/test_torch_tracing.py``."""

import math
import os

import numpy as np
import pytest
import torch

from test_torch_graphs import N_EXP, RES, _avatar, _trainer
from torch_single_thread import one_torch_thread  # noqa: F401 (autouse fixture)
from fateavatar_tpu_torch.flame.loader import synthetic_flame
from fateavatar_tpu_torch.ops.camera import make_camera
from fateavatar_tpu_torch.render.render import RenderConfig
from fateavatar_tpu_torch.train import registry as tregistry
from fateavatar_tpu_torch.train.adapters import make_family_adapter
from fateavatar_tpu_torch.train.checkpoints import CheckpointManager
from fateavatar_tpu_torch.train.datasets import SyntheticDataset
from fateavatar_tpu_torch.train.loader import DRAIN, Reenactor, checkpoint_tree
from fateavatar_tpu_torch.train.trainer import Trainer
from fateavatar_tpu_torch.utils import profiling
from fateavatar_tpu_torch.utils.graphs import Graph
from fateavatar_tpu_torch.utils.obj_io import sphere_obj_mesh

FRAMES = 4
MONO_CFG = dict(img_height=RES, img_width=RES, n_init_points=64, max_points=256,
                cam_scale=1.0, dataset_type="synthetic")
STEP_STAGES = ("forward", "raster_front", "blend", "loss", "backward", "optimizer")
STEP_COUNTERS = ("trainer.steps_replayed", "trainer.steps_eager_maintenance",
                 "trainer.steps_eager_per_step")


@pytest.fixture(autouse=True)
def tracing_off():
    profiling.set_tracing(False)
    profiling.reset()
    yield
    profiling.set_tracing(False)
    profiling.reset()


def _mono_trainer():
    """A 4-frame MonoGaussianAvatar Trainer, its ground truth cached on the
    device: epoch 1 runs per step, the next ones as scan epochs."""
    tf = synthetic_flame(n_verts=96, n_shape=6, n_exp=4, seed=0, device="cpu")
    entry = tregistry.get("monogaussianavatar")
    bundle = entry.build_model(sphere_obj_mesh(96), tf, MONO_CFG)
    loss_fn = entry.build_loss({}, bundle)
    opt = entry.build_optimizer({"lr": 1e-3})
    rcfg = RenderConfig()
    adapter = make_family_adapter("monogaussianavatar", bundle, loss_fn, opt, rcfg, {})
    ds = SyntheticDataset(num_frames=FRAMES, img_res=(RES, RES), n_exp=4)
    return Trainer("mono", bundle[0], bundle[1], bundle[2], loss_fn, opt, ds, render_cfg=rcfg,
                   adapter=adapter, device_frame_cache="on")


def _epochs(tr, n):
    for e in range(1, n + 1):
        tr.epoch = e
        tr.train_epoch()


def test_spans_nest_and_carry_ids():
    with profiling.span("off"):
        pass
    assert profiling.spans() == []
    with profiling.tracing():
        with profiling.span("outer", epoch=3, mode="scan"):
            with profiling.span("inner", reason="a"):
                pass
            with profiling.span("inner", reason="b"):
                pass
    assert not profiling.is_tracing()
    a, b, outer = profiling.spans()
    assert (outer.name, outer.parent, outer.ids) == ("outer", None, {"epoch": 3, "mode": "scan"})
    assert a.parent == b.parent == outer.id and a.id != b.id
    assert (a.ids, b.ids) == ({"reason": "a"}, {"reason": "b"})
    assert outer.start <= a.start <= a.end <= b.start <= b.end <= outer.end
    profiling.reset()
    assert profiling.spans() == []


def test_counters_give_deltas():
    before = profiling.counters()
    profiling.count("t.calls")
    profiling.count("t.calls")
    profiling.count("t.seconds", 0.5)
    d = profiling.counters(before)
    assert (d["t.calls"], d["t.seconds"]) == (2, 0.5)
    assert profiling.history("t.seconds")[-1:] == [0.5]
    assert profiling.history("t.never") == []
    assert all(v == 0 for k, v in d.items() if not k.startswith("t."))
    # reset drops spans and marks, never counters
    profiling.reset()
    assert profiling.counters(before)["t.calls"] == 2


def test_stage_intervals_partition_passes():
    """A stage lasts until the next mark, ``end`` closes a pass, a stage met
    twice in a pass adds up, marks before the first ``forward`` are left
    out."""
    seq = [(0, "blend"), (5, "forward"), (7, "raster_front"), (8, "blend"), (10, "raster_front"),
           (11, "blend"), (13, "end"), (20, "forward"), (26, "end")]
    assert profiling.stage_intervals(seq) == {"forward": [2, 6], "raster_front": [2],
                                              "blend": [4]}


def test_stage_ms_keeps_each_clock_apart():
    """The host's marks and a card's ring are split into passes on their
    own: a stage left open at the end of one clock's marks is not closed by
    the other's."""
    ring = torch.zeros((1 + 2 * profiling.RING,), dtype=torch.int64)
    ring[:5] = torch.tensor([2, 1000, 0, 1003, profiling.STAGES.index("end")])
    profiling._cpu_marks.extend([(0, 0), (10, profiling.STAGES.index("blend"))])
    profiling._rings[-1] = ring
    try:
        assert profiling.stage_ms() == {"forward": (pytest.approx(6.5e-6), 2)}
    finally:
        del profiling._rings[-1]


def test_marks_one_per_stage_per_pass():
    """Off: a Mono epoch records no mark. On: each step marks every stage
    once, per-step and replayed steps alike."""
    tr = _mono_trainer()
    _epochs(tr, 1)
    assert profiling.marks() == []
    with profiling.tracing():
        tr.epoch = 2
        tr.train_epoch()
    assert tr.last_epoch_stats["mode"] == "scan"
    names = [s for _, s in profiling.marks()]
    assert names == [*STEP_STAGES, "end"] * FRAMES
    got = profiling.stage_ms()
    assert set(got) == set(STEP_STAGES)
    assert all(n == FRAMES and ms >= 0 for ms, n in got.values())
    names = [r.name for r in profiling.spans()]
    assert names.count("graph.replay") == FRAMES


@pytest.mark.parametrize("family", ["monogaussianavatar", "fateavatar"])
def test_trainer_step_counters_match_the_harness(family):
    """Steps less ``Graph.replays`` (the benchmark's eager steps) equal the
    Trainer's eager counters: epoch 1 per step, then scan epochs (the
    FateAvatar trainer's prunes and densifies run eagerly)."""
    before = profiling.counters()
    tr = _mono_trainer() if family == "monogaussianavatar" else _trainer()
    n_epochs = 3
    _epochs(tr, n_epochs)
    d = profiling.counters(before)
    steps = n_epochs * FRAMES
    replays = tr._scan_epoch.graph.replays
    assert sum(d[k] for k in STEP_COUNTERS) == steps
    assert d["trainer.steps_replayed"] == replays
    assert d["trainer.steps_eager_per_step"] == FRAMES
    assert steps - replays == d["trainer.steps_eager_per_step"] + \
        d["trainer.steps_eager_maintenance"]
    due = tr._due()
    assert d["trainer.steps_eager_maintenance"] == sum(
        1 for s in range(FRAMES + 1, steps + 1) if due(s))
    # one add to each counter an epoch: the histories line up by epoch
    per_epoch = [profiling.history(k)[-n_epochs:] for k in STEP_COUNTERS]
    assert [sum(col) for col in zip(*per_epoch)] == [FRAMES] * n_epochs
    assert per_epoch[2] == [FRAMES, 0, 0]


def _reenactor(tmp_path, **render):
    m, p, s = _avatar()
    CheckpointManager(os.path.join(tmp_path, "checkpoints")).save(1, checkpoint_tree(p, s))
    rng = np.random.default_rng(0)
    exprs = (rng.normal(size=(11, N_EXP)) * 0.3).astype(np.float32)
    poses = (rng.normal(size=(11, 15)) * 0.05).astype(np.float32)
    cam = make_camera(np.eye(3), [0.0, 0.0, 0.4], 0.8, 0.8, RES, RES, device="cpu")
    return Reenactor(m, p, s, str(tmp_path), render_cfg=RenderConfig(**render)), exprs, poses, cam


def test_reenact_counts_drains_and_spans(tmp_path):
    rr, exprs, poses, cam = _reenactor(tmp_path)
    before = profiling.counters()
    with profiling.tracing():
        frames = rr.reenact(exprs, poses, None, cam)
    d = profiling.counters(before)
    n = len(frames)
    assert n == 11 and rr.last_overflow == 0
    assert (d["reenact.calls"], d["reenact.frames"]) == (1, n)
    assert d["reenact.drains"] == math.ceil(n / DRAIN) and d["reenact.drain_s"] > 0
    assert d["reenact.overflow"] == 0
    recs = profiling.spans()
    (call,) = [r for r in recs if r.name == "reenact.call"]
    assert call.ids == {"call": profiling.counters()["reenact.calls"], "frames": n}
    drains = [r for r in recs if r.name == "reenact.drain"]
    assert [r.ids["frames"] for r in drains] == [DRAIN, n - DRAIN]
    assert all(r.parent == call.id for r in drains + [r for r in recs
                                                     if r.name == "reenact.upload"])
    got = profiling.stage_ms()
    assert set(got) == {"forward", "raster_front", "blend", "output"}
    assert all(k == n for _, k in got.values())


def test_reenact_reports_dropped_instances(tmp_path, capsys):
    """An instance budget below the frames' instances drops some: the
    served call counts them and warns."""
    rr, exprs, poses, cam = _reenactor(tmp_path, instance_budget=16)
    before = profiling.counters()
    rr.reenact(exprs[:3], poses[:3], None, cam)
    assert rr.last_overflow > 0
    assert profiling.counters(before)["reenact.overflow"] == rr.last_overflow
    assert f"[WARN] {rr.last_overflow} tile instances dropped" in capsys.readouterr().err


@pytest.mark.cuda
def test_stage_mark_inside_a_graph_on_the_card():
    """Captured with tracing on, a graph's marks stamp every replay in
    order (its warm-up calls stamp nothing) and the profiler names the
    kernel; captured with tracing off, it holds no mark."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.zeros(4096, device="cuda")

    def fn():
        profiling.mark("forward", x.device)
        x.add_(1.0)
        profiling.mark("end", x.device)

    with profiling.tracing():
        g = Graph(fn, [x], "marked")
        g()
        profiling.reset()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                g()
            torch.cuda.synchronize()
    seq = profiling.marks()
    assert [s for _, s in seq] == ["forward", "end"] * 3
    stamps = [t for t, _ in seq]
    assert all(b > a for a, b in zip(stamps, stamps[1:]))
    assert float(x[0]) == 4.0
    assert sum(e.name == "stage_mark" for e in prof.events()) == 6
    ms, passes = profiling.stage_ms()["forward"]
    assert passes == 3 and 0 < ms < 10
    plain = Graph(fn, [x], "unmarked")
    for _ in range(3):
        plain()
    torch.cuda.synchronize()
    assert len(profiling.marks()) == 6
