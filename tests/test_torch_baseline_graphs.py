"""The baselines' scan epoch on the CPU, where ``utils/graphs.Graph`` runs its
function as it is (the plain version of the CUDA graph).

With ``adapter=``, tracking off and every training frame in the device
frame cache, the Trainer captures the family's step with ``maintain=False``
and runs the steps its ``due`` names eagerly between the replays
(``train/trainer.py``). Each family's scan epochs equal a per-step
trainer's (``_scan_disabled``, the same uint8 ground truth) bit for bit,
with a densify (GaussianAvatars) or a walk (SplattingAvatar) due inside the
epoch and MonoGaussianAvatar's upsample between epochs; SplattingAvatar's
scan epoch is held to the JAX package's ``lax.scan`` epoch; an adapter with
tracking, or a step without ``due``, keeps per-step epochs; a scan epoch
measured below 0.9x the per-step rate switches back. The card's half (graph
against eager on CUDA) is in tests/test_torch_cuda.py and chip_smoke.py's
``[baselines]`` phase."""

import numpy as np
import pytest
import torch

from test_torch_baselines import JRC, MODEL_CFG, NV, RES, TRC, _jax_build, _perturb, to_np
from torch_single_thread import one_torch_thread  # noqa: F401 (autouse fixture)
from fateavatar_tpu.flame import synthetic_flame as jsynthetic_flame
from fateavatar_tpu.train import adapters as jadapters
from fateavatar_tpu.train import datasets as jdatasets
from fateavatar_tpu.train import registry as jregistry
from fateavatar_tpu.train.trainer import Trainer as JTrainer
from fateavatar_tpu.utils.obj_io import sphere_obj_mesh

from fateavatar_tpu_torch import convert
from fateavatar_tpu_torch.flame.loader import synthetic_flame
from fateavatar_tpu_torch.models.baselines import splattingavatar as tsa
from fateavatar_tpu_torch.train import baseline_steps as tbs
from fateavatar_tpu_torch.train import registry as tregistry
from fateavatar_tpu_torch.train.adapters import make_family_adapter
from fateavatar_tpu_torch.train.datasets import SyntheticDataset
from fateavatar_tpu_torch.train.step import train_state_tensors
from fateavatar_tpu_torch.train.trainer import Trainer

FAMILIES = ("gaussianavatars", "flashavatar", "splattingavatar", "monogaussianavatar")
FRAMES = 4
# GA densifies (every visible splat: threshold 0) and Splat walks at steps 3,
# 6, 9 and 12: step 6 inside epoch 2, steps 9 and 12 inside epoch 3
MAINT = dict(densify_interval=3, densify_from_iter=0, densify_grad_threshold=0.0,
             opacity_reset_interval=10**9, triangle_walk_interval=3)
# steps of the due maintenance by family over epochs 2 and 3
DUE = {"gaussianavatars": [6, 9, 12], "splattingavatar": [6, 9, 12],
       "flashavatar": [], "monogaussianavatar": []}


def _trainer(family, scan=True, tracking=False, maint=MAINT):
    """A 4-frame Trainer of ``family`` (MonoGaussianAvatar's prune / upsample
    after every epoch), its ground truth cached on the device."""
    tf = synthetic_flame(n_verts=NV, n_shape=6, n_exp=4, seed=0, device="cpu")
    entry = tregistry.get(family)
    bundle = entry.build_model(sphere_obj_mesh(NV), tf, MODEL_CFG)
    loss_fn = entry.build_loss({}, bundle)
    opt = entry.build_optimizer({"lr": 1e-3})
    adapter = make_family_adapter(family, bundle, loss_fn, opt, TRC, maint)
    if family == "monogaussianavatar":
        model = bundle[0]

        def hook(tr, epoch):
            tr.ts = tbs.mono_epoch_maintenance(tr.ts, model, epoch, upsample_freq=1)
        adapter.epoch_hook = hook
    state0 = bundle[2] if len(bundle) > 2 and not callable(bundle[2]) else None
    ds = SyntheticDataset(num_frames=FRAMES, img_res=(RES, RES), n_exp=4)
    ds.optimize_tracking = tracking
    tr = Trainer(family, bundle[0], bundle[1], state0, loss_fn, opt, ds, render_cfg=TRC,
                 adapter=adapter, device_frame_cache="on")
    tr._scan_disabled = not scan
    return tr


def _epochs(tr, first, last):
    for e in range(first, last + 1):
        tr.epoch = e
        tr.train_epoch()
        if tr.adapter.epoch_hook is not None:
            tr.adapter.epoch_hook(tr, e)


@pytest.mark.parametrize("family", FAMILIES)
def test_scan_epochs_match_per_step(family):
    """Epochs 2 and 3 run as scan epochs (one graph, captured once: the
    upsample between them keeps MonoGaussianAvatar's shapes); the due
    steps run eagerly between replays; params, state, Adam moments and
    count, the generator and every per-step loss equal the per-step
    trainer's bit for bit."""
    tr_scan, tr_ref = _trainer(family), _trainer(family, scan=False)
    steps = {"scan": [], "ref": []}
    for tr, key in ((tr_scan, "scan"), (tr_ref, "ref")):
        step = tr.adapter.step

        def watched(ts, frame, *a, _step=step, _seen=steps[key], **k):
            if k.get("maintain", True):
                _seen.append(ts.step + 1)
            return _step(ts, frame, *a, **k)
        watched.due = step.due
        tr.adapter.step = tr.train_step = watched
        _epochs(tr, 1, 1)
        assert tr.last_epoch_stats["mode"] == "per-step" and tr.last_epoch_aux is None
    losses = {"scan": [], "ref": []}
    for tr, key in ((tr_scan, "scan"), (tr_ref, "ref")):
        steps[key].clear()
        for e in (2, 3):
            _epochs(tr, e, e)
            losses[key] += tr.epoch_losses
    assert tr_scan.last_epoch_stats["mode"] == "scan"
    assert tr_ref.last_epoch_stats["mode"] == "per-step" and tr_ref._scan_epoch is None
    scan = tr_scan._scan_epoch
    # the eager steps with maintenance are the due ones; the rest replayed
    assert steps["scan"] == DUE[family] and scan.graph.replays == 2 * FRAMES - len(DUE[family])
    assert steps["ref"] == list(range(5, 13))
    aux = tr_scan.last_epoch_aux
    assert {k: (v.shape, v.dtype) for k, v in aux.items()} == {
        "loss": ((FRAMES,), np.float32), "psnr": ((FRAMES,), np.float32),
        "overflow": ((FRAMES,), np.int32)}
    assert not aux["overflow"].any() and np.isfinite(aux["psnr"]).all()
    assert losses["scan"] == losses["ref"] and np.isfinite(losses["scan"]).all()
    assert tr_scan.global_step == tr_scan.ts.step == tr_ref.ts.step == 12
    a, b = train_state_tensors(tr_scan.ts), train_state_tensors(tr_ref.ts)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(tr_scan.ts.generator.get_state(), tr_ref.ts.generator.get_state())
    assert tr_scan._alive() == tr_ref._alive()


def test_tracking_and_hostbound_steps_keep_per_step_epochs():
    """An adapter on a tracking dataset, and one whose step has no ``due``
    (GaussianAvatars with an xyz lr schedule), train per step, as the JAX
    package's Trainer does; such a step refuses ``maintain=False``."""
    tr = _trainer("flashavatar", tracking=True)
    _epochs(tr, 1, 2)
    assert tr.last_epoch_stats["mode"] == "per-step" and tr._scan_epoch is None
    assert tr._maybe_scan_epoch() is None

    tr = _trainer("gaussianavatars")
    ga = tr.adapter
    step = tbs.make_gaussianavatars_step(tr.model, tr.loss_fn, tr.optimizer, TRC,
                                         xyz_lr_schedule=lambda s: 1e-3)
    assert step.due is None
    ga.step = tr.train_step = step
    _epochs(tr, 1, 2)
    assert tr.last_epoch_stats["mode"] == "per-step" and tr._scan_epoch is None
    frame = tr._make_frame(tr.train_dataset.sample(0))
    with pytest.raises(ValueError, match="lr schedule"):
        step(tr.ts, frame, maintain=False)


def test_adapter_scan_mode_switches_back_to_per_step():
    """The JAX package's measured choice for an adapter too: the first scan
    epoch pays the capture and is not measured; once a later one runs below
    0.9x the per-step steady rate, the Trainer logs why and trains per
    step."""
    tr = _trainer("flashavatar")
    lines = []
    tr.log = lines.append
    _epochs(tr, 1, 1)
    assert tr._per_step_its is not None and tr._per_step_its > 0
    tr._per_step_its = 1e12          # per-step mode "measured" faster than any scan
    _epochs(tr, 2, 2)
    assert tr.last_epoch_stats["mode"] == "scan" and tr._scan_its is None
    assert not tr._scan_disabled
    _epochs(tr, 3, 3)
    assert tr._scan_its is not None and tr._scan_disabled
    assert any(line.startswith("[scan] per-step mode is faster") for line in lines)
    _epochs(tr, 4, 4)
    assert tr.last_epoch_stats["mode"] == "per-step" and tr.last_epoch_aux is None
    assert tr.global_step == 4 * FRAMES


# SplattingAvatar against the JAX package's scan epoch: walks at steps 2 and 4
WALK2 = dict(triangle_walk_interval=2)
# per-step losses: the forward's image agrees within 5e-5 (test_torch_baselines)
LOSS_RTOL = 1e-5
# parameters: the per-step bound of test_torch_baselines.test_step_matches_jax
# (each gradient within 8e-5 of its field's largest) carried through Adam,
# whose update moves an element by at most lr a step, so FRAMES * 8e-5 * lr
# over the epoch, plus the walk's 1e-6 (test_triangle_walk_matches_jax), on
# every alive element of every field
STEP_GRAD_RTOL = 8e-5


def test_splattingavatar_scan_epoch_matches_jax():
    """One scan epoch of 4 frames from the same state and frames on both
    sides: JAX's one ``lax.scan`` (the walk under its ``lax.cond``) against
    the port's replays with the walks eager. Per-step losses within
    LOSS_RTOL; parameters within the per-step bound widened by the steps."""
    family = "splattingavatar"
    jf = jsynthetic_flame(n_verts=NV, n_shape=6, n_exp=4, seed=0)
    entry = jregistry.get(family)
    built = _jax_build(entry, jf)
    jb = (built[0], _perturb(family, built[1]), *built[2:])
    jloss = entry.build_loss({}, jb)
    jopt = entry.build_optimizer({"lr": 1e-3})
    jad = jadapters.make_family_adapter(family, jb, jloss, jopt, JRC, WALK2)
    jds = jdatasets.SyntheticDataset(num_frames=FRAMES, img_res=(RES, RES), n_exp=4)
    jtr = JTrainer(family, jb[0], jb[1], jb[2], jloss, jopt, jds, render_cfg=JRC,
                   adapter=jad, device_frame_cache="on")

    tentry = tregistry.get(family)
    bundle = (convert.baseline_model(family, to_np(jb[0]), device="cpu"),
              convert.baseline_params(family, to_np(jb[1]), device="cpu"),
              convert.baseline_state(family, to_np(jb[2]), device="cpu"))
    tloss = tentry.build_loss({}, bundle)
    topt = tentry.build_optimizer({"lr": 1e-3})
    tad = make_family_adapter(family, bundle, tloss, topt, TRC, WALK2)
    tds = SyntheticDataset(num_frames=FRAMES, img_res=(RES, RES), n_exp=4)
    tr = Trainer(family, bundle[0], bundle[1], bundle[2], tloss, topt, tds, render_cfg=TRC,
                 adapter=tad, device_frame_cache="on")
    walks = []
    real_walk = tsa.walking_on_triangles

    def walk(*a, **k):
        walks.append(1)
        return real_walk(*a, **k)

    # every frame cached: epoch 1 is the scan epoch on both sides
    for trainer, ds in ((jtr, jds), (tr, tds)):
        for i in range(FRAMES):
            trainer._make_frame(ds.sample(i), None)
        trainer.epoch = 1
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tsa, "walking_on_triangles", walk)
            trainer.train_epoch()
        assert trainer.last_epoch_stats["mode"] == "scan"
    assert len(walks) == 2 and tr._scan_epoch.graph.replays == FRAMES - 2

    np.testing.assert_allclose(tr.last_epoch_aux["loss"], np.asarray(jtr.last_epoch_aux["loss"]),
                               rtol=LOSS_RTOL)
    jts = to_np(jtr.ts)
    lr = 1e-3
    bound = FRAMES * STEP_GRAD_RTOL * lr + 1e-6
    # the alive splats' rows: a dead row's NaN gradient (test_torch_baselines)
    # turns its parameters NaN in JAX's Adam from the second step on, in per-
    # step epochs too, while the port's stay finite; no render reads them
    alive = tr.ts.state.alive.numpy()
    assert np.array_equal(alive, np.asarray(jts["state"]["alive"])) and alive.any()
    for name, want in jts["params"].items():
        got, want = getattr(tr.ts.params, name).numpy()[alive], np.asarray(want)[alive]
        err = np.abs(got - want).max()
        assert err <= bound, (name, err, bound)
    for name in ("sample_fidxs", "sample_bary"):
        got, want = getattr(tr.ts.state, name).numpy(), np.asarray(jts["state"][name])
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=name)
    assert tr.ts.step == int(np.asarray(jts["step"])) == FRAMES
