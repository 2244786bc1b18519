"""The harness end to end on the CPU at tiny sizes (the port's plain
versions in place of its kernels, its graphs as plain calls): a sound run
is correct, the control and each fault a cell can have are not, and no run
loads JAX."""

import copy
import os
import subprocess
import sys
import tempfile
import types

import pytest
import torch

from portbench import calibrate, check, registry
from portbench.run import ROOT, forbidden_modules, make_ctx, run_cell

# tiny sizes of the CPU runs: 32x32 frames, 64 splats, 6 training frames
TINY = {"config": {"dataset": {"img_res": [32, 32]}, "model": {"tex_size": 8},
                   "training": {"max_points_num": 128}},
        "traffic": {"frames": 6, "img_res": [32, 32]}}
SHORT_CLIPS = {"traffic": {"clip_frames_min": 3, "clip_frames_max": 6, "n_lengths": 4}}
FEW_POINTS = {"config": {"model": {"max_points": 600}, "training": {"max_points_num": 600}}}
SEED = 2 ** 31 + 77


def _tiny(extra=None):
    out = copy.deepcopy(TINY)
    for k, v in (extra or {}).items():
        for kk, vv in v.items():
            if isinstance(vv, dict):
                out.setdefault(k, {}).setdefault(kk, {}).update(vv)
            else:
                out.setdefault(k, {})[kk] = vv
    return out


# each cell's tiny sizes
TINY_OF = {"fateavatar.insta-train": _tiny(), "fateavatar.imavatar-train": _tiny(),
           "monogaussianavatar.train": _tiny(FEW_POINTS),
           "fateavatar.reenact": _tiny(SHORT_CLIPS)}
TRAIN_CELLS = ["fateavatar.insta-train", "fateavatar.imavatar-train",
               "monogaussianavatar.train"]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_train_cell_correct_on_cpu(cell):
    r = run_cell(cell, SEED, 0.5, False, device="cpu", overrides=TINY_OF[cell])
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"train_steps_per_s", "setup_s"}
    assert list(r)[-1] == "checks"


def test_reenact_cell_correct_on_cpu_traced():
    r = run_cell("fateavatar.reenact", SEED, 0.5, True, device="cpu",
                 overrides=TINY_OF["fateavatar.reenact"])
    assert r["correct"], r["checks"]
    assert r["readings"]["clips"] >= 1 and r["device"]["window_s"] > 0
    # no device on the CPU: nothing that reads the card's trace reports
    assert "blend_fwd_roofline.reenact" not in r["metrics"]


@pytest.mark.parametrize("cell", ["fateavatar.insta-train", "monogaussianavatar.train"])
def test_stale_step_is_not_correct(monkeypatch, cell):
    """The training step returns its state unchanged."""
    import fateavatar_tpu_torch.train.step as step

    monkeypatch.setattr(step, "copy_train_state_", lambda dst, src: None)
    r = run_cell(cell, SEED, 0.5, False, device="cpu", overrides=TINY_OF[cell])
    assert not r["correct"]
    assert r["checks"]["update_norm_gap"]["value"] >= 0.99


def test_altered_frame_is_not_correct(monkeypatch):
    """A served frame altered where it is produced."""
    from fateavatar_tpu_torch.train.loader import Reenactor

    orig = Reenactor.reenact

    def altered(self, *a, **k):
        frames = orig(self, *a, **k)
        f = frames[-1].copy()
        f[5:9, 5:9] = 255 - f[5:9, 5:9]
        return frames[:-1] + [f]

    monkeypatch.setattr(Reenactor, "reenact", altered)
    r = run_cell("fateavatar.reenact", SEED, 0.5, False, device="cpu",
                 overrides=TINY_OF["fateavatar.reenact"])
    assert not r["correct"]


def _readings(cell):
    return (calibrate.reenact_readings if registry.cell(cell)["kind"] == "reenact"
            else calibrate.train_readings)


@pytest.mark.parametrize("cell", sorted(TINY_OF))
def test_control_is_not_correct(cell):
    """The reference one precision step below the configuration's, in the
    program's place, fails the cell's limits."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = make_ctx(cell, SEED, 0.5, False, torch.device("cpu"), tmp, TINY_OF[cell])
        numbers = _readings(cell)(ctx, control=True)
    ok, checks = check.verdict(numbers, registry.cell(cell)["limits"])
    assert not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(TINY_OF))
def test_control_is_not_correct_on_card(card, cell):
    """The control at the cell's own size on the card."""
    with tempfile.TemporaryDirectory() as tmp:
        numbers = _readings(cell)(make_ctx(cell, SEED, 12.0, False, card, tmp), control=True)
    assert not check.verdict(numbers, registry.cell(cell)["limits"])[0]


def test_import_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "fateavatar_tpu_torch_x", types.ModuleType("x"))
    assert "fateavatar_tpu" not in forbidden_modules() or "fateavatar_tpu" in {
        m.split(".")[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert "jax" in forbidden_modules()


def test_harness_loads_no_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import portbench.run, portbench.calibrate, portbench.drivers.train,"
            " portbench.drivers.reenact, portbench.drivers.train_mono,"
            " fateavatar_tpu_torch.train.trainer;"
            "from portbench import registry;"
            "[registry.metric(m['name']) for m in registry.benchmark()['per_layer']];"
            "from portbench.run import forbidden_modules; bad = forbidden_modules();"
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, ROOT], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "portbench", "run.py"),
                          "--workload", "fateavatar.reenact", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
