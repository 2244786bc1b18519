"""The per-layer metrics that read the program's own tracing
(``fateavatar_tpu_torch/utils/profiling.py``), on the CPU at tiny sizes:
traced runs report them from the program's counters over the window alone
and leave tracing off, a program without those counters (a parent
commit's) reports nothing and raises nothing, and ``portbench/stages.py``
splits a synthetic trace's idle time by span and its kernels by stage."""

import sys
import types
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from portbench import registry, stages
from portbench.drivers.reenact import TRACE_CLIPS
from portbench.run import run_cell
from test_portbench_harness import SEED, TINY_OF

NEW = ("graph_capture_ms.reenact", "drain_wait_ms.reenact", "trainer_eager_share.train")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_traced_reenact_reports_the_program_counters():
    from fateavatar_tpu_torch.utils import profiling

    r = run_cell("fateavatar.reenact", SEED, 0.5, True, device="cpu",
                 overrides=TINY_OF["fateavatar.reenact"])
    assert r["correct"], r["checks"]
    assert not profiling.is_tracing()
    n = r["readings"]["clips"]
    h = profiling.history("reenact.drain_s")
    # set-up's call, the window's, the traced call's
    assert len(h) >= 1 + n + TRACE_CLIPS
    got = r["metrics"]["drain_wait_ms.reenact"]
    window = h[len(h) - n - TRACE_CLIPS:len(h) - TRACE_CLIPS]
    assert got["unit"] == "ms" and got["value"] == pytest.approx(1e3 * sum(window) / n)
    assert got["value"] > 0
    # the CPU's graphs run their function: nothing is captured
    assert "graph_capture_ms.reenact" not in r["metrics"]


def test_traced_mono_reports_the_trainer_counters():
    r = run_cell("monogaussianavatar.train", SEED, 0.5, True, device="cpu",
                 overrides=TINY_OF["monogaussianavatar.train"])
    assert r["correct"], r["checks"]
    m = r["metrics"]
    assert m["trainer_eager_share.train"]["unit"] == "%"
    assert m["trainer_eager_share.train"]["value"] == pytest.approx(
        m["eager_step_share.train"]["value"])


@pytest.mark.parametrize("name", NEW)
def test_reader_without_the_program_counters_reports_nothing(monkeypatch, name):
    reader = registry.metric(name)
    r = {"clips": 3, "epochs": 1, "trace_replays": 20}
    monkeypatch.delitem(sys.modules, "fateavatar_tpu_torch.utils.profiling", raising=False)
    assert reader.read(r) is None
    monkeypatch.setitem(sys.modules, "fateavatar_tpu_torch.utils.profiling",
                        types.ModuleType("profiling"))
    assert reader.read(r) is None


def test_readers_take_the_window_alone(monkeypatch):
    """Set-up's call (first) and the traced call or epoch (last) are left
    out."""
    hist = {"graph.capture_s": [0.9, 0.2, 0.2, 0.3, 0.7],
            "reenact.drain_s": [0.5, 0.05, 0.05, 0.08, 0.5],
            "trainer.steps_replayed": [99, 8, 10, 10],
            "trainer.steps_eager_maintenance": [0, 2, 0, 0],
            "trainer.steps_eager_per_step": [0, 0, 0, 10]}
    mod = types.ModuleType("profiling")
    mod.history = lambda name: list(hist.get(name, []))
    monkeypatch.setitem(sys.modules, "fateavatar_tpu_torch.utils.profiling", mod)
    reenact = {"clips": 3}
    assert registry.metric("graph_capture_ms.reenact").read(reenact) == pytest.approx(700 / 3)
    assert registry.metric("drain_wait_ms.reenact").read(reenact) == pytest.approx(60.0)
    assert registry.metric("drain_wait_ms.reenact").read({"clips": 5}) is None
    share = registry.metric("trainer_eager_share.train")
    assert share.read({"epochs": 2, "trace_replays": 20}) == pytest.approx(10.0)
    assert share.read({"epochs": 2}) == pytest.approx(100 * 10 / 30)


def _event(kind, name, a, b):
    return SimpleNamespace(device_type=kind, name=name,
                           time_range=SimpleNamespace(start=a, end=b))


def _trace():
    """Device: k1, a mark, k2, a mark, k3, and the device copy of an
    ``fa.`` range over the first 40 us; host: a call span over all of it
    with a drain span inside."""
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [_event(cuda, "k1", 0, 10), _event(cuda, stages.MARK, 10, 11),
              _event(cuda, "k2", 20, 30), _event(cuda, stages.MARK, 31, 32),
              _event(cuda, "k3", 50, 60), _event(cuda, "fa.graph.replay", 0, 40),
              _event(cpu, "fa.reenact.call", 0, 100), _event(cpu, "fa.reenact.drain", 35, 45),
              _event(cpu, "aten::copy_", 36, 44)]
    return SimpleNamespace(events=lambda: events)


def test_idle_by_span_on_a_synthetic_trace():
    """Each idle stretch goes to the innermost ``fa.`` span over it; the
    ``fa.`` range's device copy is no device work."""
    got = stages.idle_by_span(_trace())
    assert got == pytest.approx({"fa.reenact.call": 18e-6, "fa.reenact.drain": 10e-6})
    assert stages.idle_by_span(SimpleNamespace(events=lambda: [
        _event(DeviceType.CUDA, "k", 0, 1), _event(DeviceType.CUDA, "k", 3, 4)])) == \
        pytest.approx({stages.OUTSIDE: 2e-6})


def test_by_stage_on_a_synthetic_trace():
    """A kernel goes under the mark before it; before the first mark it is
    left out, after ``end`` it goes under ``(after end)``."""
    got = stages.by_stage(_trace(), [(0, "forward"), (5, "end")])
    assert got == {"forward": {"ms": pytest.approx(0.01), "top": [["k2", pytest.approx(0.01)]]},
                   stages.AFTER_END: {"ms": pytest.approx(0.01),
                                      "top": [["k3", pytest.approx(0.01)]]}}
