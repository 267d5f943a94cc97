"""The readers of the program's spans and counters: the host layers, the
device clock's copies, the padding share and the CLI process start, on
canned METRICS stages and counters, and None where the program has none
(as at a commit before them)."""

import sys
from types import ModuleType, SimpleNamespace

import pytest

import harness

# reader -> (the METRICS stage it reads, the factor to its unit)
STAGE_READERS = {
    "parse_ms": ("parse", 1e3),
    "pack_ms": ("pack", 1e3),
    "emit_ms": ("emit", 1e3),
    "write_ms": ("write", 1e3),
    "h2d_ms": ("gpu_h2d", 1e3),
    "d2h_ms": ("gpu_d2h", 1e3),
    "cli_torch_import_s": ("import_torch", 1.0),
    "cli_cuda_init_s": ("cuda_init", 1.0),
    "cli_lib_load_s": ("lib_load", 1.0),
}


def _run(samples):
    return SimpleNamespace(samples=samples, window_s=10.0, device={},
                           counts={}, spec={})


@pytest.mark.parametrize("name", sorted(STAGE_READERS))
def test_stage_reader_mean_per_call(name):
    """The mean over the calls (or processes) with stages, a call without
    the stage counting 0; samples without stages (a profiled process) are
    left out."""
    stage, unit = STAGE_READERS[name]
    samples = [
        {"ok": True, "wall": 0.5, "stages": {"total": 0.5, stage: 0.010}},
        {"ok": True, "wall": 0.5, "stages": {"total": 0.5, stage: 0.030}},
        {"ok": True, "wall": 0.5, "stages": {"total": 0.5}},
        {"ok": True, "wall": 0.9, "trace": []},
    ]
    value = harness.load_part("metrics", name).read(_run(samples))
    assert value == pytest.approx(0.040 / 3 * unit)


@pytest.mark.parametrize("name", sorted(STAGE_READERS))
def test_stage_reader_none_without_the_stage(name):
    """A program without the stage (the parent commit's) reads None."""
    reader = harness.load_part("metrics", name)
    parent = [{"ok": True, "wall": 0.5,
               "stages": {"total": 0.5, "device_chain_scan": 0.02}}]
    assert reader.read(_run(parent)) is None
    assert reader.read(_run([{"ok": True, "wall": 0.5}])) is None
    assert reader.read(_run([])) is None


def _program_metrics(monkeypatch, metrics):
    module = ModuleType(harness.PROGRAM + ".core.metrics")
    if metrics is not None:
        module.METRICS = metrics
    monkeypatch.setitem(sys.modules, module.__name__, module)


def test_pad_share_from_the_program_counters(monkeypatch):
    _program_metrics(monkeypatch, SimpleNamespace(
        stages={}, counts={"slots": 4000, "padded_slots": 3400}))
    read = harness.load_part("metrics", "pad_share").read
    assert read(_run([])) == pytest.approx(85.0)


@pytest.mark.parametrize(
    "metrics",
    [None, SimpleNamespace(stages={}), SimpleNamespace(stages={}, counts={}),
     "not loaded"],
    ids=["no-METRICS", "no-counters", "no-slots", "program-not-loaded"])
def test_pad_share_none_without_counters(metrics, monkeypatch):
    if metrics == "not loaded":
        monkeypatch.delitem(sys.modules, harness.PROGRAM + ".core.metrics",
                            raising=False)
    else:
        _program_metrics(monkeypatch, metrics)
    assert harness.load_part("metrics", "pad_share").read(_run([])) is None
