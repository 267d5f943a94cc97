"""A run driven on the CPU, the harness's look for the card skipped, with
the timed path broken underneath: `correct` comes out false for each fault
a one-card tool cell can have (a step that returns its state unchanged,
half of the batch left out, an answer altered where it is produced), and
true with nothing broken.  The cells run at a size a test can hold: their
traffic and the judging are the cells' own.  (No cell of this benchmark
exchanges data between cards, so that fault has no test.)"""

import json
import os
import sys

import pytest
import torch

import harness
import run as runmod

# ~110 Ki ops of PAF and ~4.5 Mi columns of MAF, above the program's
# DEVICE_MIN_OPS and DEVICE_MIN_COLUMNS, so that both take the device route
SMALL = {"paf": {"columns": 4_000_000, "block_max": 400_000},
         "maf": {"columns": 4_500_000}}


def _fault(kind):
    """A wrapper of a device step returning (tensor, ...) or a tensor."""
    def wrap(fn):
        def broken(*args):
            out = fn(*args)
            many = isinstance(out, tuple)
            outs = list(out) if many else [out]
            for t in outs:
                if kind == "unchanged":
                    t.zero_()
                elif kind == "half":
                    t[t.shape[0] // 2:] = 0
                elif kind == "altered":
                    # one record's answer wrong where it is produced
                    t[t.shape[0] // 3] += torch.arange(t.shape[-1], dtype=t.dtype)
            return tuple(outs) if many else outs[0]
        return broken
    return wrap


@pytest.fixture
def cpu_run(monkeypatch, capsys, tmp_path):
    saved = dict(os.environ)
    spec = harness.cell_spec

    def small(workload):
        s = spec(workload)
        params = s["config"]["generator"]["params"]
        params.update(SMALL[params["fmt"]])
        s["work"]["kernels"] = []  # the plain versions count no launch
        return s

    monkeypatch.setattr(harness, "cell_spec", small)
    cache = tmp_path / "inputs"
    cached = harness.cached_input
    monkeypatch.setattr(harness, "cached_input",
                        lambda spec, seed: cached(spec, seed, cache_dir=str(cache)))

    class NoPoll:
        peak = 0

        def __init__(self, n):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            pass

    monkeypatch.setattr(harness, "MemoryPoller", NoPoll)

    def go(workload, seconds=1.0, seed=2**33 + 5):
        capsys.readouterr()
        try:
            rc = runmod.main(
                ["--workload", workload, "--seed", str(seed), "--seconds",
                 str(seconds), "--trace", "0"],
                card=lambda chips: "cpu (test)",
                pin=lambda env: dict(harness.pinned_env(env), WGA_TORCH_DEVICE="cpu"))
        finally:
            os.environ.clear()
            os.environ.update(saved)
        out = capsys.readouterr().out.strip().splitlines()
        assert rc == 0
        return json.loads(out[-1])

    return go


STEPS = {
    "p2c-chr-paf": ("wgatools_tpu_torch.ops.liftover", "chain_scan"),
    "stat-chr-maf": ("wgatools_tpu_torch.ops.batch", "classify_stat_cat"),
}


@pytest.mark.parametrize("cell", sorted(STEPS))
def test_sound_run_is_correct(cpu_run, cell):
    result = cpu_run(cell)
    assert result["correct"] and result["failed"] == 0
    assert result["checks"]["outputs_checked"]["value"] >= 1
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", sorted(STEPS))
def test_fault_is_not_correct(cpu_run, monkeypatch, cell, kind):
    module, name = STEPS[cell]
    __import__(module)
    mod = sys.modules[module]
    monkeypatch.setattr(mod, name, _fault(kind)(getattr(mod, name)))
    result = cpu_run(cell)
    assert not result["correct"]
    assert result["checks"]["differing_outputs"]["value"] > 0


PLANT = """import runpy, sys
sys.path.insert(0, {bench!r})
import torch
from wgatools_tpu_torch.ops import liftover
from tests.test_bench_faults import _fault
liftover.chain_scan = _fault({kind!r})(liftover.chain_scan)
sys.argv[0] = "wgatools-tpu-torch"
runpy.run_module("wgatools_tpu_torch", run_name="__main__")
"""


@pytest.mark.parametrize("kind", [None, "altered"])
def test_cli_cell(cpu_run, monkeypatch, tmp_path, kind):
    """The CLI cell's processes, each with the fault planted before the
    command line starts (none: a sound run)."""
    cli = harness.load_part("drivers", "cliprocess")
    launcher = tmp_path / "launcher"
    if kind is not None:
        (tmp_path / "plant.py").write_text(PLANT.format(bench=harness.BENCH, kind=kind))
        launcher.write_text(f"#!/bin/sh\nexec {sys.executable} {tmp_path / 'plant.py'} \"$@\"\n")
    else:
        launcher.write_text(f"#!/bin/sh\nexec {sys.executable} -m wgatools_tpu_torch \"$@\"\n")
    launcher.chmod(0o755)
    setup = cli.setup

    def patched(run):
        setup_launcher = os.path.join(harness.ROOT, "bin", "wgatools-tpu-torch")
        assert os.path.exists(setup_launcher)
        run.state = None
        setup(run)
        run.state["launcher"] = str(launcher)
    monkeypatch.setattr(harness, "load_part", _swap(harness.load_part, "drivers",
                                                     "cliprocess", setup=patched))
    result = cpu_run("p2c-chr-paf-cli", seconds=0.5)
    assert result["correct"] is (kind is None)


def _swap(load_part, kind, name, **attrs):
    def load(k, n):
        module = load_part(k, n)
        if (k, n) == (kind, name):
            for a, v in attrs.items():
                setattr(module, a, v)
        return module
    return load
