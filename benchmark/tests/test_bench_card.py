"""The run's command as the driver starts it: no result without a card or
without the program, and, on the card, a short correct run of each cell."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import harness

CELLS = [w["name"] for w in harness.load_json(harness.ROOT, "BENCHMARK.json")["workloads"]]


def _run(cwd, cell, seconds=2, trace=0, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2**32 + 17), "--seconds", str(seconds), "--trace", str(trace)],
        cwd=cwd, capture_output=True, text=True, timeout=600,
        env=env or dict(os.environ))


@pytest.mark.parametrize("cell", CELLS)
def test_no_result_without_a_card(cell):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run(harness.ROOT, cell)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "is_available() is False" in p.stderr or "NVML finds no card" in p.stderr


def test_no_result_without_the_program(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = _run(tmp_path, CELLS[0], env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "not in this checkout" in p.stderr


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    # a traced CLI window alternates import-timed and profiled processes:
    # long enough for one of each
    cli = harness.cell_spec(cell)["traffic"]["driver"] == "cliprocess"
    p = _run(harness.ROOT, cell, seconds=15 if cli else 3, trace=1)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["busy_s"] > 0
