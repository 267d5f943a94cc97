"""wgatools_tpu_torch/scripts/kernel_times.py, the timing harness of the
port's kernels across checkouts: its default order, its refusal without
CUDA, its measured calls run on the CPU at a small shape (the plain
versions there), and chip_smoke.py's use of its shapes and timing loop."""

import importlib.util
import os
import subprocess
import sys

import pytest
import torch

from wgatools_tpu_torch.scripts import kernel_times as KT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("constant, field", [
    ("BENCH_B", "B"), ("BENCH_L", "L"), ("CALL_ROW", "call_row"),
    ("SCAN_ROWS", "scan_rows"), ("SCAN_N", "scan_n"), ("SHARD_OPS", "n_ops"),
])
def test_chip_smoke_main_path_shapes_are_the_harness_shapes(constant, field):
    assert getattr(_chip_smoke(), constant) == getattr(KT.Shapes(), field)


def test_chip_smoke_times_with_the_harness_loop():
    assert _chip_smoke().time_ms is KT.time_ms


def test_default_order_alternates():
    assert KT.default_order(1) == [0, 0]
    assert KT.default_order(2) == [0, 1, 1, 0]
    assert KT.default_order(3) == [0, 1, 2, 2, 1, 0]


def test_measure_runs_every_call_at_a_small_shape():
    shapes = KT.Shapes(B=3, L=1024, call_row=1001, scan_rows=5, scan_n=7,
                       n_ops=64)
    calls = []

    def timer(fn):
        calls.append(fn())
        return 0.0

    ms = KT.measure(torch.device("cpu"), 0, shapes, timer)
    assert sorted(ms) == sorted([
        "A classify_cat", "B liftover_scan chain",
        "C fused_adv16 bench config", "D classify_bytes call row",
        "D classify_words", "E classify_nibbles", "F fused16 nibbles",
        "F fused16 words", "8 fused_ops u8+i32", "8 fused_ops packed",
        "8 fused_ops u8+i32 op rows alone", "8 fused_ops packed op rows alone",
        "8 fused_ops columns alone",
    ])
    assert len(calls) == len(ms)
    # kernel 8's op rows alone: 3 x 64 offsets, no column counted
    stats, t_off, q_off = calls[
        list(ms).index("8 fused_ops packed op rows alone")]
    assert t_off.shape == q_off.shape == (3, 64)
    assert int(stats.abs().sum()) == 0


def test_exits_2_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "wgatools_tpu_torch", "scripts",
                                      "kernel_times.py"), REPO],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "is_available() is False" in proc.stderr
