"""The `asm-maf` cells on the CPU: the generator writes what its
configuration states (SNV, indel and SV rates, record lengths and their
order the same for every seed), the plain reference of `call` writes what
the program's host engine writes and its control does not, the readers of
the new metrics, and a run of each cell driven on the CPU (the ranks over
gloo), sound and with a run table altered where the device route makes it.
The port's own CPU tests (tests/test_torch_call_asm.py) hold the reference
against the device route and the ranks kept across calls."""

import io
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

import harness
import run as runmod
from wgatools_tpu_torch.core.metrics import METRICS
from wgatools_tpu_torch.io.maf import MafReader
from wgatools_tpu_torch.tools.caller import call_var_maf

GEN = harness.load_part("gen", "assembly")
REF = harness.load_part("reference", "call")
CELLS = ("call-asm-maf", "call-asm-maf-4card")
# ~12 Mi columns: records of 4 Mi columns and more take the device route
SMALL = {"columns": 12_000_000, "record_max": 6_000_000}


def _columns(path):
    """(X columns, [(I or D, length)] of the gap runs, records' columns)."""
    x, gaps, cols = 0, [], []
    for t, q in REF.blocks(path):
        t, q = np.frombuffer(t[6], np.uint8), np.frombuffer(q[6], np.uint8)
        cols.append(t.size)
        x += int(((t != q) & (t != 45) & (q != 45)).sum())
        for row, kind in ((t, "I"), (q, "D")):
            edges = np.flatnonzero(np.diff(np.concatenate(
                ([0], (row == 45).view(np.int8), [0]))))
            gaps += [(kind, int(n)) for n in edges[1::2] - edges[0::2]]
    return x, gaps, cols


@pytest.mark.parametrize("seed", [5, 2**31 + 5])
def test_stated_rates(tmp_path, seed):
    path = tmp_path / "a.maf"
    counts = GEN.generate(path, seed, columns=30_000_000, record_max=3_000_000)
    x, gaps, cols = _columns(path)
    assert sum(cols) == counts["aligned_columns"] == 30_000_000
    short = [n for _, n in gaps if n < 50]
    svs = [(k, n) for k, n in gaps if n >= 50]
    assert counts["snv"] == x and len(short) == counts["indel"]
    assert len(svs) == counts["sv"]
    assert x / 30e6 == pytest.approx(0.001, rel=0.05)
    assert len(short) / 30e6 == pytest.approx(0.00015, rel=0.1)
    assert len(svs) / 30 == pytest.approx(6.6, rel=0.2)
    assert np.mean(short) == pytest.approx(2, rel=0.1) and max(short) <= 49
    assert 50 <= min(n for _, n in svs) and max(n for _, n in svs) < 10_000
    kinds = [k for k, _ in svs]
    assert 0.3 < kinds.count("I") / len(kinds) < 0.7


def test_record_lengths_and_order_are_the_same_for_every_seed(tmp_path):
    kw = dict(columns=3_000_000, record_min=5_000, record_max=600_000)
    a = GEN.generate(tmp_path / "a.maf", 1, **kw)
    b = GEN.generate(tmp_path / "b.maf", 2**33 + 1, **kw)
    ca, cb = _columns(tmp_path / "a.maf")[2], _columns(tmp_path / "b.maf")[2]
    assert ca == cb == GEN.record_lengths(3_000_000, 5_000, 600_000).tolist()
    assert a["records"] == b["records"] == len(ca)
    assert (tmp_path / "a.maf").read_bytes() != (tmp_path / "b.maf").read_bytes()
    full = GEN.record_lengths(145_000_000, 50_000, 40_000_000)
    assert len(full) == 24 and full.sum() == 145_000_000
    assert full.min() >= 50_000 and full.max() <= 40_000_000
    # ~90% of the columns lie in records of at least 4 Mi columns
    assert full[full >= 1 << 22].sum() / full.sum() == pytest.approx(0.9, abs=0.02)


@pytest.mark.parametrize("seed", [3, 2**32 + 1])
def test_reference_is_the_host_engine_and_control_differs(tmp_path, seed):
    path = tmp_path / "a.maf"
    GEN.generate(path, seed, columns=2_000_000, record_min=5_000,
                 record_max=400_000, minus_every=3)
    out = io.BytesIO()
    with open(path, "rb") as f:
        call_var_maf(MafReader(f), None, out, True, False, 50, None)
    want = REF.answer(path)
    assert want == out.getvalue()
    equal, lines = harness.compare(want, REF.answer(path, control=True))
    assert not equal and lines > 0


def _run(**kw):
    base = dict(samples=[], window_s=0.0, device={}, counts={}, spec={})
    base.update(kw)
    return SimpleNamespace(**base)


def test_readers():
    samples = [
        {"ok": True, "wall": 1.0, "stages": {"total": 1.0, "plan": 0.01},
         "ranks": [{"total": 1.0, "merge_wait": 0.5},
                   {"total": 1.0, "merge_wait": 0.0}]},
        {"ok": True, "wall": 1.0, "stages": {"total": 1.0, "plan": 0.03,
                                             "merge_wait": 0.2, "gather": 0.1},
         "ranks": [{"total": 0.9}, {"total": 0.9}]},
    ]
    run = _run(samples=samples)
    read = lambda name: harness.load_part("metrics", name).read(run)  # noqa: E731
    assert read("plan_ms") == pytest.approx(20.0)
    assert read("merge_wait_ms") == pytest.approx(100.0)
    assert read("gather_ms") == pytest.approx(50.0)
    # own times 0.5 and 1.0 (skew 1/0.75 - 1), then 0.9 and 0.9
    assert read("rank_skew") == pytest.approx((1 / 0.75 - 1) / 2 * 100)
    one = _run(samples=[{"ok": True, "wall": 1.0, "stages": {"total": 1.0}}])
    for name in ("plan_ms", "merge_wait_ms", "gather_ms", "rank_skew"):
        assert harness.load_part("metrics", name).read(one) is None


def test_device_route_share_reads_the_counters(monkeypatch):
    reader = harness.load_part("metrics", "device_route_share")
    monkeypatch.setattr(METRICS, "counts", {})
    assert reader.read(_run()) is None
    monkeypatch.setattr(METRICS, "counts", {"call_device_columns": 9,
                                            "call_host_columns": 1})
    assert reader.read(_run()) == pytest.approx(90.0)


@pytest.fixture
def cpu_run(monkeypatch, capsys, tmp_path):
    saved = dict(os.environ)
    spec = harness.cell_spec

    def small(workload):
        s = spec(workload)
        s["config"]["generator"]["params"].update(SMALL)
        s["work"]["kernels"] = []  # the plain versions count no launch
        return s

    monkeypatch.setattr(harness, "cell_spec", small)
    cached = harness.cached_input
    monkeypatch.setattr(harness, "cached_input", lambda spec, seed: cached(
        spec, seed, cache_dir=str(tmp_path / "inputs")))
    monkeypatch.setattr(METRICS, "counts", {})

    def go(workload, trace=0, seconds=1.0, seed=2**33 + 9):
        capsys.readouterr()
        try:
            rc = runmod.main(
                ["--workload", workload, "--seed", str(seed), "--seconds",
                 str(seconds), "--trace", str(trace)],
                card=lambda chips: "cpu (test)",
                pin=lambda env: dict(harness.pinned_env(env), WGA_TORCH_DEVICE="cpu"))
        finally:
            os.environ.clear()
            os.environ.update(saved)
        out = capsys.readouterr().out.strip().splitlines()
        assert rc == 0
        return json.loads(out[-1])

    return go


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cpu_run, cell):
    result = cpu_run(cell, trace=1)
    assert result["correct"] and result["failed"] == 0
    metrics = result["metrics"]
    assert 0 < metrics["device_route_share"]["value"] < 100
    assert metrics["plan_ms"]["value"] > 0
    if cell.endswith("4card"):
        assert result["device"]["count"] == 4
        for name in ("rank_skew", "merge_wait_ms", "gather_ms"):
            assert name in metrics


def test_altered_run_table_is_not_correct(cpu_run, monkeypatch):
    from wgatools_tpu_torch.ops import rle_device

    real = rle_device.extract_runs_cat

    def altered(*args):
        packed = real(*args)
        packed[packed.shape[0] // 3] += 1  # one run a column longer
        return packed

    monkeypatch.setattr(rle_device, "extract_runs_cat", altered)
    result = cpu_run("call-asm-maf")
    assert not result["correct"]
    assert result["checks"]["differing_outputs"]["value"] > 0
