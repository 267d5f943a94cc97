"""The port's spans and counters (core/metrics.py) where the benchmark's
cells work: paf2chain's and stat's device routes (WGA_TORCH_DEVICE=cpu,
the kernels' plain versions), the process start, the -vv lines that
benchmark/drivers/cliprocess.py parses, and the profiler annotations.
"""

import importlib.util
import json
import logging
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from wgatools_tpu_torch import cli
from wgatools_tpu_torch.core import metrics as metrics_mod
from wgatools_tpu_torch.core.metrics import METRICS, Metrics
from wgatools_tpu_torch.io.paf import PafReader
from wgatools_tpu_torch.ops.batch import stream_seq_pair_stats
from wgatools_tpu_torch.scripts import make_corpus
from wgatools_tpu_torch.tools import convert
from wgatools_tpu_torch.tools import stat as stat_tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_STAGES = ("parse", "pack", "emit", "write")
# tool -> (arguments, its device stages)
TOOLS = {
    "paf2chain": (["paf2chain", "{paf}"], ("device_chain_scan",)),
    "stat": (["stat", "{maf}"], ("device_stats",)),
}
PROCESS_START = ("import_torch", "cuda_init", "lib_load")


def _paf_line(i, n_ops):
    """One PAF record whose CIGAR has exactly n_ops ops (no two neighbours
    alike), its coordinates consistent with them."""
    cycle = (("=", 9), ("X", 1), ("=", 7), ("I", 2), ("=", 5), ("D", 3))
    ops = [cycle[k % len(cycle)] for k in range(n_ops)]
    t_adv = sum(n for op, n in ops if op in "=XD")
    q_adv = sum(n for op, n in ops if op in "=XI")
    eq = sum(n for op, n in ops if op == "=")
    cg = "".join(f"{n}{op}" for op, n in ops)
    strand = "-" if i % 3 == 0 else "+"
    return (f"q{i}\t{q_adv + 50}\t20\t{20 + q_adv}\t{strand}\tt{i % 2}\t"
            f"{t_adv + 1000}\t30\t{30 + t_adv}\t{eq}\t{t_adv}\t60\tcg:Z:{cg}\n")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A PAF of 40 records (~24 000 ops) and a MAF of 6 blocks of 20 000
    columns, from seed 5."""
    d = tmp_path_factory.mktemp("metrics")
    rng = np.random.default_rng(5)
    paths = {"paf": str(d / "in.paf"), "maf": str(d / "in.maf"), "dir": str(d)}
    with open(paths["paf"], "w") as f:
        for i in range(40):
            f.write(_paf_line(i, int(rng.integers(100, 1100))))
    make_corpus.make_maf(paths["maf"], rng, 6, 20_000)
    return paths


@pytest.fixture
def device_route(monkeypatch):
    """The device route on the CPU at any input size, METRICS emptied."""
    monkeypatch.setenv("WGA_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("WGA_TPU_DEVICE", raising=False)
    monkeypatch.delenv(metrics_mod.TRACE_ENV, raising=False)
    monkeypatch.setattr(convert, "DEVICE_MIN_OPS", 0)
    monkeypatch.setattr(stat_tool, "DEVICE_MIN_COLUMNS", 1)
    monkeypatch.setattr(METRICS, "stages", {})
    monkeypatch.setattr(METRICS, "counts", {})


def _argv(tool, inputs, out):
    return [a.format(**inputs) for a in TOOLS[tool][0]] + ["-o", out, "-r"]


def _host_bytes(tool, inputs, tmp_path, monkeypatch):
    out = str(tmp_path / "host.out")
    monkeypatch.setenv("WGA_TPU_DEVICE", "0")
    assert cli.main(_argv(tool, inputs, out)) == 0
    monkeypatch.delenv("WGA_TPU_DEVICE")
    with open(out, "rb") as f:
        return f.read()


def _raise(*args, **kwargs):
    raise AssertionError("record_function called without a profiler")


@pytest.mark.parametrize("tool", list(TOOLS))
def test_device_route_stages(tool, inputs, device_route, tmp_path,
                             monkeypatch):
    """The four host stages and the tool's device stage, each once or more,
    together no longer than `total`; no record_function without a profiler;
    the host route's bytes."""
    want = _host_bytes(tool, inputs, tmp_path, monkeypatch)
    METRICS.stages.clear()
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    out = str(tmp_path / "dev.out")
    assert cli.main(_argv(tool, inputs, out)) == 0
    stages = {k: v[0] for k, v in METRICS.stages.items()}
    parts = HOST_STAGES + TOOLS[tool][1]
    assert all(stages.get(k, 0) > 0 for k in parts), stages
    assert sum(stages[k] for k in parts) <= stages["total"]
    # the device clock records nothing on the CPU
    assert not [k for k in stages if k.startswith("gpu_")]
    with open(out, "rb") as f:
        assert f.read() == want


def _annotations(trace_dir):
    (path,) = [os.path.join(trace_dir, p) for p in os.listdir(trace_dir)]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and e["name"].startswith(metrics_mod.ANNOTATION_PREFIX)]


@pytest.mark.parametrize("tool", list(TOOLS))
def test_trace_annotations_nest_in_total(tool, inputs, device_route,
                                         tmp_path, monkeypatch):
    """Under WGA_TPU_TRACE the host stages and the device stage are wga.*
    annotations inside the call's wga.total, none overlapping another."""
    trace_dir = str(tmp_path / "trace")
    monkeypatch.setenv(metrics_mod.TRACE_ENV, trace_dir)
    assert cli.main(_argv(tool, inputs, str(tmp_path / "out"))) == 0
    spans = _annotations(trace_dir)
    (total,) = [(s, e) for n, s, e in spans if n == "wga.total"]
    parts = sorted((s, e, n) for n, s, e in spans
                   if n[4:] in HOST_STAGES + TOOLS[tool][1])
    assert {n[4:] for _, _, n in parts} == set(HOST_STAGES + TOOLS[tool][1])
    assert all(total[0] <= s and e <= total[1] for s, e, _ in parts)
    assert all(a[1] <= b[0] for a, b in zip(parts, parts[1:])), parts


def test_annotations_per_phase_not_per_record(inputs, device_route):
    """Under a profiler, each batch of paf2chain is one stretch of pack,
    of the device stage, of emit and of write, whatever records it holds."""
    from torch.profiler import ProfilerActivity, profile

    with open(inputs["paf"], "rb") as f, \
            open(os.path.join(inputs["dir"], "p.chain"), "wb") as w, \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        convert._paf2chain_device(PafReader(f), w, torch.device("cpu"),
                                  batch_ops=9000, min_ops=0)
    names = [e.name for e in prof.events()
             if e.name.startswith(metrics_mod.ANNOTATION_PREFIX)]
    with open(inputs["paf"], "rb") as f:
        n_ops = [len(r.get_cigar_ops()[0]) for r in PafReader(f).records()]
    batches, filled = 0, 0
    for n in n_ops:  # a batch is sent once it holds 9000 ops or more
        filled += n
        if filled >= 9000:
            batches, filled = batches + 1, 0
    batches += filled > 0
    assert batches >= 3 and len(n_ops) == 40
    for phase in ("pack", "emit", "device_chain_scan"):
        assert names.count("wga." + phase) == batches, names
    # one stretch a batch, and the writer's flush at the end
    assert names.count("wga.write") == batches + 1


def _paf_records(lengths):
    return [_paf_line(i, n).encode() for i, n in enumerate(lengths)]


@pytest.mark.parametrize(
    "tool,lengths,batch,want",
    [("paf2chain", [100, 250, 300], 1 << 20, (3 * 384, 3 * 384 - 650)),
     ("stat", [100, 250], 1 << 20, (2 * 256, 2 * 256 - 350)),
     ("stat", [100, 250, 3000], 1000, (512 + 3072, 512 - 350 + 3072 - 3000))],
    ids=["paf2chain", "stat-one-batch", "stat-two-batches"])
def test_slot_counters_by_hand(tool, lengths, batch, want, device_route):
    """slots and padded_slots of batches of known record lengths: each
    batch pads its rows to the longest, rounded up to 128."""
    cpu = torch.device("cpu")
    if tool == "paf2chain":
        sink = open(os.devnull, "wb")
        with sink:
            convert._paf2chain_device(PafReader(_paf_records(lengths)), sink,
                                      cpu, batch_ops=batch, min_ops=0)
    else:
        rng = np.random.default_rng(1)
        items = [(rng.choice(list(b"ACGT-"), n).astype(np.uint8).tobytes(),
                  rng.choice(list(b"ACGT-"), n).astype(np.uint8).tobytes(),
                  False, k) for k, n in enumerate(lengths)]
        assert len(list(stream_seq_pair_stats(items, cpu, batch))) == len(
            lengths)
    assert (METRICS.counts["slots"], METRICS.counts["padded_slots"]) == want


def _cliprocess():
    spec = importlib.util.spec_from_file_location(
        "bench_cliprocess", os.path.join(REPO, "benchmark", "drivers",
                                         "cliprocess.py"))
    sys.path.insert(0, os.path.join(REPO, "benchmark"))
    try:
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(os.path.join(REPO, "benchmark"))
    return module


def test_vv_lines_match_cliprocess_pattern(inputs, device_route, tmp_path,
                                       caplog):
    """-vv: one `stage <name> <secs>s` line a stage, read back by
    cliprocess.py's pattern with every stage, and `count <name> <n>` lines that
    the pattern leaves alone."""
    with caplog.at_level(logging.DEBUG, logger="wgatools_tpu_torch"):
        assert cli.main(
            _argv("stat", inputs, str(tmp_path / "out")) + ["-vv"]) == 0
    err = "".join(r.getMessage() + "\n" for r in caplog.records).encode()
    parsed = {k.decode(): float(v) for k, v in _cliprocess()._STAGE.findall(err)}
    assert set(parsed) == set(METRICS.stages)
    assert all(abs(parsed[k] - v[0]) < 1e-3 for k, v in METRICS.stages.items())
    counts = dict(re.findall(rb"count (\S+) (\d+)\n", err))
    assert {k.decode(): int(v) for k, v in counts.items()} == METRICS.counts
    assert METRICS.counts["slots"] > METRICS.counts["padded_slots"] > 0


# `python -m wgatools_tpu_torch ARGS` in a process that says at its end
# whether torch was loaded; under WGA_TPU_DEVICE=0 its imports of torch fail
RUN = """
import runpy, sys

class NoTorch:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "torch":
            raise ImportError(f"{name} imported on the host route")

if sys.argv.pop(1) == "host":
    sys.meta_path.insert(0, NoTorch())
try:
    runpy.run_module("wgatools_tpu_torch", run_name="__main__", alter_sys=True)
finally:
    print("torch loaded:", "torch" in sys.modules, file=sys.stderr)
"""


@pytest.mark.parametrize(
    "route,want",
    [("host", ()), ("device", ("import_torch", "lib_load"))],
    ids=["host", "device-cpu"])
def test_process_start_stages(route, want, inputs, tmp_path):
    """A fresh process: the host route records no process start stage and
    loads no torch; the device route on the CPU times its import of torch
    and the native library's load, and no CUDA context."""
    env = dict(os.environ, PYTHONPATH=REPO, WGA_TORCH_DEVICE="cpu")
    env.pop(metrics_mod.TRACE_ENV, None)
    env.pop("WGA_TPU_DEVICE", None)
    if route == "host":
        env["WGA_TPU_DEVICE"] = "0"
    argv = _argv("paf2chain", inputs, str(tmp_path / "out")) + ["-vv"]
    proc = subprocess.run([sys.executable, "-c", RUN, route, *argv],
                          capture_output=True, env=env, cwd=REPO, timeout=120)
    err = proc.stderr.decode()
    assert proc.returncode == 0, err
    stages = set(re.findall(r"stage (\S+)", err))
    assert "total" in stages
    assert stages & set(PROCESS_START) == set(want)
    assert f"torch loaded: {route == 'device'}" in err.splitlines()


class _Event:
    def __init__(self, done, ms):
        self.done, self.ms, self.waited = done, ms, False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited = self.done = True

    def elapsed_time(self, end):
        assert end.done
        return end.ms


def test_settle_reads_completed_spans_only():
    """settle() adds the spans whose end event has completed and keeps the
    rest; settle(wait=True) waits for those left."""
    m = Metrics()
    ends = [_Event(True, 2.0), _Event(False, 5.0), _Event(True, 1.0)]
    m._gpu = [("gpu_h2d", _Event(True, 0), ends[0]),
              ("gpu_d2h", _Event(True, 0), ends[1]),
              ("gpu_h2d", _Event(True, 0), ends[2])]
    m.settle()
    assert m.stages == {"gpu_h2d": [pytest.approx(3e-3), 0]}
    assert [e[0] for e in m._gpu] == ["gpu_d2h"] and not ends[1].waited
    m.settle(wait=True)
    assert ends[1].waited and m._gpu == []
    assert m.stages["gpu_d2h"] == [pytest.approx(5e-3), 0]


def test_phases_switch_and_stop():
    m = Metrics()
    phase = m.phases()
    phase.to("parse")
    phase.to("pack")
    phase.to("parse")
    phase.stop()
    phase.stop()
    assert set(m.stages) == {"parse", "pack"}
    assert all(v[0] >= 0 for v in m.stages.values())


def test_gpu_spans_within_the_device_stage(inputs, monkeypatch, tmp_path):
    """On the card: paf2chain's gpu_h2d and gpu_d2h, on the device clock,
    fit inside its device stage on the host clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    monkeypatch.setenv("WGA_TORCH_DEVICE", "cuda")
    monkeypatch.delenv("WGA_TPU_DEVICE", raising=False)
    monkeypatch.setattr(convert, "DEVICE_MIN_OPS", 0)
    monkeypatch.setattr(METRICS, "stages", {})
    assert cli.main(_argv("paf2chain", inputs, str(tmp_path / "out"))) == 0
    s = {k: v[0] for k, v in METRICS.stages.items()}
    assert s["gpu_h2d"] > 0 and s["gpu_d2h"] > 0
    assert s["gpu_h2d"] + s["gpu_d2h"] <= s["device_chain_scan"]
