"""The arithmetic of the end-to-end metrics and of each per-layer reader, on
hand-made samples, a canned METRICS delta and a canned profiler trace."""

import json
import os
from types import SimpleNamespace

import pytest

import harness
import run as runmod


def _run(**kw):
    base = dict(samples=[], window_s=0.0, device={}, counts={}, spec={})
    base.update(kw)
    return SimpleNamespace(**base)


def test_nearest_rank_p95():
    walls = [float(i) for i in range(1, 101)]
    assert harness.nearest_rank(walls, 0.95) == 95.0
    assert harness.nearest_rank(walls[:20], 0.95) == 19.0
    assert harness.nearest_rank([2.0], 0.95) == 2.0
    assert harness.nearest_rank(list(reversed(walls)), 0.95) == 95.0


def test_end_to_end_over_the_whole_window():
    spec = {"end_to_end": [
        {"name": n, "unit": u} for n, u in (
            ("setup_s", "s"), ("tool_gbp_per_s", "Gbp/s"),
            ("tool_wall_p95_s", "s"), ("cli_process_s", "s"))]}
    samples = [{"ok": True, "wall": 0.5}] * 19 + [{"ok": True, "wall": 2.0}]
    run = _run(samples=samples, window_s=11.5, counts={"aligned_columns": 2e9},
               spec=spec)
    m = runmod.end_to_end(run, 9.0)
    assert m["setup_s"]["value"] == 9.0
    assert m["tool_gbp_per_s"]["value"] == pytest.approx(2e9 * 20 / 11.5 / 1e9)
    assert m["tool_wall_p95_s"]["value"] == 0.5
    assert m["cli_process_s"]["value"] == pytest.approx(11.5 / 20)


STAGES = [{"total": 0.50, "device_chain_scan": 0.004, "pack": 0.01},
          {"total": 0.52, "device_chain_scan": 0.006}]


def test_host_and_device_stage_ms():
    run = _run(samples=[{"ok": True, "wall": 0.6, "stages": s} for s in STAGES])
    host = harness.load_part("metrics", "host_ms").read(run)
    dev = harness.load_part("metrics", "device_stage_ms").read(run)
    assert host == pytest.approx((0.496 + 0.514) / 2 * 1e3)
    assert dev == pytest.approx(5.0)
    empty = _run(samples=[{"ok": True, "wall": 0.6, "stages": {"total": 0.5}}])
    assert harness.load_part("metrics", "device_stage_ms").read(empty) is None
    assert harness.load_part("metrics", "host_ms").read(_run()) is None


def _trace(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "scan_rows_kernel", "ts": 100.0, "dur": 10.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 105.0, "dur": 20.0},
        {"ph": "X", "cat": "kernel", "name": "scan_rows_kernel", "ts": 1000.0, "dur": 6.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 2000.0, "dur": 4.0},
        {"ph": "X", "cat": "kernel", "name": "ncclDevKernel_AllGather_RING_LL", "ts": 2002.0, "dur": 3.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::to", "ts": 90.0, "dur": 50.0},
        {"ph": "X", "cat": "user_annotation", "name": "invocation", "ts": 50.0, "dur": 1500.0},
        {"ph": "X", "cat": "user_annotation", "name": "invocation", "ts": 1600.0, "dur": 900.0},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_trace_summary_and_gaps(tmp_path):
    path = _trace(tmp_path)
    s = harness.summarize(harness.device_events(path))
    assert s["busy_s"] == pytest.approx((25 + 6 + 5) * 1e-6)
    assert s["kernel_s"] == pytest.approx(16e-6)
    assert s["by_name"]["scan_rows_kernel"] == pytest.approx(16e-6)
    gaps = harness.idle_gaps(s["busy"], harness.annotations(path, "invocation"))
    assert [g[0].startswith("the tool") for g in gaps] == [True, False]
    assert [g[1] for g in gaps] == pytest.approx([875e-6, 994e-6])
    assert harness.top(gaps, 1)[0][1] == pytest.approx(994e-6)


def test_roofline_and_idle_readers():
    spec = {"work": {"work_bytes": {"cigar_ops": 13}}}
    run = _run(samples=[{}] * 4, window_s=2.0, counts={"cigar_ops": 2_000_000},
               device={"kernel_s": 4 * 12e-6, "busy_s": 0.01}, spec=spec)
    share = harness.load_part("metrics", "kernels_roofline").read(run)
    assert share == pytest.approx(26e6 / 3.35e12 / 12e-6 * 100)
    idle = harness.load_part("metrics", "device_idle_share").read(run)
    assert idle == pytest.approx(99.5)
    silent = _run(samples=[{}], device={"kernel_s": 0.0}, spec=spec,
                  counts={"cigar_ops": 1})
    assert harness.load_part("metrics", "kernels_roofline").read(silent) is None
    assert harness.load_part("metrics", "device_idle_share").read(_run()) is None


def test_cli_readers():
    samples = [{"ok": True, "wall": 9.0, "import_s": 6.0, "import_in_main_s": 5.5,
                "stages": {"total": 6.0}},
               {"ok": True, "wall": 9.2, "import_s": 6.4, "import_in_main_s": 5.9,
                "stages": {"total": 6.6}},
               {"ok": True, "wall": 9.9, "trace": []}]
    run = _run(samples=samples)
    assert harness.load_part("metrics", "cli_import_s").read(run) == pytest.approx(6.2)
    assert harness.load_part("metrics", "cli_tool_s").read(run) == pytest.approx(0.6)
    assert harness.load_part("metrics", "cli_import_s").read(_run()) is None


def test_import_time_lines_sum_top_level():
    cli = harness.load_part("drivers", "cliprocess")
    err = (b"import time: self [us] | cumulative | imported package\n"
           b"import time:       354 |        354 |   _distutils_hack\n"
           b"import time:      4533 |      59693 | site\n"
           b"import time:       263 |        263 |       _json\n"
           b"import time:       843 |       3160 | json\n"
           b"import time:       120 |      20000 | wgatools_tpu_torch.cli\n"
           b"import time:      5000 |    6000000 | torch\n"
           b"import time:        12 |       1000 |   wgatools_tpu_torch.ops\n"
           b"import time:        12 |       2000 | wgatools_tpu_torch.tools.convert\n"
           b"2026 DEBUG [wgatools_tpu_torch.metrics] stage total     6.482s\n")
    both = cli.import_seconds(err)
    assert both == pytest.approx(((59693 + 3160 + 20000 + 6002000) * 1e-6, 6.002))
    assert dict(cli._STAGE.findall(err)) == {b"total": b"6.482"}


def test_compare_counts_lines():
    assert harness.compare(b"a\nb\nc\n", b"a\nb\nc\n") == (True, 0)
    assert harness.compare(b"a\nb\nc\n", b"a\nx\nc\n") == (False, 1)
    assert harness.compare(b"a\nb\nc\n", b"a\nb\n") == (False, 2)


def test_reservoir_keeps_a_uniform_sample(tmp_path):
    counts = {}
    for seed in range(300):
        r = harness.Reservoir(seed, 2)
        for i in range(10):
            out = tmp_path / "out"
            out.write_text(str(i))
            if r.wants(i):
                r.keep(i, str(out), str(tmp_path / f"k{seed}_{i}"))
        assert len(r.kept) == 2
        for i, p in r.kept.items():
            assert open(p).read() == str(i)
            counts[i] = counts.get(i, 0) + 1
            os.remove(p)
    assert min(counts.values()) > 0.5 * 60 and max(counts.values()) < 1.5 * 60
    a, b = harness.Reservoir(2**40, 3), harness.Reservoir(2**40, 3)
    assert [a.rng.random() for _ in range(3)] == [b.rng.random() for _ in range(3)]


def test_input_cache_hits_and_evicts(tmp_path, monkeypatch):
    spec = harness.cell_spec("p2c-chr-paf")
    spec["config"]["generator"]["params"].update(columns=200_000, block_max=60_000)
    calls = []
    gen = harness.load_part("gen", "pairwise")
    real = harness.load_part

    def counted(kind, name):
        module = real(kind, name)
        if kind == "gen":
            calls.append(name)
        return module
    monkeypatch.setattr(harness, "load_part", counted)
    cache = str(tmp_path / "inputs")
    path, counts = harness.cached_input(spec, 7, keep=2, cache_dir=cache)
    again, counts2 = harness.cached_input(spec, 7, keep=2, cache_dir=cache)
    assert (again, counts2) == (path, counts) and len(calls) == 1
    assert counts == gen.generate(tmp_path / "x.paf", 7, **spec["config"]["generator"]["params"])
    assert open(path, "rb").read() == (tmp_path / "x.paf").read_bytes()
    for seed in (8, 9):
        harness.cached_input(spec, seed, keep=2, cache_dir=cache)
    assert sorted(os.listdir(cache)) == sorted(
        f for f in os.listdir(cache) if "-8-" in f or "-9-" in f)
    assert len(os.listdir(cache)) == 4
    spec["config"]["generator"]["params"]["snp_rate"] = 0.02
    other, _ = harness.cached_input(spec, 9, keep=2, cache_dir=cache)
    assert other != path and len(calls) == 4


def test_traced_cli_processes_alternate(monkeypatch, tmp_path):
    """Import times and METRICS stages come from processes that run without
    the profiler; the device trace from the others."""
    cli = harness.load_part("drivers", "cliprocess")
    seen = []

    class Done:
        returncode = 0
        stderr = (b"import time:      4533 |      59693 | site\n"
                  b"import time:      4533 |      59693 | wgatools_tpu_torch.cli\n"
                  b"DEBUG stage total     0.482s\n"
                  b'INFO kernel launches: {"liftover_scan": 2}\n')

    def fake(argv, env, **kw):
        seen.append(("PYTHONPROFILEIMPORTTIME" in env, "WGA_TPU_TRACE" in env))
        return Done()
    monkeypatch.setattr(cli.subprocess, "run", fake)
    run = SimpleNamespace(trace=True, workdir=str(tmp_path),
                          state={"launcher": "x", "env": {}},
                          argv=lambda output: ["paf2chain", output])
    samples = [cli._invoke(run, i, "out") for i in range(4)]
    assert seen == [(True, False), (False, True)] * 2
    assert [("import_s" in s, "stages" in s, "trace" in s) for s in samples] == \
        [(True, True, False), (False, False, True)] * 2
    assert all(s["launches"] == {"liftover_scan": 2} for s in samples)
