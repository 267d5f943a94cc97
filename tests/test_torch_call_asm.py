"""`call -f maf` on the benchmark's assembly-vs-GRCh38 MAF (generator
benchmark/gen/assembly.py, at a small size): the benchmark's plain
reference (benchmark/reference/call.py) against the port's host engine
and its device route on CPU tensors, the reference's control, the device
route's METRICS phases and counters, and the distributed mode over gloo
ranks that keep their group across calls.

The inputs hold long records above and short ones below a lowered
DEVICE_MIN_COLUMNS, minus-strand records, and SVs dense enough that
chunk windows end inside them (chunks longer than the chunk size).
"""

import importlib.util
import json
import multiprocessing as mp
import os
import queue
import re
import sys
import time
import types

import pytest

from dist_ranks import _rank_env, _run, free_port
from wgatools_tpu_torch import cli
from wgatools_tpu_torch.core import metrics as metrics_mod
from wgatools_tpu_torch.core.metrics import METRICS
from wgatools_tpu_torch.tools import caller

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
SEEDS = [3, 11, 2**32 + 7]
CHUNK = 20_000
# records of 100 000 columns or more take the device route, smaller ones
# the host engine
DEVICE_MIN = 100_000
SMALL = dict(columns=1_500_000, record_min=5_000, record_max=300_000,
             minus_every=3, sv_per_mbp=300)
PHASES = ("parse", "plan", "pack", "device_runs", "emit", "write")


def _bench(kind, name):
    """benchmark/<kind>/<name>.py, with the benchmark's folder importable
    while it loads (the generator imports the harness)."""
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name}", os.path.join(BENCH, kind, name + ".py"))
    sys.path.insert(0, BENCH)
    try:
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(BENCH)
    return module


REF = _bench("reference", "call")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """seed -> (path, the generator's counts)."""
    gen = _bench("gen", "assembly")
    d = tmp_path_factory.mktemp("asm")
    out = {}
    for seed in SEEDS:
        path = str(d / f"asm{seed}.maf")
        out[seed] = (path, gen.generate(path, seed, **SMALL))
    return out


@pytest.fixture
def device_route(monkeypatch):
    """The device route on the CPU, DEVICE_MIN_COLUMNS lowered, METRICS
    emptied."""
    monkeypatch.setenv("WGA_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("WGA_TPU_DEVICE", raising=False)
    monkeypatch.delenv("WGA_TPU_DIST", raising=False)
    monkeypatch.delenv(metrics_mod.TRACE_ENV, raising=False)
    monkeypatch.setattr(caller, "DEVICE_MIN_COLUMNS", DEVICE_MIN)
    monkeypatch.setattr(METRICS, "stages", {})
    monkeypatch.setattr(METRICS, "counts", {})


def _call(path, out, flags=("-s",)):
    assert cli.main(["call", path, *flags, "-c", str(CHUNK), "-o", out,
                     "-r"]) == 0
    with open(out, "rb") as f:
        return f.read()


def test_inputs_hold_every_case(inputs):
    """Records on both sides of DEVICE_MIN, a minus-strand record, and a
    chunk window that ends inside an SV."""
    for path, _ in inputs.values():
        records = list(REF.blocks(path))
        cols = [len(t[6]) for t, _ in records]
        assert min(cols) < DEVICE_MIN <= max(cols)
        assert any(q[4] == b"-" for _, q in records)
        longer = 0
        for t, q in records:
            plan = REF.plan_bounds(*_gap_runs(t[6], q[6]), len(t[6]), CHUNK, 50)
            longer += sum(e - s > CHUNK for s, e in plan)
        assert longer > 0


def _gap_runs(t, q):
    import numpy as np

    gap = np.frombuffer(t, np.uint8) == ord("-")
    gap |= np.frombuffer(q, np.uint8) == ord("-")
    edges = np.flatnonzero(np.diff(np.concatenate(([0], gap.view(np.int8), [0]))))
    return edges[0::2], edges[1::2]


@pytest.mark.parametrize("flags", [("-s",), ("-s", "-i")], ids=["snp", "snp-inv"])
@pytest.mark.parametrize("seed", SEEDS)
def test_reference_host_engine_and_device_route_agree(
        inputs, device_route, monkeypatch, tmp_path, seed, flags):
    path, _ = inputs[seed]
    want = REF.answer(path, inv="-i" in flags, chunk_size=CHUNK)
    monkeypatch.setenv("WGA_TPU_DEVICE", "0")
    assert _call(path, str(tmp_path / "host.vcf"), flags) == want
    monkeypatch.delenv("WGA_TPU_DEVICE")
    assert _call(path, str(tmp_path / "dev.vcf"), flags) == want
    counts = METRICS.counts
    assert counts["call_device_columns"] > 0 and counts["call_host_columns"] > 0
    assert want.count(b"\n") > 500


@pytest.mark.parametrize("seed", SEEDS)
def test_control_differs(inputs, seed):
    path, _ = inputs[seed]
    want = REF.answer(path, chunk_size=CHUNK)
    assert REF.answer(path, chunk_size=CHUNK, control=True) != want


def test_phases_disjoint_cover_the_call_and_counters(inputs, device_route,
                                                     tmp_path, monkeypatch):
    """A warm call's phases, on the host's clock: each present, disjoint
    (no two annotations of a profiled call overlap), together at least 95%
    of `total` less the process-start stages; the counters: device plus
    host columns the input's, `call_variant_rows` the VCF's body lines,
    the padded slots the grouped batches' padding."""
    path, gen_counts = inputs[SEEDS[0]]
    out = str(tmp_path / "a.vcf")
    _call(path, out)  # warm: imports, the kernels' plain versions
    METRICS.stages.clear()
    METRICS.counts.clear()
    vcf = _call(path, out)
    stages = {k: v[0] for k, v in METRICS.stages.items()}
    assert all(stages.get(p, 0) > 0 for p in PHASES), stages
    start = sum(stages.get(k, 0) for k in ("import_torch", "cuda_init",
                                           "lib_load"))
    covered = sum(stages[p] for p in PHASES)
    assert 0.95 * (stages["total"] - start) <= covered <= stages["total"]
    c = METRICS.counts
    assert (c["call_device_columns"] + c["call_host_columns"]
            == gen_counts["aligned_columns"])
    body = [line for line in vcf.split(b"\n") if line and not line.startswith(b"#")]
    assert c["call_variant_rows"] == len(body)
    assert c["slots"] - c["padded_slots"] == c["call_device_columns"]

    trace = tmp_path / "trace"
    monkeypatch.setenv(metrics_mod.TRACE_ENV, str(trace))
    _call(path, out)
    (name,) = os.listdir(trace)
    with open(trace / name) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and e["name"] in {"wga." + p for p in PHASES})
    assert {n for _, _, n in spans} == {"wga." + p for p in PHASES}
    for (_, end, a), (start, _, b) in zip(spans, spans[1:]):
        assert end <= start + 1.0, (a, b)  # us: the clock's rounding


RANK = r"""
import json, sys
from wgatools_tpu_torch.cli import main
from wgatools_tpu_torch.core.metrics import METRICS
from wgatools_tpu_torch.errors import WGAError
from wgatools_tpu_torch.tools import caller

report, out, argv = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
calls, fail_call = int(sys.argv[4]), int(sys.argv[5])
caller.DEVICE_MIN_COLUMNS = int(sys.argv[6])
rcs = []
for i in range(calls):
    if i == fail_call:
        def broken(*args, **kwargs):
            raise WGAError("a planted failure")
        caller.call_record = broken
    rcs.append(main(argv + ["-o", f"{out}.{i}", "-r"]))
    if rcs[-1]:
        break
with open(report, "w") as f:
    json.dump({"rcs": rcs, "inits": METRICS.counts.get("dist_group_inits", 0)}, f)
"""


def _ranks(argv, n, tmp_path, calls, fail=None):
    """argv called `calls` times by each of n gloo ranks in one process
    each; rank k of `fail` (rank, call) raises in that call.  Returns
    (the per-rank reports, stderr texts)."""
    port = free_port()
    cmds, envs, reports = [], [], []
    for k in range(n):
        report = str(tmp_path / f"report{k}.json")
        fail_call = fail[1] if fail and fail[0] == k else -1
        cmds.append([sys.executable, "-c", RANK, report, str(tmp_path / f"out{k}"),
                     json.dumps(argv), str(calls), str(fail_call), str(DEVICE_MIN)])
        env = _rank_env(n, k, port, None)
        env.update(WGA_TORCH_DEVICE="cpu", PYTHONPATH=REPO)
        envs.append(env)
        reports.append(report)
    done = _run(cmds, envs, 120, str(tmp_path))
    got = []
    for (rc, _, err), report in zip(done, reports):
        assert os.path.exists(report), err.decode()[-3000:]
        with open(report) as f:
            got.append(dict(json.load(f), rc=rc, stderr=err.decode()))
    return got


def test_four_ranks_keep_their_group_across_calls(inputs, device_route,
                                                  tmp_path, monkeypatch):
    path, _ = inputs[SEEDS[1]]
    argv = ["call", path, "-s", "-c", str(CHUNK)]
    want = _call(path, str(tmp_path / "serial.vcf"))
    assert want == REF.answer(path, chunk_size=CHUNK)
    got = _ranks(argv, 4, tmp_path, 3)
    for rank in got:
        assert rank["rc"] == 0 and rank["rcs"] == [0, 0, 0], rank["stderr"]
        assert rank["inits"] == 1
    for i in range(3):
        with open(tmp_path / f"out0.{i}", "rb") as f:
            assert f.read() == want
        assert not any(os.path.exists(tmp_path / f"out{k}.{i}") for k in (1, 2, 3))


def test_a_failed_call_ends_the_other_ranks_meeting(inputs, device_route,
                                                   tmp_path):
    """Rank 2 fails in the second call, after the kept group's first merge:
    every rank's second call returns 1, the others with the WGAError of the
    meeting, within the rank set's timeout."""
    path, _ = inputs[SEEDS[2]]
    t0 = time.monotonic()
    got = _ranks(["call", path, "-s", "-c", str(CHUNK)], 4, tmp_path, 3,
                 fail=(2, 1))
    assert time.monotonic() - t0 < 100
    for k, rank in enumerate(got):
        assert rank["rcs"] == [0, 1] and rank["inits"] == 1, rank["stderr"]
        if k != 2:  # a rank that stopped marks the store in turn; one
            # that comes later may find the store of rank 0 gone
            assert re.search(r"ERROR .*(rank [0-3] failed before merge 2|"
                             r"merge 2: the group's store has gone)",
                             rank["stderr"]), rank["stderr"]
    assert "a planted failure" in got[2]["stderr"]


def _late_rank(rank, size, store_path, start, results):
    """One rank of a gloo group meeting once (wait_for_ranks): the last
    rank comes 0.5 s late; rank 0 records each pause between its looks at
    the store."""
    import torch.distributed as dist

    from wgatools_tpu_torch.parallel import distributed as D

    pauses = []
    if rank == 0:
        sleep = time.sleep
        D.time = types.SimpleNamespace(
            monotonic=time.monotonic,
            sleep=lambda s: (pauses.append(s), sleep(s))[1])
    start.wait()
    D.init_group("gloo", dist.FileStore(store_path, size), rank, size, "cpu", 30)
    try:
        if rank == size - 1:
            time.sleep(0.5)
        D.wait_for_ranks()
        results.put((rank, max(pauses, default=0.0), len(pauses)))
    finally:
        D.shutdown_distributed()


def test_the_meeting_polls_at_most_a_millisecond_apart(tmp_path):
    ctx = mp.get_context("spawn")
    results, start = ctx.Queue(), ctx.Barrier(3)
    procs = [ctx.Process(target=_late_rank, args=(
        r, 3, str(tmp_path / "store"), start, results)) for r in range(3)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(3):
            rank, longest, polls = results.get(timeout=60)
            got[rank] = (longest, polls)
    except queue.Empty:
        pass
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    assert set(got) == {0, 1, 2}
    longest, polls = got[0]
    assert 0 < longest <= 0.001
    assert polls >= 100  # 0.5 s of waiting at most a millisecond a look
