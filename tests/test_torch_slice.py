"""The wgatools_tpu_torch slice end to end on the CPU (WGA_TORCH_DEVICE=cpu):
`stat` on MAF, `maf2paf`, `maf2chain`, `call` and `paf2chain` against the
TPU package's device and host engines, the command line, and the rule that
the port never imports jax.
"""

import importlib.util
import io
import os
import random
import re
import subprocess
import sys
from dataclasses import astuple

import numpy as np
import pytest
import torch

from synth import build_alignment, make_paf_case, random_ops
from wgatools_tpu.io.maf import MafReader as JMafReader
from wgatools_tpu.io.paf import PafReader as JPafReader
from wgatools_tpu.ops import batch as jax_batch
from wgatools_tpu.tools import caller as jax_caller
from wgatools_tpu.tools import convert as jax_convert
from wgatools_tpu.tools import stat as jax_stat
from wgatools_tpu_torch import cli
from wgatools_tpu_torch.core.cigar import cigar_from_seqs, rec_stat_from_cigar, seq_bytes
from wgatools_tpu_torch.io.maf import MafReader
from wgatools_tpu_torch.io.paf import PafReader
from wgatools_tpu_torch.ops import batch as torch_batch
from wgatools_tpu_torch.ops import classify as torch_classify
from wgatools_tpu_torch.tools import caller as torch_caller
from wgatools_tpu_torch.tools import convert as torch_convert
from wgatools_tpu_torch.tools import stat as torch_stat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _corpus():
    spec = importlib.util.spec_from_file_location(
        "make_corpus", os.path.join(REPO, "scripts", "make_corpus.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _maf_bytes(seed, n_records, n_cols, min_cols=None):
    """make_corpus's alignments as MAF text, every 5th query on '-'; about
    min_cols (default n_cols // 2) to n_cols columns per record."""
    corpus = _corpus()
    rng = np.random.default_rng(seed)
    out = ["##maf version=1.6\n"]
    t_off = 1000
    for i in range(n_records):
        n = int(rng.integers(min_cols or n_cols // 2, n_cols + 1))
        vals, lens = corpus.run_table(rng, max(3, n // 18))
        t, q = corpus.realize(rng, vals, lens)
        tl, ql = int((t != 45).sum()), int((q != 45).sum())
        strand = "-" if i % 5 == 0 else "+"
        out.append(
            f"a score=0\ns\tref.chr{i % 3}\t{t_off}\t{tl}\t+\t100000000\t"
            f"{t.tobytes().decode()}\ns\tq{i % 4}.chr1\t{t_off}\t{ql}\t{strand}"
            f"\t100000000\t{q.tobytes().decode()}\n\n"
        )
        t_off += tl + 10
    return "".join(out).encode()


def _synth_maf(seed, n_records):
    """tests/synth.py alignments as three-row MAF records: ref, a query
    (every 3rd on '-') and a third species, with gap/gap columns where the
    first two rows both miss a stretch the third has."""
    rng = random.Random(seed)
    out = ["##maf version=1.6\n"]
    t_off = 500
    for i in range(n_records):
        t_parts, q_parts = [], []
        for _ in range(rng.randint(1, 6)):
            t, q = build_alignment(
                rng, random_ops(rng, rng.randint(3, 40), lead_trail_indel=True)
            )
            t_parts.append(t)
            q_parts.append(q)
            if rng.random() < 0.6:
                n = rng.randint(1, 70)
                t_parts.append("-" * n)
                q_parts.append("-" * n)
        t, q = "".join(t_parts), "".join(q_parts)
        o = "".join(c if rng.random() < 0.9 else rng.choice("ACGT-") for c in
                    t.replace("-", "A"))
        rows = [("ref.chr1", t, "+"), (f"q{i % 2}.chr1", q, "-+"[i % 3 != 0]),
                ("other.chr1", o, "+")]
        out.append("a score=0\n")
        for name, seq, strand in rows:
            size = sum(1 for c in seq if c != "-")
            out.append(f"s\t{name}\t{t_off}\t{size}\t{strand}\t100000000\t{seq}\n")
        out.append("\n")
        t_off += len(t) + 7
    return "".join(out).encode()


def _paf_bytes(n=23):
    rows = [make_paf_case(1000 + i, negative=(i % 3 == 0))[0] for i in range(n)]
    return ("\n".join(rows) + "\n").encode()


def _host_stat(data, each):
    out = io.BytesIO()
    jax_stat.stat_maf(JMafReader(io.BytesIO(data)), out, each, device=False)
    return out.getvalue()


@pytest.mark.parametrize("each", [False, True])
def test_stat_maf_matches_jax_device_and_host(each):
    data = _maf_bytes(1, 14, 3000)
    jax_dev = io.BytesIO()
    jax_stat.stat_maf(JMafReader(io.BytesIO(data)), jax_dev, each, device=True)
    got = io.BytesIO()
    # a small batch budget: many flushes through the one-in-flight pipeline
    torch_stat.stat_maf(MafReader(io.BytesIO(data)), got, CPU, each,
                        force_device=True, batch_columns=8192)
    assert got.getvalue() == jax_dev.getvalue() == _host_stat(data, each)
    out = io.BytesIO()  # small input: by default the host engine answers
    torch_stat.stat_maf(MafReader(io.BytesIO(data)), out, CPU, each)
    assert out.getvalue() == got.getvalue()


def test_stream_stats_order_with_int32_route(monkeypatch):
    """Input order survives many in-flight hand-offs with the int64 host
    route interleaved mid-stream, as in the TPU package."""
    rng = np.random.default_rng(13)
    alphabet = np.frombuffer(b"ACGT-", np.uint8)
    items = []
    for k in range(17):
        n = int(rng.integers(50, 4000))
        t = alphabet[rng.integers(0, 5, n)].tobytes()
        q = alphabet[rng.integers(0, 5, n)].tobytes()
        items.append((t, q, bool(rng.random() < 0.5), ("rec", k)))
    monkeypatch.setattr(torch_batch, "INT32_SAFE_COLUMNS", 3000)
    monkeypatch.setattr(jax_batch, "INT32_SAFE_COLUMNS", 3000)
    got = list(torch_batch.stream_seq_pair_stats(iter(items), CPU, 6000))
    want = list(jax_batch.stream_seq_pair_stats(iter(items), batch_columns=6000))
    assert [(m, astuple(rs)) for m, rs in got] == [
        (m, astuple(rs)) for m, rs in want]
    for (t, q, neg, _), (_, rs) in zip(items, got):
        assert rs == rec_stat_from_cigar(cigar_from_seqs(seq_bytes(t), seq_bytes(q), neg))


@pytest.mark.parametrize("seed", range(3))
def test_row_helpers_match_jax(seed):
    rng = np.random.default_rng(seed)
    row = rng.integers(0, 1 << 20, 8).astype(np.int32)
    t = np.frombuffer(b"ACGT-", np.uint8)[rng.integers(0, 5, 300)].tobytes()
    q = np.frombuffer(b"ACGT-", np.uint8)[rng.integers(0, 5, 300)].tobytes()
    for neg in (False, True):
        assert astuple(torch_batch.stats_row_to_cigar(row, neg)) == astuple(
            jax_batch.stats_row_to_cigar(row, neg))
        host_row, = torch_batch._host_pair_row(t, q)
        assert astuple(rec_stat_from_cigar(torch_batch.stats_row_to_cigar(
            host_row, neg))) == astuple(jax_batch._host_pair_stat(t, q, neg))


@pytest.mark.parametrize("batch_ops", [8, 1 << 20])
def test_paf2chain_matches_jax_device_and_host(batch_ops):
    data = _paf_bytes()
    host = io.BytesIO()
    jax_convert.paf2chain(JPafReader(io.BytesIO(data)), host, device=False)
    jax_dev = io.BytesIO()
    jax_convert._paf2chain_device(JPafReader(io.BytesIO(data)), jax_dev,
                                  batch_ops=batch_ops, min_ops=0)
    got = io.BytesIO()
    torch_convert._paf2chain_device(PafReader(io.BytesIO(data)), got, CPU,
                                    batch_ops=batch_ops, min_ops=0)
    assert got.getvalue() == jax_dev.getvalue() == host.getvalue()
    # the default threshold answers this small input on the host
    auto = io.BytesIO()
    torch_convert.paf2chain(PafReader(io.BytesIO(data)), auto, CPU)
    assert auto.getvalue() == host.getvalue()


def test_paf2chain_outlier_records():
    """An op of 2^16 (past the TPU kernel's bound: the port's int32 scan
    takes it) and an op of 2^31 (int32-unsafe: the host path takes it, in
    order) mid-stream."""
    wide = ("qb\t200000\t0\t131074\t+\ttb\t200000\t0\t131073\t131072\t131074"
            "\t255\tcg:Z:65536=1X2I65536=")
    huge = ("qh\t4294967296\t0\t2147483650\t+\tth\t4294967296\t0\t2147483649"
            "\t2147483648\t2147483650\t255\tcg:Z:2147483648=1X1I")
    rows = [make_paf_case(5)[0], wide, huge, make_paf_case(6, negative=True)[0]]
    data = ("\n".join(rows) + "\n").encode()
    host = io.BytesIO()
    jax_convert.paf2chain(JPafReader(io.BytesIO(data)), host, device=False)
    jax_dev = io.BytesIO()
    jax_convert._paf2chain_device(JPafReader(io.BytesIO(data)), jax_dev, min_ops=0)
    got = io.BytesIO()
    torch_convert._paf2chain_device(PafReader(io.BytesIO(data)), got, CPU, min_ops=0)
    assert got.getvalue() == jax_dev.getvalue() == host.getvalue()
    assert got.getvalue().count(b"chain\t") == 4


def _route_spy(monkeypatch):
    """Records which plain statistics version each device batch used: the
    category plane (kernel A's) or the byte planes (kernel D's)."""
    seen = []
    for name, route in (("classify_stat_cat_ref", "cat"),
                        ("classify_stat_bytes_ref", "bytes")):
        real = getattr(torch_classify, name)
        monkeypatch.setattr(torch_classify, name, lambda *a, _r=real,
                            _route=route: (seen.append(_route), _r(*a))[1])
    return seen


def _jax_device_mode(monkeypatch):
    """The TPU package's device paths on the CPU, at any input size."""
    monkeypatch.setenv("WGA_TPU_DEVICE", "1")
    monkeypatch.setattr("wgatools_tpu.core.device.DEVICE_MIN_COLUMNS", 1)
    monkeypatch.setattr("wgatools_tpu.tools.stat.DEVICE_MIN_COLUMNS", 1)


@pytest.mark.parametrize("query_name", [None, "other.chr1"])
@pytest.mark.parametrize("tool", ["maf2paf", "maf2chain"])
def test_maf2paf_maf2chain_match_jax_device_and_host(tool, query_name,
                                                      monkeypatch):
    data = _synth_maf(7, 14)
    jax_tool = getattr(jax_convert, tool)
    host = io.BytesIO()
    jax_tool(JMafReader(io.BytesIO(data)), host, query_name, device=False)
    auto = io.BytesIO()  # small input: by default the host engine answers
    getattr(torch_convert, tool)(MafReader(io.BytesIO(data)), auto, CPU,
                                 query_name)
    assert auto.getvalue() == host.getvalue()

    _jax_device_mode(monkeypatch)
    jax_dev = io.BytesIO()
    jax_tool(JMafReader(io.BytesIO(data)), jax_dev, query_name, device=True)
    monkeypatch.setattr(torch_convert, "DEVICE_MIN_COLUMNS", 1)
    # a small batch budget: many flushes through the one-in-flight pipeline
    monkeypatch.setattr(torch_convert, "DEFAULT_BATCH_COLUMNS", 3000)
    seen = _route_spy(monkeypatch)
    got = io.BytesIO()
    getattr(torch_convert, tool)(MafReader(io.BytesIO(data)), got, CPU,
                                 query_name)
    assert got.getvalue() == jax_dev.getvalue() == host.getvalue()
    assert len(seen) > 3 and set(seen) == {"cat"}


def _call(fn, data, chunk_size, query_name=None, regex=None, **kw):
    """`call` through fn, on its own package's MAF reader."""
    reader = MafReader if fn.__module__.startswith("wgatools_tpu_torch") else JMafReader
    out = io.BytesIO()
    fn(reader(io.BytesIO(data)), None, out, True, True, 10, sample="s1",
       query_name=query_name, query_regex=regex, chunk_size=chunk_size, **kw)
    return out.getvalue()


@pytest.mark.parametrize("select", [None, "name", "regex"])
@pytest.mark.parametrize("route", ["grouped", "bytes"])
def test_call_matches_jax_device_and_host(route, select, monkeypatch):
    """Small chunks group into one category-plane batch per record; a chunk
    size past every record sends each record as one [1, n] batch, which
    takes the byte planes unless n is a multiple of 8."""
    data = _synth_maf(11, 12)
    chunk_size = 60 if route == "grouped" else 10**6
    sel = {"query_name": "other.chr1" if select == "name" else None,
           "regex": re.compile(r"^q1\..*$") if select == "regex" else None}
    host = _call(jax_caller.call_var_maf, data, chunk_size, **sel)
    auto = _call(torch_caller.call_var_maf, data, chunk_size, device=CPU, **sel)
    assert auto == host  # small input: by default the host engine answers
    _jax_device_mode(monkeypatch)
    jax_dev = _call(jax_caller.call_var_maf, data, chunk_size, **sel)
    monkeypatch.setattr(torch_caller, "DEVICE_MIN_COLUMNS", 1)
    seen = _route_spy(monkeypatch)
    got = _call(torch_caller.call_var_maf, data, chunk_size, device=CPU, **sel)
    assert got == jax_dev == host
    assert got.count(b"\n") > 40
    assert ("cat" if route == "grouped" else "bytes") in seen


def test_call_groups_chunks_by_the_budget(monkeypatch):
    """A record's chunks go up in several batches once they pass the group
    budget, in order, with the bytes of the host engine."""
    data = _synth_maf(13, 4)
    host = _call(jax_caller.call_var_maf, data, 40)
    monkeypatch.setattr(torch_caller, "DEVICE_MIN_COLUMNS", 1)
    monkeypatch.setattr(torch_caller, "GROUP_BUDGET", 200)
    batches = []
    real = torch_caller.batch_runs
    monkeypatch.setattr(torch_caller, "batch_runs", lambda t, *a, **k: (
        batches.append(t.shape[0]), real(t, *a, **k))[1])
    assert _call(torch_caller.call_var_maf, data, 40, device=CPU) == host
    assert len(batches) > 8 and max(batches) > 1


def _env():
    env = dict(os.environ, WGA_TORCH_DEVICE="cpu", PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    return env


def test_cli_stat_subprocess(tmp_path):
    """`python -m wgatools_tpu_torch stat` on an input past
    DEVICE_MIN_COLUMNS, so that the auto mode takes the device path."""
    data = _maf_bytes(2, 40, 220_000)
    maf = tmp_path / "in.maf"
    maf.write_bytes(data)
    proc = subprocess.run(
        [sys.executable, "-m", "wgatools_tpu_torch", "stat", str(maf)],
        capture_output=True, env=_env(), cwd=REPO, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr.decode()
    assert proc.stdout == _host_stat(data, False)


@pytest.mark.parametrize(
    "argv", [["maf2paf"], ["maf2chain"], ["call", "-s", "-c", "5000000"]]
)
def test_cli_maf_tools_subprocess(argv, tmp_path):
    """`python -m wgatools_tpu_torch` on one record past DEVICE_MIN_COLUMNS
    with a width that is not a multiple of 8: the device path by default,
    and for `call` with a chunk past the record, the byte planes."""
    data = _maf_bytes(5, 1, 4_400_000, min_cols=4_300_000)
    maf = tmp_path / "in.maf"
    maf.write_bytes(data)
    width = len(data.split(b"\n")[2].split(b"\t")[-1])
    assert width >= 1 << 22 and width % 8
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "wgatools_tpu_torch", argv[0], str(maf),
         "-o", str(out), *argv[1:]],
        capture_output=True, env=_env(), cwd=REPO, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr.decode()
    want = io.BytesIO()
    if argv[0] == "call":
        jax_caller.call_var_maf(JMafReader(io.BytesIO(data)), None, want, True,
                                False, 50, chunk_size=5_000_000)
    else:
        getattr(jax_convert, argv[0])(JMafReader(io.BytesIO(data)), want,
                                      device=False)
    assert out.read_bytes() == want.getvalue()


IMPORT_GUARD = """
import pkgutil, sys, importlib
import wgatools_tpu_torch
for m in pkgutil.walk_packages(wgatools_tpu_torch.__path__, "wgatools_tpu_torch."):
    if not m.name.endswith("__main__"):
        importlib.import_module(m.name)
from wgatools_tpu_torch.cli import main
from wgatools_tpu_torch.kernels import _build
from wgatools_tpu_torch.tools import caller, convert, stat
maf, paf, out = sys.argv[1:]
# the device routes at any size, one batch per few records
for mod in (caller, convert, stat):
    mod.DEVICE_MIN_COLUMNS = 1
assert main(["stat", "-e", maf, "-o", out + ".tsv", "-r"]) == 0
assert main(["paf2chain", paf, "-o", out + ".chain", "-r"]) == 0
assert main(["maf2paf", maf, "-o", out + ".paf", "-r"]) == 0
assert main(["maf2chain", maf, "-o", out + ".m.chain", "-r"]) == 0
assert main(["call", "-s", maf, "-o", out + ".a.vcf", "-r", "-c", "333"]) == 0
assert main(["call", "-s", maf, "-o", out + ".b.vcf", "-r"]) == 0
print(sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")))
"""


def test_port_never_imports_jax(tmp_path):
    maf, paf = tmp_path / "in.maf", tmp_path / "in.paf"
    maf.write_bytes(_maf_bytes(3, 4, 2000))
    paf.write_bytes(_paf_bytes(8))
    out = str(tmp_path / "o")
    proc = subprocess.run(
        [sys.executable, "-c", IMPORT_GUARD, str(maf), str(paf), out],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
    with open(out + ".tsv", "rb") as f:
        assert f.read() == _host_stat(maf.read_bytes(), True)
    want = io.BytesIO()
    jax_convert.maf2paf(JMafReader(io.BytesIO(maf.read_bytes())), want,
                        device=False)
    with open(out + ".paf", "rb") as f:
        assert f.read() == want.getvalue()


def test_cli_refuses_cuda_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setenv("WGA_TORCH_DEVICE", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    maf = tmp_path / "in.maf"
    maf.write_bytes(_maf_bytes(4, 2, 500))
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["stat", str(maf)])


@pytest.mark.parametrize(
    "argv", [["validate"], ["stat", "-f", "paf"], ["chain2paf"], ["pafcov"],
             ["call", "-f", "paf"]]
)
def test_cli_unported_subcommands_exit_1(argv, tmp_path, caplog, monkeypatch):
    """Under WGA_TPU_DIST the port runs what the TPU package runs: an empty
    plain file takes the distributed branch in validate, stat -f paf,
    chain2paf and pafcov, whose driver runs in the one process (no
    coordinator variables); `call -f paf` has no distributed run and runs
    the serial tool.  Each writes the TPU package's bytes under the same
    variable, and none is refused."""
    from wgatools_tpu.cli import main as host_main

    monkeypatch.setenv("WGA_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("WGA_TPU_DIST", "1")
    f = tmp_path / "in.txt"
    f.write_bytes(b"")
    out, want = tmp_path / "out", tmp_path / "want"
    argv = argv + [str(f)]
    if argv[0] == "call":
        fa = tmp_path / "ref.fa"
        fa.write_bytes(b">t1\nACGTACGT\n")
        argv += ["--target", str(fa), "-q", str(fa), "-s"]
    assert cli.main(argv + ["-o", str(out)]) == 0
    assert host_main(argv + ["-o", str(want)]) == 0
    assert out.read_bytes() == want.read_bytes()
    assert "WGA_TPU_DIST" not in caplog.text


@pytest.mark.parametrize("mod,name", [
    ("stat", "stat_maf"), ("stat", "stat_paf"), ("convert", "maf2paf"),
    ("convert", "maf2chain"), ("convert", "paf2chain"),
    ("convert", "chain2paf"), ("pafcov", "pafcov"),
    ("validate", "validate_paf"), ("caller", "call_var_maf"),
])
def test_device_tools_require_a_device(mod, name):
    """A device tool has no default device: the caller names the card, or
    None for the host engine, so no call falls back to the CPU unasked."""
    import inspect

    fn = getattr(importlib.import_module(f"wgatools_tpu_torch.tools.{mod}"),
                 name)
    param = inspect.signature(fn).parameters["device"]
    assert param.default is inspect.Parameter.empty
    with pytest.raises(TypeError):
        fn(None, None)
