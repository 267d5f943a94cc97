"""WGA_TPU_DEVICE on the port's command line, read as the TPU package reads
it: "", "0" or "false" send every device branch to the host engine, in a
process that never imports torch; any other value, or none, keeps the
device route (WGA_TORCH_DEVICE's device).  The inputs sit above
DEVICE_MIN_COLUMNS / DEVICE_MIN_OPS, so the variable decides the route and
not the size, and every output must equal `python -m wgatools_tpu`'s bytes
under WGA_TPU_DEVICE=0.
"""

import logging
import os
import subprocess
import sys

import numpy as np
import pytest

from synth import make_paf_case
from wgatools_tpu_torch import cli
from wgatools_tpu_torch.core.device import DEVICE_MIN_COLUMNS, DEVICE_MIN_OPS
from wgatools_tpu_torch.core.metrics import METRICS
from wgatools_tpu_torch.io.chain import ChainReader
from wgatools_tpu_torch.io.paf import PafReader
from wgatools_tpu_torch.scripts import make_corpus
from wgatools_tpu_torch.tools.convert import paf2chain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120

# subcommand -> (arguments, the METRICS stage its device route records)
DEVICE_SUBCOMMANDS = {
    "stat": (["stat", "{maf}"], "device_stats"),
    "stat -f paf": (["stat", "-f", "paf", "{paf}"], "device_cigar_stats"),
    "maf2paf": (["maf2paf", "{maf}"], "device_rle"),
    "maf2chain": (["maf2chain", "{maf}"], "device_rle"),
    "paf2chain": (["paf2chain", "{paf}"], "device_chain_scan"),
    "chain2paf": (["chain2paf", "{chain}"], "device_chain_sums"),
    "call -s": (["call", "-s", "{maf}"], "device_rle"),
    "pafcov": (["pafcov", "{paf}"], "device_coverage"),
    "validate": (["validate", "{paf}"], "device_cigar_stats"),
}

# `python -m wgatools_tpu_torch ARGS` in a process whose imports of torch
# fail (forked pool workers inherit the hook) and that says at its end
# whether torch was loaded
NO_TORCH = """
import runpy, sys

class NoTorch:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "torch":
            raise ImportError(f"{name} imported on the host route")

sys.meta_path.insert(0, NoTorch())
try:
    runpy.run_module("wgatools_tpu_torch", run_name="__main__", alter_sys=True)
finally:
    print("torch loaded:", "torch" in sys.modules, file=sys.stderr)
"""


def _write_paf(path, rng, n_records=220, n_runs=1000):
    """make_corpus run tables (mean run 4) on two targets of ~230 kbp, one
    record in three on '-': ~220 000 CIGAR ops, a chain of ~73 000 data
    lines, pafcov output of ~460 000 lines."""
    recs, t_off = [], 0
    for i in range(n_records):
        vals, lens = make_corpus.run_table(rng, n_runs, mean_len=4)
        adv = {k: int(lens[np.isin(vals, np.frombuffer(k, np.uint8))].sum())
               for k in (b"=XD", b"=XI", b"=")}
        recs.append((t_off, adv, int(lens.sum()),
                     make_corpus.cg_string(vals, lens)))
        t_off += adv[b"=XD"] // 2
    t_len = t_off + max(r[1][b"=XD"] for r in recs)
    with open(path, "w") as f:
        for i, (ts, adv, blk, cg) in enumerate(recs):
            ql = adv[b"=XI"]
            f.write(f"q{i % 4}\t{ql + 200}\t100\t{100 + ql}\t{'+-'[i % 3 == 0]}"
                    f"\tt{i % 2}\t{t_len}\t{ts}\t{ts + adv[b'=XD']}\t"
                    f"{adv[b'=']}\t{blk}\t60\tcg:Z:{cg}\n")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A MAF of one record of just over DEVICE_MIN_COLUMNS columns, a PAF of
    more than DEVICE_MIN_OPS ops, and that PAF's chain (more than
    DEVICE_MIN_OPS data lines), from seed 11."""
    d = tmp_path_factory.mktemp("device_env")
    rng = np.random.default_rng(11)
    paths = {k: str(d / f"in.{k}") for k in ("maf", "paf", "chain")}
    make_corpus.make_maf(paths["maf"], rng, 1, 4_600_000)
    _write_paf(paths["paf"], rng)
    with open(paths["paf"], "rb") as f, open(paths["chain"], "wb") as w:
        paf2chain(PafReader(f), w, None)
    with open(paths["maf"]) as f:
        columns = len(f.read().split("\n")[2].split("\t")[6])
    with open(paths["paf"], "rb") as f:
        ops = sum(len(r.get_cigar_ops()[0]) for r in PafReader(f).records())
    with open(paths["chain"], "rb") as f:
        lines = sum(len(r.sizes) for r in ChainReader(f).records())
    assert columns > DEVICE_MIN_COLUMNS
    assert ops > DEVICE_MIN_OPS and lines > DEVICE_MIN_OPS
    paths["dir"] = str(d)
    return paths


def _argv(name, inputs):
    return [a.format(**inputs) for a in DEVICE_SUBCOMMANDS[name][0]]


def _env(**set_vars):
    """The test environment with PYTHONPATH at the repository, without
    either route variable, plus set_vars."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    env.pop("WGA_TPU_DEVICE", None)
    env.pop("WGA_TORCH_DEVICE", None)
    env.update(set_vars)
    return env


def _run(args, env):
    return subprocess.run([sys.executable, *args], capture_output=True,
                          env=env, cwd=REPO, timeout=TIMEOUT_S)


@pytest.fixture(scope="module")
def tpu_bytes(inputs):
    """Each device subcommand's output from `python -m wgatools_tpu` under
    WGA_TPU_DEVICE=0."""
    out = {}
    for name in DEVICE_SUBCOMMANDS:
        path = os.path.join(inputs["dir"], f"tpu.{name.replace(' ', '_')}")
        proc = _run(["-m", "wgatools_tpu", *_argv(name, inputs), "-o", path,
                     "-r"], _env(WGA_TPU_DEVICE="0"))
        assert proc.returncode == 0, proc.stderr.decode()
        with open(path, "rb") as f:
            out[name] = f.read()
    return out


def _no_torch_run(argv, value="0"):
    """argv through the port's CLI at -v under WGA_TPU_DEVICE=value,
    WGA_TORCH_DEVICE unset; returns (stderr, stdout bytes).  The process
    must exit 0, log the host engine's route and no kernel launch, and end
    without torch."""
    proc = _run(["-c", NO_TORCH, *argv, "-v"], _env(WGA_TPU_DEVICE=value))
    err = proc.stderr.decode()
    assert proc.returncode == 0, err
    assert "torch loaded: False" in err.splitlines()
    assert "kernel launches" not in err
    return err, proc.stdout


@pytest.mark.parametrize(
    "value,want",
    [("", None), ("0", None), ("false", None), ("1", "cpu"), ("yes", "cpu"),
     (None, "cpu")],
    ids=["empty", "0", "false", "1", "yes", "unset"],
)
def test_device_follows_wga_tpu_device(value, want, monkeypatch, caplog):
    monkeypatch.setenv("WGA_TORCH_DEVICE", "cpu")
    if value is None:
        monkeypatch.delenv("WGA_TPU_DEVICE", raising=False)
    else:
        monkeypatch.setenv("WGA_TPU_DEVICE", value)
    with caplog.at_level(logging.INFO, logger="wgatools_tpu_torch"):
        device = cli._device()
    routes = [r.getMessage() for r in caplog.records
              if r.getMessage().startswith("route: ")]
    if want is None:
        assert device is None
        assert routes == [f"route: the host engine (WGA_TPU_DEVICE={value!r})"]
    else:
        assert device.type == want
        assert routes == ["route: device cpu"]


@pytest.mark.parametrize("value", ["", "0", "false"],
                         ids=["empty", "0", "false"])
def test_off_values_never_ask_for_a_device(value, monkeypatch):
    """An off value does not read WGA_TORCH_DEVICE: not even a bad name."""
    monkeypatch.setenv("WGA_TPU_DEVICE", value)
    monkeypatch.setenv("WGA_TORCH_DEVICE", "no-such-device")
    assert cli._device() is None
    monkeypatch.setenv("WGA_TPU_DEVICE", "1")
    with pytest.raises(ValueError, match="no-such-device"):
        cli._device()


@pytest.mark.parametrize("name", list(DEVICE_SUBCOMMANDS))
def test_host_route_writes_the_tpu_bytes_without_torch(name, inputs,
                                                       tpu_bytes, tmp_path):
    out = str(tmp_path / "out")
    err, _ = _no_torch_run(_argv(name, inputs) + ["-o", out, "-r"])
    assert "route: the host engine (WGA_TPU_DEVICE='0')" in err
    with open(out, "rb") as f:
        assert f.read() == tpu_bytes[name]


@pytest.mark.parametrize("name", ["stat", "paf2chain", "pafcov"])
def test_thread_pools_import_no_torch(name, inputs, tpu_bytes, tmp_path):
    """-t 2 on a plain file forks the host pools, which never load torch,
    whatever WGA_TPU_DEVICE says."""
    out = str(tmp_path / "out")
    _no_torch_run(_argv(name, inputs) + ["-t", "2", "-o", out, "-r"],
                  value="1")
    with open(out, "rb") as f:
        assert f.read() == tpu_bytes[name]


def test_call_paf_imports_no_torch(tmp_path):
    paf, t_fa, q_fa = make_paf_case(5)
    for name, text in (("in.paf", paf), ("t.fa", t_fa), ("q.fa", q_fa)):
        (tmp_path / name).write_text(text)
    argv = ["call", "-f", "paf", str(tmp_path / "in.paf"), "--target",
            str(tmp_path / "t.fa"), "-q", str(tmp_path / "q.fa"), "-s"]
    _, got = _no_torch_run(argv, value="1")
    proc = _run(["-m", "wgatools_tpu", *argv], _env())
    assert proc.returncode == 0, proc.stderr.decode()
    assert got == proc.stdout and got.count(b"\n") > 3


@pytest.mark.parametrize("value", ["1", None], ids=["1", "unset"])
@pytest.mark.parametrize("name", list(DEVICE_SUBCOMMANDS))
def test_device_route_still_runs(name, value, inputs, tpu_bytes, tmp_path,
                                 monkeypatch):
    """Any other value, or none: the device route on WGA_TORCH_DEVICE's
    device (its METRICS stage, reported at -vv), with the same bytes."""
    monkeypatch.setenv("WGA_TORCH_DEVICE", "cpu")
    if value is None:
        monkeypatch.delenv("WGA_TPU_DEVICE", raising=False)
    else:
        monkeypatch.setenv("WGA_TPU_DEVICE", value)
    out = str(tmp_path / "out")
    METRICS.stages.clear()
    assert cli.main(_argv(name, inputs) + ["-o", out, "-r", "-vv"]) == 0
    assert DEVICE_SUBCOMMANDS[name][1] in METRICS.stages
    with open(out, "rb") as f:
        assert f.read() == tpu_bytes[name]

