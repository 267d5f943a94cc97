"""The port's command line runs every subcommand of the TPU package's
parser on its own code: one subprocess (WGA_TORCH_DEVICE=cpu, the device
routes forced at any input size) runs them all, `-t 2` included, and every
output must equal the bytes of wgatools_tpu's own command line on the same
arguments (run serially), with neither jax nor wgatools_tpu imported in
the port's process; one case per run.  A few subcommands also go through
`python -m wgatools_tpu_torch`, one process each.  tview is interactive and
left out.  Also: WGA_TPU_TRACE writes a torch.profiler trace, and
under WGA_TPU_DIST one process writes the TPU package's bytes, both where
the TPU package starts a distributed driver and where it runs the serial
tool.
"""

import gzip
import io
import json
import os
import random
import shutil
import subprocess
import sys

import pytest

from synth import build_alignment, make_paf_case, random_ops
from wgatools_tpu.cli import main as host_main
from wgatools_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_inputs(d):
    """MAF, PAF (+ a copy with wrong ends), chain and FASTA inputs in d."""
    rng = random.Random(3)
    maf = ["##maf version=1.6\n"]
    t_off = 500
    for i in range(9):
        t, q = build_alignment(rng, random_ops(rng, rng.randint(3, 30),
                                               lead_trail_indel=True))
        o = "".join(c if rng.random() < 0.9 else rng.choice("ACGT-")
                    for c in t.replace("-", "A"))
        maf.append("a score=0\n")
        for name, seq, strand in (("ref.chr1", t, "+"),
                                  (f"q{i % 2}.chr1", q, "-+"[i % 3 != 0]),
                                  ("other.chr1", o, "+")):
            size = sum(1 for c in seq if c != "-")
            maf.append(f"s\t{name}\t{t_off}\t{size}\t{strand}\t100000\t{seq}\n")
        maf.append("\n")
        t_off += len(t) + 7
    with open(os.path.join(d, "in.maf"), "w") as f:
        f.write("".join(maf))
    rows, fasta = [], []
    for i in range(8):
        paf, t_fa, q_fa = make_paf_case(200 + i, negative=i % 3 == 0)
        k = i % 3
        rows.append(paf.replace("\tt1\t", f"\tt{k}.{i}\t").replace(
            "q1\t", f"q{i}\t", 1))
        fasta += [t_fa.replace(">t1", f">t{k}.{i}"), q_fa.replace(">q1", f">q{i}")]
    with open(os.path.join(d, "in.paf"), "w") as f:
        f.write("\n".join(rows) + "\n")
    bad = []
    for i, row in enumerate(rows):
        f = row.split("\t")
        if i % 3 == 1:
            f[3] = str(int(f[3]) + 1)
        if i % 4 == 2:
            f[8] = str(int(f[8]) - 1)
        bad.append("\t".join(f))
    with open(os.path.join(d, "bad.paf"), "w") as f:
        f.write("\n".join(bad) + "\n")
    with open(os.path.join(d, "all.fa"), "w") as f:
        f.write("".join(fasta))
    assert host_main(["paf2chain", os.path.join(d, "in.paf"),
                      "-o", os.path.join(d, "in.chain")]) == 0


# every subcommand; {d}: the inputs, {o}: this run's output directory
RUNS = [
    ["maf2paf", "{d}/in.maf"],
    ["m2c", "{d}/in.maf"],
    ["paf2chain", "{d}/in.paf"],
    ["chain2paf", "{d}/in.chain"],
    ["paf2maf", "{d}/in.paf", "-g", "{d}/all.fa", "-q", "{d}/all.fa"],
    ["chain2maf", "{d}/in.chain", "-t", "{d}/all.fa", "-q", "{d}/all.fa"],
    ["maf2sam", "{d}/in.maf"],
    ["maf2sam", "{d}/in.maf", "--real"],
    ["maf-index", "{o}/idx.maf"],
    ["maf-ext", "{o}/idx.maf", "-r", "ref.chr1:600-900"],
    ["chunk", "{d}/in.maf", "-l", "40"],
    ["call", "{d}/in.maf", "-s"],
    ["call", "{o}/idx.maf", "-s", "-l", "5", "-c", "50"],
    ["call", "-f", "paf", "{d}/in.paf", "--target", "{d}/all.fa", "-q",
     "{d}/all.fa", "-s"],
    ["stat", "{d}/in.maf"],
    ["stat", "-e", "{d}/in.maf", "-q", "other.chr1"],
    ["stat", "-f", "paf", "{d}/in.paf"],
    ["st", "-f", "paf", "-e", "{d}/in.paf"],
    ["dotplot", "{d}/in.maf"],
    ["dotplot", "-f", "paf", "{d}/in.paf", "--out-format", "json"],
    ["filter", "{d}/in.maf", "-b", "30"],
    ["filter", "-f", "paf", "{d}/in.paf", "-a", "60"],
    ["filter", "-f", "chain", "{d}/in.chain", "-q", "20"],
    ["rename", "{d}/in.maf", "-p", "a.,b.,c."],
    ["pafcov", "{d}/in.paf"],
    ["pafpseudo", "{d}/in.paf", "-f", "{d}/all.fa"],  # -o names a directory
    ["gen-completion", "-s", "bash"],
    ["validate", "{d}/bad.paf"],
    ["vf", "{d}/bad.paf", "-f", "{o}/fixed.paf"],
    ["pileup", "{d}/in.maf"],
    ["trimovp", "{d}/in.paf"],
    ["paf2blocks", "{d}/in.paf"],
    # the fork pools of the TPU package's host engine
    ["maf2paf", "-t", "2", "{d}/in.maf"],
    ["maf2chain", "-t", "2", "{d}/in.maf"],
    ["paf2chain", "-t", "2", "{d}/in.paf"],
    ["chain2paf", "-t", "2", "{d}/in.chain"],
    ["call", "-t", "2", "{d}/in.maf", "-s"],
    ["stat", "-t", "2", "{d}/in.maf"],
    ["stat", "-t", "2", "-f", "paf", "{d}/in.paf"],
    ["pafcov", "-t", "2", "{d}/in.paf"],
    ["validate", "-t", "2", "{d}/bad.paf", "-f", "{o}/fixed2.paf"],
    ["filter", "-t", "2", "-f", "paf", "{d}/in.paf", "-a", "60"],
    ["dotplot", "-t", "2", "-f", "paf", "{d}/in.paf"],
]

PORT_SCRIPT = """
import json, os, sys
from wgatools_tpu_torch.cli import main
from wgatools_tpu_torch.tools import caller, convert, stat
# the device routes at any input size
for mod in (caller, convert, stat):
    mod.DEVICE_MIN_COLUMNS = 1
convert.DEVICE_MIN_OPS = 0
runs, trace_run, trace_dir = json.loads(sys.argv[1]), json.loads(sys.argv[2]), sys.argv[3]
rcs = [main(argv) for argv in runs]
os.environ["WGA_TPU_TRACE"] = trace_dir
rcs.append(main(trace_run))
print(json.dumps({"rcs": rcs, "jax": sorted(
    m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "tpu_package": sorted(m for m in sys.modules
                          if m.split(".")[0] == "wgatools_tpu")}))
"""


def _argv(run, d, o, k):
    argv = [a.format(d=d, o=o) for a in run]
    return argv + ["-o", os.path.join(o, f"{k}.out")]


def _tree(path):
    """{relative path: bytes} of every file under path."""
    out = {}
    for root, _, files in os.walk(path):
        for name in files:
            p = os.path.join(root, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, path)] = f.read()
    return out


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    """Every run of RUNS through the port (one subprocess) and through
    wgatools_tpu.cli.main (serially): both output trees, and the port's
    traced run."""
    tmp_path = tmp_path_factory.mktemp("cli")
    d, port, ref = (str(tmp_path / n) for n in ("in", "port", "ref"))
    for p in (d, port, ref):
        os.makedirs(p)
    _write_inputs(d)
    for o in (port, ref):
        shutil.copy(os.path.join(d, "in.maf"), os.path.join(o, "idx.maf"))
    runs = [_argv(r, d, port, k) for k, r in enumerate(RUNS)]
    runs[RUNS.index(["maf-index", "{o}/idx.maf"])][-2:] = []  # beside the input
    trace = tmp_path / "trace"
    traced = RUNS.index(["stat", "-f", "paf", "{d}/in.paf"])
    trace_run = runs[traced][:-1] + [str(trace / "o")]
    env = dict(os.environ, WGA_TORCH_DEVICE="cpu", PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    env.pop("WGA_TPU_DIST", None)
    proc = subprocess.run(
        [sys.executable, "-c", PORT_SCRIPT, json.dumps(runs),
         json.dumps(trace_run), str(trace)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    for k, run in enumerate(RUNS):
        argv = _argv(run, d, ref, k)
        if run[0] == "maf-index":
            argv[-2:] = []
        if run[1:3] == ["-t", "2"]:  # the reference runs serially
            del argv[1:3]
        assert host_main(argv) == 0, argv
    return {"inputs": d, "result": result, "stderr": proc.stderr,
            "got": _tree(port), "want": _tree(ref), "trace": trace,
            "traced": traced, "n_runs": len(runs)}


def test_every_subcommand_matches_the_tpu_package(both_runs):
    result, got, want = both_runs["result"], both_runs["got"], both_runs["want"]
    assert result["jax"] == [] and result["tpu_package"] == []
    assert result["rcs"] == [0] * (both_runs["n_runs"] + 1), both_runs["stderr"]
    assert sorted(got) == sorted(want)
    assert len(got) >= len(RUNS)
    for name in want:
        assert got[name] == want[name], name
    # the trace run: a Chrome trace, and the same output as its first run
    trace = both_runs["trace"]
    traces = [p for p in os.listdir(trace) if p.endswith(".trace.json")]
    assert len(traces) == 1
    with open(trace / traces[0]) as f:
        assert json.load(f)["traceEvents"]
    assert (trace / "o").read_bytes() == got[f"{both_runs['traced']}.out"]


def _outputs_of(k):
    """The files run k writes: its -o output (a directory for pafpseudo),
    and the files it names under {o} (maf-index writes <input>.index)."""
    run = RUNS[k]
    names = [f"{k}.out"]
    for a in run:
        if a.startswith("{o}/"):
            name = a[len("{o}/"):]
            names.append(name + ".index" if run[0] == "maf-index" else name)
    return names


@pytest.mark.parametrize("k", range(len(RUNS)),
                         ids=[" ".join(r).replace("{d}/", "") for r in RUNS])
def test_subcommand_writes_the_tpu_package_bytes(k, both_runs):
    """One case per run of RUNS: the host-only subcommands, `call -f paf`,
    the device branches (forced at any size) and the `-t 2` fork pools
    write the bytes of wgatools_tpu.cli.main."""
    got, want = both_runs["got"], both_runs["want"]
    names = [n for n in want if any(n == o or n.startswith(o + os.sep)
                                    for o in _outputs_of(k))]
    assert names, RUNS[k]
    for name in names:
        assert got.get(name) == want[name], name


# subcommands run through `python -m wgatools_tpu_torch`, one process each
MODULE_RUNS = [
    ["gen-completion", "-s", "zsh"],
    ["maf2sam", "{d}/in.maf", "--real"],
    ["filter", "-f", "chain", "{d}/in.chain", "-b", "20"],
    ["call", "-f", "paf", "{d}/in.paf", "--target", "{d}/all.fa", "-q",
     "{d}/all.fa", "-s"],
    ["stat", "-t", "2", "-f", "paf", "-e", "{d}/in.paf"],
    ["dotplot", "{d}/in.maf", "--out-format", "json", "--mode", "overview"],
]


@pytest.mark.parametrize("run", MODULE_RUNS, ids=lambda r: " ".join(r[:3]))
def test_module_entry_point(run, both_runs, tmp_path):
    d = both_runs["inputs"]
    argv = [a.format(d=d) for a in run]
    env = dict(os.environ, WGA_TORCH_DEVICE="cpu", PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    env.pop("WGA_TPU_DIST", None)
    proc = subprocess.run(
        [sys.executable, "-m", "wgatools_tpu_torch", *argv], capture_output=True,
        env=env, cwd=REPO, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr.decode()
    want = tmp_path / "want"
    ref = [a for a in argv]
    if ref[1:3] == ["-t", "2"]:
        del ref[1:3]
    assert host_main(ref + ["-o", str(want)]) == 0
    assert proc.stdout == want.read_bytes()
    assert proc.stdout


DIST_RUNS = [
    ["stat", "{d}/in.maf"],
    ["stat", "-f", "paf", "{d}/in.paf"],
    ["call", "{d}/in.maf"],
    ["maf2paf", "{d}/in.maf"],
    ["maf2chain", "{d}/in.maf"],
    ["paf2chain", "{d}/in.paf"],
    ["chain2paf", "{d}/in.chain"],
    ["pafcov", "{d}/in.paf"],
    ["validate", "{d}/bad.paf", "-f", "{o}/fixed.paf"],
    ["filter", "-f", "paf", "{d}/in.paf", "-a", "60"],
    ["dotplot", "{d}/in.maf"],
    ["pafpseudo", "{d}/in.paf", "-f", "{d}/all.fa", "-o", "{o}/pseudo"],
]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("inputs"))
    _write_inputs(d)
    return d


@pytest.mark.parametrize("run", DIST_RUNS, ids=lambda r: " ".join(r[:3]))
def test_dist_mode_one_process_writes_the_tpu_package_bytes(
        run, inputs, tmp_path, monkeypatch):
    """Under WGA_TPU_DIST with no coordinator variables the distributed
    driver runs in one process, and writes the bytes of the TPU package's
    driver under the same variable (pafpseudo: the same output
    directory).  tests/test_torch_dist_*.py run the drivers on 2-4
    ranks."""
    monkeypatch.setenv("WGA_TPU_DIST", "1")
    monkeypatch.setenv("WGA_TORCH_DEVICE", "cpu")
    for name in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                 "JAX_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    trees = []
    for label, main in (("got", cli.main), ("want", host_main)):
        o = str(tmp_path / label)
        os.makedirs(o)
        argv = [a.format(d=inputs, o=o) for a in run]
        if run[0] != "pafpseudo":
            argv += ["-o", os.path.join(o, "out")]
        assert main(argv) == 0, label
        trees.append(_tree(o))
    assert trees[0] == trees[1]
    assert trees[0]


# under WGA_TPU_DIST, the branches where the TPU package runs the serial
# tool: other subcommands, filter without -a, stdin and compressed inputs.
# (argv, file piped to stdin or None); {d}: the inputs
DIST_SERIAL_RUNS = [
    (["call", "-f", "paf", "{d}/in.paf", "--target", "{d}/all.fa", "-q",
      "{d}/all.fa", "-s"], None),
    (["rename", "{d}/in.maf", "-p", "x.,y.,z."], None),
    (["chunk", "{d}/in.maf", "-l", "40"], None),
    (["filter", "-f", "paf", "{d}/in.paf", "-b", "20"], None),
    (["filter", "-f", "paf", "-a", "60"], "in.paf"),
    (["stat"], "in.maf"),
    (["stat", "-f", "paf", "{d}/in.paf.gz"], None),
    (["maf2paf", "{d}/in.maf.gz"], None),
    (["pafcov"], "in.paf"),
    (["paf2chain"], "in.paf"),
    (["validate"], "bad.paf"),
]


@pytest.mark.parametrize(
    "run,stdin", DIST_SERIAL_RUNS,
    ids=[" ".join(r[:3]) + (f" < {i}" if i else "") for r, i in DIST_SERIAL_RUNS])
def test_dist_mode_runs_the_serial_tool_where_the_tpu_package_does(
        run, stdin, inputs, tmp_path, monkeypatch):
    """WGA_TPU_DIST=1 with one process: where wgatools_tpu/cli.py starts no
    distributed run, the port writes its bytes."""
    monkeypatch.setenv("WGA_TPU_DIST", "1")
    monkeypatch.setenv("WGA_TORCH_DEVICE", "cpu")
    for name in ("in.maf", "in.paf"):
        gz = os.path.join(inputs, name + ".gz")
        if not os.path.exists(gz):
            with open(os.path.join(inputs, name), "rb") as f:
                data = f.read()
            with gzip.open(gz + ".tmp", "wb") as f:
                f.write(data)
            os.replace(gz + ".tmp", gz)
    argv = [a.format(d=inputs) for a in run]
    outs = []
    for label, main in (("got", cli.main), ("want", host_main)):
        if stdin is not None:
            with open(os.path.join(inputs, stdin), "rb") as f:
                monkeypatch.setattr(sys, "stdin",
                                    io.TextIOWrapper(io.BytesIO(f.read())))
        out = tmp_path / label
        assert main(argv + ["-o", str(out)]) == 0, label
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]
    assert outs[0]
