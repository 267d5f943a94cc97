"""One fresh command-line process a request: `bin/wgatools-tpu-torch <argv>`,
the launcher users run, started when the one before has exited.

Each process is timed from spawn to exit.  Set-up runs one untimed process,
which builds the kernel and native libraries into the checkout on a first
run and warms the page cache.  The harness imports no torch and opens no
CUDA context of its own: it counts the cards, and reads the device memory
peak, by NVML.  Under --trace 1 each process also runs with `-vv` (the
program's METRICS stages and kernel launches on stderr), and the processes
alternate: the even ones under PYTHONPROFILEIMPORTTIME=1 (Python's own
import times, and the `total` stage less the imports inside it), the odd
ones under WGA_TPU_TRACE (the program's torch.profiler trace of its tool
work), so that neither reading carries the other's cost.
"""

import glob
import json
import math
import os
import re
import subprocess
import sys
import time

import harness

_IMPORT = re.compile(rb"^import time:\s*\d+ \|\s*(\d+) \| (\S.*)$", re.M)
_STAGE = re.compile(rb"stage (\S+)\s+([0-9.]+)s")
_LAUNCHES = re.compile(rb"kernel launches: (\{.*\})")
CLI_MODULE = b"wgatools_tpu_torch.cli"


def import_seconds(stderr):
    """(all, inside main) seconds of the top-level imports that
    PYTHONPROFILEIMPORTTIME reports: `python -m wgatools_tpu_torch` imports
    the CLI module, then calls its main(), whose `total` METRICS stage holds
    every import listed after that module's (torch among them)."""
    rows = [(int(c), name) for c, name in _IMPORT.findall(stderr)]
    names = [name for _, name in rows]
    cut = names.index(CLI_MODULE) + 1 if CLI_MODULE in names else len(rows)
    return (sum(c for c, _ in rows) * 1e-6,
            sum(c for c, _ in rows[cut:]) * 1e-6)


def check_card(chips):
    """The card route or nothing, without importing torch: the processes
    themselves refuse to run without CUDA (WGA_TORCH_DEVICE=cuda)."""
    count, name = harness.nvml_cards()
    if count == 0:
        raise SystemExit("benchmark: NVML finds no card; the benchmark runs "
                         "on the card only")
    if count < chips:
        raise SystemExit(f"benchmark: {count} card(s), the cell asks for {chips}")
    return name


def setup(run):
    env = dict(os.environ)
    env["PATH"] = os.path.dirname(sys.executable) + os.pathsep + env.get("PATH", "")
    run.state = {"env": env,
                 "launcher": os.path.join(harness.ROOT, "bin", "wgatools-tpu-torch")}
    if not _invoke(run, None, run.output)["ok"]:
        raise SystemExit("benchmark: the warm-up process failed")


def _invoke(run, i, output):
    argv = [run.state["launcher"], *run.argv(output)]
    env = run.state["env"]
    trace_dir = None
    traced = run.trace and i is not None
    if traced and i % 2 == 0:
        env = dict(env, PYTHONPROFILEIMPORTTIME="1")
    elif traced:
        trace_dir = os.path.join(run.workdir, f"trace{i}")
        env = dict(env, WGA_TPU_TRACE=trace_dir)
    if traced:
        argv.append("-vv")
    t0 = time.perf_counter()
    p = subprocess.run(argv, env=env, cwd=harness.ROOT,
                       stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    sample = {"ok": p.returncode == 0, "wall": time.perf_counter() - t0}
    if not sample["ok"]:
        sys.stderr.write(p.stderr.decode(errors="replace")[-4000:])
    if traced:
        launches = _LAUNCHES.search(p.stderr)
        sample["launches"] = json.loads(launches.group(1)) if launches else {}
    if traced and trace_dir is None:
        sample["import_s"], sample["import_in_main_s"] = import_seconds(p.stderr)
        sample["stages"] = {k.decode(): float(v) for k, v in _STAGE.findall(p.stderr)}
    if trace_dir is not None:
        sample["trace"] = glob.glob(os.path.join(trace_dir, "*.json"))
    return sample


def window(run):
    reservoir = harness.Reservoir(run.seed, run.spec["traffic"]["compare"])
    with harness.MemoryPoller(run.chips) as memory:
        run.samples, run.window_s = harness.closed_loop(
            lambda i, output: _invoke(run, i, output), run.seconds, reservoir,
            run.output, run.keep_path)
    run.kept = reservoir.kept
    run.device["memory_peak_bytes"] = memory.peak
    if not run.trace:
        return
    run.launches_known = True
    for s in run.samples:
        for k, v in s.get("launches", {}).items():
            run.launches[k] = run.launches.get(k, 0) + v
    # one process's trace covers its tool work: one call
    traces = harness.read_traces([p for s in run.samples for p in s.get("trace", [])],
                                 lambda p: [(-math.inf, math.inf)])
    for key in ("busy_s", "kernel_s", "breakdown"):
        run.device[key] = traces[key]


def teardown(run):
    run.state = None
