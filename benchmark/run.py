"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell's entry in BENCHMARK.json names its
configuration (benchmark/configs/, with the generator of its input) and its
traffic (benchmark/traffic/, with the driver that runs the tool and the
plain reference that judges it); benchmark/workloads/<name>.json holds the
work the input asks of the cell's kernels.  Set-up pins the card route,
generates the input from the seed, and warms the tool's path; the window
runs the tool in a closed loop for --seconds; then every output sampled
from the window is compared with the plain reference's answer.  The last
line of stdout is the result as JSON: with --trace 0 the cell's end-to-end
metrics, with --trace 1 its per-layer metrics, read under torch.profiler.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

T_START = time.perf_counter()

import harness  # noqa: E402


class Run:
    """One run of one cell: what set-up made, what the window measured."""

    def __init__(self, args, spec):
        self.name = args.workload
        self.seed = args.seed
        self.seconds = args.seconds
        self.trace = bool(args.trace)
        self.spec = spec
        self.chips = spec["cell"]["chips"]
        self.workdir = tempfile.mkdtemp(prefix="wgabench-")
        self.suffix = spec["traffic"]["output_suffix"]
        self.input = None  # set-up's, from the seed
        self.output = os.path.join(self.workdir, "out" + self.suffix)
        self.counts = {}
        self.samples = []
        self.window_s = 0.0
        self.kept = {}
        self.device = {}
        self.launches = {}
        self.state = None  # the driver's, from setup to teardown
        # whether the driver could count the kernel launches of the window
        self.launches_known = False

    def keep_path(self, i):
        return os.path.join(self.workdir, f"kept{i}{self.suffix}")

    def argv(self, output=None):
        return harness.fill(self.spec["traffic"]["argv"], input=self.input,
                            output=output or self.output)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def check_card(chips):
    """The card route or nothing: no CUDA, or fewer cards than the cell asks
    for, ends the run before any result.  A driver that never uses torch in
    this process brings its own look (`check_card`)."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("benchmark: torch.cuda.is_available() is False; "
                         "the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"benchmark: {torch.cuda.device_count()} card(s), "
                         f"the cell asks for {chips}")
    return torch.cuda.get_device_name(0)


def check_program():
    import importlib.util

    if importlib.util.find_spec(harness.PROGRAM) is None:
        raise SystemExit(f"benchmark: the program {harness.PROGRAM} is not "
                         "in this checkout")


def judge(run, reference):
    """The compared numbers, each with its limit, and whether all hold."""
    expected = reference.answer(run.input)
    differing_outputs = 0
    differing_lines = 0
    for path in run.kept.values():
        with open(path, "rb") as f:
            equal, lines = harness.compare(expected, f.read())
        differing_outputs += not equal
        differing_lines = max(differing_lines, lines)
    failed = sum(not s["ok"] for s in run.samples)
    checks = {
        "outputs_checked": {"value": len(run.kept), "limit": ">= 1"},
        "failed_invocations": {"value": failed, "limit": 0},
        "differing_outputs": {"value": differing_outputs, "limit": 0},
        "differing_lines": {"value": differing_lines, "limit": 0},
    }
    correct = (len(run.kept) >= 1 and failed == 0 and differing_outputs == 0
               and differing_lines == 0)
    return correct, checks


def end_to_end(run, setup_s):
    """The cell's end-to-end metrics, over all invocations of the window."""
    done = [s for s in run.samples if s["ok"]]
    cols = run.counts["aligned_columns"]
    values = {
        "setup_s": setup_s,
        "tool_gbp_per_s": cols * len(done) / run.window_s / 1e9,
        "tool_wall_p95_s": harness.nearest_rank([s["wall"] for s in done], 0.95)
        if done else None,
        "cli_process_s": run.window_s / len(done) if done else None,
    }
    out = {}
    for m in run.spec["end_to_end"]:
        if values.get(m["name"]) is not None:
            out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    return out


def per_layer(run):
    out = {}
    for m in run.spec["per_layer"]:
        value = harness.load_part("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None, card=None, pin=harness.pinned_env):
    """`card` and `pin` are the look for the card and the environment of the
    card route; the tests give their own to drive a run on the CPU."""
    args = parse_args(argv)
    run_env = dict(os.environ)
    spec = harness.cell_spec(args.workload)
    sys.path.insert(0, harness.ROOT)
    check_program()
    driver = harness.load_part("drivers", spec["traffic"]["driver"])
    card = card or getattr(driver, "check_card", check_card)
    kind = card(spec["cell"]["chips"])
    os.environ.clear()
    os.environ.update(pin(run_env))
    run = Run(args, spec)
    try:
        run.input, run.counts = harness.cached_input(spec, run.seed)
        driver.setup(run)
        setup_s = time.perf_counter() - T_START
        driver.window(run)
        found = harness.forbidden_modules(sys.modules)
        if found:
            print(f"benchmark: forbidden modules loaded: {found}",
                  file=sys.stderr)
            return 4
        missing = [k for k in spec["work"]["kernels"]
                   if run.launches.get(k, 0) == 0 and run.launches_known]
        driver.teardown(run)
        reference = harness.load_part("reference", spec["traffic"]["reference"])
        correct, checks = judge(run, reference)
        if missing:
            correct = False
            checks["kernels_not_launched"] = {"value": len(missing), "limit": 0}
        metrics = per_layer(run) if run.trace else end_to_end(run, setup_s)
        device = {"platform": "gpu", "kind": kind, "count": run.chips,
                  "memory_peak_bytes": run.device["memory_peak_bytes"]}
        result = {"correct": correct, "attempted": len(run.samples),
                  "failed": sum(not s["ok"] for s in run.samples),
                  "metrics": metrics, "device": device}
        if run.trace:
            device["busy_s"] = run.device["busy_s"]
            device["window_s"] = run.window_s
            result["breakdown"] = run.device["breakdown"]
        result["checks"] = checks
        print("walls_s: " + " ".join(f"{s['wall']:.4f}" for s in run.samples),
              file=sys.stderr)
        print(f"correct: {str(correct).lower()}", file=sys.stderr)
        for name, c in checks.items():
            print(f"check {name}: {c['value']} (limit {c['limit']})",
                  file=sys.stderr)
        print(json.dumps(result))
        return 0
    finally:
        if run.state is not None:
            driver.teardown(run)
        shutil.rmtree(run.workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
