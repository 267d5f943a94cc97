"""The tool's command-line entry, called in this process: one client that
calls `wgatools_tpu_torch.cli.main(argv)` again as soon as it returns.

Set-up imports the program and makes one untimed call, which builds or
loads the kernel and native libraries and touches every shape the input
asks for.  Each call is timed from entry to return, after a
`torch.cuda.synchronize()`, and records the change in the program's
`METRICS.stages` seconds.  Under --trace 1 the window runs inside
torch.profiler, each call in a `record_function("invocation")` span.
"""

import contextlib
import os
import sys
import time
import traceback

import harness


def setup(run):
    import torch

    from wgatools_tpu_torch import cli
    from wgatools_tpu_torch.core.metrics import METRICS

    run.state = {"torch": torch, "cli": cli, "metrics": METRICS,
                 "cuda": os.environ["WGA_TORCH_DEVICE"] == "cuda"}
    if not _invoke(run)["ok"]:
        raise SystemExit("benchmark: the warm-up call failed")


def _invoke(run, output=None, span=contextlib.nullcontext):
    torch, cli, metrics = run.state["torch"], run.state["cli"], run.state["metrics"]
    before = {k: v[0] for k, v in metrics.stages.items()}
    argv = run.argv(output)
    with span():
        t0 = time.perf_counter()
        try:
            rc = cli.main(argv)
        except Exception:
            traceback.print_exc()
            rc = -1
        if run.state["cuda"]:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stages = {k: v[0] - before.get(k, 0.0) for k, v in metrics.stages.items()
              if v[0] - before.get(k, 0.0) > 0}
    return {"ok": rc == 0, "wall": wall, "stages": stages}


def _launches():
    build = sys.modules.get("wgatools_tpu_torch.kernels._build")
    return dict(build.LAUNCHES) if build is not None else {}


def window(run):
    torch = run.state["torch"]
    reservoir = harness.Reservoir(run.seed, run.spec["traffic"]["compare"])
    before = _launches()
    span = contextlib.nullcontext
    prof = None
    if run.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        span = lambda: record_function("invocation")  # noqa: E731
        prof.start()
    try:
        run.samples, run.window_s = harness.closed_loop(
            lambda i, output: _invoke(run, output, span), run.seconds,
            reservoir, run.output, run.keep_path)
    finally:
        if prof is not None:
            prof.stop()
    run.kept = reservoir.kept
    after = _launches()
    run.launches = {k: after[k] - before.get(k, 0) for k in after}
    run.launches_known = True
    run.device["memory_peak_bytes"] = max(
        torch.cuda.max_memory_allocated(i) for i in range(run.chips)
    ) if run.state["cuda"] else 0
    if prof is not None:
        path = os.path.join(run.workdir, "trace.json")
        prof.export_chrome_trace(path)
        traces = harness.read_traces(
            [path], lambda p: harness.annotations(p, "invocation"))
        os.remove(path)
        for key in ("busy_s", "kernel_s", "breakdown"):
            run.device[key] = traces[key]


def teardown(run):
    run.state = None
