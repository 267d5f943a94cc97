"""The tool's command line on N ranks kept across calls, as a lab keeps them
warm between jobs: N processes, one card each, started in set-up, each
joined to one process group by the program itself (WGA_TPU_DIST=1 and
the coordinator variables); a call is one `wgatools_tpu_torch.cli.main(argv)`
on every rank, and rank 0 writes the output.

Set-up starts the ranks (`python benchmark/drivers/ranks.py <fd>`, each
serving the harness over a socket) and makes one untimed call on every
rank, which joins the group, builds or loads the kernel and native
libraries and touches every shape the input asks for.  The program must
keep its group: after the warm-up call every rank must have started
exactly one group (the program's `dist_group_inits` counter), else set-up
ends the run with a non-zero exit; at the end of the window still one.
Set-up then goes on calling for WARM_S seconds: on a freshly started
machine the first calls after the warm-up one ran up to 30% slower for
~15 s.
A call is timed from the harness's go to the last rank's return, each
rank after a `torch.cuda.synchronize()`.  Each rank ships back its change
in the program's METRICS stages, counters and kernel launches for every
call: a sample's `stages` is the mean over the ranks, `ranks` each rank's
own, and the ranks' summed counters are added to the program's METRICS in
this process (which imports nothing of the program but that module), for
the readers that read them there.  Under --trace 1 every rank runs its
own torch.profiler over the window, each call in a
`record_function("invocation")` span, and the traces are read together:
busy seconds are the mean over the ranks, kernel seconds their sum.
"""

import os
import socket
import subprocess
import sys
import time
from multiprocessing.connection import Connection

import harness

# how long the ranks may take to start and make the warm-up call, and to
# answer one later request
START_TIMEOUT_S = 600
CALL_TIMEOUT_S = 600
# how long set-up goes on calling after the first warm-up call
WARM_S = 20
GROUP_COUNTER = "dist_group_inits"


def check_card(chips):
    """The cards by NVML, without importing torch in this process."""
    count, name = harness.nvml_cards()
    if count == 0:
        raise SystemExit("benchmark: NVML finds no card; the benchmark runs "
                         "on the card only")
    if count < chips:
        raise SystemExit(f"benchmark: {count} card(s), the cell asks for {chips}")
    return name


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ask(run, message, timeout=CALL_TIMEOUT_S):
    """Send `message` to every rank, then return every rank's answer."""
    for conn in run.state["conns"]:
        conn.send(message)
    return [_answer(run, k, conn, timeout)
            for k, conn in enumerate(run.state["conns"])]


def _answer(run, k, conn, timeout):
    deadline = time.monotonic() + timeout
    while not conn.poll(1.0):
        proc = run.state["procs"][k]
        if proc.poll() is not None or time.monotonic() > deadline:
            _log_tails(run)
            raise SystemExit(f"benchmark: rank {k} "
                             + ("exited" if proc.poll() is not None
                                else f"did not answer within {timeout} s"))
    try:
        return conn.recv()
    except EOFError:
        _log_tails(run)
        raise SystemExit(f"benchmark: rank {k} closed its connection")


def _log_tails(run):
    for k, path in enumerate(run.state["logs"]):
        with open(path, "rb") as f:
            tail = f.read()[-3000:].decode(errors="replace")
        sys.stderr.write(f"--- rank {k} (last lines)\n{tail}\n")


def setup(run):
    n = run.spec["traffic"]["ranks"]
    port = _free_port()
    env = dict(os.environ, WGA_TPU_DIST="1",
               PYTHONPATH=os.pathsep.join((harness.ROOT, harness.BENCH)),
               JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
               JAX_NUM_PROCESSES=str(n))
    run.state = {"procs": [], "conns": [], "logs": [], "ranks": n}
    for k in range(n):
        ours, theirs = socket.socketpair()
        log = os.path.join(run.workdir, f"rank{k}.log")
        with open(log, "wb") as out:
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(theirs.fileno())],
                env=dict(env, JAX_PROCESS_ID=str(k)), cwd=harness.ROOT,
                stdout=out, stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL,
                pass_fds=(theirs.fileno(),))
        theirs.close()
        run.state["procs"].append(proc)
        run.state["conns"].append(Connection(ours.detach()))
        run.state["logs"].append(log)
    warm = _call(run, run.output, timeout=START_TIMEOUT_S)
    if not warm["ok"]:
        _log_tails(run)
        raise SystemExit("benchmark: the warm-up call failed")
    _check_group(warm["rank_counts"], "after the warm-up call")
    run.state["inits"] = [c.get(GROUP_COUNTER, 0) for c in warm["rank_counts"]]
    t0 = time.monotonic()
    while time.monotonic() - t0 < WARM_S:
        warm = _call(run, run.output)
        if not warm["ok"]:
            _log_tails(run)
            raise SystemExit("benchmark: a warm-up call failed")
        run.state["inits"] = [i + c.get(GROUP_COUNTER, 0) for i, c in
                              zip(run.state["inits"], warm["rank_counts"])]


def _check_group(rank_counts, when):
    inits = [c.get(GROUP_COUNTER) for c in rank_counts]
    if any(v != 1 for v in inits):
        raise SystemExit(
            f"benchmark: {when}, the ranks' {GROUP_COUNTER} read {inits}: the "
            "program does not keep its process group across calls")


def _call(run, output, timeout=CALL_TIMEOUT_S):
    t0 = time.perf_counter()
    answers = _ask(run, ("call", run.argv(output)), timeout)
    wall = time.perf_counter() - t0
    names = sorted({k for a in answers for k in a["stages"]})
    stages = {k: sum(a["stages"].get(k, 0.0) for a in answers) / len(answers)
              for k in names}
    return {"ok": all(a["rc"] == 0 for a in answers), "wall": wall,
            "stages": stages, "ranks": [a["stages"] for a in answers],
            "rank_counts": [a["counts"] for a in answers],
            "launches": [a["launches"] for a in answers]}


def window(run):
    reservoir = harness.Reservoir(run.seed, run.spec["traffic"]["compare"])
    if run.trace:
        _ask(run, ("trace", True))
    try:
        run.samples, run.window_s = harness.closed_loop(
            lambda i, output: _call(run, output), run.seconds, reservoir,
            run.output, run.keep_path)
    finally:
        traces = _ask(run, ("trace", False)) if run.trace else []
    run.kept = reservoir.kept
    run.launches_known = True
    totals = [dict() for _ in range(run.state["ranks"])]
    for s in run.samples:
        for per_rank in s["launches"]:
            for k, v in per_rank.items():
                run.launches[k] = run.launches.get(k, 0) + v
        for total, counts in zip(totals, s["rank_counts"]):
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
    _check_group([{GROUP_COUNTER: i + c.get(GROUP_COUNTER, 0)}
                  for i, c in zip(run.state["inits"], totals)],
                 "at the end of the window")
    _add_counts(totals)
    run.device["memory_peak_bytes"] = max(_ask(run, ("memory",)))
    if run.trace:
        read = harness.read_traces(
            traces, lambda p: harness.annotations(p, "invocation"))
        for path in traces:
            os.remove(path)
        run.device["busy_s"] = read["busy_s"] / run.state["ranks"]
        run.device["kernel_s"] = read["kernel_s"]
        run.device["breakdown"] = read["breakdown"]


def _add_counts(totals):
    """The ranks' counters of the window, summed, into the program's METRICS
    of this process (imported alone: no torch, no tool)."""
    import importlib

    metrics = importlib.import_module(harness.PROGRAM + ".core.metrics").METRICS
    for counts in totals:
        for k, v in counts.items():
            metrics.count(k, v)


def teardown(run):
    state, run.state = run.state, None
    if not state:
        return
    for conn in state["conns"]:
        try:
            conn.send(("exit",))
        except OSError:
            pass
    deadline = time.monotonic() + 60
    for proc in state["procs"]:
        try:
            proc.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    for conn in state["conns"]:
        conn.close()


# ---- one rank: serves the harness over the socket it was handed ----

def _serve(fd):
    conn = Connection(fd)
    import torch

    cuda = os.environ.get("WGA_TORCH_DEVICE") == "cuda"
    rank = int(os.environ["JAX_PROCESS_ID"])
    if cuda:
        # the card the program binds this rank to (rank % cards), before
        # anything touches a card
        torch.cuda.set_device(rank % torch.cuda.device_count())
    from wgatools_tpu_torch import cli
    from wgatools_tpu_torch.core.metrics import METRICS

    prof = None
    while True:
        message = conn.recv()
        kind = message[0]
        if kind == "exit":
            break
        if kind == "call":
            conn.send(_serve_call(cli, METRICS, torch, cuda, prof, message[1]))
        elif kind == "trace":
            if message[1]:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU]
                if cuda:
                    acts.append(ProfilerActivity.CUDA)
                prof = profile(activities=acts)
                prof.start()
                conn.send(None)
            else:
                path = None
                if prof is not None:
                    prof.stop()
                    path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                                        f"wgabench-rank{rank}-{os.getpid()}.json")
                    prof.export_chrome_trace(path)
                    prof = None
                conn.send(path)
        elif kind == "memory":
            conn.send(torch.cuda.max_memory_allocated() if cuda else 0)
    conn.close()


def _launches():
    build = sys.modules.get("wgatools_tpu_torch.kernels._build")
    return dict(build.LAUNCHES) if build is not None else {}


def _serve_call(cli, metrics, torch, cuda, prof, argv):
    import contextlib
    import traceback

    launches = _launches()
    stages = {k: v[0] for k, v in metrics.stages.items()}
    counts = dict(metrics.counts)
    span = contextlib.nullcontext()
    if prof is not None:
        from torch.profiler import record_function

        span = record_function("invocation")
    with span:
        try:
            rc = cli.main(argv)
        except Exception:
            traceback.print_exc()
            rc = -1
        if cuda:
            torch.cuda.synchronize()
    after = _launches()
    return {
        "rc": rc,
        "stages": {k: v[0] - stages.get(k, 0.0)
                   for k, v in metrics.stages.items()
                   if v[0] - stages.get(k, 0.0) > 0},
        "counts": {k: v - counts.get(k, 0) for k, v in metrics.counts.items()
                   if v != counts.get(k, 0)},
        "launches": {k: v - launches.get(k, 0) for k, v in after.items()
                     if v != launches.get(k, 0)},
    }


if __name__ == "__main__":
    _serve(int(sys.argv[1]))
