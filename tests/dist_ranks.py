"""Launch the ranks of a distributed command line run, as users launch them
(one process each, JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
JAX_PROCESS_ID and WGA_TPU_DIST=1), for the tests of the port's
distributed tools.

run_port_ranks starts `wgatools_tpu_torch.cli.main` in n processes on the
CPU (gloo); each rank records the paths it opened for writing (an audit
hook) and whether it imported jax or wgatools_tpu.  run_tpu_ranks starts
`python -m wgatools_tpu` in n processes, as tests/test_distributed_2proc.py
does.  Every rank set has its own timeout, after which every rank is
killed and the test fails.
"""

import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS_TIMEOUT_S = 120

PORT_RANK = r"""
import json, os, sys
WRITE = os.O_WRONLY | os.O_RDWR | os.O_CREAT
opened = []
def hook(event, args):
    if event == "open" and isinstance(args[0], str) and args[2] & WRITE:
        opened.append(os.path.abspath(args[0]))
sys.addaudithook(hook)
from wgatools_tpu_torch.cli import main
rc = main(sys.argv[2:])
report = {"rc": rc, "opened": list(opened), "imported": sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "wgatools_tpu"))}
with open(sys.argv[1], "w") as f:
    json.dump(report, f)
sys.exit(rc)
"""


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run(cmds, envs, timeout, log_dir):
    """Run every command at once, each rank's stdout and stderr into files
    (no rank can block on a full pipe while another waits for it in a
    collective); kill every rank when any is still running at `timeout`."""
    logs = [(os.path.join(log_dir, f"rank{k}.out"),
             os.path.join(log_dir, f"rank{k}.err")) for k in range(len(cmds))]
    procs = []
    try:
        for cmd, env, (out, err) in zip(cmds, envs, logs):
            with open(out, "wb") as o, open(err, "wb") as e:
                procs.append(subprocess.Popen(cmd, env=env, cwd=REPO,
                                              stdout=o, stderr=e))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    got = []
    for p, (out, err) in zip(procs, logs):
        with open(out, "rb") as o, open(err, "rb") as e:
            got.append((p.returncode, o.read(), e.read()))
        os.remove(out)
        os.remove(err)
    return got


def _rank_env(n, pid, port, extra):
    env = dict(
        os.environ,
        JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
        JAX_NUM_PROCESSES=str(n),
        JAX_PROCESS_ID=str(pid),
        WGA_TPU_DIST="1",
    )
    env.pop("WGA_TPU_GIANT_SPLIT", None)
    env.update(extra or {})
    return env


def run_port_ranks(argv, n, report_dir, env=None, timeout=RANKS_TIMEOUT_S,
                   rank_env=None):
    """argv on n ranks of the port's CLI (gloo), `env` added to every
    rank's environment and rank_env[k] to rank k's.  Returns, in rank
    order, dicts of rc, stdout, stderr, `opened` (absolute paths the rank
    opened for writing) and `imported` (modules of jax or wgatools_tpu it
    had)."""
    port = free_port()
    reports = [os.path.join(report_dir, f"rank{pid}.json") for pid in range(n)]
    cmds = [[sys.executable, "-c", PORT_RANK, reports[pid], *argv]
            for pid in range(n)]
    envs = []
    for pid in range(n):
        e = _rank_env(n, pid, port, env)
        e.update(WGA_TORCH_DEVICE="cpu", PYTHONPATH=REPO)
        e.update((rank_env or {}).get(pid, {}))
        envs.append(e)
    got = []
    for (rc, out, err), path in zip(_run(cmds, envs, timeout, report_dir),
                                   reports):
        rank = {"rc": rc, "stdout": out, "stderr": err.decode()}
        if os.path.exists(path):
            with open(path) as f:
                rank.update(json.load(f))
            os.remove(path)
        got.append(rank)
    return got


def run_tpu_ranks(argv, n, log_dir, timeout=RANKS_TIMEOUT_S):
    """argv on n processes of `python -m wgatools_tpu` (jax.distributed on
    the CPU, two virtual devices each): [(rc, stdout, stderr)]."""
    port = free_port()
    envs = []
    for pid in range(n):
        e = _rank_env(n, pid, port, None)
        e.update(PYTHONPATH="", JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=2")
        envs.append(e)
    cmds = [[sys.executable, "-m", "wgatools_tpu", *argv]] * n
    return _run(cmds, envs, timeout, log_dir)
