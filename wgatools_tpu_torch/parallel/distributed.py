"""Multi-process initialization and genome-axis work partitioning, on
torch.distributed.

The port of wgatools_tpu/parallel/distributed.py.  Ranks launch as the TPU
package's processes do: one process each, with JAX_COORDINATOR_ADDRESS
(host:port), JAX_NUM_PROCESSES and JAX_PROCESS_ID set.  Process 0 holds a
TCPStore at that address, and every rank joins one default process group
over it: NCCL, one card per rank, when the port runs on the card
(core.device), gloo when it runs on the CPU.  Neither backend stands in
for the other.  Work units come from the MAF index, as in the TPU package
(claim_work_units).

A rank's share of a tool's work may take hours, and the ranks finish it at
different times.  The merges therefore first meet on the group's store
(wait_for_ranks, which waits up to MERGE_WAIT_S), and only then enter
the collectives, whose timeout is short.  A rank that fails marks the
store (shutdown_distributed), and the ranks waiting for it stop.

The group that maybe_initialize_distributed starts is kept for the life of
the process: later calls of the command line in the same process (ranks
kept warm between jobs) reuse it, and it is destroyed at exit, or at once
after a call that failed.  The METRICS counter `dist_group_inits` counts
the groups this process started.

This module imports torch only inside its functions: the tool drivers
(dist_tools) import it, and the command line loads them on every run.
"""

import atexit
import datetime
import logging
import os
import sys
import time
from contextlib import contextmanager

from ..core.metrics import METRICS
from ..errors import WGAError

log = logging.getLogger(__name__)

# the rendezvous: every rank must have joined the group within this
INIT_TIMEOUT_S = 120
# one collective, entered once every rank has reached its merge
COLLECTIVE_TIMEOUT_S = 600
# how long a rank waits at a merge for the slowest rank's own work
MERGE_WAIT_S = 24 * 3600
# the longest pause between two looks at the store while a rank waits
POLL_MAX_S = 0.001
# the store key a failing rank sets
FAILED_KEY = "wgatools/failed"

# the group's store (init_group) and the merges begun on it so far, the
# same count on every rank
_STORE = None
_MERGES = 0


@contextmanager
def stdout_parked():
    """Temporarily point fd 1 at stderr: C++ comm backends print banners
    straight to fd 1 at init and at a first collective, and tool stdout
    must stay byte-clean for pipes."""
    sys.stdout.flush()
    saved = os.dup(1)
    try:
        os.dup2(2, 1)
        yield
    finally:
        os.dup2(saved, 1)
        os.close(saved)


def init_group(backend, store, rank, size, device, timeout_s=INIT_TIMEOUT_S):
    """Initialise the default process group of `backend` over `store`.
    NCCL binds the group to `device` at once, so that a card that cannot
    take part fails here."""
    global _STORE, _MERGES
    import torch
    import torch.distributed as dist

    device = torch.device(device)
    kwargs = {}
    if backend == "nccl":
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=size,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs,
    )
    _STORE, _MERGES = store, 0
    METRICS.count("dist_group_inits", 1)


def maybe_initialize_distributed():
    """Join the ranks' process group from the standard env vars when they
    are all present; returns False, starting nothing, when any is absent.
    A group this process started before and still holds is kept: True at
    once.

    The backend follows the port's device: NCCL on the card, where rank
    `pid` takes card pid % cards, and gloo on the CPU.  The group is
    destroyed at the process's exit (shutdown_distributed)."""
    import torch
    import torch.distributed as dist

    from ..core.device import torch_device

    addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = os.environ.get("JAX_NUM_PROCESSES")
    pid = os.environ.get("JAX_PROCESS_ID")
    if not (addr and nproc and pid):
        return False
    if _STORE is not None and dist.is_initialized():
        return True
    rank, size = int(pid), int(nproc)
    host, port = addr.rsplit(":", 1)
    if torch_device().type == "cuda":
        backend = "nccl"
        device = torch.device("cuda", rank % torch.cuda.device_count())
    else:
        backend, device = "gloo", torch.device("cpu")

    # tool output is piped: keep stdout byte-clean during init
    with stdout_parked():
        store = dist.TCPStore(
            host, int(port), size, is_master=rank == 0,
            timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S),
        )
        init_group(backend, store, rank, size, device, COLLECTIVE_TIMEOUT_S)
    atexit.register(shutdown_distributed)
    log.info("torch.distributed initialized: process %s/%s via %s, backend %s",
             pid, nproc, addr, backend)
    return True


def process_index_count():
    """(this process's rank, the number of ranks): (0, 1) when no group
    was started, as jax.process_index()/process_count() without
    jax.distributed."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def wait_for_ranks():
    """Return once every rank of the group has called this as often as
    this rank has: the n-th call on one rank meets the n-th on the others,
    on the group's store, with no collective and no time limit of the
    group's own.  Raises WGAError when another rank failed first, when the
    store has gone (rank 0, its host, ended its group), or after
    MERGE_WAIT_S.  Nothing to wait for without a group."""
    global _MERGES
    import torch.distributed as dist

    if _STORE is None or not dist.is_initialized():
        return
    _MERGES += 1
    try:
        _meet(f"wgatools/merge{_MERGES}", dist.get_world_size())
    except dist.DistError as e:
        raise WGAError(f"merge {_MERGES}: the group's store has gone "
                       f"({str(e).splitlines()[0]})") from e


def _meet(key, size):
    if _STORE.add(key, 1) == size:
        _STORE.set(key + "/all", "1")
    t0 = time.monotonic()
    pause = POLL_MAX_S / 8
    # poll: a store wait that times out logs a warning each time; the
    # pause stays short, so that the last rank's arrival is seen within
    # POLL_MAX_S
    while not _STORE.check([key + "/all"]):
        if _STORE.check([FAILED_KEY]):
            raise WGAError(f"rank {_STORE.get(FAILED_KEY).decode()} failed "
                           f"before merge {_MERGES}")
        if time.monotonic() - t0 > MERGE_WAIT_S:
            raise WGAError(f"merge {_MERGES}: not every rank arrived within "
                           f"{MERGE_WAIT_S:g} s")
        time.sleep(pause)
        pause = min(2 * pause, POLL_MAX_S)


def shutdown_distributed(failed=False):
    """Destroy the process group, if one was started.  failed: this rank
    did not finish its work; the store says so to the ranks that wait for
    it at a merge (wait_for_ranks)."""
    global _STORE
    import torch.distributed as dist

    if failed and _STORE is not None:
        try:
            _STORE.set(FAILED_KEY, str(dist.get_rank()))
        except Exception:  # the store's host, rank 0, has gone
            pass
    _STORE = None
    if dist.is_initialized():
        dist.destroy_process_group()


def claim_work_units(mafindex, process_id: int, num_processes: int):
    """Partition the index's (name, interval, offset) units across hosts.

    Deterministic round-robin over offset-sorted units: every host derives
    the same assignment from the shared manifest, so there is no coordinator
    state to lose -- restart re-reads the index (SURVEY.md §5 checkpoint
    analog).
    """
    units = []
    for name, item in mafindex.items():
        if not item["isref"]:
            continue
        for iv in item["ivls"]:
            units.append((name, iv["start"], iv["end"], iv["offset"]))
    units.sort(key=lambda u: u[3])
    return [u for k, u in enumerate(units) if k % num_processes == process_id]
