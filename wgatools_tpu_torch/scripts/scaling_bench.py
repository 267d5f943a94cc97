"""Multi-card scaling of the sharded column stats.

The counterpart of scripts/scaling_bench.py, with its flags, defaults and
JSON lines:

    python -m wgatools_tpu_torch.scripts.scaling_bench [--cols 1048576]
        [--rows-per-dev 8] [--iters 10] [--nproc N]

For each group size 1, 2, 4, ... up to --nproc (and --nproc itself; the
default is the card count, 1 on the CPU) it spawns that many ranks
(parallel.dryrun.spawn): one card each over NCCL, or gloo ranks on the CPU
under WGA_TORCH_DEVICE=cpu.  Each rank makes its own shard of
rows-per-dev x cols byte columns over ACGT- (seeded by group size and
rank) and checks parallel.mesh.sharded_column_stats on its byte words
(kernel D's word entry on the card) against the plain version.  An
iteration sums the rank's stats, all_reduces that int32 across the group
(the global sum of the TPU script's jnp.sum over the sharded stats) into
the checksum, and feeds it back into word [0, 0] of rank 0's shard.  On the
card the 1-iteration and the --iters-iteration loops are each captured once
in a CUDA graph, all_reduce included, and replayed; on the CPU they run
eagerly.  Timing as bench.py: a warm batch at each count, the min of 3
batches at each, the marginal rate, or the whole-batch lower bound when
the marginal is not positive or exceeds the guard (the byte words' 2 B per
column at the card's memory rate, times the group size).  Every rank
logs its backend and, at its end, `kernel launches: {json}` on stderr; one
JSON line per size goes to stdout: {"devices", "gcols_per_s",
"scaling_efficiency"}, the efficiency against the smallest size's rate
scaled by the group size.
"""

import argparse
import functools
import json
import os
import sys
import time

import torch
import torch.distributed as dist

from ..bench import GraphLoop, Loop, card_name_and_power, launches, marginal_rate
from ..core.device import PEAK_BYTES_PER_S, torch_device
from ..kernels import _build
from ..ops.classify import classify_stat_words_ref
from ..parallel.dryrun import spawn
from ..parallel.mesh import sharded_column_stats

BUILD = os.path.join(os.path.dirname(_build.BUILD_DIR), "scaling_bench")


def log(msg):
    # one write a line: the ranks share the stream
    sys.stderr.write(f"[scaling_bench] {msg}\n")
    sys.stderr.flush()


def group_sizes(n_total):
    """1, 2, 4, ... up to n_total, and n_total itself."""
    sizes, n = [], 1
    while n <= n_total:
        sizes.append(n)
        n *= 2
    if sizes[-1] != n_total:
        sizes.append(n_total)
    return sizes


def shard_planes(size, rank, rows, cols, device):
    """Rank `rank`'s shard in a group of `size`: (tw, qw) int32 byte words
    [rows, cols / 4] of columns over ACGT-, made on `device` from the seed
    (size, rank), and int32 lengths [rows] (all cols)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(1000 * size + rank)
    alphabet = torch.tensor(list(b"ACGT-"), dtype=torch.uint8, device=device)
    planes = [alphabet[torch.randint(0, 5, (rows, cols), generator=gen,
                                     device=device)].view(torch.int32)
              for _ in range(2)]
    lens = torch.full((rows,), cols, dtype=torch.int32, device=device)
    return planes[0], planes[1], lens


def _step(group, s, acc):
    """One iteration: this rank's stats summed, all_reduced over the group
    into acc, and fed back into rank 0's first word."""
    local = sharded_column_stats(group, s["tw"], s["qw"], s["lens"]).sum(
        dtype=torch.int32)
    dist.all_reduce(local, group=group.pg)
    acc += local
    if group.rank == 0:
        s["tw"][0, 0] = 0x41414141 + (acc & 3)


def scaling_rank(group, cols, rows, iters):
    """One rank of one group size: the gate, then the timing.  Returns
    {"stats": the gate's int32 [rows, 8] stats (numpy), "rate": the
    group's columns/s as this rank timed it, "launches": this rank's kernel
    launches}."""
    device = group.device
    on_card = device.type == "cuda"
    log(f"rank {group.rank}/{group.size}: backend {dist.get_backend()}, "
        f"device {device}")
    tw, qw, lens = shard_planes(group.size, group.rank, rows, cols, device)
    stats = sharded_column_stats(group, tw, qw, lens)
    if not torch.equal(stats, classify_stat_words_ref(tw, qw, lens)):
        raise AssertionError(f"rank {group.rank}: sharded_column_stats "
                             "differs from the plain version")
    loop = Loop(functools.partial(_step, group),
                {"tw": tw, "qw": qw, "lens": lens})
    eager = loop.run(iters)
    graphs = {}
    if on_card:
        torch.cuda.synchronize()
        graphs = {n: GraphLoop(loop, n) for n in (1, iters)}
        dist.barrier(group=group.pg)
        if graphs[iters].run() != eager:
            raise AssertionError(f"rank {group.rank}: the captured loop's "
                                 "checksum differs from the eager loop's")

    def run(n):
        dist.barrier(group=group.pg)
        t0 = time.perf_counter()
        checksum = graphs[n].run() if on_card else loop.run(n)
        secs = time.perf_counter() - t0
        if checksum == 0:
            raise AssertionError("zero checksum")
        return secs

    bound = (PEAK_BYTES_PER_S / 2) * group.size  # 2 B per column
    rate = marginal_rate(run, rows * group.size * cols, 1, iters, 1, 3, bound,
                         log=lambda msg: log(f"rank {group.rank}/"
                                             f"{group.size}: {msg}"))
    counts = launches(graphs.values())
    log(f"rank {group.rank}/{group.size}: kernel launches: "
        f"{json.dumps(counts)}")
    return {"stats": stats.cpu().numpy(), "rate": rate, "launches": counts}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cols", type=int, default=1 << 20)
    ap.add_argument("--rows-per-dev", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--nproc", type=int, default=None,
                    help="the largest group size (default: the card count, "
                    "1 on the CPU)")
    args = ap.parse_args(argv)
    if args.cols % 4 or args.cols <= 0 or args.iters < 2:
        raise SystemExit("--cols must be a positive multiple of 4 and "
                         "--iters at least 2")
    device = torch_device()
    if device.type == "cuda":
        backend, cards = "nccl", torch.cuda.device_count()
        n_total = args.nproc or cards
        if n_total > cards:
            raise SystemExit(f"--nproc {n_total} needs {n_total} cards, have "
                             f"{cards}")
        log(f"card: {card_name_and_power()}")
        _build.lib()  # once here, not in every rank at the same time
    else:
        backend, n_total = "gloo", args.nproc or 1
    os.makedirs(BUILD, exist_ok=True)
    results = {}
    sizes = group_sizes(n_total)
    for n in sizes:
        per_rank = spawn(n, scaling_rank, args.cols, args.rows_per_dev,
                         args.iters, backend=backend, store_dir=BUILD)
        rate = per_rank[0]["rate"]
        results[n] = rate
        base = results[sizes[0]] * n / sizes[0]
        print(json.dumps({
            "devices": n,
            "gcols_per_s": round(rate / 1e9, 2),
            "scaling_efficiency": round(rate / base if base else 0.0, 3),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
