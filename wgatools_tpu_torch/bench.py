"""Benchmark: aligned columns/s through the port's CIGAR engine.

The counterpart of bench.py, with its metric, its two branches and its
one JSON line:

    python -m wgatools_tpu_torch.bench

On the card (core.device.torch_device(), the default): bench.py's TPU
branch.  B x L = 128 x 2^20 columns over ACGT- from seed 0, one category
plane (classify.pack_cat_nibbles), and an op table of L/32 runs of 32 over
M=XID a row, packed as raw group-8 sums (liftover.pack_ops_sums).  Each
iteration is one call of kernel C (ops.fused.classify_liftover_fused_adv16,
catmode, raw sums) plus the checksum (an int32 that wraps as JAX's does)
and its feedback into the next iteration's inputs, so that no iteration can
be skipped.  Before any timing, seven gates must hold bit for bit on the
card: kernel D on the byte planes, D's word entry, the sharded column stats
on a one-rank NCCL group, kernel A on the category plane, kernel C's stats
and its anchors expanded per op against the plain liftover scan, kernel B
at 9 rows x 128 ops, and the captured loop's checksum against the eager
loop's.  A batch of `iters` iterations is captured once in a CUDA graph and
timed as one replay plus the fetch of its checksum; capture failing raises
(there is no eager fallback).  The iteration counts are 128 and 1536: one
iteration takes ~35 us of kernel C plus the checksum ops, so the 1536
batch lasts well over 50 ms, far above the host clock's noise.

On the CPU (WGA_TORCH_DEVICE=cpu, for tests): bench.py's off-TPU branch.
B x L = 4 x 2^16, iteration counts 2 and 6, run eagerly; each iteration is
the entry step (entry.fused_step: kernel F's plain version on the byte
words) plus the checksum and its feedback.

The rate is the marginal rate between the two counts (min of 3 batches at
each, best of 5 windows), or the whole-batch lower bound B*L*hi / min(t_hi)
when the marginal is not positive or exceeds the roofline guard: on the
card, kernel C's bytes in this configuration over the card's memory rate
(roofline_columns_per_s), on the CPU 100 Gbp/s.  Stderr carries the card's
name and power limit, the gates, each window's estimates, the graph replay
times and, at the end, `kernel launches: {json}` (a replay of an
`iters`-iteration graph counts `iters` launches of kernel C).  Stdout carries
one JSON line: {"metric", "value", "unit", "vs_baseline"}, vs_baseline the
rate over REFERENCE_GBPS.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .core.device import PEAK_BYTES_PER_S, torch_device
from .entry import fused_step
from .kernels import _build
from .ops.classify import (
    classify_stat_bytes,
    classify_stat_bytes_ref,
    classify_stat_cat,
    classify_stat_words,
    pack_cat_nibbles,
)
from .ops.fused import classify_liftover_fused_adv16
from .ops.liftover import (
    adv16_odd_offsets,
    expand_group_prefix,
    interleave_halves,
    liftover_scan,
    liftover_scan_ref,
    pack_ops_adv16,
    pack_ops_sums,
    pack_ops_words16,
)

METRIC = "aligned_columns_gbp_per_s_per_chip"
REFERENCE_GBPS = 0.59  # the reference's p2c: 2.18 Gbp / 3.69 s (BASELINE.md)
CARD_SHAPE, CPU_SHAPE = (128, 1 << 20), (4, 1 << 16)
CARD_ITERS, CPU_ITERS = (128, 1536), (2, 6)
WINDOWS, REPEATS = 5, 3
CPU_BOUND = 100e9  # bench.py's off-TPU cap: the CPU shapes time noise
GROUP = 8  # ops per group sum
CHECK_STRIDE = 512  # the checksum reads every 512th offset column
BUILD = os.path.join(os.path.dirname(_build.BUILD_DIR), "bench")


def stage(msg):
    # one write a line: ranks and subprocesses share the stream
    sys.stderr.write(f"[bench] {msg}\n")
    sys.stderr.flush()


def host_inputs(B, L, seed=0):
    """bench.py's host arrays, from `seed` in its order of draws: uint8
    byte planes t, q [B, L] over ACGT-, int32 lengths [B] (all L), and an
    op table of L/32 ops over M=XID a row, each of length 32."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGT-", dtype=np.uint8)
    t = alphabet[rng.integers(0, 5, size=(B, L))]
    q = alphabet[rng.integers(0, 5, size=(B, L))]
    n_ops = max(L // 32, 1)
    ops = np.frombuffer(b"M=XID", dtype=np.uint8)[
        rng.integers(0, 5, size=(B, n_ops))]
    return {"t": t, "q": q, "lens": np.full(B, L, np.int32), "ops": ops,
            "op_lens": np.full((B, n_ops), 32, np.int32)}


def _up(device, **arrays):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


def card_state(x, device):
    """The card branch's loop inputs on `device`: the category plane cw,
    the lengths and the group-8 sums st, sq."""
    st, sq = pack_ops_sums(x["ops"], x["op_lens"], group=GROUP)
    return _up(device, cw=pack_cat_nibbles(x["t"], x["q"]), lens=x["lens"],
               st=st, sq=sq)


def cpu_state(x, device):
    """The off-TPU branch's loop inputs on `device`: the byte planes, the
    lengths and the packed16 op words."""
    return _up(device, t=x["t"], q=x["q"], lens=x["lens"],
               opw=pack_ops_words16(x["ops"], x["op_lens"]))


def checksum(stats, *offsets):
    """int32 sum of the stats and of every CHECK_STRIDE-th column of each
    offset table, wrapping as JAX's int32 sums do."""
    total = stats.sum(dtype=torch.int32)
    for o in offsets:
        total = total + o[:, ::CHECK_STRIDE].sum(dtype=torch.int32)
    return total


def card_step(s, acc):
    """One iteration of bench.py's TPU loop body (:210-225): kernel C, the
    checksum into acc, and its feedback (every nibble of cw[0, 0] stays a
    valid one-hot category; any group sum below 2^16 is valid)."""
    stats, ta, qa = classify_liftover_fused_adv16(
        s["cw"], None, s["lens"], s["st"], s["sq"], s["cw"].device,
        catmode=True, scan_mode="once", raw_sums=True,
    )
    acc += checksum(stats, ta, qa)
    s["cw"][0, 0] = 0x11111111 + (acc & 1)
    s["st"][0, 0] = 1 + (acc & 7)
    s["sq"][0, 0] = 1 + ((acc >> 3) & 7)


def cpu_step(s, acc):
    """One iteration of bench.py's off-TPU loop body (:178-198, :226-234):
    the entry step on the byte words, the checksum into acc, and its
    feedback (op pair 0 becomes one both-advancing op of a checksum-fed
    length)."""
    acc += checksum(*fused_step(s["t"], s["q"], s["lens"], s["opw"]))
    s["t"][0, 0] = (acc & 3) + 65
    s["opw"][0, 0] = (1 << 13) + 1 + (acc & 7)


class Loop:
    """Runs of a loop body over one state.  Each run starts from the
    state's first inputs and a zero checksum, as each of bench.py's
    batches does: the bodies' feedback writes only [0, 0] of the state's
    2-D tensors, which a run restores first."""

    def __init__(self, step, state):
        self.step, self.state = step, state
        device = next(iter(state.values())).device
        self.acc = torch.zeros((), dtype=torch.int32, device=device)
        self._first = {k: v[0, 0].clone() for k, v in state.items()
                       if v.dim() == 2}

    def body(self, iters):
        for k, v in self._first.items():
            self.state[k][0, 0] = v
        self.acc.zero_()
        for _ in range(iters):
            self.step(self.state, self.acc)

    def run(self, iters) -> int:
        """The checksum of `iters` iterations, run eagerly."""
        self.body(iters)
        return int(self.acc)


class GraphLoop:
    """A Loop's run of `iters` iterations, captured once in a CUDA graph
    and replayed: one dispatch per batch.  The capture records the
    kernels' launches without running them; per_replay holds the launches
    one replay runs."""

    def __init__(self, loop, iters):
        self.loop = loop
        torch.cuda.synchronize()
        before = dict(_build.LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            loop.body(iters)
        self.per_replay = {k: n - before[k] for k, n in _build.LAUNCHES.items()}
        self.replays = 0

    def run(self) -> int:
        """The checksum of one replay (fetching it waits for the card)."""
        self.graph.replay()
        self.replays += 1
        return int(self.loop.acc)


def launches(graphs):
    """The kernel launches this process ran: the wrappers' counts, less
    each graph's capture, plus each graph's replays."""
    out = dict(_build.LAUNCHES)
    for g in graphs:
        for k, n in g.per_replay.items():
            out[k] += (g.replays - 1) * n
    return out


def marginal_rate(run, cols_per_iter, lo, hi, windows, repeats, bound,
                  log=stage):
    """Columns/s of `run(iters)` (it returns the seconds of one batch): a
    warm batch at each count, then `windows` rounds of the min of
    `repeats` batches at lo and at hi; the best marginal rate
    cols_per_iter * (hi - lo) / (t_hi - t_lo) if it lies in (0, bound],
    else the lower bound cols_per_iter * hi / min(t_hi)."""
    run(lo)
    run(hi)
    marginal, t_his = 0.0, []
    for w in range(windows):
        t_lo = min(run(lo) for _ in range(repeats))
        t_hi = min(run(hi) for _ in range(repeats))
        t_his.append(t_hi)
        est = cols_per_iter * (hi - lo) / (t_hi - t_lo) if t_hi > t_lo else 0.0
        log(f"window {w}: {lo} iterations {t_lo:.6f} s, {hi} iterations "
            f"{t_hi:.6f} s, marginal {est / 1e9:.3f} Gbp/s, "
            f"{(t_hi - t_lo) / (hi - lo) * 1e6:.3f} us per iteration")
        marginal = max(marginal, est)
    lower = cols_per_iter * hi / min(t_his)
    log(f"best marginal {marginal / 1e9:.3f} Gbp/s, lower bound "
        f"{lower / 1e9:.3f} Gbp/s, guard {bound / 1e9:.3f} Gbp/s")
    return marginal if 0 < marginal <= bound else lower


def roofline_columns_per_s(B, L, n_groups):
    """Columns/s kernel C could reach in the card branch's configuration:
    B*L columns over its bytes (the category plane, 4 B per 8 columns;
    lengths; the [B, 8] stats; per direction the group sums read and the
    anchors written) at the card's memory rate."""
    nbytes = 4 * B * (L // 8) + 4 * B + 4 * 8 * B + 2 * 2 * 4 * B * n_groups
    return B * L * PEAK_BYTES_PER_S / nbytes


def card_name_and_power():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return smi.stdout.strip().splitlines()[0]


def _gate(label, got, want):
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"on-card {label} differs from the plain "
                                 "version")
    stage(f"on-card {label} parity gate: OK")


def run_gates(x, device, state):
    """bench.py's on-chip gates (:242-327), each bit for bit against the
    port's plain version on the card."""
    from .parallel.mesh import record_group, sharded_column_stats

    d = _up(device, t=x["t"], q=x["q"], lens=x["lens"], ops=x["ops"],
            op_lens=x["op_lens"])
    t, q, lens = d["t"], d["q"], d["lens"]
    want = classify_stat_bytes_ref(t, q, lens)
    _gate("classify_bytes==plain", [classify_stat_bytes(t, q, lens)], [want])
    _gate("classify_words==plain",
          [classify_stat_words(t.view(torch.int32), q.view(torch.int32),
                               lens)], [want])
    os.makedirs(BUILD, exist_ok=True)
    store = os.path.join(BUILD, f"nccl.{os.getpid()}.store")
    try:
        with record_group("nccl", store, 0, 1, device) as group:
            got = sharded_column_stats(group, t, q, lens)
            torch.cuda.synchronize()
    finally:
        if os.path.exists(store):
            os.remove(store)
    _gate("sharded_column_stats (one-rank NCCL group)==plain", [got], [want])
    _gate("classify_cat==plain", [classify_stat_cat(state["cw"], lens)],
          [want])
    stats, ta, qa = classify_liftover_fused_adv16(
        state["cw"], None, lens, state["st"], state["sq"], device,
        catmode=True, scan_mode="once", raw_sums=True,
    )
    # anchors -> per-pair even offsets -> odd offsets -> the full table
    n_ops = x["ops"].shape[1]
    wt, wq = pack_ops_adv16(x["ops"], x["op_lens"])
    full = []
    for anchors, w in ((ta, wt), (qa, wq)):
        even = expand_group_prefix(anchors.cpu().numpy(), w, group=GROUP)
        full.append(torch.from_numpy(
            interleave_halves(even, adv16_odd_offsets(even, w))[:, :n_ops]))
    want_t, want_q = (w.cpu() for w in liftover_scan_ref(d["ops"],
                                                         d["op_lens"]))
    _gate("fused_adv16 (cat, group-8 sums) stats+offsets==plain",
          [stats, *full], [want, want_t, want_q])
    # kernel B on a row count that is not a multiple of 8
    o9, l9 = d["ops"][:9, :128].contiguous(), d["op_lens"][:9, :128].contiguous()
    _gate("liftover_scan odd-row (B=9)==plain", liftover_scan(o9, l9),
          liftover_scan_ref(o9, l9))


def kernel_us(loop, reps=20):
    """Device time of one kernel C call on the loop's inputs, without the
    checksum ops."""
    s = loop.state

    def call():
        classify_liftover_fused_adv16(s["cw"], None, s["lens"], s["st"],
                                      s["sq"], s["cw"].device, catmode=True,
                                      scan_mode="once", raw_sums=True)

    call()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # the card spins while the host queues the calls, so the window holds
    # their device time and not the host's launch cost
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def main(argv=None):
    if argv:
        raise SystemExit(f"wgatools_tpu_torch.bench takes no arguments: {argv}")
    device = torch_device()
    on_card = device.type == "cuda"
    if on_card:  # the NCCL gate binds its group to one numbered card
        device = torch.device("cuda", torch.cuda.current_device())
    stage(f"device={device}")
    B, L = CARD_SHAPE if on_card else CPU_SHAPE
    x = host_inputs(B, L)
    if on_card:
        stage(f"card: {card_name_and_power()}")
        loop = Loop(card_step, card_state(x, device))
        run_gates(x, device, loop.state)
        stage(f"kernel C alone: {kernel_us(loop):.3f} us per call (CUDA "
              "events around 20 calls)")
        lo, hi = CARD_ITERS
        eager = loop.run(lo)
        t0 = time.perf_counter()
        graphs = {n: GraphLoop(loop, n) for n in (lo, hi)}
        stage(f"captured {lo} and {hi} iterations in "
              f"{time.perf_counter() - t0:.3f} s")
        _gate("CUDA graph==eager loop checksum",
              [torch.tensor(graphs[lo].run())], [torch.tensor(eager)])
        bound = roofline_columns_per_s(B, L, loop.state["st"].shape[1])

        def run(iters):
            t0 = time.perf_counter()
            if graphs[iters].run() == 0:
                raise AssertionError("zero checksum")
            secs = time.perf_counter() - t0
            stage(f"graph replay of {iters} iterations: {secs:.6f} s")
            return secs
    else:
        loop = Loop(cpu_step, cpu_state(x, device))
        lo, hi = CPU_ITERS
        bound = CPU_BOUND
        graphs = {}

        def run(iters):
            t0 = time.perf_counter()
            if loop.run(iters) == 0:
                raise AssertionError("zero checksum")
            return time.perf_counter() - t0

    stage("timing")
    rate = marginal_rate(run, B * L, lo, hi, WINDOWS, REPEATS, bound)
    stage(f"kernel launches: {json.dumps(launches(graphs.values()))}")
    gbps = rate / 1e9
    print(json.dumps({
        "metric": METRIC,
        "value": round(gbps, 3),
        "unit": "Gbp/s",
        "vs_baseline": round(gbps / REFERENCE_GBPS, 2),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
