#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (wgatools_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N] [--profile DIR]

Builds the port's CUDA kernels from wgatools_tpu_torch/csrc/ and then:

1. gates each kernel bit for bit against its plain PyTorch version on the
   card, at the shapes the main path gives it and at edge shapes, and
   times both;
2. runs `stat` and `stat -e` through the port's command line on a ~100 Mbp
   MAF made from the seed, and checks the bytes against the host engine;
3. runs `paf2chain` the same way on a 100 000-record PAF, and on a PAF
   of 8 records x 2^17 CIGAR ops (one batch of long rows: kernel B's
   tiled path);
4. runs the fused flagship kernel at bench.py's shape and checks its
   anchors, expanded per op on the host, against the plain full liftover
   scan of the same ops;
5. runs `maf2paf` and `maf2chain` on the stat MAF (two 64 Mi-column
   category-plane batches) against the host engine's bytes;
6. runs `call -s` on a ~40 Mbp MAF of four ~10 Mbp records whose widths
   are not multiples of 8, at the default chunk size (chunks grouped into
   one category-plane batch per record) and with `-c 16000000` (one [1, n]
   byte-plane batch per record), against the host engine's bytes;
7. `pafcov`, `stat -f paf` (with and without -e), `validate` (plain and
   with `-f FIXED`) and `chain2paf` through the port's command line: pafcov
   on the paf2chain PAF (8 targets of 3.1 Mbp, ~24.8 M BED lines), stat and
   validate on a copy of it with every 7th query end one too far and every
   11th target end one short, chain2paf on the chain phase 3 wrote; the
   bytes (compared by size and SHA-256) against the host engine's;
8. `fused_ops`: kernel 8 (classify_liftover_fused, which no tool calls)
   through its public op at bench.py's shape in both op forms, against the
   plain word stats and the plain full liftover scan;
9. `sharded`: on a one-rank NCCL group (FileStore under build/), runs the
   dryrun of the sharded layer, then every sharded function at full size
   against the plain versions: column stats on byte-word and nibble
   planes, kernel F and every mode of kernel C at bench.py's B=128 x 2^20
   columns with 2^15 ops per row, the liftover scan, the pair merge,
   coverage of a 2^28-position genome from 10^6 spans (all_reduce, and
   reduce_scatter + carry) and the sequence-parallel scan of 8 rows x 2^22
   ops.  One rank shows that the collectives run on NCCL and that the
   shards' carries and merges are right when there is one shard; the
   multi-rank semantics are held on the CPU with gloo (tests);
10. `distributed`: the distributed modes (WGA_TPU_DIST) as users launch
   them, N = min(cards, 4) processes of `python -m wgatools_tpu_torch`,
   one card each, merging over NCCL (also at N = 1: a group of one rank
   runs the same collectives): `stat` and `call -s` on the stat and call
   MAFs without and with a maf-index manifest, `maf2paf`, `maf2chain`,
   `stat -f paf`, `paf2chain`, `chain2paf`, `pafcov`, `validate -f`,
   `filter -f paf -a` and `dotplot -m overview` on the earlier phases'
   files (with N > 1, `maf2paf` and `maf2chain` again with every record
   column-split over the ranks).  Every rank must exit 0 and log its NCCL
   init, only rank 0 may create a file, none may write to stdout, and rank
   0's files must equal the host engine's bytes.  Each rank logs its
   kernel launches at -v; `call -s` runs kernel A on the ranks' cards, as
   the serial `call` does, and its ranks must have launched it;
11. `entry`: the fused entry step (wgatools_tpu_torch.entry, one launch of
   kernel F) against its plain version on a CPU copy;
12. `bench`: `python -m wgatools_tpu_torch.bench` (the headline metric:
   kernel C in a CUDA-graph loop behind seven gates) must print one JSON
   line with bench.py's metric and a value within the card's roofline
   guard; the launches it logs count here;
13. `p2c headline`: `paf2chain` on the p2c headline's ~2.18 Gbp PAF
   (wgatools_tpu_torch.scripts.p2c_headline.build) against the host
   engine's bytes;
14. `scaling`: `python -m wgatools_tpu_torch.scripts.scaling_bench
   --nproc N` at its defaults, N = min(cards, 4): one JSON line a group
   size, every rank on NCCL; the launches its ranks log count here;
15. `fuzz`: `python -m wgatools_tpu_torch.scripts.fuzz_campaign` at a
   fixed seed and case count: its seven properties must pass, the kernel
   properties through all eight kernels on the card, each held against its
   plain version and the oracle on every case;
16. `scale configs`: `python -m wgatools_tpu_torch.scripts.scale_configs`
   at its defaults (BASELINE configs 3-4: maf-index, call -s -l0, maf-ext,
   chunk on a ~102 Mbp MAF; pafcov and pafpseudo on a 60 000-record PAF;
   serial on the card, -t 4 and WGA_TPU_DIST over min(cards, 2) NCCL
   ranks): every md5 cross-check must hold and the serial pafcov must
   launch kernel B.

Launch counts are reset before each tool phase and read after it: every
kernel of that phase's path must have launched there.  With --profile,
`stat`, `paf2chain`, `maf2paf`, both `call` runs, `pafcov` and `validate`
then run once more
under torch.profiler and cProfile, with a summary printed and the tables
written to DIR/profile.txt.  The reference for the tool bytes is the
port's own host engine (each tool with device=None), which shares the
output formatting code with the device route: the byte comparison checks
the per-record counters, run tables, coverage and the chain-line
arithmetic.  The CPU tests hold that host engine byte for byte against
the TPU package's, so the chain of trust runs from the TPU package
through the port's host engine to the port's device route on the card.
The script imports nothing of the TPU package and no jax.

The last three lines are a JSON object listing each kernel (launches on
the tool phases, max error, times, and the least time the card could take
for the timed call's bytes and operations), the card's name and power
limit, and the JSON result line.  Any failed check raises, so the exit code is not 0;
without CUDA the script exits 2 and prints no result.  Needs one card;
work files go to build/chip_smoke/ and are removed at the end.
"""

import argparse
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# main-path shapes: bench.py's column batch (B rows x L columns, L/32 ops per
# row for the fused kernel), a paf2chain batch of ~2^20 op slots, the
# stat MAF (~102 Mbp) and the paf2chain PAF (~4M ops, 4 device batches);
# kernel D's call-route row and a 64 Mi-column batch of odd width; the
# call MAF (~40 Mbp)
BENCH_B, BENCH_L = 128, 1 << 20
SCAN_ROWS, SCAN_N = 8192, 128
# kernel B's long rows (few records of 10^5-10^6 CIGAR ops, as whole
# assemblies aligned to each other give), and 2^20-slot batches on both
# sides of its long-row threshold (4096 ops)
LONG_SCANS = ((4, 1 << 18), (1, 1 << 20))
THRESHOLD_SCANS = ((512, 2048), (256, 4095), (256, 4096), (64, 16_384))
# the long-record paf2chain phase: records x CIGAR ops each
LONG_PAF_RECORDS, LONG_PAF_RUNS = 8, 1 << 17
MAF_RECORDS, MAF_COLUMNS = 512, 200_000
PAF_RECORDS, PAF_RUNS = 100_000, 40
CALL_ROW = 12_500_003
BYTES_B, BYTES_L = 512, 131_073
CALL_RECORDS, CALL_COLUMNS = 4, 10_000_003
# the sharded phase: ops per row of the full-size op table, the coverage
# genome and spans, the sequence-parallel scan's rows and ops
SHARD_OPS = 1 << 15
GENOME_LEN, N_SPANS = 1 << 28, 1_000_000
SP_ROWS, SP_OPS = 8, 1 << 22
# the distributed phase: ranks (one card each), modes run at once, the
# giant-record split (bytes of MAF text) of its second maf2paf and
# maf2chain runs, and how long one mode's ranks may take
MAX_RANKS = 4
DIST_JOBS = 4
DIST_GIANT_SPLIT = 262_144
DIST_TIMEOUT_S = 300
# how long the bench or the scaling bench may take as a process
PROGRAM_TIMEOUT_S = 300
# the fuzz campaign's seed and cases a property, and how long the scale
# configs program (BASELINE configs 3-4 at their full size) may take
FUZZ_SEED, FUZZ_ITERS = 0, 1000
SCALE_TIMEOUT_S = 900
# the kernel launches a phase's other processes logged (the distributed
# ranks, the bench, the scaling bench's ranks)
RANK_LAUNCHES = {}
# kernel C's modes besides bench.py's (catmode, raw sums): label, flags
ADV16_MODES = (
    ("pairs+odd", dict()),
    ("pairs", dict(emit_odd=False)),
    ("raw", dict(raw_sums=True)),
)


# kernel -> (bytes its timed call must move, operations it must do)
WORK = {}


def log(msg):
    print(msg, flush=True)


def record_work(name, nbytes, ops):
    """The timed call of kernel `name` reads and writes nbytes at the least
    (each input byte it needs once, each output byte once) and does ops
    operations (one per column classified, one per op advance summed)."""
    WORK[name] = (int(nbytes), int(ops))


def bound(name):
    """(bound_ms, bound_by) of kernel `name`'s timed call: the larger of its
    bytes over the memory rate and its operations over the peak rate."""
    from wgatools_tpu_torch.core.device import PEAK_BYTES_PER_S, PEAK_OPS_PER_S

    nbytes, ops = WORK[name]
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def valid_columns(lengths, width):
    """Each row's columns a kernel must read: its length clamped to
    [0, width]."""
    return np.clip(np.asarray(lengths, np.int64), 0, width)


def time_ms(fn, reps=20, rounds=5):
    """Device time of one fn() call in ms: the median over `rounds` of CUDA
    event windows around `reps` back-to-back calls, divided by `reps`.
    The card spins (torch.cuda._sleep) while the host queues the calls, so
    a window holds the calls' device time and not the host's launch cost."""
    import torch

    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)  # ~50 ms at H100 clocks
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


class Gates:
    """Bit-for-bit comparisons of kernels with their plain versions."""

    def __init__(self):
        self.max_err = {}

    def check(self, name, label, got, want):
        import torch

        err = 0
        for g, w in zip(got, want):
            if g.shape != w.shape:
                raise AssertionError(
                    f"{name} [{label}]: shape {tuple(g.shape)} != {tuple(w.shape)}"
                )
            if g.numel():
                diff = (g.to(torch.int64) - w.to(torch.int64)).abs().max()
                err = max(err, int(diff))
        self.max_err[name] = max(self.max_err.get(name, 0), err)
        if err:
            raise AssertionError(f"{name} [{label}]: max |kernel - plain| = {err}")
        log(f"gate {name} [{label}]: ok")


def random_pairs(rng, lengths, all_gap_rows=()):
    alphabet = np.frombuffer(b"ACGTNacgtn-RY", dtype=np.uint8)
    pairs = []
    for k, n in enumerate(lengths):
        if k in all_gap_rows:
            pairs.append((b"-" * n, b"-" * n))
            continue
        t = alphabet[rng.integers(0, len(alphabet), n)]
        q = t.copy()
        flip = rng.random(n) < 0.3
        q[flip] = alphabet[rng.integers(0, len(alphabet), int(flip.sum()))]
        pairs.append((t.tobytes(), q.tobytes()))
    return pairs


def phase_kernels(rng, device, gates, times):
    """Phase 1: kernel gates at main-path and edge shapes, with times."""
    import torch

    from wgatools_tpu_torch.ops.classify import (
        classify_stat_cat,
        classify_stat_cat_ref,
        pack_cat_nibbles,
        pack_pairs,
    )
    from wgatools_tpu_torch.ops.fused import (
        classify_liftover_fused_adv16,
        classify_liftover_fused_adv16_ref,
    )
    from wgatools_tpu_torch.ops.liftover import (
        chain_scan,
        liftover_scan,
        liftover_scan_ref,
        pack_ops_sums,
    )

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def bench_c(cw, lens, st, sq, caller=False):  # bench.py's kernel C
        return classify_liftover_fused_adv16(cw, None, lens, st, sq, device,
                                             caller, catmode=True,
                                             raw_sums=True)

    def bench_c_ref(cw, lens, st, sq, caller=False):
        return classify_liftover_fused_adv16_ref(cw, None, lens, st, sq,
                                                 caller, catmode=True,
                                                 raw_sums=True)

    # kernel A at bench.py's batch
    B, L = BENCH_B, BENCH_L
    alphabet = np.frombuffer(b"ACGT-", dtype=np.uint8)
    t0 = alphabet[rng.integers(0, 5, size=(B, L))]
    q0 = alphabet[rng.integers(0, 5, size=(B, L))]
    cw_np = pack_cat_nibbles(t0, q0)
    lens_np = (L - rng.integers(0, 4096, B)).astype(np.int32)
    lens_np[0] = L
    cw, lens = up(cw_np), up(lens_np)
    for caller in (False, True):
        gates.check(
            "classify_cat", f"B={B} L={L} caller={caller}",
            [classify_stat_cat(cw, lens, caller)],
            [classify_stat_cat_ref(cw, lens, caller)],
        )
    times["classify_cat"] = (
        time_ms(lambda: classify_stat_cat(cw, lens)),
        time_ms(lambda: classify_stat_cat_ref(cw, lens), reps=5),
    )
    cols = valid_columns(lens_np, L)
    cat_bytes = 4 * int(((cols + 7) // 8).sum()) + 4 * B + 4 * 8 * B
    record_work("classify_cat", cat_bytes, cols.sum())
    zero_ms = time_ms(lambda: torch.zeros((B, 8), dtype=torch.int32,
                                          device=device))
    log(f"classify_cat B={B} L={L}: kernel {times['classify_cat'][0]:.5f} ms "
        f"(its [B, 8] output's torch.zeros alone {zero_ms:.5f} ms), caller "
        f"mode {time_ms(lambda: classify_stat_cat(cw, lens, True)):.5f} ms")

    # kernel A edge shapes: odd B, B=1, L not a multiple of 1024, rows of
    # length 0, an all gap/gap row, IUPAC and lowercase bytes
    edge_planes = []
    for lengths, gg_rows in (
        ([0, 1, 7, 8, 9, 777, 999, 1000, 1000], (8,)),
        ([17], ()),
        ([40_000, 0, 16_385, 16_384, 3], (3,)),
    ):
        t, q, ln = pack_pairs(random_pairs(rng, lengths, gg_rows), align=8)
        edge_planes.append((up(pack_cat_nibbles(t, q)), up(ln)))
        for caller in (False, True):
            gates.check(
                "classify_cat", f"edge B={len(lengths)} L={t.shape[1]} "
                f"caller={caller}",
                [classify_stat_cat(*edge_planes[-1], caller)],
                [classify_stat_cat_ref(*edge_planes[-1], caller)],
            )

    # kernel B at a paf2chain batch: records x 128 op slots
    R, N = SCAN_ROWS, SCAN_N
    op_chars = np.frombuffer(b"M=XIDSNH", dtype=np.uint8)
    ops_np = op_chars[rng.integers(0, 8, size=(R, N))]
    ops_np[np.arange(N)[None, :] >= rng.integers(1, N + 1, R)[:, None]] = 0
    olens_np = rng.integers(0, 2000, size=(R, N)).astype(np.int32)
    olens_np[ops_np == 0] = 0
    ops, olens = up(ops_np), up(olens_np)
    for name, fn in (("liftover", liftover_scan), ("chain", chain_scan)):
        gates.check(
            "liftover_scan", f"{R}x{N} mode={name}",
            fn(ops, olens), liftover_scan_ref(ops, olens, name),
        )
    times["liftover_scan"] = (
        time_ms(lambda: chain_scan(ops, olens)),
        time_ms(lambda: liftover_scan_ref(ops, olens, "chain")),
    )
    record_work("liftover_scan", R * N * (1 + 4 + 8), 2 * R * N)
    log_scan_times(f"{R}x{N}", ops, olens, times["liftover_scan"])
    # kernel B's long rows, both modes, timed against the same 13 B/op
    for rows, n in LONG_SCANS + THRESHOLD_SCANS:
        l_ops = op_chars[rng.integers(0, 8, size=(rows, n))]
        l_lens = rng.integers(0, 2000, size=(rows, n)).astype(np.int32)
        lo, ll = up(l_ops), up(l_lens)
        if (rows, n) in LONG_SCANS:
            for name, fn in (("liftover", liftover_scan), ("chain", chain_scan)):
                gates.check("liftover_scan", f"{rows}x{n} mode={name}",
                            fn(lo, ll), liftover_scan_ref(lo, ll, name))
        log_scan_times(f"{rows}x{n}", lo, ll, (
            time_ms(lambda: chain_scan(lo, ll)),
            time_ms(lambda: liftover_scan_ref(lo, ll, "chain"), reps=5)))
        del lo, ll
    # kernel B edge shapes: B=9 with N not a step multiple and lengths
    # past 2^16, B=1, an all-padding row; rows at and just past the
    # long-row threshold (4096 ops), N not a multiple of 4 or 16, lengths
    # whose row sums wrap int32
    for rows, n, max_len in ((9, 1000, 200_000), (1, 3, 200_000),
                             (3, 129, 200_000), (1, 4096, 200_000),
                             (3, 4097, 200_000), (2, 4099, 1 << 20),
                             (5, 4110, 1 << 20), (1, 6145, 1 << 20),
                             (4, 8205, 1 << 30), (3, 4095, 1 << 30)):
        e_ops = op_chars[rng.integers(0, 8, size=(rows, n))]
        e_ops[-1, :] = 0
        e_lens = rng.integers(0, max_len, size=(rows, n)).astype(np.int32)
        for name, fn in (("liftover", liftover_scan), ("chain", chain_scan)):
            gates.check(
                "liftover_scan", f"edge {rows}x{n} mode={name}",
                fn(up(e_ops), up(e_lens)),
                liftover_scan_ref(up(e_ops), up(e_lens), name),
            )
        # bases off alignment: lens 4 B past, ops 0-3 B past (rows whose
        # pointers cannot all be aligned go op by op)
        for o_off, l_off in ((0, 4), (1, 0), (3, 8)):
            s_ops, s_lens = shifted(up(e_ops), o_off), shifted(up(e_lens), l_off)
            gates.check(
                "liftover_scan", f"edge {rows}x{n} ops+{o_off} lens+{l_off}",
                liftover_scan(s_ops, s_lens), liftover_scan_ref(s_ops, s_lens),
            )

    # kernel C at bench.py's shape: the same plane, N_OPS = L/32 ops per row
    n_ops = L // 32
    bench_ops = np.frombuffer(b"M=XID", dtype=np.uint8)[
        rng.integers(0, 5, size=(B, n_ops))
    ]
    bench_lens = np.full((B, n_ops), 32, np.int32)
    st, sq = (up(a) for a in pack_ops_sums(bench_ops, bench_lens, group=8))
    for caller in (False, True):
        gates.check(
            "fused_adv16", f"B={B} L={L} NG={st.shape[1]} caller={caller}",
            bench_c(cw, lens, st, sq, caller),
            bench_c_ref(cw, lens, st, sq, caller),
        )
    times["fused_adv16"] = (
        time_ms(lambda: bench_c(cw, lens, st, sq)),
        time_ms(lambda: bench_c_ref(cw, lens, st, sq),
                reps=5),
    )
    n_groups = st.numel()  # per direction: read once, one anchor written
    record_work("fused_adv16", cat_bytes + 2 * 2 * 4 * n_groups,
                cols.sum() + 2 * n_groups)
    # kernel C edge shapes: B2 != B both ways, B=1
    for (e_cw, e_len), b2, ng in zip(edge_planes, (5, 13, 5), (3, 700, 1)):
        e_st = up(rng.integers(0, 1 << 16, size=(b2, ng)).astype(np.int32))
        e_sq = up(rng.integers(0, 1 << 16, size=(b2, ng)).astype(np.int32))
        gates.check(
            "fused_adv16", f"edge B={e_cw.shape[0]} B2={b2} NG={ng}",
            bench_c(e_cw, e_len, e_st, e_sq),
            bench_c_ref(e_cw, e_len, e_st, e_sq),
        )

    # random shapes: arbitrary nibbles (codes the LUT never makes), lengths
    # below 0 and past the row, arbitrary op bytes
    for k in range(8):
        b, lw = int(rng.integers(1, 300)), int(rng.integers(1, 5000))
        f_cw = up(rng.integers(0, 1 << 32, (b, lw), dtype=np.uint64)
                  .astype(np.uint32).view(np.int32))
        f_len = up(rng.integers(-8, 8 * lw + 16, b).astype(np.int32))
        b2, ng = int(rng.integers(1, 300)), int(rng.integers(1, 3000))
        f_st = up(rng.integers(0, 1 << 16, (b2, ng)).astype(np.int32))
        f_sq = up(rng.integers(0, 1 << 16, (b2, ng)).astype(np.int32))
        for caller in (False, True):
            label = f"random {k} B={b} LW={lw} caller={caller}"
            gates.check("classify_cat", label,
                        [classify_stat_cat(f_cw, f_len, caller)],
                        [classify_stat_cat_ref(f_cw, f_len, caller)])
            gates.check(
                "fused_adv16", f"{label} B2={b2} NG={ng}",
                bench_c(f_cw, f_len, f_st, f_sq, caller),
                bench_c_ref(f_cw, f_len, f_st, f_sq, caller),
            )
        rows = int(rng.integers(1, 64))
        n = int(rng.integers(1, 3000) if k % 2 else rng.integers(4096, 20_000))
        f_ops = up(rng.integers(0, 256, (rows, n)).astype(np.uint8))
        f_lens = up(rng.integers(0, 1 << 19, (rows, n)).astype(np.int32))
        for name, fn in (("liftover", liftover_scan), ("chain", chain_scan)):
            gates.check("liftover_scan", f"random {k} {rows}x{n} mode={name}",
                        fn(f_ops, f_lens), liftover_scan_ref(f_ops, f_lens, name))
    gate_classify_bytes(rng, device, gates, times)
    full = gate_plane_kernels(rng, device, gates, times, t0, q0, cw_np,
                              lens_np)
    gate_fused_ops(rng, device, gates, times, full)
    log(f"classify_bytes [1, {CALL_ROW}] caller: kernel "
        f"{times['classify_bytes'][0]:.5f} ms; its word entry "
        f"(classify_words) at B={BENCH_B} L={BENCH_L}: kernel "
        f"{times['classify_words'][0]:.5f} ms")
    return {"cw": cw, "lens": lens, "ops": bench_ops, "op_lens": bench_lens,
            "full": full}


def shifted(a, offset):
    """A contiguous copy of tensor `a` whose data starts `offset` bytes past
    an allocation's (aligned) start (a multiple of its element size)."""
    import torch

    nbytes = a.numel() * a.element_size()
    buf = torch.empty(nbytes + offset, dtype=torch.uint8, device=a.device)
    out = buf[offset:].view(a.dtype).view(a.shape)
    out.copy_(a)
    return out


def log_scan_times(shape, ops, lens, ms):
    """Kernel B's line at one shape: its chain-mode time and the plain
    version's (ms), the 13 B/op bound, and torch.cumsum of one pre-decoded
    int32 advance table of the same shape: a yardstick of half the
    function (one of its two scans, without the op decode), not a library
    call that computes it."""
    import torch

    from wgatools_tpu_torch.core.device import PEAK_BYTES_PER_S

    adv = torch.where(ops == ord("I"), lens, torch.zeros_like(lens))
    cumsum_ms = time_ms(lambda: torch.cumsum(adv, dim=1, dtype=torch.int32))
    bound_ms = ops.numel() * (1 + 4 + 8) / PEAK_BYTES_PER_S * 1e3
    log(f"liftover_scan {shape} chain: kernel {ms[0]:.5f} ms, plain "
        f"{ms[1]:.5f} ms, bound {bound_ms:.5f} ms; torch.cumsum of one "
        f"pre-decoded int32 advance table (half the function) "
        f"{cumsum_ms:.5f} ms")


def gate_classify_bytes(rng, device, gates, times):
    """Kernel D at the call route's [1, n] row, at a 64 Mi-column batch of
    odd width (both made on the card from the seed) and at edge and random
    shapes, in both modes."""
    import torch

    from wgatools_tpu_torch.ops.classify import (
        classify_stat_bytes,
        classify_stat_bytes_ref,
    )

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 2**31)))
    alphabet = torch.tensor(list(b"ACGTN-"), dtype=torch.uint8, device=device)

    def planes_on_card(B, L):
        t = alphabet[torch.randint(0, 6, (B, L), generator=gen, device=device)]
        other = alphabet[torch.randint(0, 6, (B, L), generator=gen, device=device)]
        keep = torch.rand((B, L), generator=gen, device=device) < 0.7
        return t, torch.where(keep, t, other)

    t, q = planes_on_card(1, CALL_ROW)
    n = up(np.array([CALL_ROW], np.int32))
    for caller in (False, True):
        gates.check("classify_bytes", f"[1, {CALL_ROW}] caller={caller}",
                    [classify_stat_bytes(t, q, n, caller)],
                    [classify_stat_bytes_ref(t, q, n, caller)])
    # the call route runs caller mode
    times["classify_bytes"] = (
        time_ms(lambda: classify_stat_bytes(t, q, n, True)),
        time_ms(lambda: classify_stat_bytes_ref(t, q, n, True), reps=5),
    )
    record_work("classify_bytes", 2 * CALL_ROW + 4 + 4 * 8, CALL_ROW)
    log(f"classify_bytes [1, {CALL_ROW}] caller: kernel "
        f"{times['classify_bytes'][0]:.5f} ms, plain "
        f"{times['classify_bytes'][1]:.5f} ms")
    del t, q

    B, L = BYTES_B, BYTES_L
    t, q = planes_on_card(B, L)
    lens_np = (L - rng.integers(0, 4096, B)).astype(np.int32)
    lens_np[0], lens_np[1] = L, 0
    n = up(lens_np)
    for caller in (False, True):
        gates.check("classify_bytes", f"B={B} L={L} caller={caller}",
                    [classify_stat_bytes(t, q, n, caller)],
                    [classify_stat_bytes_ref(t, q, n, caller)])
    batch_ms = (time_ms(lambda: classify_stat_bytes(t, q, n)),
                time_ms(lambda: classify_stat_bytes_ref(t, q, n), reps=5))
    log(f"classify_bytes B={B} L={L} ext: kernel {batch_ms[0]:.5f} ms, "
        f"plain {batch_ms[1]:.5f} ms")
    del t, q

    # edge shapes: L % 4 in {1, 2, 3, 0}, lengths 0 and ending mid-word,
    # all-gap rows, padding bytes that are not '-', rows past 16K columns,
    # base addresses 0-3 bytes past alignment
    padding = np.frombuffer(b"ACGTNacgtn", np.uint8)
    for L in (1001, 1002, 1003, 1004, 16_387, 40_001):
        lengths = [0, 1, 2, 3, 5, 13, L, L - 1, min(L, 999), L // 2]
        pairs = random_pairs(rng, lengths, all_gap_rows=(4, 9))
        t_np = padding[rng.integers(0, len(padding), (len(lengths), L))]
        q_np = padding[rng.integers(0, len(padding), (len(lengths), L))]
        for k, (tb, qb) in enumerate(pairs):
            t_np[k, :len(tb)] = np.frombuffer(tb, np.uint8)
            q_np[k, :len(qb)] = np.frombuffer(qb, np.uint8)
        n = up(np.array(lengths, np.int32))
        for offset in range(4):
            t, q = shifted(up(t_np), offset), shifted(up(q_np), offset)
            for caller in (False, True):
                gates.check(
                    "classify_bytes",
                    f"edge B={len(lengths)} L={L} offset={offset} caller={caller}",
                    [classify_stat_bytes(t, q, n, caller)],
                    [classify_stat_bytes_ref(t, q, n, caller)],
                )
    # t and q at different offsets (0-15 bytes apart): every column of such
    # rows goes through load8 one lane each
    for L in (1001, 4099, 16_387, 40_001):
        lengths = [0, 1, 17, L, L - 1, L // 2, min(L, 1025), 2049 % L]
        pairs = random_pairs(rng, lengths, all_gap_rows=(3,))
        t_np = padding[rng.integers(0, len(padding), (len(lengths), L))]
        q_np = padding[rng.integers(0, len(padding), (len(lengths), L))]
        for k, (tb, qb) in enumerate(pairs):
            t_np[k, :len(tb)] = np.frombuffer(tb, np.uint8)
            q_np[k, :len(qb)] = np.frombuffer(qb, np.uint8)
        n = up(np.array(lengths, np.int32))
        for t_off, q_off in ((0, 1), (0, 15), (3, 10), (7, 0), (15, 2),
                             (9, 9), (16, 0)):
            t, q = shifted(up(t_np), t_off), shifted(up(q_np), q_off)
            for caller in (False, True):
                gates.check(
                    "classify_bytes",
                    f"edge B={len(lengths)} L={L} t+{t_off} q+{q_off} "
                    f"caller={caller}",
                    [classify_stat_bytes(t, q, n, caller)],
                    [classify_stat_bytes_ref(t, q, n, caller)],
                )
    # random shapes: arbitrary bytes ('-' frequent), lengths below 0 and
    # past the row, any base offsets of t and q
    for k in range(8):
        b, L = int(rng.integers(1, 300)), int(rng.integers(1, 5000))
        raw = rng.integers(0, 256, (2, b, L)).astype(np.uint8)
        raw[rng.random((2, b, L)) < 0.3] = ord("-")
        same = rng.random((b, L)) < 0.4
        raw[1][same] = raw[0][same]
        offset = int(rng.integers(0, 16))
        q_offset = offset if k % 2 else int(rng.integers(0, 16))
        t, q = shifted(up(raw[0]), offset), shifted(up(raw[1]), q_offset)
        n = up(rng.integers(-8, L + 16, b).astype(np.int32))
        for caller in (False, True):
            gates.check("classify_bytes",
                        f"random {k} B={b} L={L} offsets={offset},{q_offset} "
                        f"caller={caller}",
                        [classify_stat_bytes(t, q, n, caller)],
                        [classify_stat_bytes_ref(t, q, n, caller)])


def plane_inputs(rng, t, q, cw, lens, op_rows, n_ops):
    """Host inputs of the word, nibble and fused kernels: byte-word,
    nibble and category planes of the same uint8 columns t, q, and an
    [op_rows, n_ops] op table (M/=/X/I/D/S, lengths < 2^13, 8191 in column
    0) with its packed16 words, adv16 pair words and group-8 sums."""
    from wgatools_tpu_torch.ops.classify import pack_nibble_words
    from wgatools_tpu_torch.ops.liftover import (
        pack_ops_adv16,
        pack_ops_sums,
        pack_ops_words16,
    )

    ops = np.frombuffer(b"M=XIDS", np.uint8)[rng.integers(0, 6, (op_rows, n_ops))]
    op_lens = rng.integers(0, 8192, (op_rows, n_ops)).astype(np.int32)
    op_lens[:, 0] = 8191
    host = {"tw": t.view("<i4"), "qw": q.view("<i4"), "cw": cw, "lens": lens,
            "ops": ops, "op_lens": op_lens,
            "opw16": pack_ops_words16(ops, op_lens)}
    host["tn"], host["qn"] = pack_nibble_words(t, q)
    host["wt"], host["wq"] = pack_ops_adv16(ops, op_lens)
    host["st"], host["sq"] = pack_ops_sums(ops, op_lens, group=8)
    return host


def gate_plane_kernels(rng, device, gates, times, t0, q0, cw_np, lens_np):
    """The word entry of kernel D, kernel E, kernel F and every mode of
    kernel C at bench.py's batch (byte-word planes 2 x 128 MiB, nibble
    planes 2 x 64 MiB, 2^15 ops per row) and at edge and random shapes, in
    both modes, with times.  Returns the full-size host inputs."""
    import torch

    from wgatools_tpu_torch.ops import classify as C
    from wgatools_tpu_torch.ops import fused as F

    def up(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a)).to(device)

    host = plane_inputs(rng, t0, q0, cw_np, lens_np, t0.shape[0], SHARD_OPS)
    d = {k: up(v) for k, v in host.items()}
    B, L = t0.shape
    planes = {"words": (d["tw"], d["qw"]), "nibble": (d["tn"], d["qn"]),
              "cat": (d["cw"], None)}
    stats_fn = {"words": (C.classify_stat_words, C.classify_stat_words_ref),
                "nibble": (C.classify_stat_nibbles, C.classify_stat_nibbles_ref)}
    kernel = {"words": "classify_words", "nibble": "classify_nibbles"}

    def gate_all(label, planes, lens, opw, wt, wq, st, sq):
        """Both modes of the word entry, E, F and every mode of C on the
        plane kinds given."""
        for caller in (False, True):
            tag = f"{label} caller={caller}"
            for kind, (fn, ref) in stats_fn.items():
                if kind not in planes:
                    continue
                gates.check(kernel[kind], tag, [fn(*planes[kind], lens, caller)],
                            [ref(*planes[kind], lens, caller)])
                nib = kind == "nibble"
                gates.check(
                    "fused16", f"{kind} {tag}",
                    F.classify_liftover_fused16(*planes[kind], lens, opw, device,
                                                caller, nibble=nib),
                    F.classify_liftover_fused16_ref(*planes[kind], lens, opw,
                                                    caller, nib),
                )
            for kind, pl in planes.items():
                for mode, flags in ADV16_MODES:
                    words = (st, sq) if flags.get("raw_sums") else (wt, wq)
                    flags = dict(flags, nibble=kind == "nibble",
                                 catmode=kind == "cat")
                    gates.check(
                        "fused_adv16", f"{kind} {mode} {tag}",
                        F.classify_liftover_fused_adv16(
                            *pl, lens, *words, device, caller, **flags),
                        F.classify_liftover_fused_adv16_ref(
                            *pl, lens, *words, caller, **flags),
                    )

    gate_all(f"B={B} L={L} ops={SHARD_OPS}", planes, d["lens"], d["opw16"],
             d["wt"], d["wq"], d["st"], d["sq"])
    for kind, (fn, ref) in stats_fn.items():
        times[kernel[kind]] = (
            time_ms(lambda: fn(*planes[kind], d["lens"])),
            time_ms(lambda: ref(*planes[kind], d["lens"]), reps=5),
        )
    times["fused16"] = (
        time_ms(lambda: F.classify_liftover_fused16(
            *planes["nibble"], d["lens"], d["opw16"], device, nibble=True)),
        time_ms(lambda: F.classify_liftover_fused16_ref(
            *planes["nibble"], d["lens"], d["opw16"], nibble=True), reps=5),
    )
    cols = valid_columns(lens_np, L)
    stats_bytes = 4 * B + 4 * 8 * B
    nibble_bytes = 2 * 4 * int(((cols + 7) // 8).sum()) + stats_bytes
    record_work("classify_words", 2 * cols.sum() + stats_bytes, cols.sum())
    record_work("classify_nibbles", nibble_bytes, cols.sum())
    n_words = d["opw16"].numel()  # two ops each; four offset planes out
    record_work("fused16", nibble_bytes + 4 * n_words + 4 * 4 * n_words,
                cols.sum() + 4 * n_words)
    ms = time_ms(lambda: F.classify_liftover_fused16(
        *planes["words"], d["lens"], d["opw16"], device))
    log(f"fused16 words B={B} L={L}: kernel {ms:.5f} ms")
    # F's two parts alone: its columns (no op rows) and its op rows (rows
    # of no columns)
    no_ops = d["opw16"][:0]
    no_cols = torch.zeros(B, dtype=torch.int32, device=device)
    one = d["tn"][:, :1].contiguous()
    for label, args in (("columns alone (B2=0)", (*planes["nibble"],
                                                  d["lens"], no_ops)),
                        ("op rows alone (no columns)", (one, one, no_cols,
                                                        d["opw16"]))):
        ms = time_ms(lambda: F.classify_liftover_fused16(*args, device,
                                                         nibble=True))
        log(f"fused16 nibbles B={B} L={L}, {label}: kernel {ms:.5f} ms")
    for kind, pl in planes.items():
        for mode, flags in ADV16_MODES:
            words = (d["st"], d["sq"]) if flags.get("raw_sums") else (d["wt"], d["wq"])
            flags = dict(flags, nibble=kind == "nibble", catmode=kind == "cat")
            ms = time_ms(lambda: F.classify_liftover_fused_adv16(
                *pl, d["lens"], *words, device, **flags))
            log(f"fused_adv16 {kind} {mode} B={B} L={L}: kernel {ms:.5f} ms")
    for name, (ms, plain) in list(times.items()):
        if name in ("classify_words", "classify_nibbles", "fused16"):
            log(f"{name} B={B} L={L}: kernel {ms:.5f} ms, plain {plain:.5f} ms")
    del planes, d

    # edge shapes: lengths 0 and ending mid-word, B=1, odd B, rows past 16K
    # columns, all-gap rows; B2 below and above B, odd op counts
    nib_alphabet = np.frombuffer(b"ACGTNacgtn.-", np.uint8)
    for lengths, n_ops in (([0, 1, 7, 8, 9, 777, 999, 1000, 1000], 5),
                           ([17], 2001), ([40_000, 0, 16_385, 16_384, 3], 64)):
        pairs = []
        for k, n in enumerate(lengths):
            t = nib_alphabet[rng.integers(0, len(nib_alphabet), n)]
            q = t.copy()
            flip = rng.random(n) < 0.3
            q[flip] = nib_alphabet[rng.integers(0, len(nib_alphabet),
                                                int(flip.sum()))]
            if k == len(lengths) - 2:
                t[:], q[:] = ord("-"), ord("-")
            pairs.append((t.tobytes(), q.tobytes()))
        t, q, ln = C.pack_pairs(pairs, align=8)
        b2 = int(rng.integers(1, 2 * len(lengths) + 2))
        e = {k: up(v) for k, v in plane_inputs(
            rng, t, q, C.pack_cat_nibbles(t, q), ln, b2, n_ops).items()}
        gate_all(f"edge B={len(lengths)} L={t.shape[1]} B2={b2} N={n_ops}",
                 {"words": (e["tw"], e["qw"]), "nibble": (e["tn"], e["qn"]),
                  "cat": (e["cw"], None)},
                 e["lens"], e["opw16"], e["wt"], e["wq"], e["st"], e["sq"])

    # random shapes: arbitrary words (nibble codes the dictionary never
    # makes, any bytes), lengths below 0 and past the row, arbitrary op
    # words (bit 31 set half the time)
    def words(*shape):
        return up(rng.integers(0, 1 << 32, shape, dtype=np.uint64)
                  .astype(np.uint32).view(np.int32))

    for k in range(6):
        b, lw = int(rng.integers(1, 200)), int(rng.integers(1, 5000))
        b2, noh = int(rng.integers(1, 200)), int(rng.integers(1, 3000))
        r_planes = {"words": (words(b, lw), words(b, lw)),
                    "nibble": (words(b, lw), words(b, lw)),
                    "cat": (words(b, lw), None)}
        r_len = up(rng.integers(-8, 8 * lw + 16, b).astype(np.int32))
        gate_all(f"random {k} B={b} LW={lw} B2={b2} NOH={noh}", r_planes,
                 r_len, words(b2, noh), words(b2, noh), words(b2, noh),
                 words(b2, noh), words(b2, noh))
    gate_stream_edges(rng, device, gate_all, words)
    return host


def gate_stream_edges(rng, device, gate_all, words):
    """The edges of the byte-word and nibble loops of cat_stream.cuh
    (kernels E, F, C and D's word entry), on arbitrary words in both modes:
    LW % 4 in {1, 2, 3} (every row its own 16-byte head); only t, or only
    q, 1-3 words past an aligned base (t and q bases differ mod 16: every
    word one lane each); one nibble row of 2^24 + 8k + 3 columns (every
    warp ends in the same row: block_flush); 100 000 rows of at most 64
    columns (many row changes per warp); F and C with B2 = 0, B2 < B and
    B2 > B.  Times E on the long row."""
    from wgatools_tpu_torch.ops import classify as C

    def ops(b2, noh):
        return [words(b2, noh) for _ in range(5)]

    for lw, b, b2 in ((1001, 37, 5), (1002, 9, 40), (1003, 20, 20)):
        planes = {"words": (words(b, lw), words(b, lw)),
                  "nibble": (words(b, lw), words(b, lw))}
        lens = up_lengths(rng, device, b, 8 * lw)
        gate_all(f"stream LW={lw} B={b} B2={b2}", planes, lens,
                 *ops(b2, int(rng.integers(1, 3000))))
        for side in ("t", "q"):
            for off in (1, 2, 3):
                moved = {kind: (shifted(t, 4 * off), q) if side == "t"
                         else (t, shifted(q, 4 * off))
                         for kind, (t, q) in planes.items()}
                gate_all(f"stream LW={lw} B={b} {side}+{off} words", moved,
                         lens, *ops(b2, 64))
    k = int(rng.integers(0, 1000))
    for n in (1 << 24) + 8 * k + 3, (1 << 24) + 3:  # the timed row last
        lw = (n + 7) // 8
        tn, qn = words(1, lw), words(1, lw)
        qn[0, : lw // 2] = tn[0, : lw // 2]  # a long run of equal columns
        lens = torch_lengths(device, [n])
        gate_all(f"stream nibble row of {n} columns", {"nibble": (tn, qn)},
                 lens, *ops(3, 4096))
    ms = (time_ms(lambda: C.classify_stat_nibbles(tn, qn, lens)),
          time_ms(lambda: C.classify_stat_nibbles_ref(tn, qn, lens), reps=5))
    log(f"classify_nibbles [1, {n}]: kernel {ms[0]:.5f} ms, plain "
        f"{ms[1]:.5f} ms")
    del tn, qn
    b = 100_000
    lens = up_lengths(rng, device, b, 64)
    gate_all(f"stream {b} rows of <= 64 columns",
             {"words": (words(b, 16), words(b, 16)),
              "nibble": (words(b, 8), words(b, 8))}, lens, *ops(b, 3))
    b, lw = 64, 1 << 14
    planes = {"words": (words(b, lw), words(b, lw)),
              "nibble": (words(b, lw), words(b, lw))}
    lens = up_lengths(rng, device, b, 8 * lw)
    for b2 in (0, 17, 200):
        gate_all(f"stream B={b} LW={lw} B2={b2}", planes, lens,
                 *ops(b2, 1000))


def torch_lengths(device, lengths):
    import torch

    return torch.tensor(lengths, dtype=torch.int32, device=device)


def up_lengths(rng, device, b, cols):
    """int32 [b] lengths in [-8, cols + 16), the first row full."""
    lens = rng.integers(-8, cols + 16, b).astype(np.int32)
    lens[0] = cols
    return torch_lengths(device, lens.tolist())


def gate_fused_ops(rng, device, gates, times, full):
    """Kernel 8 in both op forms (uint8 ops + int32 lens, packed words) at
    bench.py's batch (byte-word planes 2 x 128 MiB, 2^15 ops per row) and
    at edge and random shapes, in both modes, with times."""
    import torch

    from wgatools_tpu_torch.ops import fused as F
    from wgatools_tpu_torch.ops.liftover import pack_ops_words

    def up(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a)).to(device)

    def gate(label, tw, qw, lens, ops, op_lens):
        for caller in (False, True):
            gates.check(
                "fused_ops", f"{label} caller={caller}",
                F.classify_liftover_fused(tw, qw, lens, ops, op_lens, device,
                                          caller),
                F.classify_liftover_fused_ref(tw, qw, lens, ops, op_lens,
                                              caller),
            )

    def op_table(b2, n_ops, op_bytes, max_len):
        ops = op_bytes[rng.integers(0, len(op_bytes), (b2, n_ops))]
        ops[np.arange(n_ops)[None, :]
            >= rng.integers(0, n_ops + 1, b2)[:, None]] = 0
        lens = rng.integers(0, max_len, (b2, n_ops), dtype=np.int64)
        lens[ops == 0] = 0
        return ops.astype(np.uint8), lens.astype(np.int32)

    def words(*shape):
        return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(
            np.uint32).view(np.int32)

    d = {k: up(full[k]) for k in ("tw", "qw", "lens", "ops", "op_lens")}
    d["opw"] = up(pack_ops_words(full["ops"], full["op_lens"]))
    B, LW = d["tw"].shape
    n_ops = d["ops"].shape[1]
    label = f"B={B} L={4 * LW} ops={n_ops}"
    gate(f"{label} u8+i32", d["tw"], d["qw"], d["lens"], d["ops"],
         d["op_lens"])
    gate(f"{label} packed", d["tw"], d["qw"], d["lens"], d["opw"], None)
    times["fused_ops"] = (
        time_ms(lambda: F.classify_liftover_fused(
            d["tw"], d["qw"], d["lens"], d["ops"], d["op_lens"], device)),
        time_ms(lambda: F.classify_liftover_fused_ref(
            d["tw"], d["qw"], d["lens"], d["ops"], d["op_lens"]), reps=5),
    )
    cols = valid_columns(full["lens"], 4 * LW)
    n_slots = full["ops"].size  # u8 op + i32 length in, two offsets out
    record_work("fused_ops", 2 * cols.sum() + 4 * B + 4 * 8 * B
                + (1 + 4 + 8) * n_slots, cols.sum() + 2 * n_slots)
    packed_ms = (
        time_ms(lambda: F.classify_liftover_fused(
            d["tw"], d["qw"], d["lens"], d["opw"], None, device)),
        time_ms(lambda: F.classify_liftover_fused_ref(
            d["tw"], d["qw"], d["lens"], d["opw"], None), reps=5),
    )
    log(f"fused_ops {label} u8+i32: kernel {times['fused_ops'][0]:.5f} ms, "
        f"plain {times['fused_ops'][1]:.5f} ms")
    log(f"fused_ops {label} packed: kernel {packed_ms[0]:.5f} ms, plain "
        f"{packed_ms[1]:.5f} ms")
    del d

    # edge shapes: B != B2 both ways, B2 = 0, NO = 0 and NO not a multiple
    # of 128, LW not a multiple of any tile, lengths below the row and
    # past it, op bytes that are not CIGAR ops, lengths up to 2^31 - 1
    # (the u8 form's row sums wrap)
    alphabet = np.frombuffer(b"ACGT-NRY", np.uint8)
    any_byte = np.arange(256, dtype=np.uint8)
    cigar = np.frombuffer(b"M=XIDS", np.uint8)
    for b, lw, b2, n, op_bytes, max_len in (
        (9, 1001, 3, 1000, cigar, 1 << 16),
        (3, 257, 13, 129, any_byte, 1 << 16),
        (5, 64, 0, 77, cigar, 1 << 16),
        (1, 3, 7, 0, cigar, 1 << 16),
        (4, 4099, 4, 3333, cigar, 2**31),
        (17, 999, 5, 250, any_byte, 2**31),
    ):
        planes = alphabet[rng.integers(0, len(alphabet), (2, b, 4 * lw))]
        lens = rng.integers(-4, 4 * lw + 9, b).astype(np.int32)
        tw, qw = (up(p.view("<i4")) for p in planes)
        ops, op_lens = op_table(b2, n, op_bytes, max_len)
        label = f"edge B={b} LW={lw} B2={b2} NO={n} max_len={max_len}"
        gate(f"{label} u8+i32", tw, qw, up(lens), up(ops), up(op_lens))
        if max_len <= 1 << 16:
            gate(f"{label} packed", tw, qw, up(lens),
                 up(pack_ops_words(ops, op_lens)), None)
    # random shapes: arbitrary plane words, random int32 packed words (half
    # of them negative), any op bytes with lengths up to 2^31 - 1
    for k in range(6):
        b, lw = int(rng.integers(1, 200)), int(rng.integers(1, 5000))
        b2, n = int(rng.integers(1, 200)), int(rng.integers(1, 3000))
        tw, qw = up(words(b, lw)), up(words(b, lw))
        lens = up(rng.integers(-8, 4 * lw + 16, b).astype(np.int32))
        label = f"random {k} B={b} LW={lw} B2={b2} NO={n}"
        gate(f"{label} packed", tw, qw, lens, up(words(b2, n)), None)
        ops, op_lens = op_table(b2, n, any_byte, 2**31)
        gate(f"{label} u8+i32", tw, qw, lens, up(ops), up(op_lens))


def phase_sharded(work, device, rng, gates, host):
    """Phase 7: the sharded layer on a one-rank NCCL group: the dryrun,
    then every sharded function at full size against the plain versions."""
    import torch

    from wgatools_tpu_torch.ops import classify as C
    from wgatools_tpu_torch.ops import fused as F
    from wgatools_tpu_torch.ops.liftover import liftover_scan_ref
    from wgatools_tpu_torch.parallel import mesh as M
    from wgatools_tpu_torch.parallel.dist_tools import replicate_rows
    from wgatools_tpu_torch.parallel.dryrun import dryrun_multichip

    store = os.path.join(work, "nccl.store")
    if os.path.exists(store):
        os.remove(store)
    with M.record_group("nccl", store, 0, 1, device) as group:
        t0 = time.perf_counter()
        dryrun_multichip(group)
        log(f"sharded: dryrun ok in {time.perf_counter() - t0:.3f} s")

        t0 = time.perf_counter()
        d = {k: M.shard_rows(group, v) for k, v in host.items()}
        lens = d["lens"]
        planes = {"words": (d["tw"], d["qw"]), "nibble": (d["tn"], d["qn"]),
                  "cat": (d["cw"], None)}
        refs = {"words": C.classify_stat_words_ref,
                "nibble": C.classify_stat_nibbles_ref}
        kernel = {"words": "classify_words", "nibble": "classify_nibbles"}
        for caller in (False, True):
            for kind, ref in refs.items():
                nib = kind == "nibble"
                gates.check(
                    kernel[kind], f"sharded_column_stats caller={caller}",
                    [M.sharded_column_stats(group, *planes[kind], lens, caller,
                                            nibble=nib)],
                    [ref(*planes[kind], lens, caller)],
                )
                gates.check(
                    "fused16", f"sharded_fused16 {kind} caller={caller}",
                    M.sharded_fused16(group, *planes[kind], lens, d["opw16"],
                                      nibble=nib, caller=caller),
                    F.classify_liftover_fused16_ref(*planes[kind], lens,
                                                    d["opw16"], caller, nib),
                )
            for kind, pl in planes.items():
                for mode, flags in ADV16_MODES:
                    words = ((d["st"], d["sq"]) if flags.get("raw_sums")
                             else (d["wt"], d["wq"]))
                    flags = dict(flags, nibble=kind == "nibble",
                                 catmode=kind == "cat")
                    gates.check(
                        "fused_adv16",
                        f"sharded_fused_adv16 {kind} {mode} caller={caller}",
                        M.sharded_fused_adv16(group, *pl, lens, *words,
                                              caller=caller, **flags),
                        F.classify_liftover_fused_adv16_ref(
                            *pl, lens, *words, caller, **flags),
                    )
        gates.check("liftover_scan", "sharded_liftover",
                    M.sharded_liftover(group, d["ops"], d["op_lens"]),
                    liftover_scan_ref(d["ops"], d["op_lens"]))
        stats = M.sharded_column_stats(group, *planes["words"], lens)
        ids = np.arange(stats.shape[0], dtype=np.int32) % 7
        want = np.zeros((7, 8), np.int64)
        np.add.at(want, ids, stats.cpu().numpy())
        table = M.sharded_pair_reduce(group, stats, M.shard_rows(group, ids), 7)
        if not np.array_equal(table.cpu().numpy(), want):
            raise AssertionError("sharded_pair_reduce differs from np.add.at")
        log(f"sharded: stats, fused16, fused_adv16, liftover and the pair "
            f"merge at full size ok in {time.perf_counter() - t0:.3f} s")
        del d, planes, stats

        t0 = time.perf_counter()
        starts = rng.integers(0, GENOME_LEN, N_SPANS).astype(np.int32)
        ends = np.minimum(starts + rng.integers(1, 100_000, N_SPANS),
                          GENOME_LEN).astype(np.int32)
        starts[:100] = -1  # padding spans add nothing
        s, e = M.shard_rows(group, starts), M.shard_rows(group, ends)
        real = s >= 0
        plain = torch.cumsum(
            torch.bincount(s[real].long(), minlength=GENOME_LEN + 1)
            - torch.bincount(e[real].long(), minlength=GENOME_LEN + 1), 0,
        )[:GENOME_LEN]
        for label, cov in (
            ("sharded_coverage", M.sharded_coverage(group, s, e, GENOME_LEN)),
            ("sharded_coverage_scatter",
             M.sharded_coverage_scatter(group, s, e, GENOME_LEN)),
            ("sharded_coverage_scatter trim=False",
             M.sharded_coverage_scatter(group, s, e, GENOME_LEN,
                                        trim=False)[:GENOME_LEN]),
        ):
            if cov.dtype != torch.int32 or not torch.equal(cov.long(), plain):
                raise AssertionError(f"{label} differs from the plain coverage")
        del plain
        log(f"sharded: coverage of {GENOME_LEN} positions from {N_SPANS} "
            f"spans ok in {time.perf_counter() - t0:.3f} s")

        t0 = time.perf_counter()
        sp_ops = np.frombuffer(b"M=XIDS", np.uint8)[
            rng.integers(0, 6, (SP_ROWS, SP_OPS))]
        sp_lens = rng.integers(0, 256, (SP_ROWS, SP_OPS)).astype(np.int32)
        o = M.shard_rows(group, sp_ops, axis=1)
        ln = M.shard_rows(group, sp_lens, axis=1)
        gates.check("liftover_scan", f"sharded_liftover_sp {SP_ROWS}x{SP_OPS}",
                    M.sharded_liftover_sp(group, o, ln), liftover_scan_ref(o, ln))
        rows = replicate_rows(group, np.arange(16, dtype=np.uint8))
        if not np.array_equal(rows, np.arange(16, dtype=np.uint8)[None]):
            raise AssertionError("replicate_rows")
        log(f"sharded: sequence-parallel scan and row merge ok in "
            f"{time.perf_counter() - t0:.3f} s")


def write_maf(path, corpus, rng, n_records, n_cols):
    """make_corpus.make_maf's alignments, with every 5th query on '-'."""
    with open(path, "w") as f:
        f.write("##maf version=1.6\n")
        t_off = 1000
        for i in range(n_records):
            vals, lens = corpus.run_table(rng, max(3, n_cols // 18))
            scale = n_cols / max(1, int(lens.sum()))
            lens = np.maximum(1, (lens * scale).astype(np.int64))
            t, q = corpus.realize(rng, vals, lens)
            t_len = int((t != corpus.GAP).sum())
            q_len = int((q != corpus.GAP).sum())
            strand = "-" if i % 5 == 0 else "+"
            f.write(
                f"a score=0\ns\tref.chr1\t{t_off}\t{t_len}\t+\t1000000000\t"
                + t.tobytes().decode("ascii")
                + f"\ns\tq{i % 4}.chr1\t{t_off}\t{q_len}\t{strand}\t"
                "1000000000\t" + q.tobytes().decode("ascii") + "\n\n"
            )
            t_off += t_len + 10


def run_cli(argv):
    from wgatools_tpu_torch.cli import main

    t0 = time.perf_counter()
    rc = main(argv)
    if rc != 0:
        raise AssertionError(f"wgatools_tpu_torch {' '.join(argv)} exited {rc}")
    return time.perf_counter() - t0


def phase_stat(work, corpus, rng):
    """Phase 2: `stat` and `stat -e` on a ~100 Mbp MAF against the host
    engine's bytes."""
    from wgatools_tpu_torch.io.compression import open_input
    from wgatools_tpu_torch.io.maf import MafReader
    from wgatools_tpu_torch.tools.stat import stat_maf

    maf = os.path.join(work, "smoke.maf")
    t0 = time.perf_counter()
    write_maf(maf, corpus, rng, MAF_RECORDS, MAF_COLUMNS)
    log(f"stat: wrote {os.path.getsize(maf)} B of MAF in "
        f"{time.perf_counter() - t0:.3f} s")
    for each in (False, True):
        out = os.path.join(work, f"stat{'_each' if each else ''}.tsv")
        secs = run_cli(["stat", maf, "-o", out, "-r"] + (["-e"] if each else []))
        t0 = time.perf_counter()
        want = io.BytesIO()
        stat_maf(MafReader(open_input(maf)), want, None, each)
        host_secs = time.perf_counter() - t0
        with open(out, "rb") as f:
            got = f.read()
        if got != want.getvalue():
            raise AssertionError(f"stat each={each}: bytes differ from the host engine")
        log(f"stat each={each}: ok, {len(got)} B identical; port "
            f"{secs:.3f} s, host engine {host_secs:.3f} s")


def phase_paf2chain(work, corpus, rng):
    """Phase 3: `paf2chain` on 100 000 records x 40 runs against the host
    engine's bytes."""
    from wgatools_tpu_torch.io.compression import open_input
    from wgatools_tpu_torch.io.paf import PafReader
    from wgatools_tpu_torch.tools.convert import paf2chain

    paf = os.path.join(work, "smoke.paf")
    t0 = time.perf_counter()
    corpus.make_paf(paf, rng, PAF_RECORDS, PAF_RUNS)
    log(f"paf2chain: wrote {os.path.getsize(paf)} B of PAF in "
        f"{time.perf_counter() - t0:.3f} s")
    out = os.path.join(work, "smoke.chain")
    secs = run_cli(["paf2chain", paf, "-o", out, "-r"])
    t0 = time.perf_counter()
    want = io.BytesIO()
    paf2chain(PafReader(open_input(paf)), want, None)
    host_secs = time.perf_counter() - t0
    with open(out, "rb") as f:
        got = f.read()
    if got != want.getvalue():
        raise AssertionError("paf2chain: bytes differ from the host engine")
    log(f"paf2chain: ok, {len(got)} B identical; port {secs:.3f} s, "
        f"host engine {host_secs:.3f} s")


def phase_paf2chain_long(work, corpus, rng):
    """`paf2chain` on a PAF of LONG_PAF_RECORDS records of LONG_PAF_RUNS
    CIGAR ops each: one batch of a few long rows, kernel B's long-row
    path, against the host engine's bytes."""
    from wgatools_tpu_torch.io.compression import open_input
    from wgatools_tpu_torch.io.paf import PafReader
    from wgatools_tpu_torch.tools.convert import paf2chain

    paf = os.path.join(work, "long.paf")
    t0 = time.perf_counter()
    corpus.make_paf(paf, rng, LONG_PAF_RECORDS, LONG_PAF_RUNS)
    log(f"paf2chain long records: wrote {os.path.getsize(paf)} B of PAF in "
        f"{time.perf_counter() - t0:.3f} s")
    out = os.path.join(work, "long.chain")
    secs = run_cli(["paf2chain", paf, "-o", out, "-r"])
    t0 = time.perf_counter()
    want = io.BytesIO()
    paf2chain(PafReader(open_input(paf)), want, None)
    host_secs = time.perf_counter() - t0
    with open(out, "rb") as f:
        got = f.read()
    if got != want.getvalue():
        raise AssertionError("paf2chain long records: bytes differ from the "
                             "host engine")
    log(f"paf2chain long records: ok, {len(got)} B identical; port "
        f"{secs:.3f} s, host engine {host_secs:.3f} s")
    os.remove(paf)


def file_digest(path):
    """(size, SHA-256) of a file, read in 64 MiB pieces."""
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 26), b""):
            h.update(block)
    return os.path.getsize(path), h.hexdigest()


def run_host(got_paths, host_fn):
    """Run host_fn(paths), the host engine writing to files beside each
    port output; returns its wall in seconds."""
    t0 = time.perf_counter()
    host_fn([p + ".host" for p in got_paths])
    return time.perf_counter() - t0


def compare_with_host(name, got_paths, host_fn, secs, host_secs=None):
    """Run host_fn (run_host), then compare every pair of files by size and
    SHA-256.  host_secs: the host engine already ran (run_host), in that
    many seconds."""
    if host_secs is None:
        host_secs = run_host(got_paths, host_fn)
    want_paths = [p + ".host" for p in got_paths]
    sizes = []
    for got, want in zip(got_paths, want_paths):
        g, w = file_digest(got), file_digest(want)
        if g != w:
            raise AssertionError(f"{name}: {os.path.basename(got)} differs "
                                 f"from the host engine ({g} != {w})")
        sizes.append(g[0])
        os.remove(want)
    log(f"{name}: ok, {' + '.join(map(str, sizes))} B identical; port "
        f"{secs:.3f} s, host engine {host_secs:.3f} s")


def phase_pafcov(work):
    """`pafcov` on the paf2chain PAF (8 targets of 3.1 Mbp: ~24.8 M BED
    lines) against the host engine's bytes."""
    from wgatools_tpu_torch.io.compression import open_input, open_output
    from wgatools_tpu_torch.io.paf import PafReader
    from wgatools_tpu_torch.tools.pafcov import pafcov

    paf = os.path.join(work, "smoke.paf")
    out = os.path.join(work, "smoke.cov.bed")
    secs = run_cli(["pafcov", paf, "-o", out, "-r"])
    compare_with_host("pafcov", [out], lambda w: pafcov(
        PafReader(open_input(paf)), open_output(w[0], True), None), secs)
    os.remove(out)


def write_bad_paf(work):
    """A copy of the paf2chain PAF whose every 7th record's query end is
    one past its CIGAR's and every 11th record's target end one short."""
    src, bad = os.path.join(work, "smoke.paf"), os.path.join(work, "bad.paf")
    with open(src) as f, open(bad, "w") as g:
        for i, line in enumerate(f):
            fields = line.split("\t")
            if i % 7 == 0:
                fields[3] = str(int(fields[3]) + 1)
            if i % 11 == 0:
                fields[8] = str(int(fields[8]) - 1)
            g.write("\t".join(fields))
    return bad


def phase_stat_paf(work):
    """`stat -f paf` and `stat -f paf -e` on the altered copy of the
    paf2chain PAF against the host engine's bytes."""
    from wgatools_tpu_torch.io.compression import open_input, open_output
    from wgatools_tpu_torch.io.paf import PafReader
    from wgatools_tpu_torch.tools.stat import stat_paf

    bad = write_bad_paf(work)
    for each in (False, True):
        out = os.path.join(work, f"paf_stat{'_each' if each else ''}.tsv")
        secs = run_cli(["stat", "-f", "paf", bad, "-o", out, "-r"]
                       + (["-e"] if each else []))
        compare_with_host(f"stat -f paf each={each}", [out], lambda w:
                          stat_paf(PafReader(open_input(bad)),
                                   open_output(w[0], True), None, each), secs)


def phase_validate(work):
    """`validate` and `validate -f FIXED` on the altered copy of the
    paf2chain PAF (written by phase_stat_paf) against the host engine's
    bytes."""
    from wgatools_tpu_torch.io.compression import open_input, open_output
    from wgatools_tpu_torch.io.paf import PafReader
    from wgatools_tpu_torch.tools.validate import validate_paf

    bad = os.path.join(work, "bad.paf")
    report = os.path.join(work, "validate.txt")
    secs = run_cli(["validate", bad, "-o", report, "-r"])
    compare_with_host("validate", [report], lambda w: validate_paf(
        PafReader(open_input(bad)), open_output(w[0], True), None, False,
        None), secs)
    fixed = os.path.join(work, "fixed.paf")
    secs = run_cli(["validate", bad, "-o", report, "-r", "-f", fixed])
    with open(report) as f:
        head = f.read(200)
    log("validate: " + ", ".join(head.splitlines()[:3]))
    compare_with_host("validate -f", [report, fixed], lambda w: validate_paf(
        PafReader(open_input(bad)), open_output(w[0], True),
        open_output(w[1], True), True, None), secs)


def phase_chain2paf(work):
    """`chain2paf` on the chain the paf2chain phase wrote against the host
    engine's bytes."""
    from wgatools_tpu_torch.io.chain import ChainReader
    from wgatools_tpu_torch.io.compression import open_input, open_output
    from wgatools_tpu_torch.tools.convert import chain2paf

    chain = os.path.join(work, "smoke.chain")
    out = os.path.join(work, "smoke.c2p.paf")
    secs = run_cli(["chain2paf", chain, "-o", out, "-r"])
    compare_with_host("chain2paf", [out], lambda w: chain2paf(
        ChainReader(open_input(chain)), open_output(w[0], True), None), secs)


def phase_fused_ops(device, bench):
    """Kernel 8 through its public op (no tool calls it) at bench.py's
    shape, in both op forms: its stats and offsets must equal the plain
    word stats and the plain full liftover scan of the same ops."""
    import torch

    from wgatools_tpu_torch.ops.classify import classify_stat_words_ref
    from wgatools_tpu_torch.ops.fused import classify_liftover_fused
    from wgatools_tpu_torch.ops.liftover import liftover_scan_ref, pack_ops_words

    full = bench["full"]
    tw, qw, lens, ops, op_lens = (full[k] for k in
                                  ("tw", "qw", "lens", "ops", "op_lens"))
    want_stats = classify_stat_words_ref(*(torch.from_numpy(a).to(device)
                                           for a in (tw, qw, lens)))
    want = liftover_scan_ref(torch.from_numpy(ops).to(device),
                             torch.from_numpy(op_lens).to(device))
    for form, args in (("u8+i32", (ops, op_lens)),
                       ("packed", (pack_ops_words(ops, op_lens), None))):
        t0 = time.perf_counter()
        stats, t_off, q_off = classify_liftover_fused(tw, qw, lens, *args,
                                                      device)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if not (torch.equal(stats, want_stats) and torch.equal(t_off, want[0])
                and torch.equal(q_off, want[1])):
            raise AssertionError(f"fused_ops {form}: differs from the plain "
                                 "word stats + liftover scan")
        log(f"fused_ops {form}: ok, stats + t/q offsets of {ops.shape[0]}x"
            f"{ops.shape[1]} ops equal the plain stats and scan ({secs:.3f} s "
            "host wall incl. upload)")


def phase_fused(device, bench):
    """Phase 4: the fused flagship at bench.py's shape; anchors expanded
    per op must equal the plain full-table liftover scan."""
    import torch

    from wgatools_tpu_torch.ops.classify import classify_stat_cat_ref
    from wgatools_tpu_torch.ops.fused import classify_liftover_fused_adv16
    from wgatools_tpu_torch.ops.liftover import (
        adv16_odd_offsets,
        expand_group_prefix,
        interleave_halves,
        liftover_scan_ref,
        pack_ops_adv16,
        pack_ops_sums,
    )

    ops, op_lens = bench["ops"], bench["op_lens"]
    n_ops = ops.shape[1]
    st, sq = pack_ops_sums(ops, op_lens, group=8)
    wt, wq = pack_ops_adv16(ops, op_lens)
    t0 = time.perf_counter()
    stats, ta, qa = classify_liftover_fused_adv16(
        bench["cw"], None, bench["lens"], st, sq, device, catmode=True,
        raw_sums=True,
    )
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    want_stats = classify_stat_cat_ref(bench["cw"], bench["lens"])
    if not torch.equal(stats, want_stats):
        raise AssertionError("fused stats differ from the plain version")
    want_t, want_q = (
        x.cpu().numpy()
        for x in liftover_scan_ref(
            torch.from_numpy(ops).to(device), torch.from_numpy(op_lens).to(device)
        )
    )
    for label, anchors, w, want in (("t", ta, wt, want_t), ("q", qa, wq, want_q)):
        even = expand_group_prefix(anchors.cpu().numpy(), w, group=8)
        got = interleave_halves(even, adv16_odd_offsets(even, w))[:, :n_ops]
        if not np.array_equal(got, want):
            raise AssertionError(f"fused {label} offsets differ from the full scan")
    log(f"fused: ok, stats + expanded t/q offsets of {ops.shape[0]}x{n_ops} "
        f"ops equal the plain full scan ({secs:.3f} s host wall incl. upload)")


def write_call_maf(path, rng, n_records, n_cols):
    """`call` input: '=' runs (geometric, mean 60 columns) between single
    events, a SNP or a two-base substitution (60%), an insertion, a deletion
    or a gap/gap stretch of 1-20 columns (15%, 15%, 10%).  No gap run
    reaches the default SV cutoff of 50, so `-c 16000000` keeps each record
    one chunk.  Record i has n_cols + 1001 i columns, every 4th query is on
    '-'."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    gap = ord("-")
    with open(path, "w") as f:
        f.write("##maf version=1.6\n")
        t_off = 1000
        for i in range(n_records):
            n = n_cols + 1001 * i
            n_ev = n // 60
            kind = rng.choice(4, size=n_ev, p=[0.6, 0.15, 0.15, 0.1]) + 1
            lens = np.empty(2 * n_ev + 1, np.int64)
            lens[0::2] = rng.geometric(1 / 60, n_ev + 1)
            lens[1::2] = np.where(kind == 1, rng.integers(1, 3, n_ev),
                                  rng.integers(1, 21, n_ev))
            codes = np.zeros(2 * n_ev + 1, np.int8)  # 0 '=' 1 X 2 I 3 D 4 W
            codes[1::2] = kind
            cat = np.repeat(codes, lens)[:n]
            cat = np.pad(cat, (0, n - cat.shape[0]))
            base = rng.integers(0, 4, n)
            t = bases[base]
            q = t.copy()
            x = cat == 1
            q[x] = bases[(base[x] + rng.integers(1, 4, int(x.sum()))) % 4]
            t[(cat == 2) | (cat == 4)] = gap
            q[(cat == 3) | (cat == 4)] = gap
            t_len = int((t != gap).sum())
            q_len = int((q != gap).sum())
            strand = "-" if i % 4 == 3 else "+"
            f.write(
                f"a score=0\ns\tref.chr{i}\t{t_off}\t{t_len}\t+\t1000000000\t"
                + t.tobytes().decode("ascii")
                + f"\ns\tqry.chr{i}\t{t_off}\t{q_len}\t{strand}\t"
                "1000000000\t" + q.tobytes().decode("ascii") + "\n\n"
            )
            t_off += t_len + 10


def phase_maf_tool(work, tool):
    """Phase 5: `maf2paf` or `maf2chain` on the stat MAF against the host
    engine's bytes."""
    from wgatools_tpu_torch.io.compression import open_input
    from wgatools_tpu_torch.io.maf import MafReader
    from wgatools_tpu_torch.tools import convert

    maf = os.path.join(work, "smoke.maf")
    out = os.path.join(work, f"smoke.{tool}")
    secs = run_cli([tool, maf, "-o", out, "-r"])
    t0 = time.perf_counter()
    want = io.BytesIO()
    getattr(convert, tool)(MafReader(open_input(maf)), want, None)
    host_secs = time.perf_counter() - t0
    with open(out, "rb") as f:
        got = f.read()
    if got != want.getvalue():
        raise AssertionError(f"{tool}: bytes differ from the host engine")
    log(f"{tool}: ok, {len(got)} B identical; port {secs:.3f} s, host engine "
        f"{host_secs:.3f} s")


def call_argv(work, chunk_size, out="call.vcf"):
    argv = ["call", "-s", os.path.join(work, "call.maf"),
            "-o", os.path.join(work, out), "-r"]
    return argv + (["-c", str(chunk_size)] if chunk_size else [])


def phase_call(work, rng, chunk_size):
    """Phase 6: `call -s` on the call MAF (written on first use) at a chunk
    size (None: the default) against the host engine's bytes."""
    from wgatools_tpu_torch.io.compression import open_input
    from wgatools_tpu_torch.io.maf import MafReader
    from wgatools_tpu_torch.tools.caller import call_var_maf

    maf = os.path.join(work, "call.maf")
    if not os.path.exists(maf):
        t0 = time.perf_counter()
        write_call_maf(maf, rng, CALL_RECORDS, CALL_COLUMNS)
        log(f"call: wrote {os.path.getsize(maf)} B of MAF in "
            f"{time.perf_counter() - t0:.3f} s")
    argv = call_argv(work, chunk_size)
    secs = run_cli(argv)
    t0 = time.perf_counter()
    want = io.BytesIO()
    call_var_maf(MafReader(open_input(maf)), None, want, True, False, 50,
                 None, chunk_size=chunk_size)
    host_secs = time.perf_counter() - t0
    with open(argv[4], "rb") as f:
        got = f.read()
    if got != want.getvalue():
        raise AssertionError(f"call -c {chunk_size}: bytes differ from the "
                             "host engine")
    lines = got.count(b"\n")
    log(f"call -c {chunk_size}: ok, {len(got)} B ({lines} lines) identical; "
        f"port {secs:.3f} s, host engine {host_secs:.3f} s")


def logged_launches(lines):
    """The kernel launches that the `kernel launches: {json}` lines among
    `lines` report, summed."""
    total = {}
    for line in lines:
        if "kernel launches: " in line:
            counts = json.loads(line.split("kernel launches: ", 1)[1])
            for kernel, count in counts.items():
                total[kernel] = total.get(kernel, 0) + count
    return total


class RankSet:
    """One mode's n rank processes of `python -m wgatools_tpu_torch` under
    WGA_TPU_DIST on the card (NCCL), each in its own empty directory
    job_dir/rank<k> (`-o` and `-f` name files relative to it), with its
    stdout and stderr in files beside them.  A thread a rank records when
    it exits."""

    def __init__(self, job_dir, label, argv, n, env=None):
        import socket
        import threading

        self.job_dir, self.label, self.n = job_dir, label, n
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        shutil.rmtree(job_dir, ignore_errors=True)
        self.procs, self.ends, watchers = [], [None] * n, []
        self.launches = {}
        self.t0 = time.perf_counter()
        for k in range(n):
            os.makedirs(self.path(k))
            rank_env = dict(
                os.environ, PYTHONPATH=REPO, WGA_TPU_DIST="1",
                WGA_TORCH_DEVICE="cuda",
                JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                JAX_NUM_PROCESSES=str(n), JAX_PROCESS_ID=str(k),
            )
            rank_env.pop("WGA_TPU_GIANT_SPLIT", None)
            rank_env.update(env or {})
            with open(self.path(k) + ".out", "wb") as out, \
                    open(self.path(k) + ".err", "wb") as err:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "wgatools_tpu_torch", *argv, "-v"],
                    cwd=self.path(k), env=rank_env, stdout=out, stderr=err,
                ))
            watchers.append(threading.Thread(target=self._watch, args=(k,),
                                             daemon=True))
        for w in watchers:
            w.start()

    def path(self, k, name=None):
        rank_dir = os.path.join(self.job_dir, f"rank{k}")
        return rank_dir if name is None else os.path.join(rank_dir, name)

    def _watch(self, k):
        self.procs[k].wait()
        self.ends[k] = time.perf_counter()

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def wait(self, deadline):
        """Wait for every rank (killing them all past `deadline`), check
        that each exited 0 on the NCCL backend, that no rank wrote to
        stdout and that no rank but 0 created a file; returns the wall from
        the start to the last rank's exit.  self.launches: the kernel
        launches the ranks logged, summed."""
        try:
            for p in self.procs:
                p.wait(timeout=max(0.0, deadline - time.perf_counter()))
        finally:
            self.kill()
        for k, p in enumerate(self.procs):
            with open(self.path(k) + ".err") as f:
                err = f.read()
            what = f"distributed {self.label}: rank {k}"
            if p.returncode != 0:
                raise AssertionError(f"{what} exited {p.returncode}:\n"
                                     f"{err[-4000:]}")
            if f"process {k}/{self.n}" not in err or "backend nccl" not in err:
                raise AssertionError(f"{what} logged no NCCL init:\n"
                                     f"{err[-4000:]}")
            for kernel, count in logged_launches(err.splitlines()).items():
                self.launches[kernel] = self.launches.get(kernel, 0) + count
            if os.path.getsize(self.path(k) + ".out"):
                raise AssertionError(f"{what} wrote to stdout")
            if k and os.listdir(self.path(k)):
                raise AssertionError(f"{what} created "
                                     f"{os.listdir(self.path(k))}")
        while None in self.ends:  # the watchers record the exits
            time.sleep(0.01)
        return max(self.ends) - self.t0


def pair_sum_median(paf):
    """The median over (query, target) pairs of their summed target
    alignment sizes: `filter -a` at it keeps about half the pairs."""
    sums = {}
    with open(paf) as f:
        for line in f:
            q, _, _, _, _, t, _, ts, te = line.split("\t", 9)[:9]
            sums[q, t] = sums.get((q, t), 0) + int(te) - int(ts)
    return int(np.median(list(sums.values())))


def phase_distributed(work, n_ranks):
    """The distributed modes (WGA_TPU_DIST) on n_ranks rank processes, one
    card each, over NCCL, on the files the earlier phases wrote: each
    mode's output from rank 0 against the host engine's bytes.  A rank
    takes ~10 s to start on the card, so DIST_JOBS modes run at once, and
    the host engine runs in this process while they do.  Each rank runs
    its share as the TPU package's ranks do: `call -s` on its card (kernel
    A, as the serial `call`), the other modes on the host engine; the
    merges are NCCL collectives.  The launches the ranks log go to
    RANK_LAUNCHES, and every `call -s` run must have launched kernel A.
    `stat` and `call -s` run on the stat and call MAFs without, then with,
    a maf-index manifest.  pafpseudo merges nothing and needs a FASTA: the
    CPU tests hold it."""
    from collections import deque

    from wgatools_tpu_torch.io.chain import ChainReader
    from wgatools_tpu_torch.io.compression import open_input, open_output
    from wgatools_tpu_torch.io.maf import MafReader
    from wgatools_tpu_torch.io.paf import PafReader
    from wgatools_tpu_torch.tools import convert
    from wgatools_tpu_torch.tools.caller import call_var_maf
    from wgatools_tpu_torch.tools.dotplot import dotplot
    from wgatools_tpu_torch.tools.filter import filter_paf_align_pair
    from wgatools_tpu_torch.tools.index import (
        build_index,
        index_path_for,
        load_index,
    )
    from wgatools_tpu_torch.tools.pafcov import pafcov
    from wgatools_tpu_torch.tools.stat import stat_maf, stat_paf
    from wgatools_tpu_torch.tools.validate import validate_paf

    maf, call_maf, paf, chain, bad = (os.path.join(work, name) for name in (
        "smoke.maf", "call.maf", "smoke.paf", "smoke.chain", "bad.paf"))
    min_align = pair_sum_median(paf)

    def reader(cls, path):
        return cls(open_input(path))

    def call_host(w):
        index = index_path_for(call_maf)
        call_var_maf(reader(MafReader, call_maf),
                     load_index(index) if os.path.exists(index) else None,
                     open_output(w[0], True), True, False, 50, None,
                     chunk_size=1_000_000)

    # label, argv (outputs relative to each rank's directory), the host
    # engine writing the same outputs, extra environment
    maf_runs = [
        ("stat", ["stat", maf], lambda w: stat_maf(
            reader(MafReader, maf), open_output(w[0], True), None)),
        ("call -s", ["call", "-s", call_maf], call_host),
    ]
    runs = [(f"{label}, no index", argv, host, None)
            for label, argv, host in maf_runs]
    runs += [
        ("maf2paf", ["maf2paf", maf], lambda w: convert.maf2paf(
            reader(MafReader, maf), open_output(w[0], True), None), None),
        ("maf2chain", ["maf2chain", maf], lambda w: convert.maf2chain(
            reader(MafReader, maf), open_output(w[0], True), None), None),
        ("stat -f paf", ["stat", "-f", "paf", bad], lambda w: stat_paf(
            reader(PafReader, bad), open_output(w[0], True), None), None),
        ("paf2chain", ["paf2chain", paf], lambda w: convert.paf2chain(
            reader(PafReader, paf), open_output(w[0], True), None), None),
        ("chain2paf", ["chain2paf", chain], lambda w: convert.chain2paf(
            reader(ChainReader, chain), open_output(w[0], True), None), None),
        ("pafcov", ["pafcov", paf], lambda w: pafcov(
            reader(PafReader, paf), open_output(w[0], True), None), None),
        ("validate -f", ["validate", bad, "-f", "fixed.paf"],
         lambda w: validate_paf(reader(PafReader, bad),
                                open_output(w[0], True),
                                open_output(w[1], True), True, None), None),
        (f"filter -f paf -a {min_align}",
         ["filter", "-f", "paf", "-a", str(min_align), paf],
         lambda w: filter_paf_align_pair(reader(PafReader, paf),
                                         open_output(w[0], True), min_align),
         None),
        # one row a record: the 100 000-record PAF in seconds
        ("dotplot -f paf -m overview --out-format csv",
         ["dotplot", "-f", "paf", "-m", "overview", "--out-format", "csv",
          paf], lambda w: dotplot(paf, open_output(w[0], True), "paf", "csv",
                                  "overview", False, 50, None, None), None),
    ]
    if n_ranks > 1:  # every ~400 KB record column-split over the ranks
        for label, argv, host, _ in runs[2:4]:
            runs.append((f"{label}, giant split", argv, host,
                         {"WGA_TPU_GIANT_SPLIT": str(DIST_GIANT_SPLIT)}))
    manifest_runs = [(f"{label}, maf-index manifest", argv, host, None)
                     for label, argv, host in maf_runs]

    def run_all(runs):
        """Keep DIST_JOBS modes in flight; the host engine of each runs
        here after its ranks start; each mode is checked in start order."""
        inflight = deque()

        def finish():
            job, got, host, host_secs = inflight.popleft()
            secs = job.wait(job.t0 + DIST_TIMEOUT_S)
            compare_with_host(f"distributed {job.label} (N={n_ranks}, "
                              f"{DIST_JOBS} modes at once)", got, host, secs,
                              host_secs)
            log(f"distributed {job.label}: the ranks' launches "
                f"{job.launches}")
            if job.label.startswith("call") and not job.launches.get(
                    "classify_cat"):
                raise AssertionError(f"distributed {job.label}: no rank "
                                     "launched classify_cat")
            add_rank_launches(job.launches)
            shutil.rmtree(job.job_dir)

        try:
            for k, (label, argv, host, env) in enumerate(runs):
                if len(inflight) == DIST_JOBS:
                    finish()
                outs = ["out", "fixed.paf"] if argv[0] == "validate" else ["out"]
                job = RankSet(os.path.join(work, f"dist{k}"), label,
                              argv + ["-o", outs[0]], n_ranks, env)
                got = [job.path(0, name) for name in outs]
                inflight.append([job, got, host, None])
                inflight[-1][3] = run_host(got, host)
            while inflight:
                finish()
        finally:
            for job, *_ in inflight:
                job.kill()

    indexes = [index_path_for(path) for path in (maf, call_maf)]
    try:
        run_all(runs)
        t0 = time.perf_counter()
        for path, index in zip((maf, call_maf), indexes):
            build_index(MafReader.from_path(path), open_output(index, True))
        log(f"distributed: maf-index of both MAFs in "
            f"{time.perf_counter() - t0:.3f} s")
        run_all(manifest_runs)
    finally:
        for index in indexes:
            if os.path.exists(index):
                os.remove(index)


def phase_entry(device, gates):
    """The fused entry step (wgatools_tpu_torch.entry, kernel F on the
    card) against its plain version on a CPU copy of its inputs."""
    from wgatools_tpu_torch.entry import entry

    step, args = entry(device)
    got = step(*args)
    want = step(*(a.cpu() for a in args))
    gates.check("fused16", f"entry step B={args[0].shape[0]} "
                f"L={args[0].shape[1]} op words {tuple(args[3].shape)}",
                got, [w.to(device) for w in want])


def run_program(argv, timeout=PROGRAM_TIMEOUT_S):
    """Run `python -m argv` from the repository root on the card; returns
    (stdout, stderr lines, wall seconds).  Every stderr line is logged; a
    non-zero exit raises, with the end of stdout."""
    env = dict(os.environ, PYTHONPATH=REPO, WGA_TORCH_DEVICE="cuda")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)
    secs = time.perf_counter() - t0
    err = proc.stderr.splitlines()
    for line in err:
        log(f"  {line}")
    if proc.returncode != 0:
        raise AssertionError(f"python -m {' '.join(argv)} exited "
                             f"{proc.returncode}:\n{proc.stdout[-4000:]}")
    return proc.stdout, err, secs


def add_rank_launches(counts):
    for kernel, count in counts.items():
        RANK_LAUNCHES[kernel] = RANK_LAUNCHES.get(kernel, 0) + count


def phase_bench():
    """`python -m wgatools_tpu_torch.bench` as a user runs it: it must pass
    its seven gates and print one JSON line with bench.py's metric and a
    value in (0, the card's roofline guard]."""
    from wgatools_tpu_torch import bench

    out, err, secs = run_program(["wgatools_tpu_torch.bench"])
    gates_ok = sum("parity gate: OK" in line for line in err)
    if gates_ok != 7:
        raise AssertionError(f"bench: {gates_ok} of its 7 gates passed")
    lines = out.strip().splitlines()
    result = json.loads(lines[-1])
    B, L = bench.CARD_SHAPE
    guard = bench.roofline_columns_per_s(B, L, L // 32 // bench.GROUP) / 1e9
    if (len(lines) != 1 or result["metric"] != bench.METRIC
            or not 0 < result["value"] <= guard):
        raise AssertionError(f"bench printed {out!r} (guard {guard:.3f} "
                             "Gbp/s)")
    log(f"bench: {lines[-1]} (roofline guard {guard:.3f} Gbp/s), "
        f"{secs:.3f} s of process")
    add_rank_launches(logged_launches(err))


def phase_p2c_headline(work):
    """The p2c headline's PAF (scripts.p2c_headline.build: ~2.18 Gbp in
    ~2000 records of 1000 CIGAR runs) through the port's `paf2chain` on the
    card against the host engine's bytes."""
    from wgatools_tpu_torch.io.compression import open_input, open_output
    from wgatools_tpu_torch.io.paf import PafReader
    from wgatools_tpu_torch.scripts.p2c_headline import build
    from wgatools_tpu_torch.tools.convert import paf2chain

    paf = os.path.join(work, "p2c_headline.paf")
    out = os.path.join(work, "p2c_headline.chain")
    t0 = time.perf_counter()
    records, cols = build(paf)
    log(f"p2c headline: wrote {records} records, {cols / 1e9:.3f} Gbp of "
        f"aligned columns, {os.path.getsize(paf)} B of PAF in "
        f"{time.perf_counter() - t0:.3f} s")
    secs = run_cli(["paf2chain", paf, "-o", out, "-r"])
    compare_with_host("p2c headline paf2chain", [out], lambda w: paf2chain(
        PafReader(open_input(paf)), open_output(w[0], True), None), secs)
    os.remove(paf)
    os.remove(out)


def phase_scaling(n_ranks):
    """`python -m wgatools_tpu_torch.scripts.scaling_bench --nproc
    n_ranks` at its defaults: one JSON line per group size with the TPU
    script's keys, every rank of every size on NCCL."""
    from wgatools_tpu_torch.scripts.scaling_bench import group_sizes

    out, err, secs = run_program(
        ["wgatools_tpu_torch.scripts.scaling_bench", "--nproc", str(n_ranks)])
    rows = [json.loads(line) for line in out.strip().splitlines()]
    sizes = group_sizes(n_ranks)
    if [r.get("devices") for r in rows] != sizes or any(
            set(r) != {"devices", "gcols_per_s", "scaling_efficiency"}
            or not r["gcols_per_s"] > 0 for r in rows):
        raise AssertionError(f"scaling_bench printed {out!r}")
    for n in sizes:
        for k in range(n):
            if f"rank {k}/{n}: backend nccl" not in "\n".join(err):
                raise AssertionError(f"scaling_bench: rank {k}/{n} logged no "
                                     "NCCL backend")
    log(f"scaling: {rows}, {secs:.3f} s of process")
    add_rank_launches(logged_launches(err))


def phase_fuzz():
    """`python -m wgatools_tpu_torch.scripts.fuzz_campaign` on the card at
    FUZZ_SEED, FUZZ_ITERS cases a property (kernel properties included):
    it must exit 0 and print the seven PASS lines; the launches it logs
    count here."""
    from wgatools_tpu_torch.scripts.fuzz_campaign import PROPS

    out, err, secs = run_program(
        ["wgatools_tpu_torch.scripts.fuzz_campaign", "--iters",
         str(FUZZ_ITERS), "--seed", str(FUZZ_SEED)])
    want = [f"PASS {name}: {FUZZ_ITERS} cases" for name in PROPS]
    if out.splitlines() != want:
        raise AssertionError(f"fuzz_campaign printed {out!r}")
    log(f"fuzz: {len(want)} properties x {FUZZ_ITERS} cases (seed "
        f"{FUZZ_SEED}) passed, {secs:.3f} s of process")
    add_rank_launches(logged_launches(err))


def phase_scale_configs(work):
    """`python -m wgatools_tpu_torch.scripts.scale_configs` at its defaults
    (BASELINE configs 3-4: a 128 x 800 000-column MAF, a 60 000 x 60-run
    PAF): every row serial on the card, `-t 4`, and under WGA_TPU_DIST on
    min(cards, 2) NCCL ranks; every md5 cross-check must hold (the program
    raises otherwise) and `pafcov (serial)` must have launched kernel B.
    The launches its rows logged count here."""
    out, err, secs = run_program(
        ["wgatools_tpu_torch.scripts.scale_configs", "--out",
         os.path.join(work, "scale_configs")], timeout=SCALE_TIMEOUT_S)
    table = [line for line in out.splitlines() if line.startswith("| `")]
    checks = [line for line in table if "bytes==serial" in line]
    if len(table) != 12 or len(checks) != 6 or any(
            "bytes==serial: True" not in line for line in checks):
        raise AssertionError(f"scale_configs printed {out!r}")
    rows = {}
    for line in err:  # "[scale_configs] <row>: <wall> s, launched {json}"
        if ", launched " in line:
            head, counts = line.split(", launched ", 1)
            rows[head.split("] ", 1)[1].rsplit(": ", 1)[0]] = json.loads(counts)
    if not rows.get("pafcov (serial)", {}).get("liftover_scan"):
        raise AssertionError("scale_configs: pafcov (serial) did not launch "
                             "kernel B")
    for line in table:
        log(f"scale configs {line}")
    log(f"scale configs: {secs:.3f} s of process")
    add_rank_launches(logged_launches(err))


def profile_tools(work, out_dir):
    """--profile: the tools once more on the phases' inputs,
    timed plain, then under torch.profiler (device time by kernel and copy)
    and under cProfile (host time by function).  Full tables go to
    out_dir/profile.txt, a summary to stdout."""
    import cProfile
    import pstats

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    report_path = os.path.join(out_dir, "profile.txt")
    with open(report_path, "w") as report:
        for name, argv in (
            ("stat", ["stat", os.path.join(work, "smoke.maf"),
                      "-o", os.path.join(work, "prof.tsv"), "-r"]),
            ("paf2chain", ["paf2chain", os.path.join(work, "smoke.paf"),
                           "-o", os.path.join(work, "prof.chain"), "-r"]),
            ("maf2paf", ["maf2paf", os.path.join(work, "smoke.maf"),
                         "-o", os.path.join(work, "prof.paf"), "-r"]),
            ("call", call_argv(work, None, "prof.vcf")),
            ("call -c 16000000", call_argv(work, 16_000_000, "prof.vcf")),
            ("pafcov", ["pafcov", os.path.join(work, "smoke.paf"),
                        "-o", os.path.join(work, "prof.bed"), "-r"]),
            ("validate", ["validate", os.path.join(work, "bad.paf"),
                          "-o", os.path.join(work, "prof.txt"), "-r"]),
        ):
            plain = run_cli(argv)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                traced = run_cli(argv)
                torch.cuda.synchronize()
            events = prof.key_averages()
            # kernels and copies only, as torch's own table totals them: a
            # host op's self device time repeats that of what it launched
            on_device = sorted(
                (e for e in events if e.device_type == DeviceType.CUDA
                 and not e.is_user_annotation),
                key=lambda e: -e.self_device_time_total,
            )
            busy_ms = sum(e.self_device_time_total for e in on_device) / 1e3
            log(f"profile {name}: wall {plain:.3f} s plain, {traced:.3f} s "
                f"under torch.profiler; device busy {busy_ms:.3f} ms, idle "
                f"{100 * (1 - busy_ms / 1e3 / plain):.2f}% of the plain wall")
            for e in on_device:
                log(f"  device {e.self_device_time_total / 1e3:9.3f} ms "
                    f"x{e.count:<4} {e.key[:70]}")
            report.write(f"== {name}: torch.profiler, wall {traced:.3f} s\n")
            report.write(events.table(sort_by="self_device_time_total",
                                      row_limit=20))
            cprof = cProfile.Profile()
            t0 = time.perf_counter()
            cprof.runcall(run_cli, argv)
            host = time.perf_counter() - t0
            table = io.StringIO()
            stats = pstats.Stats(cprof, stream=table)
            stats.sort_stats("tottime").print_stats(20)
            report.write(f"\n== {name}: cProfile, wall {host:.3f} s\n")
            report.write(table.getvalue())
            log(f"profile {name}: wall {host:.3f} s under cProfile; top host "
                f"functions by own time:")
            # stats.stats: (file, line, function) -> (cc, ncalls, tottime, ...)
            top = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:8]
            for (path, line, func), (_, ncalls, own, *_) in top:
                log(f"  host {own:8.3f} s x{ncalls:<7} "
                    f"{os.path.basename(path)}:{line}({func})")
    log(f"profile tables: {report_path}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="DIR",
                    help="after the checks, profile `stat`, `paf2chain`, "
                    "`maf2paf`, `call`, `pafcov` and `validate` on the device "
                    "and the host; tables go to DIR/profile.txt")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from wgatools_tpu_torch.kernels import _build
    from wgatools_tpu_torch.scripts import make_corpus as corpus

    device = torch.device("cuda", 0)
    os.environ["WGA_TORCH_DEVICE"] = "cuda"
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib_path = os.path.join(_build.BUILD_DIR, _build.LIB_NAME)
    if os.path.exists(lib_path):
        os.remove(lib_path)  # build from the checkout's sources, every run
    _build.lib()
    log(f"build: {time.perf_counter() - t0:.3f} s")
    with open(os.path.join(_build.BUILD_DIR, "nvcc.log")) as f:
        for line in f:
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("  " + line.strip())

    rng = np.random.default_rng(args.seed)
    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    n_ranks = min(torch.cuda.device_count(), MAX_RANKS)
    gates = Gates()
    times = {}
    try:
        t0 = time.perf_counter()
        bench = phase_kernels(rng, device, gates, times)
        log(f"phase kernels: ok in {time.perf_counter() - t0:.3f} s")

        # each phase, with the kernels its path must launch; the counts are
        # set to 0 just before it and read just after
        launched = {name: 0 for name in _build.LAUNCHES}
        for name, phase, kernels in (
            ("stat", lambda: phase_stat(work, corpus, rng), ["classify_cat"]),
            ("paf2chain", lambda: phase_paf2chain(work, corpus, rng),
             ["liftover_scan"]),
            ("pafcov", lambda: phase_pafcov(work), ["liftover_scan"]),
            ("paf2chain long records",
             lambda: phase_paf2chain_long(work, corpus, rng),
             ["liftover_scan"]),
            ("stat -f paf", lambda: phase_stat_paf(work), []),
            ("validate", lambda: phase_validate(work), []),
            ("chain2paf", lambda: phase_chain2paf(work), []),
            ("fused", lambda: phase_fused(device, bench), ["fused_adv16"]),
            ("fused_ops", lambda: phase_fused_ops(device, bench),
             ["fused_ops"]),
            ("maf2paf", lambda: phase_maf_tool(work, "maf2paf"),
             ["classify_cat"]),
            ("maf2chain", lambda: phase_maf_tool(work, "maf2chain"),
             ["classify_cat"]),
            ("call", lambda: phase_call(work, rng, None), ["classify_cat"]),
            ("call -c 16000000", lambda: phase_call(work, rng, 16_000_000),
             ["classify_bytes"]),
            ("sharded", lambda: phase_sharded(work, device, rng, gates,
                                              bench["full"]),
             ["classify_words", "classify_nibbles", "fused16", "fused_adv16",
              "classify_bytes", "liftover_scan"]),
            ("distributed", lambda: phase_distributed(work, n_ranks),
             ["classify_cat"]),
            ("entry", lambda: phase_entry(device, gates), ["fused16"]),
            ("bench", phase_bench,
             ["fused_adv16", "classify_bytes", "classify_words",
              "classify_cat", "liftover_scan"]),
            ("p2c headline", lambda: phase_p2c_headline(work),
             ["liftover_scan"]),
            ("scaling", lambda: phase_scaling(n_ranks), ["classify_words"]),
            ("fuzz", phase_fuzz,
             ["classify_cat", "classify_bytes", "classify_words",
              "classify_nibbles", "liftover_scan", "fused16", "fused_adv16",
              "fused_ops"]),
            ("scale configs", lambda: phase_scale_configs(work),
             ["liftover_scan"]),
        ):
            _build.reset_launches()
            RANK_LAUNCHES.clear()
            t0 = time.perf_counter()
            phase()
            # this process's launches and those its programs' processes
            # logged
            counts = {kernel: count + RANK_LAUNCHES.get(kernel, 0)
                      for kernel, count in _build.LAUNCHES.items()}
            log(f"phase {name}: ok in {time.perf_counter() - t0:.3f} s, "
                f"launches {counts}")
            for kernel in kernels:
                if counts[kernel] == 0:
                    raise AssertionError(f"{name} did not launch kernel {kernel}")
            for kernel, count in counts.items():
                launched[kernel] += count
        if args.profile:
            profile_tools(work, os.path.abspath(args.profile))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"launches on the tool phases: {launched}")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    csrc = "wgatools_tpu_torch/csrc"
    kernels = [
        ("classify_cat", "classify_cat.cu", "wgatools_tpu/ops/classify.py:1097"),
        ("classify_bytes", "classify_bytes.cu", "wgatools_tpu/ops/classify.py:247"),
        ("liftover_scan", "liftover_scan.cu", "wgatools_tpu/ops/liftover.py:266"),
        ("fused_adv16", "fused_adv16.cu", "wgatools_tpu/ops/fused.py:662"),
        ("classify_words", "classify_bytes.cu", "wgatools_tpu/ops/classify.py:545"),
        ("classify_nibbles", "classify_nibbles.cu",
         "wgatools_tpu/ops/classify.py:825"),
        ("fused16", "fused16.cu", "wgatools_tpu/ops/fused.py:534"),
        ("fused_ops", "fused_ops.cu", "wgatools_tpu/ops/fused.py:822"),
    ]
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": f"{csrc}/{src}",
            "replaces": replaces,
            "launches": launched[name],
            "max_abs_err": gates.max_err[name],
            "ms": times[name][0],
            "plain_ms": times[name][1],
            "bound_ms": bound(name)[0],
            "bound_by": bound(name)[1],
            # no single PyTorch call computes any of these functions: each
            # needs the LUT categories and run boundaries or the op decode
            "library_ms": None,
        }
        for name, src, replaces in kernels
    ]}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
