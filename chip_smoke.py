#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (wgatools_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N] [--profile DIR]

Builds the port's CUDA kernels from wgatools_tpu_torch/csrc/ and then:

1. gates each kernel bit for bit against its plain PyTorch version on the
   card, at the shapes the main path gives it and at edge shapes, and
   times both;
2. runs `stat` and `stat -e` through the port's command line on a ~100 Mbp
   MAF made from the seed, and checks the bytes against the host engine;
3. runs `paf2chain` the same way on a 100 000-record PAF;
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
   multi-rank semantics are held on the CPU with gloo (tests).

Launch counts are reset before each tool phase and read after it: every
kernel of that phase's path must have launched there.  With --profile,
`stat`, `paf2chain`, `maf2paf`, both `call` runs, `pafcov` and `validate`
then run once more
under torch.profiler and cProfile, with a summary printed and the tables
written to DIR/profile.txt.  The reference for the tool bytes is the TPU
package's jax-free host engine, which shares the output formatting code
with the port: the byte comparison checks the per-record counters, run
tables and the chain-line arithmetic, not the formatting.

The last three lines are a JSON object listing each kernel (launches on
the tool phases, max error, times), the card's name and power limit, and
the JSON result line.  Any failed check raises, so the exit code is not 0;
without CUDA the script exits 2 and prints no result.  Needs one card;
work files go to build/chip_smoke/ and are removed at the end.
"""

import argparse
import importlib.util
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
# kernel C's modes besides bench.py's (catmode, raw sums): label, flags
ADV16_MODES = (
    ("pairs+odd", dict()),
    ("pairs", dict(emit_odd=False)),
    ("raw", dict(raw_sums=True)),
)


def log(msg):
    print(msg, flush=True)


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


def load_corpus_module():
    spec = importlib.util.spec_from_file_location(
        "make_corpus", os.path.join(REPO, "scripts", "make_corpus.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    # kernel B edge shapes: B=9 with N not a tile multiple and lengths
    # past 2^16, B=1, an all-padding row
    for rows, n in ((9, 1000), (1, 3), (3, 129)):
        e_ops = op_chars[rng.integers(0, 8, size=(rows, n))]
        e_ops[-1, :] = 0
        e_lens = rng.integers(0, 200_000, size=(rows, n)).astype(np.int32)
        for name, fn in (("liftover", liftover_scan), ("chain", chain_scan)):
            gates.check(
                "liftover_scan", f"edge {rows}x{n} mode={name}",
                fn(up(e_ops), up(e_lens)),
                liftover_scan_ref(up(e_ops), up(e_lens), name),
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
        rows, n = int(rng.integers(1, 64)), int(rng.integers(1, 3000))
        f_ops = up(rng.integers(0, 256, (rows, n)).astype(np.uint8))
        f_lens = up(rng.integers(0, 1 << 19, (rows, n)).astype(np.int32))
        for name, fn in (("liftover", liftover_scan), ("chain", chain_scan)):
            gates.check("liftover_scan", f"random {k} {rows}x{n} mode={name}",
                        fn(f_ops, f_lens), liftover_scan_ref(f_ops, f_lens, name))
    gate_classify_bytes(rng, device, gates, times)
    full = gate_plane_kernels(rng, device, gates, times, t0, q0, cw_np,
                              lens_np)
    gate_fused_ops(rng, device, gates, times, full)
    return {"cw": cw, "lens": lens, "ops": bench_ops, "op_lens": bench_lens,
            "full": full}


def shifted(a, offset):
    """A contiguous copy of tensor `a` whose data starts `offset` bytes past
    an allocation's (aligned) start."""
    import torch

    buf = torch.empty(a.numel() + offset, dtype=torch.uint8, device=a.device)
    out = buf[offset:].view(a.shape)
    out.copy_(a)
    return out


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
    # random shapes: arbitrary bytes ('-' frequent), lengths below 0 and
    # past the row, any base offset
    for k in range(8):
        b, L = int(rng.integers(1, 300)), int(rng.integers(1, 5000))
        raw = rng.integers(0, 256, (2, b, L)).astype(np.uint8)
        raw[rng.random((2, b, L)) < 0.3] = ord("-")
        same = rng.random((b, L)) < 0.4
        raw[1][same] = raw[0][same]
        offset = int(rng.integers(0, 4))
        t, q = shifted(up(raw[0]), offset), shifted(up(raw[1]), offset)
        n = up(rng.integers(-8, L + 16, b).astype(np.int32))
        for caller in (False, True):
            gates.check("classify_bytes",
                        f"random {k} B={b} L={L} offset={offset} caller={caller}",
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
        for caller in (False, True):
            tag = f"{label} caller={caller}"
            for kind, (fn, ref) in stats_fn.items():
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
    ms = time_ms(lambda: F.classify_liftover_fused16(
        *planes["words"], d["lens"], d["opw16"], device))
    log(f"fused16 words B={B} L={L}: kernel {ms:.5f} ms")
    for kind, pl in planes.items():
        for mode, flags in ADV16_MODES:
            words = (d["st"], d["sq"]) if flags.get("raw_sums") else (d["wt"], d["wq"])
            flags = dict(flags, nibble=kind == "nibble", catmode=kind == "cat")
            ms = time_ms(lambda: F.classify_liftover_fused_adv16(
                *pl, d["lens"], *words, device, **flags))
            log(f"fused_adv16 {kind} {mode} B={B} L={L}: kernel {ms:.5f} ms")
    for name, (ms, plain) in times.items():
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
    return host


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
    from wgatools_tpu.io.compression import open_input
    from wgatools_tpu.io.maf import MafReader
    from wgatools_tpu.tools.stat import stat_maf as host_stat_maf

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
        host_stat_maf(MafReader(open_input(maf)), want, each, device=False)
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
    from wgatools_tpu.io.compression import open_input
    from wgatools_tpu.io.paf import PafReader
    from wgatools_tpu.tools.convert import paf2chain as host_paf2chain

    paf = os.path.join(work, "smoke.paf")
    t0 = time.perf_counter()
    corpus.make_paf(paf, rng, PAF_RECORDS, PAF_RUNS)
    log(f"paf2chain: wrote {os.path.getsize(paf)} B of PAF in "
        f"{time.perf_counter() - t0:.3f} s")
    out = os.path.join(work, "smoke.chain")
    secs = run_cli(["paf2chain", paf, "-o", out, "-r"])
    t0 = time.perf_counter()
    want = io.BytesIO()
    host_paf2chain(PafReader(open_input(paf)), want, device=False)
    host_secs = time.perf_counter() - t0
    with open(out, "rb") as f:
        got = f.read()
    if got != want.getvalue():
        raise AssertionError("paf2chain: bytes differ from the host engine")
    log(f"paf2chain: ok, {len(got)} B identical; port {secs:.3f} s, "
        f"host engine {host_secs:.3f} s")


def file_digest(path):
    """(size, SHA-256) of a file, read in 64 MiB pieces."""
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 26), b""):
            h.update(block)
    return os.path.getsize(path), h.hexdigest()


def compare_with_host(name, got_paths, host_fn, secs):
    """Run host_fn(paths) (the host engine writing to files beside each
    port output), then compare every pair of files by size and SHA-256."""
    want_paths = [p + ".host" for p in got_paths]
    t0 = time.perf_counter()
    host_fn(want_paths)
    host_secs = time.perf_counter() - t0
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
    from wgatools_tpu.io.compression import open_input, open_output
    from wgatools_tpu.io.paf import PafReader
    from wgatools_tpu.tools.pafcov import pafcov as host_pafcov

    paf = os.path.join(work, "smoke.paf")
    out = os.path.join(work, "smoke.cov.bed")
    secs = run_cli(["pafcov", paf, "-o", out, "-r"])
    compare_with_host("pafcov", [out], lambda w: host_pafcov(
        PafReader(open_input(paf)), open_output(w[0], True), device=False),
        secs)
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
    from wgatools_tpu.io.compression import open_input, open_output
    from wgatools_tpu.io.paf import PafReader
    from wgatools_tpu.tools.stat import stat_paf as host_stat_paf

    bad = write_bad_paf(work)
    for each in (False, True):
        out = os.path.join(work, f"paf_stat{'_each' if each else ''}.tsv")
        secs = run_cli(["stat", "-f", "paf", bad, "-o", out, "-r"]
                       + (["-e"] if each else []))
        compare_with_host(f"stat -f paf each={each}", [out], lambda w:
                          host_stat_paf(PafReader(open_input(bad)),
                                        open_output(w[0], True), each,
                                        device=False), secs)


def phase_validate(work):
    """`validate` and `validate -f FIXED` on the altered copy of the
    paf2chain PAF (written by phase_stat_paf) against the host engine's
    bytes."""
    from wgatools_tpu.io.compression import open_input, open_output
    from wgatools_tpu.io.paf import PafReader
    from wgatools_tpu.tools.validate import validate_paf as host_validate

    bad = os.path.join(work, "bad.paf")
    report = os.path.join(work, "validate.txt")
    secs = run_cli(["validate", bad, "-o", report, "-r"])
    compare_with_host("validate", [report], lambda w: host_validate(
        PafReader(open_input(bad)), open_output(w[0], True), device=False),
        secs)
    fixed = os.path.join(work, "fixed.paf")
    secs = run_cli(["validate", bad, "-o", report, "-r", "-f", fixed])
    with open(report) as f:
        head = f.read(200)
    log("validate: " + ", ".join(head.splitlines()[:3]))
    compare_with_host("validate -f", [report, fixed], lambda w: host_validate(
        PafReader(open_input(bad)), open_output(w[0], True),
        open_output(w[1], True), True, device=False), secs)


def phase_chain2paf(work):
    """`chain2paf` on the chain the paf2chain phase wrote against the host
    engine's bytes."""
    from wgatools_tpu.io.chain import ChainReader
    from wgatools_tpu.io.compression import open_input, open_output
    from wgatools_tpu.tools.convert import chain2paf as host_chain2paf

    chain = os.path.join(work, "smoke.chain")
    out = os.path.join(work, "smoke.c2p.paf")
    secs = run_cli(["chain2paf", chain, "-o", out, "-r"])
    compare_with_host("chain2paf", [out], lambda w: host_chain2paf(
        ChainReader(open_input(chain)), open_output(w[0], True),
        device=False), secs)


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
    from wgatools_tpu.io.compression import open_input
    from wgatools_tpu.io.maf import MafReader
    from wgatools_tpu.tools import convert as host

    maf = os.path.join(work, "smoke.maf")
    out = os.path.join(work, f"smoke.{tool}")
    secs = run_cli([tool, maf, "-o", out, "-r"])
    t0 = time.perf_counter()
    want = io.BytesIO()
    getattr(host, tool)(MafReader(open_input(maf)), want, device=False)
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
    from wgatools_tpu.io.compression import open_input
    from wgatools_tpu.io.maf import MafReader
    from wgatools_tpu.tools.caller import call_var_maf

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
                 chunk_size=chunk_size)
    host_secs = time.perf_counter() - t0
    with open(argv[4], "rb") as f:
        got = f.read()
    if got != want.getvalue():
        raise AssertionError(f"call -c {chunk_size}: bytes differ from the "
                             "host engine")
    lines = got.count(b"\n")
    log(f"call -c {chunk_size}: ok, {len(got)} B ({lines} lines) identical; "
        f"port {secs:.3f} s, host engine {host_secs:.3f} s")


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
    corpus = load_corpus_module()
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
        ):
            _build.reset_launches()
            t0 = time.perf_counter()
            phase()
            counts = dict(_build.LAUNCHES)
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
