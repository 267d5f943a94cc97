#!/usr/bin/env python3
"""Times of the port's eight CUDA kernels at chip_smoke.py's main-path
shapes, for one or more checkouts, in alternation on one card.

    python3 wgatools_tpu_torch/scripts/kernel_times.py [--seed N]
        [--order 0,1,1,0] [--out FILE] TREE ...

Each TREE is the root of a checkout of this repository: this one, or an
earlier commit unpacked with `git archive` into a directory that
.gitignore lists (a variant to time, such as another constant in csrc/,
is such a copy with the change patched in).  Each entry of --order
(indices into the trees; by default each tree in turn, then again in
reverse) is one child process that imports that tree's
wgatools_tpu_torch, builds its kernels from the tree's sources into the
tree's own build directory, makes the inputs from the seed (the same in
every process), holds each kernel's output against its plain version
there, and times it with time_ms.  Only the public ops are called, so a
tree whose C entry points differ is timed all the same.  Each child
prints one JSON line {"tree", "build_s", "ms"}; the command then prints
one line a timed call with every run's ms, the card's name and power
limit, and, last, {"runs": [...], "card": "..."}, which --out also
receives.  Exits 2 without CUDA.

chip_smoke.py takes its main-path shapes (Shapes) and its timing loop
(time_ms) from here, so that both time the kernels at the same sizes in
the same way.

The shapes (chip_smoke.py's): A on a category plane of 128 x 2^20 columns;
D on one caller-mode row of 12 500 003 columns; B on 8192 x 128 ops in
chain mode; C in bench.py's configuration (the category plane, raw group-8
sums of 2^15 ops a row); D's word entry, E and F on the byte words and
nibble words of the same columns, F with 2^14 packed op pairs a row; 8 on
the byte words with 128 x 2^15 ops in both op forms, and its column and
op-row parts alone.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np

HERE = os.path.abspath(__file__)


@dataclass(frozen=True)
class Shapes:
    """The main path's kernel shapes, chip_smoke.py's and this script's."""

    B: int = 128  # bench.py's batch: B rows x L columns
    L: int = 1 << 20
    call_row: int = 12_500_003  # kernel D's call-route row
    scan_rows: int = 8192  # kernel B's paf2chain batch
    scan_n: int = 128
    n_ops: int = 1 << 15  # ops a row of the fused kernels F and 8


def default_order(n):
    """Each tree in turn, then again in reverse: 0, 1, 1, 0 for two."""
    return list(range(n)) + list(range(n))[::-1]


def card_name_and_limit():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return smi.stdout.strip().splitlines()[0]


def time_ms(fn, reps=20, rounds=5):
    """Device time of one fn() call in ms: the median over `rounds` of CUDA
    event windows around `reps` back-to-back calls, divided by `reps`.
    The card spins (torch.cuda._sleep) while the host queues the calls, so
    a window holds the calls' device time and not the host's launch cost.
    A child runs this file's copy whatever the tree it times."""
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


def measure(device, seed, shapes, timer):
    """{label: timer(kernel call)} at `shapes`, each call first held bit for
    bit against its plain version on the same inputs."""
    import torch

    from wgatools_tpu_torch.ops import classify as C
    from wgatools_tpu_torch.ops import fused as F
    from wgatools_tpu_torch.ops import liftover as LO

    rng = np.random.default_rng(seed)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    ms = {}

    def timed(label, fn, ref):
        for g, w in zip(fn(), ref()):
            if g.shape != w.shape or not torch.equal(g, w):
                raise AssertionError(f"{label}: differs from the plain version")
        ms[label] = timer(fn)

    B, L = shapes.B, shapes.L
    alphabet = np.frombuffer(b"ACGT-", np.uint8)
    t = alphabet[rng.integers(0, 5, (B, L))]
    q = alphabet[rng.integers(0, 5, (B, L))]
    lens_np = (L - rng.integers(0, min(4096, L), B)).astype(np.int32)
    lens_np[0] = L
    lens = up(lens_np)
    cw = up(C.pack_cat_nibbles(t, q))
    timed("A classify_cat", lambda: [C.classify_stat_cat(cw, lens)],
          lambda: [C.classify_stat_cat_ref(cw, lens)])

    bench_ops = np.frombuffer(b"M=XID", np.uint8)[
        rng.integers(0, 5, (B, L // 32))]
    st, sq = (up(a) for a in LO.pack_ops_sums(
        bench_ops, np.full(bench_ops.shape, 32, np.int32), group=8))
    timed("C fused_adv16 bench config",
          lambda: F.classify_liftover_fused_adv16(
              cw, None, lens, st, sq, device, catmode=True, raw_sums=True),
          lambda: F.classify_liftover_fused_adv16_ref(
              cw, None, lens, st, sq, catmode=True, raw_sums=True))
    del cw, st, sq

    tw, qw = up(t.view("<i4")), up(q.view("<i4"))
    timed("D classify_words", lambda: [C.classify_stat_words(tw, qw, lens)],
          lambda: [C.classify_stat_words_ref(tw, qw, lens)])
    tn, qn = (up(a) for a in C.pack_nibble_words(t, q))
    timed("E classify_nibbles",
          lambda: [C.classify_stat_nibbles(tn, qn, lens)],
          lambda: [C.classify_stat_nibbles_ref(tn, qn, lens)])
    del t, q

    ops_np = np.frombuffer(b"M=XIDS", np.uint8)[
        rng.integers(0, 6, (B, shapes.n_ops))]
    op_lens_np = rng.integers(0, 8192, (B, shapes.n_ops)).astype(np.int32)
    op_lens_np[:, 0] = 8191
    opw16 = up(LO.pack_ops_words16(ops_np, op_lens_np))
    timed("F fused16 nibbles",
          lambda: F.classify_liftover_fused16(tn, qn, lens, opw16, device,
                                              nibble=True),
          lambda: F.classify_liftover_fused16_ref(tn, qn, lens, opw16,
                                                  nibble=True))
    timed("F fused16 words",
          lambda: F.classify_liftover_fused16(tw, qw, lens, opw16, device),
          lambda: F.classify_liftover_fused16_ref(tw, qw, lens, opw16))
    del tn, qn, opw16

    ops, op_lens = up(ops_np), up(op_lens_np)
    opw = up(LO.pack_ops_words(ops_np, op_lens_np))
    one = tw[:, :1].contiguous()
    no_cols = torch.zeros(B, dtype=torch.int32, device=device)
    for form, args in (("u8+i32", (ops, op_lens)), ("packed", (opw, None))):
        for part, planes in (("", (tw, qw, lens)),
                             (" op rows alone", (one, one, no_cols))):
            timed(f"8 fused_ops {form}{part}",
                  lambda: F.classify_liftover_fused(*planes, *args, device),
                  lambda: F.classify_liftover_fused_ref(*planes, *args))
    timed("8 fused_ops columns alone",
          lambda: F.classify_liftover_fused(tw, qw, lens, ops[:0],
                                            op_lens[:0], device),
          lambda: F.classify_liftover_fused_ref(tw, qw, lens, ops[:0],
                                                op_lens[:0]))
    del tw, qw, ops, op_lens, opw

    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 2**31)))
    letters = torch.tensor(list(b"ACGTN-"), dtype=torch.uint8, device=device)
    n = shapes.call_row
    rt = letters[torch.randint(0, 6, (1, n), generator=gen, device=device)]
    other = letters[torch.randint(0, 6, (1, n), generator=gen, device=device)]
    keep = torch.rand((1, n), generator=gen, device=device) < 0.7
    rq = torch.where(keep, rt, other)
    rn = torch.tensor([n], dtype=torch.int32, device=device)
    timed("D classify_bytes call row",
          lambda: [C.classify_stat_bytes(rt, rq, rn, True)],
          lambda: [C.classify_stat_bytes_ref(rt, rq, rn, True)])
    del rt, rq, other, keep

    R, N = shapes.scan_rows, shapes.scan_n
    s_ops = np.frombuffer(b"M=XIDSNH", np.uint8)[rng.integers(0, 8, (R, N))]
    s_ops[np.arange(N)[None, :] >= rng.integers(1, N + 1, R)[:, None]] = 0
    s_lens = rng.integers(0, 2000, (R, N)).astype(np.int32)
    s_lens[s_ops == 0] = 0
    so, sl = up(s_ops), up(s_lens)
    timed("B liftover_scan chain", lambda: LO.chain_scan(so, sl),
          lambda: LO.liftover_scan_ref(so, sl, "chain"))
    return ms


def run_one(tree, seed):
    """The child: time `tree`'s kernels; one JSON line on stdout."""
    import torch

    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.environ["WGA_TORCH_DEVICE"] = "cuda"
    os.environ.pop("WGA_TPU_DEVICE", None)
    from wgatools_tpu_torch.kernels import _build

    if not os.path.dirname(_build.__file__).startswith(tree):
        raise RuntimeError(f"imported {_build.__file__}, not {tree}'s")
    t0 = time.perf_counter()
    _build.lib()
    build_s = time.perf_counter() - t0
    ms = measure(torch.device("cuda", 0), seed, Shapes(), time_ms)
    print(json.dumps({"tree": tree, "build_s": build_s, "ms": ms}),
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="+", metavar="TREE")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--order", help="comma-separated tree indices")
    ap.add_argument("--out", help="also write the last line here")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_times: torch.cuda.is_available() is False; this "
              "script times CUDA kernels only", file=sys.stderr)
        return 2
    if args.child:
        run_one(args.trees[0], args.seed)
        return 0
    order = ([int(k) for k in args.order.split(",")] if args.order
             else default_order(len(args.trees)))
    runs = []
    for k in order:
        proc = subprocess.run(
            [sys.executable, HERE, "--child", "--seed", str(args.seed),
             args.trees[k]],
            stdout=subprocess.PIPE, text=True, check=True,
        )
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    card = card_name_and_limit()
    names = [args.trees[k] for k in order]
    print(f"runs: {names} on {card}")
    for label in runs[0]["ms"]:
        cells = " ".join(f"{r['ms'][label] * 1e3:9.2f}" for r in runs)
        print(f"{label:34s} us: {cells}")
    result = json.dumps({"runs": runs, "card": card})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(result + "\n")
    print(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
