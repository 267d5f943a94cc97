"""The reference's own headline benchmark on the port: `paf2chain` on a
whole-genome PAF of ~2.18 Gbp of aligned columns.

The counterpart of scripts/p2c_headline.py.  The reference's published
number is `wgatools p2c` on the maize Zm-CML333 whole-genome PAF, mean
3.69 s on the authors' workstation (BASELINE.md).  `build` writes a PAF of
the same aligned-column volume and record shape (~2000 records x 1000
CIGAR runs, geometric run lengths of mean 1090), byte for byte the TPU
script's; `main` times the port's command line `paf2chain` on it (the
device route, kernel B, on the card unless WGA_TORCH_DEVICE=cpu; an
inherited WGA_TPU_DEVICE is removed), wall clock of the whole process,
best of 3, and prints the TPU script's two lines.  A third line times the
same command best of 3 under WGA_TPU_DEVICE=0, the host engine in a
process without torch: the route the TPU script timed.  Both routes must
write the same bytes.  Work files go to build/p2c_headline/.

    python -m wgatools_tpu_torch.scripts.p2c_headline
"""

import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORK = os.path.join(REPO, "build", "p2c_headline")
REFERENCE_SECONDS = 3.69


def build(path, target=2_180_000_000, seed=7):
    """Write records of 1000 CIGAR runs (=, X, I, D, never one op twice in
    a row; lengths geometric, mean 1090) until `target` aligned columns;
    returns (records, columns)."""
    rng = np.random.default_rng(seed)
    total = 0
    k = 0
    lines = []
    while total < target:
        n = 1000
        ops = np.array(list("=XID"))[
            np.concatenate([[0], rng.integers(1, 4, n - 1)]).cumsum() % 4
        ]
        lens = rng.geometric(1 / 1090, n)
        tadv = int(lens[(ops == "=") | (ops == "X") | (ops == "D")].sum())
        qadv = int(lens[(ops == "=") | (ops == "X") | (ops == "I")].sum())
        cols = int(lens.sum())
        total += cols
        cg = "".join(f"{l}{o}" for o, l in zip(ops, lens))
        m = int(lens[ops == "="].sum())
        lines.append(
            f"q{k}\t{qadv}\t0\t{qadv}\t+\tt{k}\t{tadv}\t0\t{tadv}\t"
            f"{m}\t{cols}\t60\tcg:Z:{cg}\n"
        )
        k += 1
    with open(path, "w") as f:
        f.write("".join(lines))
    return k, total


def main():
    os.makedirs(WORK, exist_ok=True)
    paf = os.path.join(WORK, "p2c_headline.paf")
    out = os.path.join(WORK, "p2c_headline.chain")
    k, total = build(paf)
    print(f"{k} records, {total / 1e9:.3f} Gbp aligned columns", flush=True)
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("WGA_TPU_DEVICE", None)
    best = min(_one(paf, out, env) for _ in range(3))
    print(f"paf2chain wall {best:.2f} s  (reference p2c: "
          f"{REFERENCE_SECONDS} s -> {REFERENCE_SECONDS / best:.2f}x)",
          flush=True)
    host_out = out + ".host"
    host = min(_one(paf, host_out, dict(env, WGA_TPU_DEVICE="0"))
               for _ in range(3))
    with open(out, "rb") as f, open(host_out, "rb") as g:
        if f.read() != g.read():
            raise RuntimeError("paf2chain: the host route's bytes differ "
                               "from the device route's")
    print(f"paf2chain wall {host:.2f} s on the host engine "
          f"(WGA_TPU_DEVICE=0)  (reference p2c: {REFERENCE_SECONDS} s -> "
          f"{REFERENCE_SECONDS / host:.2f}x)")
    return 0


def _one(paf, out, env):
    t0 = time.perf_counter()
    subprocess.run(
        [sys.executable, "-m", "wgatools_tpu_torch", "paf2chain", paf,
         "-o", out, "-r"],
        check=True, env=env, cwd=REPO,
    )
    return time.perf_counter() - t0


if __name__ == "__main__":
    sys.exit(main())
