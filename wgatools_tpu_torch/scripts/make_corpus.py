"""Fast numpy-based synthetic corpus generator for profiling.

The counterpart of scripts/make_corpus.py: the same generator, draws and
bytes at the same flags.  Builds coordinate-consistent MAF / PAF / FASTA
inputs at profiling scale (hundreds of Mbp) in seconds.  Alignments are
'='/'X'/'I'/'D' run tables with geometric run lengths, realized into
gapped sequences with vectorized numpy.  `write_corpus` writes what the script's command line writes for the same
flags.
"""

import os

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
GAP = ord("-")


def run_table(rng, n_runs, mean_len=18, sv_every=0):
    """(vals, lens): vals in {'=','X','I','D'} as bytes; no two adjacent
    same ops; starts and ends with '='."""
    ops = np.frombuffer(b"=XID", dtype=np.uint8)
    # random walk over op indices avoiding repeats
    idx = rng.integers(1, 4, size=n_runs)
    idx = (np.cumsum(idx) % 4).astype(np.int64)
    vals = ops[idx]
    lens = rng.geometric(1.0 / mean_len, size=n_runs).astype(np.int64)
    if sv_every:
        big = rng.integers(0, n_runs, size=max(1, n_runs // sv_every))
        lens[big] += rng.integers(60, 4000, size=big.shape[0])
    # force match bookends
    vals[0] = vals[-1] = ord("=")
    return vals, lens


def realize(rng, vals, lens):
    """Gapped t/q alignment rows (uint8) for a run table."""
    total = int(lens.sum())
    cat = np.repeat(vals, lens)
    t = BASES[rng.integers(0, 4, size=total)]
    q = t.copy()
    x = cat == ord("X")
    # mismatch: offset base by 1..3
    q[x] = BASES[(np.searchsorted(BASES, q[x]) + rng.integers(1, 4, size=int(x.sum()))) % 4]
    t[cat == ord("I")] = GAP
    q[cat == ord("D")] = GAP
    return t, q


def cg_string(vals, lens, ext=True):
    """CIGAR text from run table ('='/'X' kept if ext else merged to M)."""
    if not ext:
        m = (vals == ord("=")) | (vals == ord("X"))
        vals = np.where(m, ord("M"), vals)
        keep = np.ones(len(vals), dtype=bool)
        keep[1:] = vals[1:] != vals[:-1]
        grp = np.cumsum(keep) - 1
        lens = np.bincount(grp, weights=lens).astype(np.int64)
        vals = vals[keep]
    parts = []
    for v, ln in zip(vals.tolist(), lens.tolist()):
        parts.append(f"{ln}{chr(v)}")
    return "".join(parts)


def make_maf(path, rng, n_records, n_cols_each):
    with open(path, "w") as f:
        f.write("##maf version=1.6\n")
        t_off = 1000
        for i in range(n_records):
            n_runs = max(3, n_cols_each // 18)
            vals, lens = run_table(rng, n_runs)
            scale = n_cols_each / max(1, int(lens.sum()))
            lens = np.maximum(1, (lens * scale).astype(np.int64))
            t, q = realize(rng, vals, lens)
            t_len = int((t != GAP).sum())
            q_len = int((q != GAP).sum())
            f.write("a score=0\n")
            f.write(
                f"s\tref.chr1\t{t_off}\t{t_len}\t+\t1000000000\t"
                + t.tobytes().decode("ascii")
                + "\n"
            )
            f.write(
                f"s\tq{i % 4}.chr1\t{t_off}\t{q_len}\t+\t1000000000\t"
                + q.tobytes().decode("ascii")
                + "\n\n"
            )
            t_off += t_len + 10
    return path


T_GENOME = 3_100_000
Q_GENOME = 3_100_000


def make_paf(path, rng, n_records, n_runs, mean_len=18):
    """Coordinate-consistent PAF vs fixed T_GENOME/Q_GENOME-sized
    sequences (paf2maf / validate-with-FASTA compatible)."""
    lines = []
    t_off = 0
    for i in range(n_records):
        vals, lens = run_table(rng, n_runs, mean_len=mean_len)
        m = int(lens[vals == ord("=")].sum())
        tl = int(lens[(vals == ord("=")) | (vals == ord("X")) | (vals == ord("D"))].sum())
        ql = int(lens[(vals == ord("=")) | (vals == ord("X")) | (vals == ord("I"))].sum())
        blk = int(lens.sum())
        cg = cg_string(vals, lens)
        strand = "+" if (i % 5) else "-"
        qs = 100 + (i % 7)
        if t_off + tl >= T_GENOME:
            t_off = 0
        lines.append(
            f"q{i % 16}\t{Q_GENOME}\t{qs}\t{qs + ql}\t{strand}\t"
            f"t{i % 8}\t{T_GENOME}\t{t_off}\t{t_off + tl}\t{m}\t{blk}\t60\t"
            f"NM:i:{blk - m}\tcg:Z:{cg}"
        )
        t_off += tl + 50
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def make_fastas(outdir, rng):
    """t.fa (t0..t7) and q.fa (q0..q15), each T_GENOME/Q_GENOME bases,
    60-col lines -- big.paf's coordinates resolve inside them."""
    paths = []
    for fname, names, size in (
        ("t.fa", [f"t{j}" for j in range(8)], T_GENOME),
        ("q.fa", [f"q{j}" for j in range(16)], Q_GENOME),
    ):
        p = os.path.join(outdir, fname)
        with open(p, "wb") as f:
            for name in names:
                f.write(b">" + name.encode() + b"\n")
                seq = BASES[rng.integers(0, 4, size=size)]
                for k in range(0, size, 60):
                    f.write(seq[k : k + 60].tobytes() + b"\n")
        paths.append(p)
    return paths


def write_corpus(out, maf_records=256, maf_cols=200_000, paf_records=50_000,
                 paf_runs=40, seed=0):
    """big.maf, big.paf, t.fa and q.fa in `out`, as `scripts/make_corpus.py
    --out out ...` writes them; returns their paths."""
    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(seed)
    maf = make_maf(os.path.join(out, "big.maf"), rng, maf_records, maf_cols)
    paf = make_paf(os.path.join(out, "big.paf"), rng, paf_records, paf_runs)
    return [maf, paf] + make_fastas(out, rng)
