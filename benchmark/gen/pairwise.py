"""The pairwise alignment of one chromosome of two close species, written as
PAF records (`fmt="paf"`, CIGAR in the cg:Z: tag, =/X/I/D) or as MAF blocks
(`fmt="maf"`), at a stated divergence.

Block lengths (a PAF record or a MAF block each) come from a fixed set,
log-uniform between `block_min` and `block_max` columns and summing to
exactly `columns`; the seed only orders them, so every seed has the same
sizes.  Inside a block, runs of = lie between events: an aligned column is
followed by a substitution (one X column) with probability `snp_rate`, or
by an insertion or deletion (half each, geometric length of mean
`indel_mean`) with probability `indel_rate`.  Adjacent substitutions merge
into one X run, an indel has = on both sides, and every block starts and
ends with =.  Every `minus_every`-th block lies on the query's minus
strand.  Blocks follow each other along both sequences, SPACER bases
apart; each sequence's size is its span.
"""

import numpy as np

EQ, X, INS, DEL = (ord(c) for c in "=XID")
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
GAP = ord("-")
SPACER = 50
TARGET, QUERY = "hg38.chr15", "panTro6.chr15"


def block_lengths(rng, columns, block_min, block_max):
    """The fixed set of block lengths, in an order drawn from `rng`."""
    mean = (block_max - block_min) / np.log(block_max / block_min)
    n = max(1, round(columns / mean))
    lengths = block_min * (block_max / block_min) ** ((np.arange(n) + 0.5) / n)
    lengths = np.floor(lengths * columns / lengths.sum()).astype(np.int64)
    lengths[-1] += columns - lengths.sum()
    return rng.permutation(lengths)


def block_runs(rng, length, snp_rate, indel_rate, indel_mean):
    """(ops, lens) of one block of `length` columns: the CIGAR runs."""
    p = snp_rate + indel_rate
    n = int(length * p + 10 * np.sqrt(length * p)) + 16
    gaps = rng.geometric(p, n) - 1
    is_x = rng.random(n) < snp_rate / p
    ops = np.where(is_x, X, np.where(rng.random(n) < 0.5, INS, DEL)).astype(np.uint8)
    lens = np.where(is_x, 1, rng.geometric(1 / indel_mean, n))
    # = before the first event, and on both sides of every indel
    need = ~is_x
    need[1:] |= ~is_x[:-1]
    need[0] = True
    gaps = np.maximum(gaps, need)
    cum = np.cumsum(gaps + lens)
    k = int(np.searchsorted(cum, length - 1, side="right"))
    assert k < n, "too few events drawn"
    run_ops = np.empty(2 * k + 1, np.uint8)
    run_lens = np.empty(2 * k + 1, np.int64)
    run_ops[0:2 * k:2], run_lens[0:2 * k:2] = EQ, gaps[:k]
    run_ops[1:2 * k:2], run_lens[1:2 * k:2] = ops[:k], lens[:k]
    run_ops[-1], run_lens[-1] = EQ, length - (cum[k - 1] if k else 0)
    keep = run_lens > 0
    run_ops, run_lens = run_ops[keep], run_lens[keep]
    starts = np.flatnonzero(np.concatenate(([True], run_ops[1:] != run_ops[:-1])))
    return run_ops[starts], np.add.reduceat(run_lens, starts)


def _rows(rng, ops, lens):
    """The gapped target and query rows of one block, over ACGT."""
    cat = np.repeat(ops, lens)
    t = rng.integers(0, 4, cat.size, dtype=np.uint8)
    q = t.copy()
    x = cat == X
    q[x] = (q[x] + rng.integers(1, 4, int(x.sum()), dtype=np.uint8)) % 4
    t, q = BASES[t], BASES[q]
    t[cat == INS] = GAP
    q[cat == DEL] = GAP
    return t.tobytes().decode("ascii"), q.tobytes().decode("ascii")


def generate(path, seed, fmt="paf", columns=100_000_000, block_min=20_000,
             block_max=5_000_000, snp_rate=0.0123, indel_rate=0.00176,
             indel_mean=4, minus_every=20):
    """Write the alignment; returns its work counts."""
    rng = np.random.default_rng(seed)
    blocks = [block_runs(rng, int(n), snp_rate, indel_rate, indel_mean)
              for n in block_lengths(rng, columns, block_min, block_max)]
    t_lens = [int(lens[ops != INS].sum()) for ops, lens in blocks]
    q_lens = [int(lens[ops != DEL].sum()) for ops, lens in blocks]
    t_size = sum(t_lens) + SPACER * (len(blocks) + 1)
    q_size = sum(q_lens) + SPACER * (len(blocks) + 1)
    t_off = q_off = SPACER
    with open(path, "w") as f:
        if fmt == "maf":
            f.write("##maf version=1\n")
        for i, ((ops, lens), t_len, q_len) in enumerate(zip(blocks, t_lens, q_lens)):
            minus = minus_every and i % minus_every == minus_every - 1
            strand = "-" if minus else "+"
            if fmt == "paf":
                cigar = "".join([f"{n}{o}" for n, o in
                                 zip(lens.tolist(), ops.tobytes().decode("ascii"))])
                matched = int(lens[ops == EQ].sum())
                edits = int(lens[ops != EQ].sum())
                f.write(f"{QUERY}\t{q_size}\t{q_off}\t{q_off + q_len}\t{strand}\t"
                        f"{TARGET}\t{t_size}\t{t_off}\t{t_off + t_len}\t{matched}\t"
                        f"{int(lens.sum())}\t60\tNM:i:{edits}\ttp:A:P\tcg:Z:{cigar}\n")
            else:
                t, q = _rows(rng, ops, lens)
                q_start = q_size - q_off - q_len if minus else q_off
                f.write(f"a score=0\ns {TARGET} {t_off} {t_len} + {t_size} {t}\n"
                        f"s {QUERY} {q_start} {q_len} {strand} {q_size} {q}\n\n")
            t_off += t_len + SPACER
            q_off += q_len + SPACER
    counts = {"records": len(blocks), "aligned_columns": columns}
    if fmt == "paf":
        counts["cigar_ops"] = sum(len(ops) for ops, _ in blocks)
    return counts
