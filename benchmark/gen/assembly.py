"""One haplotype of a whole-genome assembly aligned to one chromosome of
GRCh38, written as MAF: a few long records, as minimap2 -x asm5
-z200000,10000 leaves them (dipcall's alignment), at human divergence.

Record lengths come from a fixed set, log-uniform between `record_min` and
`record_max` columns and summing to exactly `columns`, in an order that is
the same for every seed (pairwise.block_lengths under ORDER_SEED); the
seed draws only the events and the bases.  Inside a record, runs of =
lie between events: an aligned column is followed by a substitution (one X
column) with probability `snp_rate`, by a short insertion or deletion
(half each, geometric length of mean `indel_mean`, redrawn while it is
`indel_max` + 1 or longer) with probability `indel_rate`, or by a
structural insertion or deletion (half each, log-uniform from `sv_min` to
`sv_max` columns) with probability `sv_per_mbp` / 1e6.  Every indel has =
on both sides, and every record starts and ends with =.  Every
`minus_every`-th record lies on the query's minus strand.  Each record's
query is a contig of its own; the records lie in order along the target
(`target`, of `target_size` bases), spaced evenly over its length.
"""

import numpy as np

import harness

pairwise = harness.load_part("gen", "pairwise")

EQ, X, INS, DEL = pairwise.EQ, pairwise.X, pairwise.INS, pairwise.DEL
# the seed of the record order, the same for every run
ORDER_SEED = 0
SPACER = 50
# the caller's defaults (wgatools call -l, -c): its SV-safe chunk plan
SVLEN, CHUNK = 50, 1_000_000


def record_lengths(columns, record_min, record_max):
    return pairwise.block_lengths(np.random.default_rng(ORDER_SEED), columns,
                                  record_min, record_max)


def record_runs(rng, length, snp_rate, indel_rate, indel_mean, indel_max,
                sv_rate, sv_min, sv_max):
    """(ops, lens, kinds) of one record of `length` columns: its CIGAR
    runs, and the event count of each class (snv, indel, sv)."""
    p = snp_rate + indel_rate + sv_rate
    n = int(length * p + 10 * np.sqrt(length * p)) + 16
    gaps = rng.geometric(p, n) - 1
    u = rng.random(n) * p
    is_x = u < snp_rate
    is_sv = u >= snp_rate + indel_rate
    lens = rng.geometric(1 / indel_mean, n)
    while (bad := lens > indel_max).any():
        lens[bad] = rng.geometric(1 / indel_mean, int(bad.sum()))
    sv = np.floor(sv_min * (sv_max / sv_min) ** rng.random(n)).astype(np.int64)
    lens = np.where(is_x, 1, np.where(is_sv, sv, lens))
    ops = np.where(is_x, X, np.where(rng.random(n) < 0.5, INS, DEL)).astype(np.uint8)
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
    kinds = {"snv": int(is_x[:k].sum()), "sv": int(is_sv[:k].sum())}
    kinds["indel"] = k - kinds["snv"] - kinds["sv"]
    keep = run_lens > 0
    run_ops, run_lens = run_ops[keep], run_lens[keep]
    starts = np.flatnonzero(np.concatenate(([True], run_ops[1:] != run_ops[:-1])))
    return run_ops[starts], np.add.reduceat(run_lens, starts), kinds


def chunk_work(ops, lens, plan_bounds):
    """(chunks, runs) of one record under the caller's SV-safe chunk plan:
    the rows kernel A counts, and the runs they hold (a chunk boundary
    inside a run cuts it in two)."""
    ends = np.cumsum(lens)
    starts = ends - lens
    gap = (ops == INS) | (ops == DEL)
    bounds = plan_bounds(starts[gap], ends[gap], int(ends[-1]), CHUNK, SVLEN)
    cuts = np.asarray([s for s, _ in bounds[1:]], np.int64)
    return len(bounds), len(ops) + int((~np.isin(cuts, starts)).sum())


def generate(path, seed, columns=145_000_000, record_min=50_000,
             record_max=40_000_000, snp_rate=0.001, indel_rate=0.00015,
             indel_mean=2, indel_max=49, sv_per_mbp=6.6, sv_min=50,
             sv_max=10_000, minus_every=10, target="GRCh38.chr8",
             target_size=145_138_636):
    """Write the alignment; returns its work counts."""
    plan_bounds = harness.load_part("reference", "call").plan_bounds
    rng = np.random.default_rng(seed)
    lengths = record_lengths(columns, record_min, record_max)
    counts = {"records": len(lengths), "aligned_columns": columns, "snv": 0,
              "indel": 0, "sv": 0, "chunks": 0, "runs": 0}
    records = []
    for n in lengths:
        ops, lens, kinds = record_runs(
            rng, int(n), snp_rate, indel_rate, indel_mean, indel_max,
            sv_per_mbp / 1e6, sv_min, sv_max)
        for k, v in kinds.items():
            counts[k] += v
        chunks, runs = chunk_work(ops, lens, plan_bounds)
        counts["chunks"] += chunks
        counts["runs"] += runs
        records.append((ops, lens))
    t_lens = [int(lens[ops != INS].sum()) for ops, lens in records]
    space = (target_size - sum(t_lens)) // (len(records) + 1)
    assert space > 0, "the records do not fit on the chromosome"
    t_off = space
    with open(path, "w") as f:
        f.write("##maf version=1\n")
        for i, ((ops, lens), t_len) in enumerate(zip(records, t_lens)):
            minus = minus_every and i % minus_every == minus_every - 1
            q_len = int(lens[ops != DEL].sum())
            q_size = q_len + 2 * SPACER
            t, q = pairwise._rows(rng, ops, lens)
            f.write(f"a score=0\ns {target} {t_off} {t_len} + {target_size} {t}\n"
                    f"s hap1.h1tg{i + 1:06d}l {SPACER} {q_len} "
                    f"{'-' if minus else '+'} {q_size} {q}\n\n")
            t_off += t_len + space
    return counts
