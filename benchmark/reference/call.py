"""Plain reference of `call -f maf` (SNP, INS and DEL rows; INV rows with
`inv`) on a MAF without an index beside it: the VCF the tool must write.

Written from the reference tool's described behaviour (wgatools
caller.rs:42-157 for the record loop, 159-219 for the SV-safe chunk plan,
221-265 for a chunk's coordinates, 388-608 for the variant scan, 304-386
for the VCF header without contig lines).  Each block's first `s` line is
the target, its second the query.  A record is cut into chunks of at most
`chunk_size` columns, each ended after the last run of gap columns (a gap
in either row) of at least `svlen` columns that completes inside the
window, or extended to the end of a run of at least `svlen` gap columns
that the window ends inside.  A chunk is a record of its own: its target
start counts the target bases before it, its query start the query bases
before it (on the minus strand from the far end, less the chunk's own
query bases).  Within a chunk a column is = where both rows agree, X where
they differ, I where only the target has a gap, D where only the query
has one, and W where both do; W runs change nothing.  Each X column is an
SNP row; an I or D run longer than `svlen` that follows an = or X run
(W runs skipped), with an anchor base before it in both rows, is an INS
or DEL row anchored on the base before it; on a minus-strand record the
rows carry `N` and `INV_NEST=TRUE;`, and with `inv` each chunk opens with
an INV row.  Rows follow records in input order, chunks in order, and
columns in order.  Bases are written upper case.  Plain Python and NumPy,
nothing of the program under test.

`answer(path, control=True)` is the control: the chunk plan without the
SV rule (plain windows of `chunk_size` columns), which splits the SVs a
window boundary falls in and moves a minus-strand chunk's query
coordinates.
"""

import numpy as np

GAP = ord("-")
EQ, X, I, D, W = 0, 1, 2, 3, 4
UPPER = np.arange(256, dtype=np.uint8)
UPPER[ord("a"):ord("z") + 1] -= 32
HEADER = (
    "##fileformat=VCFv4.4\n"
    '##INFO=<ID=SVLEN,Number=A,Type=Integer,Description="Length of structural variant">\n'
    '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Type of structural variant">\n'
    '##INFO=<ID=END,Number=1,Type=Integer,Description="End position of the longest variant described in this record">\n'
    '##INFO=<ID=INV_NEST,Number=1,Type=String,Description="Varations nested within inversion">\n'
    '##FORMAT=<ID=QI,Number=1,Type=String,Description="Query informations">\n'
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{sample}\n")


def plan_bounds(gap_starts, gap_ends, total, chunk_size, svlen):
    """The SV-safe chunk plan of a record of `total` columns whose maximal
    gap runs are [gap_starts[i], gap_ends[i]), sorted: [(start, end)]."""
    gap_starts = np.asarray(gap_starts, np.int64)
    gap_ends = np.asarray(gap_ends, np.int64)
    bounds = []
    s = 0
    while s < total:
        pe = min(s + chunk_size, total)
        lo = int(np.searchsorted(gap_ends, s, side="right"))
        hi = int(np.searchsorted(gap_starts, pe, side="left"))
        a = np.maximum(gap_starts[lo:hi], s)
        b = gap_ends[lo:hi]
        safe = pe
        done = np.flatnonzero((b < pe) & (b - a >= svlen))
        if done.size:
            safe = int(b[done[-1]])
        if hi > lo and b[-1] >= pe and pe - a[-1] >= svlen:
            # the window ends inside a long gap run: to the run's end, or
            # the window's end where the run reaches the record's end
            safe = int(b[-1]) if b[-1] < total else pe
        bounds.append((s, safe))
        s = safe
    return bounds


def blocks(path):
    """(target s-line fields, query s-line fields) of each block."""
    slines = []
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b"s"):
                slines.append(line.split())
            elif line.startswith(b"a") or not line.strip():
                if len(slines) >= 2:
                    yield slines[0], slines[1]
                slines = []
    if len(slines) >= 2:
        yield slines[0], slines[1]


def _categories(t, q):
    tg, qg = t == GAP, q == GAP
    return np.where(tg, np.where(qg, W, I),
                    np.where(qg, D, np.where(t == q, EQ, X))).astype(np.int8)


def record_rows(ts, qs, snp, inv, svlen, chunk_size, control):
    """The VCF rows of one record, as one string."""
    chro, tstart = ts[1].decode(), int(ts[2])
    qchro, qraw, qsize = qs[1].decode(), int(qs[2]), int(qs[5])
    negative = qs[4] == b"-"
    suffix, init = ("N", "INV_NEST=TRUE;") if negative else ("P", "")
    t = np.frombuffer(ts[6], np.uint8)
    q = np.frombuffer(qs[6], np.uint8)
    n = min(t.size, q.size)
    t, q = t[:n], q[:n]
    if n == 0:
        return ""
    gap = np.concatenate(([0], ((t == GAP) | (q == GAP)).astype(np.int8), [0]))
    edges = np.flatnonzero(np.diff(gap))
    if control:
        plan = [(s, min(s + chunk_size, n)) for s in range(0, n, chunk_size)]
    else:
        plan = plan_bounds(edges[0::2], edges[1::2], n, chunk_size, svlen)
    cs = np.array([s for s, _ in plan], np.int64)
    ce = np.array([e for _, e in plan], np.int64)
    # bases before each column, and the gap-free upper-case rows
    T = np.concatenate(([0], np.cumsum(t != GAP)))
    Q = np.concatenate(([0], np.cumsum(q != GAP)))
    tstr = UPPER[t[t != GAP]]
    qstr = UPPER[q[q != GAP]]
    # each chunk's target start and end, query start and end
    c_tstart = tstart + T[cs]
    c_tend = tstart + T[ce]
    q_cnt = Q[ce] - Q[cs]
    if negative:
        c_qstart = qsize - (qraw + Q[cs]) - q_cnt
        c_qend = qsize - (qraw + Q[cs])
    else:
        c_qstart = qraw + Q[cs]
        c_qend = c_qstart + q_cnt
    # runs of the categories, cut at every chunk start
    cat = _categories(t, q)
    first = np.zeros(n, bool)
    first[0] = True
    first[1:] = cat[1:] != cat[:-1]
    first[cs] = True
    rs = np.flatnonzero(first)
    rl = np.diff(np.append(rs, n))
    rc = cat[rs]
    chunk = np.searchsorted(cs, rs, side="right") - 1
    t_off = tstart + T[rs]
    q_off = c_qstart[chunk] + Q[rs] - Q[cs[chunk]]
    # after_m: the last run before, in the same chunk, that is not W is =
    # or X
    idx = np.arange(rs.size)
    last = np.maximum.accumulate(np.where(rc != W, idx, -1))
    prev = np.concatenate(([-1], last[:-1]))
    chunk_first = np.searchsorted(chunk, chunk, side="left")
    after_m = (prev >= chunk_first) & np.isin(rc[np.maximum(prev, 0)], (EQ, X))
    anchored = (t_off > c_tstart[chunk]) & (q_off > c_qstart[chunk])
    keyed = []  # (sort key, row)
    if inv and negative:
        for k in np.flatnonzero(T[ce] > T[cs]).tolist():
            keyed.append((2 * int(cs[k]), (
                f"{chro}\t{c_tstart[k] + 1}\t.\t{chr(tstr[T[cs[k]]])}\t<INV>\t.\t.\t"
                f"SVTYPE=INV;END={c_tend[k]}\tGT:QI\t"
                f"1|1:{qchro}@{c_qstart[k]}@{c_qend[k]}@N\n")))
    for k in np.flatnonzero(((rc == I) | (rc == D)) & (rl > svlen) & after_m
                            & anchored).tolist():
        ln, to, qo = int(rl[k]), int(t_off[k]), int(q_off[k])
        tb, qb = int(T[rs[k]]), int(Q[rs[k]])
        if rc[k] == I:
            ref, alt = tstr[tb - 1:tb], qstr[qb - 1:qb + ln]
            info, qi = f"SVTYPE=INS;SVLEN={ln};END={to}", f"{qo}@{qo + ln}"
        else:
            ref, alt = tstr[tb - 1:tb + ln], qstr[qb - 1:qb]
            info, qi = f"SVTYPE=DEL;SVLEN={ln};END={to + ln}", f"{qo}@{qo}"
        keyed.append((2 * int(rs[k]) + 1, (
            f"{chro}\t{to}\t.\t{ref.tobytes().decode()}\t{alt.tobytes().decode()}"
            f"\t.\t.\t{init}{info}\tGT:QI\t1|1:{qchro}@{qi}@{suffix}\n")))
    if snp:
        cols = np.flatnonzero(cat == X)
        r = np.searchsorted(rs, cols, side="right") - 1
        q_at = q_off[r] + Q[cols] - Q[rs[r]]
        refs = tstr[T[cols]].tobytes().decode()
        alts = qstr[Q[cols]].tobytes().decode()
        for c, pos, r, a, qp in zip(cols.tolist(), (tstart + T[cols] + 1).tolist(),
                                    refs, alts, q_at.tolist()):
            keyed.append((2 * c + 1, f"{chro}\t{pos}\t.\t{r}\t{a}\t.\t.\t.\t"
                                     f"GT:QI\t1|1:{qchro}@{qp}@{suffix}\n"))
    keyed.sort(key=lambda kr: kr[0])
    return "".join(row for _, row in keyed)


def answer(path, control=False, snp=True, inv=False, svlen=50,
           chunk_size=1_000_000, sample="sample"):
    """The bytes of `call -s` (snp), `-i` (inv), `-l svlen` and `-c
    chunk_size` on the MAF at `path`."""
    out = [HEADER.format(sample=sample)]
    for ts, qs in blocks(path):
        out.append(record_rows(ts, qs, snp, inv, svlen, chunk_size, control))
    return "".join(out).encode("ascii")
