"""Plain reference of `paf2chain`: PAF records to chain records.

Written from the reference tool's described behaviour (wgatools
converter.rs:148-173, chain.rs:103-204, cigar.rs:155-245 and 460-490), with
a frozen copy of the repository's naive spec functions (`tests/reference_impl.py`:
`trims`, `chain_lines`) as its core.  Plain Python over the text, nothing of
the program under test.

`answer(path)` is the chain text the tool must write for the PAF at `path`.
`answer(path, control=True)` is the control: the same text with one
guarantee broken, the merge of adjacent =/X runs into one ungapped block,
so that every =/X boundary becomes a data line with zero gaps, as an
emitter that wrote one line per aligned op would.
"""

import re

_OP = re.compile(r"(\d+)([MIDNSHP=X])")


def tokenize(cigar):
    return [(op, int(n)) for n, op in _OP.findall(cigar)]


def trims(op_runs):
    """(head_ins, head_del, tail_ins, tail_del)."""
    head_ins = head_del = tail_ins = tail_del = 0
    head = True
    for op, n in op_runs:
        if op in "MX=":
            tail_ins = tail_del = 0
            head = False
        elif op == "I":
            if head:
                head_ins += n
            tail_ins = n
        elif op == "D":
            if head:
                head_del += n
            tail_del = n
    return head_ins, head_del, tail_ins, tail_del


def chain_lines(op_runs, merge=True):
    """Data lines [(size, dq, dt)] and the final size; without `merge`, an
    =/X boundary closes the block as a zero gap would not."""
    size = qd = td = 0
    lines = []
    for op, n in op_runs:
        if op in "MX=":
            if size != 0 and ((td + qd) != 0 or not merge):
                lines.append((size, qd, td))
                size = 0
            size += n
            td = qd = 0
        elif op == "I":
            td += n
        elif op == "D":
            qd += n
    return lines, size


def chain_record(fields, chain_id, merge=True):
    qname, qsize, qs, qe, strand, tname, tsize, ts, te = fields[:9]
    qsize, qs, qe, tsize, ts, te = map(int, (qsize, qs, qe, tsize, ts, te))
    cigar = next(f[5:] for f in fields[12:] if f.startswith("cg:Z:"))
    op_runs = tokenize(cigar)
    head_ins, head_del, tail_ins, tail_del = trims(op_runs)
    ts += head_del
    te -= tail_del
    if strand == "+":
        qs += head_ins
        qe -= tail_ins
    else:
        qs = qsize - (qe - head_ins)
        qe = qsize - (qs + tail_ins)
    lines, final = chain_lines(op_runs, merge)
    head = (f"chain\t255\t{tname}\t{tsize}\t+\t{ts}\t{te}\t{qname}\t{qsize}"
            f"\t{strand}\t{qs}\t{qe}\t{chain_id}")
    body = "".join(f"\n{s}\t{q}\t{t}" for s, q, t in lines)
    return f"{head}{body}\n{final}\n\n"


def answer(path, control=False):
    out = []
    with open(path) as f:
        for chain_id, line in enumerate(f):
            out.append(chain_record(line.rstrip("\n").split("\t"), chain_id,
                                    merge=not control))
    return "".join(out).encode("ascii")
