"""Plain reference of `stat` on a MAF: per sequence pair, the aligned,
matched, mismatched, inserted and deleted columns and the identity.

Written from the reference tool's described behaviour (wgatools
stat.rs:61-84 and 167-223, common.rs:99-140, cigar.rs:344-432): each block's
first `s` line is the target and its second the query; a column is `=` where
the two bytes agree (two gaps included), I where only the target has a gap,
D where only the query has one, X otherwise; runs of I and D are events.
Records merge by (target, target size, query, query size) in order of first
appearance, rows sort naturally by target name, and identity and similarity
are float32 quotients written as the shortest float32 repr.  Plain Python and
NumPy, nothing of the program under test.

`answer(path, control=True)` is the control: identity and similarity
rounded to bfloat16, the precision below the float32 that the tool states.
"""

import re

import numpy as np

COLUMNS = ("ref_name", "ref_size", "ref_start", "query_name", "query_size",
           "query_start", "aligned_size", "unaligned_size", "identity",
           "similarity", "matched", "mismatched", "ins_event", "del_event",
           "ins_size", "del_size", "inv_event", "inv_size", "inv_ins_event",
           "inv_ins_size", "inv_del_event", "inv_del_size")
GAP = ord("-")


def fmt_f32(v):
    """The shortest digits that read back as this float32, in ryu's notation:
    positional when -5 < kk <= 13 (10^(kk-1) <= |v| < 10^kk), else d.ddde<x>."""
    f = np.float32(v)
    if f == 0:
        return "-0.0" if np.signbit(f) else "0.0"
    if not np.isfinite(f):
        return "NaN" if np.isnan(f) else ("inf" if f > 0 else "-inf")
    mant, exp = np.format_float_scientific(abs(f), unique=True).split("e")
    digits = mant.replace(".", "").rstrip("0") or "0"
    kk = int(exp) + 1
    if -5 < kk <= 13:
        if kk <= 0:
            s = "0." + "0" * -kk + digits
        elif kk >= len(digits):
            s = digits + "0" * (kk - len(digits)) + ".0"
        else:
            s = digits[:kk] + "." + digits[kk:]
    else:
        s = digits[0] + ("." + digits[1:] if len(digits) > 1 else "")
        s += f"e{kk - 1}"
    return "-" + s if f < 0 else s


def to_bfloat16(v):
    """float32 `v` rounded to the nearest bfloat16 (ties to even)."""
    bits = np.array([v], dtype=np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return np.float32(bits.astype(np.uint32).view(np.float32)[0])


def _natural_key(name):
    return [(0, int(p), len(p)) if p.isdigit() else (1, p, 0)
            for p in re.findall(r"\d+|\D+", name)]


def pair_counts(t, q, negative):
    n = min(t.size, q.size)
    t, q = t[:n], q[:n]
    cat = np.where(t == q, 0, np.where(t == GAP, 2, np.where(q == GAP, 3, 1)))
    starts = np.flatnonzero(np.concatenate(([True], cat[1:] != cat[:-1])))
    kinds = cat[starts]
    sizes = np.diff(np.append(starts, n))
    events = np.bincount(kinds, minlength=4)
    cols = np.bincount(kinds, weights=sizes, minlength=4).astype(np.int64)
    c = dict(matched=int(cols[0]), mismatched=int(cols[1]), ins_event=0,
             ins_size=0, del_event=0, del_size=0, inv_ins_event=0,
             inv_ins_size=0, inv_del_event=0, inv_del_size=0,
             inv_event=1 if negative else 0)
    pre = "inv_" if negative else ""
    c[pre + "ins_event"], c[pre + "ins_size"] = int(events[2]), int(cols[2])
    c[pre + "del_event"], c[pre + "del_size"] = int(events[3]), int(cols[3])
    c["aligned_size"] = (c["matched"] + c["mismatched"] + c["del_size"]
                         + c["inv_del_size"])
    query_aligned = (c["matched"] + c["mismatched"] + c["ins_size"]
                     + c["inv_ins_size"])
    c["inv_size"] = (np.float32(c["aligned_size"] + query_aligned)
                     / np.float32(c["inv_event"] + 1)
                     if c["inv_event"] else np.float32(0))
    return c


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


SUMMED = ("aligned_size", "matched", "mismatched", "ins_event", "del_event",
          "ins_size", "del_size", "inv_ins_event", "inv_ins_size",
          "inv_del_event", "inv_del_size", "inv_event")


def answer(path, control=False):
    rows = {}
    for ts, qs in blocks(path):
        tname, tsize, tstart = ts[1].decode(), int(ts[5]), int(ts[2])
        qname, qsize, qstart = qs[1].decode(), int(qs[5]), int(qs[2])
        negative = qs[4] == b"-"
        t = np.frombuffer(ts[6], np.uint8)
        q = np.frombuffer(qs[6], np.uint8)
        if negative:
            qstart = qsize - qstart - int(qs[3])
        c = pair_counts(t, q, negative)
        key = (tname, tsize, qname, qsize)
        r = rows.setdefault(key, dict(
            {k: 0 for k in SUMMED}, ref_start=tsize, query_start=qsize,
            inv_size=np.float32(0)))
        for k in SUMMED:
            r[k] += c[k]
        r["inv_size"] = np.float32(r["inv_size"] + c["inv_size"])
        r["ref_start"] = min(r["ref_start"], tstart)
        r["query_start"] = min(r["query_start"], qstart)
    out = ["\t".join(COLUMNS)]
    for (tname, tsize, qname, qsize), r in sorted(
            rows.items(), key=lambda kv: _natural_key(kv[0][0])):
        identity = np.float32(r["matched"]) / np.float32(r["aligned_size"])
        similarity = (np.float32(r["matched"] + r["mismatched"])
                      / np.float32(r["aligned_size"]))
        if control:
            identity, similarity = to_bfloat16(identity), to_bfloat16(similarity)
        out.append("\t".join(map(str, (
            tname, tsize, r["ref_start"], qname, qsize, r["query_start"],
            r["aligned_size"], tsize - r["aligned_size"], fmt_f32(identity),
            fmt_f32(similarity), r["matched"], r["mismatched"], r["ins_event"],
            r["del_event"], r["ins_size"], r["del_size"], r["inv_event"],
            fmt_f32(r["inv_size"]), r["inv_ins_event"], r["inv_ins_size"],
            r["inv_del_event"], r["inv_del_size"]))))
    return ("\n".join(out) + "\n").encode("ascii")
