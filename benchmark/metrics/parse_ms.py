"""Milliseconds a call spends parsing its input (records read, CIGAR op
arrays or block sequences taken out): the program's `parse` METRICS stage,
the mean over the window's calls."""


def read(run):
    rows = [s["stages"] for s in run.samples if "total" in s.get("stages", {})]
    if not any("parse" in r for r in rows):
        return None
    return sum(r.get("parse", 0.0) for r in rows) / len(rows) * 1e3
