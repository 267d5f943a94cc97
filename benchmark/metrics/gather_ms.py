"""Milliseconds a rank spends gathering every rank's output (its rows
pickled, then the two all_gathers of the lengths and the padded bytes):
the program's `gather` METRICS stage, the mean over the ranks and the
window's calls."""


def read(run):
    rows = [s["stages"] for s in run.samples if "total" in s.get("stages", {})]
    if not any("gather" in r for r in rows):
        return None
    return sum(r.get("gather", 0.0) for r in rows) / len(rows) * 1e3
