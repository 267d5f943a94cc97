"""Milliseconds a call spends formatting and writing its output: the
program's `write` METRICS stage, the mean over the window's calls."""


def read(run):
    rows = [s["stages"] for s in run.samples if "total" in s.get("stages", {})]
    if not any("write" in r for r in rows):
        return None
    return sum(r.get("write", 0.0) for r in rows) / len(rows) * 1e3
