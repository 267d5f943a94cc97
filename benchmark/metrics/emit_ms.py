"""Milliseconds a call spends on the device's results (per-record chain
blocks, per-block statistics and their aggregation): the program's `emit`
METRICS stage, the mean over the window's calls."""


def read(run):
    rows = [s["stages"] for s in run.samples if "total" in s.get("stages", {})]
    if not any("emit" in r for r in rows):
        return None
    return sum(r.get("emit", 0.0) for r in rows) / len(rows) * 1e3
