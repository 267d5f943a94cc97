"""Milliseconds a call spends packing batches for the device (padded op
tables, category planes): the program's `pack` METRICS stage, the mean over
the window's calls."""


def read(run):
    rows = [s["stages"] for s in run.samples if "total" in s.get("stages", {})]
    if not any("pack" in r for r in rows):
        return None
    return sum(r.get("pack", 0.0) for r in rows) / len(rows) * 1e3
