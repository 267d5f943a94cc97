"""Milliseconds a call spends in the tool's host layers (CLI dispatch, parse,
pack, emission, formatting, writing): the program's `total` METRICS stage
less its `device_*` stages, the mean over the window's calls."""


def read(run):
    rows = [s["stages"] for s in run.samples if "total" in s.get("stages", {})]
    if not rows:
        return None
    host = [r["total"] - sum(v for k, v in r.items() if k.startswith("device_"))
            for r in rows]
    return sum(host) / len(host) * 1e3
