"""Milliseconds a call spends planning the SV-safe chunks of its records
(`call`): the program's `plan` METRICS stage, the mean over the window's
calls (over the ranks too, in a cell of ranks)."""


def read(run):
    rows = [s["stages"] for s in run.samples if "total" in s.get("stages", {})]
    if not any("plan" in r for r in rows):
        return None
    return sum(r.get("plan", 0.0) for r in rows) / len(rows) * 1e3
