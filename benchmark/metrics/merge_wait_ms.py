"""Milliseconds a rank waits at a call's merge for the other ranks (the
meeting on the group's store before the collectives): the program's
`merge_wait` METRICS stage, the mean over the ranks and the window's
calls."""


def read(run):
    rows = [s["stages"] for s in run.samples if "total" in s.get("stages", {})]
    if not any("merge_wait" in r for r in rows):
        return None
    return sum(r.get("merge_wait", 0.0) for r in rows) / len(rows) * 1e3
