"""How much longer the slowest rank works on a call than the ranks' mean,
in %: for each call, each rank's `total` METRICS stage less its
`merge_wait` (the wait for the other ranks at the merge, which evens the
totals out), the largest over their mean, less 1; the mean over the
window's calls.  Only a cell of ranks has it."""


def read(run):
    skews = []
    for s in run.samples:
        ranks = s.get("ranks") or []
        own = [r["total"] - r.get("merge_wait", 0.0) for r in ranks
               if "total" in r]
        if len(own) < 2 or len(own) != len(ranks):
            continue
        skews.append(max(own) / (sum(own) / len(own)) - 1)
    return sum(skews) / len(skews) * 100 if skews else None
