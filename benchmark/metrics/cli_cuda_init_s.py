"""Seconds a CLI process spends creating its CUDA context: the program's
`cuda_init` METRICS stage (logged at -vv), the mean over the traced window's
processes that ran without the profiler."""


def read(run):
    rows = [s["stages"] for s in run.samples if "total" in s.get("stages", {})]
    if not any("cuda_init" in r for r in rows):
        return None
    return sum(r.get("cuda_init", 0.0) for r in rows) / len(rows)
