"""Seconds a CLI process spends loading the native and the kernel
libraries: the program's `lib_load` METRICS stage (logged at -vv), the mean
over the traced window's processes that ran without the profiler."""


def read(run):
    rows = [s["stages"] for s in run.samples if "total" in s.get("stages", {})]
    if not any("lib_load" in r for r in rows):
        return None
    return sum(r.get("lib_load", 0.0) for r in rows) / len(rows)
