"""Seconds a CLI process spends importing torch: the program's
`import_torch` METRICS stage (logged at -vv), the mean over the traced
window's processes that ran without the profiler."""


def read(run):
    rows = [s["stages"] for s in run.samples if "total" in s.get("stages", {})]
    if not any("import_torch" in r for r in rows):
        return None
    return sum(r.get("import_torch", 0.0) for r in rows) / len(rows)
