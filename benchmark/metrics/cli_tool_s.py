"""Seconds of tool work in a CLI process: the program's own `total` METRICS
stage (logged at -vv) less the imports that Python timed inside it (torch
and the tool's modules load inside main(); PYTHONPROFILEIMPORTTIME), the
mean over the traced window's processes that ran without the profiler."""


def read(run):
    values = [s["stages"]["total"] - s.get("import_in_main_s", 0.0)
              for s in run.samples if "total" in s.get("stages", {})]
    return sum(values) / len(values) if values else None
