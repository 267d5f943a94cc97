"""Seconds a CLI process spends importing modules: the sum of the cumulative
time of each top-level import Python reports under PYTHONPROFILEIMPORTTIME,
the mean over the traced window's processes."""


def read(run):
    values = [s["import_s"] for s in run.samples if "import_s" in s]
    return sum(values) / len(values) if values else None
