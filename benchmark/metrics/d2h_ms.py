"""Milliseconds a call's fetches of results take on the device's clock:
the program's `gpu_d2h` METRICS stage (CUDA events on the stream around
each batch's fetches), the mean over the window's calls."""


def read(run):
    rows = [s["stages"] for s in run.samples if "total" in s.get("stages", {})]
    if not any("gpu_d2h" in r for r in rows):
        return None
    return sum(r.get("gpu_d2h", 0.0) for r in rows) / len(rows) * 1e3
