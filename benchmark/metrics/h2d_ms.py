"""Milliseconds a call's uploads take on the device's clock: the program's
`gpu_h2d` METRICS stage (CUDA events on the stream around each batch's
uploads), the mean over the window's calls."""


def read(run):
    rows = [s["stages"] for s in run.samples if "total" in s.get("stages", {})]
    if not any("gpu_h2d" in r for r in rows):
        return None
    return sum(r.get("gpu_h2d", 0.0) for r in rows) / len(rows) * 1e3
