"""Milliseconds a call spends in the program's device stages (upload,
launches, fetch of the results): the sum of its `device_*` METRICS stages,
the mean over the window's calls."""


def read(run):
    rows = [s["stages"] for s in run.samples if "total" in s.get("stages", {})]
    device = [sum(v for k, v in r.items() if k.startswith("device_"))
              for r in rows]
    if not any(device):
        return None
    return sum(device) / len(device) * 1e3
