"""The share of the traced window in which the device ran nothing, in %: 1
less the union of its kernels, copies and fills over the window."""


def read(run):
    if "busy_s" not in run.device or not run.window_s:
        return None
    return (1 - run.device["busy_s"] / run.window_s) * 100
