"""The share of the input's columns whose run tables come from the device,
in %: the program's `call_device_columns` over its `call_device_columns`
and `call_host_columns` METRICS counters (the host engine answers chunk
groups below DEVICE_MIN_COLUMNS), read in this process as pad_share reads
its counters (a cell of ranks adds every rank's there)."""

import sys

import harness


def read(run):
    module = sys.modules.get(harness.PROGRAM + ".core.metrics")
    counts = getattr(getattr(module, "METRICS", None), "counts", {})
    device = counts.get("call_device_columns", 0)
    host = counts.get("call_host_columns", 0)
    if not device + host:
        return None
    return device / (device + host) * 100
