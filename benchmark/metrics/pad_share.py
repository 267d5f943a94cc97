"""The share of the slots the tool uploads that are padding, in %: op
slots for kernel B, columns for kernel A, each batch padded to its longest
row.  The program's `padded_slots` over its `slots` METRICS counters, read
in this process as drivers/inprocess.py reads the kernel launches; they
include the warm-up call, whose input is the window's, so the ratio is a
call's."""

import sys

import harness


def read(run):
    module = sys.modules.get(harness.PROGRAM + ".core.metrics")
    counts = getattr(getattr(module, "METRICS", None), "counts", {})
    if not counts.get("slots"):
        return None
    return counts.get("padded_slots", 0) / counts["slots"] * 100
