"""Optional tracing of a run: WGA_TPU_TRACE=<dir> wraps it in torch.profiler.

The port of wgatools_tpu/core/metrics.py::maybe_trace, on the same
variable: host operations, and on a CUDA device the kernels and copies,
are written as one Chrome trace into <dir>.  The stage counters stay the
TPU package's METRICS (wgatools_tpu.core.metrics, jax-free).
"""

import contextlib
import logging
import os

import torch

log = logging.getLogger("wgatools_tpu_torch.metrics")

TRACE_ENV = "WGA_TPU_TRACE"


@contextlib.contextmanager
def maybe_trace():
    """torch.profiler trace of the body into $WGA_TPU_TRACE, when set; the
    trace is written even when the body raises."""
    trace_dir = os.environ.get(TRACE_ENV)
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"wgatools_tpu_torch.{os.getpid()}.trace.json")
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
        log.info("torch profiler trace written to %s", path)
