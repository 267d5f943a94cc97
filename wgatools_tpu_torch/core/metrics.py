"""Per-stage timing, byte volumes and counters, and optional tracing of a run.

METRICS records stage wall times and byte volumes, and counters, reported to
stderr at -vv as `stage <name> <secs>s` and `count <name> <n>` lines (the
port of wgatools_tpu/core/metrics.py, the package's own singleton).

Stages of a device route, on the host's clock unless their name says
otherwise:

- `total`: one CLI call, entry to return (cli.main).
- process start: `import_torch` (the process's first `import torch`),
  `cuda_init` (until the CUDA context exists) and `lib_load` (the native
  library's and the kernel library's first load, the latter inside the
  device stage of the first launch); none of them on the host route.
- host layers of paf2chain and stat: `parse` (records read, CIGAR op
  arrays or block sequences taken out), `pack` (padded batches; stat's
  category planes, packed into the pinned upload slot), `emit`
  (per-record and per-block work on the device's results, and the
  aggregation), `write` (formatting, the writer's writes and flush).
  Within a call they and the `device_*` stages are disjoint.
- `device_*`: the device stages, upload, launches and fetch of one batch
  on the host's clock (`device_wait`: stat's fence on a batch in flight).
- `gpu_*`: on the device's clock, the time between two CUDA events on the
  current stream (`gpu_h2d`, `gpu_d2h`: one batch's uploads and fetches),
  read after a synchronisation the tool already makes (Metrics.settle) and
  at the latest at the end of `total`.  Nothing is recorded on the CPU.

Counters: `slots` and `padded_slots`, the op slots (kernel B) or columns
(kernel A) of every batch a tool uploads, and those of them that are
padding;
`native_scan_blocks` and `scan_fallback_blocks`, the MAF blocks of stat's
mapped input that the native scanner tokenized and those whose lines went
through parse_sline (io/maf.py mapped_records); `stat_fold_rows` and
`stat_record_rows`, the records stat's default mode folded as array rows
and those that went through a per-record RecStat (tools/stat.py).

When a torch.profiler session is on, each stage or phase also opens a
`wga.<name>` user annotation (record_function), so that the program's spans
sit on the profiler's clock beside the kernels and copies; a call's spans
nest in its `wga.total`.  Without a session a stage calls no torch function
(two clock reads and a dict update), and the host route never imports
torch.  WGA_TPU_TRACE=<dir> wraps a run in torch.profiler: host operations,
the annotations, and on a CUDA device the kernels and copies, are written as
one Chrome trace into <dir>.
"""

import contextlib
import logging
import os
import sys
import time

log = logging.getLogger("wgatools_tpu_torch.metrics")

TRACE_ENV = "WGA_TPU_TRACE"
ANNOTATION_PREFIX = "wga."


def _annotation(name):
    """An entered record_function("wga.<name>") while a torch.profiler
    session is on, else None.  The check reads torch's own Python flag, so
    without a session no torch function runs, and without torch loaded no
    torch module is imported."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None or not getattr(prof, "_is_profiler_enabled", False):
        return None
    span = prof.record_function(ANNOTATION_PREFIX + name)
    span.__enter__()
    return span


class Phases:
    """The host phases of a loop or generator that moves from one phase to
    the next (parse, pack, emit, write), one clock read a switch and no
    context manager per item: `to(name)` ends the phase running and starts
    `name`, `stop()` ends it.  Under a profiler each stretch of one phase is
    one annotation."""

    def __init__(self, metrics):
        self.metrics = metrics
        self.name = None
        self.span = None
        self.t0 = 0.0

    def to(self, name):
        now = time.perf_counter()
        if self.name is not None:
            self.metrics.add(self.name, now - self.t0)
            if self.span is not None:
                self.span.__exit__(None, None, None)
        self.name = name
        self.span = None if name is None else _annotation(name)
        self.t0 = now

    def stop(self):
        self.to(None)


class Metrics:
    def __init__(self):
        self.stages = {}  # name -> [seconds, bytes]
        self.counts = {}  # name -> count
        self._gpu = []  # (stage name, start event, end event) not yet read

    def add(self, name: str, secs: float, nbytes: int = 0):
        entry = self.stages.setdefault(name, [0.0, 0])
        entry[0] += secs
        entry[1] += nbytes

    @contextlib.contextmanager
    def stage(self, name: str, nbytes: int = 0):
        span = _annotation(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0, nbytes)
            if span is not None:
                span.__exit__(None, None, None)

    def phases(self) -> Phases:
        return Phases(self)

    @contextlib.contextmanager
    def gpu(self, name: str, device):
        """Stage gpu_<name> on the device's clock: CUDA timing events on the
        current stream before and after the body's work, read by settle().
        Adds no synchronisation; on a CPU device it records nothing."""
        if device.type != "cuda":
            yield
            return
        import torch

        stream = torch.cuda.current_stream(device)
        start = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        yield
        end = torch.cuda.Event(enable_timing=True)
        end.record(stream)
        self._gpu.append(("gpu_" + name, start, end))

    def settle(self, wait: bool = False):
        """Add the device time of each gpu span whose end event has
        completed; with wait, of every span, waiting for its end event (at
        the end of a call, when the tool has fetched all its results)."""
        keep = []
        for name, start, end in self._gpu:
            if wait:
                end.synchronize()
            elif not end.query():
                keep.append((name, start, end))
                continue
            self.add(name, start.elapsed_time(end) * 1e-3)
        self._gpu = keep

    def count(self, name: str, n: int):
        self.counts[name] = self.counts.get(name, 0) + n

    def add_bytes(self, name: str, nbytes: int):
        self.stages.setdefault(name, [0.0, 0])[1] += nbytes

    def report(self):
        for name, (secs, nbytes) in self.stages.items():
            rate = f", {nbytes / secs / 1e6:.1f} MB/s" if nbytes and secs else ""
            size = f", {nbytes / 1e6:.1f} MB" if nbytes else ""
            log.debug("stage %-20s %8.3fs%s%s", name, secs, size, rate)
        for name, n in self.counts.items():
            log.debug("count %s %d", name, n)


METRICS = Metrics()


@contextlib.contextmanager
def maybe_trace():
    """torch.profiler trace of the body into $WGA_TPU_TRACE, when set; the
    trace is written even when the body raises."""
    trace_dir = os.environ.get(TRACE_ENV)
    if not trace_dir:
        yield
        return
    import torch
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
