"""What every cell of the benchmark shares: finding its parts by name,
pinning the card route, the closed loop, the statistics, reading the
profiler's trace, and the output comparison.

Nothing here imports the program under test; the drivers do.
"""

import ctypes
import hashlib
import importlib.util
import json
import math
import os
import random
import threading
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# the program's package; the JAX package and JAX itself must never load
PROGRAM = "wgatools_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "wgatools_tpu")
# NVIDIA's data sheet, H100 SXM at 700 W: HBM bytes per second
PEAK_BYTES_PER_S = 3.35e12
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_part(kind, name):
    """The module benchmark/<kind>/<name>.py."""
    path = os.path.join(BENCH, kind, name + ".py")
    if not os.path.exists(path):
        raise SystemExit(f"benchmark: no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_spec(workload):
    """Everything BENCHMARK.json and the cell's files say of one cell."""
    bench = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"benchmark: no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return {
        "cell": cell,
        "config": load_json(ROOT, config["file"]),
        "traffic": load_json(BENCH, "traffic", cell["traffic"] + ".json"),
        "work": load_json(BENCH, "workloads", workload + ".json"),
        "end_to_end": [m for m in bench["end_to_end"]
                       if workload in m.get("workloads", [workload])],
        "per_layer": [m for m in bench["per_layer"]
                      if workload in m.get("workloads", [workload])],
    }


def pinned_env(env):
    """The card route, whatever the caller's environment says (the host
    engine's switch removed, the device named), and every build and kernel
    cache inside the checkout, at fixed paths."""
    env = dict(env)
    env.pop("WGA_TPU_DEVICE", None)
    env["WGA_TORCH_DEVICE"] = "cuda"
    env["USE_FLAX"] = "0"
    cache = os.path.join(ROOT, "build", "benchmark")
    env["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    env["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    return env


def forbidden_modules(names):
    """The forbidden top-level names among module names."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def cached_input(spec, seed, keep=12, cache_dir=None):
    """The cell's input for `seed`: generated once into build/benchmark/inputs
    of the checkout, under a key of the configuration's name, the seed and a
    digest of the generator's source and parameters, and read back by later
    runs.  Returns (path, work counts).  Only the `keep` newest inputs of a
    configuration stay."""
    gen = spec["config"]["generator"]
    source = os.path.join(BENCH, "gen", gen["name"] + ".py")
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + json.dumps(gen, sort_keys=True)
                                .encode()).hexdigest()[:16]
    cache = cache_dir or os.path.join(ROOT, "build", "benchmark", "inputs")
    name = spec["cell"]["config"]
    stem = os.path.join(cache, f"{name}-{seed}-{digest}")
    path = stem + spec["config"]["suffix"]
    if os.path.exists(path) and os.path.exists(stem + ".json"):
        os.utime(path)
        return path, load_json(stem + ".json")
    os.makedirs(cache, exist_ok=True)
    counts = load_part("gen", gen["name"]).generate(path + ".part", seed,
                                                    **gen["params"])
    os.replace(path + ".part", path)
    with open(stem + ".json", "w") as f:
        json.dump(counts, f)
    inputs = sorted((p for p in os.listdir(cache) if p.startswith(name + "-")
                     and not p.endswith((".json", ".part"))),
                    key=lambda p: os.path.getmtime(os.path.join(cache, p)))
    for old in inputs[:-keep]:
        os.remove(os.path.join(cache, old))
        os.remove(os.path.join(cache, os.path.splitext(old)[0] + ".json"))
    return path, counts


def fill(argv, **paths):
    return [a.format(**paths) for a in argv]


def nearest_rank(values, q):
    """The q-quantile by nearest rank: the smallest sample with at least a
    share q of the samples at or below it."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def work_bytes(model, counts):
    """The input's work bytes under a cell's model {count name: bytes}."""
    return sum(coef * counts[name] for name, coef in model.items())


class Reservoir:
    """A uniform sample of `size` invocations out of however many the window
    holds, drawn from the seed before each invocation runs: invocation i is
    kept with probability size / (i + 1), in place of a random earlier
    one."""

    def __init__(self, seed, size):
        self.rng = random.Random(seed)
        self.size = size
        self.kept = {}  # invocation index -> path
        self._victim = None

    def wants(self, i):
        """Whether invocation i's output will be kept."""
        if len(self.kept) < self.size:
            self._victim = None
            return True
        if self.rng.random() < self.size / (i + 1):
            self._victim = self.rng.choice(sorted(self.kept))
            return True
        return False

    def keep(self, i, path, keep_path):
        if self._victim is not None:
            os.remove(self.kept.pop(self._victim))
        os.replace(path, keep_path)
        self.kept[i] = keep_path


def closed_loop(invoke, seconds, reservoir, out_path, keep_path):
    """One client: each invocation starts when the one before returns, until
    `seconds` have passed; the invocation in flight then runs to its end.
    `invoke(i, output)` writes to `out_path`.  Returns (samples, window
    seconds).  Stops at the first failure."""
    samples = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        i = len(samples)
        wanted = reservoir.wants(i)
        sample = invoke(i, out_path)
        samples.append(sample)
        if not sample["ok"]:
            break
        if wanted:
            reservoir.keep(i, out_path, keep_path(i))
    return samples, time.perf_counter() - t0


def compare(expected, got):
    """(equal, differing lines): lines compared in order, surplus or missing
    lines counted as differing."""
    if expected == got:
        return True, 0
    a, b = expected.split(b"\n"), got.split(b"\n")
    return False, sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))


# ---- the profiler's trace ----

def device_events(trace_path):
    """[(category, name, start us, duration us)] of the device's work."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    return [(e["cat"], e["name"], float(e["ts"]), float(e.get("dur", 0)))
            for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def annotations(trace_path, name):
    """[(start us, end us)] of the user annotation `name`."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
            for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e.get("name") == name]


def merged(intervals):
    """The union of [start, end) intervals, as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events):
    """Busy seconds (the union of all device work), kernel seconds (the sum
    of every kernel that is not a copy: NCCL's collectives are copies
    between cards, and wait for the slowest rank), and the seconds by
    device operation name."""
    busy = merged((ts, ts + dur) for _, _, ts, dur in events)
    by_name = {}
    for _, name, _, dur in events:
        by_name[name] = by_name.get(name, 0.0) + dur * 1e-6
    return {
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "kernel_s": sum(dur for cat, name, _, dur in events
                        if cat == "kernel" and not name.startswith("nccl"))
        * 1e-6,
        "by_name": by_name,
        "busy": busy,
    }


def idle_gaps(busy, spans):
    """The gaps between device work, each labelled by what the host did in
    it: the tool's host work inside one call (one of `spans`), or the end of
    one call and the start of the next, with the harness between them."""
    gaps = []
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        inside = any(s <= end and nxt <= e for s, e in spans)
        gaps.append(("the tool's host work inside one call" if inside else
                     "the end of one call, the harness, the start of the next",
                     (nxt - end) * 1e-6))
    return gaps


def top(pairs, n=10):
    return [[k, v] for k, v in sorted(pairs, key=lambda kv: -kv[1])[:n]]


def read_traces(paths, spans):
    """Busy and kernel seconds summed over the traces at `paths`, device
    seconds by operation name, and each trace's idle gaps, labelled by the
    invocation spans `spans(path)`; `breakdown` is the result's top ten."""
    out = {"busy_s": 0.0, "kernel_s": 0.0, "by_name": {}, "gaps": []}
    for path in paths:
        s = summarize(device_events(path))
        out["busy_s"] += s["busy_s"]
        out["kernel_s"] += s["kernel_s"]
        for k, v in s["by_name"].items():
            out["by_name"][k] = out["by_name"].get(k, 0.0) + v
        out["gaps"] += idle_gaps(s["busy"], spans(path))
    out["breakdown"] = {"device_ops": top(out["by_name"].items()),
                        "idle_gaps": top(out["gaps"])}
    return out


# ---- device memory of other processes, by NVML ----

def nvml_cards():
    """(count, name of the first) of the cards this process may use, as NVML
    reads them, CUDA_VISIBLE_DEVICES applied: (0, None) without NVML."""
    try:
        lib = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return 0, None
    if lib.nvmlInit_v2() != 0:
        return 0, None
    try:
        n = ctypes.c_uint(0)
        if lib.nvmlDeviceGetCount_v2(ctypes.byref(n)) != 0:
            return 0, None
        ids = list(range(n.value))
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        if visible is not None:
            ids = [int(v) for v in visible.split(",") if v.strip().isdigit()
                   and int(v) < n.value]
        if not ids:
            return 0, None
        h = ctypes.c_void_p()
        name = ctypes.create_string_buffer(96)
        if (lib.nvmlDeviceGetHandleByIndex_v2(ids[0], ctypes.byref(h))
                or lib.nvmlDeviceGetName(h, name, 96)):
            return 0, None
        return len(ids), name.value.decode()
    finally:
        lib.nvmlShutdown()


class _NvmlMemory(ctypes.Structure):
    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


class MemoryPoller:
    """The peak of the device memory in use on cards 0..count-1, as NVML
    reads it every `period` seconds from a thread: the memory of the CLI
    processes the harness starts, contexts included."""

    def __init__(self, count, period=0.01):
        self.lib = ctypes.CDLL("libnvidia-ml.so.1")
        if self.lib.nvmlInit_v2() != 0:
            raise RuntimeError("nvmlInit_v2 failed")
        self.handles = []
        for i in range(count):
            h = ctypes.c_void_p()
            if self.lib.nvmlDeviceGetHandleByIndex_v2(i, ctypes.byref(h)):
                raise RuntimeError(f"NVML has no device {i}")
            self.handles.append(h)
        self.period = period
        self.peak = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)

    def read(self):
        used = []
        for h in self.handles:
            m = _NvmlMemory()
            if self.lib.nvmlDeviceGetMemoryInfo(h, ctypes.byref(m)) == 0:
                used.append(m.used)
        return max(used, default=0)

    def _poll(self):
        while not self._stop.is_set():
            self.peak = max(self.peak, self.read())
            self._stop.wait(self.period)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.lib.nvmlShutdown()
