"""Build, load and launch the hand-written CUDA kernels.

Each `csrc/*.cu` is compiled by its own `nvcc` process, all started
together, and the objects are linked into one shared library with a plain
C interface, under `build/wgatools_tpu_torch/` beside the package, at first
use (never at import: the CPU tests import every module).  The library is
rebuilt when a source is newer than it.  It is loaded with
ctypes; pointers and the stream go as `c_void_p`.  A failed build or launch
raises: nothing here falls back to the plain PyTorch versions.

Each C entry point returns `cudaGetLastError()` after its launch, and
`launch` raises when that is not 0.  `LAUNCHES` counts the successful
launches of each kernel, so that a run can show which kernels its path
went through.
"""

import ctypes
import glob
import os
import shutil
import subprocess
import threading

import torch

from ..core.metrics import METRICS

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "wgatools_tpu_torch")
LIB_NAME = "libwgatorch.so"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C argument types of each kernel entry point; the stream is appended last
SIGNATURES = {
    "classify_cat": [_P, _P, _P, _I, _LL, _I],
    "classify_bytes": [_P, _P, _P, _P, _I, _LL, _I],
    "classify_words": [_P, _P, _P, _P, _I, _LL, _I],
    "classify_nibbles": [_P, _P, _P, _P, _I, _LL, _I],
    "liftover_scan": [_P, _P, _P, _P, _P, _I, _LL, _I],
    "fused_adv16": [_I, *[_P] * 11, _I, _LL, _I, _LL, _I, _I, _I],
    "fused16": [_I, *[_P] * 10, _I, _LL, _I, _LL, _I],
    "fused_ops": [*[_P] * 9, _I, _LL, _I, _LL, _I],
}
# the library's other C entry points: (argument types, result type)
HELPERS = {
    "error_string": ([_I], ctypes.c_char_p),
    "liftover_scan_scratch": ([_I, _LL], _LL),
}

LAUNCHES = {name: 0 for name in SIGNATURES}

_lock = threading.Lock()
_lib = None


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, /usr/local/cuda/bin): the CUDA kernels "
            "of wgatools_tpu_torch cannot be built"
        )
    return nvcc


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _stale(lib_path) -> bool:
    if not os.path.exists(lib_path):
        return True
    built = os.path.getmtime(lib_path)
    deps = _sources() + glob.glob(os.path.join(CSRC, "*.cuh"))
    return any(os.path.getmtime(p) > built for p in deps)


def build(build_dir) -> str:
    """Compile each csrc/*.cu in parallel and link them into
    build_dir/LIB_NAME; returns its path.  The compilers' output (ptxas
    register and shared-memory use) is kept in build_dir/nvcc.log."""
    nvcc = find_nvcc()
    os.makedirs(build_dir, exist_ok=True)
    lib_path = os.path.join(build_dir, LIB_NAME)
    tag = os.getpid()
    steps = []
    for src in _sources():
        stem = os.path.splitext(os.path.basename(src))[0]
        obj = os.path.join(build_dir, f"{stem}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        steps.append((cmd, obj, proc))
    log, failed = [], []
    for cmd, _, proc in steps:  # wait for every compiler, failed or not
        out = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} (exit {proc.returncode}):\n{out[-4000:]}")
    objs = [obj for _, obj, _ in steps]
    try:
        if not failed:
            tmp = f"{lib_path}.{tag}.tmp"
            cmd = [nvcc, "-shared", "-o", tmp, *objs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f"link (exit {proc.returncode}):\n"
                              f"{proc.stderr[-4000:]}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
        with open(os.path.join(build_dir, "nvcc.log"), "w") as f:
            f.write("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, lib_path)  # atomic: a concurrent loader never sees half
    return lib_path


def lib():
    """The loaded kernel library, built first if missing or stale; the
    first load is the METRICS stage `lib_load`."""
    global _lib
    with _lock:
        if _lib is None:
            with METRICS.stage("lib_load"):
                lib_path = os.path.join(BUILD_DIR, LIB_NAME)
                if _stale(lib_path):
                    build(BUILD_DIR)
                handle = ctypes.CDLL(lib_path)
                for name, argtypes in SIGNATURES.items():
                    fn = getattr(handle, "wga_" + name)
                    fn.argtypes = argtypes + [_P]
                    fn.restype = _I
                for name, (argtypes, restype) in HELPERS.items():
                    fn = getattr(handle, "wga_" + name)
                    fn.argtypes = argtypes
                    fn.restype = restype
                _lib = handle
        return _lib


def check_cuda(*tensors):
    """Raise unless every tensor is a contiguous CUDA tensor on one card."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"expected CUDA tensors on one device, got {t.device} "
                f"beside {dev}"
            )
        if not t.is_contiguous():
            raise ValueError("expected contiguous tensors")


def launch(name, *args):
    """Run kernel `name` on the current stream of the first tensor
    argument's device.  Tensors go as their data pointers, ints as
    declared in SIGNATURES.  Does not synchronise."""
    fn = getattr(lib(), "wga_" + name)
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    cargs = [
        _P(a.data_ptr()) if isinstance(a, torch.Tensor) else a for a in args
    ]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*cargs, _P(stream))
    if err != 0:
        msg = lib().wga_error_string(err).decode()
        raise RuntimeError(f"kernel {name} failed to launch: {msg} ({err})")
    LAUNCHES[name] += 1
