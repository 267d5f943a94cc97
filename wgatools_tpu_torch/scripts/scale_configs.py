"""BASELINE configs 3-4 at profiling scale, through the port's command line.

The counterpart of scripts/scale_configs.py, with its rows, flags, defaults
and markdown table.  Config 3: variant calling and region extraction on a
chunked ~102 Mbp chromosome MAF (128 records x 800 000 columns;
caller.rs:109-149 is the reference's chunk loop).  Config 4: pafcov and
pafpseudo over an all-to-all PAF of 16 query samples x 8 targets (60 000
records of 60 CIGAR runs; pseudomaf.rs:24-74).

    python -m wgatools_tpu_torch.scripts.scale_configs [--out DIR]
        [--maf-records 128] [--maf-cols 800000] [--paf-records 60000]
        [--paf-runs 60]

The corpus is scripts.make_corpus's (the TPU repo's generator, the same
bytes), written to --out (build/scale_configs/ by default).  Every row is
one `python -m wgatools_tpu_torch ... -v` process: serial on the card (the
default device; the CLI's device routes, e.g. `pafcov` through kernel B),
`-t 4` (the port's fork pools), and, for `call`, `pafcov` and `pafpseudo`,
WGA_TPU_DIST with N = min(cards, 2) rank processes, one card each, merging
over NCCL.  Under WGA_TORCH_DEVICE=cpu every row runs on the CPU and the
distributed rows run 2 gloo ranks, for tests.  Each output is hashed (md5)
as soon as its process ends and then deleted, so that at most one ~1.7 GB
call VCF is on disk at a time; every `-t 4` and distributed output must
equal the serial one's bytes (pafpseudo: the output directory's files).
Prints each row's wall as it ends and the table at the end (the serial
rows' notes carry their md5, for comparison with the TPU package); logs
the card's name and power limit, each row's kernel launches (the ranks'
included) and, at the end, `kernel launches: {json}`, their sum, on
stderr.  Any failed row or cross-check raises.
"""

import argparse
import hashlib
import json
import os
import shutil
import socket
import subprocess
import sys
import time

import torch

from ..bench import card_name_and_power
from ..core.device import torch_device
from ..kernels import _build
from .make_corpus import write_corpus

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORK = os.path.join(REPO, "build", "scale_configs")
# how long one row's process (or its ranks) may take
ROW_TIMEOUT_S = 1800


def log(msg):
    sys.stderr.write(f"[scale_configs] {msg}\n")
    sys.stderr.flush()


def md5(path):
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def digest(path):
    """md5 of a file or, for a directory, of its files' names and md5s in
    name order (the TPU script's pseudo_dir_md5); the path is deleted."""
    if os.path.isdir(path):
        parts = [fn + ":" + md5(os.path.join(path, fn))
                 for fn in sorted(os.listdir(path))]
        shutil.rmtree(path)
        return hashlib.md5("\n".join(parts).encode()).hexdigest()
    h = md5(path)
    os.remove(path)
    return h


def logged_launches(log_path):
    """The kernel launches a `-v` process logged (`kernel launches:
    {json}`), or {} when it loaded no kernel."""
    with open(log_path) as f:
        for line in f:
            if "kernel launches: " in line:
                return json.loads(line.split("kernel launches: ", 1)[1])
    return {}


def _env(**extra):
    return dict(os.environ, PYTHONPATH=REPO, **extra)


def _failed(what, rc, log_path):
    with open(log_path) as f:
        tail = f.read()[-4000:]
    return RuntimeError(f"{what} exited {rc}:\n{tail}")


def run(argv, out_path):
    """One `python -m wgatools_tpu_torch argv -v` process, stdout to
    out_path and stderr to out_path.log; returns (wall, launches)."""
    t0 = time.perf_counter()
    with open(out_path, "wb") as out, open(out_path + ".log", "wb") as err:
        proc = subprocess.run(
            [sys.executable, "-m", "wgatools_tpu_torch", *argv, "-v"],
            stdout=out, stderr=err, env=_env(), cwd=REPO,
            timeout=ROW_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise _failed(" ".join(argv), proc.returncode, out_path + ".log")
    return wall, logged_launches(out_path + ".log")


def run_dist(argv, out_path, nproc, backend):
    """argv under WGA_TPU_DIST on nproc rank processes (rank k: stdout to
    out_path.k, stderr to out_path.k.log): every rank must exit 0 and log
    its `backend` init, and no rank but 0 may write to stdout.  Rank 0's
    stdout becomes out_path.  Returns (wall from the first start to the
    last exit, the ranks' launches summed)."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = []
    try:
        for k in range(nproc):
            env = _env(WGA_TPU_DIST="1",
                       JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       JAX_NUM_PROCESSES=str(nproc), JAX_PROCESS_ID=str(k))
            with open(f"{out_path}.{k}", "wb") as out, \
                    open(f"{out_path}.{k}.log", "wb") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "wgatools_tpu_torch", *argv, "-v"],
                    stdout=out, stderr=err, env=env, cwd=REPO))
        deadline = t0 + ROW_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.perf_counter()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    launches = {}
    for k, p in enumerate(procs):
        what = f"{' '.join(argv)}: rank {k}/{nproc}"
        rank_log = f"{out_path}.{k}.log"
        if p.returncode != 0:
            raise _failed(what, p.returncode, rank_log)
        with open(rank_log) as f:
            if f"process {k}/{nproc}" not in (text := f.read()) or \
                    f"backend {backend}" not in text:
                raise RuntimeError(f"{what} logged no {backend} init:\n"
                                   f"{text[-4000:]}")
        for kernel, count in logged_launches(rank_log).items():
            launches[kernel] = launches.get(kernel, 0) + count
        if k:
            if os.path.getsize(f"{out_path}.{k}"):
                raise RuntimeError(f"{what} wrote to stdout")
            os.remove(f"{out_path}.{k}")
    os.replace(f"{out_path}.0", out_path)
    return wall, launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=WORK)
    ap.add_argument("--maf-records", type=int, default=128)
    ap.add_argument("--maf-cols", type=int, default=800_000)
    ap.add_argument("--paf-records", type=int, default=60_000)
    ap.add_argument("--paf-runs", type=int, default=60)
    args = ap.parse_args(argv)
    device = torch_device()
    if device.type == "cuda":
        log(f"card: {card_name_and_power()}")
        nproc, backend = min(torch.cuda.device_count(), 2), "nccl"
        _build.lib()  # once here, not in every row's process
    else:
        nproc, backend = 2, "gloo"
    out = os.path.abspath(args.out)

    log("building corpus ...")
    t0 = time.perf_counter()
    maf, paf, _, _ = write_corpus(out, args.maf_records, args.maf_cols,
                                  args.paf_records, args.paf_runs)
    mbp = args.maf_records * args.maf_cols / 1e6
    log(f"corpus in {time.perf_counter() - t0:.3f} s; MAF ~{mbp:.0f} Mbp "
        "aligned columns")

    rows = []
    total = {}

    def record(name, wall_launches, note=""):
        wall, launches = wall_launches
        rows.append((name, wall, note))
        for kernel, count in launches.items():
            total[kernel] = total.get(kernel, 0) + count
        print(f"{name:40s} {wall:8.1f} s  {note}", flush=True)
        log(f"{name}: {wall:.3f} s, launched {json.dumps(launches)}")

    def cross_check(name, want, got):
        if got != want:
            raise RuntimeError(f"{name}: md5 {got} != serial {want}")
        return f"bytes==serial: {got == want}"

    def o(name):
        return os.path.join(out, name)

    # ---- config 3: index -> call -> maf-ext on the chromosome MAF ----
    record("maf-index", run(["maf-index", maf], o("idx.out")),
           f"md5 {md5(maf + '.index')}")

    serial = run(["call", maf, "-s", "-l0"], o("call.t1.vcf"))
    want = digest(o("call.t1.vcf"))
    record("call -s -l0 (serial)", serial, f"md5 {want}")
    w = run(["call", maf, "-s", "-l0", "-t", "4"], o("call.t4.vcf"))
    record("call -s -l0 -t4", w,
           cross_check("call -t4", want, digest(o("call.t4.vcf"))))
    w = run_dist(["call", maf, "-s", "-l0"], o("call.dist.vcf"), nproc,
                 backend)
    record(f"call -s -l0 WGA_TPU_DIST=1 x{nproc}", w,
           cross_check("call dist", want, digest(o("call.dist.vcf"))))

    # region extraction across the whole chromosome
    regions = ",".join(
        f"ref.chr1:{s}-{s + 5000}" for s in range(2000, 40_000_000, 2_000_000)
    )
    w = run(["maf-ext", maf, "-r", regions], o("ext.maf"))
    record("maf-ext (20 regions)", w, f"md5 {digest(o('ext.maf'))}")

    # chunk the chromosome (long-context analog)
    w = run(["chunk", maf, "-l", "100000"], o("chunk.maf"))
    record("chunk -l 100000", w, f"md5 {digest(o('chunk.maf'))}")

    # ---- config 4: pafcov + pafpseudo on the all-to-all PAF ----
    serial = run(["pafcov", paf], o("cov.t1.bed"))
    want = digest(o("cov.t1.bed"))
    record("pafcov (serial)", serial, f"md5 {want}")
    w = run(["pafcov", paf, "-t", "4"], o("cov.t4.bed"))
    record("pafcov -t4", w, cross_check("pafcov -t4", want,
                                        digest(o("cov.t4.bed"))))
    w = run_dist(["pafcov", paf], o("cov.dist.bed"), nproc, backend)
    record(f"pafcov WGA_TPU_DIST=1 x{nproc}", w,
           cross_check("pafcov dist", want, digest(o("cov.dist.bed"))))

    serial = run(["pafpseudo", paf, "-o", o("pp.t1")], o("pp1.log"))
    want = digest(o("pp.t1"))
    record("pafpseudo (serial, 16 samples x 8 targets)", serial, f"md5 {want}")
    w = run(["pafpseudo", paf, "-t", "4", "-o", o("pp.t4")], o("pp4.log"))
    record("pafpseudo -t4", w, "dir-" + cross_check(
        "pafpseudo -t4", want, digest(o("pp.t4"))))
    w = run_dist(["pafpseudo", paf, "-o", o("pp.dist")], o("ppd.log"), nproc,
                 backend)
    record(f"pafpseudo WGA_TPU_DIST=1 x{nproc}", w, "dir-" + cross_check(
        "pafpseudo dist", want, digest(o("pp.dist"))))

    log(f"kernel launches: {json.dumps(total)}")
    print("\n| run | wall | note |")
    print("|---|---|---|")
    for name, wall, note in rows:
        print(f"| `{name}` | {wall:.1f} s | {note} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
