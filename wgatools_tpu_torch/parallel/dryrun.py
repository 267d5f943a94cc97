"""The multi-rank dryrun: every sharded function on small shapes, per rank.

The port of __graft_entry__.dryrun_multichip.  `dryrun_multichip(group)`
runs on every rank of a RecordGroup: record-axis data parallelism (column
stats on byte, word and nibble planes; the liftover scan; kernel F and
every mode of kernel C), the per-pair stat merge (all_reduce), coverage
(all_reduce, and reduce_scatter + carry), the sequence-parallel scan
([2, B] all_gather carry) and the dist-tools row merge, each checked
against the plain versions and against each other as the TPU dryrun checks
them.  It returns the global results, gathered, for comparisons
elsewhere.

    python -m wgatools_tpu_torch.parallel.dryrun --nproc N

spawns N ranks (NCCL over N cards when the machine has them, gloo on the
CPU otherwise) and exits non-zero if any rank fails.
"""

import argparse
import multiprocessing as mp
import os
import queue
import sys
import tempfile
import traceback

import numpy as np
import torch

from ..kernels import _build
from ..ops.classify import (
    classify_stat_bytes_ref,
    pack_cat_nibbles,
    pack_nibble_words,
    pack_pairs,
)
from ..ops.liftover import (
    adv16_odd_offsets,
    expand_group_prefix,
    liftover_scan_ref,
    pack_ops_adv16,
    pack_ops_batch,
    pack_ops_sums,
    pack_ops_words16,
)
from .dist_tools import replicate_rows
from .mesh import (
    gather_rows,
    record_group,
    shard_rows,
    sharded_column_stats,
    sharded_coverage,
    sharded_coverage_scatter,
    sharded_fused16,
    sharded_fused_adv16,
    sharded_liftover,
    sharded_liftover_sp,
    sharded_pair_reduce,
)

GENOME = 1000
SPAWN_TIMEOUT_S = 300


def dryrun_inputs(n_ranks):
    """The TPU dryrun's host inputs for n_ranks devices, from seed 1, in
    the same order of draws (so the same arrays as dryrun_multichip(n))."""
    rng = np.random.default_rng(1)
    B = 4 * n_ranks
    pairs = []
    for _ in range(B):
        n = int(rng.integers(100, 256))
        t = rng.choice(list(b"ACGT-"), size=n).astype(np.uint8).tobytes()
        q = rng.choice(list(b"ACGT-"), size=n).astype(np.uint8).tobytes()
        pairs.append((t, q))
    x = {}
    x["t"], x["q"], x["lens"] = pack_pairs(pairs)
    x["pair_ids"] = (np.arange(B) % 3).astype(np.int32)
    x["starts"] = rng.integers(0, 900, size=B).astype(np.int32)
    x["ends"] = x["starts"] + rng.integers(1, 100, size=B).astype(np.int32)
    x["ops"], x["op_lens"] = pack_ops_batch(
        [np.frombuffer(b"MMMID", dtype=np.uint8) for _ in range(B)],
        [np.array([5, 7, 2, 3, 4]) for _ in range(B)],
    )
    x["tn"], x["qn"] = pack_nibble_words(x["t"], x["q"])
    op_chars = np.frombuffer(b"M=XID", np.uint8)
    ops16, lens16 = pack_ops_batch(
        [op_chars[rng.integers(0, 5, 16)] for _ in range(B)],
        [rng.integers(1, 100, 16) for _ in range(B)],
    )
    x["opw16"] = pack_ops_words16(ops16, lens16)
    x["wt16"], x["wq16"] = pack_ops_adv16(ops16, lens16)
    x["st16"], x["sq16"] = pack_ops_sums(ops16, lens16, group=8)
    x["cw"] = pack_cat_nibbles(x["t"], x["q"])
    x["sp_ops"] = op_chars[rng.integers(0, 5, (2, 16 * n_ranks))]
    x["sp_lens"] = rng.integers(1, 100, (2, 16 * n_ranks)).astype(np.int32)
    x["rows"] = np.arange(n_ranks * 16, dtype=np.uint8).reshape(n_ranks, 16)
    x["tw"] = np.ascontiguousarray(x["t"]).view("<i4")
    x["qw"] = np.ascontiguousarray(x["q"]).view("<i4")
    return x


def _equal(a, b, what):
    if a.shape != b.shape or not torch.equal(a, b):
        raise AssertionError(f"dryrun: {what}")


def dryrun_multichip(group):
    """Every check of the TPU dryrun on this rank's shards; returns a dict
    of the global results (numpy), gathered from every rank."""
    x = dryrun_inputs(group.size)
    rec = {k: shard_rows(group, x[k]) for k in (
        "t", "q", "lens", "pair_ids", "starts", "ends", "ops", "op_lens",
        "tn", "qn", "opw16", "wt16", "wq16", "st16", "sq16", "cw", "tw", "qw",
    )}
    out = {}

    def keep(name, *local, axis=0):
        out[name] = tuple(
            gather_rows(group, a, axis).cpu().numpy() for a in local
        )

    stats = sharded_column_stats(group, rec["t"], rec["q"], rec["lens"])
    _equal(stats, classify_stat_bytes_ref(rec["t"], rec["q"], rec["lens"]),
           "byte-plane stats != the plain version")
    keep("stats", stats)
    t_off, q_off = sharded_liftover(group, rec["ops"], rec["op_lens"])
    if t_off.shape != rec["ops"].shape or (
        t_off[0, :5].tolist() != [0, 5, 12, 14, 14]
    ):  # M5 M7 M2 I3 D4
        raise AssertionError(f"dryrun: liftover row {t_off[0, :5].tolist()}")
    keep("liftover", t_off, q_off)
    for name, planes, nibble in (
        ("stats_words", ("tw", "qw"), False),
        ("stats_nibbles", ("tn", "qn"), True),
    ):
        got = sharded_column_stats(group, rec[planes[0]], rec[planes[1]],
                                   rec["lens"], nibble=nibble)
        _equal(got, stats, f"{name} != byte-plane stats")
        keep(name, got)

    # kernel F on nibble planes, and on byte words: the same outputs
    p_outs = sharded_fused16(group, rec["tn"], rec["qn"], rec["lens"],
                             rec["opw16"], nibble=True)
    _equal(p_outs[0], stats, "fused16-nibble stats")
    keep("fused16", *p_outs)
    w_outs = sharded_fused16(group, rec["tw"], rec["qw"], rec["lens"],
                             rec["opw16"])
    for k in range(5):
        _equal(w_outs[k], p_outs[k], f"fused16 words[{k}] != nibble")

    # kernel C: adv16 pair words with odd offsets, as fused16's
    a_outs = sharded_fused_adv16(group, rec["tn"], rec["qn"], rec["lens"],
                                 rec["wt16"], rec["wq16"], nibble=True)
    _equal(a_outs[0], stats, "fused-adv16-nibble stats")
    for k in range(1, 5):
        _equal(a_outs[k], p_outs[k], f"fused-adv16 offsets[{k}] != fused16")
    keep("adv16", *a_outs)
    w_outs = sharded_fused_adv16(group, rec["tw"], rec["qw"], rec["lens"],
                                 rec["wt16"], rec["wq16"])
    for k in range(5):
        _equal(w_outs[k], a_outs[k], f"fused-adv16 words[{k}] != nibble")
    # ... even offsets only; odd = even + (w >> 14) on the host
    e_stats, e_te, e_qe = sharded_fused_adv16(
        group, rec["tn"], rec["qn"], rec["lens"], rec["wt16"], rec["wq16"],
        nibble=True, emit_odd=False,
    )
    _equal(e_stats, stats, "even-only stats")
    _equal(e_te, a_outs[1], "even-only t_even")
    _equal(e_qe, a_outs[3], "even-only q_even")
    for even, w, odd in ((e_te, "wt16", a_outs[2]), (e_qe, "wq16", a_outs[4])):
        _equal(adv16_odd_offsets(even, rec[w]), odd, f"odd from {w}")
    keep("adv16_even", e_stats, e_te, e_qe)
    # ... group-8 raw sums: anchors expand to the pair offsets
    g_stats, g_ta, g_qa = sharded_fused_adv16(
        group, rec["tn"], rec["qn"], rec["lens"], rec["st16"], rec["sq16"],
        nibble=True, raw_sums=True,
    )
    _equal(g_stats, stats, "g8 stats")
    for anchors, w, even in ((g_ta, "wt16", a_outs[1]),
                             (g_qa, "wq16", a_outs[3])):
        got = expand_group_prefix(anchors.cpu().numpy(),
                                  rec[w].cpu().numpy(), group=8)
        _equal(torch.from_numpy(got), even.cpu(), f"g8 anchors of {w}")
    keep("g8", g_stats, g_ta, g_qa)
    # ... catmode, in the TPU's per-step ("mm") and scan-once forms
    for name, scan_mode in (("cat", "mm"), ("cat_once", "once")):
        c_outs = sharded_fused_adv16(
            group, rec["cw"], None, rec["lens"], rec["st16"], rec["sq16"],
            catmode=True, scan_mode=scan_mode, raw_sums=True,
        )
        for k, want in enumerate((stats, g_ta, g_qa)):
            _equal(c_outs[k], want, f"{name}[{k}] != the nibble form")
        keep(name, *c_outs)

    # sequence parallelism: the op axis sharded, one [2, B] carry gather
    sp_ops = shard_rows(group, x["sp_ops"], axis=1)
    sp_lens = shard_rows(group, x["sp_lens"], axis=1)
    sp_t, sp_q = sharded_liftover_sp(group, sp_ops, sp_lens)
    keep("sp", sp_t, sp_q, axis=1)
    want = liftover_scan_ref(torch.from_numpy(x["sp_ops"]),
                             torch.from_numpy(x["sp_lens"]))
    for got, w, d in zip(out["sp"], want, "tq"):
        if not np.array_equal(got, w.numpy()):
            raise AssertionError(f"dryrun: sp scan {d}")

    pair_table = sharded_pair_reduce(group, stats, rec["pair_ids"], 3)
    coverage = sharded_coverage(group, rec["starts"], rec["ends"], GENOME)
    cov_rs = sharded_coverage_scatter(group, rec["starts"], rec["ends"],
                                      GENOME)
    _equal(cov_rs, coverage, "coverage reduce_scatter != all_reduce")
    out["pair_table"] = pair_table.cpu().numpy()
    out["coverage"] = coverage.cpu().numpy()

    # the dist tools' merge: every rank's row, replicated
    out["rows"] = replicate_rows(group, x["rows"][group.rank])
    if not np.array_equal(out["rows"], x["rows"]):
        raise AssertionError("dryrun: dist merge gather mismatch")

    # totals against a single-process reduction
    total = int(out["pair_table"][:, 0].sum())
    local = int(out["stats"][0][:, 0].sum())
    if total != local:
        raise AssertionError(f"dryrun: pair table {total} != stats {local}")
    expect = int(np.minimum(x["ends"], GENOME).sum() - x["starts"].sum())
    if int(out["coverage"].sum()) != expect:
        raise AssertionError("dryrun: coverage total")
    return out


def _rank_main(rank, size, backend, store_path, results, fn, args):
    """One spawned rank: init the group, run fn(group, *args), put
    (rank, error or None, result) on `results`."""
    try:
        torch.set_num_threads(1)
        device = (torch.device("cuda", rank) if backend == "nccl"
                  else torch.device("cpu"))
        with record_group(backend, store_path, rank, size, device) as group:
            result = fn(group, *args)
        if "jax" in sys.modules:
            raise AssertionError("a rank imported jax")
        results.put((rank, None, result))
    except Exception:  # reported to the parent, which raises
        results.put((rank, traceback.format_exc(), None))


def spawn(nproc, fn, *args, backend="gloo", store_dir=None):
    """Run fn(group, *args) on nproc new processes (spawn), one rank each,
    in a group of `backend` over a FileStore in store_dir (a new temporary
    directory when None).  fn must be importable by name and its result
    picklable.  Returns the results in rank order; raises RuntimeError with
    the rank's traceback if any rank fails or does not report within
    SPAWN_TIMEOUT_S, after stopping every rank."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        store = os.path.join(tmp, "store")
        results = ctx.Queue()
        procs = [
            ctx.Process(target=_rank_main,
                        args=(r, nproc, backend, store, results, fn, args))
            for r in range(nproc)
        ]
        for p in procs:
            p.start()
        got, errors = {}, []
        try:
            while len(got) + len(errors) < nproc and not errors:
                try:
                    rank, err, result = results.get(timeout=SPAWN_TIMEOUT_S)
                except queue.Empty:
                    errors.append(
                        f"no rank reported within {SPAWN_TIMEOUT_S} s")
                    break
                if err is None:
                    got[rank] = result
                else:
                    errors.append(f"rank {rank}:\n{err}")
        finally:
            for p in procs:
                p.join(timeout=0 if errors else 30)
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return [got[r] for r in range(nproc)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nproc", type=int, default=2)
    args = ap.parse_args(argv)
    if torch.cuda.is_available():
        if torch.cuda.device_count() < args.nproc:
            raise SystemExit(
                f"--nproc {args.nproc} needs {args.nproc} cards, have "
                f"{torch.cuda.device_count()}"
            )
        backend = "nccl"
        _build.lib()  # once here, not in every rank at the same time
    else:
        backend = "gloo"
    spawn(args.nproc, dryrun_multichip, backend=backend)
    print(f"dryrun: ok on {args.nproc} ranks ({backend})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
