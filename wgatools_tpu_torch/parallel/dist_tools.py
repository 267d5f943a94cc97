"""Distributed tool drivers: whole-tool flows across torch.distributed
ranks.

The port of wgatools_tpu/parallel/dist_tools.py.  Each rank claims record
work units from the MAF-index manifest (claim_work_units: deterministic,
coordinator-free) or a byte-range manifest every rank derives alike,
computes its partial results as the TPU package's ranks do (on the host
engine, and `call` on the rank's device as the serial tool does), and the
variable-length outputs are gathered with a length-padded byte all_gather
on the ranks' devices (replicate_rows: NCCL on the card, gloo on the CPU),
once every rank has reached the merge (wait_for_ranks), then merged
deterministically by the natural-sort rules the serial tools already
apply.  Output is byte-identical to the single-process tool.

Activation: run one process per rank with JAX_COORDINATOR_ADDRESS /
JAX_NUM_PROCESSES / JAX_PROCESS_ID set and WGA_TPU_DIST=1 (distributed.py);
the CLI then routes the distributed modes here.  Process 0 writes the
output, the other ranks write nothing.  A MAF index (`maf-index`) serves
as the restartable shard manifest when present; otherwise the ranks stripe
the raw record-offset scan.
"""

import io
import logging
import os
import pickle

import numpy as np

from ..core.metrics import METRICS
from .distributed import (
    claim_work_units,
    process_index_count,
    stdout_parked,
    wait_for_ranks,
)

log = logging.getLogger("wgatools_tpu_torch")


def dist_requested() -> bool:
    return os.environ.get("WGA_TPU_DIST", "") not in ("", "0", "false")


def replicate_rows(group, row):
    """This rank's row (a 1-D host array, one length and dtype on every
    rank) -> every rank's row as a host array [D, L], in rank order, on
    every rank of the mesh.RecordGroup: ONE all_gather."""
    import torch
    import torch.distributed as dist

    local = torch.from_numpy(np.ascontiguousarray(row).reshape(1, -1))
    local = local.to(group.device)
    out = torch.empty((group.size, local.shape[1]), dtype=local.dtype,
                      device=group.device)
    dist.all_gather_into_tensor(out, local, group=group.pg)
    return out.cpu().numpy()


def tool_group():
    """This rank's RecordGroup in the default process group: its card
    under NCCL (the card maybe_initialize_distributed bound), the CPU
    under gloo."""
    import torch
    import torch.distributed as dist

    from .mesh import RecordGroup

    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    return RecordGroup.current(device)


def allgather_bytes(payload: bytes):
    """All-gather variable-length byte strings across the ranks.

    One all_gather of the int64 lengths, then one all_gather of the
    payloads padded to the longest as uint8 rows; every rank receives
    every payload, in rank order.  The ranks first meet on the store
    (wait_for_ranks), so that no rank waits inside a collective for
    another's work.  Without a group the one payload is returned; a group
    of one rank runs both collectives, as _psum_row does.  METRICS: the
    meeting in stage `merge_wait`, the two collectives in `gather`, and
    the bytes this rank received (padding included) in the counter
    `allgather_bytes`."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return [payload]
    with METRICS.stage("merge_wait"):
        wait_for_ranks()
    with METRICS.stage("gather"):
        group = tool_group()
        lens = replicate_rows(group, np.array([len(payload)], np.int64))[:, 0]
        row = np.zeros(max(int(lens.max()), 1), np.uint8)
        row[: len(payload)] = np.frombuffer(payload, np.uint8)
        rows = replicate_rows(group, row)
    METRICS.count("allgather_bytes", rows.nbytes)
    return [rows[p, : int(n)].tobytes() for p, n in enumerate(lens)]


def _claimed_offsets(path, pid, nproc):
    """This process's record byte offsets: from the MAF-index shard
    manifest when present (claim_work_units -- restartable), else from a
    raw offset scan every process derives identically (the serial tools
    also work indexless)."""
    from ..tools.index import index_path_for, load_index

    if os.path.exists(index_path_for(path)):
        mafindex = load_index(index_path_for(path))
        units = claim_work_units(mafindex, pid, nproc)
        # units are (name, start, end, offset) per s-line; dedupe offsets
        # (a record's target s-line is the isref entry, one per record)
        return sorted({u[3] for u in units})
    from .host_pool import maf_record_offsets

    offsets = maf_record_offsets(path)
    return offsets[pid::nproc]


def distributed_stat_maf(path, writer, each=False, query_name=None):
    """Multi-process `stat`: claim -> local partials -> allgather -> merge.

    Each process seeks to its claimed records (MAF index offsets), computes
    PairStats on the host engine, and process 0 writes the merged table --
    byte-identical to the serial tool because write_style_result's
    merge/sort is order-insensitive at the pair level and `--each` rows are
    re-ordered by the deterministic unit order.
    """
    from ..io.maf import MafReader
    from ..tools.stat import _stat_from_rec, write_style_result

    pid, nproc = process_index_count()
    offsets = _claimed_offsets(path, pid, nproc)

    reader = MafReader.from_path(path)
    local = []
    for off in offsets:
        reader.seek(off)
        rec = reader.next_record()
        if rec is None:
            continue
        if query_name is not None:
            rec.set_query_idx_byname(query_name)
        local.append((off, _stat_from_rec(rec)))

    with stdout_parked():
        payloads = allgather_bytes(pickle.dumps(local, protocol=4))
    if pid != 0:
        return
    merged = []
    for blob in payloads:
        merged.extend(pickle.loads(blob))
    merged.sort(key=lambda t: t[0])  # deterministic record order
    write_style_result([ps for _, ps in merged], writer, each)


def _psum_row(local_row, contribute: bool):
    """Sum one int32 row across the ranks: ONE all_reduce on the rank's
    device, each rank adding its row (zeros where it does not contribute)
    -- pafcov.rs:42-53's elementwise vector sum as a collective."""
    import torch
    import torch.distributed as dist

    row = local_row if contribute else np.zeros_like(local_row)
    t = torch.from_numpy(np.ascontiguousarray(row, np.int32))
    if dist.is_initialized():
        group = tool_group()
        t = t.to(group.device)
        dist.all_reduce(t, group=group.pg)
    return t.cpu().numpy()


def distributed_pafcov(path, writer):
    """Multi-process `pafcov`: line-ranges -> local difference arrays ->
    per-target cross-process sum -> process 0 writes per-base BED.

    Byte-identical to the TPU package's distributed route: target output
    order is the global first-appearance order (range order == file
    order), and the merged difference arrays are exact int32 sums.
    """
    from ..io.paf import PafReader
    from ..tools.pafcov import accumulate_record, write_per_base_bed
    from .host_pool import paf_line_ranges

    pid, nproc = process_index_count()
    ranges = paf_line_ranges(path, nproc)

    diff_map = {}
    if pid < len(ranges):
        lo, hi, _ = ranges[pid]
        with open(path, "rb") as fp:
            fp.seek(lo)
            blob = fp.read(hi - lo)
        for rec in PafReader(io.BytesIO(blob)).records():
            accumulate_record(rec, diff_map)

    with stdout_parked():
        # agree on the global target list (first-appearance order across
        # ranges in file order) and sizes
        metas = allgather_bytes(
            pickle.dumps(
                [(t, d.shape[0]) for t, d in diff_map.items()], protocol=4
            )
        )
        order = []
        sizes = {}
        for blob in metas:
            for t, n in pickle.loads(blob):
                if t not in sizes:
                    order.append(t)
                    sizes[t] = n
                elif n > sizes[t]:
                    # inconsistent target_length fields across records:
                    # every rank must sum the SAME global shape, so agree
                    # on the maximum (the pooled merge's rule,
                    # host_pool.parallel_pafcov) -- a rank-local length
                    # would hang the collective
                    sizes[t] = n
        merged = {}
        for t in order:
            local = diff_map.get(t)
            contribute = local is not None
            if local is None:
                local = np.zeros(sizes[t], dtype=np.int32)
            elif local.shape[0] < sizes[t]:
                local = np.concatenate(
                    [local,
                     np.zeros(sizes[t] - local.shape[0], dtype=np.int32)]
                )
            merged[t] = _psum_row(local, contribute)

    if pid != 0:
        return
    for t in order:
        counts = np.cumsum(merged[t][:-1])
        write_per_base_bed(writer, t, counts)
    writer.flush()


def distributed_validate_paf(path, writer, fix_writer=None, fix_flag=False):
    """Multi-process `validate`: line-ranges -> local Validations ->
    allgather -> process 0 merges counters/lists/fixed rows in range
    (= file) order.  Byte-identical to the serial tool."""
    from ..io.paf import PafReader, PafWriter
    from ..tools.validate import Validations, check_record
    from .host_pool import paf_line_ranges

    pid, nproc = process_index_count()
    ranges = paf_line_ranges(path, nproc)

    vd_local = Validations()
    fixed = io.BytesIO()
    if pid < len(ranges):
        lo, hi, _ = ranges[pid]
        with open(path, "rb") as fp:
            fp.seek(lo)
            blob = fp.read(hi - lo)
        for rec in PafReader(io.BytesIO(blob)).records():
            check_record(rec, rec.get_stat(), vd_local, fix_flag)
        if fix_flag:
            paf_writer = PafWriter(fixed)
            for rec in vd_local.fix_paf_recs:
                paf_writer.write_record(rec)
            vd_local.fix_paf_recs = []

    part = (
        vd_local.total,
        vd_local.query_invalid,
        vd_local.query_inv_list,
        vd_local.ref_invalid,
        vd_local.ref_inv_list,
        fixed.getvalue(),
    )
    with stdout_parked():
        payloads = allgather_bytes(pickle.dumps(part, protocol=4))
    if pid != 0:
        return
    vd = Validations()
    fix_chunks = []
    for blob in payloads:
        total, q_inv, q_list, r_inv, r_list, fix_bytes = pickle.loads(blob)
        vd.total += total
        vd.query_invalid += q_inv
        vd.query_inv_list.extend(q_list)
        vd.ref_invalid += r_inv
        vd.ref_inv_list.extend(r_list)
        fix_chunks.append(fix_bytes)
    writer.write((vd.format() + "\n").encode("ascii"))
    writer.flush()
    if fix_writer is not None:
        for chunk in fix_chunks:
            fix_writer.write(chunk)
        fix_writer.flush()
    return vd


def distributed_call_maf(
    path,
    writer,
    if_snp,
    if_inv,
    svlen_cutoff,
    sample=None,
    query_name=None,
    query_regex=None,
    chunk_size=None,
    device=None,
):
    """Multi-process `call`: claim records from the index manifest, emit
    VCF body rows locally, allgather, merge in record-offset order.

    Process 0 writes header + merged body -- byte-identical to the serial
    tool (body rows are emitted per record and records are re-ordered by
    offset; within-record order is preserved by each worker).  device:
    each record's run tables come from the rank's device as in the serial
    tool's device route (call_record: chunk groups of DEVICE_MIN_COLUMNS
    or more), as the TPU package's ranks take theirs from the TPU; None
    runs the host engine.  METRICS: the device route's phases of each
    record (tools/caller.py; the claim and the reads in `parse`), the
    pickling of this rank's rows in `gather`, allgather_bytes' stages, and
    rank 0's sort and write in `merge`."""
    from ..io.maf import MafReader
    from ..io.vcf import VcfWriter
    from ..tools.caller import call_one_record, call_record
    from ..tools.index import index_path_for, load_index

    pid, nproc = process_index_count()
    mafindex = None
    phase = METRICS.phases()
    try:
        phase.to("parse")
        if os.path.exists(index_path_for(path)):
            mafindex = load_index(index_path_for(path))
        else:
            log.warning("maf index not found, will not generate contig info")
        offsets = _claimed_offsets(path, pid, nproc)

        reader = MafReader.from_path(path)
        local = []
        for off in offsets:
            phase.to("parse")
            reader.seek(off)
            rec = reader.next_record()
            if rec is None:
                continue
            body = io.BytesIO()
            if device is not None:
                call_record(rec, VcfWriter(body), if_snp, if_inv,
                            svlen_cutoff, device, chunk_size, query_name,
                            query_regex, phase)
            else:
                phase.to("emit")
                call_one_record(
                    rec, body, if_snp, if_inv, svlen_cutoff, chunk_size,
                    query_name, query_regex,
                )
            local.append((off, body.getvalue()))
        phase.to("gather")
        blob = pickle.dumps(local, protocol=4)
    finally:
        phase.stop()

    with stdout_parked():
        payloads = allgather_bytes(blob)
    if pid != 0:
        return
    with METRICS.stage("merge"):
        merged = []
        for blob in payloads:
            merged.extend(pickle.loads(blob))
        merged.sort(key=lambda t: t[0])
        vcf = VcfWriter(writer, sample or "sample")
        contigs = None
        if mafindex:
            contigs = [
                (name, item["size"])
                for name, item in mafindex.items()
                if item["isref"]
            ]
        vcf.write_header(contigs)
        for _, body in merged:
            writer.write(body)
        writer.flush()


def _merge_chunks_to(writer, payloads, pid):
    """Process 0 writes the gathered byte chunks in process (= file) order."""
    if pid != 0:
        return
    for chunk in payloads:
        writer.write(chunk)
    writer.flush()


# A MAF record whose text is at least this many bytes (~half that in
# alignment columns) is COLUMN-SLICED across all processes instead of
# being assigned to one: per-record granularity (the reference's rayon
# unit, converter.rs:43) would serialize a whole-chromosome record on one
# process.  Column classification is per-column, so contiguous slices
# classify independently and their run tables merge exactly at the
# boundaries.  Env-overridable for tests (WGA_TPU_GIANT_SPLIT).
GIANT_SPLIT_BYTES = 16 << 20


def _giant_threshold() -> int:
    return int(os.environ.get("WGA_TPU_GIANT_SPLIT", GIANT_SPLIT_BYTES))


def _giant_indices(path, offsets, threshold):
    """Record indices whose on-disk text reaches the split threshold --
    derived from the offset manifest alone, so every process agrees."""
    if not offsets:
        return set()
    end = os.path.getsize(path)
    bounds = list(offsets) + [end]
    return {
        k
        for k in range(len(offsets))
        if bounds[k + 1] - bounds[k] >= threshold
    }


def _giant_slice_runs(rec, pid, nproc):
    """ext-classify this process's contiguous column slice of one giant
    record.  Returns (cat_vals uint8, lens int64) for columns
    [L*pid//nproc, L*(pid+1)//nproc)."""
    from ..core.cigar import ext_runs, seq_bytes

    t = seq_bytes(rec.target_seq)
    q = seq_bytes(rec.query_seq)
    L = len(t)
    lo = (L * pid) // nproc
    hi = (L * (pid + 1)) // nproc
    if lo >= hi:
        return np.zeros(0, np.uint8), np.zeros(0, np.int64)
    return ext_runs(t[lo:hi], q[lo:hi])


def _merge_run_parts(parts):
    """Concatenate per-slice run tables, joining equal-category runs at
    slice boundaries (classification is per-column, so this equals the
    whole-record run table exactly; differential-tested)."""
    vals_out, lens_out = [], []
    for v, l in parts:
        v = np.asarray(v, np.uint8)
        l = np.array(l, np.int64, copy=True)
        if v.size == 0:
            continue
        if vals_out and vals_out[-1][-1] == v[0]:
            lens_out[-1][-1] += l[0]
            v, l = v[1:], l[1:]
            if v.size == 0:
                continue
        vals_out.append(v)
        lens_out.append(l)
    if not vals_out:
        return np.zeros(0, np.uint8), np.zeros(0, np.int64)
    return np.concatenate(vals_out), np.concatenate(lens_out)


def _distributed_maf_records(path, render, emit_merged, writer, query_name):
    """Shared skeleton of distributed maf2paf / maf2chain with giant-record
    column splitting.

    render(rec, k) -> bytes for a normally-assigned record;
    emit_merged(writer, rec, k, vals, lens) writes one giant record from
    its merged run table."""
    from ..io.maf import MafReader
    from .host_pool import _ranges, maf_record_offsets

    pid, nproc = process_index_count()
    offsets = maf_record_offsets(path)
    giants = (
        _giant_indices(path, offsets, _giant_threshold())
        if nproc > 1
        else set()
    )
    normal = [k for k in range(len(offsets)) if k not in giants]
    ranges = _ranges(len(normal), nproc) if normal else []

    reader = MafReader.from_path(path)
    rows = {}
    if pid < len(ranges):
        lo, hi = ranges[pid]
        for j in range(lo, hi):
            k = normal[j]
            reader.seek(offsets[k])
            rec = reader.next_record()
            if rec is None:
                break
            rows[k] = render(rec, k)

    if not giants:
        out = io.BytesIO()
        for k in sorted(rows):
            out.write(rows[k])
        with stdout_parked():
            payloads = allgather_bytes(out.getvalue())
        _merge_chunks_to(writer, payloads, pid)
        return

    # every process classifies its column slice of every giant record
    giant_recs = {}
    parts = {}
    for k in sorted(giants):
        reader.seek(offsets[k])
        rec = reader.next_record()
        if rec is None:
            continue
        if query_name is not None:
            rec.set_query_idx_byname(query_name)
        giant_recs[k] = rec
        parts[k] = _giant_slice_runs(rec, pid, nproc)

    with stdout_parked():
        payloads = allgather_bytes(
            pickle.dumps({"rows": rows, "parts": parts}, protocol=4)
        )
    if pid != 0:
        return
    all_rows = {}
    all_parts = {k: [None] * nproc for k in giant_recs}
    for p, blob in enumerate(payloads):
        d = pickle.loads(blob)
        all_rows.update(d["rows"])
        for k, vp in d["parts"].items():
            if k in all_parts:
                all_parts[k][p] = vp
    for k in range(len(offsets)):
        if k in giant_recs:
            vals, lens = _merge_run_parts(
                [vp for vp in all_parts[k] if vp is not None]
            )
            emit_merged(writer, giant_recs[k], k, vals, lens)
        elif k in all_rows:
            writer.write(all_rows[k])
    writer.flush()


def distributed_maf2paf(path, writer, query_name=None):
    """Multi-process `maf2paf`: contiguous record ranges from the raw
    offset scan (every process derives the same manifest), local PAF
    rendering, allgather, process 0 concatenates in record (= file)
    order.  Records over the giant threshold are column-sliced across
    ALL processes and their run tables boundary-merged (see
    _distributed_maf_records).  Byte-identical to the serial tool."""
    from ..core.cigar import cigar_from_runs
    from ..tools.convert import _paf_from_cigar

    def render(rec, _k):
        return rec.convert2paf(query_name).to_row()

    def emit_merged(w, rec, _k, vals, lens):
        cigar = cigar_from_runs(vals, lens, rec.is_negative)
        w.write(_paf_from_cigar(rec, cigar).to_row())

    _distributed_maf_records(path, render, emit_merged, writer, query_name)


def distributed_paf2chain(path, writer):
    """Multi-process `paf2chain` over line-aligned byte ranges; chain ids
    continue the serial numbering via the per-range record counts the
    manifest already carries.  Byte-identical to the serial tool."""
    from .host_pool import _paf2chain_worker, paf_line_ranges

    pid, nproc = process_index_count()
    ranges = [r for r in paf_line_ranges(path, nproc) if r[0] < r[1]]

    chunk = b""
    if pid < len(ranges):
        lo, hi, start_index = ranges[pid]
        chunk = _paf2chain_worker((path, lo, hi, start_index))

    with stdout_parked():
        payloads = allgather_bytes(chunk)
    _merge_chunks_to(writer, payloads, pid)


def distributed_chain2paf(path, writer):
    """Multi-process `chain2paf` over whole-record byte ranges.
    Byte-identical to the serial tool."""
    from .host_pool import _chain2paf_worker, _ranges, chain_record_offsets

    pid, nproc = process_index_count()
    offsets = chain_record_offsets(path)
    ranges = _ranges(len(offsets), nproc) if offsets else []

    chunk = b""
    if pid < len(ranges):
        lo, hi = ranges[pid]
        size = os.path.getsize(path)
        end = offsets[hi] if hi < len(offsets) else size
        chunk = _chain2paf_worker((path, offsets[lo], end))

    with stdout_parked():
        payloads = allgather_bytes(chunk)
    _merge_chunks_to(writer, payloads, pid)


def distributed_maf2chain(path, writer, query_name=None):
    """Multi-process `maf2chain`: contiguous record ranges; chain ids are
    the global record indices, so numbering matches the serial tool.
    Giant records column-slice across processes like distributed_maf2paf."""
    from ..tools.convert import _emit_chain, _maf_ext_runs

    def render(rec, k):
        if query_name is not None:
            rec.set_query_idx_byname(query_name)
        vals, lens = _maf_ext_runs(rec)
        out = io.BytesIO()
        _emit_chain(out, rec, k, vals, lens)
        return out.getvalue()

    def emit_merged(w, rec, k, vals, lens):
        _emit_chain(w, rec, k, vals, lens)

    _distributed_maf_records(path, render, emit_merged, writer, query_name)


def dist_output(out, rw):
    """Open the real output on process 0 only; other ranks sink to a
    BytesIO.  Opening on every rank races the overwrite guard: a non-zero
    rank would raise FileReWrite and exit BEFORE its first collective,
    hanging the surviving ranks inside the allgather."""
    from ..io.compression import open_output

    if process_index_count()[0] == 0:
        return open_output(out, rw)
    return io.BytesIO()


def distributed_filter_paf_align_pair(path, writer, min_align_size: int):
    """Multi-process all-to-all filter (reference filter.rs:108-160): the
    keyed-map sum of pass 1 merges via allgather (every process derives
    the identical keep set), pass 2's kept rows gather in range (= file)
    order.  Byte-identical to the serial tool."""
    from ..io.paf import PafReader, PafWriter
    from .host_pool import paf_line_ranges

    pid, nproc = process_index_count()
    ranges = [r for r in paf_line_ranges(path, nproc) if r[0] < r[1]]

    sums = {}
    blob = b""
    if pid < len(ranges):
        lo, hi, _ = ranges[pid]
        with open(path, "rb") as fp:
            fp.seek(lo)
            blob = fp.read(hi - lo)
        for rec in PafReader(io.BytesIO(blob)).records():
            key = (rec.query_name, rec.target_name)
            sums[key] = sums.get(key, 0) + rec.target_align_size

    with stdout_parked():
        partials = allgather_bytes(pickle.dumps(sums, protocol=4))
        merged = {}
        for p in partials:
            for key, v in pickle.loads(p).items():
                merged[key] = merged.get(key, 0) + v
        keep = {k for k, v in merged.items() if v >= min_align_size}

        out = io.BytesIO()
        if blob:
            paf_writer = PafWriter(out)
            for rec in PafReader(io.BytesIO(blob)).records():
                if (rec.query_name, rec.target_name) in keep:
                    paf_writer.write_record(rec)
        payloads = allgather_bytes(out.getvalue())
    _merge_chunks_to(writer, payloads, pid)


def distributed_stat_paf(path, writer, each=False):
    """Multi-process `stat -f paf`: line ranges -> local PairStats ->
    allgather -> process 0 writes the merged table (range order = file
    order, so --each rows match the serial tool)."""
    from ..io.paf import PafReader
    from ..tools.stat import _stat_from_rec, write_style_result
    from .host_pool import paf_line_ranges

    pid, nproc = process_index_count()
    ranges = [r for r in paf_line_ranges(path, nproc) if r[0] < r[1]]

    local = []
    if pid < len(ranges):
        lo, hi, _ = ranges[pid]
        with open(path, "rb") as fp:
            fp.seek(lo)
            blob = fp.read(hi - lo)
        local = [
            _stat_from_rec(rec) for rec in PafReader(io.BytesIO(blob)).records()
        ]

    with stdout_parked():
        payloads = allgather_bytes(pickle.dumps(local, protocol=4))
    if pid != 0:
        return
    merged = []
    for blob in payloads:
        merged.extend(pickle.loads(blob))
    write_style_result(merged, writer, each)


def distributed_dotplot_rows(path, format, mode, no_identity, skip_cutoff,
                             query_name):
    """Multi-process dotplot row collection (the reference rayon sites
    dotplot.rs:236,303-366): contiguous ranges, pooled-worker row logic,
    allgathered; process 0 gets the full row list in serial order, other
    ranks an empty list (they render to a sink)."""
    from .host_pool import (
        _PAF_RANGE_WORK,
        _WORK,
        _ranges,
        maf_record_offsets,
        paf_line_ranges,
    )

    pid, nproc = process_index_count()
    overview = mode == "overview"

    results = []
    if format == "maf":
        from ..io.maf import MafReader

        offsets = maf_record_offsets(path)
        rngs = _ranges(len(offsets), nproc) if offsets else []
        fn = _WORK["dotplot_overview" if overview else "dotplot_base"]
        extra = (
            (no_identity, query_name)
            if overview
            else (skip_cutoff, query_name)
        )
        if pid < len(rngs):
            lo, hi = rngs[pid]
            reader = MafReader.from_path(path)
            for k in range(lo, hi):
                reader.seek(offsets[k])
                rec = reader.next_record()
                if rec is None:
                    break
                results.append(fn(rec, None, k, extra))
    else:
        from ..io.paf import PafReader

        rngs = [r for r in paf_line_ranges(path, nproc) if r[0] < r[1]]
        fn = _PAF_RANGE_WORK[
            "dotplot_overview" if overview else "dotplot_base"
        ]
        extra = no_identity if overview else skip_cutoff
        if pid < len(rngs):
            lo, hi, idx = rngs[pid]
            with open(path, "rb") as fp:
                fp.seek(lo)
                blob = fp.read(hi - lo)
            results = fn(PafReader(io.BytesIO(blob)), io.BytesIO(), idx, extra)

    with stdout_parked():
        payloads = allgather_bytes(pickle.dumps(results, protocol=4))
    if pid != 0:
        return []
    rows = []
    for blob in payloads:
        part = pickle.loads(blob)
        if format == "maf":
            # same flatten rule as parallel_dotplot_rows: overview rows
            # and PlotSegs bundles append; fallback dict lists extend
            for r in part:
                if overview or not isinstance(r, list):
                    rows.append(r)
                else:
                    rows.extend(r)
        else:
            rows.extend(part)
    return rows
