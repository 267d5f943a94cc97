"""`maf2paf`, `maf2chain`, `paf2chain` and `chain2paf` (reference:
converter.rs:29-92, 148-173, 391-416) through the device.

The device branches of wgatools_tpu/tools/convert.py on PyTorch:

- `maf2paf` and `maf2chain`: MAF records batch through the run extraction
  (ops.rle_device: kernel A or D counts, torch extracts), one batch in
  flight, and the host formats PAF rows or chain blocks from each record's
  run table;
- `paf2chain`: op tables batch through chain_scan (kernel B's chain mode),
  the exclusive cumulative I/D tables every chain data line needs, and the
  host gathers the M-run boundaries and formats.

Header trims, the boundary gathers, the PAF and chain writers and the host
branches are the TPU package's own host code, so both engines write the
same bytes by construction.
"""

import numpy as np
import torch

from wgatools_tpu import native
from wgatools_tpu.core import cigar as C
from wgatools_tpu.core.metrics import METRICS
from wgatools_tpu.io.chain import chain_header_from_record, write_chain_record
from wgatools_tpu.io.paf import PafRecord, PafWriter
from wgatools_tpu.tools.convert import (
    _chain_block_from_scan,
    _emit_chain,
    _maf_ext_runs,
    _paf_from_cigar,
    _write_chain_from_ops,
)

from ..core.device import DEVICE_MIN_COLUMNS, DEVICE_MIN_OPS
from ..ops.batch import DEFAULT_BATCH_COLUMNS, _PinnedUpload
from ..ops.classify import pack_pairs
from ..ops.liftover import chain_scan, int32_safe_record, pack_ops_batch
from ..ops.rle_device import finish_runs, split_run_tables, start_runs


def maf2paf(mafreader, writer, device, query_name=None):
    """MAF -> PAF on `device`; batches below DEVICE_MIN_COLUMNS columns
    are answered on the host, as in the TPU package."""
    paf_writer = PafWriter(writer)

    def emit(rec, _index, vals, lens):
        cigar = C.cigar_from_runs(vals, lens, rec.is_negative)
        paf_writer.write_record(_paf_from_cigar(rec, cigar))

    _batched_ext_runs(mafreader, query_name, emit, device)
    writer.flush()


def maf2chain(mafreader, writer, device, query_name=None):
    """MAF -> chain on `device`: chain ids count records in input order."""

    def emit(rec, chain_id, vals, lens):
        _emit_chain(writer, rec, chain_id, vals, lens)

    _batched_ext_runs(mafreader, query_name, emit, device)
    writer.flush()


def _batched_ext_runs(mafreader, query_name, emit, device):
    """Stream MAF records through the run extraction on `device`, calling
    emit(record, index, run_vals, run_lens) in input order.

    One batch in flight: start_runs uploads batch i+1 and launches its
    statistics kernel before finish_runs waits for batch i, so the host
    parses and packs while the device works.  A batch holds up to
    DEFAULT_BATCH_COLUMNS padded columns; one of fewer than
    DEVICE_MIN_COLUMNS columns is answered by the host engine."""
    uploader = _PinnedUpload(device) if device.type == "cuda" else None
    pending = []
    max_len = 0
    next_index = 0
    in_flight = None  # (records, device state) or ("host", records)

    def dispatch():
        nonlocal max_len
        if not pending:
            return None
        recs = list(pending)
        pending.clear()
        max_len = 0
        total_cols = sum(len(r.target_seq) for r in recs)
        if total_cols < DEVICE_MIN_COLUMNS:
            return ("host", recs)
        with METRICS.stage("pack", total_cols * 2):
            t, q, lens = pack_pairs([(r.target_seq, r.query_seq) for r in recs])
        return (recs, start_runs(t, q, lens, device, uploader=uploader))

    def drain(batch):
        nonlocal next_index
        if batch[0] == "host":
            for rec in batch[1]:
                vals, lens = _maf_ext_runs(rec)
                emit(rec, next_index, vals, lens)
                next_index += 1
            return
        recs, state = batch
        with METRICS.stage("device_rle"):
            row_ids, cats, run_lens = finish_runs(state)
        for rec, (vals, lens) in zip(
            recs, split_run_tables(len(recs), row_ids, cats, run_lens)
        ):
            emit(rec, next_index, vals, lens)
            next_index += 1

    for record in mafreader.records():
        if query_name is not None:
            record.set_query_idx_byname(query_name)
        n = len(record.target_seq)
        new_max = max(max_len, n)
        if pending and new_max * (len(pending) + 1) > DEFAULT_BATCH_COLUMNS:
            nf = dispatch()
            if in_flight is not None:
                drain(in_flight)
            in_flight = nf
            new_max = n
        max_len = new_max
        pending.append(record)
    nf = dispatch()
    if in_flight is not None:
        drain(in_flight)
    if nf is not None:
        drain(nf)


def paf2chain(pafreader, writer, device):
    """PAF -> chain on `device`; batches below DEVICE_MIN_OPS ops are still
    answered on the host, as in the TPU package."""
    _paf2chain_device(pafreader, writer, device)


def _paf2chain_device(pafreader, writer, device, batch_ops=1 << 20,
                      min_ops=None):
    """Batched pipeline: chain_scan tables on `device`, M-run boundary
    gathers + C++ formatting on the host.  Records without ops, or whose
    lengths sum to 2^31 or more, take the host path in order."""
    if min_ops is None:
        min_ops = DEVICE_MIN_OPS

    pending = []  # (record, ops, lens)
    total = 0
    next_id = 0

    def emit_from_tables(record, ops, lens, ei, ed):
        nonlocal next_id
        header = chain_header_from_record(record, *C.trims_from_ops(ops, lens))
        header.chain_id = next_id
        sizes, dqs, dts, final = _chain_block_from_scan(
            record, ops, lens, ei, ed
        )
        write_chain_record(writer, header, (sizes, dqs, dts), final)
        next_id += 1

    def flush():
        nonlocal total, next_id
        if not pending:
            return
        if total < min_ops:
            # too small to amortize device dispatch
            for record, ops, lens in pending:
                _write_chain_from_ops(writer, native, record, next_id, ops, lens)
                next_id += 1
            pending.clear()
            total = 0
            return
        ops_b, lens_b = pack_ops_batch(
            [p[1] for p in pending], [p[2] for p in pending]
        )
        with METRICS.stage("device_chain_scan", ops_b.nbytes * 5):
            ei_b, ed_b = chain_scan(
                torch.from_numpy(ops_b).to(device),
                torch.from_numpy(lens_b).to(device),
            )
            ei_b = ei_b.cpu().numpy()
            ed_b = ed_b.cpu().numpy()
        for k, (record, ops, lens) in enumerate(pending):
            n = len(ops)
            emit_from_tables(record, ops, lens, ei_b[k, :n], ed_b[k, :n])
        pending.clear()
        total = 0

    for record in pafreader.records():
        ops, lens = record.get_cigar_ops()
        if not int32_safe_record(lens):
            flush()  # keeps chain ids in order
            _write_chain_from_ops(writer, native, record, next_id, ops, lens)
            next_id += 1
            continue
        pending.append((record, ops, lens))
        total += len(ops)
        if total >= batch_ops:
            flush()
    flush()
    writer.flush()


def chain2paf(chainreader, writer, device):
    """chain -> PAF on `device`; batches below DEVICE_MIN_OPS data lines
    are answered on the host, as in the TPU package."""
    _chain2paf_device(chainreader, writer, device)


def _paf_from_chain_sums(record, match, del_ct):
    """The PAF row of one chain record from its summed sizes (match) and
    dqs (del_ct), the cg:Z: string from its data lines."""
    ops, lens = record.op_arrays()
    cat = np.where(ops == C.OP_I, 1, np.where(ops == C.OP_D, 2, 0)).astype(
        np.uint8)
    cg = native.format_runs(cat, np.asarray(lens, np.int64), b"MID")
    if cg is None:  # no native library: a plain join
        cg = "".join(f"{n}{'MID'[v]}" for v, n in
                     zip(cat.tolist(), np.asarray(lens).tolist()))
    return PafRecord(
        query_name=record.query_name,
        query_length=record.query_length,
        query_start=record.query_start,
        query_end=record.query_end,
        strand=record.query_strand,
        target_name=record.target_name,
        target_length=record.target_length,
        target_start=record.target_start,
        target_end=record.target_end,
        matches=match,
        block_length=match + del_ct,
        mapq=255,
        tags=["cg:Z:" + cg],
    )


def _chain2paf_device(chainreader, writer, device, batch_lines=1 << 20,
                      min_lines=None):
    """Batched pipeline: per-record sums of sizes, dts and dqs as one
    device segment sum per batch of about `batch_lines` data lines, rows
    and cg strings formatted on the host.  A batch below `min_lines`
    (DEVICE_MIN_OPS) is answered by the host engine; a record whose sums
    reach 2^31 takes the int64 host path, in order."""
    if min_lines is None:
        min_lines = DEVICE_MIN_OPS
    paf_writer = PafWriter(writer)
    pending = []
    total = 0

    def flush():
        nonlocal total
        if not pending:
            return
        if total < min_lines:
            for record in pending:
                paf_writer.write_record(record.convert2paf())
        else:
            vals = np.stack([
                np.concatenate([r.sizes for r in pending]),
                np.concatenate([r.dts for r in pending]),
                np.concatenate([r.dqs for r in pending]),
            ], axis=1).astype(np.int32)
            row_ids = np.repeat(np.arange(len(pending), dtype=np.int32),
                                [len(r.sizes) for r in pending])
            with METRICS.stage("device_chain_sums", vals.nbytes):
                sums = torch.zeros((len(pending), 3), dtype=torch.int32,
                                   device=device)
                sums.index_add_(0, torch.from_numpy(row_ids).to(device).long(),
                                torch.from_numpy(vals).to(device))
                sums = sums.cpu().numpy()
            for record, (match, _, del_ct) in zip(pending, sums.tolist()):
                paf_writer.write_record(
                    _paf_from_chain_sums(record, match, del_ct))
        pending.clear()
        total = 0

    for record in chainreader.records():
        if (int(record.sizes.sum()) + int(record.dqs.sum())
                + int(record.dts.sum())) >= 2**31:
            flush()
            paf_writer.write_record(record.convert2paf())
            continue
        pending.append(record)
        total += len(record.sizes)
        if total >= batch_lines:
            flush()
    flush()
    writer.flush()
