"""`call` on MAF input (reference: src/tools/caller.rs) through the device.

The device branch of wgatools_tpu/tools/caller.py::call_var_maf on
PyTorch.  Each record is cut into the TPU package's SV-safe chunk plan, and
each chunk's caller-mode run table (gap/gap -> W) comes from the device:

- a record's chunks group into padded [K, Lmax] batches of up to 64 Mi
  columns, each sent once it holds two or more chunks and
  DEVICE_MIN_COLUMNS columns (the category-plane route, kernel A);
- a single chunk of DEVICE_MIN_COLUMNS or more goes up as a [1, n] batch
  (the byte route, kernel D, whenever n is not a multiple of 8);
- smaller chunks take the host engine.

The variant scan over the run tables, the chunk plan and the VCF writer are
the TPU package's own host code, so both engines write the same bytes by
construction.  Every chunk's runs are computed here and handed to
call_within_var, whose own dispatch would import the TPU package's device
modules.
"""

import logging

import numpy as np

from wgatools_tpu.core import cigar as C
from wgatools_tpu.io.vcf import VcfWriter
from wgatools_tpu.tools.caller import (
    DEFAULT_CHUNK_SIZE,
    _ChunkView,
    call_within_var,
    plan_chunks,
)

from ..core.device import DEVICE_MIN_COLUMNS
from ..ops.classify import pack_pairs
from ..ops.rle_device import batch_runs, split_run_tables

log = logging.getLogger("wgatools_tpu_torch")

# columns of chunks grouped into one device batch
GROUP_BUDGET = 64 << 20


def call_var_maf(mafreader, mafindex, writer, if_snp, if_inv, svlen_cutoff,
                 device, sample=None, query_name=None, query_regex=None,
                 chunk_size=None):
    """MAF variant calling with SV-safe chunking on `device` (reference:
    caller.rs:42-157)."""
    vcf = VcfWriter(writer, sample or "sample")
    contigs = None
    if mafindex:
        contigs = [
            (name, item["size"]) for name, item in mafindex.items()
            if item["isref"]
        ]
    vcf.write_header(contigs)
    for record in mafreader.records():
        call_record(record, vcf, if_snp, if_inv, svlen_cutoff, device,
                    chunk_size, query_name, query_regex)
    writer.flush()


def caller_runs(t_arr, q_arr, device):
    """Caller-mode run table (cats uint8, lens int64) of one chunk: a
    [1, n] device batch from DEVICE_MIN_COLUMNS columns on, the host
    engine below."""
    n = min(t_arr.shape[0], q_arr.shape[0])  # the host engine's zip rule
    if n < DEVICE_MIN_COLUMNS:
        return C.caller_runs(t_arr, q_arr)
    _, cats, lens = batch_runs(
        np.ascontiguousarray(t_arr[None, :n]),
        np.ascontiguousarray(q_arr[None, :n]),
        np.array([n], dtype=np.int32), device, caller=True,
    )
    return cats.astype(np.uint8), lens.astype(np.int64)


def call_record(record, vcf, if_snp, if_inv, svlen_cutoff, device,
                chunk_size=None, query_name=None, query_regex=None):
    """Variant rows of one record, chunk by chunk along its SV-safe chunk
    plan, written to `vcf` (the serial case of the TPU package's
    call_record_part; the parts of its multi-process modes are not
    ported).  Chunks group into device batches of up to GROUP_BUDGET
    columns."""
    if len(record.slines) == 1:
        return
    if query_name is not None:
        if record.get_query_idx_byname(query_name) is None:
            return
        record.set_query_idx_byname(query_name)
    elif query_regex is not None:
        try:
            record.set_query_idx_by_regex(query_regex)
        except Exception:  # the TPU package skips such records the same way
            return
    else:
        record.query_idx = 1

    view = _ChunkView(record)
    plan = plan_chunks(view.t_arr, view.q_arr, chunk_size or DEFAULT_CHUNK_SIZE,
                       svlen_cutoff)
    total_size = view.t_arr.shape[0]
    chunk_count = 0

    def emit_group(group):
        nonlocal chunk_count
        runs_list = [None] * len(group)
        if len(group) > 1 and sum(e - s for s, e, _ in group) >= DEVICE_MIN_COLUMNS:
            t, q, lens = pack_pairs(
                [(r.target_seq, r.query_seq) for _, _, r in group]
            )
            runs_list = split_run_tables(
                len(group), *batch_runs(t, q, lens, device, caller=True)
            )
        for (chunk_start, safe_end, chunk_rec), runs in zip(group, runs_list):
            chunk_count += 1
            log.info(
                "Processed chunk %d: start=%d, end=%d, size=%d, "
                "progress=%.2f%%",
                chunk_count, chunk_start, safe_end, safe_end - chunk_start,
                (safe_end / total_size) * 100.0 if total_size else 100.0,
            )
            if runs is None:
                runs = caller_runs(C.seq_bytes(chunk_rec.target_seq),
                                   C.seq_bytes(chunk_rec.query_seq), device)
            buf = [
                row if isinstance(row, (bytes, memoryview))
                else vcf.format_record(*row)
                for row in call_within_var(chunk_rec, if_snp, svlen_cutoff,
                                           if_inv, runs=runs)
            ]
            if buf:
                vcf.write_raw(b"".join(buf))

    group, group_cols = [], 0
    for chunk_start, safe_end in plan:
        group.append((chunk_start, safe_end, view.chunk(chunk_start, safe_end)))
        group_cols += safe_end - chunk_start
        if group_cols >= GROUP_BUDGET:
            emit_group(group)
            group, group_cols = [], 0
    if group:
        emit_group(group)
