"""`stat` (reference: src/tools/stat.rs) through the device.

The device branches of wgatools_tpu/tools/stat.py on PyTorch: MAF records
stream through ops.batch.stream_seq_pair_stats (stat_maf), PAF records
through the segment sums of tools.validate.stream_batch_stats (stat_paf).
Aggregation,
sorting and formatting are the TPU package's own host code (PairStat,
write_style_result), and so is the host branch, so both engines write the
same bytes by construction.
"""

import itertools

from wgatools_tpu.core.cigar import cigar_from_seqs, rec_stat_from_cigar, seq_bytes
from wgatools_tpu.tools.stat import PairStat, write_style_result

from ..core.device import DEVICE_MIN_COLUMNS
from ..ops.batch import DEFAULT_BATCH_COLUMNS, stream_seq_pair_stats
from .validate import stream_batch_stats


def stat_maf(reader, writer, device, each=False, query_name=None,
             force_device=False, batch_columns=DEFAULT_BATCH_COLUMNS):
    """MAF statistics (reference: stat.rs:61-84).

    Records go through the device batches on `device` once the input
    reaches DEVICE_MIN_COLUMNS aligned columns; below that the host engine
    answers (device dispatch does not pay off there), unless force_device.
    The input is never held whole: the decision buffers at most
    DEVICE_MIN_COLUMNS columns."""

    def items():
        for rec in reader.records():
            if query_name is not None:
                rec.set_query_idx_byname(query_name)
            meta = (
                rec.target_name,
                rec.target_length,
                rec.query_name,
                rec.query_length,
                rec.target_start,
                rec.query_start,
            )
            yield (rec.target_seq, rec.query_seq, rec.is_negative, meta)

    stream = items()
    head = []
    head_cols = 0
    if not force_device:
        for item in stream:
            head.append(item)
            head_cols += len(item[0])
            if head_cols >= DEVICE_MIN_COLUMNS:
                break
    if not force_device and head_cols < DEVICE_MIN_COLUMNS:
        results = (
            (m, rec_stat_from_cigar(
                cigar_from_seqs(seq_bytes(t), seq_bytes(q), neg)))
            for t, q, neg, m in head
        )
    else:
        results = stream_seq_pair_stats(
            itertools.chain(head, stream), device, batch_columns
        )
    pair_stats = [
        PairStat(
            ref_name=m[0],
            ref_size=m[1],
            query_name=m[2],
            query_size=m[3],
            ref_start=m[4],
            query_start=m[5],
            rec_stat=rs,
        )
        for m, rs in results
    ]
    write_style_result(pair_stats, writer, each)


def stat_paf(reader, writer, device, each=False):
    """PAF statistics (reference: stat.rs:87-105), the per-record counters
    on `device`.  Records stream; only the per-pair rows accumulate."""
    pair_stats = [
        PairStat(
            ref_name=rec.target_name,
            ref_size=rec.target_length,
            query_name=rec.query_name,
            query_size=rec.query_length,
            ref_start=rec.target_start,
            query_start=rec.query_start,
            rec_stat=rs,
        )
        for rec, rs in stream_batch_stats(reader.records(), device)
    ]
    write_style_result(pair_stats, writer, each)
