"""Alignment statistics (reference: src/tools/stat.rs).

Per-record RecStats come from the host CIGAR engine (device=None) or from
the device: MAF records stream through ops.batch.stream_seq_pair_stats
(kernel A), PAF records through the segment sums of
tools.validate.stream_batch_stats; only those device branches import torch.
Aggregation merges records keyed by (ref_name, ref_size, query_name,
query_size) exactly like the reference, then natural-sorts rows by
ref_name; both engines share it, so they write the same bytes when their
counters agree.
"""

import itertools
from dataclasses import dataclass

import numpy as np

from ..core.cigar import RecStat, cigar_from_seqs, rec_stat_from_cigar, seq_bytes
from ..core.device import DEFAULT_BATCH_COLUMNS, DEVICE_MIN_COLUMNS
from ..core.fmt import fmt_f32
from ..core.metrics import METRICS
from ..core.natsort import rank_by_natural
from .validate import stream_batch_stats

STAT_COLUMNS = (
    "ref_name",
    "ref_size",
    "ref_start",
    "query_name",
    "query_size",
    "query_start",
    "aligned_size",
    "unaligned_size",
    "identity",
    "similarity",
    "matched",
    "mismatched",
    "ins_event",
    "del_event",
    "ins_size",
    "del_size",
    "inv_event",
    "inv_size",
    "inv_ins_event",
    "inv_ins_size",
    "inv_del_event",
    "inv_del_size",
)


@dataclass
class PairStat:
    """One record's stat keyed by its sequence pair (stat.rs:52-58)."""

    ref_name: str
    ref_size: int
    query_name: str
    query_size: int
    ref_start: int
    query_start: int
    rec_stat: RecStat


@dataclass
class Statistic:
    ref_name: str = ""
    ref_size: int = 0
    ref_start: int = 0
    query_name: str = ""
    query_size: int = 0
    query_start: int = 0
    aligned_size: int = 0
    unaligned_size: int = 0
    identity: float = 0.0
    similarity: float = 0.0
    matched: int = 0
    mismatched: int = 0
    ins_event: int = 0
    del_event: int = 0
    ins_size: int = 0
    del_size: int = 0
    inv_event: int = 0
    inv_size: float = 0.0
    inv_ins_event: int = 0
    inv_ins_size: int = 0
    inv_del_event: int = 0
    inv_del_size: int = 0

    def to_row(self) -> str:
        return "\t".join(
            (
                self.ref_name,
                str(self.ref_size),
                str(self.ref_start),
                self.query_name,
                str(self.query_size),
                str(self.query_start),
                str(self.aligned_size),
                str(self.unaligned_size),
                fmt_f32(self.identity),
                fmt_f32(self.similarity),
                str(self.matched),
                str(self.mismatched),
                str(self.ins_event),
                str(self.del_event),
                str(self.ins_size),
                str(self.del_size),
                str(self.inv_event),
                fmt_f32(self.inv_size),
                str(self.inv_ins_event),
                str(self.inv_ins_size),
                str(self.inv_del_event),
                str(self.inv_del_size),
            )
        )


def _stat_from_rec(rec) -> PairStat:
    """stat_rec (reference: stat.rs:226-250)."""
    return PairStat(
        ref_name=rec.target_name,
        ref_size=rec.target_length,
        query_name=rec.query_name,
        query_size=rec.query_length,
        ref_start=rec.target_start,
        query_start=rec.query_start,
        rec_stat=rec.get_stat(),
    )


def _copy_fields(stat: Statistic, rs: RecStat):
    stat.aligned_size = rs.aligned_size
    stat.matched = rs.matched
    stat.mismatched = rs.mismatched
    stat.ins_event = rs.ins_event
    stat.del_event = rs.del_event
    stat.ins_size = rs.ins_size
    stat.del_size = rs.del_size
    stat.inv_ins_event = rs.inv_ins_event
    stat.inv_ins_size = rs.inv_ins_size
    stat.inv_del_event = rs.inv_del_event
    stat.inv_del_size = rs.inv_del_size
    stat.inv_event = rs.inv_event
    stat.inv_size = rs.inv_size


def split_final(pair_stats) -> list:
    """--each mode: one row per record (reference: stat.rs:129-164).
    Note the reference leaves unaligned_size at 0 here."""
    out = []
    for ps in pair_stats:
        stat = Statistic(
            ref_name=ps.ref_name,
            ref_size=ps.ref_size,
            ref_start=ps.ref_start,
            query_name=ps.query_name,
            query_size=ps.query_size,
            query_start=ps.query_start,
        )
        _copy_fields(stat, ps.rec_stat)
        stat.identity = float(
            np.float32(stat.matched) / np.float32(stat.aligned_size)
        )
        stat.similarity = float(
            np.float32(stat.matched + stat.mismatched)
            / np.float32(stat.aligned_size)
        )
        out.append(stat)
    return out


def merge_final(pair_stats) -> list:
    """Default mode: aggregate by pair key with min-start tracking
    (reference: stat.rs:167-223)."""
    grouped = {}
    for ps in pair_stats:
        key = (ps.ref_name, ps.ref_size, ps.query_name, ps.query_size)
        grouped.setdefault(key, []).append(ps)
    out = []
    for (ref_name, ref_size, query_name, query_size), group in grouped.items():
        stat = Statistic(
            ref_name=ref_name,
            ref_size=ref_size,
            ref_start=ref_size,  # init to max, min-tracked below
            query_name=query_name,
            query_size=query_size,
            query_start=query_size,
        )
        for ps in group:
            rs = ps.rec_stat
            stat.aligned_size += rs.aligned_size
            stat.matched += rs.matched
            stat.mismatched += rs.mismatched
            stat.ins_event += rs.ins_event
            stat.del_event += rs.del_event
            stat.ins_size += rs.ins_size
            stat.del_size += rs.del_size
            stat.inv_ins_event += rs.inv_ins_event
            stat.inv_ins_size += rs.inv_ins_size
            stat.inv_del_event += rs.inv_del_event
            stat.inv_del_size += rs.inv_del_size
            stat.inv_event += rs.inv_event
            stat.inv_size = float(
                np.float32(stat.inv_size) + np.float32(rs.inv_size)
            )
            if ps.ref_start < stat.ref_start:
                stat.ref_start = ps.ref_start
            if ps.query_start < stat.query_start:
                stat.query_start = ps.query_start
        stat.unaligned_size = stat.ref_size - stat.aligned_size
        stat.identity = float(
            np.float32(stat.matched) / np.float32(stat.aligned_size)
        )
        stat.similarity = float(
            np.float32(stat.matched + stat.mismatched)
            / np.float32(stat.aligned_size)
        )
        out.append(stat)
    return out


def final_stats(pair_stats, each: bool) -> list:
    return split_final(pair_stats) if each else merge_final(pair_stats)


def write_style_result(pair_stats, writer, each: bool):
    write_final(final_stats(pair_stats, each), writer)


def write_final(final, writer):
    """The table: rows natural-sorted by ref_name under the header."""
    rank = rank_by_natural(s.ref_name for s in final)
    final.sort(key=lambda s: rank[s.ref_name])
    writer.write(("\t".join(STAT_COLUMNS) + "\n").encode("ascii"))
    for stat in final:
        writer.write((stat.to_row() + "\n").encode("ascii"))
    writer.flush()


def stat_maf(reader, writer, device, each=False, query_name=None,
             force_device=False, batch_columns=DEFAULT_BATCH_COLUMNS):
    """MAF statistics (reference: stat.rs:61-84).

    device=None: the host engine, no torch op.  Otherwise records go
    through the device batches on `device` once the input reaches
    DEVICE_MIN_COLUMNS aligned columns; below that the host engine answers
    (device dispatch does not pay off there), unless force_device.  The
    input is never held whole: the decision buffers at most
    DEVICE_MIN_COLUMNS columns."""
    if device is None:
        pair_stats = []
        for rec in reader.records():
            if query_name is not None:
                rec.set_query_idx_byname(query_name)
            pair_stats.append(_stat_from_rec(rec))
        write_style_result(pair_stats, writer, each)
        return

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

    # METRICS: the head's parse here, the stream's phases in
    # stream_seq_pair_stats (PairStat is built inside its emit phase)
    stream = items()
    head = []
    head_cols = 0
    if not force_device:
        with METRICS.stage("parse"):
            for item in stream:
                head.append(item)
                head_cols += len(item[0])
                if head_cols >= DEVICE_MIN_COLUMNS:
                    break
    if not force_device and head_cols < DEVICE_MIN_COLUMNS:
        with METRICS.stage("emit"):
            pair_stats = [
                PairStat(*m, rec_stat=rec_stat_from_cigar(
                    cigar_from_seqs(seq_bytes(t), seq_bytes(q), neg)))
                for t, q, neg, m in head
            ]
    else:
        from ..ops.batch import stream_seq_pair_stats

        pair_stats = [
            PairStat(*m, rec_stat=rs)
            for m, rs in stream_seq_pair_stats(
                itertools.chain(head, stream), device, batch_columns)
        ]
    with METRICS.stage("emit"):
        final = final_stats(pair_stats, each)
    with METRICS.stage("write"):
        write_final(final, writer)


def stat_paf(reader, writer, device, each=False):
    """PAF statistics (reference: stat.rs:87-105).  device=None: the host
    engine; otherwise the per-record counters on `device`.  Records
    stream; only the per-pair rows accumulate."""
    if device is None:
        pair_stats = [_stat_from_rec(rec) for rec in reader.records()]
        write_style_result(pair_stats, writer, each)
        return

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
