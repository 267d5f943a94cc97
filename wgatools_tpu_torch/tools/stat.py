"""Alignment statistics (reference: src/tools/stat.rs).

Per-record RecStats come from the host CIGAR engine (device=None) or from
the device: MAF records stream through ops.batch.stream_stat_rows (kernel
A), a batch's counter rows at a time, PAF records through the segment sums
of tools.validate.stream_batch_stats; only those device branches import
torch.
Aggregation (StatFold) merges records keyed by (ref_name, ref_size,
query_name, query_size) exactly like the reference, as arrays: the device
route folds each batch's counter rows (ops.batch.stream_stat_rows) and the
per-record routes their RecStats (merge_final), then rows are
natural-sorted by ref_name; every route shares it, so they write the same
bytes when their counters agree.  Counters: `stat_fold_rows`, the records
StatFold folded, and `stat_record_rows`, those that went through a
per-record RecStat (final_stats).
"""

import itertools
import operator
from dataclasses import dataclass

import numpy as np

from .. import native
from ..core.cigar import RecStat, cigar_from_seqs, rec_stat_from_cigar
from ..core.device import DEFAULT_BATCH_COLUMNS, DEVICE_MIN_COLUMNS
from ..core.fmt import fmt_f32
from ..core.metrics import METRICS
from ..core.natsort import rank_by_natural
from ..core.strand import Strand
from ..io.maf import (
    BytesRows,
    MappedRows,
    forward_start,
    map_reader,
    mapped_records,
    query_by_name,
    query_index,
)
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


# RecStat's integer fields, in the order of StatFold's columns
SUM_FIELDS = (
    "aligned_size",
    "matched",
    "mismatched",
    "ins_event",
    "del_event",
    "ins_size",
    "del_size",
    "inv_ins_event",
    "inv_ins_size",
    "inv_del_event",
    "inv_del_size",
    "inv_event",
)
_PAIR_KEY = operator.itemgetter(0, 1, 2, 3)
_NO_START = np.iinfo(np.int64).max


def _starts(metas, col):
    """metas[k][col] as an int64 array, or of Python ints past int64."""
    starts = list(map(operator.itemgetter(col), metas))
    try:
        return np.array(starts, np.int64)
    except OverflowError:
        return np.array(starts, object)


class StatFold:
    """Default mode's aggregation (reference: stat.rs:167-223) over batches
    of records as arrays.  Records group by (ref_name, ref_size,
    query_name, query_size), the groups in order of first appearance; a
    group sums the records' integer fields, keeps the least ref_start and
    query_start (from its sizes down), and sums inv_size in float32 in
    input order, one record after the other, as the reference's loop."""

    def __init__(self):
        self.keys = {}  # pair key -> group id
        self.sums = np.zeros((0, len(SUM_FIELDS)), np.int64)
        self.starts = np.zeros((0, 2), np.int64)
        self.inv_size = np.zeros(0, np.float32)

    def add(self, metas, sums, inv_size):
        """Fold one batch: metas[k] is record k's (ref_name, ref_size,
        query_name, query_size, ref_start, query_start), sums[k] its
        integer fields in SUM_FIELDS' order (int64 [B, 12]), inv_size[k]
        its float32 inv_size."""
        B = len(metas)
        if not B:
            return
        METRICS.count("stat_fold_rows", B)
        keys = self.keys
        pairs = list(map(_PAIR_KEY, metas))
        ids = list(map(keys.get, pairs))
        if None in ids:  # a group's first record
            ids = [keys.setdefault(p, len(keys)) for p in pairs]
        gid = np.array(ids, np.intp)
        if len(keys) > len(self.inv_size):
            self._grow(len(keys))
        np.add.at(self.sums, gid, sums)
        for col in (0, 1):
            starts = _starts(metas, 4 + col)
            if starts.dtype == object:
                self.starts = self.starts.astype(object)
            np.minimum.at(self.starts[:, col], gid, starts)
        # a running float32 sum a group, in input order: a stable sort by
        # group keeps each group's records in order; +0.0 changes no sum
        inv = np.flatnonzero(inv_size != 0)
        if not inv.size:
            return
        order = np.argsort(gid[inv], kind="stable")
        g, v = gid[inv][order], inv_size[inv][order]
        cuts = [0, *(np.flatnonzero(g[1:] != g[:-1]) + 1).tolist(), len(g)]
        for lo, hi in zip(cuts, cuts[1:]):
            k = g[lo]
            carried = self.inv_size[k : k + 1]
            self.inv_size[k] = np.add.accumulate(
                np.concatenate((carried, v[lo:hi])))[-1]

    def _grow(self, n):
        n = max(n, 2 * len(self.inv_size))
        more = n - len(self.inv_size)
        self.sums = np.concatenate(
            (self.sums, np.zeros((more, len(SUM_FIELDS)), np.int64)))
        self.starts = np.concatenate(
            (self.starts, np.full((more, 2), _NO_START, self.starts.dtype)))
        self.inv_size = np.concatenate(
            (self.inv_size, np.zeros(more, np.float32)))

    def rows(self) -> list:
        """One Statistic a group, in order of first appearance."""
        out = []
        n = len(self.keys)
        for key, sums, (ref_start, query_start), inv_size in zip(
                self.keys, self.sums[:n].tolist(), self.starts[:n].tolist(),
                self.inv_size[:n].tolist()):
            ref_name, ref_size, query_name, query_size = key
            stat = Statistic(
                ref_name=ref_name,
                ref_size=ref_size,
                ref_start=min(ref_start, ref_size),
                query_name=query_name,
                query_size=query_size,
                query_start=min(query_start, query_size),
                inv_size=inv_size,
                **dict(zip(SUM_FIELDS, sums)),
            )
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


def merge_final(pair_stats) -> list:
    """Default mode: aggregate a list of PairStats by pair key with
    min-start tracking (reference: stat.rs:167-223), by StatFold over
    their RecStats."""
    fields = operator.attrgetter(*SUM_FIELDS)
    fold = StatFold()
    fold.add(
        [(ps.ref_name, ps.ref_size, ps.query_name, ps.query_size,
          ps.ref_start, ps.query_start) for ps in pair_stats],
        np.array([fields(ps.rec_stat) for ps in pair_stats],
                 np.int64).reshape(-1, len(SUM_FIELDS)),
        np.array([ps.rec_stat.inv_size for ps in pair_stats], np.float32),
    )
    return fold.rows()


def final_stats(pair_stats, each: bool) -> list:
    METRICS.count("stat_record_rows", len(pair_stats))
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


def _mapped_items(records, query_name):
    """The items of stat_maf's device route from io.maf.mapped_records:
    the same (t, q, negative, meta), and the same errors, as from
    MafRecords, with t and q the ranges of the rows in the mapping."""
    for slines in records:
        qi = 1 if query_name is None else query_by_name(
            (s[0] for s in slines), query_name)
        t_name, t_start, _, _, t_size, t = slines[0]
        q_name, q_start, q_align, q_strand, q_size, q = slines[
            query_index(len(slines), qi)]
        yield t, q, q_strand == Strand.NEGATIVE, (
            t_name, t_size, q_name, q_size, t_start,
            forward_start(q_start, q_align, q_strand, q_size))


def stat_maf(reader, writer, device, each=False, query_name=None,
             force_device=False, batch_columns=DEFAULT_BATCH_COLUMNS):
    """MAF statistics (reference: stat.rs:61-84).

    device=None: the host engine, no torch op.  Otherwise records go
    through the device batches on `device` once the input reaches
    DEVICE_MIN_COLUMNS aligned columns; below that the host engine answers
    (device dispatch does not pay off there), unless force_device.  The
    input is never held whole: the decision buffers at most
    DEVICE_MIN_COLUMNS columns.  On the device route a plain uncompressed
    file is mapped and tokenized by the native scanner
    (io.maf.mapped_records), and its rows are packed where they lie in
    the mapping; any other input, or no native library, goes through
    MafReader."""
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

    mm = map_reader(reader) if native.available() else None
    if mm is None:
        rows, stream = BytesRows, items()
    else:
        rows = MappedRows(mm)
        stream = _mapped_items(mapped_records(mm, reader.offset()), query_name)

    # METRICS: the head's parse here, the stream's phases in
    # stream_stat_rows (the fold runs inside its emit phase)
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
            final = final_stats([
                PairStat(*m, rec_stat=rec_stat_from_cigar(
                    cigar_from_seqs(rows.array(t), rows.array(q), neg)))
                for t, q, neg, m in head
            ], each)
    elif each:
        from ..ops.batch import stream_seq_pair_stats

        pair_stats = [
            PairStat(*m, rec_stat=rs)
            for m, rs in stream_seq_pair_stats(
                itertools.chain(head, stream), device, batch_columns, rows)
        ]
        with METRICS.stage("emit"):
            final = final_stats(pair_stats, each)
    else:
        from ..ops.batch import rec_stat_columns, stream_stat_rows

        fold = StatFold()
        for metas, counters, negative in stream_stat_rows(
                itertools.chain(head, stream), device, batch_columns, rows):
            fold.add(metas, *rec_stat_columns(counters, negative))
        with METRICS.stage("emit"):
            final = fold.rows()
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
