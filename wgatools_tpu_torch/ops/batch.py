"""Batched per-record statistics on the device: stat's device route.

Streams MAF records through ops.pipeline.overlapped in [B, L] column
batches, packs each batch's category plane on the host, reduces it with
classify_stat_cat on the device, and hands each batch's counter rows back
as one int64 array with its records' strands (stream_stat_rows), for
stat's columnar fold; stream_seq_pair_stats turns them into per-record
RecStats with host-side strand routing.  The plane is packed from where
each record's rows lie (their bytes, or their place in stat's mapped
input, io.maf) straight into the buffer that goes up, on CUDA the pinned
slot, and nothing past a row's length is written: the kernel and its plain
version mask those columns.  Without the native library the same layout is
packed by numpy.  Records of 2^31 columns or more would wrap the int32
counters and take the int64 host engine instead, in order.

On CUDA one batch is in flight: the host packs batch i+1 while the device
reduces batch i.  Each batch goes up from a PinnedSlots slot and its
counters come back with a non_blocking copy on the current stream; an
event recorded after the copy back is the one-batch-deep fence.
"""

import numpy as np
import torch

from .. import native
from ..core.cigar import EQ, D, I, X, Cigar, ext_runs, rec_stat_from_cigar
from ..core.device import DEFAULT_BATCH_COLUMNS
from ..core.metrics import METRICS
from ..io.maf import BytesRows
from .classify import (
    _CAT_LUT64K,
    STAT_DEL_EVENT,
    STAT_DEL_SIZE,
    STAT_INS_EVENT,
    STAT_INS_SIZE,
    STAT_MATCHED,
    STAT_MISMATCHED,
    classify_stat_cat,
    pack_cat_nibbles,
    pack_pairs,
)
from .pipeline import PinnedSlots, aligned, overlapped

# Records at or past this many columns go to the int64 host engine (the
# reference's counters are u64, cigar.rs:629-707).  A module attribute so
# that tests can lower it.
INT32_SAFE_COLUMNS = 2**31


def _host_pair_row(t_bytes, q_bytes):
    """int64 host-engine counters of one pair (the int32-overflow route)
    as a [1, 8] array in classify_stat_cat's row layout, STAT_GAPGAP and
    STAT_RUNS left 0 (no RecStat field reads them)."""
    t = np.frombuffer(t_bytes, dtype=np.uint8)
    q = np.frombuffer(q_bytes, dtype=np.uint8)
    vals, lens = ext_runs(t, q)
    lens = np.asarray(lens, dtype=np.int64)
    ins_mask = vals == I
    del_mask = vals == D
    row = np.zeros((1, 8), np.int64)
    row[0, STAT_MATCHED] = lens[vals == EQ].sum()
    row[0, STAT_MISMATCHED] = lens[vals == X].sum()
    row[0, STAT_INS_EVENT] = ins_mask.sum()
    row[0, STAT_INS_SIZE] = lens[ins_mask].sum()
    row[0, STAT_DEL_EVENT] = del_mask.sum()
    row[0, STAT_DEL_SIZE] = lens[del_mask].sum()
    return row


def stats_row_to_cigar(row, negative: bool) -> Cigar:
    """Device counter row -> Cigar (without the cigar string); a record on
    the negative strand books its indels as inversion events."""
    c = Cigar()
    c.match_count = int(row[STAT_MATCHED])
    c.mismatch_count = int(row[STAT_MISMATCHED])
    if negative:
        c.inv_event = 1
        c.inv_ins_event = int(row[STAT_INS_EVENT])
        c.inv_ins_count = int(row[STAT_INS_SIZE])
        c.inv_del_event = int(row[STAT_DEL_EVENT])
        c.inv_del_count = int(row[STAT_DEL_SIZE])
    else:
        c.ins_event = int(row[STAT_INS_EVENT])
        c.ins_count = int(row[STAT_INS_SIZE])
        c.del_event = int(row[STAT_DEL_EVENT])
        c.del_count = int(row[STAT_DEL_SIZE])
    return c


def pack_cat_plane(rows, ts, qs, lens, row_bytes, dst):
    """The category plane of rows ts[k] and qs[k], held as `rows` says
    (io.maf.BytesRows, MappedRows), lens[k] columns each, at byte
    k * row_bytes of dst: natively where the rows lie, nothing written
    past a row's last byte; without the library by numpy (pack_pairs,
    pack_cat_nibbles), row_bytes then being half pack_pairs' padded
    width."""
    if native.available():
        native.pack_cat_rows(rows.addresses(ts, lens), rows.addresses(qs, lens),
                             lens, row_bytes, _CAT_LUT64K, dst)
        return
    t, q, _ = pack_pairs([(rows.array(t), rows.array(q))
                          for t, q in zip(ts, qs)])
    assert t.shape[1] == 2 * row_bytes
    dst[: len(ts) * row_bytes] = pack_cat_nibbles(t, q).view(np.uint8).reshape(-1)


def rec_stat_columns(counters, negative):
    """RecStat's integer fields of a batch of counter rows (int64 [B, 8]),
    as columns in tools.stat.SUM_FIELDS' order, and its float32 inv_size:
    stats_row_to_cigar and core.cigar.rec_stat_from_cigar by array
    arithmetic.  negative[k] books row k's indels as inversion events."""
    neg = negative.astype(np.int64)
    fwd = 1 - neg
    matched = counters[:, STAT_MATCHED]
    mismatched = counters[:, STAT_MISMATCHED]
    ins_event = counters[:, STAT_INS_EVENT]
    ins_size = counters[:, STAT_INS_SIZE]
    del_event = counters[:, STAT_DEL_EVENT]
    del_size = counters[:, STAT_DEL_SIZE]
    aligned = matched + mismatched + del_size
    sums = np.stack([aligned, matched, mismatched,
                     ins_event * fwd, del_event * fwd,
                     ins_size * fwd, del_size * fwd,
                     ins_event * neg, ins_size * neg,
                     del_event * neg, del_size * neg, neg], axis=1)
    # f32 arithmetic in the reference (common.rs:135-137), inv_event 1
    query_aligned = matched + mismatched + ins_size
    inv_size = np.where(negative, (aligned + query_aligned).astype(np.float32)
                        / np.float32(2), np.float32(0))
    return sums, inv_size


def stream_stat_rows(items, device, batch_columns=DEFAULT_BATCH_COLUMNS,
                     rows=BytesRows):
    """Stream (t, q, negative, meta) items through the device, t and q a
    record's rows, held as `rows` says (io.maf.BytesRows: bytes objects;
    MappedRows: ranges in its buffer); yields one (metas, counters,
    negative) a batch in input order, one batch in flight (see the module
    docstring): the batch's metas as a list, its counter rows as an int64
    [B, 8] array of its own, and its strands as a bool [B] array.  A
    record of INT32_SAFE_COLUMNS or more is a batch of one, counted by the
    int64 host engine.  METRICS phases: `parse` while items are pulled,
    `pack`, then the device stage, and `emit` while a batch is yielded
    (the consumer's work on it included)."""
    cuda = device.type == "cuda"
    slots = PinnedSlots(device) if cuda else None
    phase = METRICS.phases()

    def start(batch):
        phase.to("pack")
        B = len(batch)
        ts = [it[0] for it in batch]
        qs = [it[1] for it in batch]
        lens = np.fromiter(map(min, map(len, ts), map(len, qs)), np.int32, B)
        L = max(-(-int(lens.max()) // 128) * 128, 128)  # as pack_pairs
        plane = B * L // 2
        off = aligned(plane)
        n = off + lens.nbytes
        host = slots.slot(n) if cuda else np.empty(n, np.uint8)
        pack_cat_plane(rows, ts, qs, lens, L // 2, host)
        host[off:] = lens.view(np.uint8)
        METRICS.count("slots", B * L)
        METRICS.count("padded_slots", B * L - int(lens.sum()))
        metas = [it[3] for it in batch]
        negative = np.fromiter((it[2] for it in batch), bool, B)
        phase.stop()
        # the upload and the launches (on CUDA the wait is in finish)
        with METRICS.stage("device_stats", plane + lens.nbytes):
            raw = slots.send(n) if cuda else torch.from_numpy(host)
            out_d = classify_stat_cat(
                raw[:plane].view(torch.int32).view(B, L // 8),
                raw[off:].view(torch.int32))
            out, done = out_d, None
            if cuda:
                out = torch.empty(out_d.shape, dtype=torch.int32,
                                  pin_memory=True)
                with METRICS.gpu("d2h", device):
                    out.copy_(out_d, non_blocking=True)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(device))
        return metas, negative, out, done

    def finish(state):
        metas, negative, out, done = state
        if done is not None:
            with METRICS.stage("device_wait"):
                done.synchronize()  # the one-batch-deep fence
            METRICS.settle()
        phase.to("emit")
        # a copy: the pinned buffer may be handed out again once freed
        yield metas, out.numpy().astype(np.int64), negative

    def alone(item):  # past the int32 counters: the int64 host engine
        phase.to("emit")
        t, q, negative, meta = item
        yield [meta], _host_pair_row(rows.array(t), rows.array(q)), np.array(
            [negative], bool)

    return overlapped(items, start, finish, batch_columns, phase,
                      (INT32_SAFE_COLUMNS, alone))


def stream_seq_pair_stats(items, device, batch_columns=DEFAULT_BATCH_COLUMNS,
                          rows=BytesRows):
    """stream_stat_rows one record at a time: yields (meta, RecStat) in
    input order."""
    for metas, counters, negative in stream_stat_rows(
            items, device, batch_columns, rows):
        for meta, row, neg in zip(metas, counters, negative.tolist()):
            yield meta, rec_stat_from_cigar(stats_row_to_cigar(row, neg))
