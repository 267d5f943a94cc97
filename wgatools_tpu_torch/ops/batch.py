"""Batched per-record statistics on the device.

Streams MAF records into padded [B, L] column batches, packs each batch
into the category plane on the host, reduces it with classify_stat_cat on
the device, and turns the counter rows back into RecStats with host-side
strand routing.  Records of 2^31 columns or more would wrap the int32
counters and take the int64 host engine instead, in order.

On CUDA the pipeline keeps one batch in flight: the host packs batch i+1
while the device reduces batch i.  Each batch goes up from a pinned host
slot with a non_blocking copy and its counters come back the same way, all
on the current stream; an event recorded after the copy back is the
one-batch-deep fence.  Two pinned slots alternate, and a slot is refilled
only after the event of its previous upload has completed.
"""

import numpy as np
import torch

from wgatools_tpu.core.cigar import Cigar, rec_stat_from_cigar

from .classify import (
    STAT_DEL_EVENT,
    STAT_DEL_SIZE,
    STAT_INS_EVENT,
    STAT_INS_SIZE,
    STAT_MATCHED,
    STAT_MISMATCHED,
    classify_stat_cat,
    column_stats,
    pack_cat_nibbles,
    pack_pairs,
)

# batch capacity in columns: a batch is flushed when its padded size would
# pass this (32 MiB of category plane per batch)
DEFAULT_BATCH_COLUMNS = 64 << 20

# Records at or past this many columns go to the int64 host engine (the
# reference's counters are u64, cigar.rs:629-707).  A module attribute so
# that tests can lower it.
INT32_SAFE_COLUMNS = 2**31


def _host_pair_stat(t_bytes, q_bytes, negative):
    """int64 host-engine stats for one pair (the int32-overflow route)."""
    from wgatools_tpu.core.cigar import EQ, D, I, X, ext_runs

    t = np.frombuffer(t_bytes, dtype=np.uint8)
    q = np.frombuffer(q_bytes, dtype=np.uint8)
    vals, lens = ext_runs(t, q)
    lens = np.asarray(lens, dtype=np.int64)
    c = Cigar()
    c.match_count = int(lens[vals == EQ].sum())
    c.mismatch_count = int(lens[vals == X].sum())
    ins_mask = vals == I
    del_mask = vals == D
    if negative:
        c.inv_event = 1
        c.inv_ins_event = int(ins_mask.sum())
        c.inv_ins_count = int(lens[ins_mask].sum())
        c.inv_del_event = int(del_mask.sum())
        c.inv_del_count = int(lens[del_mask].sum())
    else:
        c.ins_event = int(ins_mask.sum())
        c.ins_count = int(lens[ins_mask].sum())
        c.del_event = int(del_mask.sum())
        c.del_count = int(lens[del_mask].sum())
    return rec_stat_from_cigar(c)


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


def batch_rec_stats(pairs, negatives, device,
                    batch_columns=DEFAULT_BATCH_COLUMNS):
    """RecStats of (t_bytes, q_bytes) pairs, in input order, one batch at
    a time.  negatives: per-pair strand flags."""
    out = [None] * len(pairs)
    pending = []  # (original_index, pair)

    def flush():
        if not pending:
            return
        t, q, lens = pack_pairs([p for _, p in pending])
        rows = column_stats(t, q, lens, device).cpu().numpy()
        for k, (i, _) in enumerate(pending):
            out[i] = rec_stat_from_cigar(
                stats_row_to_cigar(rows[k], negatives[i])
            )
        pending.clear()

    max_len = 0
    for i, pair in enumerate(pairs):
        n = len(pair[0])
        if n >= INT32_SAFE_COLUMNS:
            out[i] = _host_pair_stat(pair[0], pair[1], negatives[i])
            continue
        new_max = max(max_len, n)
        if pending and new_max * (len(pending) + 1) > batch_columns:
            flush()
            new_max = n
        max_len = new_max
        pending.append((i, pair))
    flush()
    return out


class _PinnedUpload:
    """Two pinned host slots for non_blocking uploads on the current
    stream.  A slot holds one batch's arrays (a category plane and its
    lengths, or two byte planes) back to back, each at a 16-byte aligned
    offset, so a batch goes up in one copy."""

    def __init__(self, device):
        self.device = device
        self.slots = [(None, None), (None, None)]  # (pinned buffer, event)
        self.turn = 0

    def upload(self, *arrays):
        """numpy arrays -> tensors of the same dtypes and shapes on the
        device, without waiting for the copy."""
        host, event = self.slots[self.turn]
        if event is not None:
            event.synchronize()  # its previous upload must have left
        offsets, n = [], 0
        for a in arrays:
            offsets.append(n)
            n += -(-a.nbytes // 16) * 16
        if host is None or host.numel() < n:
            host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        staged = host.numpy()
        for a, off in zip(arrays, offsets):
            staged[off : off + a.nbytes] = np.ascontiguousarray(a).reshape(
                -1).view(np.uint8)
        dev = host[:n].to(self.device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self.slots[self.turn] = (host, event)
        self.turn ^= 1
        return tuple(
            dev[off : off + a.nbytes]
            .view(torch.from_numpy(np.empty(0, a.dtype)).dtype)
            .view(a.shape)
            for a, off in zip(arrays, offsets)
        )


def stream_seq_pair_stats(items, device, batch_columns=DEFAULT_BATCH_COLUMNS):
    """Stream (t_bytes, q_bytes, negative, meta) items through the device;
    yields (meta, RecStat) in input order, with one batch in flight on
    CUDA (see the module docstring)."""
    cuda = device.type == "cuda"
    uploader = _PinnedUpload(device) if cuda else None
    pending = []  # (t, q, negative, meta)
    max_len = 0
    in_flight = None  # (list of (negative, meta), host rows, done event)

    def dispatch():
        nonlocal max_len
        if not pending:
            return None
        t, q, lens = pack_pairs([(it[0], it[1]) for it in pending])
        cw = pack_cat_nibbles(t, q)  # pack_pairs aligns L to 128
        if cuda:
            cw_d, len_d = uploader.upload(cw, lens)
            rows_d = classify_stat_cat(cw_d, len_d)
            rows = torch.empty(rows_d.shape, dtype=torch.int32, pin_memory=True)
            rows.copy_(rows_d, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
        else:
            rows = classify_stat_cat(
                torch.from_numpy(cw), torch.from_numpy(lens)
            )
            done = None
        batch = [(it[2], it[3]) for it in pending]
        pending.clear()
        max_len = 0
        return batch, rows, done

    def drain(batch_rows):
        batch, rows, done = batch_rows
        if done is not None:
            done.synchronize()  # the one-batch-deep fence
        for (neg, meta), row in zip(batch, rows.numpy()):
            yield meta, rec_stat_from_cigar(stats_row_to_cigar(row, neg))

    for item in items:
        n = len(item[0])
        if n >= INT32_SAFE_COLUMNS:
            # drain the pipeline first so that output order is kept
            nf = dispatch()
            if in_flight is not None:
                yield from drain(in_flight)
                in_flight = None
            if nf is not None:
                yield from drain(nf)
            yield item[3], _host_pair_stat(item[0], item[1], item[2])
            continue
        new_max = max(max_len, n)
        if pending and new_max * (len(pending) + 1) > batch_columns:
            nf = dispatch()
            if in_flight is not None:
                yield from drain(in_flight)
            in_flight = nf
            new_max = n
        max_len = new_max
        pending.append(item)
    nf = dispatch()
    if in_flight is not None:
        yield from drain(in_flight)
    if nf is not None:
        yield from drain(nf)
