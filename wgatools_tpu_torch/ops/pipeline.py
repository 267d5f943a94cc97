"""The batch pipeline of the MAF device tools (stat, maf2paf, maf2chain).

`overlapped` cuts a stream of records into padded column batches and keeps
one batch in flight: the host pulls and packs batch i+1 while the device
works on batch i, and results come out in input order.  `PinnedSlots` is
the pinned double buffer the batches go up from: each batch goes up from a
pinned host slot with a non_blocking copy on the current stream, and a slot
is refilled only after the event of its previous upload has completed.
"""

import numpy as np
import torch

from ..core.device import DEFAULT_BATCH_COLUMNS
from ..core.metrics import METRICS


class PinnedSlots:
    """Two pinned host slots for non_blocking uploads on the current
    stream.  A slot holds one batch's arrays (a category plane and its
    lengths, or two byte planes) back to back, each at a 16-byte aligned
    offset, so a batch goes up in one copy.  `slot` hands out the next
    slot's host bytes to be filled in place, `send` uploads them; `upload`
    does both for numpy arrays."""

    def __init__(self, device):
        self.device = device
        self.slots = [(None, None), (None, None)]  # (pinned buffer, event)
        self.turn = 0

    def slot(self, n):
        """The next slot's first n bytes as a writable uint8 numpy array,
        once that slot's previous upload has left."""
        host, event = self.slots[self.turn]
        if event is not None:
            event.synchronize()
        if host is None or host.numel() < n:
            host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        self.slots[self.turn] = (host, None)
        return host.numpy()[:n]

    def send(self, n):
        """Upload the first n bytes of the slot `slot` handed out, without
        waiting for the copy; returns them as a uint8 tensor on the device
        and turns to the other slot."""
        host = self.slots[self.turn][0]
        dev = torch.empty(n, dtype=torch.uint8, device=self.device)
        with METRICS.gpu("h2d", self.device):
            dev.copy_(host[:n], non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self.slots[self.turn] = (host, event)
        self.turn ^= 1
        return dev

    def upload(self, *arrays):
        """numpy arrays -> tensors of the same dtypes and shapes on the
        device, without waiting for the copy."""
        offsets, n = [], 0
        for a in arrays:
            offsets.append(n)
            n += aligned(a.nbytes)
        staged = self.slot(n)
        for a, off in zip(arrays, offsets):
            staged[off : off + a.nbytes] = np.ascontiguousarray(a).reshape(
                -1).view(np.uint8)
        dev = self.send(n)
        return tuple(
            dev[off : off + a.nbytes]
            .view(torch.from_numpy(np.empty(0, a.dtype)).dtype)
            .view(a.shape)
            for a, off in zip(arrays, offsets)
        )


def aligned(nbytes):
    """nbytes rounded up to a multiple of 16: where the next array of a
    slot starts."""
    return -(-nbytes // 16) * 16


def overlapped(items, start, finish, budget=DEFAULT_BATCH_COLUMNS,
               phase=None, alone=None):
    """Yield what finish yields for each batch of `items`, in input order,
    with one batch in flight.

    An item's width is len(item[0]).  A batch closes before the item that
    would take its padded size (its widest item's width times its items)
    past `budget`.  start(batch) packs, uploads and launches a batch (a
    list of items) and returns its state without waiting; finish(state)
    waits for it and yields its results.  Batch i+1 starts before batch i
    finishes.  `alone`, when given, is (columns, answer): an item that
    wide or wider is answered by answer(item), which yields its results,
    once every batch before it has finished.  `phase` (METRICS.phases()),
    when given, is switched to `parse` while items are pulled and stopped
    at the end; start, finish and answer switch it for their own work."""

    def drain(pending, in_flight):
        state = start(pending) if pending else None
        if in_flight is not None:
            yield from finish(in_flight)
        if state is not None:
            yield from finish(state)

    alone_at, answer = alone or (1 << 62, None)
    in_flight = None
    pending = []
    widest = 0
    try:
        if phase is not None:
            phase.to("parse")
        for item in items:
            n = len(item[0])
            if n >= alone_at:
                yield from drain(pending, in_flight)
                in_flight, pending, widest = None, [], 0
                yield from answer(item)
                if phase is not None:
                    phase.to("parse")
                continue
            wide = n if n > widest else widest
            if pending and wide * (len(pending) + 1) > budget:
                state = start(pending)
                if in_flight is not None:
                    yield from finish(in_flight)
                in_flight, pending, wide = state, [], n
                if phase is not None:
                    phase.to("parse")
            widest = wide
            pending.append(item)
        yield from drain(pending, in_flight)
    finally:
        if phase is not None:
            phase.stop()
