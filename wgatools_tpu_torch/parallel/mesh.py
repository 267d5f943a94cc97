"""Record-axis data parallelism with collective merges, on torch.distributed.

The port of wgatools_tpu/parallel/mesh.py.  The TPU package shards a batch
over a 1-D device mesh inside one program (shard_map); here each rank is a
process of a torch.distributed group (NCCL on the card, gloo on the CPU)
and holds its shard as local tensors on its own device:

- record batches shard over the ranks (`shard_rows`); the per-record
  kernels run on each rank's shard and issue NO collective
  (sharded_column_stats, sharded_fused16, sharded_fused_adv16,
  sharded_liftover);
- associative merges become collectives of the shape the reference's
  try_reduce merges have: the per-pair stat table (all_reduce), the
  coverage difference array (all_reduce, or reduce_scatter plus a [D]
  all_gather of shard totals);
- one giant record's op axis shards over the ranks (sharded_liftover_sp):
  a local scan plus ONE [2, B] int32 all_gather of shard totals.

`gather_rows` assembles a global result from the shards (tests, the
dryrun, consumers that need it whole).  The TPU package's 15-bit limb sums
behind its overflow check existed because x64 is off on the TPU; the card
sums in int64.
"""

import datetime
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..ops.classify import (
    classify_stat_bytes,
    classify_stat_nibbles,
    classify_stat_words,
)
from ..ops.fused import classify_liftover_fused16, classify_liftover_fused_adv16
from ..ops.liftover import OP_D, OP_I, OP_S, liftover_scan

INIT_TIMEOUT_S = 120


@dataclass(frozen=True)
class RecordGroup:
    """One rank's view of the process group its records shard over."""

    rank: int
    size: int
    device: torch.device
    pg: object = None  # the torch.distributed group; None is the default

    @classmethod
    def current(cls, device, pg=None):
        return cls(dist.get_rank(pg), dist.get_world_size(pg),
                   torch.device(device), pg)


@contextmanager
def record_group(backend, store_path, rank, size, device):
    """Initialise the default process group from a FileStore at store_path
    (a new file in an existing directory; no network address: every rank
    of one host opens the same file), yield this rank's RecordGroup, and
    destroy the group on exit.  NCCL binds the group to `device` at once,
    so that a card that cannot take part fails here, within
    INIT_TIMEOUT_S."""
    device = torch.device(device)
    kwargs = {}
    if backend == "nccl":
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, size), rank=rank,
        world_size=size, timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S),
        **kwargs,
    )
    try:
        yield RecordGroup.current(device)
    finally:
        dist.destroy_process_group()


def shard_rows(group: RecordGroup, arr, axis=0):
    """This rank's slice of a global host array along `axis`, as a
    contiguous tensor on the rank's device.  The axis must divide evenly
    over the group (pad_to_multiple)."""
    arr = np.asarray(arr)
    n = arr.shape[axis]
    if n % group.size:
        raise ValueError(
            f"axis {axis} of length {n} must divide evenly over the "
            f"{group.size}-rank group: pad it (pad_to_multiple; padding ops "
            "0 / len 0 advance nothing, padding rows have length 0)"
        )
    k = n // group.size
    part = np.take(arr, np.arange(group.rank * k, (group.rank + 1) * k), axis)
    return torch.from_numpy(np.ascontiguousarray(part)).to(group.device)


def gather_rows(group: RecordGroup, local, axis=0):
    """Every rank's `local` tensor (one shape on every rank), concatenated
    along `axis` in rank order, on every rank."""
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(group.size)]
    dist.all_gather(parts, local, group=group.pg)
    return torch.cat(parts, dim=axis)


def pad_to_multiple(arr, multiple, axis=0, fill=0):
    """Pad a host array along axis to a multiple (for even sharding)."""
    n = arr.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, target - n)
    return np.pad(arr, widths, constant_values=fill)


def sharded_column_stats(group: RecordGroup, t, q, lengths, caller=False,
                         nibble=False):
    """Column stats of this rank's record shard: int32 [b, 8], no
    collective.  uint8 planes take kernel D; int32 planes are byte words
    (4 columns per word, kernel D's word entry) or, with nibble=True,
    nibble planes (kernel E).  Lengths stay in columns."""
    if t.dtype == torch.int32:
        fn = classify_stat_nibbles if nibble else classify_stat_words
        return fn(t, q, lengths, caller)
    if nibble:
        raise ValueError("nibble planes are int32 words")
    return classify_stat_bytes(t, q, lengths, caller)


def sharded_pair_reduce(group: RecordGroup, stats, pair_ids, num_pairs: int):
    """Merge record stats into per-pair aggregates over the group: a local
    segment sum by pair id (ids outside [0, num_pairs) are dropped, as
    jax.ops.segment_sum drops them), then one all_reduce of the
    [num_pairs, 8] int32 table, which every rank then holds."""
    keep = (pair_ids >= 0) & (pair_ids < num_pairs)
    seg = torch.zeros((num_pairs, stats.shape[1]), dtype=torch.int32,
                      device=stats.device)
    seg.index_add_(0, pair_ids[keep].long(), stats[keep].to(torch.int32))
    dist.all_reduce(seg, group=group.pg)
    return seg


def _span_diff(starts, ends, genome_len, size):
    """int32 [size] difference array of this rank's spans: +1 at each
    start, -1 at each end, both clipped to [0, genome_len]; a span whose
    start is negative is padding and adds nothing."""
    diff = torch.zeros(size, dtype=torch.int32, device=starts.device)
    w = (starts >= 0).to(torch.int32)
    diff.index_add_(0, starts.clamp(0, genome_len).long(), w)
    diff.index_add_(0, ends.clamp(0, genome_len).long(), -w)
    return diff


def sharded_coverage(group: RecordGroup, starts, ends, genome_len: int):
    """Coverage of every rank's spans: int32 [genome_len] on every rank,
    from one all_reduce of the [genome_len + 1] difference array."""
    diff = _span_diff(starts, ends, genome_len, genome_len + 1)
    dist.all_reduce(diff, group=group.pg)
    return torch.cumsum(diff[:-1], dim=0, dtype=torch.int32)


def sharded_coverage_scatter(group: RecordGroup, starts, ends,
                             genome_len: int, trim: bool = True):
    """Coverage with the GENOME axis sharded on output: one reduce_scatter
    of the difference array (half the fabric bytes of the all_reduce),
    one [D] int32 all_gather of the shard totals for each shard's carry,
    and a local cumsum.  The array is padded to `padded`, the next multiple
    of D above genome_len, padded // D positions per rank.

    trim=False returns this rank's int32 [padded // D] shard (positions >=
    genome_len carry the final running coverage: ignore them); trim=True
    gathers the shards and returns int32 [genome_len] on every rank, equal
    to sharded_coverage."""
    D = group.size
    padded = ((genome_len + 1 + D - 1) // D) * D
    diff = _span_diff(starts, ends, genome_len, padded)
    part = torch.empty(padded // D, dtype=torch.int32, device=diff.device)
    dist.reduce_scatter_tensor(part, diff, group=group.pg)
    totals = torch.empty(D, dtype=torch.int32, device=diff.device)
    dist.all_gather_into_tensor(
        totals, part.sum(dtype=torch.int32).reshape(1), group=group.pg
    )
    carry = totals[: group.rank].sum(dtype=torch.int32)
    local = torch.cumsum(part, dim=0, dtype=torch.int32) + carry
    if not trim:
        return local
    return gather_rows(group, local)[:genome_len]


def sharded_fused16(group: RecordGroup, tw, qw, lengths, opw16, nibble=False,
                    caller=False):
    """Kernel F on this rank's record shard (classify_liftover_fused16):
    (stats [b, 8], t_even, t_odd, q_even, q_odd [b2, NOH]), no
    collective."""
    return classify_liftover_fused16(tw, qw, lengths, opw16, group.device,
                                     caller, nibble=nibble)


def sharded_fused_adv16(group: RecordGroup, tw, qw, lengths, wt, wq,
                        nibble=False, catmode=False, scan_mode="mm",
                        chunk=None, emit_odd=True, raw_sums=False,
                        caller=False):
    """Kernel C on this rank's record shard (classify_liftover_fused_adv16,
    every mode: 3 or 5 outputs), no collective.  catmode=True takes ONE
    category plane, qw None."""
    return classify_liftover_fused_adv16(
        tw, qw, lengths, wt, wq, group.device, caller, nibble=nibble,
        catmode=catmode, scan_mode=scan_mode, chunk=chunk,
        emit_odd=emit_odd, raw_sums=raw_sums,
    )


def sharded_liftover(group: RecordGroup, ops, lens):
    """Kernel B's liftover scan of this rank's record shard: (t_off, q_off)
    int32 [b, N], no collective."""
    return liftover_scan(ops, lens)


def sharded_liftover_sp(group: RecordGroup, ops, lens):
    """SEQUENCE-parallel liftover scan: the OP axis of every record sharded
    over the ranks, so that one multi-Gbp record spans every card.

    ops: uint8 [B, n], lens: int32 [B, n], this rank's columns
    [rank * n, (rank + 1) * n) of the global table (shard_rows(..., axis=1);
    pad with op 0 / len 0, which advance nothing).  Each rank scans its
    shard with kernel B, and the shard totals cross ranks in ONE [2, B]
    int32 all_gather; a rank's carry is the sum of the totals of the ranks
    below it.  Before that, each row's advances per direction are summed in
    int64 and all_reduced: a record reaching 2^31 in either direction would
    wrap the int32 offsets, and every rank raises alike (route such
    records through the int64 host engine).  Returns this rank's (t_off,
    q_off) int32 [B, n], the matching columns of liftover_scan on the whole
    table."""
    pad = ops == 0
    l64 = lens.to(torch.int64)
    zero = torch.zeros((), dtype=torch.int64, device=lens.device)
    adv_t = torch.where(pad | (ops == OP_I) | (ops == OP_S), zero, l64)
    adv_q = torch.where(pad | (ops == OP_D), zero, l64)
    local = torch.stack([adv_t.sum(dim=1), adv_q.sum(dim=1)])  # [2, B]
    total = local.clone()
    dist.all_reduce(total, group=group.pg)
    if total.numel() and int(total.max()) >= 1 << 31:
        raise ValueError(
            f"sharded_liftover_sp: record advances up to ~{int(total.max())} "
            "bases in one direction -- int32 offsets would wrap (route "
            "records past ~2.1 Gbp per direction through the int64 host "
            "engine)"
        )
    t_loc, q_loc = liftover_scan(ops, lens)
    B = ops.shape[0]
    gathered = torch.empty((group.size * 2, B), dtype=torch.int32,
                           device=lens.device)
    dist.all_gather_into_tensor(gathered, local.to(torch.int32),
                                group=group.pg)
    carry = gathered.reshape(group.size, 2, B)[: group.rank].sum(
        dim=0, dtype=torch.int32
    )
    return t_loc + carry[0][:, None], q_loc + carry[1][:, None]
