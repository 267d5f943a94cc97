"""Ragged CIGAR-op batch reductions: per-record counters as segment sums.

The port of wgatools_tpu/ops/segments.py.  PAF-driven tools (stat -f paf,
validate) concatenate a batch of records' ops into flat (ops, lens) arrays
with a row id per op, and every per-record counter is a segment sum, the
device form of parse_paf_to_cigar's fold (reference:
src/parser/cigar.rs:629-707).  The TPU package left these to XLA's
segment_sum, not Pallas; here they are one `index_add_` on the tensors'
device.  The numpy helpers match the TPU package's byte for byte.
"""

import numpy as np
import torch

from wgatools_tpu.errors import CigarOpInvalid

OP_M = ord("M")
OP_EQ = ord("=")
OP_X = ord("X")
OP_I = ord("I")
OP_D = ord("D")

# output columns of cigar_batch_stats
SEG_MATCHED = 0
SEG_MISMATCHED = 1
SEG_INS_SIZE = 2
SEG_DEL_SIZE = 3
SEG_INS_EVENT = 4
SEG_DEL_EVENT = 5
N_SEG_STATS = 6

_KNOWN = np.zeros(256, dtype=bool)
for _b in b"M=XID":
    _KNOWN[_b] = True


def cigar_batch_stats(ops, lens, row_ids, num_records):
    """Per-record CIGAR counters by one segment sum.

    ops: uint8 [N]; lens: int32 [N]; row_ids: int32 [N] in
    [0, num_records), tensors of one device.  Returns int32
    [num_records, 6] on that device, the columns SEG_*: matched,
    mismatched, ins_size, del_size, ins_events, del_events (every I/D op is
    one event, PAF semantics).  Per-record length totals must stay below
    2^31 (callers route larger records to the int64 host engine)."""
    lens = lens.to(torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=lens.device)
    is_i, is_d = ops == OP_I, ops == OP_D
    vals = torch.stack([
        torch.where((ops == OP_M) | (ops == OP_EQ), lens, zero),
        torch.where(ops == OP_X, lens, zero),
        torch.where(is_i, lens, zero),
        torch.where(is_d, lens, zero),
        is_i.to(torch.int32),
        is_d.to(torch.int32),
    ], dim=1)
    out = torch.zeros((num_records, N_SEG_STATS), dtype=torch.int32,
                      device=lens.device)
    return out.index_add_(0, row_ids.long(), vals)


def assert_stat_ops(ops):
    """Raise CigarOpInvalid on the first op outside {M,=,X,I,D}, as the
    reference's parse_paf_to_cigar fold does (cigar.rs:685); the segment
    sums would otherwise drop it from every counter."""
    known = _KNOWN[np.asarray(ops, dtype=np.uint8)]
    if not known.all():
        raise CigarOpInvalid(chr(int(ops[~known][0])))


def pack_cigar_batch(op_arrays, len_arrays):
    """Concatenate per-record (ops, lens) into flat arrays with row ids
    (op domain checked by assert_stat_ops)."""
    if not op_arrays:
        return (
            np.zeros(0, np.uint8),
            np.zeros(0, np.int32),
            np.zeros(0, np.int32),
        )
    ops = np.concatenate(op_arrays)
    lens = np.concatenate(len_arrays)
    assert_stat_ops(ops)
    row_ids = np.repeat(
        np.arange(len(op_arrays), dtype=np.int32),
        [len(a) for a in op_arrays],
    )
    return ops, lens, row_ids
