"""`validate` (reference: src/tools/validate.rs) through the device.

The device branch of wgatools_tpu/tools/validate.py on PyTorch: records
stream through batched segment sums (ops.segments.cigar_batch_stats) and
each record's counters are checked against its coordinates.  The checks,
the report, the fixed-PAF writer and the strand routing of the counters
are the TPU package's own host code (Validations, check_record,
_stat_from_row), so both engines write the same bytes by construction.
`stat -f paf` (tools.stat.stat_paf) shares the stream.
"""

import numpy as np
import torch

from wgatools_tpu.errors import CigarOpInvalid
from wgatools_tpu.io.paf import PafWriter
from wgatools_tpu.tools.validate import Validations, _stat_from_row, check_record

from ..ops.segments import assert_stat_ops, cigar_batch_stats, pack_cigar_batch


def stream_batch_stats(records, device, batch_ops=1 << 20):
    """Yield (record, RecStat) in input order, the counters taken in
    batches of about `batch_ops` ops on `device`.

    Only one batch of records is held at a time.  A record with an op
    outside {M,=,X,I,D} raises CigarOpInvalid after every record before it
    has been yielded, as in the host engine; a record whose op lengths sum
    to 2^31 or more takes the int64 host engine, in order (the device
    counters are int32)."""
    pending = []  # (rec, ops, lens)
    total = 0

    def flush():
        nonlocal total
        if not pending:
            return
        ops, lens, row_ids = pack_cigar_batch(
            [p[1] for p in pending], [p[2] for p in pending]
        )
        rows = cigar_batch_stats(
            *(torch.from_numpy(a).to(device) for a in (ops, lens, row_ids)),
            len(pending),
        ).cpu().numpy()
        for (rec, _, _), row in zip(pending, rows):
            yield rec, _stat_from_row(rec, row)
        pending.clear()
        total = 0

    for rec in records:
        ops, lens = rec.get_cigar_ops()
        try:
            assert_stat_ops(ops)
        except CigarOpInvalid:
            yield from flush()
            raise
        if lens.sum(dtype=np.int64) >= 2**31:
            yield from flush()
            yield rec, rec.get_stat()
            continue
        pending.append((rec, ops, lens.astype(np.int32)))
        total += len(ops)
        if total >= batch_ops:
            yield from flush()
    yield from flush()


def validate_paf(reader, writer, fix_writer, fix_flag, device):
    """reference: validate.rs:44-141, the counters on `device`.  The
    report goes to writer; with fix_flag, every record, its ends set to
    what its CIGAR gives, goes to fix_writer."""
    vd = Validations()
    for rec, rs in stream_batch_stats(reader.records(), device):
        check_record(rec, rs, vd, fix_flag)
    writer.write((vd.format() + "\n").encode("ascii"))
    if fix_writer is not None:
        paf_writer = PafWriter(fix_writer)
        for rec in vd.fix_paf_recs:
            paf_writer.write_record(rec)
        fix_writer.flush()
    writer.flush()
    return vd
