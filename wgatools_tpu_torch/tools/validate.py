"""Validate / fix PAF coordinates against CIGARs (reference: src/tools/validate.rs).

expected query_end = query_start + matched + mismatched + ins (+inv variants)
expected target_end = target_start + matched + mismatched + del (+inv variants)

Each record's counters come from the host CIGAR engine (device=None) or
from batched segment sums on the device (ops.segments.cigar_batch_stats,
stream_batch_stats); the checks, the report and the fixed-PAF writer are
shared, so both engines write the same bytes when their counters agree.
`stat -f paf` (tools.stat.stat_paf) shares the stream, the only code here
that imports torch.
"""

from dataclasses import dataclass, field

import numpy as np

from ..core.cigar import Cigar, rec_stat_from_cigar
from ..core.metrics import METRICS
from ..errors import CigarOpInvalid
from ..io.paf import PafWriter


@dataclass
class Validations:
    total: int = 0
    query_invalid: int = 0
    query_inv_list: list = field(default_factory=list)
    ref_invalid: int = 0
    ref_inv_list: list = field(default_factory=list)
    fix_paf_recs: list = field(default_factory=list)

    def format(self) -> str:
        lines = [
            f"Total records: {self.total}",
            f"Query invalid records: {self.query_invalid}",
            f"Target invalid records: {self.ref_invalid}",
            "Query invalid list:",
        ]
        lines.extend(self.query_inv_list)
        lines.append("Target invalid list:")
        lines.extend(self.ref_inv_list)
        return "\n".join(lines) + "\n"


def _stat_from_row(rec, row):
    """Device counter row -> RecStat with host strand routing."""
    c = Cigar()
    c.match_count = int(row[0])
    c.mismatch_count = int(row[1])
    if rec.is_negative:
        c.inv_event = 1
        c.inv_ins_count, c.inv_del_count = int(row[2]), int(row[3])
        c.inv_ins_event, c.inv_del_event = int(row[4]), int(row[5])
    else:
        c.ins_count, c.del_count = int(row[2]), int(row[3])
        c.ins_event, c.del_event = int(row[4]), int(row[5])
    return rec_stat_from_cigar(c)


def stream_batch_stats(records, device, batch_ops=1 << 20):
    """Yield (record, RecStat) in input order, the counters taken in
    batches of about `batch_ops` ops on `device`.

    Only one batch of records is held at a time.  A record with an op
    outside {M,=,X,I,D} raises CigarOpInvalid after every record before it
    has been yielded, as in the host engine; a record whose op lengths sum
    to 2^31 or more takes the int64 host engine, in order (the device
    counters are int32)."""
    import torch

    from ..ops.segments import (
        assert_stat_ops,
        cigar_batch_stats,
        pack_cigar_batch,
    )

    pending = []  # (rec, ops, lens)
    total = 0

    def flush():
        nonlocal total
        if not pending:
            return
        ops, lens, row_ids = pack_cigar_batch(
            [p[1] for p in pending], [p[2] for p in pending]
        )
        with METRICS.stage("device_cigar_stats",
                           ops.nbytes + lens.nbytes + row_ids.nbytes):
            rows = cigar_batch_stats(
                *(torch.from_numpy(a).to(device)
                  for a in (ops, lens, row_ids)),
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


def check_record(rec, rs, vd, fix_flag):
    """Validate one record against its RecStat, updating vd and fixing the
    record's ends in place (loop body of validate.rs:71-120)."""
    vd.total += 1
    exp_query_end = (
        rec.query_start
        + rs.matched
        + rs.mismatched
        + rs.ins_size
        + rs.inv_ins_size
    )
    if exp_query_end != rec.query_end:
        vd.query_invalid += 1
        vd.query_inv_list.append(
            f"{rec.query_name}:{rec.query_start}-{rec.query_end}"
        )
        rec.query_end = exp_query_end
    exp_ref_end = (
        rec.target_start
        + rs.matched
        + rs.mismatched
        + rs.del_size
        + rs.inv_del_size
    )
    if exp_ref_end != rec.target_end:
        vd.ref_invalid += 1
        vd.ref_inv_list.append(
            f"{rec.target_name}:{rec.target_start}-{rec.target_end}"
        )
        rec.target_end = exp_ref_end
    if fix_flag:
        vd.fix_paf_recs.append(rec)


def validate_paf(reader, writer, fix_writer, fix_flag, device):
    """reference: validate.rs:44-141.  device=None: the host engine's
    counters; otherwise the counters on `device`.  The report goes to
    writer; with fix_flag, every record, its ends set to what its CIGAR
    gives, goes to fix_writer."""
    vd = Validations()
    if device is None:
        stream = ((rec, rec.get_stat()) for rec in reader.records())
    else:
        stream = stream_batch_stats(reader.records(), device)
    for rec, rs in stream:
        check_record(rec, rs, vd, fix_flag)
    writer.write((vd.format() + "\n").encode("ascii"))
    if fix_writer is not None:
        paf_writer = PafWriter(fix_writer)
        for rec in vd.fix_paf_recs:
            paf_writer.write_record(rec)
        fix_writer.flush()
    writer.flush()
    return vd
