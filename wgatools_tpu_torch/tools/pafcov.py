"""`pafcov`, per-base PAF coverage (reference: src/tools/pafcov.rs), through
the device.

The device branch of wgatools_tpu/tools/pafcov.py on PyTorch: records
buffer per target and flush in op batches; each batch's M/'=' spans come
from kernel B's liftover scan (ops.liftover.coverage_span_table) and are
scattered into the target's int32 difference array on the device; one
prefix sum per target at the end.  The host route for int32-unsafe targets
and records and the BED writer are the TPU package's own host code
(coverage_spans, add_spans, write_per_base_bed).
"""

import numpy as np
import torch

from wgatools_tpu.tools.pafcov import add_spans, coverage_spans, write_per_base_bed

from ..ops.coverage import diff_to_coverage, scatter_spans
from ..ops.liftover import coverage_span_table, pack_ops_batch


def pafcov(reader, writer, device):
    """reference: pafcov.rs:13-61, one BED line per base, the coverage on
    `device`."""
    _pafcov_device(reader, writer, device)


def _pafcov_device(reader, writer, device, batch_ops=1 << 20):
    """Streaming device coverage: a target's records flush once they hold
    `batch_ops` ops, and at the end of the input.  Targets are written in
    the order they first appear.

    Each target keeps a device int32 difference array of target_length + 1
    entries; a target whose difference array would pass 2^31 entries, and
    a record whose op lengths sum to 2^31 or more, take the int64 host
    route (added to the device counts at the end)."""
    diff_dev = {}  # target -> device int32 [target_length + 1]
    host_diff = {}  # target -> host int64 [target_length + 1]
    pending = {}  # target -> (op_arrays, len_arrays, starts, total_ops)
    order = []  # first-appearance target order

    def flush(target):
        op_arrays, len_arrays, starts, _ = pending.pop(target)
        ops, lens = pack_ops_batch(op_arrays, len_arrays)
        s, e = coverage_span_table(
            torch.from_numpy(ops).to(device),
            torch.from_numpy(lens).to(device),
            torch.from_numpy(np.array(starts, dtype=np.int32)).to(device),
        )
        s, e = s.reshape(-1), e.reshape(-1)
        scatter_spans(diff_dev[target], s, e, valid=(s >= 0).to(torch.int32))

    for rec in reader.records():
        ops, lens = rec.get_cigar_ops()
        target = rec.target_name
        if target not in diff_dev and target not in host_diff:
            order.append(target)
            if rec.target_length + 1 >= 2**31:
                host_diff[target] = np.zeros(rec.target_length + 1, np.int64)
            else:
                diff_dev[target] = torch.zeros(
                    rec.target_length + 1, dtype=torch.int32, device=device)
        if target in host_diff or lens.sum(dtype=np.int64) >= 2**31:
            cov = host_diff.setdefault(
                target, np.zeros(rec.target_length + 1, np.int64))
            starts, ends = coverage_spans(ops, lens, rec.target_start)
            add_spans(cov[:-1], starts, ends)
            continue
        op_arrays, len_arrays, starts, total = pending.setdefault(
            target, ([], [], [], 0))
        op_arrays.append(ops)
        len_arrays.append(lens.astype(np.int32))
        starts.append(rec.target_start)
        total += len(ops)
        pending[target] = (op_arrays, len_arrays, starts, total)
        if total >= batch_ops:
            flush(target)
    for target in list(pending):
        flush(target)

    for target in order:
        if target in diff_dev:
            counts = diff_to_coverage(diff_dev.pop(target)).cpu().numpy()
            if target in host_diff:
                counts = counts + np.cumsum(host_diff.pop(target)[:-1])
        else:
            counts = np.cumsum(host_diff.pop(target)[:-1])
        write_per_base_bed(writer, target, counts)
    writer.flush()
