"""Per-base PAF coverage (reference: src/tools/pafcov.rs).

The reference increments a per-chromosome counter vector over M/'=' CIGAR
spans per record.  Here the increments are an interval scatter-add over
(start, end) span tables: on the host (device=None) one fused native call
per record into an int32 difference array, on the device kernel B's
liftover scan (ops.liftover.coverage_span_table) per batch of op rows,
scattered into the target's int32 difference array there
(ops.coverage.scatter_spans), with one prefix sum per target at the end.
The int64 host route for targets and records that would wrap int32 and
the BED writer are shared by both.  Only the device branch imports torch.
"""

import numpy as np

from .. import native
from ..core import cigar as C
from ..core.cigar import raise_tokenize_error, strip_cg_prefix
from ..core.metrics import METRICS


def coverage_spans(ops, lens, start: int):
    """M/'=' spans as (starts, ends) advancing like update_cov_vec
    (reference: cigar.rs:710-741): I/S don't advance, everything else does."""
    ops = np.asarray(ops)
    lens = np.asarray(lens, dtype=np.int64)
    advances = np.where((ops == C.OP_I) | (ops == C.OP_S), 0, lens)
    pos = start + np.concatenate(([0], np.cumsum(advances)[:-1]))
    cover = (ops == C.OP_M) | (ops == C.OP_EQ)
    return pos[cover], pos[cover] + lens[cover]


def add_spans(cov: np.ndarray, starts: np.ndarray, ends: np.ndarray):
    """Difference-array scatter-add: +1 at span starts, -1 at span ends,
    prefix-sum at the end turns it into per-base coverage."""
    n = cov.shape[0]
    starts = np.clip(starts, 0, n)
    ends = np.clip(ends, 0, n)
    np.add.at(cov, starts[starts < n], 1)
    np.subtract.at(cov, ends[ends < n], 1)


def accumulate_record(rec, diff_map, use_native=None):
    """One record's +/-1 coverage scatter into its target's difference
    array (shared by the serial, pooled, and distributed paths).  Hot
    path: one fused native call over the CIGAR text; numpy span tables
    otherwise."""
    if use_native is None:
        use_native = native.available()
    cov = diff_map.get(rec.target_name)
    if cov is None:
        # int32 halves the footprint vs the reference's usize vectors
        cov = np.zeros(rec.target_length + 1, dtype=np.int32)
        diff_map[rec.target_name] = cov
    if use_native:
        raw = strip_cg_prefix(rec.get_cigar_string()).encode("ascii")
        try:
            if native.cigar_cov_diff(raw, rec.target_start, cov):
                return
        except ValueError as e:
            raise_tokenize_error(raw, e.args[0])
    ops, lens = rec.get_cigar_ops()
    starts, ends = coverage_spans(ops, lens, rec.target_start)
    add_spans(cov[:-1], starts, ends)


def pafcov(reader, writer, device):
    """reference: pafcov.rs:13-61.  Output: one BED line per base.
    device=None: the host engine; otherwise the coverage on `device`."""
    if device is not None:
        return _pafcov_device(reader, writer, device)
    use_native = native.available()
    diff_map = {}
    for rec in reader.records():
        accumulate_record(rec, diff_map, use_native)
    for target, diff in diff_map.items():
        counts = np.cumsum(diff[:-1])
        write_per_base_bed(writer, target, counts)
    writer.flush()


def _pafcov_device(reader, writer, device, batch_ops=1 << 20):
    """Streaming device coverage: a target's records flush once they hold
    `batch_ops` ops, and at the end of the input.  Targets are written in
    the order they first appear.

    Each target keeps a device int32 difference array of target_length + 1
    entries; a target whose difference array would pass 2^31 entries, and
    a record whose op lengths sum to 2^31 or more, take the int64 host
    route (added to the device counts at the end)."""
    import torch

    from ..ops.coverage import diff_to_coverage, scatter_spans
    from ..ops.liftover import coverage_span_table, pack_ops_batch

    diff_dev = {}  # target -> device int32 [target_length + 1]
    host_diff = {}  # target -> host int64 [target_length + 1]
    pending = {}  # target -> (op_arrays, len_arrays, starts, total_ops)
    order = []  # first-appearance target order

    def flush(target):
        op_arrays, len_arrays, starts, _ = pending.pop(target)
        ops, lens = pack_ops_batch(op_arrays, len_arrays)
        with METRICS.stage("device_coverage", ops.nbytes + lens.nbytes):
            s, e = coverage_span_table(
                torch.from_numpy(ops).to(device),
                torch.from_numpy(lens).to(device),
                torch.from_numpy(np.array(starts, dtype=np.int32)).to(device),
            )
            s, e = s.reshape(-1), e.reshape(-1)
            scatter_spans(diff_dev[target], s, e,
                          valid=(s >= 0).to(torch.int32))

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


def write_per_base_bed(writer, target: str, counts: np.ndarray,
                       chunk: int = 1 << 20):
    """Bulk-format one BED line per base: `target\\tpos\\tpos+1\\tcount`.

    Per-base output over whole chromosomes is the pafcov output bottleneck;
    the C++ formatter does ~2 GB/min vs ~2.7 us/line in Python."""
    prefix = target.encode("ascii")
    n = counts.shape[0]
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        block = native.format_bed_lines(prefix, lo, counts[lo:hi])
        if block is None:
            buf = bytearray()
            for p, c in zip(range(lo, hi), counts[lo:hi].tolist()):
                buf += b"%s\t%d\t%d\t%d\n" % (prefix, p, p + 1, c)
            block = bytes(buf)
        writer.write(block)
