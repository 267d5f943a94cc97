"""Device run-length extraction for the tools that write CIGAR strings.

The port of wgatools_tpu/ops/rle_device.py: the host packs records into
padded [B, L] column batches, the device classifies the columns, counts
per-record statistics with a hand-written kernel and extracts the run
boundaries, and only the run table (category and length per run) returns
to the host for string formatting.

Two routes, with the TPU package's conditions (start_runs):

- the category plane: host numpy batches whose width is a multiple of 8
  and below 2^28 columns are packed into one 0.5 B/column plane (one
  upload); kernel A counts it and the runs come back packed as
  (cat << 28) | len, 4 bytes per run, rows rebuilt on the host from the
  kernel's per-record run counts;
- the byte planes: everything else (an unaligned width, 2^28 columns or
  more, tensors already on the device) keeps t and q as uint8 [B, L];
  kernel D counts them (classify.column_stats) and the runs come back as
  (row, cat, len).

The extraction itself is plain torch (nonzero and gathers), as the TPU
package left it to XLA outside any Pallas kernel.  It fetches exactly the
number of runs the kernel counted, and raises if the two disagree.
"""

import numpy as np
import torch

from ..core.metrics import METRICS

from .classify import (
    STAT_RUNS,
    _unpack_cats,
    cat_to_std,
    classify_columns,
    classify_stat_cat,
    column_stats,
    pack_cat_nibbles,
)

# the packed (cat << 28) | len fetch holds a run length below 2^28
PACKED_MAX_COLUMNS = 1 << 28


def _run_bounds(cat, lengths):
    """(row, category, length) of every run of a [B, L] code plane over
    the columns < lengths[row], in (row, column) order."""
    B, L = cat.shape
    lengths = lengths.to(device=cat.device, dtype=torch.int64)
    start = torch.ones((B, L), dtype=torch.bool, device=cat.device)
    start[:, 1:] = cat[:, 1:] != cat[:, :-1]
    start &= torch.arange(L, device=cat.device)[None, :] < lengths[:, None]
    flat = torch.nonzero(start.reshape(-1)).reshape(-1)
    row = flat // L
    col = flat % L
    run_cat = cat.reshape(-1)[flat]
    # a run ends where the next run of its row starts, else at its row's
    # length
    end = lengths[row]
    end[:-1] = torch.where(row[1:] == row[:-1], col[1:], end[:-1])
    return row, run_cat, end - col


def extract_runs_cat(cw, lengths, caller=False):
    """Runs of an int32 [B, L//8] category plane (pack_cat_nibbles), in
    (row, column) order, as ONE int32 tensor of (cat << 28) | len with
    standard codes (EQ X I D W); ext mode folds gap/gap into '=' runs.
    Needs L < 2^28 (start_runs routes wider batches to the byte planes)."""
    if 8 * cw.shape[1] >= PACKED_MAX_COLUMNS:
        raise ValueError("packed run lengths need rows below 2^28 columns")
    cat = cat_to_std(_unpack_cats(cw), caller)
    _, run_cat, run_len = _run_bounds(cat, lengths)
    return (run_cat.to(torch.int32) << 28) | run_len.to(torch.int32)


def extract_runs(t, q, lengths, caller=False):
    """Runs of uint8 t, q [B, L] byte planes, in (row, column) order: int32
    (row, cat, len) tensors."""
    row, run_cat, run_len = _run_bounds(classify_columns(t, q, caller),
                                        lengths)
    return (row.to(torch.int32), run_cat.to(torch.int32),
            run_len.to(torch.int32))


def _upload(arrays, device, uploader):
    if uploader is not None:
        return uploader.upload(*arrays)
    with METRICS.gpu("h2d", torch.device(device)):
        return tuple(torch.tensor(a, device=device) for a in arrays)


def start_runs(t, q, lengths, device, caller=False, uploader=None,
               phase=None):
    """Phase 1 of batch_runs: upload the batch and launch its statistics
    kernel, without waiting for it.  Returns the state finish_runs takes;
    in between, the device works while the host packs the next batch.

    t, q: uint8 [B, L] numpy planes or tensors; lengths: int32 [B].
    uploader: an ops.pipeline.PinnedSlots for the host planes (pinned,
    non_blocking), or None for a plain copy.  phase: a METRICS.phases()
    of the caller's, switched to `pack` for the category plane's packing
    and to `device_runs` from the upload on."""
    if (
        isinstance(t, np.ndarray)
        and isinstance(q, np.ndarray)
        and t.dtype == np.uint8
        and q.dtype == np.uint8
        and t.flags.c_contiguous
        and q.flags.c_contiguous
        and t.shape[1] % 8 == 0
        and t.shape[1] < PACKED_MAX_COLUMNS
    ):
        if phase is not None:
            phase.to("pack")
        cw = pack_cat_nibbles(t, q)
        if phase is not None:
            phase.to("device_runs")
        METRICS.add_bytes("device_rle", cw.nbytes)
        cw_d, len_d = _upload((cw, np.asarray(lengths, dtype=np.int32)),
                              device, uploader)
        return ("cat", cw_d, len_d, classify_stat_cat(cw_d, len_d, caller),
                caller)
    # the extraction needs the byte planes on the device anyway, so the
    # statistics kernel reads those same buffers
    if isinstance(t, np.ndarray):
        METRICS.add_bytes("device_rle", t.nbytes + q.nbytes)
        t, q = _upload((t.astype(np.uint8, copy=False),
                        q.astype(np.uint8, copy=False)), device, uploader)
    t, q = t.to(device), q.to(device)
    len_d = torch.as_tensor(lengths, dtype=torch.int32).to(device)
    stats = column_stats(t, q, len_d, device, caller)
    return ("bytes", (t, q), len_d, stats, caller)


def finish_runs(state):
    """Phase 2 of batch_runs: wait for the statistics (they size the
    extraction), extract the runs and fetch them.  Returns numpy
    (row_ids, cats, lens), int32 each, in (row, column) order."""
    kind, data, lengths, stats, caller = state
    runs = stats[:, STAT_RUNS]
    with METRICS.gpu("d2h", stats.device):
        per_row = runs.cpu().numpy()
    total = int(per_row.sum(dtype=np.int64))
    if total == 0:
        z = np.zeros(0, dtype=np.int32)
        return z, z, z
    if kind == "cat":
        packed = extract_runs_cat(data, lengths, caller)
        with METRICS.gpu("d2h", stats.device):
            packed = packed.cpu().numpy()
        _check_count(total, packed.shape[0])
        METRICS.add_bytes("device_rle", packed.nbytes)
        rows = np.repeat(np.arange(per_row.shape[0], dtype=np.int32), per_row)
        return rows, packed >> 28, packed & np.int32(0x0FFFFFFF)
    tables = extract_runs(*data, lengths, caller)
    with METRICS.gpu("d2h", stats.device):
        row, cat, ln = (x.cpu().numpy() for x in tables)
    _check_count(total, row.shape[0])
    METRICS.add_bytes("device_rle", 12 * row.shape[0])
    return row, cat, ln


def _check_count(total, extracted):
    if extracted != total:
        raise RuntimeError(
            f"run extraction found {extracted} runs where the statistics "
            f"kernel counted {total}"
        )


def batch_runs(t, q, lengths, device, caller=False, phase=None):
    """All runs of a padded batch on `device`, in (row, column) order.

    caller=True uses the caller category table (gap/gap -> W), the device
    scan of the variant caller.  phase: as start_runs'.  Returns numpy
    (row_ids, cats, lens), int32 each."""
    return finish_runs(start_runs(t, q, lengths, device, caller,
                                  phase=phase))


def split_run_tables(n_rows, row_ids, cats, lens):
    """Partition a batch_runs/finish_runs result into per-record run
    tables: a list of n_rows (cats uint8, lens int64) pairs in row order
    (row_ids is sorted: runs come back in (row, column) order)."""
    splits = np.searchsorted(row_ids, np.arange(1, n_rows))
    return [
        (v.astype(np.uint8), ln.astype(np.int64))
        for v, ln in zip(np.split(cats, splits), np.split(lens, splits))
    ]
