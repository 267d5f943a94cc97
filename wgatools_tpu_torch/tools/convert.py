"""`paf2chain` (reference: converter.rs:148-173) through the device.

The device branch of wgatools_tpu/tools/convert.py::paf2chain on PyTorch:
op tables batch through chain_scan (kernel B's chain mode), the exclusive
cumulative I/D tables every chain data line needs, and the host gathers the
M-run boundaries and formats.  Header trims, the boundary gathers, the
chain writer and the host branch are the TPU package's own host code, so
both engines write the same bytes by construction.
"""

import torch

from wgatools_tpu import native
from wgatools_tpu.core import cigar as C
from wgatools_tpu.core.metrics import METRICS
from wgatools_tpu.io.chain import chain_header_from_record, write_chain_record
from wgatools_tpu.tools.convert import _chain_block_from_scan, _write_chain_from_ops

from ..core.device import DEVICE_MIN_OPS
from ..ops.liftover import chain_scan, int32_safe_record, pack_ops_batch


def paf2chain(pafreader, writer, device):
    """PAF -> chain on `device`; batches below DEVICE_MIN_OPS ops are still
    answered on the host, as in the TPU package."""
    _paf2chain_device(pafreader, writer, device)


def _paf2chain_device(pafreader, writer, device, batch_ops=1 << 20,
                      min_ops=None):
    """Batched pipeline: chain_scan tables on `device`, M-run boundary
    gathers + C++ formatting on the host.  Records without ops, or whose
    lengths sum to 2^31 or more, take the host path in order."""
    if min_ops is None:
        min_ops = DEVICE_MIN_OPS

    pending = []  # (record, ops, lens)
    total = 0
    next_id = 0

    def emit_from_tables(record, ops, lens, ei, ed):
        nonlocal next_id
        header = chain_header_from_record(record, *C.trims_from_ops(ops, lens))
        header.chain_id = next_id
        sizes, dqs, dts, final = _chain_block_from_scan(
            record, ops, lens, ei, ed
        )
        write_chain_record(writer, header, (sizes, dqs, dts), final)
        next_id += 1

    def flush():
        nonlocal total, next_id
        if not pending:
            return
        if total < min_ops:
            # too small to amortize device dispatch
            for record, ops, lens in pending:
                _write_chain_from_ops(writer, native, record, next_id, ops, lens)
                next_id += 1
            pending.clear()
            total = 0
            return
        ops_b, lens_b = pack_ops_batch(
            [p[1] for p in pending], [p[2] for p in pending]
        )
        with METRICS.stage("device_chain_scan", ops_b.nbytes * 5):
            ei_b, ed_b = chain_scan(
                torch.from_numpy(ops_b).to(device),
                torch.from_numpy(lens_b).to(device),
            )
            ei_b = ei_b.cpu().numpy()
            ed_b = ed_b.cpu().numpy()
        for k, (record, ops, lens) in enumerate(pending):
            n = len(ops)
            emit_from_tables(record, ops, lens, ei_b[k, :n], ed_b[k, :n])
        pending.clear()
        total = 0

    for record in pafreader.records():
        ops, lens = record.get_cigar_ops()
        if not int32_safe_record(lens):
            flush()  # keeps chain ids in order
            _write_chain_from_ops(writer, native, record, next_id, ops, lens)
            next_id += 1
            continue
        pending.append((record, ops, lens))
        total += len(ops)
        if total >= batch_ops:
            flush()
    flush()
    writer.flush()
