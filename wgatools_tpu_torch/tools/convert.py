"""Format converters (reference: src/converter.rs).

Each direction streams records through the columnar CIGAR engine.  The
device converters take `device` as a required argument: an explicit None
runs the host engine and calls no torch op; given a torch device, four
directions run their batch work there:

- `maf2paf` and `maf2chain`: MAF records batch through the run extraction
  (ops.rle_device: kernel A or D counts, torch extracts), one batch in
  flight, and the host formats PAF rows or chain blocks from each record's
  run table;
- `paf2chain`: op tables batch through chain_scan (kernel B's chain mode),
  the exclusive cumulative I/D tables every chain data line needs, and the
  host gathers the M-run boundaries and formats;
- `chain2paf`: per-record sums of the data lines as one device segment sum
  per batch.

Header trims, the boundary gathers and the PAF and chain writers are
shared by both engines, so they write the same bytes when the device
tables agree.  Batches below DEVICE_MIN_COLUMNS columns or DEVICE_MIN_OPS
ops are answered by the host engine, as in the TPU package.  Only the
device branches import torch and the ops modules, so the host engine
never loads torch.
"""

import numpy as np

from .. import native
from ..core import cigar as C
from ..core.device import (
    DEFAULT_BATCH_COLUMNS,
    DEVICE_MIN_COLUMNS,
    DEVICE_MIN_OPS,
)
from ..core.metrics import METRICS
from ..core.strand import Strand
from ..errors import WGAError
from ..io.chain import (
    ChainReader,
    chain_header_from_record,
    write_chain_record,
)
from ..io.fasta import FastaReader
from ..io.maf import MafReader, MafRecord, MafSLine, MafWriter
from ..io.paf import PafReader, PafRecord, PafWriter


def maf2paf(mafreader: MafReader, writer, device, query_name=None):
    """MAF -> PAF (reference: converter.rs:29-54).  device=None: the host
    engine; otherwise column batches classify and run-length-encode on
    `device`, only the run tables return, and the host formats PAF rows;
    batches below DEVICE_MIN_COLUMNS columns are answered on the host."""
    paf_writer = PafWriter(writer)
    if device is None:
        for record in mafreader.records():
            paf_writer.write_record(record.convert2paf(query_name))
        writer.flush()
        return

    def emit(rec, _index, vals, lens):
        cigar = C.cigar_from_runs(vals, lens, rec.is_negative)
        paf_writer.write_record(_paf_from_cigar(rec, cigar))

    _batched_ext_runs(mafreader, query_name, emit, device)
    writer.flush()


def _paf_from_cigar(record: MafRecord, cigar):
    """PafRecord fields from a Cigar (maf.rs:484-520 body)."""
    matches = cigar.match_count
    block_length = (
        cigar.match_count
        + cigar.mismatch_count
        + cigar.ins_count
        + cigar.inv_ins_count
        + cigar.del_count
        + cigar.inv_del_count
    )
    edit_dist = block_length - matches
    return PafRecord(
        query_name=record.query_name,
        query_length=record.query_length,
        query_start=record.query_start,
        query_end=record.query_end,
        strand=record.query_strand,
        target_name=record.target_name,
        target_length=record.target_length,
        target_start=record.target_start,
        target_end=record.target_end,
        matches=matches,
        block_length=block_length,
        mapq=255,
        tags=[f"NM:i:{edit_dist}", "cg:Z:" + cigar.cigar_string],
    )


def _maf_ext_runs(record: MafRecord):
    return C.ext_runs(
        C.seq_bytes(record.target_seq), C.seq_bytes(record.query_seq)
    )


_EXT2OP = np.zeros(5, dtype=np.uint8)
_EXT2OP[C.EQ] = C.OP_EQ
_EXT2OP[C.X] = C.OP_X
_EXT2OP[C.I] = C.OP_I
_EXT2OP[C.D] = C.OP_D


def maf2chain(mafreader: MafReader, writer, device, query_name=None):
    """MAF -> chain (reference: converter.rs:57-92): header via the ext-mode
    trim rule, data lines via M-merged runs, auto-increment chain ids
    counting records in input order.  device=None: the host engine;
    otherwise the run tables come from `device`, as in maf2paf."""
    if device is None:
        for chain_id, record in enumerate(mafreader.records()):
            if query_name is not None:
                record.set_query_idx_byname(query_name)
            vals, lens = _maf_ext_runs(record)
            _emit_chain(writer, record, chain_id, vals, lens)
        writer.flush()
        return

    def emit(rec, chain_id, vals, lens):
        _emit_chain(writer, rec, chain_id, vals, lens)

    _batched_ext_runs(mafreader, query_name, emit, device)
    writer.flush()


def _emit_chain(writer, record, chain_id, vals, lens):
    _write_chain_from_ops(writer, native, record, chain_id, _EXT2OP[vals],
                          lens)


def _batched_ext_runs(mafreader, query_name, emit, device):
    """Stream MAF records through the run extraction on `device`, calling
    emit(record, index, run_vals, run_lens) in input order.

    ops.pipeline.overlapped batches them, DEFAULT_BATCH_COLUMNS padded
    columns a batch, one batch in flight: start uploads batch i+1 and
    launches its statistics kernel before finish waits for batch i, so the
    host parses and packs while the device works.  A batch of fewer than
    DEVICE_MIN_COLUMNS columns is answered by the host engine."""
    from ..ops.classify import pack_pairs
    from ..ops.pipeline import PinnedSlots, overlapped
    from ..ops.rle_device import finish_runs, split_run_tables, start_runs

    slots = PinnedSlots(device) if device.type == "cuda" else None

    def items():
        for record in mafreader.records():
            if query_name is not None:
                record.set_query_idx_byname(query_name)
            yield record.target_seq, record

    def start(batch):
        recs = [rec for _, rec in batch]
        total_cols = sum(len(t) for t, _ in batch)
        if total_cols < DEVICE_MIN_COLUMNS:
            return recs, None
        with METRICS.stage("pack", total_cols * 2):
            t, q, lens = pack_pairs([(t, rec.query_seq) for t, rec in batch])
        return recs, start_runs(t, q, lens, device, uploader=slots)

    def finish(state):
        recs, runs = state
        if runs is None:
            for rec in recs:
                yield rec, _maf_ext_runs(rec)
            return
        with METRICS.stage("device_rle"):
            row_ids, cats, run_lens = finish_runs(runs)
        yield from zip(recs, split_run_tables(len(recs), row_ids, cats,
                                              run_lens))

    for index, (rec, (vals, lens)) in enumerate(
            overlapped(items(), start, finish, DEFAULT_BATCH_COLUMNS)):
        emit(rec, index, vals, lens)


def paf2chain(pafreader: PafReader, writer, device):
    """PAF -> chain (reference: converter.rs:148-173).

    device=None, the host engine: the per-record body (trims +
    cigar_unit_chain state machine + data-line emission) runs as ONE fused
    native pass when available.  Otherwise op tables batch through
    chain_scan on `device`; batches below DEVICE_MIN_OPS ops are still
    answered on the host."""
    if device is not None:
        _paf2chain_device(pafreader, writer, device)
        return
    use_native = native.available()
    for chain_id, record in enumerate(pafreader.records()):
        if use_native:
            raw = C.strip_cg_prefix(record.get_cigar_string()).encode("ascii")
            try:
                blk = native.cigar_text_to_chain_block(raw)
            except ValueError as e:
                kind, val = e.args[0]
                if kind == "op":
                    raise C.CigarOpInvalid(val) from None
                C.raise_tokenize_error(raw, val)
            if blk is not None:
                _emit_chain_block(writer, record, chain_id, blk)
                continue
        ops, lens = record.get_cigar_ops()
        _write_chain_from_ops(writer, native, record, chain_id, ops, lens)
    writer.flush()


def _chain_block_from_scan(record, ops, lens, excl_ins, excl_del):
    """Chain lines from per-op EXCLUSIVE cumulative I/D tables
    (ops.liftover.chain_scan): identical semantics to
    chain_line_arrays_from_ops, the row scans replaced by gathers."""
    for op in np.unique(ops).tolist():
        if op not in C._VALID_STAT_OPS:
            raise C.CigarOpInvalid(chr(op))
    is_m = (ops == C.OP_M) | (ops == C.OP_EQ) | (ops == C.OP_X)
    m_idx = np.flatnonzero(is_m)
    if m_idx.size and np.any(np.asarray(lens)[m_idx] == 0):
        # zero-length M: flush-or-drop barrier the gather form cannot
        # express -- reference-faithful scalar walk (see
        # core.cigar.chain_line_arrays_from_ops, round-5 review finding)
        return C.chain_line_arrays_from_ops(ops, lens)
    empty = np.zeros(0, dtype=np.int64)
    if m_idx.size == 0:
        return empty, empty, empty, 0
    m_sizes = np.asarray(lens, dtype=np.int64)[m_idx]
    td = (excl_ins[m_idx[1:]] - excl_ins[m_idx[:-1] + 1]).astype(np.int64)
    qd = (excl_del[m_idx[1:]] - excl_del[m_idx[:-1] + 1]).astype(np.int64)
    nonzero_gap = (td + qd) != 0
    seg_starts = np.concatenate(([0], np.flatnonzero(nonzero_gap) + 1))
    merged = np.add.reduceat(m_sizes, seg_starts)
    gap_sel = np.flatnonzero(nonzero_gap)
    return merged[:-1], qd[gap_sel], td[gap_sel], int(merged[-1])


def _paf2chain_device(pafreader, writer, device, batch_ops=1 << 20,
                      min_ops=None):
    """Batched pipeline: chain_scan tables on `device`, M-run boundary
    gathers + C++ formatting on the host.  Records without ops, or whose
    lengths sum to 2^31 or more, take the host path in order.  A batch runs
    its phases one after another (METRICS: parse, pack, the device stage,
    emit, write), so that each is one stretch of host time."""
    import torch

    from ..ops.liftover import chain_scan, int32_safe_record, pack_ops_batch

    if min_ops is None:
        min_ops = DEVICE_MIN_OPS

    phase = METRICS.phases()
    pending = []  # (record, ops, lens)
    total = 0
    next_id = 0

    def chain_block(record, chain_id, ops, lens, ei, ed):
        header = chain_header_from_record(record, *C.trims_from_ops(ops, lens))
        header.chain_id = chain_id
        return header, _chain_block_from_scan(record, ops, lens, ei, ed)

    def host_record(record, ops, lens):
        nonlocal next_id
        _write_chain_from_ops(writer, native, record, next_id, ops, lens)
        next_id += 1

    def flush():
        nonlocal total, next_id
        if not pending:
            return
        if total < min_ops:
            # too small to amortize device dispatch
            phase.to("emit")
            for record, ops, lens in pending:
                host_record(record, ops, lens)
        else:
            phase.to("pack")
            ops_b, lens_b = pack_ops_batch(
                [p[1] for p in pending], [p[2] for p in pending]
            )
            METRICS.count("slots", ops_b.size)
            METRICS.count("padded_slots", ops_b.size - total)
            phase.stop()
            with METRICS.stage("device_chain_scan", ops_b.nbytes * 5):
                # allocated outside the gpu spans, which hold the copies
                ops_d = torch.empty(ops_b.shape, dtype=torch.uint8,
                                    device=device)
                lens_d = torch.empty(lens_b.shape, dtype=torch.int32,
                                     device=device)
                with METRICS.gpu("h2d", device):
                    ops_d.copy_(torch.from_numpy(ops_b))
                    lens_d.copy_(torch.from_numpy(lens_b))
                ei_d, ed_d = chain_scan(ops_d, lens_d)
                ei_h = torch.empty(ei_d.shape, dtype=ei_d.dtype)
                ed_h = torch.empty(ed_d.shape, dtype=ed_d.dtype)
                with METRICS.gpu("d2h", device):
                    ei_h.copy_(ei_d)
                    ed_h.copy_(ed_d)
                ei_b, ed_b = ei_h.numpy(), ed_h.numpy()
            METRICS.settle()
            phase.to("emit")
            blocks = [
                chain_block(record, next_id + k, ops, lens, ei_b[k, :len(ops)],
                            ed_b[k, :len(ops)])
                for k, (record, ops, lens) in enumerate(pending)
            ]
            phase.to("write")
            for header, (sizes, dqs, dts, final) in blocks:
                write_chain_record(writer, header, (sizes, dqs, dts), final)
            next_id += len(pending)
        pending.clear()
        total = 0
        phase.to("parse")

    try:
        phase.to("parse")
        for record in pafreader.records():
            ops, lens = record.get_cigar_ops()
            if not int32_safe_record(lens):
                flush()  # keeps chain ids in order
                phase.to("emit")
                host_record(record, ops, lens)
                phase.to("parse")
                continue
            pending.append((record, ops, lens))
            total += len(ops)
            if total >= batch_ops:
                flush()
        flush()
        phase.to("write")
        writer.flush()
    finally:
        phase.stop()


def _emit_chain_block(writer, record, chain_id, blk):
    text, head_ins, head_del, tail_ins, tail_del, final_size = blk
    header = chain_header_from_record(
        record, head_ins, head_del, tail_ins, tail_del
    )
    header.chain_id = chain_id
    writer.write(header.format().encode("ascii"))
    writer.write(text)
    writer.write(f"\n{final_size}\n\n".encode("ascii"))


def _write_chain_from_ops(writer, native, record, chain_id, ops, lens):
    """Emit one chain record from CIGAR op arrays: fused native path with
    a vectorized-numpy fallback."""
    try:
        blk = native.ops_to_chain_block(ops, lens)
    except ValueError as e:
        raise C.CigarOpInvalid(e.args[0]) from None
    if blk is not None:
        _emit_chain_block(writer, record, chain_id, blk)
        return
    trims = C.trims_from_ops(ops, lens)
    header = chain_header_from_record(record, *trims)
    header.chain_id = chain_id
    sizes, dqs, dts, final_size = C.chain_line_arrays_from_ops(ops, lens)
    write_chain_record(writer, header, (sizes, dqs, dts), final_size)


def chain2paf(chainreader: ChainReader, writer, device):
    """chain -> PAF (reference: converter.rs:391-416).  device=None: the
    host engine; otherwise the per-record sums of the data lines on
    `device`, batches below DEVICE_MIN_OPS data lines on the host."""
    if device is not None:
        _chain2paf_device(chainreader, writer, device)
        return
    paf_writer = PafWriter(writer)
    for record in chainreader.records():
        paf_writer.write_record(record.convert2paf())
    writer.flush()


def _paf_from_chain_sums(record, match, del_ct):
    """The PAF row of one chain record from its summed sizes (match) and
    dqs (del_ct), the cg:Z: string from its data lines."""
    ops, lens = record.op_arrays()
    cat = np.where(ops == C.OP_I, 1, np.where(ops == C.OP_D, 2, 0)).astype(
        np.uint8)
    cg = native.format_runs(cat, np.asarray(lens, np.int64), b"MID")
    if cg is None:  # no native library: a plain join
        cg = "".join(f"{n}{'MID'[v]}" for v, n in
                     zip(cat.tolist(), np.asarray(lens).tolist()))
    return PafRecord(
        query_name=record.query_name,
        query_length=record.query_length,
        query_start=record.query_start,
        query_end=record.query_end,
        strand=record.query_strand,
        target_name=record.target_name,
        target_length=record.target_length,
        target_start=record.target_start,
        target_end=record.target_end,
        matches=match,
        block_length=match + del_ct,
        mapq=255,
        tags=["cg:Z:" + cg],
    )


def _chain2paf_device(chainreader, writer, device, batch_lines=1 << 20,
                      min_lines=None):
    """Batched pipeline: per-record sums of sizes, dts and dqs as one
    device segment sum per batch of about `batch_lines` data lines, rows
    and cg strings formatted on the host.  A batch below `min_lines`
    (DEVICE_MIN_OPS) is answered by the host engine; a record whose sums
    reach 2^31 takes the int64 host path, in order."""
    import torch

    if min_lines is None:
        min_lines = DEVICE_MIN_OPS
    paf_writer = PafWriter(writer)
    pending = []
    total = 0

    def flush():
        nonlocal total
        if not pending:
            return
        if total < min_lines:
            for record in pending:
                paf_writer.write_record(record.convert2paf())
        else:
            vals = np.stack([
                np.concatenate([r.sizes for r in pending]),
                np.concatenate([r.dts for r in pending]),
                np.concatenate([r.dqs for r in pending]),
            ], axis=1).astype(np.int32)
            row_ids = np.repeat(np.arange(len(pending), dtype=np.int32),
                                [len(r.sizes) for r in pending])
            with METRICS.stage("device_chain_sums", vals.nbytes):
                sums = torch.zeros((len(pending), 3), dtype=torch.int32,
                                   device=device)
                sums.index_add_(0, torch.from_numpy(row_ids).to(device).long(),
                                torch.from_numpy(vals).to(device))
                sums = sums.cpu().numpy()
            for record, (match, _, del_ct) in zip(pending, sums.tolist()):
                paf_writer.write_record(
                    _paf_from_chain_sums(record, match, del_ct))
        pending.clear()
        total = 0

    for record in chainreader.records():
        if (int(record.sizes.sum()) + int(record.dqs.sum())
                + int(record.dts.sum())) >= 2**31:
            flush()
            paf_writer.write_record(record.convert2paf())
            continue
        pending.append(record)
        total += len(record.sizes)
        if total >= batch_lines:
            flush()
    flush()
    writer.flush()


def _seq_record_to_maf(
    rec, score, t_reader: FastaReader, q_reader: FastaReader, gap_insert
):
    """Shared paf2maf / chain2maf body (reference: converter.rs:176-357)."""
    t_name = rec.target_name
    t_start = rec.target_start
    t_size = rec.target_length
    t_alilen = rec.target_end - t_start
    q_name = rec.query_name
    q_strand = rec.query_strand
    q_size = rec.query_length
    q_alilen = rec.query_end - rec.query_start
    # negative strand: MAF start is counted from the reverse end
    if q_strand == Strand.NEGATIVE:
        q_start_field = q_size - rec.query_end
    else:
        q_start_field = rec.query_start

    whole_t = t_reader.fetch(t_name, t_start, rec.target_end - 1)
    whole_q = q_reader.fetch(q_name, rec.query_start, rec.query_end - 1)
    if q_strand == Strand.NEGATIVE:
        whole_q = C.reverse_complement(whole_q)
    t_gapped, q_gapped = gap_insert(whole_t, whole_q)

    t_sline = MafSLine(
        mode="s",
        name=t_name,
        start=t_start,
        align_size=t_alilen,
        strand=rec.target_strand,
        size=t_size,
        seq=t_gapped,
    )
    q_sline = MafSLine(
        mode="s",
        name=q_name,
        start=q_start_field,
        align_size=q_alilen,
        strand=q_strand,
        size=q_size,
        seq=q_gapped,
    )
    return MafRecord(score=score, slines=[t_sline, q_sline], query_idx=1)


def paf2maf(pafreader: PafReader, writer, t_fa_path: str, q_fa_path: str):
    """PAF -> MAF with sequences from indexed FASTA
    (reference: converter.rs:176-265)."""
    t_reader = FastaReader(t_fa_path)
    q_reader = FastaReader(q_fa_path)
    maf_writer = MafWriter(writer)
    maf_writer.write_header(
        f"#maf version=1.6 convert_from=paf t_seq_path={t_fa_path} "
        f"q_seq_path={q_fa_path}"
    )
    for rec in pafreader.records():
        ops, lens = rec.get_cigar_ops()

        def gap_insert(t_raw, q_raw, _ops=ops, _lens=lens):
            return C.insert_gaps_by_ops(_ops, _lens, t_raw, q_raw)

        maf_writer.write_record(
            _seq_record_to_maf(rec, rec.mapq, t_reader, q_reader, gap_insert)
        )
    writer.flush()


def chain2maf(chainreader: ChainReader, writer, t_fa_path: str, q_fa_path: str):
    """chain -> MAF (reference: converter.rs:268-357)."""
    t_reader = FastaReader(t_fa_path)
    q_reader = FastaReader(q_fa_path)
    maf_writer = MafWriter(writer)
    maf_writer.write_header(
        f"#maf version=1.6 convert_from=chain t_seq_path={t_fa_path} "
        f"q_seq_path={q_fa_path}"
    )
    use_native = native.available()
    for rec in chainreader.records():
        if rec.sizes.shape[0] == 0:
            raise WGAError("chain record has no data lines")

        # per line: copy `size`, then target gaps (dt), then query gaps
        # (dq) -- exactly the interleaved op order of op_arrays().  Hot
        # path feeds the data-line arrays straight to C++ (no op array
        # materialization); differential-tested vs the ops formulation.
        def gap_insert(t_raw, q_raw, _rec=rec):
            # the C++ fused pass assumes sources exactly matching the
            # data lines (the common case); length disagreements take
            # insert_gaps_by_ops, which reproduces the reference's
            # insert-into-copy edge semantics (tails kept, short rows,
            # WGAError where insert_str would panic -- round-5 review)
            need_t = int(_rec.sizes.sum() + _rec.dqs.sum())
            need_q = int(_rec.sizes.sum() + _rec.dts.sum())
            if (
                use_native
                and need_t == len(t_raw)
                and need_q == len(q_raw)
            ):
                res = native.chain_insert_gaps(
                    _rec.sizes, _rec.dqs, _rec.dts, t_raw, q_raw
                )
                if res is not None:
                    return res
            ops, lens = _rec.op_arrays()
            return C.insert_gaps_by_ops(ops, lens, t_raw, q_raw)

        maf_writer.write_record(
            _seq_record_to_maf(rec, 255, t_reader, q_reader, gap_insert)
        )
    writer.flush()


def maf2sam(mafreader: MafReader, writer, real: bool = False):
    """DEV stub by default, surface parity only: the reference writes a
    hard-coded noodles example header and one unmapped record, ignoring
    the input (reference: converter.rs:94-125).

    real=True (OPTIONAL EXTRA, `--real`, not reference parity -- see
    PARITY.md): an actual MAF -> SAM conversion.  Per record: the query
    row becomes one alignment line against the target -- FLAG 16 for
    negative strand (the MAF query seq is already in target-forward
    orientation), 1-based POS, M/I/D CIGAR ('='/'X' runs M-merged) with
    hard clips in SEQ (target-forward) orientation, SEQ =
    gap-stripped query row, MAPQ 255 and NM:i as in convert2paf
    (maf.rs:484-520).  @SQ lines collect target names/sizes in first
    appearance order (header precedes body, so the body spools)."""
    if not real:
        writer.write(
            b"@HD\tVN:1.6\tSO:unsorted\n"
            b"@SQ\tSN:sq0\tLN:8\n"
            b"@SQ\tSN:sq1\tLN:13\n"
            b"@SQ\tSN:sq2\tLN:21\n"
            b"@PG\tID:noodles-sam\n"
            b"@CO\tan example SAM written by noodles-sam\n"
            b"sq2\t4\t*\t0\t255\t*\t*\t0\t0\t*\t*\n"
        )
        writer.flush()
        return

    import tempfile

    from .. import __version__
    from ..core.cigar import EQ, X, ext_runs, seq_bytes

    sq = {}  # target name -> size, first-appearance order
    body = tempfile.SpooledTemporaryFile(max_size=64 << 20)
    for rec in mafreader.records():
        if len(rec.slines) < 2:
            continue
        t_arr = seq_bytes(rec.target_seq)
        q_arr = seq_bytes(rec.query_seq)
        # gap/gap columns exist in NEITHER coordinate frame: ext_runs
        # classifies '-'/'-' as '=' (cigar_cat_ext), which would inflate
        # the M run past len(SEQ) and the target span -- invalid SAM.
        # Drop them before the scan (round-5 review finding).
        gg = (t_arr == C.GAP) & (q_arr == C.GAP)
        if gg.any():
            t_arr = t_arr[~gg]
            q_arr = q_arr[~gg]
        if t_arr.shape[0] == 0:
            continue
        cat_vals, cat_lens = ext_runs(t_arr, q_arr)
        cat_lens = np.asarray(cat_lens, np.int64)
        # SAM-style cigar: '='/'X' merge to M (adjacent runs coalesce)
        vals = np.where(
            (cat_vals == EQ) | (cat_vals == X),
            np.uint8(ord("M")),
            np.where(
                cat_vals == C.I, np.uint8(ord("I")), np.uint8(ord("D"))
            ),
        )
        keep = np.ones(vals.shape[0], dtype=bool)
        keep[1:] = vals[1:] != vals[:-1]
        grp = np.cumsum(keep) - 1
        mlens = np.bincount(grp, weights=cat_lens.astype(np.float64))
        mlens = mlens.astype(np.int64)
        vals = vals[keep]
        cigar = "".join(
            f"{ln}{chr(v)}" for v, ln in zip(vals.tolist(), mlens.tolist())
        )
        qs = rec.slines[rec.query_idx]
        # hard clips: the MAF start is strand-relative (maf.rs:433-450),
        # but SEQ is written TARGET-FORWARD (FLAG 16 carries the
        # orientation), so for negative strands the strand-frame head
        # clip is the read's target-forward TAIL -- swap the two
        # (round-5 review finding; SAM clips are in SEQ orientation)
        h_lead = qs.start
        h_trail = qs.size - qs.start - qs.align_size
        if rec.is_negative:
            h_lead, h_trail = h_trail, h_lead
        if h_lead:
            cigar = f"{h_lead}H{cigar}"
        if h_trail:
            cigar = f"{cigar}{h_trail}H"
        # NM = mismatches + indel bases, as convert2paf's tag
        nm = int(cat_lens[cat_vals != EQ].sum())
        # an all-gap query row has no aligned bases: SEQ must be '*'
        # (an empty mandatory column is malformed SAM)
        seq = q_arr[q_arr != C.GAP].tobytes() or b"*"
        flag = 16 if rec.is_negative else 0
        tname = rec.target_name
        if tname not in sq:
            sq[tname] = rec.target_length
        body.write(
            (
                f"{rec.query_name}\t{flag}\t{tname}\t"
                f"{rec.target_start + 1}\t255\t{cigar}\t*\t0\t0\t"
            ).encode("ascii")
            + seq
            + f"\t*\tNM:i:{nm}\n".encode("ascii")
        )
    writer.write(b"@HD\tVN:1.6\tSO:unsorted\n")
    for name, size in sq.items():
        writer.write(f"@SQ\tSN:{name}\tLN:{size}\n".encode("ascii"))
    writer.write(
        f"@PG\tID:wgatools-tpu\tPN:wgatools-tpu\tVN:{__version__}\n".encode(
            "ascii"
        )
    )
    body.seek(0)
    while True:
        chunk = body.read(1 << 20)
        if not chunk:
            break
        writer.write(chunk)
    body.close()
    writer.flush()


# Block struct field order, common.rs:73-81 (csv serialize writes the
# field names as a header row because has_headers defaults to true,
# converter.rs:133-135)
_BLOCKS_HEADER = (
    b"query_name\tquery_start\tquery_end"
    b"\ttarget_name\ttarget_start\ttarget_end\tstrand\n"
)


def paf2blocks(pafreader: PafReader, writer):
    """PAF -> blocks TSV (OPTIONAL EXTRA -- dead code in the reference).

    The reference ships `paf2blocks` (converter.rs:128-145) and its
    per-op folder `parse_cigar_to_blocks`/`cigar_unit_block`
    (cigar.rs:83-152) fully commented out, with no CLI entry at all.
    Per SURVEY.md §2.18 it is out of parity scope; this implements the
    same semantics as a *working* tool (divergence notes in PARITY.md):

    - a running block starts at (query_start, target_start) with both
      ends collapsed (cigar.rs:128-137); 'M' extends both ends, emits
      one row, then collapses starts onto ends (cigar.rs:88-100); 'I'
      advances the query side only, 'D' the target side only, neither
      emits (cigar.rs:101-110);
    - the dead code rejects every op outside M/I/D ("cigar should only
      contains 'M,I,D'", cigar.rs:117-119) -- but this toolchain's own
      PAF output spells match runs '='/'X', so we treat those as 'M'
      (one row per run, no coalescing; recorded in PARITY.md);
    - output is tab-separated with a header row of the Block field
      names (csv serialize, converter.rs:133-135); strand renders +/-
      (serde rename, common.rs:84-90).

    Vectorized: per record one cumsum over op advances replaces the
    reference's per-unit fold."""
    writer.write(_BLOCKS_HEADER)
    for rec in pafreader.records():
        ops, lens = rec.get_cigar_ops()
        lens = np.asarray(lens, np.int64)
        emit = (ops == C.OP_M) | (ops == C.OP_EQ) | (ops == C.OP_X)
        ins = ops == C.OP_I
        dele = ops == C.OP_D
        bad = ~(emit | ins | dele)
        if bad.any():
            raise C.CigarOpInvalid(chr(int(ops[bad.argmax()])))
        q_end = np.cumsum(np.where(emit | ins, lens, 0)) + rec.query_start
        t_end = np.cumsum(np.where(emit | dele, lens, 0)) + rec.target_start
        strand = rec.query_strand
        qn, tn = rec.query_name, rec.target_name
        rows = []
        for i in np.flatnonzero(emit).tolist():
            rows.append(
                f"{qn}\t{q_end[i] - lens[i]}\t{q_end[i]}"
                f"\t{tn}\t{t_end[i] - lens[i]}\t{t_end[i]}\t{strand}\n"
            )
        writer.write("".join(rows).encode("ascii"))
    writer.flush()
