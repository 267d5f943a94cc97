"""Variant caller: SNP / INS / DEL / INV from MAF or PAF
(reference: src/tools/caller.rs).

The reference's per-column char loops (call_within_var, caller.rs:388-608)
become a vectorized aligned-column diff scan: columns are classified with the
caller category table (gap/gap -> W), run-length encoded, and the variant
table is derived from run arrays with prefix sums for target/query offsets.
Chunking with SV-safe boundaries (caller.rs:159-219) is the genome-axis
tiling step and is computed on the gap bitmask with the same semantics.

`call -f maf` on a torch device (call_var_maf with a device): each
record's chunks group into padded [K, Lmax] batches of up to GROUP_BUDGET
columns, whose caller-mode run tables come from the device (kernel A's
category plane), a single chunk of DEVICE_MIN_COLUMNS or more goes up as
a [1, n] batch (kernel D's byte route whenever n is not a multiple of 8),
and smaller chunks take the host engine.  The variant scan over the run
tables, the chunk plan and the VCF writer are shared with the host
engine, so both write the same bytes when the run tables agree.  Only that
device route imports torch (batch_runs below), so `call -f paf` and the
host engine never load it.
"""

import logging

import numpy as np

from .. import native
from ..core import cigar as C
from ..core.device import DEVICE_MIN_COLUMNS
from ..errors import CigarOpInvalid
from ..io.fasta import FastaReader
from ..io.maf import MafRecord, MafSLine
from ..io.vcf import VcfWriter

log = logging.getLogger("wgatools_tpu_torch")

DEFAULT_CHUNK_SIZE = 1000000

# CIGAR op byte -> caller category code (PAF path; M merges into EQ because
# only explicit X runs emit SNPs, caller.rs:640-664); 255 = invalid
_OP2CAT = np.full(256, 255, dtype=np.uint8)
_OP2CAT[C.OP_M] = C.EQ
_OP2CAT[C.OP_EQ] = C.EQ
_OP2CAT[C.OP_X] = C.X
_OP2CAT[C.OP_I] = C.I
_OP2CAT[C.OP_D] = C.D


def find_safe_chunk_boundary(t_seq, q_seq, start, chunk_size, svlen_cutoff, total):
    """SV-safe chunk boundary (reference: caller.rs:159-219).

    Returns (safe_end, next_start).  The window is truncated to the end of
    the *last* gap run of length >= cutoff that completes inside it; when the
    window ends inside a large gap run, it extends to the run's end.
    """
    proposed_end = min(start + chunk_size, total)
    # NOTE: even when the window reaches the record end, the reference
    # still truncates at the last completed gap run (caller.rs:188-195);
    # the resulting chunk decomposition is OBSERVABLE output for
    # negative-strand records (one INV row per chunk, caller.rs:423-440),
    # so no EOF shortcut is allowed here.
    if t_seq.flags.c_contiguous and q_seq.flags.c_contiguous:
        res = native.safe_chunk_boundary(
            t_seq, q_seq, start, proposed_end, svlen_cutoff
        )
        if res is not None:
            return res, res
    gap = (t_seq[start:proposed_end] == C.GAP) | (q_seq[start:proposed_end] == C.GAP)
    n = gap.shape[0]
    safe_end = proposed_end
    if n == 0:
        return safe_end, safe_end
    vals, lens = C.rle(gap.view(np.uint8))
    ends = np.cumsum(lens)
    is_gap_run = vals == 1
    # gap runs that complete inside the window (followed by a non-gap column)
    completes = is_gap_run.copy()
    completes[-1] = False
    big = completes & (lens >= svlen_cutoff)
    big_idx = np.flatnonzero(big)
    if big_idx.size:
        safe_end = start + int(ends[big_idx[-1]])
    # window ends inside a gap run
    if is_gap_run[-1] and int(lens[-1]) >= svlen_cutoff:
        tail = (t_seq[proposed_end:] != C.GAP) & (q_seq[proposed_end:] != C.GAP)
        nz = np.flatnonzero(tail)
        end_pos = proposed_end + int(nz[0]) if nz.size else proposed_end
        safe_end = end_pos
    return safe_end, safe_end


class _ChunkView:
    """Chunked record view with re-derived coordinates
    (reference: create_chunk_record, caller.rs:221-265), computed with
    running non-gap counters instead of per-chunk full rescans."""

    def __init__(self, record: MafRecord):
        self.record = record
        self.t_arr = C.seq_bytes(record.target_seq)
        self.q_arr = C.seq_bytes(record.query_seq)
        # chunks are consumed left-to-right, so running non-gap counters
        # replace the reference's per-chunk full prefix rescans
        # (caller.rs:240-245) without changing any derived coordinate
        self._consumed = 0
        self._t_nongap = 0
        self._q_nongap = 0

    def skip_to(self, col: int):
        """Position the running counters at column `col` (for chunk-plan
        slices claimed by parallel workers)."""
        self._t_nongap = int((self.t_arr[:col] != C.GAP).sum())
        self._q_nongap = int((self.q_arr[:col] != C.GAP).sum())
        self._consumed = col

    def chunk(self, start: int, end: int) -> MafRecord:
        rec = self.record
        assert start == self._consumed, "chunks must be sequential"
        t_cnt = int((self.t_arr[start:end] != C.GAP).sum())
        q_cnt = int((self.q_arr[start:end] != C.GAP).sum())
        new = MafRecord(score=rec.score, slines=[], query_idx=1)
        for sline, arr, before, cnt in (
            (rec.slines[0], self.t_arr, self._t_nongap, t_cnt),
            (rec.slines[rec.query_idx], self.q_arr, self._q_nongap, q_cnt),
        ):
            new.slines.append(
                MafSLine(
                    mode=sline.mode,
                    name=sline.name,
                    start=sline.start + before,
                    align_size=cnt,
                    strand=sline.strand,
                    size=sline.size,
                    seq=arr[start:end].tobytes(),
                )
            )
        self._consumed = end
        self._t_nongap += t_cnt
        self._q_nongap += q_cnt
        return new


def _emit_inv_record(out, mafrec, t_seq_ref, fmt_suffix):
    """Per-chunk INV record for negative-strand records
    (reference: caller.rs:423-440)."""
    info = f"SVTYPE=INV;END={mafrec.target_end}"
    qi = (
        f"1|1:{mafrec.query_name}@{mafrec.query_start}@{mafrec.query_end}"
        f"@{fmt_suffix}"
    )
    out.append(
        (
            mafrec.target_name,
            mafrec.target_start + 1,
            t_seq_ref[0:1].decode("ascii").upper(),
            "<INV>",
            info,
            "GT:QI",
            qi,
        )
    )


def call_within_var(
    mafrec: MafRecord, if_snp: bool, svlen_cutoff: int, if_inv: bool,
    runs=None,
):
    """Vectorized variant scan over one (chunk) record
    (reference: caller.rs:388-608).  Returns VCF row tuples.

    runs=(vals, lens): precomputed caller-mode run table for this chunk
    (the device route, call_record); the host engine's otherwise."""
    t_arr = C.seq_bytes(mafrec.target_seq)
    q_arr = C.seq_bytes(mafrec.query_seq)
    chro = mafrec.target_name
    q_chro = mafrec.query_name
    t_start = mafrec.target_start
    q_start = mafrec.query_start
    negative = mafrec.is_negative
    fmt_suffix = "N" if negative else "P"
    init_info = "INV_NEST=TRUE;" if negative else ""

    # gap-stripped, pre-uppercased copies used for REF/ALT slicing
    # (caller.rs:411-415; noodles uppercases bases on parse)
    t_seq_ref = t_arr[t_arr != C.GAP].tobytes()
    q_seq_ref = q_arr[q_arr != C.GAP].tobytes()
    t_str = t_seq_ref.decode("ascii").upper()
    q_str = q_seq_ref.decode("ascii").upper()

    out = []
    if negative and len(t_seq_ref) > 0 and if_inv:
        _emit_inv_record(out, mafrec, t_seq_ref, fmt_suffix)

    vals, lens = runs if runs is not None else C.caller_runs(t_arr, q_arr)
    out.extend(
        _emit_variant_rows(
            vals, lens, t_start, q_start, t_str, q_str, chro, q_chro,
            fmt_suffix, init_info, if_snp, svlen_cutoff,
        )
    )
    return out


def _emit_variant_rows(
    vals,
    lens,
    t_start,
    q_start,
    t_str,
    q_str,
    chro,
    q_chro,
    fmt_suffix,
    init_info,
    if_snp,
    svlen_cutoff,
):
    """Run-table -> VCF rows: the shared vectorized event scan
    (reference: caller.rs:453-606 for MAF columns, caller.rs:640-818 for
    the PAF CIGAR fold -- both reduce to the same per-run machinery).

    vals: category codes (C.EQ/C.X/C.I/C.D/C.W) per run; lens: run lengths.
    t_str/q_str: gap-free uppercased sequences starting at
    t_start/q_start.  Returns VCF row tuples/bytes in emission order.
    """
    nruns = vals.shape[0]
    if nruns == 0:
        return []
    if nruns <= 256:
        vlist = vals.tolist()
        llist = lens.tolist()
        if sum(llist) <= 65536:
            # small chunk: the vectorized formulation pays ~25 numpy
            # dispatches of fixed cost; a sequential walk is ~10x faster
            # under ~256 runs and differentially tested identical
            return _emit_variant_rows_scalar(
                vlist, llist, t_start, q_start, t_str, q_str, chro,
                q_chro, fmt_suffix, init_info, if_snp, svlen_cutoff,
            )
    return _emit_variant_rows_vec(
        vals, lens, t_start, q_start, t_str, q_str, chro, q_chro,
        fmt_suffix, init_info, if_snp, svlen_cutoff,
    )


def _emit_variant_rows_vec(
    vals,
    lens,
    t_start,
    q_start,
    t_str,
    q_str,
    chro,
    q_chro,
    fmt_suffix,
    init_info,
    if_snp,
    svlen_cutoff,
):
    """Vectorized large-chunk path of _emit_variant_rows."""
    out = []
    nruns = vals.shape[0]
    lens64 = lens.astype(np.int64)
    # per-run target/query offsets at run start
    t_adv = np.where((vals == C.EQ) | (vals == C.X) | (vals == C.D), lens64, 0)
    q_adv = np.where((vals == C.EQ) | (vals == C.X) | (vals == C.I), lens64, 0)
    t_off = t_start + np.concatenate(([0], np.cumsum(t_adv)[:-1]))
    q_off = q_start + np.concatenate(([0], np.cumsum(q_adv)[:-1]))

    # after_m at run k: the most recent non-W run before k was '=' or 'X'
    # (W runs "do nothing", caller.rs:461-463)
    sig = vals != C.W
    is_m = (vals == C.EQ) | (vals == C.X)
    idx = np.arange(nruns)
    last_sig = np.where(sig, idx, -1)
    last_sig = np.maximum.accumulate(last_sig)
    prev_sig = np.concatenate(([-1], last_sig[:-1]))
    after_m = np.where(prev_sig >= 0, is_m[np.clip(prev_sig, 0, None)], False)

    # negative-anchor guard: after_m set by a ZERO-length match can leave
    # the indel's anchor base at index -1 (t_off==t_start or
    # q_off==q_start); the reference panics on the slice underflow
    # (caller.rs:531-535) -- we skip the event (PARITY.md)
    anchor_ok = (t_off > t_start) & (q_off > q_start)
    indel_ok = (lens64 > svlen_cutoff) & after_m & anchor_ok
    ins_sel = np.flatnonzero((vals == C.I) & indel_ok)
    del_sel = np.flatnonzero((vals == C.D) & indel_ok)
    snp_sel = np.flatnonzero(vals == C.X) if if_snp else np.zeros(0, np.int64)

    t_ref_np = np.frombuffer(t_str.encode("ascii"), dtype=np.uint8)
    q_ref_np = np.frombuffer(q_str.encode("ascii"), dtype=np.uint8)

    events = []  # (run_idx, sub_idx, row)
    iblob = None
    if ins_sel.size or del_sel.size:
        # ONE native call formats every indel row of the chunk in run
        # order (the per-event Python loop + write_record f-strings
        # dominated indel-dense calls: 2.8M events = ~17 s on the
        # 100 Mbp profiling corpus before this)
        sel_all = np.concatenate([ins_sel, del_sel])
        isdel_all = np.concatenate(
            [
                np.zeros(ins_sel.size, np.uint8),
                np.ones(del_sel.size, np.uint8),
            ]
        )
        order = np.argsort(sel_all, kind="stable")
        sel_all = sel_all[order]
        isdel_all = isdel_all[order]
        res = native.format_indel_rows(
            chro.encode("ascii"), q_chro.encode("ascii"),
            fmt_suffix.encode("ascii"), init_info.encode("ascii"),
            t_ref_np, q_ref_np, t_start, q_start,
            t_off[sel_all], q_off[sel_all], lens64[sel_all], isdel_all,
        )
        if res is not None:
            iblob, iend = res
            # memoryview slices: no per-event copy (2.8M events on the
            # 100 Mbp profile); the sink join makes the single copy
            mv = memoryview(iblob)
            b0 = 0
            for x, k in enumerate(sel_all.tolist()):
                e = int(iend[x])
                events.append((k, 0, mv[b0:e]))
                b0 = e
    if iblob is None:
        for k in ins_sel.tolist():
            ln = int(lens64[k])
            to, qo = int(t_off[k]), int(q_off[k])
            ts = to - t_start - 1
            qs = qo - q_start - 1
            ref = t_str[ts : ts + 1]
            alt = q_str[qs : qs + ln + 1]
            info = f"{init_info}SVTYPE=INS;SVLEN={ln};END={to}"
            qi = f"1|1:{q_chro}@{qo}@{qo + ln}@{fmt_suffix}"
            events.append((k, 0, (chro, to, ref, alt, info, "GT:QI", qi)))
        for k in del_sel.tolist():
            ln = int(lens64[k])
            to, qo = int(t_off[k]), int(q_off[k])
            ts = to - t_start - 1
            qs = qo - q_start - 1
            ref = t_str[ts : ts + ln + 1]
            alt = q_str[qs : qs + 1]
            info = f"{init_info}SVTYPE=DEL;SVLEN={ln};END={to + ln}"
            qi = f"1|1:{q_chro}@{qo}@{qo}@{fmt_suffix}"
            events.append((k, 0, (chro, to, ref, alt, info, "GT:QI", qi)))
        events.sort(key=lambda e: e[0])

    if snp_sel.size == 0:
        out.extend(row for _, _, row in events)
        return out

    # SNP rows: run-expand the X runs into flat position arrays and
    # bulk-format whole blocks between indel events (native C++ formatter;
    # per-row Python f-strings dominate SNP-dense chunks otherwise)
    snp_lens = lens64[snp_sel]
    total_snps = int(snp_lens.sum())
    run_ids = np.repeat(snp_sel, snp_lens)
    intra = np.arange(total_snps) - np.repeat(
        np.cumsum(snp_lens) - snp_lens, snp_lens
    )
    pos_flat = np.repeat(t_off[snp_sel], snp_lens) + intra
    qpos_flat = np.repeat(q_off[snp_sel], snp_lens) + intra
    ref_flat = t_ref_np[pos_flat - t_start]
    alt_flat = q_ref_np[qpos_flat - q_start]

    # ONE native call formats every SNP row of the chunk; row_end offsets
    # let the interleave below slice the blob at indel-event boundaries
    # (previously one native call per event: 20us wrapper cost x ~100k
    # events dominated SNP-dense calls)
    res = native.format_snp_rows(
        chro.encode("ascii"),
        q_chro.encode("ascii"),
        fmt_suffix.encode("ascii"),
        pos_flat,
        qpos_flat,
        ref_flat,
        alt_flat,
        want_offsets=True,
    )
    if res is not None:
        blob, row_end = res
    else:
        rows = [
            f"{chro}\t{p + 1}\t.\t{chr(rb)}\t{chr(ab)}\t.\t.\t.\t"
            f"GT:QI\t1|1:{q_chro}@{qp}@{fmt_suffix}\n"
            for p, qp, rb, ab in zip(
                pos_flat.tolist(),
                qpos_flat.tolist(),
                ref_flat.tolist(),
                alt_flat.tolist(),
            )
        ]
        blob = "".join(rows).encode("ascii")
        row_end = np.cumsum(
            np.fromiter((len(r) for r in rows), np.int64, len(rows))
        )

    # byte boundary before SNP-row i
    bnd = np.concatenate(([0], row_end))
    # interleave indel rows with SNP blocks in run order
    if events:
        ks = np.fromiter((e[0] for e in events), np.int64, len(events))
        cuts = np.searchsorted(run_ids, ks).tolist()
    else:
        cuts = []
    cursor = 0
    bmv = memoryview(blob)
    for (k, _, row), cut in zip(events, cuts):
        if cut > cursor:
            out.append(bmv[bnd[cursor] : bnd[cut]])
        cursor = cut
        out.append(row)
    if total_snps > cursor:
        out.append(bmv[bnd[cursor] : bnd[total_snps]])
    return out


def _emit_variant_rows_scalar(
    vlist,
    llist,
    t_start,
    q_start,
    t_str,
    q_str,
    chro,
    q_chro,
    fmt_suffix,
    init_info,
    if_snp,
    svlen_cutoff,
):
    """Sequential small-chunk equivalent of _emit_variant_rows' vectorized
    scan (same run-order interleaving of SNP blocks and indel rows; SNP
    rows formatted to the exact bytes native.format_snp_rows emits)."""
    out = []
    t_off = t_start
    q_off = q_start
    after_m = False
    snp_buf = []

    def flush():
        if snp_buf:
            out.append("".join(snp_buf).encode("ascii"))
            snp_buf.clear()

    for v, ln in zip(vlist, llist):
        if v == C.EQ:
            t_off += ln
            q_off += ln
            after_m = True
        elif v == C.X:
            if if_snp:
                bt = t_off - t_start
                bq = q_off - q_start
                for d in range(ln):
                    snp_buf.append(
                        f"{chro}\t{t_off + d + 1}\t.\t{t_str[bt + d]}\t"
                        f"{q_str[bq + d]}\t.\t.\t.\tGT:QI\t"
                        f"1|1:{q_chro}@{q_off + d}@{fmt_suffix}\n"
                    )
            t_off += ln
            q_off += ln
            after_m = True
        elif v == C.I:
            # negative-anchor guard: matches _emit_variant_rows_vec
            # (reference panics on the slice underflow, caller.rs:531-535)
            if ln > svlen_cutoff and after_m and t_off > t_start and q_off > q_start:
                flush()
                ts = t_off - t_start - 1
                qs = q_off - q_start - 1
                out.append((
                    chro,
                    t_off,
                    t_str[ts : ts + 1],
                    q_str[qs : qs + ln + 1],
                    f"{init_info}SVTYPE=INS;SVLEN={ln};END={t_off}",
                    "GT:QI",
                    f"1|1:{q_chro}@{q_off}@{q_off + ln}@{fmt_suffix}",
                ))
            q_off += ln
            after_m = False
        elif v == C.D:
            if ln > svlen_cutoff and after_m and t_off > t_start and q_off > q_start:
                flush()
                ts = t_off - t_start - 1
                qs = q_off - q_start - 1
                out.append((
                    chro,
                    t_off,
                    t_str[ts : ts + ln + 1],
                    q_str[qs : qs + 1],
                    f"{init_info}SVTYPE=DEL;SVLEN={ln};END={t_off + ln}",
                    "GT:QI",
                    f"1|1:{q_chro}@{q_off}@{q_off}@{fmt_suffix}",
                ))
            t_off += ln
            after_m = False
        # W runs advance nothing and leave after_m unchanged
        # (caller.rs:461-463)
    flush()
    return out


def call_var_maf(
    mafreader,
    mafindex,
    writer,
    if_snp: bool,
    if_inv: bool,
    svlen_cutoff: int,
    device,
    sample=None,
    query_name=None,
    query_regex=None,
    chunk_size=None,
):
    """MAF variant calling with SV-safe chunking
    (reference: caller.rs:42-157).  device=None: the host engine;
    otherwise the run tables of large chunks and chunk groups come from
    `device` (call_record)."""
    vcf = VcfWriter(writer, sample or "sample")
    contigs = None
    if mafindex:
        contigs = [
            (name, item["size"])
            for name, item in mafindex.items()
            if item["isref"]
        ]
    vcf.write_header(contigs)

    for record in mafreader.records():
        if device is not None:
            call_record(record, vcf, if_snp, if_inv, svlen_cutoff, device,
                        chunk_size, query_name, query_regex)
            continue
        call_one_record(
            record,
            writer,
            if_snp,
            if_inv,
            svlen_cutoff,
            chunk_size,
            query_name,
            query_regex,
            vcf=vcf,
        )
    writer.flush()


def call_one_record(
    record,
    writer,
    if_snp,
    if_inv,
    svlen_cutoff,
    chunk_size=None,
    query_name=None,
    query_regex=None,
    vcf=None,
):
    """Chunked variant calling for one record, writing VCF body rows
    (reference: caller.rs:62-149)."""
    call_record_part(
        record, writer, if_snp, if_inv, svlen_cutoff, chunk_size,
        query_name, query_regex, 0, 1, vcf,
    )


def call_record_part(
    record,
    writer,
    if_snp,
    if_inv,
    svlen_cutoff,
    chunk_size=None,
    query_name=None,
    query_regex=None,
    part: int = 0,
    n_parts: int = 1,
    vcf=None,
    precomputed_plan=None,
):
    """Process contiguous slice `part` of `n_parts` of one record's SV-safe
    chunk plan.

    Every worker derives the same deterministic plan from the sequences
    (plan_chunks), so genome-axis sharding needs no coordination: part j
    of J takes plan[floor(j*K/J) : floor((j+1)*K/J)] and outputs
    concatenate in part order to exactly the sequential result.
    """
    if vcf is None:
        vcf = VcfWriter(writer)
    base_chunk_size = chunk_size or DEFAULT_CHUNK_SIZE
    if len(record.slines) == 1:
        return
    if query_name is not None:
        if record.get_query_idx_byname(query_name) is None:
            return
        record.set_query_idx_byname(query_name)
    elif query_regex is not None:
        try:
            record.set_query_idx_by_regex(query_regex)
        except Exception:
            return
    else:
        record.query_idx = 1

    view = _ChunkView(record)
    plan = precomputed_plan
    if plan is None:
        plan = plan_chunks(
            view.t_arr, view.q_arr, base_chunk_size, svlen_cutoff
        )
    k = len(plan)
    lo = (part * k) // n_parts
    hi = ((part + 1) * k) // n_parts
    if lo >= hi:
        return
    if plan[lo][0] > 0:
        view.skip_to(plan[lo][0])
    total_size = view.t_arr.shape[0]
    for chunk_count, (chunk_start, safe_end) in enumerate(plan[lo:hi], 1):
        chunk_rec = view.chunk(chunk_start, safe_end)
        _write_chunk_rows(vcf, chunk_rec, if_snp, if_inv, svlen_cutoff, None,
                          chunk_count, chunk_start, safe_end, total_size)


def _write_chunk_rows(vcf, chunk_rec, if_snp, if_inv, svlen_cutoff, runs,
                      chunk_count, chunk_start, safe_end, total_size):
    """One chunk's VCF rows, joined and written once (per-row
    BufferedWriter writes were ~10 s of a 100 Mbp profile)."""
    # per-chunk progress on large records (caller.rs:131-138)
    log.info(
        "Processed chunk %d: start=%d, end=%d, size=%d, progress=%.2f%%",
        chunk_count,
        chunk_start,
        safe_end,
        safe_end - chunk_start,
        (safe_end / total_size) * 100.0 if total_size else 100.0,
    )
    buf = [
        row if isinstance(row, (bytes, memoryview))
        else vcf.format_record(*row)
        for row in call_within_var(
            chunk_rec, if_snp, svlen_cutoff, if_inv, runs=runs
        )
    ]
    if buf:
        vcf.write_raw(b"".join(buf))


def plan_chunks(t_arr, q_arr, chunk_size, svlen_cutoff):
    """The full SV-safe chunk decomposition of a record.

    This is the genome-axis shard plan (SURVEY.md §5): deterministic from
    the sequences alone, so independent workers (or hosts) derive the same
    boundaries and claim disjoint chunk slices -- the halo rule is that no
    chunk boundary splits a gap run >= svlen_cutoff.

    Returns a list of (start, end) column windows covering [0, total).
    """
    total = len(t_arr)
    plan = []
    chunk_start = 0
    while chunk_start < total:
        safe_end, next_start = find_safe_chunk_boundary(
            t_arr, q_arr, chunk_start, chunk_size, svlen_cutoff, total
        )
        plan.append((chunk_start, safe_end))
        chunk_start = next_start
    return plan


def call_var_paf(
    pafreader,
    t_fa_path: str,
    q_fa_path: str,
    writer,
    if_snp: bool,
    svlen_cutoff: int,
    sample=None,
):
    """PAF variant calling driven by CIGAR ops with REF/ALT from FASTA
    (reference: caller.rs:268-302, 610-822).

    The CIGAR fold runs through the same vectorized run-table scan as the
    MAF path (_emit_variant_rows; ops map to caller categories via
    _OP2CAT), with bulk C++ SNP-row formatting: ~74 Mbp/s on a 20 Mbp
    SNP-dense synthetic (2026-08-17), vs per-op/per-base interpreted
    Python previously.

    Note the reference fetches the query sequence on the + strand even for
    negative-strand records -- reproduced.
    """
    vcf = VcfWriter(writer, sample or "sample")
    vcf.write_header(None)
    t_reader = FastaReader(t_fa_path)
    q_reader = FastaReader(q_fa_path)

    for rec in pafreader.records():
        t_seq = t_reader.fetch(rec.target_name, rec.target_start, rec.target_end)
        q_seq = q_reader.fetch(rec.query_name, rec.query_start, rec.query_end)
        negative = rec.is_negative
        fmt_suffix = "N" if negative else "P"
        init_info = "INV_NEST=TRUE;" if negative else ""
        if negative:
            info = f"SVTYPE=INV;END={rec.target_end}"
            qi = (
                f"1|1:{rec.query_name}@{rec.query_start}@{rec.query_end}"
                f"@{fmt_suffix}"
            )
            vcf.write_record(
                rec.target_name,
                rec.target_start + 1,
                t_seq[0:1].decode("ascii").upper(),
                "<INV>",
                info,
                "GT:QI",
                qi,
            )

        ops, lens = rec.get_cigar_ops()
        cats = _OP2CAT[ops]
        bad = np.flatnonzero(cats == 255)
        if bad.size:
            raise CigarOpInvalid(chr(int(ops[bad[0]])))
        # zero-length ops ('0=' tokenizes fine) advance nothing and emit
        # nothing, but they DO drive the after_m state machine in the
        # reference's fold ('0='/'0X' set after_m, '0I'/'0D' clear it,
        # caller.rs:682-684, 762-766), so they stay in the run table.
        # The one pathological case -- a zero-length match anchoring a
        # following indel at index -1, where the reference panics on the
        # slice underflow (caller.rs:531-535) -- is skipped inside
        # _emit_variant_rows (divergence noted in PARITY.md).
        rows = _emit_variant_rows(
            cats,
            lens,
            rec.target_start,
            rec.query_start,
            t_seq.decode("ascii").upper(),
            q_seq.decode("ascii").upper(),
            rec.target_name,
            rec.query_name,
            fmt_suffix,
            init_info,
            if_snp,
            svlen_cutoff,
        )
        buf = [
            row if isinstance(row, (bytes, memoryview))
            else vcf.format_record(*row)
            for row in rows
        ]
        if buf:
            vcf.write_raw(b"".join(buf))
    writer.flush()


# columns of chunks grouped into one device batch
GROUP_BUDGET = 64 << 20


def batch_runs(*args, **kwargs):
    """ops.rle_device.batch_runs, imported at the first call (that module
    loads torch)."""
    from ..ops.rle_device import batch_runs

    return batch_runs(*args, **kwargs)


def caller_runs(t_arr, q_arr, device):
    """Caller-mode run table (cats uint8, lens int64) of one chunk: a
    [1, n] device batch from DEVICE_MIN_COLUMNS columns on, the host
    engine below."""
    n = min(t_arr.shape[0], q_arr.shape[0])  # the host engine's zip rule
    if n < DEVICE_MIN_COLUMNS:
        return C.caller_runs(t_arr, q_arr)
    _, cats, lens = batch_runs(
        np.ascontiguousarray(t_arr[None, :n]),
        np.ascontiguousarray(q_arr[None, :n]),
        np.array([n], dtype=np.int32), device, caller=True,
    )
    return cats.astype(np.uint8), lens.astype(np.int64)


def call_record(record, vcf, if_snp, if_inv, svlen_cutoff, device,
                chunk_size=None, query_name=None, query_regex=None):
    """Variant rows of one record, chunk by chunk along its SV-safe chunk
    plan, written to `vcf`: call_record_part's serial case with the run
    tables from `device`.  Chunks group into device batches of up to
    GROUP_BUDGET columns."""
    if len(record.slines) == 1:
        return
    if query_name is not None:
        if record.get_query_idx_byname(query_name) is None:
            return
        record.set_query_idx_byname(query_name)
    elif query_regex is not None:
        try:
            record.set_query_idx_by_regex(query_regex)
        except Exception:  # the host engine skips such records the same way
            return
    else:
        record.query_idx = 1

    view = _ChunkView(record)
    plan = plan_chunks(view.t_arr, view.q_arr, chunk_size or DEFAULT_CHUNK_SIZE,
                       svlen_cutoff)
    total_size = view.t_arr.shape[0]
    chunk_count = 0

    def emit_group(group):
        nonlocal chunk_count
        runs_list = [None] * len(group)
        if len(group) > 1 and sum(e - s for s, e, _ in group) >= DEVICE_MIN_COLUMNS:
            from ..ops.classify import pack_pairs
            from ..ops.rle_device import split_run_tables

            t, q, lens = pack_pairs(
                [(r.target_seq, r.query_seq) for _, _, r in group]
            )
            runs_list = split_run_tables(
                len(group), *batch_runs(t, q, lens, device, caller=True)
            )
        for (chunk_start, safe_end, chunk_rec), runs in zip(group, runs_list):
            chunk_count += 1
            if runs is None:
                runs = caller_runs(C.seq_bytes(chunk_rec.target_seq),
                                   C.seq_bytes(chunk_rec.query_seq), device)
            _write_chunk_rows(vcf, chunk_rec, if_snp, if_inv, svlen_cutoff,
                              runs, chunk_count, chunk_start, safe_end,
                              total_size)

    group, group_cols = [], 0
    for chunk_start, safe_end in plan:
        group.append((chunk_start, safe_end, view.chunk(chunk_start, safe_end)))
        group_cols += safe_end - chunk_start
        if group_cols >= GROUP_BUDGET:
            emit_group(group)
            group, group_cols = [], 0
    if group:
        emit_group(group)
