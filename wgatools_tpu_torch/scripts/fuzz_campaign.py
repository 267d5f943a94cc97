"""Long-running differential fuzz campaign over the port's host engines and
its hand-written kernels.

The counterpart of scripts/fuzz_campaign.py, with its seven properties,
flags and PASS/FAIL lines:

  1. stat_vs_oracle: core.cigar.ext_runs (the C++ SWAR engine) against the
     naive per-character spec oracle, and the same pair through the device
     route `stat` takes (ops.batch.stream_seq_pair_stats: kernel A on the
     card) against the oracle's counters, either strand.
  2. maf_paf_roundtrip: maf2paf -> paf2maf(FASTA) must give back the MAF's
     s-lines byte for byte (both strands).
  3. call_chunked: call with a tiny random chunk size against the whole
     record: byte-identical VCF bodies (positive strand).
  4. op_packings: the 16-bit op packings (adv16 words, group sums at g =
     2, 4, 8) must rebuild the 32-bit liftover scan exactly; the same op
     table goes through kernel B (liftover and chain scans) and, with a
     column batch, through the fused kernels F, C (every plane kind, adv16
     words and group sums) and 8 (u8 ops and packed words): stats,
     offsets and anchors expanded per op against the plain versions and
     the 32-bit scan.
  5. cat_plane: arbitrary byte pairs, both category tables, through
     kernels A (category plane), D (byte planes and its word entry) and E
     (nibble planes, where the bytes take them) against the plain versions
     and the plain byte-plane stats.
  6. parser_robustness: corrupted MAF/PAF/chain input must parse or raise
     a WGAError, never anything else.
  7. extras: paf2blocks against a naive per-unit fold; trimovp keeps a
     sorted, non-overlapping subset and is idempotent.

    python -m wgatools_tpu_torch.scripts.fuzz_campaign [--iters N] [--seed S]

The kernels run on the card (the default device); under
WGA_TORCH_DEVICE=cpu the wrappers take their plain versions, for tests.
On the card the kernel properties (op_packings, cat_plane) run --iters
cases, on the CPU --iters // 10, as the TPU script ran its interpret-mode
kernels.  Each property draws its cases from default_rng(seed), the same
cases as the TPU script's; what that script does not draw (the fused
kernels' column batches, the strand of stat_vs_oracle's device route, the
padding of the kernel planes) comes from a second generator seeded with
[seed, 1], so that the first keeps the TPU script's sequence.  Within a
case every kernel launches back to back; one synchronisation ends the case,
after its comparisons.  A failing case prints the property, the seed, the
case index, the shapes and the first differing element, and the run goes
on to the next property.  Prints one PASS/FAIL line per property on
stdout; logs each property's cases per second, the card's name and power
limit and `kernel launches: {json}` on stderr; exits 1 on any failure.
"""

import argparse
import io
import json
import os
import sys
import tempfile
import time
import traceback
from itertools import groupby

import numpy as np
import torch

from ..bench import card_name_and_power
from ..core.device import torch_device
from ..kernels import _build
from ..ops.batch import stream_seq_pair_stats
from ..ops.classify import (
    classify_stat_bytes,
    classify_stat_bytes_ref,
    classify_stat_cat,
    classify_stat_cat_ref,
    classify_stat_nibbles,
    classify_stat_nibbles_ref,
    classify_stat_words,
    classify_stat_words_ref,
    pack_cat_nibbles,
    pack_nibble_words,
    pack_pairs,
)
from ..ops.fused import (
    classify_liftover_fused,
    classify_liftover_fused16,
    classify_liftover_fused_adv16,
)
from ..ops.liftover import (
    adv16_odd_offsets,
    chain_scan,
    expand_group_prefix,
    interleave_halves,
    liftover_scan,
    liftover_scan_ref,
    pack_ops_adv16,
    pack_ops_batch,
    pack_ops_sums,
    pack_ops_words,
    pack_ops_words16,
)

KERNEL_PROPS = ("op_packings", "cat_plane")


def log(msg):
    sys.stderr.write(f"[fuzz_campaign] {msg}\n")
    sys.stderr.flush()


# ---- the naive spec oracle (per-character loops) ----------------------------


def _cat_ext(c1, c2):
    if c1 == c2:
        return "="
    if c1 == "-":
        return "I"
    if c2 == "-":
        return "D"
    return "X"


def _runs(t, q):
    pairs = [_cat_ext(a, b) for a, b in zip(t, q)]
    return [(k, len(list(g))) for k, g in groupby(pairs)]


def cigar_string(t, q):
    return "".join(f"{n}{k}" for k, n in _runs(t, q))


def cigar_counts(t, q, negative):
    c = dict(
        match=0, mismatch=0, ins_event=0, ins=0, del_event=0, dele=0,
        inv_ins_event=0, inv_ins=0, inv_del_event=0, inv_del=0,
        inv_event=1 if negative else 0,
    )
    for k, n in _runs(t, q):
        if k == "=":
            c["match"] += n
        elif k == "X":
            c["mismatch"] += n
        elif k == "I":
            if negative:
                c["inv_ins_event"] += 1
                c["inv_ins"] += n
            else:
                c["ins_event"] += 1
                c["ins"] += n
        elif k == "D":
            if negative:
                c["inv_del_event"] += 1
                c["inv_del"] += n
            else:
                c["del_event"] += 1
                c["dele"] += n
    return c


def tokenize(cigar):
    out = []
    num = ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            out.append((ch, int(num)))
            num = ""
    return out


def blocks_rows(op_runs, q_start, t_start):
    """Per-unit fold of cigar_unit_block: M-like ops extend both ends and
    emit one (qs, qe, ts, te) row, then the starts collapse onto the ends;
    I advances the query only, D the target only."""
    qs = qe = q_start
    ts = te = t_start
    rows = []
    for op, n in op_runs:
        if op in "M=X":
            qe += n
            te += n
            rows.append((qs, qe, ts, te))
            qs, ts = qe, te
        elif op == "I":
            qs += n
            qe += n
        elif op == "D":
            ts += n
            te += n
        else:
            raise ValueError(op)
    return rows


_COMP = str.maketrans("ACGTN", "TGCAN")


def revcomp(s):
    return s.translate(_COMP)[::-1]


# ---- checks -----------------------------------------------------------------


def expect(cond, *detail):
    if not cond:
        raise AssertionError(" ".join(str(d) for d in detail))


def same(what, got, want):
    """Raise unless got equals want element for element; the message gives
    both shapes and the first differing element."""
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = (want.cpu().numpy() if isinstance(want, torch.Tensor)
            else np.asarray(want))
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} != {want.shape}")
    diff = np.argwhere(got != want)
    if len(diff):
        at = tuple(int(i) for i in diff[0])
        raise AssertionError(
            f"{what}: shape {got.shape}, {len(diff)} elements differ, first "
            f"at {at}: {got[at]} != {want[at]}")


# ---- case generators (the TPU script's draws) -------------------------------


def rand_alignment(rng, max_runs=40, alphabet="ACGTNacgtn"):
    """Random gapped alignment pair with edge-case bias."""
    style = rng.integers(0, 6)
    if style == 0:  # single run, possibly single column
        ops = [(str(rng.choice(list("=XID"))), int(rng.integers(1, 4)))]
    elif style == 1:  # long homogeneous '=' with rare X (realistic)
        ops = []
        for _ in range(int(rng.integers(1, 8))):
            ops.append(("=", int(rng.integers(1, 300))))
            ops.append((str(rng.choice(list("XID"))), int(rng.integers(1, 4))))
        ops.append(("=", 1))
    elif style == 2:  # indel storm
        ops = [
            (str(rng.choice(list("ID"))), int(rng.integers(1, 20)))
            for _ in range(int(rng.integers(1, max_runs)))
        ]
        ops.insert(0, ("=", 1))
        ops.append(("=", 1))
    else:  # random runs, no op twice in a row
        ops = []
        prev = None
        for _ in range(int(rng.integers(1, max_runs))):
            op = str(rng.choice(list("=XID")))
            while op == prev:
                op = str(rng.choice(list("=XID")))
            ops.append((op, int(rng.integers(1, 30))))
            prev = op
        ops.insert(0, ("=", int(rng.integers(1, 20))))
        ops.append(("=", int(rng.integers(1, 20))))
    t, q = [], []
    bases = list(alphabet)
    for op, ln in ops:
        for _ in range(ln):
            if op == "=":
                b = str(rng.choice(bases))
                t.append(b)
                q.append(b)
            elif op == "X":
                b1 = str(rng.choice(list("ACGT")))
                b2 = str(rng.choice([c for c in "ACGT" if c != b1]))
                t.append(b1)
                q.append(b2)
            elif op == "I":
                t.append("-")
                q.append(str(rng.choice(bases)))
            else:
                t.append(str(rng.choice(bases)))
                q.append("-")
    return "".join(t), "".join(q)


def _corrupt(rng, blob):
    """Random byte-level corruption: truncation, splice, byte flips,
    field deletion, junk insertion."""
    b = bytearray(blob)
    for _ in range(int(rng.integers(1, 4))):
        style = int(rng.integers(0, 5))
        if not b:
            break
        if style == 0:  # truncate
            b = b[: int(rng.integers(0, len(b)))]
        elif style == 1:  # flip bytes
            for _ in range(int(rng.integers(1, 8))):
                i = int(rng.integers(0, len(b)))
                b[i] = int(rng.integers(0, 256))
        elif style == 2:  # delete a span
            i = int(rng.integers(0, len(b)))
            j = min(len(b), i + int(rng.integers(1, 40)))
            del b[i:j]
        elif style == 3:  # insert junk
            i = int(rng.integers(0, len(b)))
            b[i:i] = bytes(rng.integers(0, 256, int(rng.integers(1, 20))))
        else:  # duplicate a span
            i = int(rng.integers(0, len(b)))
            j = min(len(b), i + int(rng.integers(1, 40)))
            b[i:i] = b[i:j]
    return bytes(b)


def op_table(rng):
    """The TPU script's random op table: B in 1..4 rows of 1..299 ops over
    M=XIDS, lengths 0..8191 with up to 4 of a row at 8191.  Returns the
    per-row (op_arrays, len_arrays)."""
    op_chars = np.frombuffer(b"M=XIDS", np.uint8)
    B = int(rng.integers(1, 5))
    op_arrays, len_arrays = [], []
    for _ in range(B):
        n = int(rng.integers(1, 300))
        op_arrays.append(op_chars[rng.integers(0, 6, n)])
        ls = rng.integers(0, 8192, n).astype(np.int32)
        k = min(n, 4)
        ls[rng.integers(0, n, k)] = 8191  # boundary lengths
        len_arrays.append(ls)
    return op_arrays, len_arrays


def byte_pairs(rng):
    """The TPU script's random byte pairs for the category plane: B in 1..4
    rows of 1..499 columns over ACGT-, arbitrary bytes with '-' sprinkled
    in, or A-."""
    B = int(rng.integers(1, 5))
    pairs = []
    for _ in range(B):
        n = int(rng.integers(1, 500))
        profile = rng.integers(0, 3)
        if profile == 0:
            alpha = np.frombuffer(b"ACGT-", np.uint8)
            t = alpha[rng.integers(0, 5, n)]
            q = alpha[rng.integers(0, 5, n)]
        elif profile == 1:
            t = rng.integers(1, 256, n).astype(np.uint8)
            q = rng.integers(1, 256, n).astype(np.uint8)
            t[rng.random(n) < 0.2] = ord("-")
            q[rng.random(n) < 0.2] = ord("-")
        else:
            alpha = np.frombuffer(b"A-", np.uint8)
            t = alpha[(rng.random(n) < 0.5).astype(int)]
            q = alpha[(rng.random(n) < 0.5).astype(int)]
        pairs.append((t.tobytes(), q.tobytes()))
    return pairs


def edge_rows(aux):
    """0-2 rows the TPU script's cases never hold: an empty row or an
    all-gap row, from the second generator."""
    rows = []
    for _ in range(int(aux.integers(0, 3))):
        n = int(aux.choice([0, 1, 7, 31, int(aux.integers(1, 300))]))
        rows.append((b"-" * n, b"-" * n))
    return rows


def cat_plane_case(rng, aux):
    """One cat_plane case: the TPU script's byte pairs plus edge rows,
    packed at an alignment of 8, 32 or 128 columns.  Returns (t, q, lens,
    cw) numpy planes; cw is the category plane (pack_cat_nibbles must take
    any bytes)."""
    pairs = byte_pairs(rng)
    pairs = pairs + edge_rows(aux)
    t, q, lens = pack_pairs(pairs, align=int(aux.choice([8, 32, 128])))
    cw = pack_cat_nibbles(t, q)
    expect(cw is not None, "pack_cat_nibbles refused", t.shape)
    return t, q, lens, cw


def column_batch(aux):
    """The fused kernels' column batch: B2 in 1..5 rows over the nibble
    dictionary's bytes (so every plane kind takes it), lengths biased to
    0, short and all-gap rows, at an alignment of 8, 32 or 128 columns.
    Returns (t, q, lens) numpy planes."""
    alphabet = np.frombuffer(b"ACGTNacgtn-", np.uint8)
    pairs = []
    for _ in range(int(aux.integers(1, 6))):
        n = int(aux.choice([0, 1, 31, 33, int(aux.integers(1, 700))]))
        if aux.random() < 0.15:
            pairs.append((b"-" * n, b"-" * n))
            continue
        t = alphabet[aux.integers(0, len(alphabet), n)]
        q = t.copy()
        flip = aux.random(n) < 0.3
        q[flip] = alphabet[aux.integers(0, len(alphabet), int(flip.sum()))]
        pairs.append((t.tobytes(), q.tobytes()))
    return pack_pairs(pairs, align=int(aux.choice([8, 32, 128])))


def op_packings_case(rng, aux):
    """One op_packings case: the TPU script's op table (ops uint8, lens
    int32 [B, N]) and a column batch (t, q, lens) whose row count is the
    op table's half of the time and random otherwise, and the category
    table (caller) to classify it with."""
    ops, lens = pack_ops_batch(*op_table(rng))
    t, q, col_lens = column_batch(aux)
    if aux.random() < 0.5:  # the op table's row count
        rows = np.arange(ops.shape[0]) % t.shape[0]
        t, q, col_lens = t[rows], q[rows], col_lens[rows]
    caller = bool(aux.integers(0, 2))
    return ops, lens, (t, q, col_lens), caller


# ---- properties ---------------------------------------------------------------


def _oracle_recstat(c):
    return dict(
        matched=c["match"], mismatched=c["mismatch"],
        ins_event=c["ins_event"], ins_size=c["ins"],
        del_event=c["del_event"], del_size=c["dele"],
        inv_ins_event=c["inv_ins_event"], inv_ins_size=c["inv_ins"],
        inv_del_event=c["inv_del_event"], inv_del_size=c["inv_del"],
        inv_event=c["inv_event"],
    )


def prop_stat_vs_oracle(rng, aux, device):
    from ..core import cigar as C

    t, q = rand_alignment(rng)
    tu, qu = t.upper(), q.upper()
    want = cigar_counts(tu, qu, False)
    vals, lens = C.ext_runs(
        np.frombuffer(tu.encode(), np.uint8).copy(),
        np.frombuffer(qu.encode(), np.uint8).copy(),
    )
    got = dict(match=0, mismatch=0, ins_event=0, ins=0, del_event=0, dele=0)
    for v, ln in zip(vals.tolist(), lens.tolist()):
        if v == C.EQ:
            got["match"] += ln
        elif v == C.X:
            got["mismatch"] += ln
        elif v == C.I:
            got["ins_event"] += 1
            got["ins"] += ln
        elif v == C.D:
            got["del_event"] += 1
            got["dele"] += ln
    for k in got:
        expect(got[k] == want[k], "ext_runs", k, got[k], "!= oracle", want[k],
               f"(columns {len(t)})")
    # the device route of `stat`
    negative = bool(aux.integers(0, 2))
    want = _oracle_recstat(cigar_counts(tu, qu, negative))
    (meta, rs), = stream_seq_pair_stats(
        [(tu.encode(), qu.encode(), negative, 0)], device)
    for k, w in want.items():
        expect(getattr(rs, k) == w, "stream_seq_pair_stats", k, getattr(rs, k),
               "!= oracle", w, f"(columns {len(t)}, negative {negative})")


def prop_maf_paf_roundtrip(rng, aux, device, tmpdir):
    from ..io.maf import MafReader
    from ..io.paf import PafReader
    from ..tools.convert import maf2paf, paf2maf

    t_aln, q_aln = rand_alignment(rng, alphabet="ACGT")
    if not t_aln or t_aln[0] == "-" or q_aln[0] == "-" or \
            t_aln[-1] == "-" or q_aln[-1] == "-":
        return  # PAF cannot carry lead/trail indels losslessly here
    negative = bool(rng.integers(0, 2))
    t_plain = t_aln.replace("-", "")
    q_plain = q_aln.replace("-", "")
    t_start = int(rng.integers(0, 50))
    q_start = int(rng.integers(0, 50))
    t_size = t_start + len(t_plain) + int(rng.integers(0, 50))
    q_size = q_start + len(q_plain) + int(rng.integers(0, 50))
    strand = "-" if negative else "+"
    maf = (
        "#maf version=1.6\n"
        "a score=0\n"
        f"s\tref.c\t{t_start}\t{len(t_plain)}\t+\t{t_size}\t{t_aln}\n"
        f"s\tqry.c\t{q_start}\t{len(q_plain)}\t{strand}\t{q_size}\t{q_aln}\n"
        "\n"
    )
    paf_out = io.BytesIO()
    maf2paf(MafReader(io.BytesIO(maf.encode())), paf_out, None)

    # FASTA backing for paf2maf: plain coordinates
    t_full = "A" * t_start + t_plain + "A" * (t_size - t_start - len(t_plain))
    if negative:
        # the query's start is a reverse-strand offset: the forward FASTA
        # holds the reverse complement
        q_fwd_off = q_size - q_start - len(q_plain)
        q_full = ("A" * q_fwd_off + revcomp(q_plain)
                  + "A" * (q_size - q_fwd_off - len(q_plain)))
    else:
        q_full = "A" * q_start + q_plain + "A" * (q_size - q_start - len(q_plain))
    tfa = os.path.join(tmpdir, "t.fa")
    qfa = os.path.join(tmpdir, "q.fa")
    with open(tfa, "w") as f:
        f.write(f">ref.c\n{t_full}\n")
    with open(qfa, "w") as f:
        f.write(f">qry.c\n{q_full}\n")
    for p in (tfa, qfa):
        fai = p + ".fai"
        if os.path.exists(fai):
            os.unlink(fai)

    maf_back = io.BytesIO()
    paf2maf(PafReader(io.BytesIO(paf_out.getvalue())), maf_back, tfa, qfa)
    want_s = [line for line in maf.upper().splitlines()
              if line.startswith("S\t")]
    got_s = [line for line in maf_back.getvalue().decode().upper().splitlines()
             if line.startswith("S\t")]
    expect(got_s == want_s, "round trip:", maf, maf_back.getvalue().decode())


def prop_call_chunked(rng, aux, device):
    from ..io.maf import MafReader
    from ..tools.caller import call_var_maf, plan_chunks

    t_aln, q_aln = rand_alignment(rng, alphabet="ACGT")
    if not t_aln:
        return
    t_plain = t_aln.replace("-", "")
    q_plain = q_aln.replace("-", "")
    maf = (
        "#maf version=1.6\n"
        "a score=0\n"
        f"s\tref.c\t100\t{len(t_plain)}\t+\t100000\t{t_aln}\n"
        f"s\tqry.c\t200\t{len(q_plain)}\t+\t100000\t{q_aln}\n\n"
    )
    cutoff = int(rng.integers(0, 4))
    cs = int(rng.integers(8, 64))

    def run(chunk_size):
        out = io.BytesIO()
        call_var_maf(
            MafReader(io.BytesIO(maf.encode())), None, out,
            if_snp=True, if_inv=True, svlen_cutoff=cutoff, device=None,
            chunk_size=chunk_size,
        )
        return out.getvalue()

    whole = run(None)
    tiny = run(cs)
    # The reference's quirk, kept on purpose: a chunk boundary landing
    # exactly on a gap-run start drops that SV through the leading-indel
    # skip (caller.rs:178-199 + 531-535).  Equality holds only when no
    # planned boundary starts on a gap column.
    t_arr = np.frombuffer(t_aln.encode(), np.uint8)
    q_arr = np.frombuffer(q_aln.encode(), np.uint8)
    gap = ord("-")
    plan = plan_chunks(t_arr, q_arr, cs, cutoff)
    boundary_on_sv = any(
        s > 0 and (t_arr[s] == gap or q_arr[s] == gap) for s, _ in plan
    )
    if boundary_on_sv:
        # weaker invariant: chunking only ever drops whole indel rows
        wl = set(whole.splitlines())
        for line in tiny.splitlines():
            expect(line in wl, "chunked call minted a line:", maf, line)
    else:
        expect(whole == tiny, "chunked call differs:", maf, whole[:400],
               tiny[:400])


def _check_host_packings(ops, lens, want_t, want_q):
    """The TPU script's host checks: the adv16 words and the group sums at
    g = 2, 4, 8 rebuild the 32-bit scan.  Returns the adv16 words."""
    N = ops.shape[1]
    wt, wq = pack_ops_adv16(ops, lens)

    def exclusive(a):
        return np.cumsum(np.concatenate(
            [np.zeros((a.shape[0], 1), np.int64), a], axis=1
        ), axis=1)[:, :-1].astype(np.int32)

    te, qe = exclusive(wt & 0x3FFF), exclusive(wq & 0x3FFF)
    same("adv16 t", interleave_halves(te, adv16_odd_offsets(te, wt))[:, :N],
         want_t)
    same("adv16 q", interleave_halves(qe, adv16_odd_offsets(qe, wq))[:, :N],
         want_q)
    for g in (2, 4, 8):
        st, sq = pack_ops_sums(ops, lens, group=g)
        expect(st.max(initial=0) < (1 << 16), "group sum", g, "past 2^16")
        ge = expand_group_prefix(exclusive(st), wt, group=g)
        gq = expand_group_prefix(exclusive(sq), wq, group=g)
        same(f"g{g} t", interleave_halves(ge, adv16_odd_offsets(ge, wt))[:, :N],
             want_t)
        same(f"g{g} q", interleave_halves(gq, adv16_odd_offsets(gq, wq))[:, :N],
             want_q)
    return wt, wq


def op_packings_plain(ops, lens, cols, caller):
    """The plain results an op_packings case is held to, on the CPU: the
    32-bit liftover and chain scans and the column batch's stats."""
    t, q, col_lens = (torch.from_numpy(a) for a in cols)
    ops_c, lens_c = torch.from_numpy(ops), torch.from_numpy(lens)
    return {
        "liftover": liftover_scan_ref(ops_c, lens_c),
        "chain": liftover_scan_ref(ops_c, lens_c, "chain"),
        "stats": classify_stat_bytes_ref(t, q, col_lens, caller),
    }


def prop_op_packings(rng, aux, device):
    ops, lens, cols, caller = op_packings_case(rng, aux)
    plain = op_packings_plain(ops, lens, cols, caller)
    want_t, want_q = (a.numpy() for a in plain["liftover"])
    wt, wq = _check_host_packings(ops, lens, want_t, want_q)
    N = ops.shape[1]
    label = f"ops {ops.shape}, columns {cols[0].shape}, caller {caller}"

    t, q, col_lens = cols
    nib = pack_nibble_words(t, q)
    expect(nib is not None, "pack_nibble_words refused the column batch")
    planes = {
        "words": (t.view("<i4"), q.view("<i4"), {}),
        "nibble": (*nib, {"nibble": True}),
        "cat": (pack_cat_nibbles(t, q), None, {"catmode": True}),
    }

    def up(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a)).to(device)

    d_ops, d_lens, d_cl = up(ops), up(lens), up(col_lens)
    d_planes = {k: (up(a), up(b), kw) for k, (a, b, kw) in planes.items()}
    d_wt, d_wq = up(wt), up(wq)
    sums = {g: pack_ops_sums(ops, lens, group=g) for g in (2, 4, 8)}
    # every launch first, back to back; the comparisons after.  Each fused
    # launch: (label, plane kind, outputs, what its offsets are: "pairs"
    # even and odd, "even" only, "full" per op, or the group g of its sums)
    scans = {"liftover": liftover_scan(d_ops, d_lens),
             "chain": chain_scan(d_ops, d_lens)}
    fused = []
    opw16 = up(pack_ops_words16(ops, lens))
    for kind in ("words", "nibble"):
        a, b, kw = d_planes[kind]
        fused.append((f"fused16 {kind}", kind, classify_liftover_fused16(
            a, b, d_cl, opw16, device, caller=caller, **kw), "pairs"))
    for kind, (a, b, kw) in d_planes.items():
        fused.append((f"fused_adv16 {kind}", kind,
                      classify_liftover_fused_adv16(
                          a, b, d_cl, d_wt, d_wq, device, caller=caller, **kw),
                      "pairs"))
    a, b, kw = d_planes["cat"]
    fused.append(("fused_adv16 cat even", "cat", classify_liftover_fused_adv16(
        a, b, d_cl, d_wt, d_wq, device, caller=caller, emit_odd=False, **kw),
        "even"))
    for g, kind in ((2, "words"), (4, "nibble"), (8, "cat")):  # 8: bench.py's
        a, b, kw = d_planes[kind]
        fused.append((f"fused_adv16 {kind} g{g}", kind,
                      classify_liftover_fused_adv16(
                          a, b, d_cl, *(up(x) for x in sums[g]), device,
                          caller=caller, raw_sums=True, **kw), g))
    tw, qw, _ = d_planes["words"]
    fused.append(("fused_ops u8", "words", classify_liftover_fused(
        tw, qw, d_cl, d_ops, d_lens, device, caller=caller), "full"))
    fused.append(("fused_ops packed", "words", classify_liftover_fused(
        tw, qw, d_cl, up(pack_ops_words(ops, lens)), None, device,
        caller=caller), "full"))

    # the comparisons
    for mode, out in scans.items():
        for k in range(2):
            same(f"{mode} scan[{k}] ({label})", out[k], plain[mode][k])
    stats_plain = {
        "words": classify_stat_words_ref(*(torch.from_numpy(a) for a in (
            planes["words"][0], planes["words"][1], col_lens)), caller),
        "nibble": classify_stat_nibbles_ref(*(torch.from_numpy(a) for a in (
            *nib, col_lens)), caller),
        "cat": classify_stat_cat_ref(torch.from_numpy(planes["cat"][0]),
                                     torch.from_numpy(col_lens), caller),
    }
    for kind, st in stats_plain.items():
        same(f"plain {kind} stats vs byte-plane stats ({label})", st,
             plain["stats"])
    for name, kind, out, offsets in fused:
        same(f"{name} stats ({label})", out[0], stats_plain[kind])
        host = [o.cpu().numpy() for o in out[1:]]
        if offsets == "full":
            per_op = [(host[0], want_t), (host[1], want_q)]
        elif offsets == "pairs":
            per_op = [(interleave_halves(host[0], host[1]), want_t),
                      (interleave_halves(host[2], host[3]), want_q)]
        else:
            per_op = []
            for k, (w, want) in enumerate(((wt, want_t), (wq, want_q))):
                even = host[k]
                if offsets != "even":  # anchors of group sums
                    x = torch.from_numpy(sums[offsets][k])
                    same(f"{name} anchors[{k}] ({label})", even,
                         torch.cumsum(x, 1, dtype=torch.int32) - x)
                    even = expand_group_prefix(even, w, group=offsets)
                per_op.append((interleave_halves(
                    even, adv16_odd_offsets(even, w)), want))
        for k, (got, want) in enumerate(per_op):
            same(f"{name} offsets[{k}] ({label})", got[:, :N], want)
    if device.type == "cuda":
        torch.cuda.synchronize()


def cat_plane_plain(t, q, lens, cw, caller):
    """The plain results a cat_plane case is held to, on the CPU: each
    kernel's plain version (kernel name -> [B, 8]) and the plain byte-plane
    stats (the port of classify_stat_jnp), under "oracle"."""
    tc, qc, lc = (torch.from_numpy(a) for a in (t, q, lens))
    tw, qw = (torch.from_numpy(a.view("<i4")) for a in (t, q))
    out = {
        "oracle": classify_stat_bytes_ref(tc, qc, lc, caller),
        "classify_cat": classify_stat_cat_ref(torch.from_numpy(cw), lc, caller),
        "classify_bytes": classify_stat_bytes_ref(tc, qc, lc, caller),
        "classify_words": classify_stat_words_ref(tw, qw, lc, caller),
    }
    nib = pack_nibble_words(t, q)
    if nib is not None:
        out["classify_nibbles"] = classify_stat_nibbles_ref(
            *(torch.from_numpy(a) for a in nib), lc, caller)
    return out


def prop_cat_plane(rng, aux, device):
    t, q, lens, cw = cat_plane_case(rng, aux)
    nib = pack_nibble_words(t, q)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    d_t, d_q, d_l, d_cw = up(t), up(q), up(lens), up(cw)
    d_tw, d_qw = up(t.view("<i4")), up(q.view("<i4"))
    d_nib = None if nib is None else (up(nib[0]), up(nib[1]))
    got = {}
    for caller in (False, True):
        got[caller] = {
            "classify_cat": classify_stat_cat(d_cw, d_l, caller),
            "classify_bytes": classify_stat_bytes(d_t, d_q, d_l, caller),
            "classify_words": classify_stat_words(d_tw, d_qw, d_l, caller),
        }
        if d_nib is not None:
            got[caller]["classify_nibbles"] = classify_stat_nibbles(
                *d_nib, d_l, caller)
    for caller, outs in got.items():
        plain = cat_plane_plain(t, q, lens, cw, caller)
        for name, out in outs.items():
            label = f"{name} caller={caller} (planes {t.shape})"
            same(f"{label} vs its plain version", out, plain[name])
            same(f"{label} vs the byte-plane stats", out, plain["oracle"])
    if device.type == "cuda":
        torch.cuda.synchronize()


def prop_parser_robustness(rng, aux, device):
    """Corrupted MAF/PAF/chain inputs must either parse or raise a clean
    WGAError, never an unhandled IndexError, ValueError, KeyError, ...
    (the CLI maps WGAError to exit 1 with a message)."""
    from ..errors import WGAError
    from ..io.chain import ChainReader
    from ..io.maf import MafReader
    from ..io.paf import PafReader

    t_aln, q_aln = rand_alignment(rng, alphabet="ACGT")
    if not t_aln:
        return
    maf = (
        "#maf version=1.6\na score=0\n"
        f"s\tref.c\t10\t{len(t_aln.replace('-', ''))}\t+\t100000\t{t_aln}\n"
        f"s\tqry.c\t20\t{len(q_aln.replace('-', ''))}\t+\t100000\t{q_aln}\n\n"
    ).encode()
    paf = (
        "q\t500\t0\t400\t+\tt\t600\t0\t450\t380\t460\t60\t"
        "cg:Z:100=5I200=10D100=\n"
    ).encode()
    chain = (
        "chain 4900 t 600 + 0 450 q 500 + 0 400 1\n100\t10\t5\n300\n\n"
    ).encode()
    for reader_cls, blob in (
        (MafReader, maf), (PafReader, paf), (ChainReader, chain),
    ):
        bad = _corrupt(rng, blob)
        try:
            for rec in reader_cls(io.BytesIO(bad)).records():
                # the record's compute accessors too: corrupt cg strings go
                # through the C++ CIGAR tokenizer, corrupt seqs through
                # classify + RLE
                for attr in ("get_stat", "get_cigar_ops", "get_cigar"):
                    fn = getattr(rec, attr, None)
                    if fn is not None:
                        try:
                            fn()
                        except WGAError:
                            pass
        except WGAError:
            pass  # a clean, user-facing failure
        # silent acceptance of a mutated but well-formed file is fine


def prop_extras(rng, aux, device):
    """paf2blocks against the naive per-unit fold (blocks_rows); trimovp
    keeps a subset of the input rows, each (target, query) group sorted by
    target_start and pairwise non-overlapping, and is idempotent."""
    from ..io.paf import PafReader
    from ..tools.convert import paf2blocks
    from ..tools.trimovp import trim_ovp

    lines = []
    per_rec_oracle = []
    for _ in range(int(rng.integers(1, 8))):
        t, q = rand_alignment(rng, max_runs=12)
        cg = cigar_string(t, q)
        runs = tokenize(cg)
        qadv = sum(n for op, n in runs if op in "M=XI")
        tadv = sum(n for op, n in runs if op in "M=XD")
        qs = int(rng.integers(0, 1000))
        ts = int(rng.integers(0, 1000))
        qn = f"q{int(rng.integers(1, 4))}"
        tn = f"t{int(rng.integers(1, 3))}"
        strand = str(rng.choice(["+", "-"]))
        lines.append(
            f"{qn}\t{qs + qadv + 10}\t{qs}\t{qs + qadv}\t{strand}\t"
            f"{tn}\t{ts + tadv + 10}\t{ts}\t{ts + tadv}\t"
            f"{qadv}\t{max(qadv, tadv)}\t60\tcg:Z:{cg}\n"
        )
        per_rec_oracle.append((qn, tn, strand, blocks_rows(runs, qs, ts)))

    text = "".join(lines).encode()
    out = io.BytesIO()
    paf2blocks(PafReader(io.BytesIO(text)), out)
    got = out.getvalue().decode().splitlines()[1:]  # drop the header
    want = []
    for qn, tn, strand, rows in per_rec_oracle:
        for qs_, qe_, ts_, te_ in rows:
            want.append(f"{qn}\t{qs_}\t{qe_}\t{tn}\t{ts_}\t{te_}\t{strand}")
    expect(got == want, f"paf2blocks mismatch:\n{got}\nvs\n{want}")

    out = io.BytesIO()
    trim_ovp(PafReader(io.BytesIO(text)), out)
    kept = out.getvalue().decode().splitlines()
    inputs = [ln.rstrip("\n") for ln in lines]
    expect(all(k in inputs for k in kept), "trimovp minted a record")
    groups = {}
    for k in kept:
        f = k.split("\t")
        groups.setdefault((f[5], f[0]), []).append((int(f[7]), int(f[8])))
    for spans in groups.values():
        expect(spans == sorted(spans), "group not sorted by target_start")
        for (s0, e0), (s1, e1) in zip(spans, spans[1:]):
            expect(s1 >= e0, f"overlap survived: {(s0, e0)} {(s1, e1)}")
    out2 = io.BytesIO()
    trim_ovp(PafReader(io.BytesIO(out.getvalue())), out2)
    expect(out2.getvalue() == out.getvalue(), "trimovp not idempotent")


PROPS = {
    "stat_vs_oracle": prop_stat_vs_oracle,
    "maf_paf_roundtrip": prop_maf_paf_roundtrip,
    "call_chunked": prop_call_chunked,
    "op_packings": prop_op_packings,
    "cat_plane": prop_cat_plane,
    "parser_robustness": prop_parser_robustness,
    "extras": prop_extras,
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = torch_device()
    on_card = device.type == "cuda"
    if on_card:
        _build.lib()
    _build.reset_launches()
    failures = 0
    with tempfile.TemporaryDirectory() as td:
        for name, prop in PROPS.items():
            rng = np.random.default_rng(args.seed)
            aux = np.random.default_rng([args.seed, 1])
            n_iters = args.iters
            if name in KERNEL_PROPS and not on_card:
                n_iters //= 10
            extra = (td,) if name == "maf_paf_roundtrip" else ()
            before = dict(_build.LAUNCHES)
            ok = 0
            t0 = time.perf_counter()
            try:
                for _ in range(n_iters):
                    prop(rng, aux, device, *extra)
                    ok += 1
                print(f"PASS {name}: {ok} cases", flush=True)
            except Exception:  # reported; the run goes on to the next one
                failures += 1
                print(f"FAIL {name} after {ok} cases: seed {args.seed}, case "
                      f"{ok}", flush=True)
                traceback.print_exc(limit=4, file=sys.stdout)
                sys.stdout.flush()
            secs = time.perf_counter() - t0
            counts = {k: v - before[k] for k, v in _build.LAUNCHES.items()
                      if v > before[k]}
            log(f"{name}: {ok} cases in {secs:.3f} s, "
                f"{ok / secs if secs else 0.0:.1f} cases/s on {device.type}; "
                f"launched {json.dumps(counts)}")
    if on_card:
        log(f"card: {card_name_and_power()}")
    log(f"kernel launches: {json.dumps(_build.LAUNCHES)}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
