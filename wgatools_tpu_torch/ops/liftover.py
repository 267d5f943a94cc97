"""Per-op offset scans, the coverage and chain tables built on them, and
the host op packers.

The port of wgatools_tpu/ops/liftover.py.  Every
coordinate walk of the CIGAR engine is an exclusive prefix sum of per-op
advances along each record's row of a padded [B, N] op table (op 0 is
padding):

  liftover mode: the target advances on every op but I and S, the query on
    every op but D (reference cigar.rs:718-726);
  chain mode: cumulative I sizes and D sizes, the target_diff/query_diff
    state of cigar_unit_chain (reference cigar.rs:460-490).

`liftover_scan` and `chain_scan` launch kernel B (csrc/liftover_scan.cu) on
CUDA tensors; `liftover_scan_ref` is the plain PyTorch version (an int32
torch.cumsum) they are held against, and the one CPU tensors take.  The TPU
package's bf16-limb matmul scans and their `wide` switch were workarounds
for the TPU's matrix unit and have no counterpart here: int32 sums are exact
for any op length.

`coverage_span_table`, `spans_to_coverage` and `chain_advance_table` are
the tables pafcov and the chain tools build from those scans, on tensors of
one device.

The numpy packers below (pack_ops_words, pack_ops_words16, pack_ops_adv16,
pack_ops_sums, expand_group_prefix, ...) are the host side of the fused
kernels' op words and match the TPU package's byte for byte.
"""

import numpy as np
import torch

from ..kernels import _build
from .coverage import diff_to_coverage, scatter_spans

OP_M = ord("M")
OP_EQ = ord("=")
OP_X = ord("X")
OP_I = ord("I")
OP_D = ord("D")
OP_S = ord("S")

_MODES = {"liftover": 0, "chain": 1}


def liftover_scan_ref(ops, lens, mode="liftover"):
    """Plain PyTorch version of kernel B.  ops: uint8 [B, N] (0 = padding);
    lens: int32 [B, N].  Returns exclusive (t, q) int32 [B, N] in liftover
    mode, exclusive (ins, del) cumulative sizes in chain mode."""
    lens = lens.to(torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=lens.device)
    if mode == "chain":
        adv_t = torch.where(ops == OP_I, lens, zero)
        adv_q = torch.where(ops == OP_D, lens, zero)
    elif mode == "liftover":
        pad = ops == 0
        adv_t = torch.where(pad | (ops == OP_I) | (ops == OP_S), zero, lens)
        adv_q = torch.where(pad | (ops == OP_D), zero, lens)
    else:
        raise ValueError(f"unknown scan mode {mode!r}")
    t_off = torch.cumsum(adv_t, dim=1, dtype=torch.int32) - adv_t
    q_off = torch.cumsum(adv_q, dim=1, dtype=torch.int32) - adv_q
    return t_off, q_off


def _scan(ops, lens, mode):
    if ops.device.type == "cpu":
        return liftover_scan_ref(ops, lens, mode)
    _build.check_cuda(ops, lens)
    if ops.dtype != torch.uint8 or lens.dtype != torch.int32:
        raise ValueError("the op scan takes uint8 ops and int32 lens")
    if ops.dim() != 2 or ops.shape != lens.shape:
        raise ValueError(
            f"ops {tuple(ops.shape)} and lens {tuple(lens.shape)} must be "
            "one [B, N] shape"
        )
    B, N = ops.shape
    t_off = torch.empty((B, N), dtype=torch.int32, device=ops.device)
    q_off = torch.empty((B, N), dtype=torch.int32, device=ops.device)
    _build.launch("liftover_scan", ops, lens, t_off, q_off, B, N, _MODES[mode])
    return t_off, q_off


def liftover_scan(ops, lens):
    """Exclusive per-op (target, query) offsets within each record: kernel
    B on CUDA tensors, its plain version on CPU tensors.  ops: uint8
    [B, N] (0 = padding); lens: int32 [B, N]; row totals below 2^31."""
    return _scan(ops, lens, "liftover")


def chain_scan(ops, lens):
    """Exclusive per-op cumulative (ins, del) sizes for chain-line
    derivation (cigar_unit_chain, reference cigar.rs:460-490): kernel B's
    chain mode on CUDA tensors, its plain version on CPU tensors."""
    return _scan(ops, lens, "chain")


def coverage_span_table(ops, lens, t_starts):
    """Per-op absolute M/'=' coverage spans (update_cov_vec semantics).

    ops: uint8 [B, N] (0 = padding); lens: int32 [B, N]; t_starts: int32
    [B], the records' target starts.  Returns (starts, ends) int32 [B, N]
    with the ops that cover nothing marked -1, as
    wgatools_tpu.tools.pafcov.coverage_spans gives them.  The target
    offsets come from liftover_scan (kernel B on CUDA tensors)."""
    lens = lens.to(torch.int32)
    t_off, _ = liftover_scan(ops, lens)
    cover = (ops == OP_M) | (ops == OP_EQ)
    starts = t_starts.to(torch.int32)[:, None] + t_off
    ends = starts + lens
    neg = torch.full((), -1, dtype=torch.int32, device=ops.device)
    return torch.where(cover, starts, neg), torch.where(cover, ends, neg)


def spans_to_coverage(starts, ends, genome_len: int):
    """Span tables (any shape) -> int32 [genome_len] per-base coverage of
    one target: a difference array and its prefix sum.  Spans whose start
    is negative are padding and add nothing."""
    starts, ends = starts.reshape(-1), ends.reshape(-1)
    diff = torch.zeros(genome_len + 1, dtype=torch.int32, device=starts.device)
    scatter_spans(diff, starts, ends, valid=(starts >= 0).to(torch.int32))
    return diff_to_coverage(diff)


def chain_advance_table(ops, lens):
    """INCLUSIVE per-op cumulative (ins, del) sizes: chain_scan plus each
    op's own I or D length."""
    lens = lens.to(torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=lens.device)
    ex_i, ex_d = chain_scan(ops, lens)
    return (ex_i + torch.where(ops == OP_I, lens, zero),
            ex_d + torch.where(ops == OP_D, lens, zero))


def int32_safe_record(lens) -> bool:
    """Whether one record's op table can take the int32 device scan: it
    has ops and its lengths sum below 2^31 (so no prefix can wrap).  The
    rest take the int64 host path."""
    return len(lens) > 0 and int(np.asarray(lens).sum(dtype=np.int64)) < 2**31


def interleave_halves(even, odd):
    """Zip even/odd half-arrays ([B, N/2] each) back to [B, N]."""
    even = np.asarray(even)
    odd = np.asarray(odd)
    out = np.empty((even.shape[0], even.shape[1] * 2), even.dtype)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def pack_ops_batch(op_arrays, len_arrays, align=128):
    """Pad per-record (ops, lens) arrays to uint8 / int32 [B, N], 0-padded;
    N is a multiple of `align` and at least `align`."""
    B = len(op_arrays)
    N = max((len(a) for a in op_arrays), default=0)
    N = max(((N + align - 1) // align) * align, align)
    ops = np.zeros((B, N), dtype=np.uint8)
    lens = np.zeros((B, N), dtype=np.int32)
    for k, (o, l) in enumerate(zip(op_arrays, len_arrays)):
        ops[k, : len(o)] = o
        lens[k, : len(o)] = l
    return ops, lens


def pack_ops_words(ops, lens):
    """Packed op words for kernel 8: (op byte << 24) | len, int32 [B, N];
    every length < 2^16 (ValueError otherwise).  Padding (op 0, len 0)
    packs to 0."""
    ops = np.asarray(ops, dtype=np.uint8)
    lens = np.asarray(lens)
    if lens.max(initial=0) >= (1 << 16):
        raise ValueError("packed op words need len < 2^16")
    return (ops.astype(np.int32) << 24) | lens.astype(np.int32)


# advance classes for the 16-bit packings: which of (target, query) an op
# advances (cigar.rs:718-726)
ADV_PAD, ADV_BOTH, ADV_I, ADV_S, ADV_D = 0, 1, 2, 3, 4
_ADV_CLASS = np.zeros(256, dtype=np.int32)
for _b in b"M=X":
    _ADV_CLASS[_b] = ADV_BOTH
_ADV_CLASS[OP_I] = ADV_I
_ADV_CLASS[OP_S] = ADV_S
_ADV_CLASS[OP_D] = ADV_D
# ops the packers accept: padding plus the classes above; anything else
# (N, H, corrupt bytes) would pack to the padding class and advance nothing
_VALID_PACK16 = np.zeros(256, dtype=bool)
_VALID_PACK16[0] = True
for _b in b"M=XIDS":
    _VALID_PACK16[_b] = True


def _validate_pack16(ops, lens, who, pad_to):
    """Guard shared by the 16-bit op packers: op bytes in M/=/X/I/S/D (+ 0
    padding), lengths < 2^13; N zero-padded to a multiple of `pad_to`.
    Returns (ops uint8, lens) padded."""
    ops = np.asarray(ops, dtype=np.uint8)
    lens = np.asarray(lens)
    if lens.max(initial=0) >= (1 << 13):
        raise ValueError(f"{who} needs len < 8192")
    if not _VALID_PACK16[ops].all():
        bad = np.unique(ops[~_VALID_PACK16[ops]])
        raise ValueError(
            f"{who}: unsupported op byte(s) "
            f"{[chr(b) for b in bad]}; only M/=/X/I/S/D pack to advance "
            "classes (use the 32-bit op paths for other ops)"
        )
    N = ops.shape[1]
    if N % pad_to:
        pad = pad_to - N % pad_to
        ops = np.pad(ops, ((0, 0), (0, pad)))
        lens = np.pad(lens, ((0, 0), (0, pad)))
    return ops, lens


def _host_advances(ops, lens, who, pad_to):
    """Per-op (target, query) advances, int32 [B, N'], of the 16-bit
    packers: the one home of the class -> advance mapping that
    pack_ops_adv16 words and pack_ops_sums anchors recombine under."""
    ops, lens = _validate_pack16(ops, lens, who, pad_to)
    cls = _ADV_CLASS[ops]
    lens = lens.astype(np.int32)
    adv_t = np.where((cls == ADV_BOTH) | (cls == ADV_D), lens, 0)
    adv_q = np.where(
        (cls == ADV_BOTH) | (cls == ADV_I) | (cls == ADV_S), lens, 0
    )
    return adv_t, adv_q


def pack_ops_words16(ops, lens):
    """TWO ops per int32, for the fused kernel F: [0:13) len0, [13:16)
    cls0, [16:29) len1, [29:32) cls1, with the advance classes above.  Every
    length < 2^13, ops in M/=/X/I/S/D (ValueError otherwise: an unknown op
    would pack to the padding class and advance nothing); N is padded to
    even.  Returns int32 [B, ceil(N/2)]; a cls1 of D sets bit 31."""
    ops, lens = _validate_pack16(ops, lens, "pack_ops_words16", pad_to=2)
    half = (_ADV_CLASS[ops] << 13) | lens.astype(np.int32)
    return half[:, 0::2] | (half[:, 1::2] << 16)


def pack_ops_adv16(ops, lens):
    """Per op PAIR and direction one int32 word (adv_even << 14) |
    (adv_even + adv_odd).  Every length < 2^13, ops in M/=/X/I/S/D.
    Returns (wt, wq) int32 [B, ceil(N/2)]; padding packs to 0."""
    adv_t, adv_q = _host_advances(ops, lens, "pack_ops_adv16", pad_to=2)

    def pack(a):
        even = a[:, 0::2]
        return (even << 14) | (even + a[:, 1::2])

    return pack(adv_t), pack(adv_q)


def pack_ops_sums(ops, lens, group=4):
    """Raw group sums: one int32 per `group` consecutive ops and direction,
    the group's total advance (group in 2, 4, 8; same op domain and length
    bound as pack_ops_adv16).  Returns (st, sq) int32 [B, ceil(N/group)]."""
    if group not in (2, 4, 8):
        raise ValueError(f"group must be 2, 4 or 8, not {group}")
    adv_t, adv_q = _host_advances(ops, lens, "pack_ops_sums", pad_to=group)
    B, N = adv_t.shape
    st = adv_t.reshape(B, N // group, group).sum(axis=2, dtype=np.int32)
    sq = adv_q.reshape(B, N // group, group).sum(axis=2, dtype=np.int32)
    return st, sq


def expand_group_prefix(anchors, w16, group=4):
    """Per-PAIR exclusive prefixes from group anchors + the adv16 pair
    words of the same direction: P[p] = anchors[p // (group/2)] + the
    exclusive sum of the pair sums before p within its group.  Returns
    int32 [B, N2] where w16 is [B, N2]; odd offsets then come from
    adv16_odd_offsets."""
    h = group // 2
    anchors = np.asarray(anchors)
    w16 = np.asarray(w16)
    B, N2 = w16.shape
    if h == 1:
        return anchors[:, :N2].astype(np.int32, copy=False)
    ng = (N2 + h - 1) // h
    ps = np.zeros((B, ng * h), np.int32)
    ps[:, :N2] = w16 & 0x3FFF
    ps = ps.reshape(B, ng, h)
    exc = np.cumsum(ps, axis=2, dtype=np.int32) - ps
    out = anchors[:, :ng, None] + exc
    return out.reshape(B, ng * h)[:, :N2]


def adv16_odd_offsets(even, w):
    """Odd-position offsets from the even ones and the adv16 words:
    odd = even + (w >> 14)."""
    return even + (w >> 14)
