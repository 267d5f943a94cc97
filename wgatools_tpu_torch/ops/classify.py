"""Column classify + per-record statistics.

The port of the main-path pieces of wgatools_tpu/ops/classify.py.  Each
aligned column pair (t, q) is one category, reduced on the device to int32
[B, 8] per-record counters

    matched, mismatched, ins_size, del_size, ins_events, del_events,
    gap/gap, runs

in ext mode (gap/gap columns are '=' and merge into '=' runs,
cigar_cat_ext) or caller mode (gap/gap is its own W category,
cigar_cat_ext_caller).  Four inputs:

- the category plane: the host packs each pair into ONE 4-bit one-hot code
  through a 64K LUT (X=0, EQ=1, I=2, D=4, GG=9), eight columns per int32
  word; `classify_stat_cat` launches kernel A (csrc/classify_cat.cu);
- the byte planes: uint8 t, q [B, L] already on the device;
  `classify_stat_bytes` launches kernel D (csrc/classify_bytes.cu);
- the byte-word planes: int32 t, q [B, L/4], the little-endian words of
  the byte planes (a zero-copy host `.view('<i4')`); `classify_stat_words`
  launches kernel D's device code through its word entry;
- the nibble planes: int32 t, q [B, L/8] of 4-bit dictionary codes
  (`pack_nibble_words`); `classify_stat_nibbles` launches kernel E
  (csrc/classify_nibbles.cu).

Each wrapper launches its kernel on a CUDA tensor; its `_ref` twin is the
plain PyTorch version it is held against, and the one a CPU tensor takes.
"""

import numpy as np
import torch

from ..kernels import _build

GAP = ord("-")

# stat column indices
STAT_MATCHED = 0
STAT_MISMATCHED = 1
STAT_INS_SIZE = 2
STAT_DEL_SIZE = 3
STAT_INS_EVENT = 4
STAT_DEL_EVENT = 5
STAT_GAPGAP = 6
STAT_RUNS = 7
N_STATS = 8

CAT_X, CAT_EQ, CAT_I, CAT_D, CAT_GG = 0, 1, 2, 4, 9

# standard category codes of the run tables (wgatools_tpu.core.cigar)
EQ, X, I, D, W = 0, 1, 2, 3, 4


def _build_cat_lut64k():
    t = np.arange(256, dtype=np.uint16)[:, None]
    q = np.arange(256, dtype=np.uint16)[None, :]
    tg = t == GAP
    qg = q == GAP
    lut = np.where(
        tg & qg,
        CAT_GG,
        np.where(tg, CAT_I, np.where(qg, CAT_D, np.where(t == q, CAT_EQ, CAT_X))),
    ).astype(np.uint8)
    return np.ascontiguousarray(lut.reshape(-1))  # index = (t << 8) | q


_CAT_LUT64K = _build_cat_lut64k()


def pack_pairs(pairs, align=128):
    """Pack a list of (t_bytes, q_bytes) into padded uint8 [B, L] planes.

    Padding is '-' in both rows (gap/gap).  A pair whose rows differ in
    length truncates to the shorter one, the reference's zip semantics.
    L is a multiple of `align` and at least `align`.  Returns
    (t, q, lengths) numpy arrays, lengths int32."""
    B = len(pairs)
    L = max((min(len(t), len(q)) for t, q in pairs), default=0)
    L = max(((L + align - 1) // align) * align, align)
    t_arr = np.full((B, L), GAP, dtype=np.uint8)
    q_arr = np.full((B, L), GAP, dtype=np.uint8)
    lengths = np.zeros(B, dtype=np.int32)
    for k, (t, q) in enumerate(pairs):
        n = min(len(t), len(q))
        lengths[k] = n
        t_arr[k, :n] = np.frombuffer(t, dtype=np.uint8)[:n]
        q_arr[k, :n] = np.frombuffer(q, dtype=np.uint8)[:n]
    return t_arr, q_arr, lengths


def pack_cat_nibbles(t, q, use_native=True):
    """uint8 [B, L] byte planes -> ONE int32 [B, L//8] category plane
    (column j's code in bits [4j, 4j+4) of word j//8); None when L is not
    a multiple of 8.  The C++ packer runs when the native library is
    available, the numpy one otherwise; both give the same words."""
    if t.shape[1] % 8:
        return None
    if use_native and t.flags.c_contiguous and q.flags.c_contiguous:
        from wgatools_tpu import native

        if native.available():
            cw = native.pack_cats(t, q, _CAT_LUT64K)
            if cw is not None:
                return cw
    c = _CAT_LUT64K[(t.astype(np.uint16) << 8) | q.astype(np.uint16)]
    b = c[:, 0::2] | (c[:, 1::2] << 4)
    return np.ascontiguousarray(b).view("<i4")


# 4-bit dictionary of the nibble planes: '-' first, so that a gap is code 0
_NIB_ALPHABET = b"-ACGTNacgtn."
_NIB_LUT = np.full(256, 255, dtype=np.uint8)
_NIB_LUT[np.frombuffer(_NIB_ALPHABET, np.uint8)] = np.arange(
    len(_NIB_ALPHABET), dtype=np.uint8
)


def pack_nibble_words(t, q, use_native=True):
    """uint8 [B, L] byte planes -> (tw, qw) int32 [B, L//8] nibble planes
    (column j's dictionary code in bits [4j, 4j+4) of word j//8), or None
    when L is not a multiple of 8 or any byte lies outside `-ACGTNacgtn.`:
    such batches take the byte or word planes instead.  The C++ packer runs
    when the native library is available, the numpy one otherwise; both
    give the same words."""
    if t.shape[1] % 8:
        return None
    if use_native and t.flags.c_contiguous and q.flags.c_contiguous:
        from wgatools_tpu import native

        if native.available():
            tw = native.pack_nibbles(t, _NIB_LUT)
            qw = None if tw is None else native.pack_nibbles(q, _NIB_LUT)
            return None if qw is None else (tw, qw)
    ct, cq = _NIB_LUT[t], _NIB_LUT[q]
    if int(ct.max(initial=0)) == 255 or int(cq.max(initial=0)) == 255:
        return None

    def pack(c):
        return np.ascontiguousarray(c[:, 0::2] | (c[:, 1::2] << 4)).view("<i4")

    return pack(ct), pack(cq)


def _unpack_cats(w):
    """int32 [B, LW] plane of nibbles -> uint8 [B, 8*LW], one per column."""
    B, LW = w.shape
    b = w.contiguous().view(torch.uint8).reshape(B, LW * 4)
    return torch.stack((b & 0xF, b >> 4), dim=2).reshape(B, LW * 8)


def classify_stat_cat_ref(cw, lengths, caller=False):
    """Plain PyTorch version of kernel A: int32 [B, LW] plane + int32 [B]
    lengths (columns) -> int32 [B, 8].  Columns >= lengths[b] are masked,
    so whatever the padding holds does not count."""
    return _stats_from_cats(_unpack_cats(cw), lengths, caller)


def _stats_from_cats(codes, lengths, caller):
    """uint8 [B, L] one-hot category codes -> int32 [B, 8] counters of the
    columns below each row's length."""
    B, L = codes.shape
    col = torch.arange(L, device=codes.device)
    valid = col[None, :] < lengths.to(codes.device)[:, None]
    key = codes if caller else codes & 7
    start = torch.ones_like(valid)
    start[:, 1:] = key[:, 1:] != key[:, :-1]
    start &= valid
    is_eqg = ((codes & 1) != 0) & valid
    is_i = ((codes & 2) != 0) & valid
    is_d = ((codes & 4) != 0) & valid
    is_gg = ((codes & 8) != 0) & valid

    def count(m):
        return m.sum(dim=1, dtype=torch.int32)

    eqg, ins, dele, gg = count(is_eqg), count(is_i), count(is_d), count(is_gg)
    return torch.stack(
        [
            eqg - gg if caller else eqg,
            count(valid) - eqg - ins - dele,
            ins,
            dele,
            count(start & is_i),
            count(start & is_d),
            gg,
            count(start),
        ],
        dim=1,
    )


def classify_stat_cat(cw, lengths, caller=False):
    """Kernel A on a CUDA tensor, its plain version on a CPU tensor.

    cw: int32 [B, LW] category plane (pack_cat_nibbles); lengths: int32 [B]
    in columns, on the same device.  Returns int32 [B, 8]."""
    if cw.device.type == "cpu":
        return classify_stat_cat_ref(cw, lengths, caller)
    return _launch_word_planes("classify_cat", 8, (cw,), lengths, caller)


def _launch_word_planes(kernel, cols_per_word, planes, lengths, caller):
    """Checks int32 [B, LW] word planes and int32 [B] lengths on one card,
    then launches `kernel` into a zeroed int32 [B, 8]."""
    _build.check_cuda(*planes, lengths)
    if any(p.dtype != torch.int32 for p in (*planes, lengths)):
        raise ValueError(f"{kernel} takes int32 planes and lengths")
    B, LW = planes[0].shape
    if any(p.shape != (B, LW) for p in planes) or lengths.shape != (B,):
        raise ValueError(
            f"shapes {[tuple(p.shape) for p in planes]}, lengths "
            f"{tuple(lengths.shape)} do not match"
        )
    if cols_per_word * LW >= 2**31:
        raise ValueError("row width would wrap the int32 counters")
    out = torch.zeros((B, N_STATS), dtype=torch.int32, device=lengths.device)
    _build.launch(kernel, *planes, lengths, out, B, LW, int(caller))
    return out


def _cats_from_nibbles(tw, qw):
    """int32 [B, LW] nibble planes -> uint8 [B, 8*LW] one-hot category
    codes: equal codes are EQ, code 0 is a gap, gap/gap is GG (EQ | 8)."""
    ct, cq = _unpack_cats(tw), _unpack_cats(qw)
    tg, qg = ct == 0, cq == 0
    gg = tg & qg
    codes = (ct == cq).to(torch.uint8)
    codes |= (tg ^ gg).to(torch.uint8) << 1
    codes |= (qg ^ gg).to(torch.uint8) << 2
    codes |= gg.to(torch.uint8) << 3
    return codes


def classify_stat_nibbles_ref(tw, qw, lengths, caller=False):
    """Plain PyTorch version of kernel E: int32 [B, LW] nibble planes +
    int32 [B] lengths (columns) -> int32 [B, 8].  Columns >= lengths[b]
    are masked."""
    return _stats_from_cats(_cats_from_nibbles(tw, qw), lengths, caller)


def classify_stat_nibbles(tw, qw, lengths, caller=False):
    """Kernel E on CUDA tensors, its plain version on CPU tensors.

    tw, qw: int32 [B, LW] nibble planes (pack_nibble_words); lengths: int32
    [B] in columns, on the same device.  Returns int32 [B, 8]."""
    if tw.device.type == "cpu":
        return classify_stat_nibbles_ref(tw, qw, lengths, caller)
    return _launch_word_planes("classify_nibbles", 8, (tw, qw), lengths, caller)


def _word_bytes(w):
    """int32 [B, LW] byte words -> the uint8 [B, 4*LW] plane they hold."""
    B, LW = w.shape
    return w.contiguous().view(torch.uint8).reshape(B, 4 * LW)


def classify_stat_words_ref(tw, qw, lengths, caller=False):
    """Plain PyTorch version of the word entry: int32 [B, LW] byte-word
    planes + int32 [B] lengths (columns) -> int32 [B, 8]."""
    return classify_stat_bytes_ref(_word_bytes(tw), _word_bytes(qw), lengths,
                                   caller)


def classify_stat_words(tw, qw, lengths, caller=False):
    """Kernel D's word entry on CUDA tensors, its plain version on CPU
    tensors.

    tw, qw: int32 [B, LW] little-endian words of the byte planes (4
    columns per word); lengths: int32 [B] in columns, on the same device.
    Returns int32 [B, 8]."""
    if tw.device.type == "cpu":
        return classify_stat_words_ref(tw, qw, lengths, caller)
    return _launch_word_planes("classify_words", 4, (tw, qw), lengths, caller)


def classify_columns(t, q, caller=False):
    """uint8 [B, L] byte planes -> uint8 [B, L] standard codes (EQ X I D W):
    ext mode (cigar_cat_ext) gives '=' to equal bytes, gap/gap included;
    caller mode (cigar_cat_ext_caller) gives W to gap/gap."""
    tg = t == GAP
    qg = q == GAP
    cat = torch.full_like(t, X)
    if caller:
        cat.masked_fill_(t == q, EQ)
        cat.masked_fill_(qg, D)
        cat.masked_fill_(tg, I)
        cat.masked_fill_(tg & qg, W)
    else:
        cat.masked_fill_(qg, D)
        cat.masked_fill_(tg, I)
        cat.masked_fill_(t == q, EQ)
    return cat


def cat_to_std(c, caller=False):
    """One-hot category nibbles (any integer tensor) -> uint8 standard codes.
    Ext mode masks bit 3 first, so that GG folds into EQ: gap/gap merges
    into '=' runs.  Codes the LUT never makes give X."""
    if not caller:
        c = c & 7
    std = torch.full(c.shape, X, dtype=torch.uint8, device=c.device)
    for cat, code in ((CAT_EQ, EQ), (CAT_I, I), (CAT_D, D), (CAT_GG, W)):
        std.masked_fill_(c == cat, code)
    return std


def classify_stat_bytes_ref(t, q, lengths, caller=False):
    """Plain PyTorch version of kernel D (the port of classify_stat_jnp):
    uint8 t, q [B, L] + int32 [B] lengths -> int32 [B, 8].  Columns >=
    lengths[b] are masked, so whatever the padding holds does not count."""
    B, L = t.shape
    cat = classify_columns(t, q, caller)
    col = torch.arange(L, device=t.device)
    valid = col[None, :] < lengths.to(t.device)[:, None]
    start = torch.ones_like(valid)
    start[:, 1:] = cat[:, 1:] != cat[:, :-1]
    start &= valid
    is_i = (cat == I) & valid
    is_d = (cat == D) & valid

    def count(m):
        return m.sum(dim=1, dtype=torch.int32)

    return torch.stack(
        [
            count((cat == EQ) & valid),
            count((cat == X) & valid),
            count(is_i),
            count(is_d),
            count(start & is_i),
            count(start & is_d),
            count((t == GAP) & (q == GAP) & valid),
            count(start),
        ],
        dim=1,
    )


def classify_stat_bytes(t, q, lengths, caller=False):
    """Kernel D on CUDA tensors, its plain version on CPU tensors.

    t, q: uint8 [B, L] (any L; rows need not be word-aligned); lengths:
    int32 [B] in columns, on the same device.  Returns int32 [B, 8]."""
    if t.device.type == "cpu":
        return classify_stat_bytes_ref(t, q, lengths, caller)
    _build.check_cuda(t, q, lengths)
    if t.dtype != torch.uint8 or q.dtype != torch.uint8:
        raise ValueError("classify_stat_bytes takes uint8 t and q")
    if lengths.dtype != torch.int32:
        raise ValueError("classify_stat_bytes takes int32 lengths")
    B, L = t.shape
    if q.shape != t.shape or lengths.shape != (B,):
        raise ValueError(
            f"shapes t {tuple(t.shape)}, q {tuple(q.shape)}, lengths "
            f"{tuple(lengths.shape)} do not match"
        )
    if L >= 2**31:
        raise ValueError("row width would wrap the int32 counters")
    out = torch.zeros((B, N_STATS), dtype=torch.int32, device=t.device)
    _build.launch("classify_bytes", t, q, lengths, out, B, L, int(caller))
    return out


def column_stats(t, q, lengths, device, caller=False):
    """uint8 [B, L] byte planes + lengths -> int32 [B, 8] counters on
    `device`.  Host numpy planes are packed into the category plane and
    reduced by classify_stat_cat; byte tensors already on the device are
    reduced in place by classify_stat_bytes, as the TPU package sends
    device-resident bytes to its byte kernel.  Rows of 2^31 columns or
    more would wrap the int32 counters and are refused (batch callers route
    such records to the int64 host engine, ops.batch.INT32_SAFE_COLUMNS).

    int32 planes, numpy or tensors, are the little-endian words of the byte
    planes (4 columns per word, lengths still in columns), as the TPU
    package's sharded stats take them, and are reduced by
    classify_stat_words."""
    words = t.dtype in (np.int32, torch.int32)
    if (4 if words else 1) * t.shape[1] >= 2**31:
        raise ValueError("row width would wrap the int32 counters")
    if words:
        tw, qw = (torch.as_tensor(a).to(device) for a in (t, q))
        lengths = torch.as_tensor(lengths, dtype=torch.int32).to(device)
        return classify_stat_words(tw, qw, lengths, caller)
    if isinstance(t, torch.Tensor):
        lengths = torch.as_tensor(lengths, dtype=torch.int32)
        return classify_stat_bytes(t.to(device), q.to(device),
                                   lengths.to(device), caller)
    pad = -t.shape[1] % 8
    if pad:  # padding columns lie beyond every length and are masked
        t = np.pad(t, ((0, 0), (0, pad)), constant_values=GAP)
        q = np.pad(q, ((0, 0), (0, pad)), constant_values=GAP)
    cw = pack_cat_nibbles(np.ascontiguousarray(t), np.ascontiguousarray(q))
    cw_d = torch.from_numpy(cw).to(device)
    len_d = torch.from_numpy(np.asarray(lengths, dtype=np.int32)).to(device)
    return classify_stat_cat(cw_d, len_d, caller)
