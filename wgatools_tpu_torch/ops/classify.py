"""Column classify + per-record statistics.

The port of the main-path pieces of wgatools_tpu/ops/classify.py.  Each
aligned column pair (t, q) is one category, reduced on the device to int32
[B, 8] per-record counters

    matched, mismatched, ins_size, del_size, ins_events, del_events,
    gap/gap, runs

in ext mode (gap/gap columns are '=' and merge into '=' runs,
cigar_cat_ext) or caller mode (gap/gap is its own W category,
cigar_cat_ext_caller).  Two inputs:

- the category plane: the host packs each pair into ONE 4-bit one-hot code
  through a 64K LUT (X=0, EQ=1, I=2, D=4, GG=9), eight columns per int32
  word; `classify_stat_cat` launches kernel A (csrc/classify_cat.cu);
- the byte planes: uint8 t, q [B, L] already on the device;
  `classify_stat_bytes` launches kernel D (csrc/classify_bytes.cu).

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


def _unpack_cats(cw):
    """int32 [B, LW] category plane -> uint8 [B, 8*LW] per-column codes."""
    B, LW = cw.shape
    b = cw.contiguous().view(torch.uint8).reshape(B, LW * 4)
    return torch.stack((b & 0xF, b >> 4), dim=2).reshape(B, LW * 8)


def classify_stat_cat_ref(cw, lengths, caller=False):
    """Plain PyTorch version of kernel A: int32 [B, LW] plane + int32 [B]
    lengths (columns) -> int32 [B, 8].  Columns >= lengths[b] are masked,
    so whatever the padding holds does not count."""
    codes = _unpack_cats(cw)
    B, L = codes.shape
    col = torch.arange(L, device=cw.device)
    valid = col[None, :] < lengths.to(cw.device)[:, None]
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
    _build.check_cuda(cw, lengths)
    if cw.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("classify_stat_cat takes int32 cw and lengths")
    B, LW = cw.shape
    if lengths.shape != (B,):
        raise ValueError(f"lengths shape {tuple(lengths.shape)} != ({B},)")
    if 8 * LW >= 2**31:
        raise ValueError("row width would wrap the int32 counters")
    out = torch.zeros((B, N_STATS), dtype=torch.int32, device=cw.device)
    _build.launch("classify_cat", cw, lengths, out, B, LW, int(caller))
    return out


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
    such records to the int64 host engine, ops.batch.INT32_SAFE_COLUMNS)."""
    if t.shape[1] >= 2**31:
        raise ValueError("row width would wrap the int32 counters")
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
