"""Fused column statistics + op-word scans: kernels C, F and 8.

The port of wgatools_tpu/ops/fused.py::classify_liftover_fused_adv16
(kernel C, csrc/fused_adv16.cu), classify_liftover_fused16 (kernel F,
csrc/fused16.cu) and classify_liftover_fused (kernel 8, csrc/fused_ops.cu).
One kernel reads a column plane of a batch AND the op words of the matching
op table, and returns the per-record counters of the plane plus the
exclusive scans of the op words.  The plane is one of

- byte words: int32 t, q [B, L/4] (the little-endian words of the byte
  planes), the default;
- nibble words: int32 t, q [B, L/8] from classify.pack_nibble_words
  (nibble=True);
- one category plane: int32 [B, L/8] from classify.pack_cat_nibbles, with
  qw None (catmode=True, kernel C only).

The op words, int32 [B2, NOH] (B2 may differ from B):

- kernel F: two ops per word (liftover.pack_ops_words16) -> (stats,
  t_even, t_odd, q_even, q_odd), the offset of op 2k at *_even[:, k] and of
  op 2k+1 at *_odd[:, k];
- kernel C, adv16 pair words per direction (liftover.pack_ops_adv16) ->
  (stats, t_even, t_odd, q_even, q_odd), or (stats, t_even, q_even) with
  emit_odd=False (odd = even + (w >> 14), liftover.adv16_odd_offsets);
- kernel C, raw group sums per direction (liftover.pack_ops_sums,
  raw_sums=True, which implies emit_odd=False) -> (stats, t_anchor,
  q_anchor), group-prefix anchors for liftover.expand_group_prefix;
- kernel 8 (byte words only), one op per slot [B2, NO]: uint8 ops + int32
  lens, or packed words (liftover.pack_ops_words) -> (stats, t_off, q_off),
  the full exclusive offsets of kernel B's liftover mode.

bench.py's flagship is kernel C with catmode=True, raw_sums=True.  The TPU
wrappers' scan_mode ("vpu", "mm", "once"), chunk and tile arguments chose
between formulations of the same sums on the TPU; they are accepted here
and change nothing.  Each wrapper launches its kernel on a CUDA device; its
`_ref` twin is the plain PyTorch version it is held against, and the one
the CPU takes.
"""

import torch

from ..kernels import _build
from .classify import (
    N_STATS,
    classify_stat_cat_ref,
    classify_stat_nibbles_ref,
    classify_stat_words_ref,
)
from .liftover import OP_D, OP_I, OP_S

SCAN_MODES = ("vpu", "mm", "once")

# plane kinds of the C entry points (csrc/fused.cuh)
_WORDS, _NIBBLE, _CAT = 0, 1, 2


def _plane_kind(nibble, catmode, qw):
    if catmode:
        if qw is not None:
            raise ValueError("catmode takes ONE category plane: qw must be None")
        return _CAT
    if qw is None:
        raise ValueError("qw is None: only catmode takes one plane")
    return _NIBBLE if nibble else _WORDS


def _plane_stats_ref(kind, tw, qw, lengths, caller):
    if kind == _CAT:
        return classify_stat_cat_ref(tw, lengths, caller)
    if kind == _NIBBLE:
        return classify_stat_nibbles_ref(tw, qw, lengths, caller)
    return classify_stat_words_ref(tw, qw, lengths, caller)


def _exclusive(x):
    """Exclusive int32 prefix sums along each row (wrapping as int32)."""
    return torch.cumsum(x, dim=1, dtype=torch.int32) - x


def _lsr(w, k):
    """Logical right shift of int32 words."""
    return (w >> k) & ((1 << (32 - k)) - 1)


def classify_liftover_fused16_ref(tw, qw, lengths, opw16, caller=False,
                                  nibble=False):
    """Plain PyTorch version of kernel F: (stats int32 [B, 8], t_even,
    t_odd, q_even, q_odd int32 [B2, NOH])."""
    stats = _plane_stats_ref(_NIBBLE if nibble else _WORDS, tw, qw, lengths,
                             caller)
    zero = torch.zeros((), dtype=torch.int32, device=opw16.device)

    def advances(cls, ln):
        # ADV_BOTH=1, ADV_I=2, ADV_S=3, ADV_D=4 (liftover._ADV_CLASS)
        at = torch.where((cls == 1) | (cls == 4), ln, zero)
        aq = torch.where((cls == 1) | (cls == 2) | (cls == 3), ln, zero)
        return at, aq

    at0, aq0 = advances(_lsr(opw16, 13) & 7, opw16 & 0x1FFF)
    at1, aq1 = advances(_lsr(opw16, 29), _lsr(opw16, 16) & 0x1FFF)
    p_t, p_q = _exclusive(at0 + at1), _exclusive(aq0 + aq1)
    return stats, p_t, p_t + at0, p_q, p_q + aq0


def classify_liftover_fused_adv16_ref(tw, qw, lengths, wt, wq, caller=False,
                                      nibble=False, catmode=False,
                                      emit_odd=True, raw_sums=False):
    """Plain PyTorch version of kernel C: 3 or 5 outputs, as the module
    docstring lists them."""
    stats = _plane_stats_ref(_plane_kind(nibble, catmode, qw), tw, qw,
                             lengths, caller)
    if raw_sums:
        return stats, _exclusive(wt), _exclusive(wq)
    t_even, q_even = _exclusive(wt & 0x3FFF), _exclusive(wq & 0x3FFF)
    if not emit_odd:
        return stats, t_even, q_even
    return stats, t_even, t_even + _lsr(wt, 14), q_even, q_even + _lsr(wq, 14)


def _check_fused(name, kind, tw, qw, lengths, op_planes, scan_mode):
    """Device, dtype and shape checks of a fused launch; returns
    (B, LW, B2, NOH)."""
    if scan_mode not in SCAN_MODES:
        raise ValueError(f"scan_mode {scan_mode!r} is not one of {SCAN_MODES}")
    planes = (tw,) if kind == _CAT else (tw, qw)
    _build.check_cuda(*planes, lengths, *op_planes)
    if any(a.dtype != torch.int32 for a in (*planes, lengths, *op_planes)):
        raise ValueError(f"{name} takes int32 inputs")
    B, LW = tw.shape
    B2, NOH = op_planes[0].shape
    if (
        any(p.shape != (B, LW) for p in planes)
        or lengths.shape != (B,)
        or any(o.shape != (B2, NOH) for o in op_planes)
    ):
        raise ValueError(
            f"{name}: shapes of planes {[tuple(p.shape) for p in planes]}, "
            f"lengths {tuple(lengths.shape)} and op words "
            f"{[tuple(o.shape) for o in op_planes]} do not agree"
        )
    if (4 if kind == _WORDS else 8) * LW >= 2**31:
        raise ValueError("row width would wrap the int32 counters")
    return B, LW, B2, NOH


def _to_device(device, *arrays):
    return [None if a is None else torch.as_tensor(a, device=device)
            for a in arrays]


def classify_liftover_fused16(tw, qw, lengths, opw16, device, caller=False,
                              nibble=False, scan_mode="vpu", tile_b=None,
                              tile_lw=None, tile_loh=None):
    """Counters of a byte-word (or, with nibble=True, nibble) plane + the
    even/odd offsets of its 16-bit packed op words, in one pass.

    tw, qw: int32 [B, LW]; lengths: int32 [B] in columns; opw16: int32
    [B2, NOH] (liftover.pack_ops_words16).  Arrays may be numpy or tensors;
    they are moved to `device`.  Returns (stats [B, 8], t_even, t_odd,
    q_even, q_odd [B2, NOH]), int32 on `device`: kernel F on a CUDA device,
    the plain version on the CPU.  scan_mode and the tile sizes are
    accepted for the TPU signature and change nothing."""
    tw, qw, lengths, opw16 = _to_device(device, tw, qw, lengths, opw16)
    if device.type == "cpu":
        return classify_liftover_fused16_ref(tw, qw, lengths, opw16, caller,
                                             nibble)
    kind = _NIBBLE if nibble else _WORDS
    B, LW, B2, NOH = _check_fused("classify_liftover_fused16", kind, tw, qw,
                                  lengths, (opw16,), scan_mode)
    stats = torch.zeros((B, N_STATS), dtype=torch.int32, device=device)
    offs = [torch.empty((B2, NOH), dtype=torch.int32, device=device)
            for _ in range(4)]
    _build.launch("fused16", kind, tw, qw, lengths, opw16, stats, *offs,
                  B, LW, B2, NOH, int(caller))
    return (stats, *offs)


def classify_liftover_fused_adv16(tw, qw, lengths, wt, wq, device,
                                  caller=False, nibble=False, catmode=False,
                                  scan_mode="vpu", chunk=None, emit_odd=True,
                                  raw_sums=False, tile_b=None, tile_lw=None,
                                  tile_loh=None):
    """Counters of a plane + the scans of its advance-packed op words, in
    one pass.

    tw, qw: int32 [B, LW] byte-word planes, nibble planes (nibble=True) or
    one category plane with qw None (catmode=True); lengths: int32 [B] in
    columns; wt, wq: int32 [B2, NOH] adv16 pair words
    (liftover.pack_ops_adv16) or, with raw_sums=True, group sums
    (liftover.pack_ops_sums).  Arrays may be numpy or tensors; they are
    moved to `device`.  Returns the 3 or 5 int32 outputs the module
    docstring lists, on `device`: kernel C on a CUDA device, the plain
    version on the CPU.  scan_mode, chunk and the tile sizes are accepted
    for the TPU signature and change nothing."""
    if raw_sums:
        emit_odd = False
    kind = _plane_kind(nibble, catmode, qw)
    tw, qw, lengths, wt, wq = _to_device(device, tw, qw, lengths, wt, wq)
    if device.type == "cpu":
        return classify_liftover_fused_adv16_ref(
            tw, qw, lengths, wt, wq, caller, nibble, catmode, emit_odd,
            raw_sums,
        )
    B, LW, B2, NOH = _check_fused("classify_liftover_fused_adv16", kind, tw,
                                  qw, lengths, (wt, wq), scan_mode)
    stats = torch.zeros((B, N_STATS), dtype=torch.int32, device=device)
    offs = [torch.empty((B2, NOH), dtype=torch.int32, device=device)
            for _ in range(4 if emit_odd else 2)]
    te, to, qe, qo = offs if emit_odd else (offs[0], None, offs[1], None)
    _build.launch("fused_adv16", kind, tw, qw, lengths, wt, wq, stats,
                  te, to, qe, qo, B, LW, B2, NOH, int(caller), int(raw_sums),
                  int(emit_odd))
    return (stats, *offs)


def _decode_ops(ops, lens):
    """int64 (op byte, length) of each op slot: uint8 ops + int32 lens, or,
    with lens None, packed int32 words (op = w >> 24 logically, len =
    w & 0xFFFF, bits 16-23 ignored)."""
    if lens is None:
        w = ops.to(torch.int64) & 0xFFFFFFFF
        return w >> 24, w & 0xFFFF
    return ops.to(torch.int64), lens.to(torch.int64)


def _wrap_int32(x):
    """int64 -> int32 modulo 2^32, as int32 adds wrap."""
    return ((x + 2**31) % 2**32 - 2**31).to(torch.int32)


def classify_liftover_fused_ref(tw, qw, lengths, ops, lens, caller=False):
    """Plain PyTorch version of kernel 8: (stats int32 [B, 8], t_off, q_off
    int32 [B2, NO]), the byte-word stats and the exclusive liftover-mode
    offsets.  The target advances on every op byte but 0, I and S, the
    query on every op byte but 0 and D; the sums are taken in int64 and
    wrapped to int32, as the kernel's uint32 adds wrap."""
    stats = classify_stat_words_ref(tw, qw, lengths, caller)
    op, ln = _decode_ops(ops, lens)
    zero = torch.zeros((), dtype=torch.int64, device=ln.device)
    adv_t = torch.where((op == 0) | (op == OP_I) | (op == OP_S), zero, ln)
    adv_q = torch.where((op == 0) | (op == OP_D), zero, ln)
    t_off = _wrap_int32(torch.cumsum(adv_t, dim=1) - adv_t)
    q_off = _wrap_int32(torch.cumsum(adv_q, dim=1) - adv_q)
    return stats, t_off, q_off


def classify_liftover_fused(tw, qw, lengths, ops, lens, device, caller=False,
                            tile_b=None, tile_lw=None, tile_lo=None,
                            interpret=False, scan_chunk=None,
                            scan_mode="vpu"):
    """Byte-word counters + the full liftover offsets of an op table, in
    one pass.

    tw, qw: int32 [B, LW] byte-word planes; lengths: int32 [B] in columns;
    ops: uint8 [B2, NO] (0 = padding) with lens int32 [B2, NO], or, with
    lens None, packed int32 words [B2, NO] (liftover.pack_ops_words).
    Arrays may be numpy or tensors; they are moved to `device`.  Returns
    (stats [B, 8], t_off, q_off [B2, NO]), int32 on `device`: kernel 8 on
    a CUDA device, the plain version on the CPU.  Any op length is exact
    (no len < 2^16 bound).  The tile sizes, interpret, scan_chunk and
    scan_mode are accepted for the TPU signature and change nothing."""
    tw, qw, lengths, ops, lens = _to_device(device, tw, qw, lengths, ops, lens)
    if device.type == "cpu":
        return classify_liftover_fused_ref(tw, qw, lengths, ops, lens, caller)
    B, LW, B2, NO = _check_fused("classify_liftover_fused", _WORDS, tw, qw,
                                 lengths, (ops if lens is None else lens,),
                                 scan_mode)
    if lens is not None:
        _build.check_cuda(ops, lens)
        if ops.dtype != torch.uint8 or ops.shape != lens.shape:
            raise ValueError(
                "classify_liftover_fused takes uint8 ops of the lens' shape "
                f"(got {ops.dtype} {tuple(ops.shape)})"
            )
    stats = torch.zeros((B, N_STATS), dtype=torch.int32, device=device)
    t_off, q_off = (torch.empty((B2, NO), dtype=torch.int32, device=device)
                    for _ in range(2))
    _build.launch("fused_ops", tw, qw, lengths, ops, lens, stats, t_off,
                  q_off, B, LW, B2, NO, int(caller))
    return stats, t_off, q_off
