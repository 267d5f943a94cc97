"""stat's category plane packed straight from where each block's rows lie,
as bytes objects or at offsets in one buffer (native.pack_cat_rows over
io.maf.BytesRows / MappedRows, ops.batch.stream_seq_pair_stats): the same nibbles
as the padded byte planes' route on every valid column, nothing written
past a row's last byte, nothing past a length read by kernel A's plain
version, and the same RecStats with and without the native library.
The last test runs only on the CUDA card: the pinned slot's hand-out and
send against `PinnedSlots.upload`.
"""

from dataclasses import astuple

import numpy as np
import pytest
import torch

from wgatools_tpu_torch import native
from wgatools_tpu_torch.core.cigar import (
    cigar_from_seqs,
    rec_stat_from_cigar,
    seq_bytes,
)
from wgatools_tpu_torch.core.metrics import METRICS
from wgatools_tpu_torch.io.maf import BytesRows, MappedRows
from wgatools_tpu_torch.ops import batch, pipeline
from wgatools_tpu_torch.ops.classify import (
    _CAT_LUT64K,
    classify_stat_cat,
    classify_stat_cat_ref,
    pack_cat_nibbles,
    pack_pairs,
)

CPU = torch.device("cpu")
GARBAGE = 0xA5  # neither nibble is a category code


def _random_pairs(rng):
    """Blocks of odd, even, 0 and 1 columns over bases, gaps, N and lower
    case, with t and q of the same length."""
    alphabet = np.frombuffer(b"ACGTN-acgtn", np.uint8)
    pairs = []
    for n in [0, 1, 2, 3, 7, 127, 128, 129, 255, 1000, 1001, 4097]:
        t = alphabet[rng.integers(0, len(alphabet), n)].tobytes()
        q = alphabet[rng.integers(0, len(alphabet), n)].tobytes()
        pairs.append((t, q))
    return pairs


def _ragged_pairs(rng):
    """t and q of different lengths: each row truncates to the shorter."""
    alphabet = np.frombuffer(b"ACGT-", np.uint8)
    pairs = []
    for nt, nq in [(0, 5), (5, 0), (1, 2), (9, 4), (130, 131), (300, 257)]:
        t = alphabet[rng.integers(0, 5, nt)].tobytes()
        q = alphabet[rng.integers(0, 5, nq)].tobytes()
        pairs.append((t, q))
    return pairs


def _all_byte_pairs(rng):
    """Every (t, q) byte pair of 256 x 256, in rows of 511 columns (odd),
    so that some pairs land in a row's odd last column."""
    t = np.repeat(np.arange(256, dtype=np.uint8), 256)
    q = np.tile(np.arange(256, dtype=np.uint8), 256)
    order = rng.permutation(t.size)
    t, q = t[order], q[order]
    return [(t[i : i + 511].tobytes(), q[i : i + 511].tobytes())
            for i in range(0, t.size, 511)]


CASES = {"random": _random_pairs, "ragged": _ragged_pairs,
         "all_byte_pairs": _all_byte_pairs}


def _pack_bytes(pairs, lens, row_bytes, dst):
    """native.pack_cat_rows on the rows of `pairs` as bytes objects."""
    return native.pack_cat_rows(BytesRows.addresses([p[0] for p in pairs], lens),
                                BytesRows.addresses([p[1] for p in pairs], lens),
                                lens, row_bytes, _CAT_LUT64K, dst)


def _planes(pairs):
    """(today's padded category plane as uint8 [B, L/2], the rows packed
    straight into a GARBAGE-filled buffer of that shape, lengths)."""
    t, q, lens = pack_pairs(pairs)
    want = pack_cat_nibbles(t, q).view(np.uint8)
    got = np.full(want.shape, GARBAGE, np.uint8)
    assert _pack_bytes(pairs, lens, want.shape[1], got)
    return want, got, lens


@pytest.mark.parametrize("case", sorted(CASES))
def test_rows_equal_the_padded_plane_on_valid_columns(case):
    want, got, lens = _planes(CASES[case](np.random.default_rng(7)))
    for k, n in enumerate(lens.tolist()):
        full = n // 2
        assert np.array_equal(got[k, :full], want[k, :full]), k
        if n % 2:
            assert got[k, full] & 0xF == want[k, full] & 0xF, k
        # nothing past the row's last byte is written
        assert (got[k, (n + 1) // 2 :] == GARBAGE).all(), k


@pytest.mark.parametrize("caller", [False, True], ids=["ext", "caller"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_kernel_reads_nothing_past_a_length(case, caller):
    """Kernel A's plain version gives the same counters on a plane packed
    over random garbage as on the gap/gap-padded plane."""
    rng = np.random.default_rng(11)
    pairs = CASES[case](rng)
    t, q, lens = pack_pairs(pairs)
    want = classify_stat_cat_ref(
        torch.from_numpy(pack_cat_nibbles(t, q)), torch.from_numpy(lens),
        caller)
    got = rng.integers(0, 256, (t.shape[0], t.shape[1] // 2), dtype=np.uint8)
    assert _pack_bytes(pairs, lens, got.shape[1], got)
    rows = classify_stat_cat_ref(
        torch.from_numpy(got.view("<i4")), torch.from_numpy(lens), caller)
    assert torch.equal(rows, want)


def _stream_items(seed, n_items=23, long_at=()):
    """Blocks of 0-3500 columns; those at the indices in long_at have
    exactly 3000 columns."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGTN-acgtn", np.uint8)
    items = []
    for k in range(n_items):
        n = 3000 if k in long_at else int(rng.integers(0, 3500))
        t = alphabet[rng.integers(0, len(alphabet), n)].tobytes()
        q = alphabet[rng.integers(0, len(alphabet),
                                  n + int(rng.integers(-2, 3)) if n > 2 else n)
                     ].tobytes()
        items.append((t, q, bool(rng.random() < 0.5), ("rec", k)))
    return items


def _host_stats(items):
    return [rec_stat_from_cigar(cigar_from_seqs(seq_bytes(t), seq_bytes(q), neg))
            for t, q, neg, _ in items]


def _native_spy(monkeypatch):
    """The columns each native.pack_cat_rows call was given room for
    (rows x 2 row_bytes), in call order."""
    seen = []
    real = native.pack_cat_rows

    def spy(t_addr, q_addr, lens, row_bytes, lut, dst):
        seen.append(len(lens) * 2 * row_bytes)
        return real(t_addr, q_addr, lens, row_bytes, lut, dst)

    monkeypatch.setattr(native, "pack_cat_rows", spy)
    return seen


@pytest.mark.parametrize("int32_safe", [None, 3000],
                         ids=["device_only", "int32_route"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stream_native_equals_fallback(seed, int32_safe, monkeypatch):
    """stream_seq_pair_stats on the CPU device: the same RecStats in input
    order with the native packer as without the library (pack_pairs and
    pack_cat_nibbles), with blocks past a lowered INT32_SAFE_COLUMNS
    routed to the int64 host engine mid-stream; the native packer packs
    every slot on the native route and none on the fallback."""
    items = _stream_items(seed, long_at=(5, 6, 15))
    if int32_safe is not None:
        monkeypatch.setattr(batch, "INT32_SAFE_COLUMNS", int32_safe)
    packed = _native_spy(monkeypatch)

    def run():
        monkeypatch.setattr(METRICS, "counts", {})
        got = list(batch.stream_seq_pair_stats(iter(items), CPU, 6000))
        return got, dict(METRICS.counts), packed.copy()

    direct, direct_counts, direct_packed = run()
    packed.clear()
    with monkeypatch.context() as m:
        m.setattr(native, "load", lambda: None)
        assert not native.available()
        fallback, fallback_counts, fallback_packed = run()
    assert [(m, astuple(rs)) for m, rs in direct] == [
        (m, astuple(rs)) for m, rs in fallback]
    assert [m for m, _ in direct] == [it[3] for it in items]
    assert [rs for _, rs in direct] == _host_stats(items)
    assert sum(direct_packed) == direct_counts["slots"] > 0
    assert fallback_packed == []
    for key in ("slots", "padded_slots"):
        assert direct_counts[key] == fallback_counts[key]


def _one_buffer(rng, pairs):
    """Every row of `pairs` in one uint8 buffer, t and q in turn, each at
    an offset of 0-7 bytes past the previous row's end (odd ones
    included); returns (buffer, t offsets, q offsets)."""
    parts, t_off, q_off, pos = [], [], [], 0
    for t, q in pairs:
        for row, offs in ((t, t_off), (q, q_off)):
            gap = int(rng.integers(0, 8))
            parts.append(bytes(rng.integers(0, 256, gap, dtype=np.uint8)))
            offs.append(pos + gap)
            parts.append(row)
            pos += gap + len(row)
    buf = np.frombuffer(b"".join(parts), np.uint8)
    return buf, np.array(t_off, np.int64), np.array(q_off, np.int64)


@pytest.mark.parametrize("extra", [0, 1, 64], ids=["row_bytes", "plus_1",
                                                   "plus_64"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_rows_at_offsets_equal_bytes_rows(case, extra):
    """native.pack_cat_rows on rows at unaligned addresses of one buffer
    writes the padded plane's nibbles on every valid column, with odd, 0
    and 1 lengths, row_bytes at or past a row's length, and nothing past a
    row's last byte."""
    rng = np.random.default_rng(13)
    pairs = CASES[case](rng)
    buf, t_off, q_off = _one_buffer(rng, pairs)
    t, q, lens = pack_pairs(pairs)
    plane = pack_cat_nibbles(t, q).view(np.uint8)
    row_bytes = (int(lens.max()) + 1) // 2 + extra
    got = np.full((len(pairs), row_bytes), GARBAGE, np.uint8)
    rows = MappedRows(buf)
    t_addr = rows.addresses([range(o, o + len(p[0])) for o, p in
                             zip(t_off.tolist(), pairs)], lens)
    q_addr = rows.addresses([range(o, o + len(p[1])) for o, p in
                             zip(q_off.tolist(), pairs)], lens)
    assert native.pack_cat_rows(t_addr, q_addr, lens, row_bytes,
                                _CAT_LUT64K, got)
    for k, n in enumerate(lens.tolist()):
        full = n // 2
        assert np.array_equal(got[k, :full], plane[k, :full]), k
        if n % 2:
            assert got[k, full] & 0xF == plane[k, full] & 0xF, k
        assert (got[k, (n + 1) // 2 :] == GARBAGE).all(), k


@pytest.mark.parametrize("start, length", [(-1, 4), (0, 17), (13, 4)],
                         ids=["before", "past_by_one", "past_the_end"])
def test_mapped_rows_refuse_rows_outside_the_buffer(start, length):
    """MappedRows hands the packer no address of a row that begins before
    its buffer or whose lens[k] bytes run past the buffer's end."""
    rows = MappedRows(np.zeros(16, np.uint8))
    lens = np.array([4, length], np.int32)
    # a row that ends at the buffer's end is inside
    assert rows.addresses([range(12, 16)], lens[:1]).size == 1
    with pytest.raises(AssertionError):
        rows.addresses([range(0, 4), range(start, start + length)], lens)


@pytest.mark.parametrize("library", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("int32_safe", [None, 3000],
                         ids=["device_only", "int32_route"])
def test_stream_rows_at_offsets_equal_bytes(library, int32_safe, monkeypatch):
    """stream_seq_pair_stats with its rows given as ranges of offsets in
    one buffer (MappedRows) gives the RecStats of the same rows as bytes:
    packed in place with the library, viewed for pack_pairs without it and
    for the int64 host engine past a lowered INT32_SAFE_COLUMNS."""
    items = _stream_items(4, long_at=(5, 6, 15))
    buf, t_off, q_off = _one_buffer(np.random.default_rng(17),
                                    [(t, q) for t, q, _, _ in items])
    ranged = [(range(to, to + len(t)), range(qo, qo + len(q)), neg, meta)
              for (t, q, neg, meta), to, qo in zip(items, t_off.tolist(),
                                                   q_off.tolist())]
    if int32_safe is not None:
        monkeypatch.setattr(batch, "INT32_SAFE_COLUMNS", int32_safe)
    packed = _native_spy(monkeypatch)
    if not library:
        monkeypatch.setattr(native, "load", lambda: None)
    monkeypatch.setattr(METRICS, "counts", {})
    got = list(batch.stream_seq_pair_stats(iter(ranged), CPU, 6000,
                                           MappedRows(buf)))
    assert [m for m, _ in got] == [it[3] for it in items]
    assert [rs for _, rs in got] == _host_stats(items)
    assert sum(packed) == (METRICS.counts["slots"] if library else 0)


def test_slot_send_on_the_card_equals_upload(monkeypatch):
    """On the card: four back-to-back batches packed straight into the
    pinned slots (filled with garbage first) and sent give kernel A the
    same counters as upload() of the padded plane, so a slot is refilled
    only after its previous upload has left; stream_seq_pair_stats' native
    route equals its fallback, and the native packer packs its slots."""
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    batches = [_random_pairs(rng), _ragged_pairs(rng), _random_pairs(rng),
               _all_byte_pairs(rng)]
    up_direct = pipeline.PinnedSlots(dev)
    up_staged = pipeline.PinnedSlots(dev)
    got, want = [], []
    for pairs in batches:
        t, q, lens = pack_pairs(pairs)
        B, L = t.shape
        off = pipeline.aligned(B * L // 2)
        n = off + lens.nbytes
        host = up_direct.slot(n)
        host[:] = rng.integers(0, 256, n, dtype=np.uint8)
        assert _pack_bytes(pairs, lens, L // 2, host)
        host[off:] = lens.view(np.uint8)
        raw = up_direct.send(n)
        got.append(classify_stat_cat(
            raw[: B * L // 2].view(torch.int32).view(B, L // 8),
            raw[off:].view(torch.int32)))
        want.append(classify_stat_cat(*up_staged.upload(
            pack_cat_nibbles(t, q), lens)))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())

    items = _stream_items(3, n_items=40)
    monkeypatch.setattr(METRICS, "counts", {})
    packed = _native_spy(monkeypatch)
    direct = list(batch.stream_seq_pair_stats(iter(items), dev, 6000))
    counts = dict(METRICS.counts)
    with monkeypatch.context() as m:
        m.setattr(native, "load", lambda: None)
        fallback = list(batch.stream_seq_pair_stats(iter(items), dev, 6000))
    assert direct == fallback
    assert [rs for _, rs in direct] == _host_stats(items)
    assert sum(packed) == counts["slots"] > 0
