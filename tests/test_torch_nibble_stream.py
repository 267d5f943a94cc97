"""The counting algebra of the nibble-plane loop (csrc/cat_stream.cuh,
kernels E, F and C on nibble words), emulated in numpy on the CPU.

The loop never builds the category word of a column: per word pair it
takes three zero-nibble flags (equal, t gap, q gap), merges the four word
pairs of a uint4 into one word per flag (word j shifted right by 3 - j, so
bit 4 i + j is column 8 j + i), finds run starts on the merged run key with
the key of the column before carried from the lane before, lane 31 of the
batch before, or memory at a segment's first uint4, and counts 32 columns
a __popc.  Ragged words take cat_nibbles + count_word.

This is a design check of that algebra, not coverage of the kernel: the
emulation is a numpy copy of the loop's steps, with the segment cuts, the
row's 16-byte head and the t/q base mismatch as parameters, and no code of
csrc/ runs here (chip_smoke.py holds the kernel itself against the plain
version on the card).  The emulation is held exactly against
classify_stat_nibbles_ref on arbitrary int32 words (codes 12-15 included)
and ragged lengths (negative, past the row), and both against the JAX
package's Pallas nibble kernel (interpret mode) on the same words.  No card
needed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgatools_tpu.ops import classify as JC
from wgatools_tpu_torch.ops.classify import classify_stat_nibbles_ref

M1, M7, HI = np.uint32(0x11111111), np.uint32(0x77777777), np.uint32(0x88888888)
LANES = 32


def u32(x):
    return np.asarray(x, dtype=np.uint32)


def popc(x):
    return int(np.bitwise_count(u32(x)).sum())


def zero_nibbles(x):
    """Bit 3 of each nibble of x that is 0."""
    x = u32(x)
    return ~(((x & M7) + M7) | x) & HI


def run_key(e, tg, qg, caller):
    return (e, tg, qg) if caller else (e, tg ^ qg, qg & ~tg)


def merged_flags(t4, q4):
    """(equal, t gap, q gap) of uint4 pairs [..., 4]: bit 4 i + j of each
    word is column 8 j + i."""
    out = [u32(np.zeros(t4.shape[:-1])) for _ in range(3)]
    for j in range(4):
        t, q = t4[..., j], q4[..., j]
        for k, f in enumerate((zero_nibbles(t ^ q), zero_nibbles(t), zero_nibbles(q))):
            out[k] |= f >> u32(3 - j)
    return out


def merged_starts(k, c):
    """Bits whose column's key differs from the column before's; c: the
    key bit of the column before column 0, in bit 0."""
    return k ^ ((k << u32(4)) | ((k >> u32(27)) & u32(0xE)) | c)


def cat_nibbles(t, q):
    """The LUT's one-hot category code of each of 8 nibble columns."""
    def zero(x):
        return ~((((x & M7) + M7) | x) >> u32(3)) & M1

    t, q = u32(t), u32(q)
    e, tg, qg = zero(t ^ q), zero(t), zero(q)
    gg = tg & qg
    return e | ((tg ^ gg) << u32(1)) | ((qg ^ gg) << u32(2)) | (gg << u32(3))


def count_word(w, prev_top, row_start, valid, caller, c):
    """count_word of csrc/cat_stats.cuh: 8 category nibbles, the category
    of the column before, the first `valid` columns counted."""
    w, prev_top = u32(w), u32(prev_top)
    diff = w ^ ((w << u32(4)) | prev_top)
    if caller:
        nz = (((diff & M7) + M7) | diff) & HI
    else:
        nz = ((diff & M7) + M7) & HI
    rs = nz >> u32(3)
    if row_start:
        rs |= u32(1)
    vm = M1 if valid >= 8 else M1 & u32((1 << (4 * valid)) - 1)
    rs &= vm
    bits = [(w >> u32(b)) & vm for b in range(4)]
    for k, v in enumerate(bits + [rs, rs & bits[1], rs & bits[2]]):
        c[k] += popc(v)


def scalar_words(t, q, lo, hi, n, caller, c):
    """Words [lo, hi) of a row, one a lane: the word before from memory."""
    for g in range(lo, hi):
        prev = (cat_nibbles(t[g - 1] >> u32(28), q[g - 1] >> u32(28)) & u32(0xF)
                if g else u32(0))
        count_word(cat_nibbles(t[g], q[g]), prev, g == 0, n - 8 * g, caller, c)


def vector_segment(t, q, g0, nv, caller, c):
    """nv whole uint4 of each plane from word g0, as one warp segment:
    uint4 i at lane i % 32 of batch i // 32."""
    t4 = t[g0:g0 + 4 * nv].reshape(nv, 4)
    q4 = q[g0:g0 + 4 * nv].reshape(nv, 4)
    m = merged_flags(t4, q4)
    key = run_key(*m, caller)
    last = [k >> u32(31) for k in key]
    # lane 0 of batch 0: the key of the column before, from memory
    if g0:
        tb, qb = t[g0 - 1], q[g0 - 1]
        carry = [k >> u32(31) for k in run_key(
            zero_nibbles(tb ^ qb), zero_nibbles(tb), zero_nibbles(qb), caller)]
    else:
        carry = [u32(0)] * 3
    batches = -(-nv // LANES)
    pad = batches * LANES - nv
    lanes = [np.concatenate([x, u32(np.zeros(pad))]).reshape(batches, LANES) for x in last]
    prev = []
    for x, cm in zip(lanes, carry):
        up = np.empty_like(x)
        up[:, 1:] = x[:, :-1]      # __shfl_up_sync(last, 1)
        up[1:, 0] = x[:-1, -1]     # lane 0: lane 31 of the batch before
        up[0, 0] = cm              # lane 0 of batch 0: from memory
        prev.append(up.reshape(-1)[:nv])
    rs = merged_starts(key[0], prev[0])
    rs |= merged_starts(key[1], prev[1])
    rs |= merged_starts(key[2], prev[2])
    if g0 == 0:
        rs[0] |= u32(1)  # column 0 of the row always starts a run
    e, tg, qg = m
    ng = popc(tg & qg)
    c[0] += popc(e)
    c[1] += popc(tg) - ng
    c[2] += popc(qg) - ng
    c[3] += ng
    c[4] += popc(rs)
    c[5] += popc(rs & tg & ~qg)
    c[6] += popc(rs & qg & ~tg)


def stream_row(t, q, n, caller, head, seg_uint4s, vec):
    """One row's counters as the loop counts them.  head: words before the
    row's first 16-byte boundary (0-3); seg_uint4s: the lengths, in uint4,
    of the row's successive warp segments; vec False: the t and q bases
    differ mod 16, every word one lane each."""
    c = [0] * 7
    ng, nfull = (n + 7) // 8, n // 8
    if not vec:
        scalar_words(t, q, 0, ng, n, caller, c)
        return c
    h = min(head, ng)
    scalar_words(t, q, 0, h, n, caller, c)
    nv_row = max(0, nfull - h) // 4
    g, left = h, nv_row
    for s in seg_uint4s:
        if left == 0:
            break
        s = min(s, left)
        vector_segment(t, q, g, s, caller, c)
        g += 4 * s
        left -= s
    if left:
        vector_segment(t, q, g, left, caller, c)
        g += 4 * left
    scalar_words(t, q, g, ng, n, caller, c)
    return c


def stream_stats(tw, qw, lengths, caller, head, seg_uint4s, vec=True):
    """int32 [B, 8] counters of the emulated loop (atomic_add_stats)."""
    B, LW = tw.shape
    out = np.zeros((B, 8), np.int64)
    for b in range(B):
        n = int(np.clip(lengths[b], 0, 8 * LW))
        t, q = tw[b].view(np.uint32), qw[b].view(np.uint32)
        s = stream_row(t, q, n, caller, head, seg_uint4s, vec)
        out[b] = [s[0] - s[3] if caller else s[0], n - s[0] - s[1] - s[2],
                  s[1], s[2], s[5], s[6], s[3], s[4]]
    return out


def _planes(seed, B, LW, dictionary):
    rng = np.random.default_rng(seed)
    if dictionary:
        # dictionary codes (0 = gap), many gaps, equal and gap/gap columns
        codes = rng.integers(0, 12, (2, B, 8 * LW)).astype(np.uint8)
        codes[rng.random((2, B, 8 * LW)) < 0.25] = 0
        same = rng.random((B, 8 * LW)) < 0.5
        codes[1][same] = codes[0][same]
        packed = codes[:, :, 0::2] | (codes[:, :, 1::2] << 4)
        tw, qw = (np.ascontiguousarray(p).view("<i4") for p in packed)
    else:
        # arbitrary words: codes 12-15 included
        tw, qw = (rng.integers(0, 1 << 32, (B, LW), dtype=np.uint64)
                  .astype(np.uint32).view(np.int32) for _ in range(2))
        tw[0, :LW // 2] = qw[0, :LW // 2]  # long equal and gap/gap runs
    lengths = rng.integers(-8, 8 * LW + 16, B).astype(np.int32)
    lengths[0] = 8 * LW
    lengths[1] = 8 * LW - 3
    return tw, qw, lengths


def _want(tw, qw, lengths, caller):
    return classify_stat_nibbles_ref(torch.from_numpy(tw), torch.from_numpy(qw),
                                     torch.from_numpy(lengths), caller).numpy()


def _pallas(tw, qw, lengths, caller):
    """The JAX package's nibble kernel in interpret mode.  Its padding
    contract wants lengths in [0, 8 LW] and gap/gap (nibble 0) in both planes
    past them, so the columns past each length are zeroed first."""
    B, LW = tw.shape
    n = np.clip(lengths, 0, 8 * LW).astype(np.int32)
    shifts = 4 * np.arange(8, dtype=np.uint32)
    keep = (np.arange(8 * LW)[None, :] < n[:, None]).reshape(B, LW, 8)

    def masked(w):
        nib = (w.view(np.uint32)[..., None] >> shifts) & np.uint32(0xF)
        return np.bitwise_or.reduce(np.where(keep, nib, 0) << shifts,
                                    axis=-1).astype(np.uint32).view(np.int32)

    out = JC.classify_stat_pallas_nibbles(
        jnp.asarray(masked(tw)), jnp.asarray(masked(qw)), jnp.asarray(n),
        tile_lw=128, interpret=True, caller=caller)
    return np.asarray(out)[:B]


# (seed, B, LW, dictionary codes): LW % 4 in {0, 1, 2, 3}, rows of one
# uint4 or none, rows past a 64-uint4 segment
SHAPES = [(0, 5, 1, False), (1, 4, 3, True), (2, 6, 4, False), (3, 3, 9, True),
          (4, 7, 37, False), (5, 4, 130, True), (6, 3, 263, False)]
# segment cuts in uint4: the kernel's 64 (32 lanes x NS_VEC), single uint4s,
# and cuts at arbitrary lanes
CUTS = {"kernel": [64] * 64, "ones": [1] * 512, "ragged": [7, 33, 1, 31, 64, 5, 40] * 16}


@pytest.mark.parametrize("caller", [False, True])
@pytest.mark.parametrize("head", [0, 1, 2, 3])
@pytest.mark.parametrize("shape", range(len(SHAPES)))
def test_loop_counts_equal_the_plain_version(shape, head, caller):
    seed, B, LW, dictionary = SHAPES[shape]
    tw, qw, lengths = _planes(seed, B, LW, dictionary)
    want = _want(tw, qw, lengths, caller)
    for cuts in CUTS.values():
        got = stream_stats(tw, qw, lengths, caller, head, cuts)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("caller", [False, True])
@pytest.mark.parametrize("shape", range(len(SHAPES)))
def test_loop_and_plain_version_equal_the_pallas_kernel(shape, caller):
    """The emulated loop and the plain version against the JAX package's
    kernel on the same words: codes 12-15 are held to the reference's
    semantics, not only to the port's."""
    seed, B, LW, dictionary = SHAPES[shape]
    tw, qw, lengths = _planes(seed + 200, B, LW, dictionary)
    want = _pallas(tw, qw, lengths, caller)
    np.testing.assert_array_equal(_want(tw, qw, lengths, caller), want)
    for head, cuts in ((0, CUTS["kernel"]), (3, CUTS["ragged"])):
        got = stream_stats(tw, qw, lengths, caller, head, cuts)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("caller", [False, True])
@pytest.mark.parametrize("shape", range(len(SHAPES)))
def test_rows_of_mismatched_bases_go_word_by_word(shape, caller):
    seed, B, LW, dictionary = SHAPES[shape]
    tw, qw, lengths = _planes(seed + 100, B, LW, dictionary)
    got = stream_stats(tw, qw, lengths, caller, 0, CUTS["kernel"], vec=False)
    np.testing.assert_array_equal(got, _want(tw, qw, lengths, caller))


@pytest.mark.parametrize("caller", [False, True])
@pytest.mark.parametrize("word", [0x00000000, 0xFFFFFFFF, 0xF0F0F0F0, 0x0C0D0E0F,
                                  0x80000000, 0x00000008])
def test_flags_of_codes_the_dictionary_never_makes(word, caller):
    """Zero tests and carries on words of codes 12-15 and gaps: every
    column of one uint4 against the per-column reference, with the column
    before it a gap, an equal column or code 15."""
    rng = np.random.default_rng(word & 0xFFFF)
    for before in (0x00000000, 0x10000000, 0xF0000000):
        tw = np.array([[before, word, word ^ 0x0F0F0000, word, 0x76543210]],
                      np.uint32)
        qw = np.array([[before, word, word, rng.integers(0, 1 << 32), 0xFEDCBA98]],
                      np.uint32)
        tw, qw = tw.view(np.int32), qw.view(np.int32)
        lengths = np.array([40], np.int32)
        want = _want(tw, qw, lengths, caller)
        for head in (0, 1):
            np.testing.assert_array_equal(
                stream_stats(tw, qw, lengths, caller, head, CUTS["ones"]), want)


def test_merged_bits_are_columns():
    """Bit 4 i + j of a merged flag word is column 8 j + i of the uint4, and
    merged_starts finds the column before across words and uint4s."""
    for col in range(32):
        j, i = divmod(col, 8)
        t4 = u32(np.full((1, 4), 0x11111111))
        t4[0, j] ^= u32(1 << (4 * i))  # column `col` becomes a gap in t
        e, tg, qg = merged_flags(t4, u32(np.full((1, 4), 0x11111111)))
        assert int(tg[0]) == 1 << (4 * i + j)
        assert int(e[0]) == 0xFFFFFFFF ^ (1 << (4 * i + j))
        rs = merged_starts(tg, u32(0))
        nxt = col + 1
        want = 1 << (4 * i + j)
        if nxt < 32:
            want |= 1 << (4 * (nxt % 8) + nxt // 8)
        assert int(rs[0]) == want
