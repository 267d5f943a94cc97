"""The word, nibble and fused16 paths of wgatools_tpu_torch against
wgatools_tpu.

The plain versions of the word entry (kernel D's device code), kernel E,
kernel F and every mode of kernel C are what those kernels are held to on
the card; here each must equal the JAX function, run in Pallas interpret
mode on the same numpy inputs from a seed.  The host packers must match the
JAX ones byte for byte.  Every output is an integer: the tolerance is exact
equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wgatools_tpu.ops import classify as JC
from wgatools_tpu.ops import fused as JF
from wgatools_tpu.ops import liftover as JL
from wgatools_tpu_torch.ops import classify as TC
from wgatools_tpu_torch.ops import fused as TF
from wgatools_tpu_torch.ops import liftover as TL

CPU = torch.device("cpu")
NIB_ALPHABET = np.frombuffer(b"ACGTNacgtn.-", np.uint8)

# (row lengths, seed): lengths 0, rows of any width, B not a multiple of 8
CASES = [
    ([0, 5, 3000, 2999, 100, 8, 9, 1000, 77], 1),
    ([17], 2),
    ([4096, 0, 4095, 1, 2048], 3),
]
# (op rows, ops per row): B2 below, equal to and above B; odd op counts
OP_SHAPES = [(7, 2001), (9, 64), (1, 3)]
SCANS = [("vpu", None), ("mm", None), ("mm", 128), ("once", None)]


def _pairs(seed, lengths, alphabet=NIB_ALPHABET):
    rng = np.random.default_rng(seed)
    pairs = []
    for n in lengths:
        t = alphabet[rng.integers(0, len(alphabet), n)]
        q = t.copy()
        flip = rng.random(n) < 0.35
        q[flip] = alphabet[rng.integers(0, len(alphabet), int(flip.sum()))]
        if n > 40:  # a gap/gap stretch
            t[10:30] = q[10:30] = ord("-")
        pairs.append((t.tobytes(), q.tobytes()))
    return JC.pack_pairs(pairs, align=8)


def _ops(seed, rows, n):
    """M/=/X/I/D/S ops with lengths in [0, 8192), 8191 included, and
    trailing padding."""
    rng = np.random.default_rng(seed)
    ops = np.frombuffer(b"M=XIDS", np.uint8)[rng.integers(0, 6, (rows, n))]
    lens = rng.integers(0, 8192, (rows, n)).astype(np.int32)
    lens[:, 0] = 8191
    ops[-1, n // 2:] = 0
    lens[ops == 0] = 0
    return ops, lens


def _planes(case, kind):
    """(tw, qw, lengths) numpy planes of one case: byte words, nibble
    words or (qw None) the category plane."""
    lengths, seed = CASES[case]
    t, q, ln = _pairs(seed, lengths)
    if kind == "words":
        return t.view("<i4"), q.view("<i4"), ln
    if kind == "nibble":
        return (*JC.pack_nibble_words(t, q), ln)
    return JC.pack_cat_nibbles(t, q), None, ln


def _assert_outputs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


# ---- host packers -----------------------------------------------------------


def test_nibble_lut_matches():
    assert TC._NIB_LUT.tobytes() == JC._NIB_LUT.tobytes()


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_pack_nibble_words_matches(case, use_native):
    lengths, seed = CASES[case]
    t, q, _ = _pairs(seed, lengths)
    got = TC.pack_nibble_words(t, q, use_native=use_native)
    want = JC.pack_nibble_words(t, q, use_native=use_native)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("bad", [b"R", b"*", b"\x00"])
def test_pack_nibble_words_refuses_bytes_outside_the_dictionary(bad, use_native):
    t, q, _ = _pairs(4, [50, 60])
    for plane in (t, q):
        plane[1, 7] = bad[0]
        assert TC.pack_nibble_words(t, q, use_native) is None
        assert JC.pack_nibble_words(t, q, use_native) is None
        plane[1, 7] = ord("A")


def test_pack_nibble_words_refuses_unaligned_width():
    t = np.full((2, 12), ord("A"), np.uint8)
    assert TC.pack_nibble_words(t, t) is None


@pytest.mark.parametrize("shape", OP_SHAPES)
def test_pack_ops_words16_matches(shape):
    ops, lens = _ops(sum(shape), *shape)
    got = TL.pack_ops_words16(ops, lens)
    want = JL.pack_ops_words16(ops, lens)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    # a D in the odd half sets bit 31
    assert (got < 0).any() == (ops[:, 1::2] == ord("D")).any()


@pytest.mark.parametrize(
    "ops, lens, match",
    [
        (b"MID", [1, 8192, 3], "len < 8192"),
        (b"MNM", [1, 2, 3], "unsupported op"),
        (b"MHM", [1, 2, 3], "unsupported op"),
    ],
)
def test_pack_ops_words16_guards(ops, lens, match):
    o = np.frombuffer(ops, np.uint8).reshape(1, -1)
    ln = np.array([lens], np.int32)
    for pack in (TL.pack_ops_words16, JL.pack_ops_words16):
        with pytest.raises(ValueError, match=match):
            pack(o, ln)


# ---- plain versions against the Pallas kernels ------------------------------


@pytest.mark.parametrize("caller", [False, True])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_words_ref_matches_pallas_and_jnp(case, caller):
    tw, qw, ln = _planes(case, "words")
    got = TC.classify_stat_words_ref(_t(tw), _t(qw), _t(ln), caller)
    pallas = JC.classify_stat_pallas_words(
        jnp.asarray(tw), jnp.asarray(qw), jnp.asarray(ln), interpret=True,
        caller=caller,
    )
    _assert_outputs([got], [pallas])
    t, q = tw.view(np.uint8), qw.view(np.uint8)
    _assert_outputs([got], [JC.classify_stat_jnp(t, q, ln, caller=caller)])


@pytest.mark.parametrize("caller", [False, True])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_nibbles_ref_matches_pallas(case, caller):
    tw, qw, ln = _planes(case, "nibble")
    got = TC.classify_stat_nibbles_ref(_t(tw), _t(qw), _t(ln), caller)
    pallas = JC.classify_stat_pallas_nibbles(
        jnp.asarray(tw), jnp.asarray(qw), jnp.asarray(ln), tile_lw=128,
        interpret=True, caller=caller,
    )
    _assert_outputs([got], [pallas])


@pytest.mark.parametrize("caller", [False, True])
def test_nibbles_ref_masks_whatever_padding_holds(caller):
    """Columns >= lengths do not count, whatever their codes (the kernel
    masks them instead of relying on 0/0 padding)."""
    tw, qw, ln = _planes(0, "nibble")
    want = TC.classify_stat_nibbles_ref(_t(tw), _t(qw), _t(ln), caller)
    noisy = TC._unpack_cats(_t(tw)).numpy().copy()
    col = np.arange(noisy.shape[1])[None, :]
    noisy[col >= ln[:, None]] = 7
    packed = np.ascontiguousarray(noisy[:, 0::2] | (noisy[:, 1::2] << 4)).view("<i4")
    got = TC.classify_stat_nibbles_ref(_t(packed), _t(qw), _t(ln), caller)
    assert torch.equal(got, want)


@pytest.mark.parametrize("caller", [False, True])
@pytest.mark.parametrize("kind", ["words", "nibble"])
@pytest.mark.parametrize("scan", SCANS[:2], ids=["vpu", "mm"])
@pytest.mark.parametrize("case, op_shape", [(0, OP_SHAPES[0]), (2, OP_SHAPES[1]), (1, OP_SHAPES[2])])
def test_fused16_ref_matches_jax(case, op_shape, scan, kind, caller):
    tw, qw, ln = _planes(case, kind)
    opw = JL.pack_ops_words16(*_ops(case, *op_shape))
    want = JF.classify_liftover_fused16(
        jnp.asarray(tw), jnp.asarray(qw), jnp.asarray(ln), jnp.asarray(opw),
        interpret=True, caller=caller, nibble=kind == "nibble",
        scan_mode=scan[0],
    )
    got = TF.classify_liftover_fused16(tw, qw, ln, opw, CPU, caller,
                                       nibble=kind == "nibble",
                                       scan_mode=scan[0])
    _assert_outputs(got, want)
    _assert_outputs(got, TF.classify_liftover_fused16_ref(
        _t(tw), _t(qw), _t(ln), _t(opw), caller, kind == "nibble"))


@pytest.mark.parametrize("caller", [False, True])
@pytest.mark.parametrize("scan", SCANS, ids=["vpu", "mm", "mm-chunk128", "once"])
@pytest.mark.parametrize("mode", ["odd", "even", "raw"])
@pytest.mark.parametrize("kind", ["words", "nibble", "cat"])
def test_adv16_ref_matches_jax(kind, mode, scan, caller):
    case = {"words": 0, "nibble": 2, "cat": 1}[kind]
    tw, qw, ln = _planes(case, kind)
    ops, lens = _ops(10 + case, *OP_SHAPES[case])
    if mode == "raw":
        wt, wq = JL.pack_ops_sums(ops, lens, group=8)
    else:
        wt, wq = JL.pack_ops_adv16(ops, lens)
    flags = dict(caller=caller, nibble=kind == "nibble", catmode=kind == "cat",
                 scan_mode=scan[0], chunk=scan[1], emit_odd=mode == "odd",
                 raw_sums=mode == "raw")
    want = JF.classify_liftover_fused_adv16(
        jnp.asarray(tw), None if qw is None else jnp.asarray(qw),
        jnp.asarray(ln), jnp.asarray(wt), jnp.asarray(wq), interpret=True,
        **flags,
    )
    got = TF.classify_liftover_fused_adv16(tw, qw, ln, wt, wq, CPU, **flags)
    assert len(got) == (5 if mode == "odd" else 3)
    _assert_outputs(got, want)


@pytest.mark.parametrize("kind", ["words", "nibble"])
def test_fused16_and_adv16_offsets_are_the_full_scan(kind):
    """Even/odd halves interleave to kernel B's per-op offsets, and the
    adv16 words give the same halves as the packed16 words."""
    tw, qw, ln = _planes(0, kind)
    ops, lens = _ops(21, 7, 2001)
    nib = kind == "nibble"
    f16 = TF.classify_liftover_fused16(tw, qw, ln, JL.pack_ops_words16(ops, lens),
                                       CPU, nibble=nib)
    wt, wq = TL.pack_ops_adv16(ops, lens)
    adv = TF.classify_liftover_fused_adv16(tw, qw, ln, wt, wq, CPU, nibble=nib)
    for g, w in zip(adv, f16):
        assert torch.equal(g, w)
    want_t, want_q = TL.liftover_scan_ref(_t(ops), _t(lens))
    for even, odd, want in ((f16[1], f16[2], want_t), (f16[3], f16[4], want_q)):
        full = TL.interleave_halves(even.numpy(), odd.numpy())[:, : ops.shape[1]]
        np.testing.assert_array_equal(full, want.numpy())


def test_raw_sums_forces_even_only():
    tw, qw, ln = _planes(1, "nibble")
    st, sq = TL.pack_ops_sums(*_ops(3, 1, 3), group=8)
    out = TF.classify_liftover_fused_adv16(tw, qw, ln, st, sq, CPU, nibble=True,
                                           raw_sums=True, emit_odd=True)
    assert len(out) == 3


@pytest.mark.parametrize(
    "qw_none, flags, match",
    [
        (False, dict(catmode=True), "ONE category plane"),
        (True, dict(), "only catmode"),
    ],
)
def test_adv16_plane_arguments_are_checked(qw_none, flags, match):
    tw, qw, ln = _planes(1, "nibble")
    wt, wq = TL.pack_ops_adv16(*_ops(3, 1, 3))
    with pytest.raises(ValueError, match=match):
        TF.classify_liftover_fused_adv16(tw, None if qw_none else qw, ln, wt,
                                         wq, CPU, **flags)


@pytest.mark.parametrize(
    "fn, planes",
    [
        (TC.classify_stat_words, 2),
        (TC.classify_stat_nibbles, 2),
    ],
)
def test_word_wrappers_refuse_a_non_cuda_device(fn, planes):
    w = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fn(w, w, torch.zeros(2, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("caller", [False, True])
@pytest.mark.parametrize("kind", ["words", "nibble"])
def test_word_wrappers_on_cpu_are_the_plain_versions(kind, caller):
    tw, qw, ln = (_t(a) for a in _planes(0, kind))
    fn, ref = {
        "words": (TC.classify_stat_words, TC.classify_stat_words_ref),
        "nibble": (TC.classify_stat_nibbles, TC.classify_stat_nibbles_ref),
    }[kind]
    assert torch.equal(fn(tw, qw, ln, caller), ref(tw, qw, ln, caller))


@pytest.mark.parametrize("caller", [False, True])
def test_column_stats_takes_word_planes(caller):
    tw, qw, ln = _planes(0, "words")
    want = np.asarray(JC.column_stats(tw.view(np.uint8), qw.view(np.uint8), ln,
                                      caller=caller))
    for a, b in ((tw, qw), (_t(tw), _t(qw))):
        got = TC.column_stats(a, b, ln, CPU, caller)
        np.testing.assert_array_equal(got.numpy(), want)
