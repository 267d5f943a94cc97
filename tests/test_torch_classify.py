"""wgatools_tpu_torch.ops.classify against wgatools_tpu.ops.classify.

The same numpy inputs, made from a seed, go through both packages.  Every
output is an integer, so the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wgatools_tpu.ops import classify as J
from wgatools_tpu_torch.kernels import _build
from wgatools_tpu_torch.ops import classify as T

ALPHABET = np.frombuffer(b"ACGTNacgtn-RYMKSW.", dtype=np.uint8)

# (lengths, all gap/gap rows, pack alignment): odd B, B=1, L not a multiple
# of 1024, rows of length 0, multi-word rows with partial last words
CASES = [
    ([0, 1, 7, 8, 9, 777, 999, 1000, 1000], (8,), 8),
    ([17], (), 8),
    ([300, 0, 129, 256, 3], (3,), 128),
    ([0], (), 8),
]


def _pairs(seed, lengths, gg_rows=(), unequal=False):
    """(t, q) byte pairs: IUPAC and lowercase bytes, runs of gaps, and with
    `unequal` one row longer than the other."""
    rng = np.random.default_rng(seed)
    pairs = []
    for k, n in enumerate(lengths):
        if k in gg_rows:
            pairs.append((b"-" * n, b"-" * n))
            continue
        t = ALPHABET[rng.integers(0, len(ALPHABET), n)]
        q = t.copy()
        flip = rng.random(n) < 0.35
        q[flip] = ALPHABET[rng.integers(0, len(ALPHABET), int(flip.sum()))]
        extra = rng.integers(0, 5) if unequal else 0
        tail = ALPHABET[rng.integers(0, len(ALPHABET), extra)]
        if k % 2:
            pairs.append((t.tobytes() + tail.tobytes(), q.tobytes()))
        else:
            pairs.append((t.tobytes(), q.tobytes() + tail.tobytes()))
    return pairs


def test_cat_lut_matches():
    assert T._CAT_LUT64K.dtype == J._CAT_LUT64K.dtype
    assert T._CAT_LUT64K.tobytes() == J._CAT_LUT64K.tobytes()


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("unequal", [False, True])
def test_pack_pairs_matches(case, unequal):
    lengths, gg, align = CASES[case]
    pairs = _pairs(case, lengths, gg, unequal)
    for got, want in zip(T.pack_pairs(pairs, align), J.pack_pairs(pairs, align)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_pack_cat_nibbles_matches(case, use_native):
    lengths, gg, align = CASES[case]
    t, q, _ = J.pack_pairs(_pairs(10 + case, lengths, gg, True), align)
    got = T.pack_cat_nibbles(t, q, use_native=use_native)
    want = J.pack_cat_nibbles(t, q, use_native=use_native)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    # the native and numpy packers agree with each other too
    assert got.tobytes() == T.pack_cat_nibbles(t, q, not use_native).tobytes()


def test_pack_cat_nibbles_refuses_unaligned_width():
    t = np.full((2, 12), ord("A"), np.uint8)
    assert T.pack_cat_nibbles(t, t) is None


@pytest.mark.parametrize("caller", [False, True])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_classify_ref_matches_jnp_and_pallas(case, caller):
    lengths, gg, align = CASES[case]
    t, q, ln = J.pack_pairs(_pairs(20 + case, lengths, gg, True), align)
    want = np.asarray(J.classify_stat_jnp(t, q, ln, caller=caller))
    cw = J.pack_cat_nibbles(t, q)
    got = T.classify_stat_cat_ref(torch.from_numpy(cw), torch.from_numpy(ln), caller)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    pallas = J.classify_stat_pallas_cat(
        jnp.asarray(cw), jnp.asarray(ln), interpret=True, tile_lw=32,
        caller=caller,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


@pytest.mark.parametrize("caller", [False, True])
def test_classify_ref_masks_whatever_padding_holds(caller):
    """Columns >= lengths do not count, whatever their codes (the kernel
    masks them instead of relying on gap/gap padding)."""
    t, q, ln = J.pack_pairs(_pairs(31, [40, 100, 0]), 128)
    cw = J.pack_cat_nibbles(t, q)
    want = T.classify_stat_cat_ref(torch.from_numpy(cw), torch.from_numpy(ln), caller)
    noisy = cw.copy()
    rng = np.random.default_rng(3)
    for b, n in enumerate(ln.tolist()):
        first = (n + 7) // 8
        noisy[b, first:] = rng.integers(-(2**31), 2**31 - 1, cw.shape[1] - first)
        if n % 8:  # the partial word's tail nibbles
            keep = (1 << (4 * (n % 8))) - 1
            w = int(noisy[b, first - 1]) & 0xFFFFFFFF
            noisy[b, first - 1] = np.uint32((w & keep) | (0x42424242 & ~keep)).view(np.int32)
    got = T.classify_stat_cat_ref(torch.from_numpy(noisy), torch.from_numpy(ln), caller)
    assert torch.equal(got, want)


@pytest.mark.parametrize("caller", [False, True])
def test_classify_wrapper_on_cpu_is_the_plain_version(caller):
    t, q, ln = J.pack_pairs(_pairs(41, [500, 3, 0, 64]), 128)
    cw, lt = torch.from_numpy(J.pack_cat_nibbles(t, q)), torch.from_numpy(ln)
    assert torch.equal(
        T.classify_stat_cat(cw, lt, caller), T.classify_stat_cat_ref(cw, lt, caller)
    )


def test_classify_wrapper_refuses_a_non_cuda_device():
    cw = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        T.classify_stat_cat(cw, torch.zeros(2, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("caller", [False, True])
def test_column_stats_matches_jax(caller):
    # widths of 1000 columns: not a multiple of 8 before the port's padding
    t, q, ln = J.pack_pairs(_pairs(51, [1000, 999, 0, 5]), 8)
    want = np.asarray(J.column_stats(t, q, ln, caller=caller))
    got = T.column_stats(t, q, ln, torch.device("cpu"), caller)
    np.testing.assert_array_equal(got.numpy(), want)
    t3, q3 = t[:, :997], q[:, :997]
    want3 = np.asarray(J.column_stats(t3, q3, np.minimum(ln, 997), caller=caller))
    got3 = T.column_stats(t3, q3, np.minimum(ln, 997), torch.device("cpu"), caller)
    np.testing.assert_array_equal(got3.numpy(), want3)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A missing compiler is an error, never a quiet switch to the plain
    versions."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.lib()
    assert _build._lib is None
