"""wgatools_tpu_torch.ops.fused.classify_liftover_fused (kernel 8's plain
version, what the kernel is held to on the card) against
wgatools_tpu.ops.fused.classify_liftover_fused run in interpret mode, as
tests/test_fused.py runs it, on the same numpy inputs; and the port's
pack_ops_words against the TPU package's.  Exact equality: every output
is an integer.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wgatools_tpu.ops.fused import classify_liftover_fused as jax_fused
from wgatools_tpu.ops.liftover import pack_ops_words as jax_pack_ops_words
from wgatools_tpu_torch.ops import fused as T
from wgatools_tpu_torch.ops.liftover import pack_ops_words

CPU = torch.device("cpu")


def _planes(rng, B, L):
    """Byte planes of B random pairs (row 0 full, one all-gap row) as
    little-endian int32 words, and their lengths in columns."""
    alpha = np.frombuffer(b"ACGTN-acgt", np.uint8)
    t = np.full((B, L), ord("-"), np.uint8)
    q = np.full((B, L), ord("-"), np.uint8)
    lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
    lengths[0] = L
    for b in range(B):
        t[b, : lengths[b]] = alpha[rng.integers(0, len(alpha), lengths[b])]
        q[b, : lengths[b]] = alpha[rng.integers(0, len(alpha), lengths[b])]
    if B > 2:
        t[2], q[2] = ord("-"), ord("-")
    return t.view("<i4"), q.view("<i4"), lengths


def _ops(rng, B2, NO, op_bytes, max_len):
    """[B2, NO] op table, each row padded with op 0 after a random count."""
    ops = op_bytes[rng.integers(0, len(op_bytes), (B2, NO))]
    ops[np.arange(NO)[None, :] >= rng.integers(0, NO + 1, B2)[:, None]] = 0
    lens = rng.integers(0, max_len, (B2, NO), dtype=np.int64).astype(np.int32)
    lens[ops == 0] = 0
    return ops.astype(np.uint8), lens


CIGAR = np.frombuffer(b"M=XIDS", np.uint8)
ANY_BYTE = np.arange(256, dtype=np.uint8)


def _check(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("caller", [False, True])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize(
    "B, L, B2, NO, op_bytes, scan_mode",
    [
        (5, 2048, 7, 300, CIGAR, "vpu"),
        (9, 1024, 3, 129, CIGAR, "mm"),  # B > B2, NO past one tile
        (2, 2048, 11, 77, ANY_BYTE, "vpu"),  # bytes that are not CIGAR ops
    ],
)
def test_fused_ops_ref_matches_jax(B, L, B2, NO, op_bytes, scan_mode, packed,
                                   caller):
    rng = np.random.default_rng(B * 1000 + NO + packed)
    tw, qw, lengths = _planes(rng, B, L)
    ops, lens = _ops(rng, B2, NO, op_bytes, 1 << 16)
    if packed:
        opw = pack_ops_words(ops, lens)
        jax_args, args = (jnp.asarray(opw), None), (opw, None)
    else:
        jax_args, args = (jnp.asarray(ops), jnp.asarray(lens)), (ops, lens)
    want = jax_fused(jnp.asarray(tw), jnp.asarray(qw), jnp.asarray(lengths),
                     *jax_args, tile_lw=256, tile_lo=256, interpret=True,
                     caller=caller, scan_mode=scan_mode)
    _check(T.classify_liftover_fused(tw, qw, lengths, *args, CPU, caller,
                                     scan_mode=scan_mode), want)


@pytest.mark.parametrize("caller", [False, True])
def test_fused_ops_random_packed_words(caller):
    """Random int32 words, half of them negative (op bytes >= 0x80), bits
    16-23 set: the op is the top byte, the length the low 16 bits."""
    rng = np.random.default_rng(17)
    tw, qw, lengths = _planes(rng, 4, 1024)
    opw = rng.integers(0, 1 << 32, (6, 200), dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    assert (opw < 0).mean() > 0.3
    want = jax_fused(jnp.asarray(tw), jnp.asarray(qw), jnp.asarray(lengths),
                     jnp.asarray(opw), None, tile_lw=256, tile_lo=256,
                     interpret=True, caller=caller)
    _check(T.classify_liftover_fused(tw, qw, lengths, opw, None, CPU, caller),
           want)


def test_fused_ops_lengths_that_wrap():
    """u8 ops with int32 lengths up to 2^31 - 1: the row sums pass 2^31 and
    wrap as the TPU kernel's int32 adds (vpu scan) do."""
    rng = np.random.default_rng(5)
    tw, qw, lengths = _planes(rng, 3, 1024)
    ops, _ = _ops(rng, 4, 150, CIGAR, 2)
    lens = rng.integers(0, 2**31, ops.shape, dtype=np.int64).astype(np.int32)
    lens[ops == 0] = 0
    want = jax_fused(jnp.asarray(tw), jnp.asarray(qw), jnp.asarray(lengths),
                     jnp.asarray(ops), jnp.asarray(lens), tile_lw=256,
                     tile_lo=256, interpret=True)
    got = T.classify_liftover_fused(tw, qw, lengths, ops, lens, CPU)
    _check(got, want)
    assert (got[1].numpy() < 0).any()  # wrapped


def test_fused_ops_equal_the_separate_kernels():
    """Kernel 8's plain version is kernel D's word stats beside kernel B's
    liftover scan, and takes numpy and tensors alike."""
    from wgatools_tpu_torch.ops.classify import classify_stat_words_ref
    from wgatools_tpu_torch.ops.liftover import liftover_scan_ref

    rng = np.random.default_rng(3)
    tw, qw, lengths = _planes(rng, 6, 512)
    ops, lens = _ops(rng, 6, 64, CIGAR, 1000)
    a = T.classify_liftover_fused(tw, qw, lengths, ops, lens, CPU)
    b = T.classify_liftover_fused_ref(*(torch.from_numpy(x) for x in
                                        (tw, qw, lengths, ops, lens)))
    stats = classify_stat_words_ref(*(torch.from_numpy(x) for x in
                                      (tw, qw, lengths)))
    scan = liftover_scan_ref(torch.from_numpy(ops), torch.from_numpy(lens))
    for x, y, z in zip(a, b, (stats, *scan)):
        assert torch.equal(x, y) and torch.equal(x, z)


def test_pack_ops_words_matches_jax():
    rng = np.random.default_rng(0)
    ops = ANY_BYTE[rng.integers(0, 256, (4, 33))]
    lens = rng.integers(0, 1 << 16, (4, 33)).astype(np.int32)
    got = pack_ops_words(ops, lens)
    assert got.dtype == np.int32
    assert np.array_equal(got, jax_pack_ops_words(ops, lens))
    assert np.array_equal((got >> 24) & 0xFF, ops)
    for pack in (pack_ops_words, jax_pack_ops_words):
        with pytest.raises(ValueError, match="2\\^16"):
            pack(ops, lens + 0x10000)
