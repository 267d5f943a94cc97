"""wgatools_tpu_torch.ops.liftover against wgatools_tpu.ops.liftover.

The host packers must match byte for byte; the plain PyTorch scan (the
reference kernel B is held to on the card) must match the TPU package's
jnp scans and its Pallas kernel in interpret mode.  Exact equality: every
output is an integer.
"""

import random

import numpy as np
import pytest
import torch

from wgatools_tpu.ops import liftover as J
from wgatools_tpu_torch.ops import liftover as T


def _op_table(seed, max_len=60, ops=b"M=XIDS", zero_lens=False):
    """Per-record (ops, lens) arrays, packed to [B, N] the way both packages
    pack them: random row counts and op mixes, single-op rows."""
    rng = random.Random(seed)
    op_arrays, len_arrays = [], []
    for _ in range(rng.randint(1, 13)):
        n = rng.randint(1, 700)
        op_arrays.append(np.frombuffer(
            bytes(rng.choice(ops) for _ in range(n)), dtype=np.uint8))
        choices = (0, 1, 2, 31, max_len) if zero_lens else range(1, max_len + 1)
        len_arrays.append(np.array(
            [rng.choice(choices) for _ in range(n)], dtype=np.int64))
    return op_arrays, len_arrays


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_adv_tables_match():
    _same(T._ADV_CLASS, J._ADV_CLASS)
    _same(T._VALID_PACK16, J._VALID_PACK16)


@pytest.mark.parametrize("seed", range(3))
def test_pack_ops_batch_matches(seed):
    op_arrays, len_arrays = _op_table(seed)
    for align in (1, 128):
        for got, want in zip(T.pack_ops_batch(op_arrays, len_arrays, align),
                             J.pack_ops_batch(op_arrays, len_arrays, align)):
            _same(got, want)
    for got, want in zip(T.pack_ops_batch([], []), J.pack_ops_batch([], [])):
        _same(got, want)


@pytest.mark.parametrize("n", [64, 63, 1])
def test_16bit_packers_match(n):
    rng = np.random.default_rng(n)
    ops = np.frombuffer(b"M=XIDS", np.uint8)[rng.integers(0, 6, (5, n))].copy()
    ops[-1, n // 2:] = 0
    lens = rng.integers(0, 8000, (5, n)).astype(np.int32)
    for who, pad_to in (("x", 2), ("y", 8)):
        for got, want in zip(T._validate_pack16(ops, lens, who, pad_to),
                             J._validate_pack16(ops, lens, who, pad_to)):
            _same(got, want)
        for got, want in zip(T._host_advances(ops, lens, who, pad_to),
                             J._host_advances(ops, lens, who, pad_to)):
            _same(got, want)
    for got, want in zip(T.pack_ops_adv16(ops, lens), J.pack_ops_adv16(ops, lens)):
        _same(got, want)
    for group in (2, 4, 8):
        got_s = T.pack_ops_sums(ops, lens, group)
        for got, want in zip(got_s, J.pack_ops_sums(ops, lens, group)):
            _same(got, want)
        # anchors -> per-pair offsets -> odd offsets -> the full table
        wt, _ = J.pack_ops_adv16(ops, lens)
        anchors = np.cumsum(got_s[0], axis=1, dtype=np.int32) - got_s[0]
        even = T.expand_group_prefix(anchors, wt, group)
        _same(even, J.expand_group_prefix(anchors, wt, group))
        odd = T.adv16_odd_offsets(even, wt)
        _same(odd, J.adv16_odd_offsets(even, wt))
        _same(T.interleave_halves(even, odd), J.interleave_halves(even, odd))


@pytest.mark.parametrize("bad", [(b"N", 5), (b"M", 8192)])
def test_16bit_packers_refuse_what_they_cannot_pack(bad):
    op, length = bad
    ops = np.full((1, 4), op[0], np.uint8)
    lens = np.full((1, 4), length, np.int32)
    for mod in (T, J):
        with pytest.raises(ValueError):
            mod.pack_ops_adv16(ops, lens)


@pytest.mark.parametrize("seed", range(30, 34))
@pytest.mark.parametrize("mode", ["liftover", "chain"])
def test_scan_ref_matches_jax(seed, mode):
    """Same cases as the TPU package's Pallas fuzz: S ops, zero-length ops,
    lengths up to 2^16 - 1, single-op rows, odd row counts."""
    op_arrays, len_arrays = _op_table(seed, 65535, zero_lens=True)
    ops, lens = J.pack_ops_batch(op_arrays, len_arrays)
    impl = J._liftover_scan_impl if mode == "liftover" else J._chain_scan_impl
    want = [np.asarray(a) for a in impl(ops, lens, False, False)]
    pallas = J.liftover_scan_pallas(ops, lens, interpret=True, mode=mode)
    got = T.liftover_scan_ref(torch.from_numpy(ops), torch.from_numpy(lens), mode)
    for g, w, p in zip(got, want, pallas):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(g.numpy(), np.asarray(p))


@pytest.mark.parametrize("mode", ["liftover", "chain"])
def test_scan_ref_past_the_tpu_length_bound(mode):
    """Op lengths past 2^16 (the TPU kernel's limb bound) and op bytes
    outside M/=/X/I/D/S: int32 sums stay identical to the jnp scan."""
    op_arrays, len_arrays = _op_table(7, 1 << 20, ops=b"M=XIDSNH")
    ops, lens = J.pack_ops_batch(op_arrays, len_arrays)
    impl = J._liftover_scan_impl if mode == "liftover" else J._chain_scan_impl
    want = impl(ops, lens, True, False)
    got = T.liftover_scan_ref(torch.from_numpy(ops), torch.from_numpy(lens), mode)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_scan_wrappers_on_cpu_are_the_plain_version():
    op_arrays, len_arrays = _op_table(3)
    ops, lens = (torch.from_numpy(a) for a in J.pack_ops_batch(op_arrays, len_arrays))
    for fn, mode in ((T.liftover_scan, "liftover"), (T.chain_scan, "chain")):
        for g, w in zip(fn(ops, lens), T.liftover_scan_ref(ops, lens, mode)):
            assert torch.equal(g, w)


def test_scan_wrapper_refuses_a_non_cuda_device():
    ops = torch.zeros((2, 4), dtype=torch.uint8, device="meta")
    lens = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        T.chain_scan(ops, lens)


@pytest.mark.parametrize(
    "lens, safe",
    [([], False), ([5, 7], True), ([2**31 - 1], True), ([2**31 - 1, 1], False),
     ([2**31], False), ([70000, 3], True)],
)
def test_int32_safe_record(lens, safe):
    assert T.int32_safe_record(np.array(lens, dtype=np.int64)) is safe
