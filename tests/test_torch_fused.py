"""wgatools_tpu_torch.ops.fused against wgatools_tpu.ops.fused.

The plain PyTorch version of the fused kernel (what kernel C is held to on
the card) must equal classify_liftover_fused_adv16 in bench.py's
configuration (catmode, scan_mode="once", raw_sums), run in interpret mode
on the same numpy inputs.  Exact equality: every output is an integer.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wgatools_tpu.ops.classify import pack_cat_nibbles, pack_pairs
from wgatools_tpu.ops.fused import classify_liftover_fused_adv16 as jax_fused
from wgatools_tpu.ops.liftover import _liftover_scan_impl, pack_ops_adv16, pack_ops_sums
from wgatools_tpu_torch.ops import fused as T
from wgatools_tpu_torch.ops.liftover import (
    adv16_odd_offsets,
    expand_group_prefix,
    interleave_halves,
)

CPU = torch.device("cpu")


def _inputs(seed, n_rows, n_op_rows, n_ops):
    """A category plane of n_rows random pairs (one all gap/gap, one empty)
    and n_op_rows x n_ops random ops of lengths < 8000."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGTacgtN-", dtype=np.uint8)
    pairs = []
    for k in range(n_rows):
        n = int(rng.integers(0, 700)) if k else 0
        t = alphabet[rng.integers(0, len(alphabet), n)]
        q = alphabet[rng.integers(0, len(alphabet), n)]
        pairs.append((b"-" * n, b"-" * n) if k == 1 else (t.tobytes(), q.tobytes()))
    t, q, lens = pack_pairs(pairs, align=256)
    ops = np.frombuffer(b"M=XIDS", np.uint8)[rng.integers(0, 6, (n_op_rows, n_ops))]
    op_lens = rng.integers(0, 8000, (n_op_rows, n_ops)).astype(np.int32)
    return pack_cat_nibbles(t, q), lens, ops, op_lens


@pytest.mark.parametrize("caller", [False, True])
@pytest.mark.parametrize(
    "n_rows, n_op_rows, n_ops",
    [(5, 4, 64), (9, 9, 200), (3, 7, 8), (8, 2, 1000)],
)
def test_fused_ref_matches_jax(n_rows, n_op_rows, n_ops, caller):
    cw, lens, ops, op_lens = _inputs(n_rows * 100 + n_ops, n_rows, n_op_rows, n_ops)
    st, sq = pack_ops_sums(ops, op_lens, group=8)
    want = jax_fused(
        jnp.asarray(cw), None, jnp.asarray(lens), jnp.asarray(st),
        jnp.asarray(sq), tile_b=2, tile_lw=32, interpret=True, caller=caller,
        catmode=True, scan_mode="once", raw_sums=True,
    )
    got = T.classify_liftover_fused_adv16(cw, None, lens, st, sq, CPU, caller,
                                          catmode=True, raw_sums=True)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_fused_anchors_expand_to_the_full_scan():
    """bench.py's parity chain: anchors -> per-pair even offsets -> odd
    offsets -> the full per-op table of the plain liftover scan."""
    cw, lens, ops, op_lens = _inputs(7, 4, 6, 333)
    st, sq = pack_ops_sums(ops, op_lens, group=8)
    wt, wq = pack_ops_adv16(ops, op_lens)
    _, ta, qa = T.classify_liftover_fused_adv16(cw, None, lens, st, sq, CPU,
                                                catmode=True, raw_sums=True)
    want_t, want_q = _liftover_scan_impl(ops, op_lens, False, False)
    for anchors, w, want in ((ta, wt, want_t), (qa, wq, want_q)):
        even = expand_group_prefix(anchors.numpy(), w, group=8)
        got = interleave_halves(even, adv16_odd_offsets(even, w))[:, : ops.shape[1]]
        np.testing.assert_array_equal(got, np.asarray(want))


def test_fused_takes_tensors_and_numpy_alike():
    cw, lens, ops, op_lens = _inputs(11, 3, 3, 40)
    st, sq = pack_ops_sums(ops, op_lens, group=8)
    flags = dict(catmode=True, raw_sums=True)
    a = T.classify_liftover_fused_adv16(cw, None, lens, st, sq, CPU, **flags)
    cw, lens, st, sq = (torch.from_numpy(x) for x in (cw, lens, st, sq))
    b = T.classify_liftover_fused_adv16(cw, None, lens, st, sq, CPU, **flags)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
