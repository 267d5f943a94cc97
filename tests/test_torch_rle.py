"""wgatools_tpu_torch.ops.rle_device and the byte-plane statistics against
wgatools_tpu.ops.rle_device and wgatools_tpu.ops.classify.

The same numpy inputs, made from a seed, go through both packages.  Every
output is an integer, so the tolerance is exact equality.  The TPU
package's extraction returns `size` slots with a validity mask (or, packed,
a prefix of `total` runs); only that valid prefix is compared.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wgatools_tpu.ops import classify as JC
from wgatools_tpu.ops import rle_device as JR
from wgatools_tpu_torch.ops import classify as TC
from wgatools_tpu_torch.ops import rle_device as TR

CPU = torch.device("cpu")
ALPHABET = np.frombuffer(b"ACGTNacgtn-RY-", dtype=np.uint8)

# (lengths, all gap/gap rows): odd B, B = 1, empty rows, gap/gap rows,
# lengths ending mid-word
CASES = [
    ([0, 1, 7, 8, 9, 777, 999, 1000, 1000], (8,)),
    ([17], ()),
    ([300, 0, 129, 256, 3], (3,)),
    ([0], ()),
    ([5000, 4999, 1, 0, 2], (4,)),
]


def _planes(seed, lengths, gg_rows=(), width=None, pad=None):
    """uint8 [B, width] planes + int32 lengths: runs of equal, mismatched
    and gap columns and gap/gap stretches; padding past each length is '-'
    in both rows, or random bytes when pad == "random"."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    L = width if width is not None else max(lengths)
    t = np.full((B, L), ord("-"), np.uint8)
    q = np.full((B, L), ord("-"), np.uint8)
    if pad == "random":
        t[:] = ALPHABET[rng.integers(0, len(ALPHABET), (B, L))]
        q[:] = ALPHABET[rng.integers(0, len(ALPHABET), (B, L))]
    for k, n in enumerate(lengths):
        if k in gg_rows:
            t[k, :n] = q[k, :n] = ord("-")
            continue
        # runs: a category per run, so that runs are longer than a column
        n_runs = max(1, n // 6)
        run_cat = rng.integers(0, 5, n_runs)
        cats = np.repeat(run_cat, rng.integers(1, 12, n_runs))[:n]
        cats = np.pad(cats, (0, n - cats.shape[0]), constant_values=0)
        base = ALPHABET[rng.integers(0, len(ALPHABET), n)]
        tt, qq = base.copy(), base.copy()
        x = cats == 1
        qq[x] = ALPHABET[rng.integers(0, len(ALPHABET), int(x.sum()))]
        tt[cats == 2] = ord("-")
        qq[cats == 3] = ord("-")
        tt[cats == 4] = qq[cats == 4] = ord("-")
        t[k, :n], q[k, :n] = tt, qq
    return t, q, np.asarray(lengths, dtype=np.int32)


def _pow2(n):
    return max(1 << (max(n, 1) - 1).bit_length(), 16)


def _stats(t, q, lens, caller):
    return np.asarray(JC.classify_stat_jnp(t, q, lens, caller=caller))


@pytest.mark.parametrize("caller", [False, True])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_extract_runs_cat_matches_jax(case, caller):
    lengths, gg = CASES[case]
    t, q, ln = _planes(case, lengths, gg, width=-(-max(lengths + [1]) // 8) * 8)
    cw = TC.pack_cat_nibbles(t, q)
    total = int(_stats(t, q, ln, caller)[:, JC.STAT_RUNS].sum())
    want = np.asarray(JR._extract_runs_cat(
        jnp.asarray(cw), jnp.asarray(ln), _pow2(total), caller))[:total]
    got = TR.extract_runs_cat(torch.from_numpy(cw), torch.from_numpy(ln), caller)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("caller", [False, True])
@pytest.mark.parametrize("pad", ["gap", "random"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_extract_runs_matches_jax(case, pad, caller):
    lengths, gg = CASES[case]
    t, q, ln = _planes(10 + case, lengths, gg, width=max(lengths) + 3, pad=pad)
    total = int(_stats(t, q, ln, caller)[:, JC.STAT_RUNS].sum())
    row, cat, run_len, valid = (np.asarray(a) for a in JR._extract_runs(
        jnp.asarray(t), jnp.asarray(q), jnp.asarray(ln), _pow2(total), caller))
    assert int(valid.sum()) == total and valid[:total].all()
    got = TR.extract_runs(torch.from_numpy(t), torch.from_numpy(q),
                          torch.from_numpy(ln), caller)
    for g, w in zip(got, (row, cat, run_len)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w[:total])


def test_extract_runs_cat_refuses_rows_past_the_packed_bound():
    cw = torch.empty((1, TR.PACKED_MAX_COLUMNS // 8), dtype=torch.int32,
                     device="meta")
    with pytest.raises(ValueError, match="2\\^28"):
        TR.extract_runs_cat(cw, torch.zeros(1, dtype=torch.int32, device="meta"))


def _same_runs(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("caller", [False, True])
@pytest.mark.parametrize("route", ["cat", "bytes", "tensor"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_batch_runs_matches_jax(case, route, caller, monkeypatch):
    """Both routes, as the TPU package picks them: a width that is a
    multiple of 8 rides the category plane, any other width (or a tensor
    already on the device) the byte planes."""
    lengths, gg = CASES[case]
    width = -(-max(lengths + [1]) // 8) * 8
    if route != "cat":
        width += 3
    t, q, ln = _planes(20 + case, lengths, gg, width=width,
                       pad="random" if route == "bytes" else None)
    seen = []
    for name in ("classify_stat_cat_ref", "classify_stat_bytes_ref"):
        real = getattr(TC, name)
        monkeypatch.setattr(TC, name, lambda *a, _r=real, _n=name, **k: (
            seen.append(_n), _r(*a, **k))[1])
    want = JR.batch_runs(t, q, ln, caller=caller)
    if route == "tensor":
        got = TR.batch_runs(torch.from_numpy(t), torch.from_numpy(q),
                            torch.from_numpy(ln), CPU, caller)
    else:
        got = TR.batch_runs(t, q, ln, CPU, caller)
    _same_runs(got, want)
    assert seen == ["classify_stat_cat_ref" if route == "cat"
                    else "classify_stat_bytes_ref"]


def test_finish_runs_raises_when_the_counts_disagree():
    t, q, ln = _planes(3, [40, 7], width=48)
    for tt, qq in ((t, q), (t[:, :45], q[:, :45])):  # cat and byte routes
        state = TR.start_runs(np.ascontiguousarray(tt), np.ascontiguousarray(qq),
                              ln, CPU)
        state[3][0, TC.STAT_RUNS] += 1
        with pytest.raises(RuntimeError, match="counted"):
            TR.finish_runs(state)


def test_batch_runs_of_empty_rows_is_empty():
    t = np.full((3, 16), ord("A"), np.uint8)
    for arr in (t, t[:, :13].copy()):
        for got in TR.batch_runs(arr, arr, np.zeros(3, np.int32), CPU):
            assert got.dtype == np.int32 and got.shape == (0,)


@pytest.mark.parametrize("seed", range(3))
def test_split_run_tables_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n_rows = int(rng.integers(1, 9))
    row_ids = np.sort(rng.integers(0, n_rows, 50)).astype(np.int32)
    cats = rng.integers(0, 5, 50).astype(np.int32)
    lens = rng.integers(1, 1000, 50).astype(np.int32)
    got = TR.split_run_tables(n_rows, row_ids, cats, lens)
    want = JR.split_run_tables(n_rows, row_ids, cats, lens)
    assert len(got) == len(want) == n_rows
    for (gv, gl), (wv, wl) in zip(got, want):
        assert gv.dtype == wv.dtype == np.uint8 and gl.dtype == wl.dtype == np.int64
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("caller", [False, True])
@pytest.mark.parametrize("pad", ["gap", "random"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_classify_stat_bytes_ref_matches_jnp(case, pad, caller):
    lengths, gg = CASES[case]
    t, q, ln = _planes(30 + case, lengths, gg, width=max(lengths) + 5, pad=pad)
    got = TC.classify_stat_bytes_ref(torch.from_numpy(t), torch.from_numpy(q),
                                     torch.from_numpy(ln), caller)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _stats(t, q, ln, caller))


@pytest.mark.parametrize("caller", [False, True])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_classify_stat_bytes_ref_matches_pallas(case, caller):
    """The Pallas byte kernel in interpret mode, on its '-'/'-' padding
    contract, with a tile narrower than the rows."""
    lengths, gg = CASES[case]
    t, q, ln = _planes(40 + case, lengths, gg, width=max(lengths) + 1)
    want = JC.classify_stat_pallas(jnp.asarray(t), jnp.asarray(q),
                                   jnp.asarray(ln), tile_l=256, interpret=True,
                                   caller=caller)
    got = TC.classify_stat_bytes_ref(torch.from_numpy(t), torch.from_numpy(q),
                                     torch.from_numpy(ln), caller)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("caller", [False, True])
def test_classify_columns_and_cat_to_std_match_jax(caller):
    t, q, _ = _planes(50, [3000], (), width=3000)
    want = np.asarray(JC._classify(jnp.asarray(t), jnp.asarray(q), caller))
    got = TC.classify_columns(torch.from_numpy(t), torch.from_numpy(q), caller)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    codes = np.arange(16, dtype=np.int32)  # every nibble, LUT-made or not
    np.testing.assert_array_equal(
        TC.cat_to_std(torch.from_numpy(codes), caller).numpy(),
        np.asarray(JC._cat_to_std(jnp.asarray(codes), caller)),
    )
    # the cat plane decodes to the byte classification
    cw = TC.pack_cat_nibbles(t, q)
    np.testing.assert_array_equal(
        TC.cat_to_std(TC._unpack_cats(torch.from_numpy(cw)), caller).numpy(), want
    )


@pytest.mark.parametrize("caller", [False, True])
def test_classify_stat_bytes_wrapper_on_cpu_is_the_plain_version(caller):
    t, q, ln = _planes(60, [500, 3, 0, 64], (1,), width=509, pad="random")
    args = [torch.from_numpy(a) for a in (t, q, ln)]
    assert torch.equal(TC.classify_stat_bytes(*args, caller),
                       TC.classify_stat_bytes_ref(*args, caller))


def test_classify_stat_bytes_wrapper_refuses_a_non_cuda_device():
    t = torch.zeros((2, 5), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        TC.classify_stat_bytes(t, t, torch.zeros(2, dtype=torch.int32,
                                                 device="meta"))


@pytest.mark.parametrize("caller", [False, True])
def test_column_stats_of_device_bytes_matches_jax(caller):
    """Byte tensors already on the device take kernel D's route, as the TPU
    package sends device-resident bytes to its byte kernel."""
    t, q, ln = _planes(70, [1000, 999, 0, 5], (3,), width=1003, pad="random")
    want = np.asarray(JC.column_stats(jnp.asarray(t), jnp.asarray(q), ln,
                                      caller=caller))
    got = TC.column_stats(torch.from_numpy(t), torch.from_numpy(q),
                          torch.from_numpy(ln), CPU, caller)
    np.testing.assert_array_equal(got.numpy(), want)
