"""The port's PAF and chain device tools on the CPU (WGA_TORCH_DEVICE=cpu
semantics: CPU tensors take the plain versions): the segment sums and the
coverage and chain tables against wgatools_tpu.ops, and `pafcov`,
`validate` (with --fix), `stat -f paf` (with -e) and `chain2paf` against
the TPU package's device path and host engine, with flush batches small
enough that every tool flushes several times, the int32 host routes and
the error position of an invalid op.  Exact equality throughout.
"""

import io
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from synth import random_ops
from wgatools_tpu.errors import CigarOpInvalid
from wgatools_tpu.io.chain import ChainReader
from wgatools_tpu.io.paf import PafReader, parse_paf_line
from wgatools_tpu.ops import coverage as jax_coverage
from wgatools_tpu.ops import liftover as jax_liftover
from wgatools_tpu.ops import segments as jax_segments
from wgatools_tpu.tools import convert as jax_convert
from wgatools_tpu.tools import pafcov as jax_pafcov
from wgatools_tpu.tools import stat as jax_stat
from wgatools_tpu.tools import validate as jax_validate
from wgatools_tpu_torch.ops import coverage as T_coverage
from wgatools_tpu_torch.ops import liftover as T_liftover
from wgatools_tpu_torch.ops import segments as T_segments
from wgatools_tpu_torch.tools import convert as T_convert
from wgatools_tpu_torch.tools import pafcov as T_pafcov
from wgatools_tpu_torch.tools import stat as T_stat
from wgatools_tpu_torch.tools import validate as T_validate

CPU = torch.device("cpu")


def paf_bytes(seed, n=40, n_targets=3, t_len=3000, corrupt=False):
    """n PAF rows of random =/X/I/D CIGARs (synth.random_ops) on n_targets
    targets of t_len bases, every 4th on '-'.  With corrupt, every 7th
    row's query end is one past its CIGAR's and every 11th row's target
    end one short."""
    rng = random.Random(seed)
    rows = []
    for i in range(n):
        ops = random_ops(rng, rng.randint(1, 14), lead_trail_indel=i % 5 == 0)
        cg = "".join(f"{ln}{op}" for op, ln in ops)
        q_span = sum(ln for op, ln in ops if op in "=XI")
        t_span = sum(ln for op, ln in ops if op in "=XD")
        m = sum(ln for op, ln in ops if op == "=")
        ts, qs = rng.randint(0, t_len // 2), rng.randint(0, 50)
        qe, te = qs + q_span, ts + t_span
        if corrupt:
            qe += i % 7 == 0
            te -= i % 11 == 0
        rows.append(
            f"q{i % 5}\t{q_span + 100}\t{qs}\t{qe}\t{'-+'[i % 4 != 0]}\t"
            f"t{i % n_targets}\t{t_len}\t{ts}\t{te}\t{m}\t"
            f"{max(q_span, t_span)}\t60\tcg:Z:{cg}"
        )
    return ("\n".join(rows) + "\n").encode()


def _reader(data):
    return PafReader(io.BytesIO(data))


def _run(fn, *args, **kw):
    out = io.BytesIO()
    fn(*args[:1], out, *args[1:], **kw)
    return out.getvalue()


# -- ops ------------------------------------------------------------------


def _op_batch(rng, n_records, max_ops, op_bytes=b"M=XID"):
    chars = np.frombuffer(op_bytes, np.uint8)
    op_arrays = [chars[rng.integers(0, len(chars), int(rng.integers(0, max_ops)))]
                 for _ in range(n_records)]
    len_arrays = [rng.integers(0, 70000, len(o)).astype(np.int32)
                  for o in op_arrays]
    return op_arrays, len_arrays


@pytest.mark.parametrize("seed", range(3))
def test_cigar_batch_stats_matches_jax(seed):
    rng = np.random.default_rng(seed)
    op_arrays, len_arrays = _op_batch(rng, 17, 90)
    want_flat = jax_segments.pack_cigar_batch(op_arrays, len_arrays)
    flat = T_segments.pack_cigar_batch(op_arrays, len_arrays)
    for a, b in zip(flat, want_flat):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    want = jax_segments.cigar_batch_stats(*want_flat, 17)
    got = T_segments.cigar_batch_stats(
        *(torch.from_numpy(a) for a in flat), 17)
    assert got.dtype == torch.int32 and got.shape == (17, T_segments.N_SEG_STATS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (T_segments.SEG_MATCHED, T_segments.SEG_DEL_EVENT) == (
        jax_segments.SEG_MATCHED, jax_segments.SEG_DEL_EVENT)


def test_segment_helpers_empty_and_invalid_ops():
    for a, b in zip(T_segments.pack_cigar_batch([], []),
                    jax_segments.pack_cigar_batch([], [])):
        assert a.dtype == b.dtype and a.shape == b.shape == (0,)
    for bad in (b"MMS=", b"5H", b"IDN"):
        ops = np.frombuffer(bad, np.uint8)
        with pytest.raises(CigarOpInvalid) as got:
            T_segments.assert_stat_ops(ops)
        with pytest.raises(CigarOpInvalid) as want:
            jax_segments.assert_stat_ops(ops)
        assert str(got.value) == str(want.value)
        with pytest.raises(CigarOpInvalid):
            T_segments.pack_cigar_batch([np.frombuffer(b"M", np.uint8), ops],
                                        [np.ones(1, np.int32),
                                         np.ones(len(ops), np.int32)])
    T_segments.assert_stat_ops(np.frombuffer(b"M=XID", np.uint8))


@pytest.mark.parametrize("seed", range(3))
def test_coverage_and_chain_tables_match_jax(seed):
    rng = np.random.default_rng(seed + 10)
    op_arrays, len_arrays = _op_batch(rng, 9, 200, b"M=XIDSNH")
    ops, lens = T_liftover.pack_ops_batch(op_arrays, len_arrays)
    starts = rng.integers(0, 5000, 9).astype(np.int32)
    want = jax_liftover.coverage_span_table(
        jnp.asarray(ops), jnp.asarray(lens), jnp.asarray(starts), wide=True)
    got = T_liftover.coverage_span_table(
        *(torch.from_numpy(a) for a in (ops, lens, starts)))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for genome_len in (1000, 3_000_000):
        np.testing.assert_array_equal(
            T_liftover.spans_to_coverage(*got, genome_len).numpy(),
            np.asarray(jax_liftover.spans_to_coverage(*want, genome_len)))
    want_i, want_d = jax_liftover.chain_advance_table(ops, lens, wide=True)
    got_i, got_d = T_liftover.chain_advance_table(
        torch.from_numpy(ops), torch.from_numpy(lens))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


def test_scatter_spans_matches_jax():
    """Spans past either end clip to [0, n]; without a mask every span
    counts, as in the TPU package's scatter_spans."""
    rng = np.random.default_rng(4)
    n = 500
    starts = rng.integers(-50, n + 50, 300).astype(np.int32)
    ends = starts + rng.integers(0, 80, 300).astype(np.int32)
    want = jax_coverage.scatter_spans(jnp.zeros(n + 1, jnp.int32),
                                      jnp.asarray(starts), jnp.asarray(ends))
    diff = torch.zeros(n + 1, dtype=torch.int32)
    got = T_coverage.scatter_spans(diff, torch.from_numpy(starts),
                                   torch.from_numpy(ends))
    assert got is diff  # in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        T_coverage.diff_to_coverage(got).numpy(),
        np.asarray(jax_coverage.diff_to_coverage(want)))


# -- tools ----------------------------------------------------------------


@pytest.mark.parametrize("batch_ops", [16, 1 << 20])
def test_pafcov_matches_jax_device_and_host(batch_ops):
    data = paf_bytes(1)
    host = _run(jax_pafcov.pafcov, _reader(data), device=False)
    jax_dev = _run(jax_pafcov._pafcov_device, _reader(data),
                   batch_ops=batch_ops)
    got = _run(T_pafcov._pafcov_device, _reader(data), CPU,
               batch_ops=batch_ops)
    assert got == jax_dev == host
    assert got.count(b"\n") == 3 * 3000
    assert _run(T_pafcov.pafcov, _reader(data), CPU) == host


def _small_batches(monkeypatch, batch_ops):
    """Run the port's validate and stat -f paf with `batch_ops`-op
    batches: several flushes on the small inputs."""
    real = T_validate.stream_batch_stats

    def stream(records, device):
        return real(records, device, batch_ops)

    monkeypatch.setattr(T_validate, "stream_batch_stats", stream)
    monkeypatch.setattr(T_stat, "stream_batch_stats", stream)


@pytest.mark.parametrize("batch_ops", [16, 1 << 20])
def test_validate_and_fix_match_jax_device_and_host(batch_ops, monkeypatch):
    data = paf_bytes(2, n=60, corrupt=True)
    _small_batches(monkeypatch, batch_ops)
    outs = []
    for fn, kw in ((jax_validate.validate_paf, dict(device=False)),
                   (jax_validate.validate_paf, dict(device=True)),
                   (T_validate.validate_paf, dict(device=CPU))):
        report, fixed = io.BytesIO(), io.BytesIO()
        fn(_reader(data), report, fixed, True, **kw)
        plain = io.BytesIO()
        fn(_reader(data), plain, None, False, **kw)
        assert plain.getvalue() == report.getvalue()
        outs.append((report.getvalue(), fixed.getvalue()))
    assert outs[2] == outs[1] == outs[0]
    report, fixed = outs[0]
    assert b"Query invalid records: 9\n" in report
    assert b"Target invalid records: 6\n" in report
    # the fixed PAF validates clean
    again = io.BytesIO()
    T_validate.validate_paf(_reader(fixed), again, None, False, CPU)
    assert b"Query invalid records: 0\nTarget invalid records: 0" in again.getvalue()


@pytest.mark.parametrize("batch_ops", [16, 1 << 20])
@pytest.mark.parametrize("each", [False, True])
def test_stat_paf_matches_jax_device_and_host(each, batch_ops, monkeypatch):
    data = paf_bytes(3, n=50)
    _small_batches(monkeypatch, batch_ops)
    host = _run(jax_stat.stat_paf, _reader(data), each, device=False)
    jax_dev = _run(jax_stat.stat_paf, _reader(data), each, device=True)
    got = _run(T_stat.stat_paf, _reader(data), CPU, each)
    assert got == jax_dev == host
    assert got


def _chain_bytes(paf):
    out = io.BytesIO()
    jax_convert.paf2chain(_reader(paf), out, device=False)
    return out.getvalue()


@pytest.mark.parametrize("batch_lines", [4, 1 << 20])
def test_chain2paf_matches_jax_device_and_host(batch_lines):
    chain = _chain_bytes(paf_bytes(4, n=30))
    host = _run(jax_convert.chain2paf, ChainReader(io.BytesIO(chain)),
                device=False)
    jax_dev = _run(jax_convert._chain2paf_device,
                   ChainReader(io.BytesIO(chain)), batch_lines=batch_lines,
                   min_lines=0)
    got = _run(T_convert._chain2paf_device, ChainReader(io.BytesIO(chain)),
               CPU, batch_lines=batch_lines, min_lines=0)
    assert got == jax_dev == host
    assert got.count(b"\n") == 30
    # the default DEVICE_MIN_OPS answers this small input on the host
    assert _run(T_convert.chain2paf, ChainReader(io.BytesIO(chain)), CPU) == host


# -- int32 host routes and the error position -------------------------------


def _overflow_paf():
    """Rows 1 and 3 sum their op lengths to 2^31 or more (3 exactly at the
    boundary)."""
    def row(i, cg, q_span, t_span, strand="+"):
        return (f"q{i}\t{q_span + 10}\t0\t{q_span}\t{strand}\tt0\t5000\t0\t"
                f"{t_span}\t{t_span}\t{t_span}\t255\tcg:Z:{cg}")
    return ("\n".join([
        row(0, "10M2I3D", 12, 13),
        row(1, "1500000000I900000000I5M", 2400000005, 5),
        row(2, "4M1X2M", 7, 7, strand="-"),
        row(3, f"{2**31 - 1}I1M", 2**31, 1),
        row(4, "7=3X", 10, 10),
    ]) + "\n").encode()


def test_stream_batch_stats_overflow_host_route():
    """Records whose op lengths reach 2^31 take the int64 host engine, in
    order, as in tests/test_int32_overflow.py."""
    data = _overflow_paf()
    host = [(r.query_name, r.get_stat()) for r in _reader(data).records()]
    got = [(r.query_name, rs) for r, rs in
           T_validate.stream_batch_stats(_reader(data).records(), CPU, 4)]
    assert got == host
    assert got[1][1].ins_size == 2400000000
    assert got[3][1].ins_size == 2**31 - 1
    assert _run(T_stat.stat_paf, _reader(data), CPU, True) == _run(
        jax_stat.stat_paf, _reader(data), True, device=False)


def test_pafcov_overflow_record_host_route():
    """Rows whose op lengths reach 2^31 take the int64 host spans and are
    added to the device counts of their target at the end."""
    data = _overflow_paf() + paf_bytes(5, n=12, n_targets=2, t_len=5000)
    host = _run(jax_pafcov.pafcov, _reader(data), device=False)
    got = _run(T_pafcov._pafcov_device, _reader(data), CPU, batch_ops=8)
    assert got == _run(jax_pafcov._pafcov_device, _reader(data)) == host


def test_chain2paf_overflow_record_host_route():
    huge = ("qh\t4294967296\t0\t2147483650\t+\tth\t4294967296\t0\t2147483649"
            "\t2147483648\t2147483650\t255\tcg:Z:2147483648=1X1I")
    chain = _chain_bytes(paf_bytes(6, n=5) + (huge + "\n").encode()
                         + paf_bytes(7, n=5))
    host = _run(jax_convert.chain2paf, ChainReader(io.BytesIO(chain)),
                device=False)
    got = _run(T_convert._chain2paf_device, ChainReader(io.BytesIO(chain)),
               CPU, min_lines=0)
    assert got == host
    assert got.count(b"\n") == 11 and b"cg:Z:2147483649M\n" in got


def test_invalid_op_raises_after_earlier_records():
    """An op outside {M,=,X,I,D} raises CigarOpInvalid at its record, with
    every earlier record already yielded, as the host engine does
    (tests/test_parser_robustness.py)."""
    bad = "q\t20\t0\t10\t+\tt\t20\t0\t10\t10\t10\t60\tcg:Z:5=5S"
    with pytest.raises(CigarOpInvalid):
        parse_paf_line(bad).get_stat()
    data = paf_bytes(8, n=6) + (bad + "\n").encode() + paf_bytes(9, n=3)
    seen = []
    with pytest.raises(CigarOpInvalid):
        for rec, rs in T_validate.stream_batch_stats(_reader(data).records(),
                                                     CPU, 1 << 20):
            seen.append((rec.query_name, rs))
    host = [(r.query_name, r.get_stat()) for r in
            list(_reader(data).records())[:6]]
    assert seen == host
    with pytest.raises(CigarOpInvalid):
        list(T_validate.stream_batch_stats([parse_paf_line(bad)], CPU))
