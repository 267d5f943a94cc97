"""stat's columnar fold (tools.stat.StatFold over ops.batch.stream_stat_rows
and rec_stat_columns) against the TPU package's per-record merge_final:
the same table bytes for the same per-record stats, whatever the keys,
strands, starts and batch boundaries; and stat_maf's bytes and counters
on the CPU device.
"""

import io
from dataclasses import astuple

import numpy as np
import pytest
import torch

from wgatools_tpu.core.cigar import cigar_from_seqs as jax_cigar_from_seqs
from wgatools_tpu.core.cigar import rec_stat_from_cigar as jax_rec_stat
from wgatools_tpu.io.maf import MafReader as JMafReader
from wgatools_tpu.ops import batch as jax_batch
from wgatools_tpu.tools import stat as jax_stat
from wgatools_tpu_torch.core.cigar import rec_stat_from_cigar
from wgatools_tpu_torch.core.metrics import METRICS
from wgatools_tpu_torch.io.compression import open_input
from wgatools_tpu_torch.io.maf import MafReader
from wgatools_tpu_torch.ops import batch
from wgatools_tpu_torch.tools import stat as stat_tool

CPU = torch.device("cpu")
KEYS = [("ref.chr2", 5_000_000, "q1.chr2", 4_000_000),
        ("ref.chr10", 9_000_000, "q1.chr10", 8_000_000),
        ("ref.chr1", 7_000_000, "q2.chr1", 7_000_000),
        ("ref.chr1", 7_000_000, "q3.chr1", 6_000_000)]
ALPHABET = np.frombuffer(b"ACGT-", np.uint8)


def _cut(rng, n, most):
    """Random batch sizes of 1 to `most` that add up to n."""
    sizes = []
    while n > 0:
        sizes.append(min(n, int(rng.integers(1, most + 1))))
        n -= sizes[-1]
    return sizes


def _counter_batches(rng, n, key_of, counts, starts=None, most=7):
    """Synthetic device batches of 1 to `most` records: (metas, int64
    [B, 8] counters, negative) of n records, record k keyed
    KEYS[key_of(k)], every third on the minus strand, starts drawn at
    random (not monotone) unless given."""
    keys = [KEYS[key_of(k)] for k in range(n)]
    if starts is None:
        starts = [(int(rng.integers(0, key[1])), int(rng.integers(0, key[3])))
                  for key in keys]
    metas = [key + start for key, start in zip(keys, starts)]
    counters = counts(rng, n)
    negative = (np.arange(n) % 3 == 1) ^ (rng.random(n) < 0.2)
    out, lo = [], 0
    for size in _cut(rng, n, most):
        out.append((metas[lo : lo + size], counters[lo : lo + size],
                    negative[lo : lo + size]))
        lo += size
    return out


def _small(rng, n):
    return rng.integers(0, 5000, (n, 8)).astype(np.int64)


def _interleaved(rng):
    # keys that interleave and come back after others, batches cut inside
    # every group
    pattern = [0, 1, 0, 2, 3, 1, 1, 0, 3, 2, 2, 0, 1, 3]
    return _counter_batches(rng, 60, lambda k: pattern[k % len(pattern)],
                            _small)


def _inv_past_2p24(rng):
    # a group whose float32 inv_size runs past 2^24, where float32's
    # spacing is 2 and the order of rounding shows: odd column sums give
    # half-integer inv_sizes; batches long enough that a pairwise sum
    # would take another order than the records'
    def counts(rng, n):
        c = _small(rng, n)
        c[:, batch.STAT_MATCHED] = rng.integers(200_000, 600_000, n)
        c[:, batch.STAT_INS_SIZE] = rng.integers(0, 1000, n) * 2 + 1
        c[:, batch.STAT_DEL_SIZE] = rng.integers(0, 1000, n) * 2
        return c
    return _counter_batches(rng, 200, lambda k: int(k % 5 != 4), counts,
                            most=80)


def _starts_past_int64(rng):
    # malformed blocks: starts past the sizes (the least start of a group
    # counts from its size down), and forward starts below -2^63, Python
    # ints, as the reference's u64 arithmetic and the TPU package keep them
    starts = [(10**7 + k if k % 2 == 0 else k,
               -(2**64) + k if k % 4 == 1 else 10**7 + k) for k in range(12)]
    return _counter_batches(rng, 12, lambda k: k % 2, _small, starts)


def _stream_items(rng, n):
    """(t, q, negative, meta) items of real rows, keys interleaved."""
    items = []
    for k in range(n):
        cols = int(rng.integers(50, 4000))
        t = ALPHABET[rng.integers(0, 5, cols)].tobytes()
        q = ALPHABET[rng.integers(0, 5, cols)].tobytes()
        key = KEYS[(k * 7) % 4 if k % 5 else 0]
        items.append((t, q, bool(rng.random() < 0.4),
                      key + (int(rng.integers(0, 10**6)),
                             int(rng.integers(0, 10**6)))))
    return items


def _stream_with_alone(rng, monkeypatch):
    # device batches with one-row batches of the int64 host engine between
    # them (records of 3000 columns or more), in input order
    monkeypatch.setattr(batch, "INT32_SAFE_COLUMNS", 3000)
    items = _stream_items(rng, 23)
    batches = list(batch.stream_stat_rows(iter(items), CPU, 6000))
    assert any(len(m) == 1 for m, _, _ in batches)
    assert [m for ms, _, _ in batches for m in ms] == [it[3] for it in items]
    return batches, items


CASES = {
    "interleaved_keys": _interleaved,
    "inv_size_past_2p24": _inv_past_2p24,
    "starts_past_int64": _starts_past_int64,
    "stream_with_alone": None,
    "empty": lambda rng: [],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fold_matches_jax_merge(case, monkeypatch):
    """The fold's table (stat_maf's device route: rec_stat_columns of each
    batch into StatFold, then write_final) equals the TPU package's
    merge_final and write over the same per-record stats; merge_final,
    the fold's adapter for RecStats, writes it too."""
    rng = np.random.default_rng(sorted(CASES).index(case) + 31)
    monkeypatch.setattr(METRICS, "counts", {})
    if case == "stream_with_alone":
        batches, items = _stream_with_alone(rng, monkeypatch)
        # the TPU package's host engine, record by record
        want_stats = [jax_rec_stat(jax_cigar_from_seqs(
            np.frombuffer(t, np.uint8), np.frombuffer(q, np.uint8), neg))
            for t, q, neg, _ in items]
    else:
        batches = CASES[case](rng)
        want_stats = [jax_rec_stat(jax_batch.stats_row_to_cigar(row, neg))
                      for _, counters, negative in batches
                      for row, neg in zip(counters, negative.tolist())]
    metas = [m for ms, _, _ in batches for m in ms]
    want = io.BytesIO()
    jax_stat.write_style_result(
        [jax_stat.PairStat(*m, rec_stat=rs) for m, rs in zip(metas, want_stats)],
        want, False)

    fold = stat_tool.StatFold()
    for ms, counters, negative in batches:
        fold.add(ms, *batch.rec_stat_columns(counters, negative))
    got = io.BytesIO()
    stat_tool.write_final(fold.rows(), got)
    assert got.getvalue() == want.getvalue()
    assert METRICS.counts.get("stat_fold_rows", 0) == len(metas)

    port_stats = [stat_tool.PairStat(*m, rec_stat=rec_stat_from_cigar(
        batch.stats_row_to_cigar(row, neg)))
        for ms, counters, negative in batches
        for m, row, neg in zip(ms, counters, negative.tolist())]
    assert [astuple(p.rec_stat) for p in port_stats] == [
        astuple(rs) for rs in want_stats]
    adapted = io.BytesIO()
    stat_tool.write_final(stat_tool.merge_final(port_stats), adapted)
    assert adapted.getvalue() == want.getvalue()

    if case == "inv_size_past_2p24":
        # the case bites: numpy's pairwise float32 sum gives another total
        inv = batch.rec_stat_columns(
            *(np.concatenate(a) for a in zip(*((c, n) for _, c, n in batches)))
        )[1]
        group = inv[np.array([m[:4] == KEYS[1] for m in metas])]
        seq = np.add.accumulate(group)[-1]
        assert seq > 2**24
        assert seq != np.sum(group)


def _maf(rng, n):
    """MAF text of n pairwise blocks over KEYS, keys interleaved, every
    fourth query on the minus strand."""
    out = [b"##maf version=1\n"]
    for k in range(n):
        t_name, t_size, q_name, q_size = KEYS[(k * 3) % 4]
        cols = int(rng.integers(100, 900))
        t = ALPHABET[rng.integers(0, 5, cols)]
        q = ALPHABET[rng.integers(0, 5, cols)]
        strand = b"-" if k % 4 == 3 else b"+"
        out.append(b"a score=0\n")
        for name, start, seq, st, size in (
                (t_name, 1000 + 10 * k, t, b"+", t_size),
                (q_name, 5000 - 10 * k, q, strand, q_size)):
            out.append(b"s %s %d %d %s %d %s\n" % (
                name.encode(), start, int((seq != 45).sum()), st, size,
                seq.tobytes()))
        out.append(b"\n")
    return b"".join(out)


@pytest.mark.parametrize("route", ["mapped", "reader", "head"])
@pytest.mark.parametrize("each", [False, True], ids=["merge", "each"])
def test_stat_maf_bytes_and_counters(each, route, tmp_path, monkeypatch):
    """stat_maf on the CPU device writes the TPU package's host-engine
    bytes, in merge mode and with --each, through the mapping, through
    MafReader and in the head's host answer.  Merge mode on the device
    folds every block as an array row and builds no RecStat
    (stat_record_rows absent); --each and the head go through per-record
    RecStats, and the head's merge folds them through merge_final."""
    data = _maf(np.random.default_rng(7), 30)
    path = tmp_path / "in.maf"
    path.write_bytes(data)
    want = io.BytesIO()
    jax_stat.stat_maf(JMafReader(io.BytesIO(data)), want, each, device=False)
    monkeypatch.setattr(METRICS, "counts", {})
    if route == "reader":
        monkeypatch.setattr(stat_tool, "map_reader", lambda reader: None)
    got = io.BytesIO()
    stat_tool.stat_maf(MafReader(open_input(str(path))), got, CPU, each,
                       force_device=route != "head", batch_columns=3000)
    assert got.getvalue() == want.getvalue()
    counts = METRICS.counts
    n = 30
    if route == "head":
        assert counts.get("stat_record_rows") == n
        assert counts.get("stat_fold_rows", 0) == (0 if each else n)
    elif each:
        assert counts.get("stat_record_rows") == n
        assert "stat_fold_rows" not in counts
    else:
        assert counts.get("stat_fold_rows") == n
        assert "stat_record_rows" not in counts
    assert ("native_scan_blocks" in counts) == (route != "reader")
