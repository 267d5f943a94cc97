"""The generator writes what its configuration states: the same bytes for
the same seed (a large one among them), the same block sizes for every
seed, and the published divergence (substitutions at 1.23% of aligned
columns, indel events at 0.176%, single-base X runs)."""

import re
from collections import Counter

import numpy as np
import pytest

import harness

GEN = harness.load_part("gen", "pairwise")


def _cigars(path):
    text = path.read_text()
    return [line.rsplit("cg:Z:", 1)[1] for line in text.splitlines()]


@pytest.mark.parametrize("fmt", ["paf", "maf"])
def test_a_function_of_the_seed(tmp_path, fmt):
    kw = dict(fmt=fmt, columns=600_000, block_max=60_000)
    a = GEN.generate(tmp_path / "a", 2**32 + 3, **kw)
    b = GEN.generate(tmp_path / "b", 2**32 + 3, **kw)
    assert a == b and a["aligned_columns"] == 600_000
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()
    GEN.generate(tmp_path / "c", 2**32 + 4, **kw)
    assert (tmp_path / "a").read_bytes() != (tmp_path / "c").read_bytes()


def test_every_seed_has_the_same_block_sizes():
    a = GEN.block_lengths(np.random.default_rng(1), 10_000_000, 300, 30_000)
    b = GEN.block_lengths(np.random.default_rng(2**33), 10_000_000, 300, 30_000)
    assert a.sum() == b.sum() == 10_000_000
    assert sorted(a) == sorted(b) and list(a) != list(b)
    assert 1_000 < np.median(a) < 5_000 and a.min() >= 300


@pytest.mark.parametrize("seed", [11, 2**31 + 11])
def test_published_divergence(tmp_path, seed):
    counts = GEN.generate(tmp_path / "a.paf", seed, columns=4_000_000,
                          block_max=400_000)
    ops = [(int(n), o) for c in _cigars(tmp_path / "a.paf")
           for n, o in re.findall(r"(\d+)([=XID])", c)]
    assert counts["cigar_ops"] == len(ops)
    cols = Counter()
    events = Counter()
    for n, o in ops:
        cols[o] += n
        events[o] += 1
    assert sum(cols.values()) == 4_000_000
    aligned = cols["="] + cols["X"]
    assert cols["X"] / aligned == pytest.approx(0.0123, rel=0.05)
    assert (events["I"] + events["D"]) / aligned == pytest.approx(0.00176, rel=0.1)
    x_runs = [n for n, o in ops if o == "X"]
    assert np.mean(np.array(x_runs) == 1) > 0.98
    for c in _cigars(tmp_path / "a.paf"):
        runs = re.findall(r"\d+([=XID])", c)
        assert runs[0] == runs[-1] == "="
        assert all(a != b for a, b in zip(runs, runs[1:]))


def test_maf_rows_agree_with_their_fields(tmp_path):
    GEN.generate(tmp_path / "a.maf", 5, fmt="maf", columns=200_000, block_min=300,
                 block_max=30_000, minus_every=2)
    blocks = [b for b in (tmp_path / "a.maf").read_text().split("\n\n") if "s " in b]
    assert {l.split()[4] for b in blocks for l in b.splitlines()[2:]} == {"+", "-"}
    for b in blocks:
        (_, t), (_, q) = [(None, l.split()) for l in b.splitlines() if l.startswith("s ")]
        assert len(t[6]) == len(q[6])
        assert int(t[3]) == len(t[6]) - t[6].count("-")
        assert int(q[3]) == len(q[6]) - q[6].count("-")
        assert int(q[2]) + int(q[3]) <= int(q[5])
