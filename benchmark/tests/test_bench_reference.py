"""The plain references write what the program's host engine
(`device=None`) writes on small generated inputs, and their controls do
not: the control fails the comparison that decides `correct`."""

import io

import pytest

import harness
from wgatools_tpu_torch.io.maf import MafReader
from wgatools_tpu_torch.io.paf import PafReader
from wgatools_tpu_torch.tools.convert import paf2chain
from wgatools_tpu_torch.tools.stat import stat_maf


def _host(tool, reader_cls, path):
    out = io.BytesIO()
    with open(path, "rb") as f:
        tool(reader_cls(f), out, None)
    return out.getvalue()


def _paf(tmp_path, seed):
    path = tmp_path / "in.paf"
    harness.load_part("gen", "pairwise").generate(
        path, seed, fmt="paf", columns=3_000_000, block_max=300_000, minus_every=3)
    return path


def _maf(tmp_path, seed):
    path = tmp_path / "in.maf"
    harness.load_part("gen", "pairwise").generate(
        path, seed, fmt="maf", columns=400_000, block_min=300, block_max=30_000,
        minus_every=3)
    return path


@pytest.mark.parametrize("seed", [3, 2**32 + 1])
def test_paf2chain(tmp_path, seed):
    path = _paf(tmp_path, seed)
    ref = harness.load_part("reference", "paf2chain")
    assert ref.answer(path) == _host(paf2chain, PafReader, path)


@pytest.mark.parametrize("seed", [3, 2**32 + 1])
def test_stat(tmp_path, seed):
    path = _maf(tmp_path, seed)
    ref = harness.load_part("reference", "stat")
    assert ref.answer(path) == _host(stat_maf, MafReader, path)


def test_paf2chain_negative_strand_and_trims(tmp_path):
    path = tmp_path / "neg.paf"
    path.write_text(
        "q1\t100\t10\t60\t-\tt1\t200\t5\t60\t40\t55\t60\tcg:Z:3I20=1X2D20=5X4I3D\n"
        "q2\t100\t0\t30\t+\tt2\t90\t1\t29\t20\t30\t60\tcg:Z:2D10=3I15=\n")
    ref = harness.load_part("reference", "paf2chain")
    assert ref.answer(path) == _host(paf2chain, PafReader, path)


def test_stat_negative_strand(tmp_path):
    path = tmp_path / "neg.maf"
    path.write_text(
        "##maf version=1\na score=0\ns\tchr2\t10\t9\t+\t100\tAC-GTTA-CA\n"
        "s\tq9\t5\t9\t-\t50\tAGTG-TACCA\n\n"
        "a score=0\ns\tchr10\t3\t6\t+\t80\tACGTTA\ns\tq9\t1\t6\t+\t50\tACGATA\n\n")
    ref = harness.load_part("reference", "stat")
    assert ref.answer(path) == _host(stat_maf, MafReader, path)


@pytest.mark.parametrize("tool,make", [("paf2chain", _paf), ("stat", _maf)])
@pytest.mark.parametrize("seed", [5, 6, 2**31 + 3])
def test_control_is_not_correct(tmp_path, tool, make, seed):
    path = make(tmp_path, seed)
    ref = harness.load_part("reference", tool)
    equal, lines = harness.compare(ref.answer(path), ref.answer(path, control=True))
    assert not equal and lines > 0
