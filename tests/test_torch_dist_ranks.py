"""The port's distributed modes at 3 and 4 ranks, with and without a
MAF-index manifest, with giant records split across the ranks, with ranks
that get no work, `pafcov` on targets whose records disagree on their
length, and a rank that fails after the group started.

Ranks are processes of the port's command line on the CPU (gloo), writing
to stdout as users pipe them: rank 0's bytes must equal
wgatools_tpu.cli.main's run serially (pafcov: the TPU package's own
distributed route on two processes), and every other rank writes nothing.
"""

import os
import random
import shutil

import pytest

from dist_ranks import run_port_ranks, run_tpu_ranks
from synth import build_alignment, random_ops
from test_torch_cli import _write_inputs
from wgatools_tpu.cli import main as host_main
from wgatools_tpu_torch.parallel.dist_tools import _giant_indices
from wgatools_tpu_torch.parallel.host_pool import maf_record_offsets


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The CLI tests' inputs, a copy of the MAF beside its MAF index, and a
    MAF of two records."""
    d = str(tmp_path_factory.mktemp("inputs"))
    _write_inputs(d)
    shutil.copy(os.path.join(d, "in.maf"), os.path.join(d, "idx.maf"))
    assert host_main(["maf-index", os.path.join(d, "idx.maf")]) == 0
    with open(os.path.join(d, "in.maf")) as f:
        text = f.read()
    records = text.split("\n\n")
    with open(os.path.join(d, "two.maf"), "w") as f:
        f.write("\n\n".join(records[:2]) + "\n\n")
    return d


def _serial(argv, tmp_path, monkeypatch):
    monkeypatch.delenv("WGA_TPU_DIST", raising=False)
    out = tmp_path / "serial.out"
    assert host_main(argv + ["-o", str(out)]) == 0
    return out.read_bytes()


def _check_ranks(ranks, want):
    for rank in ranks:
        assert rank["rc"] == 0, rank["stderr"]
        assert rank["imported"] == []
    assert ranks[0]["stdout"] == want
    assert all(rank["stdout"] == b"" for rank in ranks[1:])
    assert want


@pytest.mark.parametrize("maf", ["in.maf", "idx.maf"],
                         ids=["scan", "manifest"])
@pytest.mark.parametrize("n", [3, 4])
@pytest.mark.parametrize("mode", [["stat"], ["call", "-s"]],
                         ids=["stat", "call"])
def test_stat_and_call_on_n_ranks(mode, n, maf, inputs, tmp_path,
                                  monkeypatch):
    argv = [mode[0], os.path.join(inputs, maf), *mode[1:]]
    ranks = run_port_ranks(argv + ["-v"], n, str(tmp_path))
    _check_ranks(ranks, _serial(argv, tmp_path, monkeypatch))
    for pid, rank in enumerate(ranks):  # the init line names the backend
        assert (f"process {pid}/{n} via 127.0.0.1:" in rank["stderr"]
                and "backend gloo" in rank["stderr"])


# records of at least this many bytes are column-split over the ranks;
# in.maf's records take 400-1400 bytes
GIANT_SPLIT = 800


@pytest.mark.parametrize("tool", ["maf2paf", "maf2chain"])
def test_giant_records_split_over_three_ranks(tool, inputs, tmp_path,
                                              monkeypatch):
    path = os.path.join(inputs, "in.maf")
    giants = _giant_indices(path, maf_record_offsets(path), GIANT_SPLIT)
    assert 0 < len(giants) < 9  # giant and normal records both
    ranks = run_port_ranks([tool, path], 3, str(tmp_path),
                           env={"WGA_TPU_GIANT_SPLIT": str(GIANT_SPLIT)})
    _check_ranks(ranks, _serial([tool, path], tmp_path, monkeypatch))


@pytest.mark.parametrize("mode", [["stat"], ["call", "-s"], ["maf2chain"]],
                         ids=lambda m: m[0])
def test_four_ranks_on_two_records(mode, inputs, tmp_path, monkeypatch):
    """Ranks 2 and 3 claim no record and still take part in every
    collective."""
    argv = [mode[0], os.path.join(inputs, "two.maf"), *mode[1:]]
    ranks = run_port_ranks(argv, 4, str(tmp_path))
    _check_ranks(ranks, _serial(argv, tmp_path, monkeypatch))


def test_pafcov_with_disagreeing_target_lengths_matches_the_tpu_route(
        tmp_path):
    """Records of one target state different target lengths: the ranks
    agree on the largest, as the TPU package's distributed route does (the
    serial tool takes the first)."""
    rng = random.Random(11)
    rows = []
    for i in range(16):
        t, q = build_alignment(rng, random_ops(rng, rng.randint(2, 9)))
        t_len, q_len = len(t) - t.count("-"), len(q) - q.count("-")
        cigar, last, n = [], None, 0
        for tc, qc in zip(t, q):
            op = "I" if tc == "-" else "D" if qc == "-" else "M"
            if op != last and n:
                cigar.append(f"{n}{last}")
                n = 0
            last, n = op, n + 1
        cigar.append(f"{n}{last}")
        start = 3 * i
        length = 400 + 37 * (i % 5)  # five lengths per target
        rows.append(f"q{i}\t{q_len + 9}\t0\t{q_len}\t+\tt{i % 2}\t{length}\t"
                    f"{start}\t{start + t_len}\t{t_len}\t{len(t)}\t60\t"
                    f"cg:Z:{''.join(cigar)}")
    paf = tmp_path / "lengths.paf"
    paf.write_text("\n".join(rows) + "\n")
    want = run_tpu_ranks(["pafcov", str(paf)], 2, str(tmp_path))
    for rc, _, err in want:
        assert rc == 0, err.decode()
    ranks = run_port_ranks(["pafcov", str(paf)], 2, str(tmp_path))
    _check_ranks(ranks, want[0][1])
    assert want[1][1] == b""


def test_a_failing_rank_ends_every_rank(inputs, tmp_path):
    """Rank 1 raises after joining the group, before the first merge: it
    exits non-zero, and so do the ranks waiting for it in the collective,
    within the rank set's timeout."""
    path = os.path.join(inputs, "in.maf")
    ranks = run_port_ranks(["maf2paf", path], 3, str(tmp_path),
                           rank_env={1: {"WGA_TPU_GIANT_SPLIT": "not a size"}})
    assert "not a size" in ranks[1]["stderr"]
    assert all(rank["rc"] not in (0, None) for rank in ranks)
    assert all(rank["stdout"] == b"" for rank in ranks)
