"""wgatools_tpu_torch.scripts.scale_configs (and its corpus generator)
against the TPU repo's scripts/scale_configs.py and scripts/make_corpus.py.

The port's corpus copy must write scripts/make_corpus.py's bytes (the
script run unedited); the program at a tiny size under WGA_TORCH_DEVICE=cpu
must pass every md5 cross-check (`-t 4` and 2 gloo ranks against serial),
and its serial rows' md5s must be those of `python -m wgatools_tpu` on the
same corpus.
"""

import hashlib
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from wgatools_tpu_torch.scripts import make_corpus, scale_configs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--maf-records", "4", "--maf-cols", "20000", "--paf-records", "300"]


def _md5(path):
    with open(path, "rb") as f:
        return hashlib.md5(f.read()).hexdigest()


@pytest.mark.parametrize("sizes", [(3, 5000, 40, 12), (6, 1001, 7, 60)])
def test_corpus_copy_writes_make_corpus_bytes(tmp_path, sizes):
    records, cols, paf_records, runs = sizes
    mine = make_corpus.write_corpus(str(tmp_path / "port"), records, cols,
                                    paf_records, runs)
    subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "make_corpus.py"),
         "--out", str(tmp_path / "tpu"), "--maf-records", str(records),
         "--maf-cols", str(cols), "--paf-records", str(paf_records),
         "--paf-runs", str(runs)],
        check=True, capture_output=True, timeout=300)
    for path in mine:
        name = os.path.basename(path)
        assert _md5(path) == _md5(tmp_path / "tpu" / name), name


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """The program at TINY on the CPU: (out dir, stdout, stderr)."""
    out = str(tmp_path_factory.mktemp("scale") / "work")
    env = dict(os.environ, PYTHONPATH=REPO, WGA_TORCH_DEVICE="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "wgatools_tpu_torch.scripts.scale_configs",
         "--out", out, *TINY],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return out, proc.stdout, proc.stderr


def _table(stdout):
    """The markdown table's rows: name -> note."""
    rows = {}
    for line in stdout.splitlines():
        m = re.fullmatch(r"\| `(.+)` \| [0-9.]+ s \| (.*) \|", line)
        if m:
            rows[m.group(1)] = m.group(2)
    return rows


def test_every_cross_check_holds_with_gloo_ranks(tiny_run):
    out, stdout, stderr = tiny_run
    rows = _table(stdout)
    assert list(rows) == [
        "maf-index", "call -s -l0 (serial)", "call -s -l0 -t4",
        "call -s -l0 WGA_TPU_DIST=1 x2", "maf-ext (20 regions)",
        "chunk -l 100000", "pafcov (serial)", "pafcov -t4",
        "pafcov WGA_TPU_DIST=1 x2",
        "pafpseudo (serial, 16 samples x 8 targets)", "pafpseudo -t4",
        "pafpseudo WGA_TPU_DIST=1 x2",
    ]
    checks = [note for name, note in rows.items()
              if "-t4" in name or "DIST" in name]
    assert checks == ["bytes==serial: True"] * 4 + [
        "dir-bytes==serial: True"] * 2
    assert "kernel launches: {" in stderr
    # the outputs are hashed and deleted; the ranks' logs say gloo
    assert not any(n.endswith((".vcf", ".bed")) or n.startswith("pp.")
                   for n in os.listdir(out))
    for k in range(2):
        with open(os.path.join(out, f"cov.dist.bed.{k}.log")) as f:
            assert f"process {k}/2" in f.read()


SERIAL = {
    "maf-index": (["maf-index", "{maf}"], "{maf}.index"),
    "call -s -l0 (serial)": (["call", "{maf}", "-s", "-l0"], None),
    "maf-ext (20 regions)": (
        ["maf-ext", "{maf}", "-r", ",".join(
            f"ref.chr1:{s}-{s + 5000}"
            for s in range(2000, 40_000_000, 2_000_000))], None),
    "chunk -l 100000": (["chunk", "{maf}", "-l", "100000"], None),
    "pafcov (serial)": (["pafcov", "{paf}"], None),
    "pafpseudo (serial, 16 samples x 8 targets)": (
        ["pafpseudo", "{paf}", "-o", "{dir}"], "{dir}"),
}


@pytest.mark.parametrize("row", list(SERIAL))
def test_serial_rows_write_the_tpu_packages_bytes(tiny_run, tmp_path, row):
    out, stdout, _ = tiny_run
    argv, product = SERIAL[row]
    # the TPU package on a copy of the corpus and, but for the maf-index
    # row, of the port's index (call and maf-ext read it)
    names = ["big.maf", "big.paf"] + ["big.maf.index"] * (row != "maf-index")
    for name in names:
        shutil.copy(os.path.join(out, name), tmp_path / name)
    paths = dict(maf=str(tmp_path / "big.maf"), paf=str(tmp_path / "big.paf"),
                 dir=str(tmp_path / "pp"))
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    stdout_path = tmp_path / "stdout"
    with open(stdout_path, "wb") as f:
        subprocess.run(
            [sys.executable, "-m", "wgatools_tpu",
             *(a.format(**paths) for a in argv)],
            stdout=f, check=True, env=env, cwd=REPO, timeout=300)
    target = stdout_path if product is None else product.format(**paths)
    if os.path.isdir(target):
        parts = [fn + ":" + _md5(os.path.join(target, fn))
                 for fn in sorted(os.listdir(target))]
        want = hashlib.md5("\n".join(parts).encode()).hexdigest()
    else:
        want = _md5(target)
    assert _table(stdout)[row] == f"md5 {want}"


def test_digest_of_a_directory_is_the_tpu_scripts(tmp_path):
    d = tmp_path / "d"
    d.mkdir()
    (d / "b.maf").write_bytes(b"bb")
    (d / "a.maf").write_bytes(b"a")
    want = hashlib.md5(("a.maf:" + hashlib.md5(b"a").hexdigest() + "\nb.maf:"
                        + hashlib.md5(b"bb").hexdigest()).encode()).hexdigest()
    assert scale_configs.digest(str(d)) == want
    assert not d.exists()


def test_program_without_a_card_exits_non_zero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("WGA_TORCH_DEVICE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "wgatools_tpu_torch.scripts.scale_configs",
         "--out", str(tmp_path), *TINY], capture_output=True, text=True,
        cwd=REPO, env=env, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "WGA_TORCH_DEVICE" in proc.stderr
    assert os.listdir(tmp_path) == []
