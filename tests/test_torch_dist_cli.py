"""The port's distributed modes on two ranks against the TPU package.

Each of the 12 runs where wgatools_tpu/cli.py starts a distributed driver
(test_torch_cli.DIST_RUNS) goes through two rank processes of the port's
command line on the CPU (gloo; WGA_TPU_DIST=1 and the coordinator
variables, as users launch them), writing to `-o` (and `-f FIXED`).  The
files must equal, byte for byte, those of wgatools_tpu.cli.main run
serially on the same arguments.  Only rank 0 opens `-o` or `-f` for
writing, neither rank writes to stdout, and neither imports jax or
wgatools_tpu.  pafpseudo's ranks each write their stripe of the targets
into the output directory, whose files must equal the serial run's.
"""

import os

import pytest

from dist_ranks import run_port_ranks
from test_torch_cli import DIST_RUNS, _tree, _write_inputs
from wgatools_tpu.cli import main as host_main


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("inputs"))
    _write_inputs(d)
    return d


def _argv(run, d, o):
    argv = [a.format(d=d, o=o) for a in run]
    if run[0] != "pafpseudo":  # its -o names a directory, in the run
        argv += ["-o", os.path.join(o, "out")]
    return argv


@pytest.mark.parametrize("run", DIST_RUNS, ids=lambda r: " ".join(r[:3]))
def test_two_ranks_write_the_tpu_package_bytes(run, inputs, tmp_path,
                                               monkeypatch):
    got, want = tmp_path / "got", tmp_path / "want"
    for p in (got, want):
        os.makedirs(p)
    ranks = run_port_ranks(_argv(run, inputs, str(got)), 2, str(tmp_path))
    for rank in ranks:
        assert rank["rc"] == 0, rank["stderr"]
        assert rank["imported"] == []
        assert rank["stdout"] == b""
    monkeypatch.delenv("WGA_TPU_DIST", raising=False)
    assert host_main(_argv(run, inputs, str(want))) == 0
    files = _tree(str(want))
    assert files and _tree(str(got)) == files
    if run[0] != "pafpseudo":
        real = {os.path.join(str(got), name) for name in files}
        assert set(ranks[0]["opened"]) >= real
        assert not [p for p in ranks[1]["opened"]
                    if p.startswith(str(got) + os.sep)]
