"""bin/wgatools-tpu-torch, the port's console launcher: run from a bin
directory beside a `python`, as an installed console script is, it writes
the bytes of `python -m wgatools_tpu_torch`; pyproject.toml installs it
beside the TPU package's launcher.
"""

import os
import shutil
import subprocess
import sys
import tomllib

import pytest

from synth import make_paf_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCHER = os.path.join(REPO, "bin", "wgatools-tpu-torch")


@pytest.fixture
def bin_dir(tmp_path):
    """A temporary bin directory holding the launcher and a `python` that
    runs this interpreter.  The `python` is a script that execs it, not a
    symlink: a virtual environment's interpreter reached through a symlink
    in another directory loses the environment's site-packages."""
    d = tmp_path / "bin"
    d.mkdir()
    shutil.copy2(LAUNCHER, d / "wgatools-tpu-torch")
    (d / "python").write_text(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    (d / "python").chmod(0o755)
    return d


def _env():
    # no python on PATH: the launcher must find the one beside it; the
    # host route, which needs no card
    return dict(os.environ, PYTHONPATH=REPO, PATH="/usr/bin:/bin",
                WGA_TPU_DEVICE="0")


@pytest.mark.parametrize("argv", [["--version"], ["paf2chain", "{paf}"]],
                         ids=["version", "paf2chain"])
def test_launcher_writes_the_modules_bytes(argv, bin_dir, tmp_path):
    paf, _, _ = make_paf_case(9, negative=True)
    (tmp_path / "in.paf").write_text(paf)
    argv = [a.format(paf=tmp_path / "in.paf") for a in argv]
    got = subprocess.run([str(bin_dir / "wgatools-tpu-torch"), *argv],
                         capture_output=True, env=_env(), cwd=tmp_path,
                         timeout=60)
    want = subprocess.run([sys.executable, "-m", "wgatools_tpu_torch", *argv],
                          capture_output=True, env=_env(), cwd=tmp_path,
                          timeout=60)
    assert got.returncode == want.returncode == 0, got.stderr.decode()
    assert got.stdout == want.stdout and got.stdout


def test_pyproject_installs_both_launchers():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        script_files = tomllib.load(f)["tool"]["setuptools"]["script-files"]
    assert script_files == ["bin/wgatools-tpu", "bin/wgatools-tpu-torch"]
    assert os.access(LAUNCHER, os.X_OK)
