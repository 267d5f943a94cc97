"""wgatools_tpu_torch.scripts.p2c_headline against scripts/p2c_headline.py.

`build` must write the TPU script's bytes (the script is loaded with
importlib, unedited), and the port's `paf2chain` on that PAF, through its
command line on the CPU, must write `python -m wgatools_tpu paf2chain`'s
bytes: on the host engine (the default threshold answers a small input
there) and on the device route (DEVICE_MIN_OPS lowered to 0: kernel B's
plain version).
"""

import importlib.util
import os
import subprocess
import sys

import pytest

from wgatools_tpu_torch.scripts import p2c_headline as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET = 5_000_000


def _tpu_script():
    spec = importlib.util.spec_from_file_location(
        "tpu_p2c_headline", os.path.join(REPO, "scripts", "p2c_headline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def paf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("p2c") / "headline.paf")
    assert P.build(path, target=TARGET) == _tpu_script().build(
        path + ".tpu", target=TARGET)
    return path


@pytest.fixture(scope="module")
def tpu_chain(paf):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    out = paf + ".tpu.chain"
    subprocess.run([sys.executable, "-m", "wgatools_tpu", "paf2chain", paf,
                    "-o", out, "-r"], check=True, env=env, cwd=REPO,
                   timeout=300)
    with open(out, "rb") as f:
        return f.read()


@pytest.mark.parametrize("seed", [7, 3])
def test_build_writes_the_tpu_scripts_bytes(tmp_path, seed):
    got, want = tmp_path / "port.paf", tmp_path / "tpu.paf"
    counts = P.build(str(got), target=TARGET, seed=seed)
    assert counts == _tpu_script().build(str(want), target=TARGET, seed=seed)
    assert counts[1] >= TARGET and counts[0] >= 4
    assert got.read_bytes() == want.read_bytes()


def test_defaults_are_the_tpu_scripts():
    assert P.build.__defaults__ == _tpu_script().build.__defaults__
    assert P.WORK == os.path.join(REPO, "build", "p2c_headline")


@pytest.mark.parametrize("route", ["host", "device"])
def test_port_paf2chain_writes_the_tpu_packages_bytes(
        paf, tpu_chain, route, tmp_path, monkeypatch):
    from wgatools_tpu_torch.cli import main
    from wgatools_tpu_torch.tools import convert

    monkeypatch.setenv("WGA_TORCH_DEVICE", "cpu")
    if route == "device":
        monkeypatch.setattr(convert, "DEVICE_MIN_OPS", 0)
    out = tmp_path / "port.chain"
    assert main(["paf2chain", paf, "-o", str(out), "-r"]) == 0
    assert out.read_bytes() == tpu_chain
