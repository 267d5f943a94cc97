"""wgatools_tpu_torch.scripts.fuzz_campaign against scripts/fuzz_campaign.py.

The port's case generators must draw the TPU script's cases (the script is
loaded with importlib, unedited; its op tables and byte pairs are caught
where they reach the TPU package's packers); each of the seven properties
must pass on the CPU (WGA_TORCH_DEVICE=cpu: the kernels' plain versions);
the kernel properties' plain outputs must equal the TPU package's
functions on the same cases (classify_stat_jnp, classify_stat_pallas_cat in
interpret mode, _liftover_scan_impl), with tolerance 0; and a fault planted
in a plain version must fail the run.
"""

import importlib.util
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wgatools_tpu.ops.classify as tpu_classify
import wgatools_tpu.ops.liftover as tpu_liftover
from wgatools_tpu_torch.scripts import fuzz_campaign as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (0, 11)


@pytest.fixture(scope="module")
def tpu_script():
    spec = importlib.util.spec_from_file_location(
        "tpu_fuzz_campaign", os.path.join(REPO, "scripts", "fuzz_campaign.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Caught(Exception):
    pass


def _catch(monkeypatch, module, name):
    """Replace module.name with a function that records its arguments and
    stops the caller; returns the list of recorded argument tuples."""
    seen = []

    def record(*args, **kwargs):
        seen.append(args)
        raise _Caught

    monkeypatch.setattr(module, name, record)
    return seen


def _same_state(a, b):
    assert a.integers(0, 2**62) == b.integers(0, 2**62)


@pytest.mark.parametrize("seed", SEEDS)
def test_rand_alignment_and_corrupt_draw_the_tpu_scripts_cases(tpu_script,
                                                               seed):
    mine, theirs = np.random.default_rng(seed), np.random.default_rng(seed)
    for k in range(60):
        kw = ({}, {"alphabet": "ACGT"}, {"max_runs": 12})[k % 3]
        pair = F.rand_alignment(mine, **kw)
        assert pair == tpu_script.rand_alignment(theirs, **kw)
        blob = ("".join(pair) + "\n").encode()
        assert F._corrupt(mine, blob) == tpu_script._corrupt(theirs, blob)
    _same_state(mine, theirs)


@pytest.mark.parametrize("seed", SEEDS)
def test_op_tables_are_the_tpu_scripts(tpu_script, monkeypatch, seed):
    seen = _catch(monkeypatch, tpu_liftover, "pack_ops_batch")
    mine, theirs = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(25):
        with pytest.raises(_Caught):
            tpu_script.prop_op_packings(theirs)
        op_arrays, len_arrays = F.op_table(mine)
        want_ops, want_lens = seen[-1]
        assert len(op_arrays) == len(want_ops)
        for got, want in zip(op_arrays + len_arrays, want_ops + want_lens):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    _same_state(mine, theirs)


@pytest.mark.parametrize("seed", SEEDS)
def test_byte_pairs_are_the_tpu_scripts(tpu_script, monkeypatch, seed):
    seen = _catch(monkeypatch, tpu_classify, "pack_pairs")
    mine, theirs = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(25):
        with pytest.raises(_Caught):
            tpu_script.prop_cat_plane(theirs)
        assert F.byte_pairs(mine) == seen[-1][0]
    _same_state(mine, theirs)


@pytest.mark.parametrize("name", list(F.PROPS))
def test_each_property_passes_on_the_cpu(name, tmp_path):
    rng = np.random.default_rng(3)
    aux = np.random.default_rng([3, 1])
    extra = (str(tmp_path),) if name == "maf_paf_roundtrip" else ()
    for _ in range(40):
        F.PROPS[name](rng, aux, torch.device("cpu"), *extra)


@pytest.mark.parametrize("seed", SEEDS)
def test_cat_plane_plain_outputs_equal_the_tpu_packages(seed):
    rng = np.random.default_rng(seed)
    aux = np.random.default_rng([seed, 1])
    nibble_cases = 0
    for _ in range(6):
        t, q, lens, cw = F.cat_plane_case(rng, aux)
        for caller in (False, True):
            plain = F.cat_plane_plain(t, q, lens, cw, caller)
            want = np.asarray(tpu_classify.classify_stat_jnp(
                jnp.asarray(t), jnp.asarray(q), jnp.asarray(lens),
                caller=caller))
            pallas = np.asarray(tpu_classify.classify_stat_pallas_cat(
                jnp.asarray(cw), jnp.asarray(lens), tile_b=2, tile_lw=32,
                interpret=True, caller=caller))
            np.testing.assert_array_equal(pallas, want)
            for name, got in plain.items():
                np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
            nibble_cases += "classify_nibbles" in plain
    assert nibble_cases  # the ACGT- and A- profiles take the nibble planes


@pytest.mark.parametrize("seed", SEEDS)
def test_op_packings_plain_outputs_equal_the_tpu_packages(seed):
    rng = np.random.default_rng(seed)
    aux = np.random.default_rng([seed, 1])
    b2_differs = 0
    for _ in range(8):
        ops, lens, (t, q, col_lens), caller = F.op_packings_case(rng, aux)
        plain = F.op_packings_plain(ops, lens, (t, q, col_lens), caller)
        want = tpu_liftover._liftover_scan_impl(
            jnp.asarray(ops), jnp.asarray(lens), False, False)
        for got, w in zip(plain["liftover"], want):
            np.testing.assert_array_equal(got.numpy(), np.asarray(w))
        np.testing.assert_array_equal(
            plain["stats"].numpy(),
            np.asarray(tpu_classify.classify_stat_jnp(
                jnp.asarray(t), jnp.asarray(q), jnp.asarray(col_lens),
                caller=caller)))
        b2_differs += t.shape[0] != ops.shape[0]
    assert b2_differs  # the fused kernels see B2 != B too


def test_program_prints_seven_pass_lines(monkeypatch, capsys):
    monkeypatch.setenv("WGA_TORCH_DEVICE", "cpu")
    assert F.main(["--iters", "20", "--seed", "5"]) == 0
    out, err = capsys.readouterr()
    assert out.splitlines() == [
        f"PASS {name}: {2 if name in F.KERNEL_PROPS else 20} cases"
        for name in F.PROPS]
    assert "kernel launches: {" in err


@pytest.mark.parametrize("where", ["classify_stat_cat_ref", "liftover_scan_ref"])
def test_a_planted_fault_fails_the_run(monkeypatch, capsys, where):
    """A plain version that is off by one in one element fails its
    property, names the first differing element, and the run still reports
    every other property."""
    monkeypatch.setenv("WGA_TORCH_DEVICE", "cpu")
    true_fn = getattr(F, where)

    def planted(*args, **kwargs):
        out = true_fn(*args, **kwargs)
        first = out[0] if isinstance(out, tuple) else out
        first.view(-1)[-1] += 1
        return out

    monkeypatch.setattr(F, where, planted)
    assert F.main(["--iters", "30"]) == 1
    out = capsys.readouterr().out
    prop = "cat_plane" if where == "classify_stat_cat_ref" else "op_packings"
    assert f"FAIL {prop} after 0 cases: seed 0, case 0" in out
    assert "elements differ, first at" in out
    verdicts = [line.split(" ", 2)[:2] for line in out.splitlines()
                if line.startswith(("PASS ", "FAIL "))]
    assert [name.split(":")[0] for _, name in verdicts] == list(F.PROPS)
    assert ["PASS", "stat_vs_oracle:"] in verdicts


def test_program_without_a_card_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("WGA_TORCH_DEVICE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "wgatools_tpu_torch.scripts.fuzz_campaign",
         "--iters", "10"], capture_output=True, text=True, cwd=REPO,
        env=env, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "WGA_TORCH_DEVICE" in proc.stderr
