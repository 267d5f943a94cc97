"""wgatools_tpu_torch.scripts.scaling_bench on gloo ranks on the CPU.

The program at a small --cols must print one JSON line per group size with
the TPU script's keys, and each rank's stats (the gate before its timing)
must equal the plain word stats of its shard and the JAX package's
classify_stat_jnp on the same byte columns (tolerance 0).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from wgatools_tpu_torch.ops.classify import classify_stat_words_ref
from wgatools_tpu_torch.parallel.dryrun import spawn
from wgatools_tpu_torch.scripts import scaling_bench as S

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLS, ROWS, ITERS = 4096, 3, 3


@pytest.mark.parametrize("n_total, sizes", [
    (1, [1]), (2, [1, 2]), (4, [1, 2, 4]), (6, [1, 2, 4, 6]),
])
def test_group_sizes_are_the_tpu_scripts(n_total, sizes):
    assert S.group_sizes(n_total) == sizes


def test_program_prints_a_line_per_group_size():
    env = dict(os.environ, PYTHONPATH=REPO, WGA_TORCH_DEVICE="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "wgatools_tpu_torch.scripts.scaling_bench",
         "--cols", str(COLS), "--rows-per-dev", "2", "--iters", str(ITERS),
         "--nproc", "2"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    rows = [json.loads(line) for line in proc.stdout.strip().splitlines()]
    assert [r["devices"] for r in rows] == [1, 2]
    for r in rows:
        assert list(r) == ["devices", "gcols_per_s", "scaling_efficiency"]
        assert r["gcols_per_s"] >= 0
    assert rows[0]["scaling_efficiency"] == 1.0
    for n in (1, 2):
        for k in range(n):
            assert f"rank {k}/{n}: backend gloo" in proc.stderr
            assert f"rank {k}/{n}: kernel launches: " in proc.stderr


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return spawn(2, S.scaling_rank, COLS, ROWS, ITERS,
                 store_dir=tmp_path_factory.mktemp("scaling"))


@pytest.mark.parametrize("rank", [0, 1])
def test_rank_stats_equal_the_plain_stats_of_its_shard(two_ranks, rank):
    tw, qw, lens = S.shard_planes(2, rank, ROWS, COLS, torch.device("cpu"))
    got = two_ranks[rank]["stats"]
    assert got.dtype == np.int32 and got.shape == (ROWS, 8)
    np.testing.assert_array_equal(got, classify_stat_words_ref(tw, qw, lens).numpy())


@pytest.mark.parametrize("rank", [0, 1])
def test_rank_stats_equal_jax_on_the_same_columns(two_ranks, rank):
    import jax.numpy as jnp

    from wgatools_tpu.ops.classify import classify_stat_jnp

    tw, qw, lens = S.shard_planes(2, rank, ROWS, COLS, torch.device("cpu"))
    t, q = (jnp.asarray(w.view(torch.uint8).numpy()) for w in (tw, qw))
    want = classify_stat_jnp(t, q, jnp.asarray(lens.numpy()))
    np.testing.assert_array_equal(two_ranks[rank]["stats"], np.asarray(want))


def test_ranks_agree_on_the_rate_and_run_no_kernel_on_the_cpu(two_ranks):
    for res in two_ranks:
        assert res["rate"] > 0
        assert all(n == 0 for n in res["launches"].values())


def test_shards_differ_by_rank_and_group_size():
    cpu = torch.device("cpu")
    a = S.shard_planes(2, 0, ROWS, COLS, cpu)[0]
    assert not torch.equal(a, S.shard_planes(2, 1, ROWS, COLS, cpu)[0])
    assert not torch.equal(a, S.shard_planes(4, 0, ROWS, COLS, cpu)[0])
    assert torch.equal(a, S.shard_planes(2, 0, ROWS, COLS, cpu)[0])
    assert set(a.view(torch.uint8).unique().tolist()) == set(b"ACGT-")
