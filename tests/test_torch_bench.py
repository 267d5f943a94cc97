"""wgatools_tpu_torch.entry and wgatools_tpu_torch.bench against the JAX
package's entry step and bench.py's loops.

The entry step must equal __graft_entry__.entry()'s `combined` on the same
arguments, and the bench's two loop bodies, run on the CPU through the
kernels' plain versions, must give the int32 checksum that the same loops
give in JAX: the card branch's (kernel C with raw group-8 sums, bench.py's
feedback) against the JAX package's Pallas kernel in interpret mode, the
off-TPU branch's against classify_stat_jnp and the jnp scan of
__graft_entry__'s `combined`.  Tolerance 0: every value is an int32.  The
JAX inputs are drawn here in bench.py's order from seed 0.
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from wgatools_tpu_torch import bench
from wgatools_tpu_torch.entry import entry, entry_inputs
from wgatools_tpu_torch.kernels import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _bench_py_inputs(B, L):
    """bench.py's host arrays (:74-105), drawn here in its order."""
    rng = np.random.default_rng(0)
    alphabet = np.frombuffer(b"ACGT-", dtype=np.uint8)
    t0 = alphabet[rng.integers(0, 5, size=(B, L))]
    q0 = alphabet[rng.integers(0, 5, size=(B, L))]
    n_ops = max(L // 32, 1)
    ops = np.frombuffer(b"M=XID", dtype=np.uint8)[rng.integers(0, 5, size=(B, n_ops))]
    return t0, q0, ops, np.full((B, n_ops), 32, np.int32)


def _jax_checksum(acc, outs):
    import jax.numpy as jnp

    acc = acc + jnp.sum(outs[0], dtype=jnp.int32)
    for o in outs[1:]:
        acc = acc + jnp.sum(o[:, ::512], dtype=jnp.int32)
    return acc


# ---- the entry step -----------------------------------------------------------


def test_entry_inputs_are_the_graft_entry_args():
    import __graft_entry__

    _, want = __graft_entry__.entry()
    for got, w in zip(entry_inputs(), want):
        np.testing.assert_array_equal(got, np.asarray(w))


def test_entry_step_matches_graft_entry():
    import __graft_entry__

    combined, jargs = __graft_entry__.entry()
    want = combined(*jargs)
    step, args = entry(CPU)
    got = step(*args)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_entry_default_device_follows_wga_torch_device(monkeypatch):
    monkeypatch.setenv("WGA_TORCH_DEVICE", "cpu")
    _, args = entry()
    assert all(a.device == CPU for a in args)


# ---- the loop bodies against JAX --------------------------------------------------


def test_host_inputs_are_bench_py_draws():
    x = bench.host_inputs(4, 1 << 12)
    for got, want in zip((x["t"], x["q"], x["ops"], x["op_lens"]),
                         _bench_py_inputs(4, 1 << 12)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(x["lens"], np.full(4, 1 << 12, np.int32))


@pytest.mark.parametrize("iters", [1, 3])
def test_card_loop_checksum_matches_jax_kernel_c(iters):
    """The card branch's body through kernel C's plain version at B = 9,
    L = 2^12, runs of 32, against the JAX package's kernel C in interpret
    mode with bench.py's feedback (:216-225)."""
    import jax.numpy as jnp

    from wgatools_tpu.ops.classify import pack_cat_nibbles
    from wgatools_tpu.ops.fused import classify_liftover_fused_adv16
    from wgatools_tpu.ops.liftover import pack_ops_sums

    B, L = 9, 1 << 12
    loop = bench.Loop(bench.card_step,
                      bench.card_state(bench.host_inputs(B, L), CPU))
    got = loop.run(iters)

    t0, q0, ops, op_lens = _bench_py_inputs(B, L)
    cw = jnp.asarray(pack_cat_nibbles(t0, q0))
    st, sq = (jnp.asarray(a) for a in pack_ops_sums(ops, op_lens, group=8))
    lens = jnp.full(B, L, dtype=jnp.int32)
    acc = jnp.int32(0)
    for _ in range(iters):
        outs = classify_liftover_fused_adv16(
            cw, None, lens, st, sq, interpret=True, catmode=True,
            scan_mode="once", raw_sums=True,
        )
        acc = _jax_checksum(acc, outs)
        cw = cw.at[0, 0].set(jnp.int32(0x11111111) + (acc & 1))
        st = st.at[0, 0].set(jnp.int32(1) + (acc & 7))
        sq = sq.at[0, 0].set(jnp.int32(1) + ((acc >> 3) & 7))
    assert got == int(acc) != 0


@pytest.mark.parametrize("iters", [2, 6])
def test_cpu_loop_checksum_matches_jax(iters):
    """The off-TPU branch at 4 x 2^16 against a replay built from
    classify_stat_jnp and the jnp scan of __graft_entry__'s `combined`,
    with bench.py's feedback (:226-234)."""
    import jax.numpy as jnp

    import __graft_entry__
    from wgatools_tpu.ops.liftover import pack_ops_words16

    B, L = bench.CPU_SHAPE
    loop = bench.Loop(bench.cpu_step, bench.cpu_state(bench.host_inputs(B, L), CPU))
    got = loop.run(iters)
    assert loop.run(iters) == got  # each run starts from the first inputs

    combined, _ = __graft_entry__.entry()
    t0, q0, ops, op_lens = _bench_py_inputs(B, L)
    t, q = jnp.asarray(t0), jnp.asarray(q0)
    opw = jnp.asarray(pack_ops_words16(ops, op_lens))
    lens = jnp.full(B, L, dtype=jnp.int32)
    acc = jnp.int32(0)
    for _ in range(iters):
        acc = _jax_checksum(acc, combined(t, q, lens, opw))
        t = t.at[0, 0].set((acc & 3).astype(jnp.uint8) + jnp.uint8(65))
        opw = opw.at[0, 0].set(jnp.int32(1 << 13) + jnp.int32(1) + (acc & 7))
    assert got == int(acc) != 0


# ---- the program ----------------------------------------------------------------


def _run_bench(env):
    return subprocess.run([sys.executable, "-m", "wgatools_tpu_torch.bench"],
                          capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=300)


def test_bench_on_the_cpu_prints_one_json_line():
    proc = _run_bench(dict(os.environ, PYTHONPATH=REPO, WGA_TORCH_DEVICE="cpu"))
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert list(result) == ["metric", "value", "unit", "vs_baseline"]
    assert result["metric"] == "aligned_columns_gbp_per_s_per_chip"
    assert result["unit"] == "Gbp/s"
    assert 0 < result["value"] <= bench.CPU_BOUND / 1e9
    assert result["vs_baseline"] == round(result["value"] / 0.59, 2)
    assert "kernel launches: " in proc.stderr


def test_bench_without_a_card_exits_non_zero():
    """The default device is the card; without one the bench refuses
    rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("WGA_TORCH_DEVICE", None)
    proc = _run_bench(env)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "torch.cuda.is_available() is False" in proc.stderr


# ---- timing and bookkeeping -------------------------------------------------------


def test_marginal_rate_takes_the_best_window():
    # window k: lo batches take 1 + k s, hi batches 3 + 2k s
    times = iter([1.0, 3.0] + [t for k in range(3) for t in
                               [1.0 + k] * 3 + [3.0 + 2 * k] * 3])
    rate = bench.marginal_rate(lambda n: next(times), 100, 2, 6, 3, 3, 1e9,
                               log=lambda msg: None)
    assert rate == 100 * 4 / 2.0


def test_marginal_rate_falls_back_to_the_lower_bound():
    # the marginal (400 columns in 0.5 s) exceeds the guard of 500/s
    times = iter([1.0, 1.5] + [1.0] * 3 + [1.5] * 3)
    rate = bench.marginal_rate(lambda n: next(times), 100, 2, 6, 1, 3, 500,
                               log=lambda msg: None)
    assert rate == 100 * 6 / 1.5


def test_launches_count_replays_not_captures(monkeypatch):
    counts = dict.fromkeys(_build.LAUNCHES, 0)
    counts.update(fused_adv16=1 + 128 + 1536, classify_cat=1)
    monkeypatch.setattr(_build, "LAUNCHES", counts)
    graphs = [SimpleNamespace(per_replay=dict(counts, fused_adv16=n,
                                              classify_cat=0), replays=r)
              for n, r in ((128, 16), (1536, 17))]
    got = bench.launches(graphs)
    assert got["fused_adv16"] == 1 + 128 * 16 + 1536 * 17
    assert got["classify_cat"] == 1


def test_roofline_guard_is_kernel_c_bytes_at_the_card_rate():
    B, L = bench.CARD_SHAPE
    n_groups = L // 32 // bench.GROUP
    nbytes = B * L // 2 + 4 * B + 32 * B + 16 * B * n_groups
    assert bench.roofline_columns_per_s(B, L, n_groups) == pytest.approx(
        B * L * 3.35e12 / nbytes)
    assert 5.9e12 < bench.roofline_columns_per_s(B, L, n_groups) < 6.0e12
