"""wgatools_tpu_torch.parallel against wgatools_tpu.parallel.

Groups of 2 and 4 CPU ranks (gloo, one spawned process per rank, a
FileStore in tmp_path) run every sharded function, `replicate_rows` and the
whole dryrun on numpy inputs from a seed; the JAX package runs the same
inputs on its 8-device virtual mesh (tests/conftest.py).  Each global
result, assembled with gather_rows, must equal JAX's exactly (integers,
tolerance 0).  The ranks also count their collectives, the payload checks
of tests/test_comm_volume.py: none for the record-parallel functions, one
table-sized all_reduce for the merges, one [2, B] int32 all_gather for the
sequence-parallel scan, whatever the record or op count.

The ranks are spawned once per group size; they import this module to find
_rank_checks, so jax is imported only inside the fixtures that run the JAX
package, and every rank checks that it never imported jax.
"""

import os
import subprocess
import sys
from contextlib import contextmanager

import numpy as np
import pytest
import torch
import torch.distributed as dist

from wgatools_tpu_torch.ops.classify import pack_cat_nibbles, pack_nibble_words, pack_pairs
from wgatools_tpu_torch.ops.liftover import (
    liftover_scan_ref,
    pack_ops_adv16,
    pack_ops_batch,
    pack_ops_sums,
    pack_ops_words16,
)
from wgatools_tpu_torch.parallel import dryrun as TD
from wgatools_tpu_torch.parallel import mesh as TM
from wgatools_tpu_torch.parallel.dist_tools import replicate_rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 16  # records: divides 2, 4 and the JAX package's 8 devices
GENOME = 1003  # genome_len + 1 divides none of them: shard padding
NUM_PAIRS = 5
SP_SHAPES = [(1, 256, 200), (5, 1024, 1000)]  # (records, ops, real ops)
ADV16_MODES = {  # name -> sharded_fused_adv16 flags; words from adv16 or sums
    "nibble_odd": dict(nibble=True),
    "nibble_even": dict(nibble=True, emit_odd=False),
    "nibble_raw": dict(nibble=True, raw_sums=True),
    "words_odd": dict(),
    "words_even": dict(emit_odd=False, scan_mode="vpu"),
    "words_raw": dict(raw_sums=True, scan_mode="once"),
    "cat_raw": dict(catmode=True, raw_sums=True, scan_mode="once"),
    "cat_odd": dict(catmode=True),
}


def _inputs():
    """Global numpy inputs of every check, from seed 7."""
    rng = np.random.default_rng(7)
    alphabet = np.frombuffer(b"ACGTNacgtn-", np.uint8)
    pairs = []
    for k in range(B):
        n = 0 if k == 3 else int(rng.integers(1, 700))
        t = alphabet[rng.integers(0, len(alphabet), n)]
        q = t.copy()
        flip = rng.random(n) < 0.4
        q[flip] = alphabet[rng.integers(0, len(alphabet), int(flip.sum()))]
        pairs.append((t.tobytes(), q.tobytes()))
    x = {}
    x["t"], x["q"], x["lens"] = pack_pairs(pairs, align=128)
    x["tw"] = np.ascontiguousarray(x["t"]).view("<i4")
    x["qw"] = np.ascontiguousarray(x["q"]).view("<i4")
    x["tn"], x["qn"] = pack_nibble_words(x["t"], x["q"])
    x["cw"] = pack_cat_nibbles(x["t"], x["q"])
    x["pair_ids"] = rng.integers(-1, NUM_PAIRS + 1, B).astype(np.int32)
    x["starts"] = rng.integers(0, GENOME, 40).astype(np.int32)
    x["ends"] = np.minimum(x["starts"] + rng.integers(1, 200, 40), GENOME + 5)
    x["ends"] = x["ends"].astype(np.int32)
    x["starts"][3] = -1  # a padding span adds nothing
    op_chars = np.frombuffer(b"M=XIDS", np.uint8)
    n_ops = [int(rng.integers(0, 300)) for _ in range(B)]
    x["ops"], x["op_lens"] = pack_ops_batch(
        [op_chars[rng.integers(0, 6, n)] for n in n_ops],
        [rng.integers(0, 8192, n) for n in n_ops],
    )
    x["ops"], x["op_lens"] = x["ops"][:, :298], x["op_lens"][:, :298]
    x["opw16"] = pack_ops_words16(x["ops"], x["op_lens"])
    x["wt"], x["wq"] = pack_ops_adv16(x["ops"], x["op_lens"])
    x["st"], x["sq"] = pack_ops_sums(x["ops"], x["op_lens"], group=8)
    for k, (b, n, n_real) in enumerate(SP_SHAPES):
        ops = op_chars[rng.integers(0, 6, (b, n))]
        ops[:, n_real:] = 0
        lens = rng.integers(0, 100_000, (b, n)).astype(np.int32)
        lens[ops == 0] = 0
        x[f"sp_ops{k}"], x[f"sp_lens{k}"] = ops, lens
    x["rows"] = rng.integers(0, 256, (4, 16)).astype(np.uint8)
    return x


# ---- the ranks (spawned processes; no jax here) ----------------------------

_COLLECTIVES = (
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "reduce_scatter_tensor", "reduce_scatter", "broadcast", "reduce",
    "all_to_all", "all_to_all_single", "gather", "scatter",
)


@contextmanager
def _counting():
    """Records (collective, shape, dtype) of the tensor this rank
    contributes to each torch.distributed collective in the block."""
    calls = []
    saved = {name: getattr(dist, name) for name in _COLLECTIVES}

    def counted(name, fn):
        def call(*args, **kwargs):
            sent = args[1] if name in (
                "all_gather", "all_gather_into_tensor", "reduce_scatter_tensor",
            ) else args[0]
            shape = tuple(sent.shape) if isinstance(sent, torch.Tensor) else None
            calls.append((name, shape, str(getattr(sent, "dtype", None))))
            return fn(*args, **kwargs)

        return call

    for name, fn in saved.items():
        setattr(dist, name, counted(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def _rank_checks(group, x):
    """Every sharded function on this rank's shards of x; returns the
    gathered global results (numpy) and the collectives of each call."""
    rec = {k: TM.shard_rows(group, x[k]) for k in (
        "t", "q", "lens", "tw", "qw", "tn", "qn", "cw", "pair_ids", "ops",
        "op_lens", "opw16", "wt", "wq", "st", "sq",
    )}
    span = {k: TM.shard_rows(group, x[k]) for k in ("starts", "ends")}
    res, comm = {}, {}

    def run(name, fn, *args, axis=0, gather=True, **kwargs):
        with _counting() as calls:
            out = fn(group, *args, **kwargs)
        comm[name] = calls
        outs = out if isinstance(out, tuple) else (out,)
        if gather:
            outs = tuple(TM.gather_rows(group, o, axis) for o in outs)
        res[name] = tuple(o.cpu().numpy() for o in outs)
        return out

    for caller in (False, True):
        run(f"stats_bytes_{caller}", TM.sharded_column_stats, rec["t"],
            rec["q"], rec["lens"], caller=caller)
        run(f"stats_words_{caller}", TM.sharded_column_stats, rec["tw"],
            rec["qw"], rec["lens"], caller=caller)
        run(f"stats_nibbles_{caller}", TM.sharded_column_stats, rec["tn"],
            rec["qn"], rec["lens"], caller=caller, nibble=True)
    run("liftover", TM.sharded_liftover, rec["ops"], rec["op_lens"])
    for nibble in (False, True):
        planes = (rec["tn"], rec["qn"]) if nibble else (rec["tw"], rec["qw"])
        run(f"fused16_{nibble}", TM.sharded_fused16, *planes, rec["lens"],
            rec["opw16"], nibble=nibble)
    for name, flags in ADV16_MODES.items():
        kind = name.split("_")[0]
        planes = {"nibble": (rec["tn"], rec["qn"]), "words": (rec["tw"], rec["qw"]),
                  "cat": (rec["cw"], None)}[kind]
        words = (rec["st"], rec["sq"]) if flags.get("raw_sums") else (rec["wt"], rec["wq"])
        run(f"adv16_{name}", TM.sharded_fused_adv16, *planes, rec["lens"],
            *words, **flags)
    stats = TM.sharded_column_stats(group, rec["t"], rec["q"], rec["lens"])
    run("pair_reduce", TM.sharded_pair_reduce, stats, rec["pair_ids"],
        NUM_PAIRS, gather=False)
    run("coverage", TM.sharded_coverage, span["starts"], span["ends"], GENOME,
        gather=False)
    run("coverage_scatter", TM.sharded_coverage_scatter, span["starts"],
        span["ends"], GENOME, gather=False)
    run("coverage_scatter_shards", TM.sharded_coverage_scatter,
        span["starts"], span["ends"], GENOME, trim=False)
    for k in range(len(SP_SHAPES)):
        run(f"sp{k}", TM.sharded_liftover_sp,
            TM.shard_rows(group, x[f"sp_ops{k}"], axis=1),
            TM.shard_rows(group, x[f"sp_lens{k}"], axis=1), axis=1)
    with _counting() as calls:
        res["rows"] = replicate_rows(group, x["rows"][group.rank])
    comm["rows"] = calls
    comm.update(_payload_checks(group))
    res["guards"] = _guard_checks(group)
    res["dryrun"] = TD.dryrun_multichip(group)
    return res, comm


def _payload_checks(group):
    """Collectives of the merges at two record (or op) counts each."""
    comm = {}
    for n in (16, 128):  # records per rank
        stats = torch.ones((n, 8), dtype=torch.int32)
        ids = torch.arange(n, dtype=torch.int32) % NUM_PAIRS
        with _counting() as comm[f"pair_reduce_{n}"]:
            TM.sharded_pair_reduce(group, stats, ids, NUM_PAIRS)
    for n in (8, 256):  # spans per rank
        s = torch.zeros(n, dtype=torch.int32)
        e = torch.ones(n, dtype=torch.int32)
        with _counting() as comm[f"coverage_{n}"]:
            TM.sharded_coverage(group, s, e, 1000)
        with _counting() as comm[f"coverage_scatter_{n}"]:
            TM.sharded_coverage_scatter(group, s, e, GENOME, trim=False)
    for n in (256, 8192):  # ops per rank
        ops = torch.full((4, n), ord("M"), dtype=torch.uint8)
        with _counting() as comm[f"sp_{n}"]:
            TM.sharded_liftover_sp(group, ops, torch.ones((4, n), dtype=torch.int32))
    return comm


def _guard_checks(group):
    """Each guard's error message on this rank (None if it did not raise),
    and the scan of a record that passes only per direction."""
    out = {}
    try:
        TM.shard_rows(group, np.zeros((1, 4 * group.size + 1), np.uint8), axis=1)
    except ValueError as e:
        out["divide"] = str(e)
    n = 256 // group.size
    ops = torch.full((1, n), ord("M"), dtype=torch.uint8)
    lens = torch.full((1, n), 10_000_000, dtype=torch.int32)  # 2.56 G total
    try:
        TM.sharded_liftover_sp(group, ops, lens)
    except ValueError as e:
        out["overflow"] = str(e)
    # 1.28 G of I + 1.28 G of D: each direction stays below 2^31
    mix = torch.from_numpy(np.frombuffer(b"ID" * 128, np.uint8).reshape(1, 256).copy())
    t, q = TM.sharded_liftover_sp(
        group, TM.shard_rows(group, mix.numpy(), axis=1),
        TM.shard_rows(group, np.full((1, 256), 10_000_000, np.int32), axis=1),
    )
    out["mix"] = tuple(TM.gather_rows(group, a, 1).numpy() for a in (t, q))
    return out


# ---- fixtures ---------------------------------------------------------------


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request, inputs, tmp_path_factory):
    """(group size, per-rank (results, collectives)) of one spawn."""
    size = request.param
    got = TD.spawn(size, _rank_checks, inputs,
                   store_dir=tmp_path_factory.mktemp(f"store{size}"))
    return size, got


@pytest.fixture(scope="module")
def jax_results(inputs):
    """The JAX package's mesh functions on the same inputs, 8 devices."""
    import jax.numpy as jnp

    from wgatools_tpu.ops import classify as JC
    from wgatools_tpu.ops.liftover import _liftover_scan_impl
    from wgatools_tpu.parallel import mesh as JM

    x = {k: jnp.asarray(v) for k, v in inputs.items()}
    mesh = JM.make_mesh(8)
    # the mesh's stats take no caller flag and no nibble planes: those
    # cases are held to the unsharded JAX kernels (Pallas in interpret mode)
    out = {
        "stats_bytes_False": JM.sharded_column_stats(mesh, x["t"], x["q"], x["lens"]),
        "stats_words_False": JM.sharded_column_stats(
            mesh, x["tw"], x["qw"], x["lens"], use_pallas=True),
        "stats_bytes_True": JC.classify_stat_jnp(x["t"], x["q"], x["lens"], caller=True),
        "stats_words_True": JC.classify_stat_pallas_words(
            x["tw"], x["qw"], x["lens"], interpret=True, caller=True),
    }
    for caller in (False, True):
        out[f"stats_nibbles_{caller}"] = JC.classify_stat_pallas_nibbles(
            x["tn"], x["qn"], x["lens"], tile_lw=128, interpret=True, caller=caller)
    out["liftover"] = JM.sharded_liftover(mesh, x["ops"], x["op_lens"])
    for nibble in (False, True):
        planes = (x["tn"], x["qn"]) if nibble else (x["tw"], x["qw"])
        out[f"fused16_{nibble}"] = JM.sharded_fused16(
            mesh, *planes, x["lens"], x["opw16"], nibble=nibble)
    for name, flags in ADV16_MODES.items():
        kind = name.split("_")[0]
        planes = {"nibble": (x["tn"], x["qn"]), "words": (x["tw"], x["qw"]),
                  "cat": (x["cw"], None)}[kind]
        words = (x["st"], x["sq"]) if flags.get("raw_sums") else (x["wt"], x["wq"])
        out[f"adv16_{name}"] = JM.sharded_fused_adv16(
            mesh, *planes, x["lens"], *words, **flags)
    stats = JM.sharded_column_stats(mesh, x["t"], x["q"], x["lens"])
    out["pair_reduce"] = JM.sharded_pair_reduce(mesh, stats, x["pair_ids"],
                                                NUM_PAIRS)
    out["coverage"] = JM.sharded_coverage(mesh, x["starts"], x["ends"], GENOME)
    out["coverage_scatter"] = JM.sharded_coverage_scatter(
        mesh, x["starts"], x["ends"], GENOME)
    out["coverage_scatter_shards"] = JM.sharded_coverage_scatter(
        mesh, x["starts"], x["ends"], GENOME, trim=False)
    for k in range(len(SP_SHAPES)):
        out[f"sp{k}"] = JM.sharded_liftover_sp(
            mesh, x[f"sp_ops{k}"], x[f"sp_lens{k}"], wide=True)
        want = _liftover_scan_impl(x[f"sp_ops{k}"], x[f"sp_lens{k}"], True, False)
        for a, b in zip(out[f"sp{k}"], want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    return {k: tuple(np.asarray(a) for a in v) if isinstance(v, tuple)
            else (np.asarray(v),) for k, v in out.items()}


def _rank0(ranks):
    return ranks[1][0][0]


# ---- results against the JAX package ----------------------------------------

FUNCTIONS = (
    [f"stats_{p}_{c}" for p in ("bytes", "words", "nibbles") for c in (False, True)]
    + ["liftover", "fused16_False", "fused16_True"]
    + [f"adv16_{m}" for m in ADV16_MODES]
    + ["pair_reduce", "coverage", "coverage_scatter", "sp0", "sp1"]
)


@pytest.mark.parametrize("name", FUNCTIONS)
def test_sharded_function_matches_jax(ranks, jax_results, name):
    got, want = _rank0(ranks)[name], jax_results[name]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_every_rank_gathers_the_same_results(ranks):
    size, per_rank = ranks
    first = per_rank[0][0]
    for res, _ in per_rank[1:]:
        for name in FUNCTIONS:
            for a, b in zip(res[name], first[name]):
                np.testing.assert_array_equal(a, b)


def test_coverage_scatter_shards_are_the_padded_array(ranks, jax_results):
    """trim=False: each rank holds padded // D positions; gathered, they
    are JAX's padded array (the values past genome_len included)."""
    size, _ = ranks
    (got,) = _rank0(ranks)["coverage_scatter_shards"]
    (want,) = jax_results["coverage_scatter_shards"]  # padded for 8 devices
    padded = ((GENOME + 1 + size - 1) // size) * size
    assert got.shape == (padded,)
    np.testing.assert_array_equal(got[:GENOME], jax_results["coverage"][0])
    np.testing.assert_array_equal(got[GENOME:], want[GENOME:padded])


def test_replicate_rows_matches_jax(ranks, inputs):
    import jax

    from wgatools_tpu.parallel.dist_tools import _replicate_rows

    size, per_rank = ranks
    rows = inputs["rows"][:size]
    want = _replicate_rows(rows, jax.devices()[:size])
    for res, _ in per_rank:
        assert res["rows"].dtype == want.dtype
        np.testing.assert_array_equal(res["rows"], want)


# ---- the dryrun -------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_dryrun():
    """JAX mesh results on TD.dryrun_inputs(n), for n ranks, cached."""
    import jax
    import jax.numpy as jnp

    from wgatools_tpu.parallel import mesh as JM
    from wgatools_tpu.parallel.dist_tools import _replicate_rows

    cache = {}

    def results(n):
        if n in cache:
            return cache[n]
        x = TD.dryrun_inputs(n)
        j = {k: jnp.asarray(v) for k, v in x.items()}
        mesh = JM.make_mesh(8)
        out = {"stats": (JM.sharded_column_stats(mesh, j["t"], j["q"], j["lens"]),)}
        out["stats_words"] = out["stats_nibbles"] = out["stats"]
        out["liftover"] = JM.sharded_liftover(mesh, j["ops"], j["op_lens"])
        out["fused16"] = JM.sharded_fused16(mesh, j["tn"], j["qn"], j["lens"],
                                            j["opw16"], nibble=True)
        out["adv16"] = JM.sharded_fused_adv16(mesh, j["tn"], j["qn"], j["lens"],
                                              j["wt16"], j["wq16"], nibble=True)
        out["adv16_even"] = JM.sharded_fused_adv16(
            mesh, j["tn"], j["qn"], j["lens"], j["wt16"], j["wq16"],
            nibble=True, emit_odd=False)
        out["g8"] = JM.sharded_fused_adv16(
            mesh, j["tn"], j["qn"], j["lens"], j["st16"], j["sq16"],
            nibble=True, raw_sums=True)
        for name, scan_mode in (("cat", "mm"), ("cat_once", "once")):
            out[name] = JM.sharded_fused_adv16(
                mesh, j["cw"], None, j["lens"], j["st16"], j["sq16"],
                catmode=True, scan_mode=scan_mode, raw_sums=True)
        out["sp"] = JM.sharded_liftover_sp(mesh, x["sp_ops"], x["sp_lens"])
        out["pair_table"] = JM.sharded_pair_reduce(mesh, out["stats"][0],
                                                   j["pair_ids"], 3)
        out["coverage"] = JM.sharded_coverage(mesh, j["starts"], j["ends"],
                                              TD.GENOME)
        out["rows"] = _replicate_rows(x["rows"], jax.devices()[:n])
        cache[n] = {k: tuple(np.asarray(a) for a in v) if isinstance(v, tuple)
                    else np.asarray(v) for k, v in out.items()}
        return cache[n]

    return results


def test_dryrun_matches_jax(ranks, jax_dryrun):
    size, per_rank = ranks
    want = jax_dryrun(size)
    for res, _ in per_rank:
        got = res["dryrun"]
        assert set(got) == set(want)
        for name, w in want.items():
            g = got[name]
            for a, b in zip(g if isinstance(g, tuple) else (g,),
                            w if isinstance(w, tuple) else (w,)):
                np.testing.assert_array_equal(a, b, err_msg=name)


def test_dryrun_inputs_are_the_tpu_dryrun_inputs():
    """dryrun_inputs draws the TPU dryrun's arrays (checked through the
    JAX packers on the same seed and order of draws)."""
    from wgatools_tpu.ops import classify as JC
    from wgatools_tpu.ops import liftover as JL

    x = TD.dryrun_inputs(2)
    rng = np.random.default_rng(1)
    pairs = []
    for _ in range(8):
        n = int(rng.integers(100, 256))
        t = rng.choice(list(b"ACGT-"), size=n).astype(np.uint8).tobytes()
        q = rng.choice(list(b"ACGT-"), size=n).astype(np.uint8).tobytes()
        pairs.append((t, q))
    t, q, lens = JC.pack_pairs(pairs)
    for k, want in (("t", t), ("q", q), ("lens", lens)):
        np.testing.assert_array_equal(x[k], want)
    np.testing.assert_array_equal(x["tn"], JC.pack_nibble_words(t, q)[0])
    rng.integers(0, 900, size=8), rng.integers(1, 100, size=8)
    op_chars = np.frombuffer(b"M=XID", np.uint8)
    ops16, lens16 = JL.pack_ops_batch(
        [op_chars[rng.integers(0, 5, 16)] for _ in range(8)],
        [rng.integers(1, 100, 16) for _ in range(8)],
    )
    np.testing.assert_array_equal(x["opw16"], JL.pack_ops_words16(ops16, lens16))
    np.testing.assert_array_equal(x["sp_ops"], op_chars[rng.integers(0, 5, (2, 32))])


# ---- collectives (the payload checks of test_comm_volume.py) -----------------


@pytest.mark.parametrize("name", [
    n for n in FUNCTIONS if n.startswith(("stats", "liftover", "fused16", "adv16"))
])
def test_record_parallel_functions_issue_no_collective(ranks, name):
    for _, comm in ranks[1]:
        assert comm[name] == []


def test_pair_reduce_collective_is_pair_table_sized(ranks):
    want = [("all_reduce", (NUM_PAIRS, 8), "torch.int32")]
    for _, comm in ranks[1]:
        assert comm["pair_reduce"] == comm["pair_reduce_16"] == want
        assert comm["pair_reduce_128"] == want


def test_coverage_collective_is_genome_sized_not_span_sized(ranks):
    for _, comm in ranks[1]:
        assert comm["coverage_8"] == comm["coverage_256"] == [
            ("all_reduce", (1001,), "torch.int32")
        ]


def test_coverage_scatter_collectives(ranks):
    """One [padded] reduce_scatter (each rank keeps padded // D) and one
    [1] carry all_gather, whatever the span count; trim=True adds the
    gather of the result."""
    size, per_rank = ranks
    padded = ((GENOME + 1 + size - 1) // size) * size
    want = [("reduce_scatter_tensor", (padded,), "torch.int32"),
            ("all_gather_into_tensor", (1,), "torch.int32")]
    for _, comm in per_rank:
        assert comm["coverage_scatter_8"] == comm["coverage_scatter_256"] == want
        assert comm["coverage_scatter_shards"] == want
        assert comm["coverage_scatter"] == want + [
            ("all_gather", (padded // size,), "torch.int32")
        ]


def test_sequence_parallel_scan_moves_one_carry_gather(ranks):
    """The only data collective is ONE [2, B] int32 all_gather of shard
    totals, independent of the op count; the overflow check adds one
    [2, B] int64 all_reduce of per-row advance sums."""
    want = [("all_reduce", (2, 4), "torch.int64"),
            ("all_gather_into_tensor", (2, 4), "torch.int32")]
    for _, comm in ranks[1]:
        assert comm["sp_256"] == comm["sp_8192"] == want
        gathers = [c for c in comm["sp1"] if "gather" in c[0]]
        assert gathers == [("all_gather_into_tensor", (2, 5), "torch.int32")]


def test_replicate_rows_is_one_all_gather(ranks):
    for _, comm in ranks[1]:
        assert comm["rows"] == [("all_gather_into_tensor", (1, 16), "torch.uint8")]


# ---- guards -----------------------------------------------------------------


def test_uneven_shards_raise(ranks):
    for res, _ in ranks[1]:
        assert "divide evenly" in res["guards"]["divide"]


def test_overflow_check_raises_on_every_rank(ranks):
    """2.56 G of target advance in one record wraps int32 offsets: every
    rank raises, though no rank's shard reaches 2^31 alone."""
    for res, _ in ranks[1]:
        assert "int32 offsets" in res["guards"]["overflow"]


def test_overflow_check_is_per_direction(ranks):
    ops = np.frombuffer(b"ID" * 128, np.uint8).reshape(1, 256)
    lens = np.full((1, 256), 10_000_000, np.int32)
    want = liftover_scan_ref(torch.from_numpy(ops.copy()), torch.from_numpy(lens))
    for res, _ in ranks[1]:
        for g, w in zip(res["guards"]["mix"], want):
            np.testing.assert_array_equal(g, w.numpy())


# ---- the launcher -----------------------------------------------------------


def _fail_on_rank1(group):
    if group.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return group.rank


def test_spawn_raises_when_a_rank_fails(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        TD.spawn(2, _fail_on_rank1, store_dir=tmp_path)


def test_dryrun_launcher_runs_two_ranks():
    proc = subprocess.run(
        [sys.executable, "-m", "wgatools_tpu_torch.parallel.dryrun",
         "--nproc", "2"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "dryrun: ok on 2 ranks (gloo)"
