"""wgatools_tpu_torch.parallel.{distributed,dist_tools} against
wgatools_tpu.parallel.{distributed,dist_tools}.

The work partitions (claim_work_units, _claimed_offsets with and without a
MAF-index manifest) and the giant-record column split (_giant_indices,
_giant_slice_runs, _merge_run_parts) must equal the JAX package's on the
same seeded inputs, exactly.  The merges run on gloo groups of 1, 2 and 4
spawned ranks: allgather_bytes hands every rank every payload (ragged,
empty and one-byte payloads) in two all_gathers whatever their sizes, and
_psum_row is one int32 all_reduce of the contributing ranks' rows.  Before
a merge the ranks meet on the store: a rank later than the collectives'
timeout still merges, a rank that failed stops the others, and the wait
has its own limit.  `call` on a device takes the serial tool's device
route on every rank, with the JAX package's bytes.  The ranks import this
module to find their functions, so the JAX package is imported only
inside the tests.
"""

import io
import multiprocessing as mp
import os
import queue
import random
import shutil
import time

import numpy as np
import pytest

from wgatools_tpu_torch.io.maf import MafReader
from wgatools_tpu_torch.parallel import dist_tools as DT
from wgatools_tpu_torch.parallel import dryrun as TD
from wgatools_tpu_torch.parallel.distributed import (
    claim_work_units,
    process_index_count,
)
from wgatools_tpu_torch.parallel.host_pool import maf_record_offsets

NPROCS = [1, 2, 3, 4, 7]


@pytest.fixture(scope="module")
def maf(tmp_path_factory):
    """The CLI tests' 9-record MAF, and a copy beside its MAF index."""
    from test_torch_cli import _write_inputs
    from wgatools_tpu_torch.cli import main

    d = tmp_path_factory.mktemp("maf")
    _write_inputs(str(d))
    plain, indexed = str(d / "in.maf"), str(d / "idx.maf")
    shutil.copy(plain, indexed)
    assert main(["maf-index", indexed]) == 0
    return plain, indexed


def _index(rng):
    """A MAF-index-shaped manifest: ref and query entries, shuffled
    offsets."""
    index, offsets = {}, rng.sample(range(10_000), 40)
    for k in range(6):
        ivls = [{"start": 100 * j, "end": 100 * j + 50, "strand": "+",
                 "offset": offsets.pop()} for j in range(rng.randint(0, 6))]
        index[f"s{k}.chr1"] = {"isref": k % 3 != 2, "size": 10_000,
                               "ivls": ivls}
    return index


@pytest.mark.parametrize("nproc", NPROCS)
def test_claim_work_units_matches_jax(nproc):
    from wgatools_tpu.parallel.distributed import claim_work_units as want

    rng = random.Random(nproc)
    for _ in range(5):
        index = _index(rng)
        got = [claim_work_units(index, pid, nproc) for pid in range(nproc)]
        assert got == [want(index, pid, nproc) for pid in range(nproc)]
        flat = [u for units in got for u in units]
        assert len(flat) == len(set(flat))


@pytest.mark.parametrize("indexed", [False, True], ids=["scan", "manifest"])
@pytest.mark.parametrize("nproc", NPROCS)
def test_claimed_offsets_match_jax(maf, nproc, indexed):
    from wgatools_tpu.parallel.dist_tools import _claimed_offsets as want

    path = maf[indexed]
    got = [DT._claimed_offsets(path, pid, nproc) for pid in range(nproc)]
    assert got == [want(path, pid, nproc) for pid in range(nproc)]
    flat = [o for offs in got for o in offs]
    assert len(flat) == len(set(flat)) == 9
    reader = MafReader.from_path(path)
    for off in flat:  # every claimed offset starts a record
        reader.seek(off)
        assert reader.next_record() is not None


def test_giant_indices_match_jax(maf):
    from wgatools_tpu.parallel.dist_tools import _giant_indices as want

    path = maf[0]
    offsets = maf_record_offsets(path)
    sizes = np.diff(offsets + [os.path.getsize(path)])
    seen = set()
    for threshold in (1, *sorted(set(sizes.tolist())), int(sizes.max()) + 1):
        got = DT._giant_indices(path, offsets, threshold)
        assert got == want(path, offsets, threshold)
        seen.add(len(got))
    assert DT._giant_indices(path, [], 1) == want(path, [], 1) == set()
    assert {0, 9} <= seen and len(seen) > 3


def test_giant_threshold_reads_the_variable(monkeypatch):
    from wgatools_tpu.parallel.dist_tools import _giant_threshold as want

    assert DT.GIANT_SPLIT_BYTES == 16 << 20
    assert DT._giant_threshold() == want() == DT.GIANT_SPLIT_BYTES
    monkeypatch.setenv("WGA_TPU_GIANT_SPLIT", "4096")
    assert DT._giant_threshold() == want() == 4096


@pytest.mark.parametrize("nproc", NPROCS)
def test_giant_slice_runs_match_jax_and_merge_to_the_record(maf, nproc):
    from wgatools_tpu.io.maf import MafReader as JaxReader
    from wgatools_tpu.parallel.dist_tools import _giant_slice_runs as want
    from wgatools_tpu_torch.core.cigar import ext_runs, seq_bytes

    path = maf[0]
    ours, theirs = MafReader.from_path(path), JaxReader.from_path(path)
    for rec, ref in zip(ours.records(), theirs.records()):
        parts = [DT._giant_slice_runs(rec, pid, nproc) for pid in range(nproc)]
        for (v, ln), (wv, wln) in zip(
                parts, (want(ref, pid, nproc) for pid in range(nproc))):
            assert v.dtype == wv.dtype and ln.dtype == wln.dtype
            assert np.array_equal(v, wv) and np.array_equal(ln, wln)
        vals, lens = DT._merge_run_parts(parts)
        whole = ext_runs(seq_bytes(rec.target_seq), seq_bytes(rec.query_seq))
        assert np.array_equal(vals, whole[0])
        assert np.array_equal(lens, whole[1])


def test_merge_run_parts_matches_jax():
    from wgatools_tpu.parallel.dist_tools import _merge_run_parts as want

    rng = np.random.default_rng(5)
    for _ in range(200):
        parts = []
        for _ in range(int(rng.integers(0, 6))):
            n = int(rng.integers(0, 4))  # empty slices too
            parts.append((rng.integers(0, 3, n).astype(np.uint8),
                          rng.integers(1, 50, n).astype(np.int64)))
        before = [(v.copy(), ln.copy()) for v, ln in parts]
        got, wanted = DT._merge_run_parts(parts), want(parts)
        for g, w in zip(got, wanted):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        # boundary runs of one category join; inputs are left as they were
        assert not np.any(got[0][1:] == got[0][:-1]) or any(
            np.any(v[1:] == v[:-1]) for v, _ in parts)
        for (v, ln), (bv, bl) in zip(parts, before):
            assert np.array_equal(v, bv) and np.array_equal(ln, bl)


def test_one_process_merges_match_jax():
    """With no group: allgather_bytes returns the payload alone and
    _psum_row the row (zeros where it does not contribute), as the JAX
    package's one-process runs do."""
    from wgatools_tpu.parallel.dist_tools import (
        _allgather_bytes,
        _psum_row,
    )

    assert process_index_count() == (0, 1)
    for payload in (b"", b"x", bytes(range(256)) * 3):
        assert DT.allgather_bytes(payload) == _allgather_bytes(payload)
    row = np.random.default_rng(2).integers(-2**31, 2**31, 37).astype(np.int32)
    for contribute in (True, False):
        got = DT._psum_row(row, contribute)
        assert got.dtype == np.int32
        assert np.array_equal(got, np.asarray(_psum_row(row, contribute)))


# ---- the ranks (spawned processes; no jax here) ----------------------------


def _payloads(size):
    """Named payload sets, one payload per rank."""
    rng = np.random.default_rng(size)
    ragged = [rng.integers(0, 256, int(rng.integers(0, 300)), np.uint8)
              .tobytes() for _ in range(size)]
    return {
        "ragged": ragged,
        "empty": [b""] * size,
        "one_byte": [bytes([r]) for r in range(size)],
        "one_empty": [b""] + [b"\x00" * (7 + r) for r in range(1, size)],
        "large": [bytes([r]) * (1 << 16) for r in range(size)],
    }


def _rows(size):
    rng = np.random.default_rng(100 + size)
    rows = rng.integers(-2**31, 2**31, (size, 1001)).astype(np.int32)
    contribute = [r % 3 != 1 for r in range(size)]
    return rows, contribute


def _rank_merges(group):
    from test_torch_mesh import _counting

    out = {"index_count": process_index_count(), "gathered": {}, "comm": {}}
    for name, payloads in _payloads(group.size).items():
        with _counting() as calls:
            out["gathered"][name] = DT.allgather_bytes(payloads[group.rank])
        out["comm"][name] = calls
    rows, contribute = _rows(group.size)
    with _counting() as calls:
        out["psum"] = DT._psum_row(rows[group.rank], contribute[group.rank])
    out["comm"]["psum"] = calls
    return out


@pytest.fixture(scope="module", params=[1, 2, 4],
                ids=["1rank", "2ranks", "4ranks"])
def merges(request, tmp_path_factory):
    size = request.param
    return size, TD.spawn(size, _rank_merges,
                          store_dir=tmp_path_factory.mktemp(f"store{size}"))


def test_every_rank_knows_its_index_and_count(merges):
    size, got = merges
    assert [g["index_count"] for g in got] == [(r, size) for r in range(size)]


@pytest.mark.parametrize("name", ["ragged", "empty", "one_byte", "one_empty",
                                  "large"])
def test_allgather_bytes_gives_every_rank_every_payload(merges, name):
    size, got = merges
    want = _payloads(size)[name]
    for g in got:
        assert g["gathered"][name] == want
        # the lengths, then the padded rows: two all_gathers at any size
        width = max(max(len(p) for p in want), 1)
        assert g["comm"][name] == [
            ("all_gather_into_tensor", (1, 1), "torch.int64"),
            ("all_gather_into_tensor", (1, width), "torch.uint8"),
        ]


def test_psum_row_sums_the_contributing_rows(merges):
    size, got = merges
    rows, contribute = _rows(size)
    want = rows[np.array(contribute)].sum(axis=0, dtype=np.int32)
    for g in got:
        assert g["psum"].dtype == np.int32
        assert np.array_equal(g["psum"], want)
        assert g["comm"]["psum"] == [("all_reduce", (1001,), "torch.int32")]


# ---- the ranks meet before a merge -----------------------------------------

# the group's timeout in these ranks, and the wait limit of "deadline"
SHORT_TIMEOUT_S = 2
WAIT_S = 1


def _meeting_rank(rank, size, store_path, scenario, start, results):
    """One rank of a gloo group whose collectives time out after
    SHORT_TIMEOUT_S (the ranks start it together, at `start`); the last
    rank comes late ("slow"), fails ("failed") or never comes ("deadline",
    where the others wait WAIT_S)."""
    import torch.distributed as dist

    from wgatools_tpu_torch.parallel import distributed as D

    if scenario == "deadline":
        D.MERGE_WAIT_S = WAIT_S
    start.wait()
    D.init_group("gloo", dist.FileStore(store_path, size), rank, size,
                 "cpu", SHORT_TIMEOUT_S)
    failed = False
    try:
        if rank == size - 1 and scenario != "slow":
            failed = scenario == "failed"
            if scenario == "deadline":
                time.sleep(2 * WAIT_S)
            results.put((rank, None))
            return
        if rank == size - 1:
            time.sleep(2 * SHORT_TIMEOUT_S)
        results.put((rank, DT.allgather_bytes(bytes([rank]) * (rank + 1))))
    except Exception as e:
        results.put((rank, f"{type(e).__name__}: {e}"))
    finally:
        D.shutdown_distributed(failed)


def _meet(scenario, size, tmp):
    ctx = mp.get_context("spawn")
    results, start = ctx.Queue(), ctx.Barrier(size)
    procs = [ctx.Process(target=_meeting_rank, args=(
        r, size, str(tmp / "store"), scenario, start, results))
        for r in range(size)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(size):
            rank, result = results.get(timeout=60)
            got[rank] = result
    except queue.Empty:
        pass
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return got


def test_a_rank_later_than_the_collective_timeout_still_merges(tmp_path):
    got = _meet("slow", 3, tmp_path)
    want = [b"\x00", b"\x01\x01", b"\x02\x02\x02"]
    assert got == {r: want for r in range(3)}


def test_a_failed_rank_stops_the_ranks_at_the_merge(tmp_path):
    t0 = time.monotonic()
    got = _meet("failed", 3, tmp_path)
    assert got[2] is None
    for r in (0, 1):
        assert got[r] == "WGAError: rank 2 failed before merge 1"
    assert time.monotonic() - t0 < 30


def test_the_wait_at_a_merge_has_its_limit(tmp_path):
    got = _meet("deadline", 3, tmp_path)
    assert got[2] is None
    for r in (0, 1):
        assert got[r] == ("WGAError: merge 1: not every rank arrived within "
                          f"{WAIT_S} s")


def test_no_group_no_wait():
    from wgatools_tpu_torch.parallel import distributed as D

    assert D._STORE is None
    D.wait_for_ranks()
    assert D._MERGES == 0


# ---- `call` on the ranks' device -------------------------------------------


@pytest.fixture(scope="module")
def call_maf(tmp_path_factory):
    """The slice tests' three-row MAF of 12 records, plain and beside its
    MAF index."""
    from test_torch_slice import _synth_maf
    from wgatools_tpu_torch.cli import main

    d = tmp_path_factory.mktemp("call")
    data = _synth_maf(11, 12)
    paths = str(d / "in.maf"), str(d / "idx.maf")
    for path in paths:
        with open(path, "wb") as f:
            f.write(data)
    assert main(["maf-index", paths[1]]) == 0
    return paths


def _call_bytes(fn, path, chunk_size, **kw):
    """`call -s -i -l 10` through a distributed driver in this process."""
    out = io.BytesIO()
    fn(path, out, True, True, 10, "s1", None, None, chunk_size, **kw)
    return out.getvalue()


# chunk sizes: small chunks group into one category-plane batch per record;
# past every record each record goes up alone, on the byte planes
CALL_ROUTES = {"grouped": (60, "cat"), "bytes": (10**6, "bytes")}


@pytest.mark.parametrize("indexed", [False, True], ids=["scan", "manifest"])
@pytest.mark.parametrize("route", list(CALL_ROUTES))
def test_one_process_call_takes_the_device_route(call_maf, route, indexed,
                                                 monkeypatch):
    """With a device, distributed_call_maf runs each record through the
    serial tool's device route, as the TPU package's ranks do on the TPU:
    its bytes equal the JAX driver's in device mode and the host
    engine's."""
    import torch
    from test_torch_slice import _jax_device_mode, _route_spy
    from wgatools_tpu.parallel.dist_tools import distributed_call_maf as want
    from wgatools_tpu_torch.tools import caller

    path = call_maf[indexed]
    chunk_size, plane = CALL_ROUTES[route]
    host = _call_bytes(DT.distributed_call_maf, path, chunk_size)
    assert host == _call_bytes(want, path, chunk_size)
    _jax_device_mode(monkeypatch)
    jax_device = _call_bytes(want, path, chunk_size)
    monkeypatch.setattr(caller, "DEVICE_MIN_COLUMNS", 1)
    seen = _route_spy(monkeypatch)
    got = _call_bytes(DT.distributed_call_maf, path, chunk_size,
                      device=torch.device("cpu"))
    assert got == jax_device == host
    assert got.count(b"\n") > 40
    assert plane in seen


def _rank_call(group, path, chunk_size):
    """distributed_call_maf on this rank's device at any record size:
    (the bytes it wrote, the device batches it ran)."""
    from wgatools_tpu_torch.tools import caller

    caller.DEVICE_MIN_COLUMNS = 1
    batches = []
    real = caller.batch_runs
    caller.batch_runs = lambda *a, **k: (batches.append(1), real(*a, **k))[1]
    out = io.BytesIO()
    DT.distributed_call_maf(path, out, True, True, 10, "s1", None, None,
                            chunk_size, device=group.device)
    return out.getvalue(), len(batches)


@pytest.mark.parametrize("indexed", [False, True], ids=["scan", "manifest"])
@pytest.mark.parametrize("size", [2, 4])
def test_every_rank_calls_its_records_on_its_device(call_maf, size, indexed,
                                                   tmp_path):
    from wgatools_tpu_torch.io.maf import MafReader as Reader
    from wgatools_tpu_torch.tools.caller import call_var_maf
    from wgatools_tpu_torch.tools.index import load_index

    path = call_maf[indexed]
    want = io.BytesIO()
    call_var_maf(Reader.from_path(path),
                 load_index(path + ".index") if indexed else None, want,
                 True, True, 10, None, sample="s1", chunk_size=60)
    got = TD.spawn(size, _rank_call, path, 60, store_dir=tmp_path)
    assert got[0][0] == want.getvalue()
    assert all(out == b"" for out, _ in got[1:])
    # 12 records over the ranks: every rank ran device batches
    assert all(batches > 0 for _, batches in got)
