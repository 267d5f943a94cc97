"""stat's mapped MAF route (io.maf.map_reader / mapped_records, the native
scan_maf_blocks, tools.stat._mapped_items): on every input the scanner's
records equal MafReader.records() field by field, and stat_maf's device
route writes the same bytes, or raises the same exception class and
message, through the mapping as through MafReader.  Lines the scanner does
not understand fully go through parse_sline and are counted as fallback
blocks; gzip input and stdin keep MafReader.
"""

import gzip
import importlib.util
import io
import os
import sys

import numpy as np
import pytest
import torch

from wgatools_tpu_torch import native
from wgatools_tpu_torch.core.metrics import METRICS
from wgatools_tpu_torch.io import maf
from wgatools_tpu_torch.io.compression import open_input
from wgatools_tpu_torch.io.maf import MafReader, map_reader, mapped_records
from wgatools_tpu_torch.ops import batch
from wgatools_tpu_torch.tools import stat as stat_tool

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = b"##maf version=1\n"


def _pairwise():
    """benchmark/gen/pairwise.py, the cells' input generator."""
    spec = importlib.util.spec_from_file_location(
        "pairwise", os.path.join(REPO, "benchmark", "gen", "pairwise.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _seq(rng, n, alphabet=b"ACGTN-acgt"):
    a = np.frombuffer(alphabet, np.uint8)
    return a[rng.integers(0, len(a), n)].tobytes()


def _s(name, start, size, strand, total, seq, sep=b" ", end=b"\n"):
    fields = [b"s", name, b"%d" % start, b"%d" % size, strand, b"%d" % total,
              seq]
    return sep.join(fields) + end


def _block(rng, names, n=40, sep=b" ", end=b"\n", strands=None):
    """One block of len(names) s-lines of n columns each."""
    strands = strands or [b"+"] * len(names)
    return b"".join(
        _s(name, 10 * k, n, strand, 10_000 + k, _seq(rng, n), sep, end)
        for k, (name, strand) in enumerate(zip(names, strands)))


def _pairwise_text(seed):
    def make(path):
        _pairwise().generate(path, seed, fmt="maf", columns=60_000,
                             block_min=300, block_max=4000, minus_every=3)
    return make


def _text(body):
    def make(path):
        with open(path, "wb") as f:
            f.write(HEADER + body)
    return make


def _lines_case(kinds):
    """Blocks of 1, 2 or 4 s-lines, named t, q, r, u in turn."""
    rng = np.random.default_rng(len(kinds))
    names = [b"t", b"q", b"r", b"u"]
    body = b"".join(b"a score=0\n" + _block(rng, names[:k],
                                            strands=[b"+", b"-", b"+", b"-"])
                    + b"\n" for k in kinds)
    return _text(body)


def _names_vary():
    """Names that change at a line's place from block to block, with equal
    and unequal lengths."""
    rng = np.random.default_rng(7)
    body = b"".join(b"a score=0\n" + _block(rng, [b"chr1", q, b"r"][:k]) + b"\n"
                    for q, k in [(b"q1", 2), (b"q2", 3), (b"q2", 3), (b"q1", 2),
                                 (b"q10", 3), (b"q1", 3)])
    return _text(body)


def _separators():
    rng = np.random.default_rng(3)
    body = b""
    for sep in (b"a score=1\n", b"i t 1 2\n", b"e t 0 1 + 9 I\n",
                b"q t 9999\n", b"# comment\n", b"\n", b"x\n"):
        body += _block(rng, [b"t", b"q"]) + sep
    # two blocks with only a separator line between them, then a trailing
    # run of non-s lines
    body += _block(rng, [b"t", b"q"]) + b"a\n" + _block(rng, [b"t", b"q"])
    return _text(body + b"\n\n# end\n")


def _crlf():
    rng = np.random.default_rng(4)
    return _text(b"a score=0\r\n" + _block(rng, [b"t", b"q"], end=b"\r\n")
                 + b"\r\n" + _block(rng, [b"t", b"q"], sep=b"\t", end=b"\r\n"))


def _trailing_spaces():
    rng = np.random.default_rng(5)
    return _text(_block(rng, [b"t", b"q"], end=b"  \t\n") + b"\n"
                 + _block(rng, [b"t", b"q"], sep=b" \t ", end=b" \r\n"))


def _no_newline_at_eof():
    rng = np.random.default_rng(6)
    return _text(_block(rng, [b"t", b"q"]) + b"\n"
                 + _block(rng, [b"t", b"q"])[:-1])


VALID = {
    "pairwise_seed0": _pairwise_text(0),
    "pairwise_seed1": _pairwise_text(1),
    "pairwise_seed2": _pairwise_text(2),
    "slines_2": _lines_case([2, 2, 2]),
    "slines_4": _lines_case([4, 2, 4]),
    "names_vary": _names_vary(),
    "separators": _separators(),
    "crlf": _crlf(),
    "trailing_spaces": _trailing_spaces(),
    "no_newline_at_eof": _no_newline_at_eof(),
    "header_only": _text(b""),
    "no_blocks": _text(b"# only comments\n\na score=0\n"),
}


def _bad_line(line):
    """A file whose second block holds `line` as its query's s-line."""
    rng = np.random.default_rng(8)
    good = _block(rng, [b"t", b"q"])
    return _text(good + b"\n" + _s(b"t", 0, 4, b"+", 9, b"ACGT") + line
                 + b"\n" + good)


# case -> (the query's s-line, whether the scanner refuses it); MafReader
# accepts '+12', 2^63 - 1, a vertical tab or a byte past 0x7f in a
# sequence and a mode field longer than "s", and raises on the others
ODD_LINES = {
    "fields_6": (b"s q 0 4 + 9\n", True),
    "fields_8": (b"s q 0 4 + 9 ACGT ACGT\n", True),
    "plus_12": (b"s q +12 4 + 99 ACGT\n", False),
    "underscore": (b"s q 1_000 4 + 9999 ACGT\n", True),
    "over_int64": (b"s q 9223372036854775808 4 + 9 ACGT\n", True),
    "int64_max": (b"s q 9223372036854775807 4 + 9 ACGT\n", False),
    "bad_strand": (b"s q 0 4 * 9 ACGT\n", True),
    "non_ascii_name": (b"s q\xc3\xa9 0 4 + 9 ACGT\n", True),
    "tab_in_sequence": (b"s q 0 4 + 9 AC\tGT\n", True),
    "vtab_in_sequence": (b"s q 0 4 + 9 AC\x0bGT\n", True),
    "high_byte_in_sequence": (b"s q 0 4 + 9 AC\xffT\n", True),
    "mode_sx": (b"sx q 0 4 + 9 ACGT\n", True),
    "only_s": (b"s\n", True),
}
ACCEPTED = ("plus_12", "int64_max", "vtab_in_sequence",
            "high_byte_in_sequence", "mode_sx")


def _write(tmp_path, make, name="in.maf"):
    path = str(tmp_path / name)
    make(path)
    return path


def _reader_records(path):
    return [[(s.name, s.start, s.align_size, s.strand, s.size, s.seq)
             for s in rec.slines]
            for rec in MafReader(open_input(path)).records()]


def _scan_records(path):
    reader = MafReader(open_input(path))
    mm = map_reader(reader)
    assert mm is not None
    return [[(*s[:5], mm[s[5].start : s[5].stop]) for s in rec]
            for rec in mapped_records(mm, reader.offset())]


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # the class and message are compared
        return "raised", type(e), str(e)


def _stat(path, mapped, monkeypatch, stdin=False, **kw):
    """stat_maf's device route on the CPU (every block through the stream
    unless `head`), through the mapping or through MafReader; returns
    (outcome, counters)."""
    monkeypatch.setattr(METRICS, "counts", {})
    head = kw.pop("head", False)

    def run():
        with monkeypatch.context() as m:
            if not mapped:
                m.setattr(stat_tool, "map_reader", lambda reader: None)
            out = io.BytesIO()
            stat_tool.stat_maf(MafReader(open_input("-" if stdin else path)),
                               out, CPU, force_device=not head,
                               batch_columns=3000, **kw)
            return out.getvalue()

    return _outcome(run), dict(METRICS.counts)


@pytest.mark.parametrize("case", sorted(VALID))
def test_scanner_records_equal_the_reader(case, tmp_path, monkeypatch):
    path = _write(tmp_path, VALID[case])
    monkeypatch.setattr(METRICS, "counts", {})
    want = _reader_records(path)
    assert _scan_records(path) == want
    assert METRICS.counts.get("native_scan_blocks", 0) == len(want)
    assert "scan_fallback_blocks" not in METRICS.counts


@pytest.mark.parametrize("span", [1, 2, 3])
def test_spans_of_any_size_equal_the_reader(span, tmp_path, monkeypatch):
    """Spans of 1-3 blocks over blocks of 1-9 s-lines: a block that does
    not fit the line table after others waits for the next span, and one
    that does not fit alone grows the table."""
    rng = np.random.default_rng(9)
    names = [b"n%d" % k for k in range(9)]
    body = b"".join(b"a score=0\n" + _block(rng, names[:k], n=5) + b"\n"
                    for k in (2, 4, 9, 1, 5, 9, 2, 2, 3))
    path = _write(tmp_path, _text(body))
    monkeypatch.setattr(maf, "SCAN_BLOCKS", span)
    assert _scan_records(path) == _reader_records(path)


@pytest.mark.parametrize("route", ["stream", "head", "each"])
@pytest.mark.parametrize("case", sorted(VALID))
def test_stat_bytes_equal_the_reader(case, route, tmp_path, monkeypatch):
    """The table through the mapping equals MafReader's and the host
    engine's, in the stream (several batches), in the head's host answer
    below DEVICE_MIN_COLUMNS, and with --each; every block tokenized."""
    path = _write(tmp_path, VALID[case])
    kw = {"head": route == "head", "each": route == "each"}
    got, counts = _stat(path, True, monkeypatch, **kw)
    want, _ = _stat(path, False, monkeypatch, **kw)
    assert got == want and got[0] == "ok"
    host = io.BytesIO()
    stat_tool.stat_maf(MafReader(open_input(path)), host, None,
                       each=kw["each"])
    assert got[1] == host.getvalue()
    assert counts.get("native_scan_blocks", 0) == len(_reader_records(path))
    assert "scan_fallback_blocks" not in counts


@pytest.mark.parametrize("query", ["t", "q", "r", "u", "missing"])
@pytest.mark.parametrize("kinds", [(1,), (2, 4), (4, 4), (2, 1)],
                         ids=["1", "2_4", "4_4", "2_1"])
def test_query_selection_equals_the_reader(kinds, query, tmp_path,
                                           monkeypatch):
    """-q over blocks of 1, 2 and 4 s-lines, and none: the same table, or
    the same QueryNameNotFound / out-of-range query error."""
    path = _write(tmp_path, _lines_case(list(kinds)))
    got, _ = _stat(path, True, monkeypatch, query_name=query)
    want, _ = _stat(path, False, monkeypatch, query_name=query)
    assert got == want
    got, _ = _stat(path, True, monkeypatch)
    want, _ = _stat(path, False, monkeypatch)
    assert got == want


@pytest.mark.parametrize("case", sorted(ODD_LINES))
def test_odd_lines_keep_the_reader_outcome(case, tmp_path, monkeypatch):
    """The same table, or the same exception class and message, through
    the mapping as through MafReader; a block the scanner refuses goes
    through parse_sline and counts one fallback block."""
    line, refused = ODD_LINES[case]
    path = _write(tmp_path, _bad_line(line))
    got, counts = _stat(path, True, monkeypatch)
    want, _ = _stat(path, False, monkeypatch)
    assert got == want
    assert got[0] == ("ok" if case in ACCEPTED else "raised")
    assert counts.get("scan_fallback_blocks", 0) == int(refused)
    if got[0] == "ok":
        assert _scan_records(path) == _reader_records(path)
        assert counts["native_scan_blocks"] == 3 - int(refused)


class _GarbageEmpty:
    """numpy, but np.empty's integer arrays come filled with random
    values, negative and far past any file's size among them."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def __getattr__(self, name):
        return getattr(np, name)

    def empty(self, shape, dtype=float, *args, **kwargs):
        out = np.empty(shape, dtype, *args, **kwargs)
        if np.issubdtype(out.dtype, np.integer):
            out[...] = self.rng.integers(-(1 << 62), 1 << 62, out.shape)
        return out


@pytest.mark.parametrize("span", [1, 2])
@pytest.mark.parametrize("line", [b"sx q 0 4 + 9 ACGT\n",
                                  b"s q\x01 0 4 + 9 ACGT\n"],
                         ids=["mode_sx", "control_byte_name"])
def test_refused_blocks_read_no_unwritten_table_cell(line, span, tmp_path,
                                                     monkeypatch):
    """Over spans of 1 and 2 blocks, with the scanner's tables allocated
    over garbage: a block the scanner refuses (MafReader accepts both)
    gives MafReader's records and table, whatever its unwritten cells
    hold."""
    path = _write(tmp_path, _bad_line(line))
    monkeypatch.setattr(maf, "SCAN_BLOCKS", span)
    monkeypatch.setattr(native, "np", _GarbageEmpty(span))
    got, counts = _stat(path, True, monkeypatch)
    want, _ = _stat(path, False, monkeypatch)
    assert got == want and got[0] == "ok"
    assert counts["scan_fallback_blocks"] == 1
    assert _scan_records(path) == _reader_records(path)


def test_int32_route_through_the_mapping(tmp_path, monkeypatch):
    """Blocks past a lowered INT32_SAFE_COLUMNS take the int64 host engine
    on views of the mapping, in order, with the same table."""
    path = _write(tmp_path, _pairwise_text(0))
    monkeypatch.setattr(batch, "INT32_SAFE_COLUMNS", 1000)
    got, _ = _stat(path, True, monkeypatch, each=True)
    want, _ = _stat(path, False, monkeypatch, each=True)
    assert got == want and got[0] == "ok"


@pytest.mark.parametrize("kind", ["gzip", "stdin"])
def test_gzip_and_stdin_take_the_reader(kind, tmp_path, monkeypatch):
    path = _write(tmp_path, _pairwise_text(1))
    fast, fast_counts = _stat(path, True, monkeypatch)
    assert fast_counts["native_scan_blocks"] > 0
    if kind == "gzip":
        with open(path, "rb") as f:
            data = f.read()
        path = str(tmp_path / "in.maf.gz")
        with gzip.open(path, "wb") as f:
            f.write(data)
        got, counts = _stat(path, True, monkeypatch)
    else:
        # stdin redirected from the regular file itself
        fd = os.open(path, os.O_RDONLY)
        stdin = io.TextIOWrapper(io.BufferedReader(io.FileIO(fd, "rb")))
        monkeypatch.setattr(sys, "stdin", stdin)
        try:
            got, counts = _stat(path, True, monkeypatch, stdin=True)
        finally:
            stdin.close()
    assert got == fast
    assert "native_scan_blocks" not in counts
