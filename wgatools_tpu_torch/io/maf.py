"""MAF reader/writer with byte-offset tracking.

Host-side tokenizer for the MAF format (reference: src/parser/maf.rs).
Sequences are kept as bytes (not str) so they can be viewed as uint8 arrays
and shipped to the device without copies.

Reader semantics mirror the reference exactly:
  * the first line is always consumed as the header (maf.rs:25-36);
  * records are groups of consecutive 's' lines; any other line separates
    records and is consumed (maf.rs:371-421);
  * the parsed a-line score is ignored -- records always carry score 255
    (maf.rs:375);
  * s-lines must have exactly 7 whitespace-separated fields (maf.rs:138-211).
"""

import ctypes
import io
import mmap
import os
import stat
from dataclasses import dataclass, field

import numpy as np

from ..core.cigar import (
    GAP,
    cigar_from_seqs,
    count_non_gap,
    seq_bytes,
)
from ..core.metrics import METRICS
from ..core.natsort import natural_cmp
from ..core.strand import Strand
from ..errors import (
    ParseIntError,
    ParseMafError,
    QueryNameNotFound,
    SLineCountNotMatch,
    WGAError,
)


def _parse_u64(s: str) -> int:
    # Rust u64::from_str grammar (the reference's serde path): optional
    # leading '+', then ASCII digits only -- Python int() leniency
    # ('1_000', unicode digits, surrounding signs) must not widen the
    # accepted-input set (round-5 review finding)
    d = s[1:] if s[:1] == "+" else s
    if not d.isascii() or not d.isdigit():
        raise ParseIntError(s)
    v = int(d)
    if v > 0x7FFFFFFFFFFFFFFF:  # int64 arrays downstream (see PARITY.md)
        raise ParseIntError(s)
    return v


@dataclass
class MafSLine:
    """One MAF 's' line (reference: maf.rs:64-73)."""

    mode: str
    name: str
    start: int
    align_size: int
    strand: str
    size: int
    seq: bytes

    def seq_array(self) -> np.ndarray:
        return seq_bytes(self.seq)

    def get_col_coord(self, pos: int) -> int:
        """Map a region-relative base position to a column index, skipping
        gaps (reference: maf.rs:81-95).  Returns len(seq) when pos is past
        the last base."""
        arr = self.seq_array()
        non_gap = np.flatnonzero(arr != GAP)
        if pos < non_gap.size:
            return int(non_gap[pos])
        return len(self.seq)


def parse_sline(line: bytes) -> MafSLine:
    """Parse an s-line at the bytes level: the (potentially huge) sequence
    field is never decoded or copied through str.

    maxsplit stops the whitespace scan after the 6 metadata fields -- the
    multi-Mbp seq field is not re-tokenized (it is validated with two
    memchr passes instead; ~10x cheaper on chromosome-scale lines)."""
    fields = line.split(None, 6)
    names = ("mode", "name", "start", "align_size", "strand", "size", "seq")
    if len(fields) < 7:
        missing = names[len(fields)]
        raise ParseMafError(f"S-line Filed `{missing}` Missing")
    mode, name, start, align_size, strand, size, seq = fields
    seq = seq.rstrip()
    if b" " in seq or b"\t" in seq:
        raise ParseMafError("Surplus Filed > 7")
    try:
        return MafSLine(
            mode=chr(mode[0]),
            name=name.decode("ascii"),
            start=_parse_u64(start.decode("ascii")),
            align_size=_parse_u64(align_size.decode("ascii")),
            strand=Strand.parse(strand.decode("ascii")),
            size=_parse_u64(size.decode("ascii")),
            seq=seq,
        )
    except UnicodeDecodeError as e:
        # corrupt / non-ASCII metadata field: a user-facing parse error,
        # not a traceback (the reference's nom str conversion fails the
        # same way, maf.rs parse path)
        raise ParseMafError(f"non-ASCII bytes in s-line field: {e}")


def query_index(n_lines, idx) -> int:
    """`idx`, a block's query s-line among its n_lines, for MafRecord and
    stat's mapped route alike.  The reference panics on an index past the
    block (a Rust index); a WGAError here."""
    if idx >= n_lines:
        raise WGAError(
            f"MAF record has {n_lines} s-line(s) but query index {idx}")
    return idx


def query_by_name(names, name) -> int:
    """The index of the first of a block's s-line names (any iterable, in
    order) equal to `name`; QueryNameNotFound when none is."""
    for i, n in enumerate(names):
        if n == name:
            return i
    raise QueryNameNotFound(name)


def forward_start(start, align_size, strand, size) -> int:
    """A query s-line's start on the forward strand (maf.rs query_start)."""
    if strand == Strand.NEGATIVE:
        return size - start - align_size
    return start


@dataclass
class MafRecord:
    """A MAF alignment block (reference: maf.rs:216-220)."""

    score: int = 255
    slines: list = field(default_factory=list)
    query_idx: int = 1

    # -- AlignRecord surface (reference: maf.rs:424-540) --

    def _query_sline(self) -> MafSLine:
        return self.slines[query_index(len(self.slines), self.query_idx)]

    @property
    def query_name(self) -> str:
        return self._query_sline().name

    @property
    def query_length(self) -> int:
        return self._query_sline().size

    @property
    def query_strand(self) -> str:
        return self._query_sline().strand

    @property
    def query_start(self) -> int:
        s = self._query_sline()
        return forward_start(s.start, s.align_size, s.strand, s.size)

    @property
    def query_end(self) -> int:
        s = self._query_sline()
        if s.strand == Strand.NEGATIVE:
            return s.size - s.start
        return s.start + s.align_size

    @property
    def target_name(self) -> str:
        return self.slines[0].name

    @property
    def target_length(self) -> int:
        return self.slines[0].size

    @property
    def target_start(self) -> int:
        return self.slines[0].start

    @property
    def target_end(self) -> int:
        return self.slines[0].start + self.slines[0].align_size

    @property
    def target_strand(self) -> str:
        return self.slines[0].strand

    @property
    def target_align_size(self) -> int:
        return self.slines[0].align_size

    @property
    def target_seq(self) -> bytes:
        return self.slines[0].seq

    @property
    def query_seq(self) -> bytes:
        if self.query_idx < len(self.slines):
            return self.slines[self.query_idx].seq
        return b""

    @property
    def is_negative(self) -> bool:
        return self.query_strand == Strand.NEGATIVE

    def get_cigar(self, with_h: bool = False):
        begin = self.query_start
        end = self.query_length - self.query_end
        return cigar_from_seqs(
            seq_bytes(self.target_seq),
            seq_bytes(self.query_seq),
            self.is_negative,
            with_h,
            begin,
            end,
        )

    def get_cigar_string(self) -> str:
        return self.get_cigar(False).cigar_string

    def get_stat(self):
        """RecStat via the CIGAR engine (reference: maf.rs:535-540)."""
        from ..core.cigar import rec_stat_from_cigar

        return rec_stat_from_cigar(self.get_cigar(False))

    # -- query selection --

    def get_query_idx_byname(self, name: str):
        for i, s in enumerate(self.slines):
            if s.name == name:
                return i
        return None

    def set_query_idx_byname(self, name: str):
        self.query_idx = query_by_name((s.name for s in self.slines), name)

    def set_query_idx_by_regex(self, regex):
        for i, s in enumerate(self.slines):
            if regex.match(s.name):
                self.query_idx = i
                return
        raise QueryNameNotFound(regex.pattern)

    # -- editing --

    def rename(self, prefixes):
        """Prefix each s-line name positionally (reference: maf.rs:250-261)."""
        if len(prefixes) != len(self.slines):
            raise SLineCountNotMatch()
        for prefix, sline in zip(prefixes, self.slines):
            sline.name = prefix + sline.name

    def slice_block(self, cut_start: int, cut_end: int, ord_: int):
        """Cut this record to a [cut_start, cut_end) interval of s-line
        `ord_`'s sequence coordinates (reference: maf.rs:223-248)."""
        sline = self.slines[ord_]
        cut_start_index = cut_start - sline.start
        cut_end_index = cut_end - sline.start
        sline.start = cut_start
        sline.align_size = cut_end - cut_start
        start_coord = sline.get_col_coord(cut_start_index)
        end_coord = sline.get_col_coord(cut_end_index)
        sline.seq = sline.seq[start_coord:end_coord]
        for i, other in enumerate(self.slines):
            if i == ord_:
                continue
            other.start = other.start + cut_start_index
            new_seq = other.seq[start_coord:end_coord]
            # pre_align_size - gap_count == non-gap count (maf.rs:243-245)
            other.align_size = count_non_gap(new_seq)
            other.seq = new_seq

    def convert2paf(self, query_name=None):
        """Convert to a PafRecord (reference: maf.rs:484-520)."""
        from .paf import PafRecord

        if query_name is not None:
            self.set_query_idx_byname(query_name)
        cigar = self.get_cigar(False)
        matches = cigar.match_count
        block_length = (
            cigar.match_count
            + cigar.mismatch_count
            + cigar.ins_count
            + cigar.inv_ins_count
            + cigar.del_count
            + cigar.inv_del_count
        )
        edit_dist = block_length - matches
        return PafRecord(
            query_name=self.query_name,
            query_length=self.query_length,
            query_start=self.query_start,
            query_end=self.query_end,
            strand=self.query_strand,
            target_name=self.target_name,
            target_length=self.target_length,
            target_start=self.target_start,
            target_end=self.target_end,
            matches=matches,
            block_length=block_length,
            mapq=255,
            tags=[f"NM:i:{edit_dist}", "cg:Z:" + cigar.cigar_string],
        )

    def sort_key(self):
        """Natural order by target name then start (reference: maf.rs:338-351)."""
        return (self.target_name, self.target_start)

    def cmp(self, other) -> int:
        a, b = self.sort_key(), other.sort_key()
        if a[0] == b[0]:
            return (a[1] > b[1]) - (a[1] < b[1])
        return natural_cmp(a[0], b[0])


class MafReader:
    """Streaming MAF reader with byte-offset tracking for indexing."""

    def __init__(self, stream):
        """`stream` is a binary buffered reader."""
        self.inner = stream
        self._offset = 0
        header = self._readline()
        self.header = header.decode("ascii", "replace").rstrip("\r\n")

    @classmethod
    def from_path(cls, path):
        from .compression import open_input

        return cls(open_input(path))

    def _readline(self):
        line = self.inner.readline()
        self._offset += len(line)
        return line

    def offset(self) -> int:
        """Byte offset of the next unread line (stream_position analog)."""
        return self._offset

    def seek(self, offset: int):
        self.inner.seek(offset)
        self._offset = offset

    def records(self):
        """Iterate MafRecords (reference: maf.rs:371-421)."""
        while True:
            rec = self.next_record()
            if rec is None:
                return
            yield rec

    def next_record(self):
        # skip lines until an 's' line
        while True:
            line = self._readline()
            if not line:
                return None
            if line.startswith(b"s"):
                break
        record = MafRecord(score=255, slines=[], query_idx=1)
        record.slines.append(parse_sline(line))
        while True:
            line = self._readline()
            if not line:
                break
            if line.startswith(b"s"):
                record.slines.append(parse_sline(line))
            else:
                # the separating line is consumed, matching the reference
                break
        return record


# blocks a scanner call: bounds its tables, and the first batch waits for
# one span only
SCAN_BLOCKS = 1024


def map_reader(reader):
    """The reader's file mapped read-only, when the reader is a plain
    `open(path, "rb")` of a regular file (an uncompressed path through
    compression.open_input) standing where MafReader has read to; else
    None (stdin, a decompressing stream, an empty file)."""
    inner = reader.inner
    if type(inner) is not io.BufferedReader:
        return None
    raw = inner.raw
    if type(raw) is not io.FileIO or isinstance(raw.name, int):
        return None
    st = os.fstat(raw.fileno())
    if not stat.S_ISREG(st.st_mode) or st.st_size == 0:
        return None
    if inner.tell() != reader.offset():
        return None
    return mmap.mmap(raw.fileno(), 0, access=mmap.ACCESS_READ)


def mapped_records(mm, start):
    """The records of a mapped MAF (map_reader's mapping) from byte `start`,
    in MafReader.records()'s order, each as a list of its s-lines' (name,
    start, align_size, strand, size, seq) with seq the range of the
    sequence's offsets in the mapping (rows for MappedRows).  The native
    scanner tokenizes spans of SCAN_BLOCKS blocks; the lines of a block it
    refuses go through parse_sline, which raises as MafReader does.
    Counters: `native_scan_blocks`, `scan_fallback_blocks`."""
    from .. import native

    base = np.frombuffer(mm, np.uint8)
    while start < base.size:
        blocks, lines, start = native.scan_maf_blocks(base, start, SCAN_BLOCKS)
        METRICS.count("native_scan_blocks", int(blocks[:, 2].sum()))
        rows = lines[:, 2:].tolist()
        names = {}  # name offset -> name, within the span
        for first, n, tokenized in blocks.tolist():
            if tokenized:
                yield [(names.get(r[0]) or _name(names, mm, r[0], r[1]), r[2],
                        r[3], Strand.NEGATIVE if r[4] else Strand.POSITIVE,
                        r[5], range(r[6], r[7]))
                       for r in rows[first : first + n]]
                continue
            METRICS.count("scan_fallback_blocks", 1)
            slines = []
            for lo, hi in lines[first : first + n, :2].tolist():
                line = mm[lo:hi]
                s = parse_sline(line)
                # seq is the line's last field, right-stripped
                end = lo + len(line.rstrip())
                slines.append((s.name, s.start, s.align_size, s.strand,
                               s.size, range(end - len(s.seq), end)))
            yield slines


class BytesRows:
    """Rows held as bytes objects (the sequences of MafReader's records),
    for stat's packer (ops.batch.stream_stat_rows)."""

    @staticmethod
    def addresses(rows, lens) -> np.ndarray:
        """int64 addresses of rows to read lens[k] bytes of each from in
        place; the array keeps the rows alive."""
        return np.frombuffer((ctypes.c_char_p * len(rows))(*rows), np.int64)

    @staticmethod
    def array(row) -> np.ndarray:
        """A row as a uint8 array, not copied."""
        return np.frombuffer(row, np.uint8)


class MappedRows:
    """Rows held as ranges of offsets into one buffer, mapped_records' in
    its mapping: BytesRows' surface over them.  Holds the buffer, so the
    mapping stays open while the rows are read."""

    def __init__(self, buf):
        self.base = np.frombuffer(buf, np.uint8)

    def addresses(self, rows, lens) -> np.ndarray:
        off = np.fromiter((r.start for r in rows), np.int64, len(rows))
        # lens[k] bytes are read from each row: all inside the buffer
        assert off.min(initial=0) >= 0
        assert (off + lens).max(initial=0) <= self.base.size
        return off + self.base.ctypes.data

    def array(self, row) -> np.ndarray:
        return self.base[row.start : row.stop]


def _name(names, mm, offset, n):
    """The name at `offset`, decoded and kept in `names`."""
    name = names[offset] = mm[offset : offset + n].decode("ascii")
    return name


class MafWriter:
    """MAF writer (reference: maf.rs:543-582)."""

    def __init__(self, stream):
        self.inner = stream

    def write_header(self, header: str):
        self.inner.write(header.encode("ascii") + b"\n")

    def write_record(self, record: MafRecord):
        self.inner.write(f"a score={record.score}\n".encode("ascii"))
        for s in record.slines:
            prefix = (
                f"{s.mode}\t{s.name}\t{s.start}\t{s.align_size}\t"
                f"{s.strand}\t{s.size}\t"
            ).encode("ascii")
            self.inner.write(prefix)
            self.inner.write(s.seq if isinstance(s.seq, bytes) else bytes(s.seq))
            self.inner.write(b"\n")
        self.inner.write(b"\n")
