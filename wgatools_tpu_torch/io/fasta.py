"""Indexed FASTA access (.fai), replacing the reference's htslib dependency.

The reference links C htslib via rust-htslib for `.fai`-indexed random
access into plain or bgzip-compressed FASTA (reference:
src/parser/paf.rs:221-238, Cargo.toml:26).  Here the `.fai` text index is
parsed directly; plain files fetch with O(1) seeks, BGZF files fetch
through the block index (wgatools_tpu.io.bgzf), and plain-gzip files fall
back to a one-time in-memory inflate.

Fetch semantics mirror htslib's faidx_fetch_seq: `fetch(name, start, end)`
is 0-based with an *inclusive* end, and `end` is clamped to the sequence
length - 1.
"""

import gzip
import os
from dataclasses import dataclass

from ..errors import FileNotExist, WGAError


@dataclass
class FaiEntry:
    name: str
    length: int
    offset: int
    linebases: int
    linewidth: int


def read_fai(path: str):
    entries = {}
    with open(path, "rt") as fp:
        for line in fp:
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 5:
                continue
            entries[fields[0]] = FaiEntry(
                name=fields[0],
                length=int(fields[1]),
                offset=int(fields[2]),
                linebases=int(fields[3]),
                linewidth=int(fields[4]),
            )
    return entries


def _scan_fai_entries(fp):
    """Scan a (decompressed) FASTA stream for .fai entries; offsets are
    positions in the decompressed byte stream (htslib semantics for both
    plain and bgzf FASTA)."""
    entries = []
    name = None
    length = 0
    offset = 0
    linebases = linewidth = 0
    first_line = True
    pos = 0
    for line in fp:
        line_start = pos
        pos += len(line)
        if line.startswith(b">"):
            if name is not None:
                entries.append((name, length, offset, linebases, linewidth))
            name = line[1:].split()[0].decode()
            length = 0
            offset = pos
            first_line = True
        elif name is not None:
            stripped = line.rstrip(b"\r\n")
            if first_line and stripped:
                linebases = len(stripped)
                linewidth = len(line)
                first_line = False
            length += len(stripped)
    if name is not None:
        entries.append((name, length, offset, linebases, linewidth))
    return entries


def build_fai(fasta_path: str, fai_path: str, bgzf: bool = False):
    """Build a .fai index for a plain or BGZF FASTA file."""
    if bgzf:
        opener = gzip.open(fasta_path, "rb")
    else:
        opener = open(fasta_path, "rb")
    with opener as fp:
        entries = _scan_fai_entries(fp)
    # written under a name of this process's and renamed: the ranks of a
    # distributed pafpseudo may each build the index of one FASTA at once,
    # and none may read another's half-written index
    tmp = f"{fai_path}.{os.getpid()}.tmp"
    with open(tmp, "wt") as out:
        for name, length, offset, lb, lw in entries:
            out.write(f"{name}\t{length}\t{offset}\t{lb}\t{lw}\n")
    os.replace(tmp, fai_path)


class FastaReader:
    """Random access into an indexed FASTA file (plain, BGZF, or gzip)."""

    def __init__(self, path: str):
        if not os.path.exists(path):
            raise FileNotExist(path)
        self.path = path
        self._mode = "plain"
        if path.endswith(".gz"):
            from .bgzf import is_bgzf

            self._mode = "bgzf" if is_bgzf(path) else "gzip"
        fai = path + ".fai"
        if not os.path.exists(fai):
            if self._mode == "gzip":
                raise FileNotExist(fai)
            build_fai(path, fai, bgzf=self._mode == "bgzf")
        self.index = read_fai(fai)
        self._cache = None  # name -> bytes for plain-gzip fallback
        self._fp = None
        self._bgzf = None
        if self._mode == "plain":
            self._fp = open(path, "rb")
        elif self._mode == "bgzf":
            from .bgzf import BgzfReader

            self._bgzf = BgzfReader(path)

    def _load_gz(self):
        if self._cache is not None:
            return
        self._cache = {}
        with gzip.open(self.path, "rb") as fp:
            name = None
            chunks = []
            for line in fp:
                if line.startswith(b">"):
                    if name is not None:
                        self._cache[name] = b"".join(chunks)
                    name = line[1:].split()[0].decode()
                    chunks = []
                else:
                    chunks.append(line.rstrip(b"\r\n"))
            if name is not None:
                self._cache[name] = b"".join(chunks)

    def fetch(self, name: str, start: int, end: int) -> bytes:
        """Fetch bases [start, end] inclusive, 0-based, clamped like htslib."""
        entry = self.index.get(name)
        if entry is None:
            raise WGAError(f"sequence `{name}` not found in {self.path}")
        if end >= entry.length:
            end = entry.length - 1
        if start < 0 or start > end:
            raise WGAError(
                f"invalid fetch range {name}:{start}-{end} (length {entry.length})"
            )
        if self._mode == "gzip":
            self._load_gz()
            return self._cache[name][start : end + 1]
        lb, lw = entry.linebases, entry.linewidth
        byte_start = entry.offset + (start // lb) * lw + (start % lb)
        byte_end = entry.offset + (end // lb) * lw + (end % lb)
        span = byte_end - byte_start + 1
        if self._mode == "bgzf":
            raw = self._bgzf.read_slice(byte_start, span)
        else:
            self._fp.seek(byte_start)
            raw = self._fp.read(span)
        return raw.replace(b"\n", b"").replace(b"\r", b"")

    def close(self):
        if self._fp is not None:
            self._fp.close()
        if self._bgzf is not None:
            self._bgzf.close()
