"""The port's copies of the host readers and writers
(wgatools_tpu_torch.io) against the TPU package's (wgatools_tpu.io): MAF,
PAF and chain records parsed from the same text made from a seed have
equal fields, CIGARs, stats and conversions; every writer, the FASTA
fetches (plain, gzip and BGZF), the VCF writer, region parsing and the
compressed inputs and outputs give equal bytes; malformed input raises
errors of the same name and message.  Tolerance 0 throughout.
"""

import dataclasses
import gzip
import io
import os
import random

import numpy as np
import pytest

from synth import build_alignment, make_paf_case, random_ops
from wgatools_tpu import errors as JE
from wgatools_tpu import io as J
from wgatools_tpu.io import bgzf as J_bgzf
from wgatools_tpu.io import chain as J_chain
from wgatools_tpu.io import compression as J_comp
from wgatools_tpu.io import fasta as J_fasta
from wgatools_tpu.io import paf as J_paf
from wgatools_tpu.io import regions as J_regions
from wgatools_tpu.io import vcf as J_vcf
from wgatools_tpu.tools import convert as J_convert
from wgatools_tpu_torch import errors as TE
from wgatools_tpu_torch import io as T
from wgatools_tpu_torch.io import bgzf as T_bgzf
from wgatools_tpu_torch.io import chain as T_chain
from wgatools_tpu_torch.io import compression as T_comp
from wgatools_tpu_torch.io import fasta as T_fasta
from wgatools_tpu_torch.io import paf as T_paf
from wgatools_tpu_torch.io import regions as T_regions
from wgatools_tpu_torch.io import vcf as T_vcf

SEEDS = range(3)


def plain(x):
    """A record, dataclass or container as plain Python values, so that
    the two packages' classes compare by content."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, plain(
            {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}))
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.tolist())
    return x


def outcome(fn, *args, where=None):
    """(plain result, None) or (None, (error class name, message)); the
    directory `where` reads as <d> in a message."""
    try:
        return plain(fn(*args)), None
    except Exception as e:  # both packages' WGAError subclasses
        msg = str(e) if where is None else str(e).replace(str(where), "<d>")
        return None, (type(e).__name__, msg)


def maf_text(seed, n_records=8):
    """Three-row MAF records (every 3rd query on '-'), with gap/gap
    columns and lowercase and IUPAC bases."""
    rng = random.Random(seed)
    out = ["##maf version=1.6\n"]
    t_off = 500
    for i in range(n_records):
        t, q = build_alignment(rng, random_ops(rng, rng.randint(3, 25),
                                               lead_trail_indel=True))
        if i % 2:
            t, q = t[:4].lower() + "--N" + t[4:], q[:4] + "--R" + q[4:]
        o = "".join(c if rng.random() < 0.9 else rng.choice("ACGT-")
                    for c in t.replace("-", "A"))
        out.append(f"a score={i}.5\n")
        for name, seq, strand in (("ref.chr1", t, "+"),
                                  (f"q{i % 2}.chr{i % 3}", q, "-+"[i % 3 != 0]),
                                  ("other.chr1", o, "+")):
            size = sum(1 for c in seq if c != "-")
            out.append(f"s\t{name}\t{t_off}\t{size}\t{strand}\t100000\t{seq}\n")
        out.append("\n")
        t_off += len(t) + 7
    return "".join(out).encode()


def paf_text(seed, n=10):
    rows = [make_paf_case(seed * 100 + i, negative=i % 3 == 0)[0]
            for i in range(n)]
    return ("\n".join(rows) + "\n").encode()


def chain_text(seed):
    out = io.BytesIO()
    J_convert.paf2chain(J.PafReader(io.BytesIO(paf_text(seed))), out,
                        device=False)
    return out.getvalue()


def maf_view(rec):
    return {
        "record": plain(rec),
        "props": [rec.query_name, rec.query_length, rec.query_strand,
                  rec.query_start, rec.query_end, rec.target_name,
                  rec.target_length, rec.target_start, rec.target_end,
                  rec.target_strand, rec.target_align_size, rec.target_seq,
                  rec.query_seq, rec.is_negative],
        "cigar": rec.get_cigar_string(),
        "stat": plain(rec.get_stat()),
        "paf": rec.convert2paf().to_row(),
        "paf_other": rec.convert2paf("other.chr1").to_row(),
    }


@pytest.mark.parametrize("seed", SEEDS)
def test_maf_reader_and_writer(seed):
    data = maf_text(seed)
    jrecs = list(J.MafReader(io.BytesIO(data)).records())
    trecs = list(T.MafReader(io.BytesIO(data)).records())
    assert len(trecs) == len(jrecs) > 0
    for a, b in zip(trecs, jrecs):
        assert maf_view(a) == maf_view(b)
    outs = []
    for mod, recs in ((T, trecs), (J, jrecs)):
        buf = io.BytesIO()
        w = mod.MafWriter(buf)
        w.write_header("##maf version=1.6")
        for rec in recs:
            w.write_record(rec)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("query", [None, "t", "q", "missing"])
@pytest.mark.parametrize("n_lines", [1, 2])
def test_maf_query_selection_fails_alike(n_lines, query):
    """The query s-line of a block of 1 or 2 s-lines, by index or by name:
    the same name and forward-strand coordinates, or the same error (an
    index past the block, a name no s-line has)."""
    lines = [b"s t 10 4 + 100 ACGT", b"s q 5 4 - 50 AC-T"][:n_lines]
    data = b"##maf version=1\n\na score=0\n" + b"\n".join(lines) + b"\n\n"

    def query_of(mod):
        rec = next(mod.MafReader(io.BytesIO(data)).records())
        if query is not None:
            rec.set_query_idx_byname(query)
        return rec.query_name, rec.query_start, rec.query_end

    got, want = outcome(query_of, T), outcome(query_of, J)
    assert got == want
    assert (got[1] is None) == (query == "t" or (
        query != "missing" and n_lines == 2))


def paf_view(rec):
    ops, lens = rec.get_cigar_ops()
    return {"record": plain(rec), "ops": plain(ops), "lens": plain(lens),
            "cigar": rec.get_cigar_string(), "stat": plain(rec.get_stat()),
            "row": rec.to_row(), "strands": (rec.query_strand,
                                             rec.target_strand,
                                             rec.is_negative)}


@pytest.mark.parametrize("seed", SEEDS)
def test_paf_reader_and_writer(seed):
    data = paf_text(seed)
    jrecs = list(J.PafReader(io.BytesIO(data)).records())
    trecs = list(T.PafReader(io.BytesIO(data)).records())
    assert len(trecs) == len(jrecs) == 10
    assert [paf_view(r) for r in trecs] == [paf_view(r) for r in jrecs]
    outs = []
    for mod, recs in ((T, trecs), (J, jrecs)):
        buf = io.BytesIO()
        w = mod.PafWriter(buf)
        for rec in recs:
            w.write_record(rec)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] == data


@pytest.mark.parametrize("line", [
    "q\t10\t0\t10\t+\tt\t10\t0\t10\t10\t10\t60\tcg:Z:5=5S",
    "q\t10\t0\t10\t+\tt\t10\t0\t10\t10\t10\t60\tcg:Z:5=5",
    "q\tx\t0\t10\t+\tt\t10\t0\t10\t10\t10\t60\tcg:Z:10M",
    "q\t10\t0\t10\t*\tt\t10\t0\t10\t10\t10\t60\tcg:Z:10M",
    "q\t10\t0\t10\t+\tt\t10\t0",
    "q\t10\t0\t10\t+\tt\t10\t0\t10\t10\t10\t60\tcs:Z::5*ac:4",
])
def test_paf_malformed_lines_fail_alike(line):
    def parse(mod):
        rec = mod.parse_paf_line(line)
        return paf_view(rec)

    assert outcome(parse, T_paf) == outcome(parse, J_paf)


@pytest.mark.parametrize("cs", [":5*ac:4+gg:3-tt:2", ":10", "*ag*ct:7-a"])
def test_cs_to_cigar(cs):
    assert outcome(T_paf.cs_to_cigar, cs) == outcome(J_paf.cs_to_cigar, cs)


def chain_view(rec):
    return {"header": plain(rec.header), "sizes": plain(rec.sizes),
            "dqs": plain(rec.dqs), "dts": plain(rec.dts),
            "lines": plain(rec.lines), "ops": plain(rec.op_arrays()),
            "cigar": plain(rec.to_cigar()), "stat": plain(rec.get_stat()),
            "paf": rec.convert2paf().to_row(),
            "props": [rec.query_name, rec.query_length, rec.query_start,
                      rec.query_end, rec.query_strand, rec.target_name,
                      rec.target_length, rec.target_start, rec.target_end,
                      rec.target_strand, rec.target_align_size,
                      rec.is_negative]}


@pytest.mark.parametrize("seed", SEEDS)
def test_chain_reader_and_writer(seed):
    data = chain_text(seed)
    jrecs = list(J.ChainReader(io.BytesIO(data)).records())
    trecs = list(T.ChainReader(io.BytesIO(data)).records())
    assert len(trecs) == len(jrecs) == 10
    assert [chain_view(r) for r in trecs] == [chain_view(r) for r in jrecs]
    outs = []
    for mod, recs in ((T_chain, trecs), (J_chain, jrecs)):
        buf = io.BytesIO()
        for rec in recs:
            mod.write_chain_record(buf, rec.header,
                                   (rec.sizes[:-1], rec.dqs[:-1], rec.dts[:-1]),
                                   int(rec.sizes[-1]))
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] == data
    paf = list(T.PafReader(io.BytesIO(paf_text(seed))).records())[0]
    jpaf = list(J.PafReader(io.BytesIO(paf_text(seed))).records())[0]
    assert plain(T_chain.chain_header_from_record(paf, 1, 2, 3, 4)) == plain(
        J_chain.chain_header_from_record(jpaf, 1, 2, 3, 4))


@pytest.mark.parametrize("text", [
    b"chain 1 t 10 + 0 10 q 10 + 0 10 1\n10\n\n",
    b"chain x t 10 + 0 10 q 10 + 0 10 1\n10\n\n",
    b"chain 1 t 10 + 0 10 q 10 + 0 10 1\n4\t1\n\n",
    b"chain 1 t 10 + 0 10 q 10 ? 0 10 1\n10\n\n",
    b"chain 1 t 10 + 0\n10\n\n",
])
def test_chain_malformed_records_fail_alike(text):
    def parse(mod):
        return [chain_view(r) for r in mod.ChainReader(io.BytesIO(text)).records()]

    assert outcome(parse, T) == outcome(parse, J)


@pytest.mark.parametrize("kind", ["plain", "gzip", "bgzf"])
def test_fasta_fetch(kind, tmp_path):
    rng = np.random.default_rng(7)
    alphabet = np.frombuffer(b"ACGTNacgt", np.uint8)
    seqs = {f"s{i}": alphabet[rng.integers(0, 9, int(n))].tobytes()
            for i, n in enumerate(rng.integers(1, 400, 5))}
    text = "".join(f">{k} desc\n" + "\n".join(
        v[j:j + 60].decode() for j in range(0, len(v), 60)) + "\n"
        for k, v in seqs.items()).encode()
    assert T_bgzf.bgzf_compress(text, 300) == J_bgzf.bgzf_compress(text, 300)
    got = {}
    for name, mod in (("port", T_fasta), ("tpu", J_fasta)):
        d = tmp_path / name
        d.mkdir()
        path = d / ("a.fa" if kind == "plain" else "a.fa.gz")
        if kind == "plain":
            path.write_bytes(text)
        elif kind == "gzip":
            path.write_bytes(gzip.compress(text))
        else:
            path.write_bytes(J_bgzf.bgzf_compress(text, 300))
        reader, err = None, None
        try:
            reader = mod.FastaReader(str(path))
        except Exception as e:  # plain gzip has no index to seek by
            err = (type(e).__name__, str(e).replace(str(d), "<d>"))
        fetched = []
        for k, v in seqs.items():
            for start in (0, len(v) // 3):
                if reader is not None:
                    fetched.append(outcome(reader.fetch, k, start, len(v) - 1,
                                          where=d))
        if reader is not None:
            fetched.append(outcome(reader.fetch, "missing", 0, 3, where=d))
            reader.close()
        got[name] = (err, fetched, sorted(p.name for p in d.iterdir()))
    assert got["port"] == got["tpu"]


def test_vcf_writer():
    outs = []
    for mod in (T_vcf, J_vcf):
        buf = io.BytesIO()
        w = mod.VcfWriter(buf, "s1")
        w.write_header([("chr10", 100), ("chr2", 50), ("chrX", 7)])
        w.write_record("chr2", 5, "A", "G", ".", "GT:QI", "1|1:q@4@P")
        w.write_raw(w.format_record("chr10", 9, "AC", "A", "SVTYPE=DEL",
                                    "GT:QI", "1|1:q@8@8@N"))
        w.write_header(None)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("region", [
    "chr1:10-20", "chr1:10", "ref.chr8:181470000-181470050", "chr1",
    "chr1:20-10", "chr1:x-3", ":1-2",
])
def test_parse_region(region):
    assert outcome(T_regions.parse_region, region) == outcome(
        J_regions.parse_region, region)


def test_read_region_file():
    text = "chr1\t10\t20\nchr2\t0\t5\n\nchr3\t7\t9\tname\n"
    assert outcome(T_regions.read_region_file, io.StringIO(text)) == outcome(
        J_regions.read_region_file, io.StringIO(text))


@pytest.mark.parametrize("suffix", ["", ".gz", ".bz2", ".xz"])
def test_compressed_output_and_input(suffix, tmp_path):
    data = maf_text(3)
    got = {}
    for name, mod in (("port", T_comp), ("tpu", J_comp)):
        d = tmp_path / name
        d.mkdir()
        path = str(d / f"out.maf{suffix}")
        w = mod.open_output(path, False)
        w.write(data)
        w.close()
        again = outcome(mod.open_output, path, False, where=d)  # no rewrite
        missing = outcome(mod.open_input, str(d / "none.maf"), where=d)
        with mod.open_input(path) as f:
            got[name] = (f.read(), again[1], missing[1])
    assert got["port"] == got["tpu"]
    assert got["port"][0] == data
    assert got["port"][1][0] == "FileReWrite"


def test_error_classes_match():
    """The port's errors.py is a copy: the same classes, bases and
    messages."""
    names = sorted(n for n in dir(JE) if isinstance(getattr(JE, n), type)
                   and issubclass(getattr(JE, n), Exception))
    assert names == sorted(n for n in dir(TE) if isinstance(getattr(TE, n), type)
                           and issubclass(getattr(TE, n), Exception))
    for n in names:
        j, t = getattr(JE, n), getattr(TE, n)
        assert [b.__name__ for b in t.__mro__] == [b.__name__ for b in j.__mro__]
    assert str(TE.CigarOpInvalid("Q")) == str(JE.CigarOpInvalid("Q"))
    assert os.path.basename(T.__file__) == "__init__.py"
