"""ctypes loader for the native host kernels.

Compiles wganative.cpp with g++ on first use into
build/wgatools_tpu_torch/ beside the package (the kernels' build directory,
kernels/_build.py), rebuilt when the source is newer; every entry point has
a numpy fallback in wgatools_tpu_torch.core.cigar, so a missing toolchain
only costs speed.  The library is written under a temporary name and moved
into place with os.replace, so that processes building it at the same time
never load half a file.  It is compiled with -march=native for the host
that builds it: the build directory belongs to one checkout on one host.
"""

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

log = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "wganative.cpp")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(_HERE)), "build", "wgatools_tpu_torch"
)
_LIB = os.path.join(BUILD_DIR, "libwganative.so")

_lock = threading.Lock()
_lib = None
_tried = False

_i64 = ctypes.c_int64
# Array parameters are declared c_void_p and the wrappers pass
# `arr.ctypes.data` directly: np.ctypeslib.ndpointer's from_param validation
# costs ~15us per argument, which dominates per-record native calls on
# many-small-record inputs (every wrapper below guarantees dtype and
# C-contiguity itself before taking the pointer).
_ptr = ctypes.c_void_p
_charp = ctypes.c_char_p


def _build():
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load():
    """Return the loaded library or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if not os.path.exists(_LIB) or os.path.getmtime(
                _LIB
            ) < os.path.getmtime(_SRC):
                _build()
            lib = ctypes.CDLL(_LIB)
        except Exception as e:  # missing toolchain, sandboxed fs, ...
            log.debug("native library unavailable: %s", e)
            return None
        lib.classify_rle.argtypes = [_ptr, _ptr, _i64, ctypes.c_int, _ptr, _ptr]
        lib.classify_rle.restype = _i64
        lib.tokenize_cigar.argtypes = [_charp, _i64, _ptr, _ptr]
        lib.tokenize_cigar.restype = _i64
        lib.format_runs.argtypes = [_ptr, _ptr, _i64, _charp, _ptr, _i64]
        lib.format_runs.restype = _i64
        lib.reverse_complement.argtypes = [_ptr, _i64, _ptr]
        lib.reverse_complement.restype = _i64
        lib.pack_nibbles.argtypes = [_ptr, _i64, _ptr, _ptr]
        lib.pack_nibbles.restype = ctypes.c_int32
        lib.pack_cats.argtypes = [_ptr, _ptr, _i64, _ptr, _ptr]
        lib.pack_cats.restype = None
        lib.format_bed_lines.argtypes = [
            _charp, _i64, _i64, _ptr, _i64, _ptr, _i64,
        ]
        lib.format_bed_lines.restype = _i64
        lib.format_snp_rows.argtypes = [
            _charp, _i64, _charp, _i64, ctypes.c_char,
            _ptr, _ptr, _ptr, _ptr, _i64, _ptr, _i64, _ptr,
        ]
        lib.format_snp_rows.restype = _i64
        lib.format_indel_rows.argtypes = [
            _charp, _i64, _charp, _i64, ctypes.c_char, _charp, _i64,
            _ptr, _i64, _ptr, _i64, _i64, _i64, _ptr, _ptr, _ptr, _ptr,
            _i64, _ptr, _i64, _ptr,
        ]
        lib.format_indel_rows.restype = _i64
        lib.format_chain_lines.argtypes = [_ptr, _ptr, _ptr, _i64, _ptr, _i64]
        lib.format_chain_lines.restype = _i64
        lib.parse_chain_lines.argtypes = [_charp, _i64, _ptr, _ptr, _ptr]
        lib.parse_chain_lines.restype = _i64
        lib.chain_arrays_to_cg.argtypes = [
            _ptr, _ptr, _ptr, _i64, _ptr, _ptr, _i64,
        ]
        lib.chain_arrays_to_cg.restype = _i64
        lib.chain_text_to_cg.argtypes = [_charp, _i64, _ptr, _ptr, _i64]
        lib.chain_text_to_cg.restype = _i64
        lib.validate_chain_lines.argtypes = [_charp, _i64]
        lib.validate_chain_lines.restype = _i64
        lib.ops_to_chain_block.argtypes = [_ptr, _ptr, _i64, _ptr, _ptr, _i64]
        lib.ops_to_chain_block.restype = _i64
        lib.classify_rle_format.argtypes = [
            _ptr, _ptr, _i64, ctypes.c_int, _charp, _ptr, _ptr, _i64,
        ]
        lib.classify_rle_format.restype = _i64
        lib.safe_chunk_boundary.argtypes = [
            _ptr, _ptr, _i64, _i64, _i64, _i64,
        ]
        lib.safe_chunk_boundary.restype = _i64
        lib.cigar_text_stats.argtypes = [_charp, _i64, _ptr]
        lib.cigar_text_stats.restype = _i64
        lib.plot_segments.argtypes = [
            _ptr, _ptr, _i64, _i64, _i64, ctypes.c_int, _i64,
            _ptr, _ptr, _ptr, _ptr, _ptr,
        ]
        lib.plot_segments.restype = _i64
        lib.format_plotdata_json.argtypes = [
            _ptr, _ptr, _ptr, _ptr, _ptr, _i64,
            _charp, _i64, _charp, _i64, ctypes.c_int, _ptr, _i64,
        ]
        lib.format_plotdata_json.restype = _i64
        lib.format_plotdata_csv.argtypes = [
            _ptr, _ptr, _ptr, _ptr, _ptr, _i64,
            _charp, _i64, _charp, _i64, _ptr, _i64,
        ]
        lib.format_plotdata_csv.restype = _i64
        lib.cigar_text_to_plotdata.argtypes = [
            _charp, _i64, _i64, _i64, ctypes.c_int, _i64,
            _charp, _i64, _charp, _i64, ctypes.c_int, ctypes.c_int,
            _ptr, _i64,
        ]
        lib.cigar_text_to_plotdata.restype = _i64
        lib.cigar_cov_diff.argtypes = [_charp, _i64, _i64, _ptr, _i64]
        lib.cigar_cov_diff.restype = _i64
        lib.cigar_text_to_chain_block.argtypes = [
            _charp, _i64, _ptr, _ptr, _i64,
        ]
        lib.cigar_text_to_chain_block.restype = _i64
        lib.insert_gaps.argtypes = [
            _ptr, _ptr, _i64, _charp, _i64, _charp, _i64, _ptr, _ptr,
        ]
        lib.insert_gaps.restype = _i64
        lib.chain_insert_gaps.argtypes = [
            _ptr, _ptr, _ptr, _i64, _charp, _i64, _charp, _i64, _ptr, _ptr,
        ]
        lib.chain_insert_gaps.restype = _i64
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def loaded() -> bool:
    """Whether load() has run in this process (the library may still be
    unavailable)."""
    return _tried


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

# grow-only scratch buffers: repeated multi-MB np.empty allocations mmap
# and fault fresh pages on every call, dominating the per-chunk cost
_SCRATCH = {}


def _scratch(name, n, dtype):
    buf = _SCRATCH.get(name)
    if buf is None or buf.shape[0] < n:
        buf = np.empty(max(n, 1 << 16), dtype=dtype)
        _SCRATCH[name] = buf
    return buf


def _scratch_ptr(name, n, dtype):
    """(buffer, raw pointer) scratch: `.ctypes.data` costs ~2us per access
    (it builds a ctypes interface object), which dominates small
    per-record native calls -- cache the pointer with the buffer."""
    ent = _SCRATCH_PTR.get(name)
    if ent is None or ent[0].shape[0] < n:
        buf = np.empty(max(n, 1 << 16), dtype=dtype)
        ent = (buf, buf.ctypes.data)
        _SCRATCH_PTR[name] = ent
    return ent


_SCRATCH_PTR = {}


def classify_and_rle(t: np.ndarray, q: np.ndarray, caller: bool = False):
    """Fused classify + RLE; returns (vals uint8, lens int64) or None when
    the native library is unavailable.  The returned arrays are copies (the
    scratch buffers are reused across calls)."""
    lib = load()
    if lib is None:
        return None
    # reference zip semantics: per-column folds stop at the SHORTER row
    # of a malformed record (cigar.rs:344-432); also keeps the C kernel
    # from reading past the shorter buffer (round-5 review finding)
    n = min(t.shape[0], q.shape[0])
    t = np.ascontiguousarray(t[:n])
    q = np.ascontiguousarray(q[:n])
    vals = _scratch("vals", n, np.uint8)
    lens = _scratch("lens", n, np.int64)
    # fused single pass (no intermediate cat array)
    n_runs = lib.classify_rle(
        t.ctypes.data,
        q.ctypes.data,
        n,
        1 if caller else 0,
        vals.ctypes.data,
        lens.ctypes.data,
    )
    return vals[:n_runs].copy(), lens[:n_runs].copy()


def classify_rle_format(t: np.ndarray, q: np.ndarray, caller: bool = False,
                        chars: bytes = b"=XIDW"):
    """Classify + RLE + CIGAR formatting + per-category stats in one
    streaming native pass.  Returns (cigar_body str, stats) where
    stats[2c] / stats[2c+1] are the run events / total columns of category
    c in 0..4, or None when the native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    # zip-to-min like the reference fold (see classify_and_rle above)
    n = min(t.shape[0], q.shape[0])
    t = np.ascontiguousarray(t[:n])
    q = np.ascontiguousarray(q[:n])
    # each run of length L formats to digits(L)+1 <= 2L bytes (L>=1), so
    # 2n+24 bounds the whole string without over-allocating on Mbp records
    cap = 2 * max(n, 1) + 24
    out = _scratch("crfbuf", cap, np.uint8)
    stats = _scratch("crfstats", 10, np.int64)
    w = lib.classify_rle_format(
        t.ctypes.data, q.ctypes.data, n, 1 if caller else 0, chars,
        stats.ctypes.data, out.ctypes.data, cap,
    )
    if w < 0:
        return None
    return out[: int(w)].tobytes().decode("ascii"), stats[:10].tolist()


def tokenize_cigar(cigar: bytes):
    """Returns (ops uint8, lens int64) or None; raises ValueError with the
    error byte offset for malformed strings."""
    lib = load()
    if lib is None:
        return None
    n = len(cigar)
    cap = max(n // 2 + 1, 1)
    ops = np.empty(cap, dtype=np.uint8)
    lens = np.empty(cap, dtype=np.int64)
    res = lib.tokenize_cigar(cigar, n, ops.ctypes.data, lens.ctypes.data)
    if res < 0:
        raise ValueError(-res - 1)
    return ops[: int(res)], lens[: int(res)]


def format_runs(vals: np.ndarray, lens: np.ndarray, chars: bytes):
    lib = load()
    if lib is None:
        return None
    n_runs = len(vals)
    cap = 24 * max(n_runs, 1)
    # scratch avoids ctypes' zero-fill of the whole capacity per call
    out = _scratch("fmtbuf", cap, np.uint8)
    # bind contiguous copies to locals: a bare `.ctypes.data` of a temporary
    # would free the buffer before the foreign call runs
    vals = np.ascontiguousarray(vals, dtype=np.uint8)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    w = lib.format_runs(
        vals.ctypes.data, lens.ctypes.data, n_runs, chars, out.ctypes.data, cap
    )
    if w < 0:
        return None
    return out[: int(w)].tobytes().decode("ascii")


def format_bed_lines(prefix: bytes, start: int, counts: np.ndarray):
    """Bulk per-base BED formatting; returns bytes or None."""
    lib = load()
    if lib is None:
        return None
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    n = counts.shape[0]
    # worst case per line: prefix + 3 tabs + newline + 3x 20-digit ints
    cap = (len(prefix) + 84) * max(n, 1)
    out = np.empty(cap, dtype=np.uint8)
    w = lib.format_bed_lines(
        prefix, len(prefix), start, counts.ctypes.data, n, out.ctypes.data, cap
    )
    if w < 0:
        return None
    return out[: int(w)].tobytes()


def parse_chain_lines(text: bytes):
    """Parse chain data lines into (sizes, dqs, dts) int64 arrays.
    Returns None if the native library is unavailable; raises
    ValueError(byte_pos) on malformed input."""
    lib = load()
    if lib is None:
        return None
    n = len(text)
    max_lines = text.count(b"\n") + 1
    sizes = np.empty(max_lines, dtype=np.int64)
    dqs = np.empty(max_lines, dtype=np.int64)
    dts = np.empty(max_lines, dtype=np.int64)
    res = lib.parse_chain_lines(
        text, n, sizes.ctypes.data, dqs.ctypes.data, dts.ctypes.data
    )
    if res < 0:
        raise ValueError(-res - 1)
    k = int(res)
    return sizes[:k].copy(), dqs[:k].copy(), dts[:k].copy()


def format_chain_lines(sizes, dqs, dts):
    """Bulk chain data-line formatting; returns bytes or None."""
    lib = load()
    if lib is None:
        return None
    sizes = np.ascontiguousarray(sizes, dtype=np.int64)
    dqs = np.ascontiguousarray(dqs, dtype=np.int64)
    dts = np.ascontiguousarray(dts, dtype=np.int64)
    n = sizes.shape[0]
    cap = 66 * max(n, 1)
    out = np.empty(cap, dtype=np.uint8)
    w = lib.format_chain_lines(
        sizes.ctypes.data, dqs.ctypes.data, dts.ctypes.data, n,
        out.ctypes.data, cap,
    )
    if w < 0:
        return None
    return out[: int(w)].tobytes()


def plot_segments(ops: np.ndarray, lens: np.ndarray, ref_off: int,
                  q_off: int, negative: bool, cutoff: int):
    """Dotplot base-level segments (state machine in C++).  Returns
    (rs, re, qs, qe, cg) int64/uint8 arrays or None."""
    lib = load()
    if lib is None:
        return None
    ops = np.ascontiguousarray(ops, dtype=np.uint8)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    n = ops.shape[0]
    rs = np.empty(n, dtype=np.int64)
    re_ = np.empty(n, dtype=np.int64)
    qs = np.empty(n, dtype=np.int64)
    qe = np.empty(n, dtype=np.int64)
    cg = np.empty(n, dtype=np.uint8)
    m = int(lib.plot_segments(
        ops.ctypes.data, lens.ctypes.data, n, ref_off, q_off,
        1 if negative else 0, cutoff,
        rs.ctypes.data, re_.ctypes.data, qs.ctypes.data, qe.ctypes.data,
        cg.ctypes.data,
    ))
    return rs[:m], re_[:m], qs[:m], qe[:m], cg[:m]


def format_plotdata_json(rs, re_, qs, qe, cg, rname_json: bytes,
                         qname_json: bytes, lead_comma: bool):
    """Comma-joined serde_json row objects for one record's segments;
    names are pre-escaped JSON string tokens.  Returns bytes or None."""
    lib = load()
    if lib is None:
        return None
    n = rs.shape[0]
    cap = (len(rname_json) + len(qname_json) + 208) * max(n, 1)
    out = np.empty(cap, dtype=np.uint8)
    w = lib.format_plotdata_json(
        rs.ctypes.data, re_.ctypes.data, qs.ctypes.data, qe.ctypes.data,
        cg.ctypes.data, n, rname_json, len(rname_json), qname_json,
        len(qname_json), 1 if lead_comma else 0, out.ctypes.data, cap,
    )
    if w < 0:
        return None
    return out[: int(w)].tobytes()


def cigar_text_to_plotdata(cg: bytes, ref_off: int, q_off: int,
                           negative: bool, cutoff: int, rname_tok: bytes,
                           qname_tok: bytes, lead_comma: bool, csv: bool):
    """Fully fused dotplot row emission: CIGAR text -> formatted plot rows
    (tokenize + segment state machine + formatting in one native pass).
    Name tokens arrive pre-escaped for the target format.  Returns bytes
    or None; raises ValueError(byte_pos) on a malformed numeric token."""
    lib = load()
    if lib is None:
        return None
    room = len(rname_tok) + len(qname_tok) + 208
    cap = (len(cg) // 2 + 2) * room  # rows <= ops <= ceil(len/2)
    out = np.empty(cap, dtype=np.uint8)
    w = int(lib.cigar_text_to_plotdata(
        cg, len(cg), ref_off, q_off, 1 if negative else 0, cutoff,
        rname_tok, len(rname_tok), qname_tok, len(qname_tok),
        1 if lead_comma else 0, 1 if csv else 0, out.ctypes.data, cap,
    ))
    if w == -1:
        raise AssertionError("cigar_text_to_plotdata capacity bound broken")
    if w < -1:
        raise ValueError(-w - 2)
    return out[:w].tobytes()


def format_plotdata_csv(rs, re_, qs, qe, cg, rname_csv: bytes,
                        qname_csv: bytes):
    """Newline-terminated CSV lines for one record's segments; names are
    pre-quoted per the csv crate's rules.  Returns bytes or None."""
    lib = load()
    if lib is None:
        return None
    n = rs.shape[0]
    cap = (len(rname_csv) + len(qname_csv) + 108) * max(n, 1)
    out = np.empty(cap, dtype=np.uint8)
    w = lib.format_plotdata_csv(
        rs.ctypes.data, re_.ctypes.data, qs.ctypes.data, qe.ctypes.data,
        cg.ctypes.data, n, rname_csv, len(rname_csv), qname_csv,
        len(qname_csv), out.ctypes.data, cap,
    )
    if w < 0:
        return None
    return out[: int(w)].tobytes()


def cigar_cov_diff(cg: bytes, start: int, cov: np.ndarray) -> bool:
    """Fused coverage scatter: CIGAR text -> +/-1 into the int32
    difference array `cov` (its LAST slot is the out-of-range sink, i.e.
    diff_len = len(cov) - 1, matching the host add_spans(cov[:-1], ...)
    call shape).  Returns False when the native library is unavailable;
    raises ValueError(byte_pos) on a malformed numeric token."""
    lib = load()
    if lib is None:
        return False
    r = int(lib.cigar_cov_diff(
        cg, len(cg), start, cov.ctypes.data, cov.shape[0] - 1,
    ))
    if r < 0:
        raise ValueError(-r - 1)
    return True


def cigar_text_stats(cg: bytes):
    """Fused tokenize + PAF-stat scan over CIGAR text.  Returns the
    6-tuple (match, mismatch, ins_event, ins_count, del_event, del_count)
    or None when the native library is unavailable.  Raises
    ValueError(("pos", byte_pos)) on a malformed numeric token and
    ValueError(("op", op_char)) on an op outside {M,=,X,I,D}."""
    lib = load()
    if lib is None:
        return None
    # scratch reuse follows the module convention: callers are processes
    # (fork pool), not threads
    out, out_p = _scratch_ptr("stat6", 6, np.int64)
    r = int(lib.cigar_text_stats(cg, len(cg), out_p))
    if r == 0:
        return tuple(out[:6].tolist())  # scratch is 64k-inflated
    if r < 0:
        raise ValueError(("pos", -r - 1))
    raise ValueError(("op", chr(0 if r == 256 else r)))


def safe_chunk_boundary(t: np.ndarray, q: np.ndarray, start: int,
                        proposed_end: int, cutoff: int):
    """SV-safe chunk boundary scan; returns safe_end or None when the
    native library is unavailable.  t/q must be C-contiguous uint8 of the
    same length."""
    lib = load()
    if lib is None:
        return None
    return int(lib.safe_chunk_boundary(
        t.ctypes.data, q.ctypes.data, t.shape[0], start, proposed_end,
        cutoff,
    ))


def chain_arrays_to_cg(sizes, dqs, dts):
    """Fused chain data-lines -> (cg string, match, ins_ev, ins_ct, del_ev,
    del_ct); one native call replacing interleave + format + 5 reductions.
    Returns None when the native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    sizes = np.ascontiguousarray(sizes, dtype=np.int64)
    dqs = np.ascontiguousarray(dqs, dtype=np.int64)
    dts = np.ascontiguousarray(dts, dtype=np.int64)
    n = sizes.shape[0]
    cap = 66 * max(n, 1)
    out = _scratch("cgbuf", cap, np.uint8)
    stats = _scratch("cgstats", 5, np.int64)
    w = lib.chain_arrays_to_cg(
        sizes.ctypes.data, dqs.ctypes.data, dts.ctypes.data, n,
        stats.ctypes.data, out.ctypes.data, cap,
    )
    if w < 0:
        return None
    cg = out[: int(w)].tobytes().decode("ascii")
    return (cg, int(stats[0]), int(stats[1]), int(stats[2]), int(stats[3]),
            int(stats[4]))


_I64_MIN = -(1 << 63)


def validate_chain_lines(text: bytes):
    """Grammar-check chain data lines without building arrays; returns the
    line count, None when the native library is unavailable, and raises
    ValueError(byte_pos) on malformed input."""
    lib = load()
    if lib is None:
        return None
    res = lib.validate_chain_lines(text, len(text))
    if res < 0:
        raise ValueError(-res - 1)
    return int(res)


def chain_text_to_cg(text: bytes):
    """One-pass chain data-line text -> (cg string, match, ins_ev, ins_ct,
    del_ev, del_ct): parse + emit fused, no intermediate arrays (the
    chain2paf hot body).  Returns None when the native library is
    unavailable; raises ValueError(byte_pos) on malformed input."""
    lib = load()
    if lib is None:
        return None
    n = len(text)
    cap = 70 * (text.count(b"\n") + 2)
    out = _scratch("cgbuf", cap, np.uint8)
    stats = _scratch("cgstats", 5, np.int64)
    w = lib.chain_text_to_cg(text, n, stats.ctypes.data, out.ctypes.data, cap)
    if w == _I64_MIN:
        return None
    if w < 0:
        raise ValueError(-w - 1)
    cg = out[: int(w)].tobytes().decode("ascii")
    return (cg, int(stats[0]), int(stats[1]), int(stats[2]), int(stats[3]),
            int(stats[4]))


def ops_to_chain_block(ops, lens):
    """Fused CIGAR ops -> (data-line text bytes, head_ins, head_del,
    tail_ins, tail_del, final_size): the whole chain-conversion body in one
    native pass.  Returns None when the native library is unavailable;
    raises a ValueError carrying the invalid op char on a non-M/=/X/I/D op
    (matching trims_from_ops, cigar.rs:155-199)."""
    lib = load()
    if lib is None:
        return None
    ops = np.ascontiguousarray(ops, dtype=np.uint8)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    n = ops.shape[0]
    cap = 66 * max(n, 1)
    out = _scratch("chainblk", cap, np.uint8)
    meta = _scratch("chainmeta", 6, np.int64)
    w = lib.ops_to_chain_block(
        ops.ctypes.data, lens.ctypes.data, n, meta.ctypes.data,
        out.ctypes.data, cap,
    )
    if w == -1:
        return None
    if w == -2:
        raise ValueError(chr(int(meta[5])))
    return (out[: int(w)].tobytes(), int(meta[0]), int(meta[1]),
            int(meta[2]), int(meta[3]), int(meta[4]))


def insert_gaps(ops, lens, t_raw: bytes, q_raw: bytes):
    """Gap insertion in one native pass (memcpy/memset per run).  Returns
    (t_gapped, q_gapped) bytes or None; raises ValueError(op_char) on an
    op outside M/=/X/I/D."""
    lib = load()
    if lib is None:
        return None
    if isinstance(t_raw, str):
        t_raw = t_raw.encode("ascii")
    if isinstance(q_raw, str):
        q_raw = q_raw.encode("ascii")
    ops = np.ascontiguousarray(ops, dtype=np.uint8)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    total = int(lens.sum())
    if total == 0:
        # still validate ops like the numpy path (zero-length runs only)
        if ops.shape[0] and not np.all(
            np.isin(ops, np.frombuffer(b"M=XID", dtype=np.uint8))
        ):
            bad = ops[~np.isin(ops, np.frombuffer(b"M=XID", dtype=np.uint8))][0]
            raise ValueError(chr(int(bad)))
        return b"", b""
    if not t_raw or not q_raw:
        # degenerate sources: the numpy formulation substitutes BOTH
        # gather sources with '-' when either is empty
        t_raw = b"-"
        q_raw = b"-"
    t_out = np.empty(total, dtype=np.uint8)
    q_out = np.empty(total, dtype=np.uint8)
    r = int(lib.insert_gaps(
        ops.ctypes.data, lens.ctypes.data, ops.shape[0],
        t_raw, len(t_raw), q_raw, len(q_raw),
        t_out.ctypes.data, q_out.ctypes.data,
    ))
    if r < 0:
        raise ValueError(chr(-r))
    return t_out.tobytes(), q_out.tobytes()


def chain_insert_gaps(sizes, dqs, dts, t_raw: bytes, q_raw: bytes):
    """Chain data lines -> gapped sequences in one native pass (no op
    array materialization).  Returns (t_gapped, q_gapped) bytes or None."""
    lib = load()
    if lib is None:
        return None
    if isinstance(t_raw, str):
        t_raw = t_raw.encode("ascii")
    if isinstance(q_raw, str):
        q_raw = q_raw.encode("ascii")
    sizes = np.ascontiguousarray(sizes, dtype=np.int64)
    dqs = np.ascontiguousarray(dqs, dtype=np.int64)
    dts = np.ascontiguousarray(dts, dtype=np.int64)
    total = int(sizes.sum() + dqs.sum() + dts.sum())
    if total == 0:
        return b"", b""
    if not t_raw or not q_raw:
        t_raw = b"-"
        q_raw = b"-"
    t_out = np.empty(total, dtype=np.uint8)
    q_out = np.empty(total, dtype=np.uint8)
    w = int(lib.chain_insert_gaps(
        sizes.ctypes.data, dqs.ctypes.data, dts.ctypes.data, sizes.shape[0],
        t_raw, len(t_raw), q_raw, len(q_raw),
        t_out.ctypes.data, q_out.ctypes.data,
    ))
    return t_out[:w].tobytes(), q_out[:w].tobytes()


def cigar_text_to_chain_block(cg: bytes):
    """Text-input ops_to_chain_block (tokenize fused in): one native call
    per record on the paf2chain hot path.  Returns the same 6-tuple or
    None; raises ValueError(("op", ch)) / ValueError(("pos", byte_pos))."""
    lib = load()
    if lib is None:
        return None
    cap = 66 * (len(cg) // 2 + 1)
    out, out_p = _scratch_ptr("chainblk", cap, np.uint8)
    meta, meta_p = _scratch_ptr("chainmeta", 6, np.int64)
    w = int(lib.cigar_text_to_chain_block(cg, len(cg), meta_p, out_p,
                                          out.shape[0]))
    if w == -1:
        return None
    if w == -2:
        raise ValueError(("op", chr(int(meta[5]))))
    if w == -3:
        raise ValueError(("pos", int(meta[5])))
    m = meta[:5].tolist()  # NOT meta.tolist(): scratch is 64k-inflated
    return (out[:w].tobytes(), m[0], m[1], m[2], m[3], m[4])


def format_snp_rows(chrom: bytes, qchro: bytes, suffix: bytes, pos, qpos,
                    ref, alt, want_offsets=False):
    """Bulk VCF SNP row formatting; returns bytes (or (bytes, row_end int64
    array) with want_offsets) or None.  One call formats a whole chunk;
    row_end offsets let the caller slice the blob at indel-event
    boundaries without further native calls."""
    lib = load()
    if lib is None:
        return None
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    qpos = np.ascontiguousarray(qpos, dtype=np.int64)
    ref = np.ascontiguousarray(ref, dtype=np.uint8)
    alt = np.ascontiguousarray(alt, dtype=np.uint8)
    n = pos.shape[0]
    cap = (len(chrom) + len(qchro) + 100) * max(n, 1)
    out = np.empty(cap, dtype=np.uint8)
    row_end = np.empty(n if want_offsets else 0, dtype=np.int64)
    w = lib.format_snp_rows(
        chrom, len(chrom), qchro, len(qchro), suffix,
        pos.ctypes.data, qpos.ctypes.data, ref.ctypes.data, alt.ctypes.data,
        n, out.ctypes.data, cap,
        row_end.ctypes.data if want_offsets else None,
    )
    if w < 0:
        return None
    blob = out[: int(w)].tobytes()
    return (blob, row_end) if want_offsets else blob


def format_indel_rows(chrom: bytes, qchro: bytes, suffix: bytes,
                      init_info: bytes, tseq, qseq, t_start: int,
                      q_start: int, t_off, q_off, lens, is_del):
    """Bulk VCF indel (INS/DEL) row formatting in event order; returns
    (bytes, row_end int64 array) or None (callers fall back to per-event
    Python f-strings).  tseq/qseq: gap-free uppercased uint8 sequence
    arrays; per-event arrays are parallel (is_del picks the row shape).
    Any event whose REF/ALT slice falls outside the sequences (negative
    anchor or past-end offset) makes the C++ side return -1 -> None here,
    so malformed offsets can never read out of bounds.
    One call formats every indel row of a chunk -- the per-event Python
    loop + write_record f-strings dominated indel-dense calls."""
    lib = load()
    if lib is None:
        return None
    tseq = np.ascontiguousarray(tseq, dtype=np.uint8)
    qseq = np.ascontiguousarray(qseq, dtype=np.uint8)
    t_off = np.ascontiguousarray(t_off, dtype=np.int64)
    q_off = np.ascontiguousarray(q_off, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    is_del = np.ascontiguousarray(is_del, dtype=np.uint8)
    n = t_off.shape[0]
    # worst-case non-sequence row bytes: 49 fixed chars + 5 int64 fields
    # at <= 19 digits + slack; must be >= the C++ guard's 152 margin
    fixed = len(chrom) + len(qchro) + len(init_info) + 152
    cap = int(lens.sum()) + fixed * max(n, 1)
    out = np.empty(cap, dtype=np.uint8)
    row_end = np.empty(max(n, 1), dtype=np.int64)
    w = lib.format_indel_rows(
        chrom, len(chrom), qchro, len(qchro), suffix,
        init_info, len(init_info),
        tseq.ctypes.data, tseq.shape[0], qseq.ctypes.data, qseq.shape[0],
        t_start, q_start,
        t_off.ctypes.data, q_off.ctypes.data, lens.ctypes.data,
        is_del.ctypes.data, n, out.ctypes.data, cap,
        row_end.ctypes.data,
    )
    if w < 0:
        return None
    return out[: int(w)].tobytes(), row_end[:n]


def pack_cats(t: np.ndarray, q: np.ndarray, lut64k: np.ndarray):
    """CATEGORY-plane packing: one 4-bit classification code per column
    from the 64K (t_byte << 8 | q_byte) -> code LUT
    (ops.classify._CAT_LUT64K -- Python owns the code table).  t, q:
    contiguous uint8 [B, L] with L % 8 == 0.  Returns int32 [B, L//8]
    cat words or None (library unavailable; callers fall back to numpy
    packing)."""
    lib = load()
    if lib is None:
        return None
    assert t.dtype == np.uint8 and t.flags.c_contiguous
    assert q.dtype == np.uint8 and q.flags.c_contiguous
    assert t.shape == q.shape and t.ndim == 2 and t.shape[1] % 8 == 0
    out = np.empty((t.shape[0], t.shape[1] // 2), dtype=np.uint8)
    lib.pack_cats(
        t.ctypes.data, q.ctypes.data, t.size, lut64k.ctypes.data,
        out.ctypes.data,
    )
    return out.view("<i4")


def pack_nibbles(arr: np.ndarray, lut256: np.ndarray):
    """4-bit dictionary packing of a contiguous uint8 [B, L] plane
    (L % 8 == 0) into int32 [B, L//8] nibble words.

    lut256: uint8[256] byte->code map with 0xFF = out-of-dictionary
    (ops.classify._NIB_LUT -- Python owns the alphabet).  Returns the
    packed array or None (library unavailable / out-of-dictionary bytes;
    callers fall back to numpy packing or the byte-word kernel)."""
    lib = load()
    if lib is None:
        return None
    assert arr.dtype == np.uint8 and arr.flags.c_contiguous
    assert arr.ndim == 2 and arr.shape[1] % 8 == 0
    out = np.empty((arr.shape[0], arr.shape[1] // 2), dtype=np.uint8)
    rc = lib.pack_nibbles(
        arr.ctypes.data, arr.size, lut256.ctypes.data, out.ctypes.data
    )
    if rc != 0:
        return None
    return out.view("<i4")


def reverse_complement(seq: np.ndarray):
    """Returns revcomp bytes or raises ValueError(bad_index)."""
    lib = load()
    if lib is None:
        return None
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    out = np.empty_like(seq)
    res = lib.reverse_complement(seq.ctypes.data, seq.shape[0], out.ctypes.data)
    if res != 0:
        raise ValueError(int(res) - 1)
    return out.tobytes()
