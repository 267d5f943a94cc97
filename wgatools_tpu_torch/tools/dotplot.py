"""Dotplot rendering: vega-lite HTML/JSON/CSV (reference: src/tools/dotplot.rs).

Overview mode: one segment per record colored by identity
(dotplot.rs:384-423).  BaseLevel mode: per-CIGAR-op segments with indels
below the cutoff merged into neighboring match segments
(emit_baseplotdatas, reference: src/parser/cigar.rs:807-985).
"""

import copy
import json
from dataclasses import dataclass

import numpy as np

from ..core import cigar as C
from ..core.fmt import RawJson, dumps_serde, fmt_f64_ryu
from ..core.strand import Strand
from ..errors import WGAError
from ..io.maf import MafReader
from ..io.paf import PafReader

# vega-lite v5 spec skeleton (reference: dotplot.rs:41-150)
DOTPLOT_SPEC = {
    "$schema": "https://vega.github.io/schema/vega-lite/v5.json",
    "height": 800,
    "width": 800,
    "data": {"values": []},
    "params": [
        {"name": "zoom", "select": "interval", "bind": "scales"},
        {
            "name": "cigartype",
            "select": {"type": "point", "fields": ["cigar"]},
            "bind": "legend",
        },
    ],
    "mark": {"type": "rule", "tooltip": True, "strokeCap": "round"},
    "transform": [
        {
            "calculate": "datum.ref_chro+':'+toString(datum.ref_start)+'-'+toString(datum.ref_end)",
            "as": "ref",
        },
        {
            "calculate": "datum.query_chro+':'+toString(datum.query_start)+'-'+toString(datum.query_end)",
            "as": "query",
        },
        {"calculate": "abs(datum.ref_end-datum.ref_start)", "as": "ref_len"},
        {
            "calculate": "abs(datum.query_end-datum.query_start)",
            "as": "query_len",
        },
        {
            "as": "cigar",
            "calculate": "datum.cigar == 'M' && datum.query_start > datum.query_end ? 'M_R' : datum.cigar",
        },
    ],
    "encoding": {
        "x": {"field": "ref_start", "type": "quantitative", "title": None},
        "y": {"field": "query_start", "type": "quantitative", "title": None},
        "x2": {"field": "ref_end"},
        "y2": {"field": "query_end"},
        "color": {
            "field": "identity",
            "type": "quantitative",
            "scale": {"scheme": "blues"},
            "legend": {
                "labelFontSize": 20,
                "symbolSize": 10,
                "symbolStrokeWidth": 10,
                "symbolType": "square",
            },
        },
        "tooltip": [
            {"field": "ref", "type": "nominal"},
            {"field": "query", "type": "nominal"},
            {"field": "identity", "type": "nominal"},
            {"field": "ref_len", "type": "quantitative"},
            {"field": "query_len", "type": "quantitative"},
        ],
        "column": {"field": "ref_chro", "title": None},
        "row": {
            "field": "query_chro",
            "header": {"labelAngle": 0},
            "sort": "descending",
            "title": None,
        },
        "opacity": {
            "condition": {"param": "cigartype", "value": 1},
            "value": 0.2,
        },
        "strokeWidth": {
            "condition": {"param": "cigartype", "value": 5},
            "value": 2,
        },
    },
    "resolve": {"scale": {"x": "independent", "y": "independent"}},
}

HTML_TEMPLATE = """<head>
    <script src="https://cdn.jsdelivr.net/npm/vega@5"></script>
    <script src="https://cdn.jsdelivr.net/npm/vega-lite@5"></script>
    <script src="https://cdn.jsdelivr.net/npm/vega-embed@6"></script>
</head>

<body>
    <div id="view" style="display: flex; justify-content: space-evenly;"></div>
    <script>
        const spec = {vl_json};
        vegaEmbed(
            '#view',
            spec
        );
    </script>
</body>
"""

ALL_FIELDS = (
    "ref_start",
    "ref_end",
    "query_start",
    "query_end",
    "identity",
    "ref_chro",
    "query_chro",
)
BASE_FIELDS = (
    "ref_start",
    "ref_end",
    "query_start",
    "query_end",
    "cigar",
    "ref_chro",
    "query_chro",
)


def parse_color_config(color_str: str):
    """Parse "M:#FF0000,I:#00FF00" (reference: dotplot.rs:19-39)."""
    color_map = {}
    for pair in color_str.split(","):
        parts = pair.split(":")
        if len(parts) != 2:
            raise WGAError(
                f"Invalid color format: {pair}. Expected format: M:#FF0000"
            )
        if not parts[1].startswith("#") or len(parts[1]) != 7:
            raise WGAError(
                f"Invalid hex color code: {parts[1]}. Expected format: #RRGGBB"
            )
        color_map[parts[0]] = parts[1]
    return color_map


@dataclass
class RawRows:
    """Rows already formatted in the target output format by the fused
    native pass (serial base-level path).  JSON blobs carry their own
    leading commas -- producers must track first-row state."""

    blob: bytes


@dataclass
class PlotSegs:
    """One record's base-level segments, columnar (the hot representation:
    per-op Python dicts cost ~100x more to build and serialize)."""

    rs: np.ndarray  # int64 ref_start
    re: np.ndarray  # int64 ref_end
    qs: np.ndarray  # int64 query_start
    qe: np.ndarray  # int64 query_end
    cg: np.ndarray  # uint8 op char M/I/D
    ref_chro: str
    query_chro: str

    def rows(self):
        """Dict rows identical to base_plotdata_from_runs output (fallback
        and differential-test bridge)."""
        return [
            {
                "ref_start": int(a),
                "ref_end": int(b),
                "query_start": int(c),
                "query_end": int(d),
                "cigar": chr(e),
                "ref_chro": self.ref_chro,
                "query_chro": self.query_chro,
            }
            for a, b, c, d, e in zip(
                self.rs.tolist(), self.re.tolist(), self.qs.tolist(),
                self.qe.tolist(), self.cg.tolist(),
            )
        ]


def base_plotdata_segments(op_chars, lens, rec, skip_cutoff: int):
    """Columnar segment emission via the C++ state machine; returns a
    PlotSegs or None when the native library is unavailable.  Exactly
    equivalent to base_plotdata_from_runs (differential-tested)."""
    from .. import native

    res = native.plot_segments(
        op_chars,
        lens,
        rec.target_start,
        rec.query_start,
        rec.query_strand == Strand.NEGATIVE,
        skip_cutoff,
    )
    if res is None:
        return None
    rs, re_, qs, qe, cg = res
    return PlotSegs(rs, re_, qs, qe, cg, rec.target_name, rec.query_name)


def base_plotdata_from_runs(op_runs, rec, skip_cutoff: int):
    """Segment emission with short-indel merging
    (emit_baseplotdatas, reference: cigar.rs:815-952).

    op_runs: iterable of (op_char, length).  Negative-strand records swap
    query start/end at segment creation.
    """
    negative = rec.query_strand == Strand.NEGATIVE
    ref_chro = rec.target_name
    query_chro = rec.query_name
    ref_off = rec.target_start
    q_off = rec.query_start
    out = []
    last_m = False

    def push(rs, re_, qs, qe, cigar):
        if negative:
            qs, qe = qe, qs
        out.append(
            {
                "ref_start": rs,
                "ref_end": re_,
                "query_start": qs,
                "query_end": qe,
                "cigar": cigar,
                "ref_chro": ref_chro,
                "query_chro": query_chro,
            }
        )

    for op, length in op_runs:
        if op in ("M", "=", "X"):
            ref_end = ref_off + length
            q_end = q_off + length
            if not last_m:
                push(ref_off, ref_end, q_off, q_end, "M")
            else:
                seg = out[-1]
                if negative:
                    seg["ref_end"] = ref_end
                    seg["query_start"] = q_end
                else:
                    seg["ref_end"] = ref_end
                    seg["query_end"] = q_end
            ref_off += length
            q_off += length
            last_m = True
        elif op == "I":
            q_end = q_off + length
            if length > skip_cutoff:
                push(ref_off, ref_off, q_off, q_end, "I")
                last_m = False
            elif last_m:
                seg = out[-1]
                if negative:
                    seg["query_start"] = q_end
                else:
                    seg["query_end"] = q_end
            q_off += length
        elif op == "D":
            ref_end = ref_off + length
            if length > skip_cutoff:
                push(ref_off, ref_end, q_off, q_off, "D")
                last_m = False
            elif last_m:
                out[-1]["ref_end"] = ref_end
            ref_off += length
    return out


def _overview_row(rec, no_identity: bool):
    """reference: dotplot.rs:384-423."""
    query_start, query_end = rec.query_start, rec.query_end
    if rec.query_strand == Strand.NEGATIVE:
        query_start, query_end = query_end, query_start
    if no_identity:
        identity = 1.0
    else:
        # Rust f64 division never raises: 0/0 -> NaN, n/0 -> inf
        # (calculate_identity, dotplot.rs:416-423); mirror instead of
        # ZeroDivisionError on a degenerate zero-span record
        matched = float(rec.get_stat().matched)
        span = float(rec.target_align_size)
        if span == 0.0:
            identity = float("nan") if matched == 0.0 else float("inf")
        else:
            identity = matched / span
    return {
        "ref_start": rec.target_start,
        "ref_end": rec.target_end,
        "query_start": query_start,
        "query_end": query_end,
        "identity": identity,
        "ref_chro": rec.target_name,
        "query_chro": rec.query_name,
    }


class _FusedRowEmitter:
    """Serial PAF base-level fast path: one native call per record runs
    tokenize + segment state machine + row formatting (RawRows out).
    Tracks JSON first-row state for comma placement and caches escaped
    name tokens."""

    def __init__(self, out_format, skip_cutoff):
        self.csv = out_format == "csv"
        self.cutoff = skip_cutoff
        self.first = True
        self._tok = {}

    def _name_tok(self, name: str) -> bytes:
        tok = self._tok.get(name)
        if tok is None:
            if self.csv:
                tok = _csv_cell(name).encode("utf-8")
            else:
                tok = json.dumps(name, ensure_ascii=False).encode("utf-8")
            self._tok[name] = tok
        return tok

    def __call__(self, rec) -> RawRows:
        from .. import native
        from ..core.cigar import raise_tokenize_error, strip_cg_prefix

        raw = strip_cg_prefix(rec.get_cigar_string()).encode("ascii")
        try:
            blob = native.cigar_text_to_plotdata(
                raw,
                rec.target_start,
                rec.query_start,
                rec.query_strand == Strand.NEGATIVE,
                self.cutoff,
                self._name_tok(rec.target_name),
                self._name_tok(rec.query_name),
                lead_comma=not self.first,
                csv=self.csv,
            )
        except ValueError as e:
            raise_tokenize_error(raw, e.args[0])
        if blob is None:  # lib vanished mid-run: bundle fallback
            ops, lens = rec.get_cigar_ops()
            return base_plotdata_segments(ops, lens, rec, self.cutoff)
        if blob:
            self.first = False
        return RawRows(blob)


_MAF_RUN_CHARS = np.frombuffer(b"=XID", dtype=np.uint8)


def _maf_op_arrays(rec):
    vals, lens = C.ext_runs(
        C.seq_bytes(rec.target_seq), C.seq_bytes(rec.query_seq)
    )
    return _MAF_RUN_CHARS[vals], lens


def _maf_runs(rec):
    ops, lens = _maf_op_arrays(rec)
    return [(chr(o), int(n)) for o, n in zip(ops.tolist(), lens.tolist())]


def _paf_runs(rec):
    ops, lens = rec.get_cigar_ops()
    return [(chr(o), int(n)) for o, n in zip(ops.tolist(), lens.tolist())]


def _fmt_value(v):
    return v


def _values_json(data) -> RawJson:
    """Serialize the row list (dicts and/or PlotSegs bundles) into one raw
    JSON array.  Bundles go through the native row formatter; dict rows
    (overview mode, no-native fallback) through dumps_serde -- identical
    bytes either way (differential-tested)."""
    from .. import native

    parts = []
    for item in data:
        if isinstance(item, RawRows):
            if item.blob:
                parts.append(item.blob.decode("utf-8"))
        elif isinstance(item, PlotSegs):
            blob = native.format_plotdata_json(
                item.rs, item.re, item.qs, item.qe, item.cg,
                json.dumps(item.ref_chro, ensure_ascii=False).encode("utf-8"),
                json.dumps(item.query_chro, ensure_ascii=False).encode("utf-8"),
                lead_comma=bool(parts),
            )
            if blob is None:  # lib vanished: dict fallback
                blob = (
                    ("," if parts else "")
                    + ",".join(dumps_serde(r) for r in item.rows())
                ).encode("utf-8") if item.rs.shape[0] else b""
            if blob:
                parts.append(blob.decode("utf-8"))
        else:
            parts.append(("," if parts else "") + dumps_serde(item))
    return RawJson("[" + "".join(parts) + "]")


def _render(data, writer, out_format, spec, fields):
    if out_format in ("json", "html"):
        spec = copy.deepcopy(spec)
        spec["data"]["values"] = _values_json(data)
        vl_json = dumps_serde(spec)
        if out_format == "json":
            writer.write((vl_json + "\n").encode())
        else:
            writer.write(
                HTML_TEMPLATE.format(vl_json=vl_json).encode() + b"\n"
            )
    else:  # csv
        from .. import native

        out = [(",".join(fields) + "\n").encode()]
        for item in data:
            if isinstance(item, RawRows):
                out.append(item.blob)
            elif isinstance(item, PlotSegs):
                blob = native.format_plotdata_csv(
                    item.rs, item.re, item.qs, item.qe, item.cg,
                    _csv_cell(item.ref_chro).encode("utf-8"),
                    _csv_cell(item.query_chro).encode("utf-8"),
                )
                if blob is None:
                    blob = b"".join(
                        (",".join(_csv_cell(r[f]) for f in fields) + "\n")
                        .encode("utf-8")
                        for r in item.rows()
                    )
                out.append(blob)
            else:
                out.append(
                    (",".join(_csv_cell(item[f]) for f in fields) + "\n")
                    .encode("utf-8")
                )
        writer.write(b"".join(out))
    writer.flush()


def _csv_cell(v):
    if isinstance(v, float):
        # csv crate serializes f64 via ryu pretty (dotplot.rs:284-292)
        return fmt_f64_ryu(v)
    s = str(v)
    if any(c in s for c in ",\"\n"):
        s = '"' + s.replace('"', '""') + '"'
    return s


def dotplot(
    input_path,
    writer,
    format="maf",
    out_format="html",
    mode="base-level",
    no_identity=False,
    skip_cutoff=50,
    query_name=None,
    color=None,
    threads=1,
    dist=False,
):
    """reference: dotplot.rs:192-261.  threads > 1 collects rows with the
    forked record pool (reference rayon sites dotplot.rs:236,303-366);
    dist=True collects across torch.distributed ranks instead."""
    from ..io.compression import open_input

    if format not in ("maf", "paf"):
        raise WGAError("Only support MAF and PAF format")
    spec = copy.deepcopy(DOTPLOT_SPEC)

    if dist:
        from ..parallel.dist_tools import distributed_dotplot_rows

        rows = distributed_dotplot_rows(
            input_path, format, mode, no_identity, skip_cutoff, query_name
        )
    elif threads > 1:
        from ..parallel.host_pool import parallel_dotplot_rows

        rows = parallel_dotplot_rows(
            input_path, threads, format, mode, no_identity, skip_cutoff,
            query_name,
        )
    else:
        reader_stream = open_input(input_path)
        rows = []
        if mode == "overview":
            if format == "maf":
                for rec in MafReader(reader_stream).records():
                    if query_name is not None:
                        rec.set_query_idx_byname(query_name)
                    rows.append(_overview_row(rec, no_identity))
            else:
                for rec in PafReader(reader_stream).records():
                    rows.append(_overview_row(rec, no_identity))
        else:
            from .. import native

            use_native = native.available()
            if format == "maf":
                for rec in MafReader(reader_stream).records():
                    if query_name is not None:
                        rec.set_query_idx_byname(query_name)
                    if use_native:
                        ops, lens = _maf_op_arrays(rec)
                        rows.append(
                            base_plotdata_segments(ops, lens, rec, skip_cutoff)
                        )
                    else:
                        rows.extend(
                            base_plotdata_from_runs(
                                _maf_runs(rec), rec, skip_cutoff
                            )
                        )
            else:
                emit = _FusedRowEmitter(out_format, skip_cutoff)
                for rec in PafReader(reader_stream).records():
                    if use_native:
                        rows.append(emit(rec))
                    else:
                        rows.extend(
                            base_plotdata_from_runs(
                                _paf_runs(rec), rec, skip_cutoff
                            )
                        )

    if mode == "overview":
        _render(rows, writer, out_format, spec, ALL_FIELDS)
    else:
        # BaseLevel spec tweaks (dotplot.rs:240-255)
        spec["encoding"]["x"].setdefault("scale", {})["zero"] = False
        spec["encoding"]["y"].setdefault("scale", {})["zero"] = False
        spec["encoding"]["color"]["scale"]["scheme"] = "category10"
        spec["encoding"]["color"]["field"] = "cigar"
        spec["encoding"]["color"]["type"] = "nominal"
        spec["encoding"]["tooltip"][2]["field"] = "cigar"
        if color is not None:
            color_map = parse_color_config(color)
            spec["encoding"]["color"]["scale"]["domain"] = list(color_map.keys())
            spec["encoding"]["color"]["scale"]["range"] = list(color_map.values())
        _render(rows, writer, out_format, spec, BASE_FIELDS)
