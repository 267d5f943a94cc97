"""`python -m wgatools_tpu_torch`: the wgatools command line on the port.

The parser is the TPU package's own (wgatools_tpu.cli.build_parser), so
subcommands, aliases and flags are the same.  `stat` and `call` on MAF,
`maf2paf`, `maf2chain` and `paf2chain` run on the port; every other
subcommand, and `stat`/`call -f paf`, exits 1 as not yet ported.  The
device comes from WGA_TORCH_DEVICE (core.device).  The multi-process modes
of the TPU package (-t > 1, WGA_TPU_DIST) are not ported: the port runs
one process, and its output bytes are the same.
"""

import logging
import os

from wgatools_tpu.cli import _wrap_regex_full_match, build_parser
from wgatools_tpu.core.metrics import METRICS
from wgatools_tpu.errors import WGAError
from wgatools_tpu.io.compression import open_input, open_output
from wgatools_tpu.io.maf import MafReader
from wgatools_tpu.io.paf import PafReader
from wgatools_tpu.log import init_logger

from .core.device import torch_device

log = logging.getLogger("wgatools_tpu_torch")

PORTED = {"stat": "stat", "st": "stat", "paf2chain": "paf2chain",
          "p2c": "paf2chain", "maf2paf": "maf2paf", "m2p": "maf2paf",
          "maf2chain": "maf2chain", "m2c": "maf2chain", "call": "call",
          "c": "call"}


def main(argv=None):
    args = build_parser().parse_args(argv)
    init_logger(args.verbose)
    cmd = PORTED.get(args.command)
    if cmd is None or (cmd in ("stat", "call") and args.format != "maf"):
        what = f"{args.command} -f {args.format}" if cmd else args.command
        log.error("`%s` is not yet ported to wgatools_tpu_torch", what)
        return 1
    device = torch_device()
    try:
        with METRICS.stage("total"):
            dispatch(cmd, args, device)
    except WGAError as e:
        log.error(str(e))
        return 1
    except BrokenPipeError:
        return 0
    finally:
        if args.verbose >= 2:
            METRICS.report()
    return 0


def dispatch(cmd, args, device):
    if cmd == "paf2chain":
        from .tools.convert import paf2chain

        reader = PafReader(open_input(args.input))
        paf2chain(reader, open_output(args.outfile, args.rewrite), device)
        return
    if cmd == "call":
        _dispatch_call(args, device)
        return
    reader = MafReader(open_input(args.input))
    out = open_output(args.outfile, args.rewrite)
    if cmd == "stat":
        from .tools.stat import stat_maf

        stat_maf(reader, out, device, args.each, args.query_name)
    elif cmd == "maf2paf":
        from .tools.convert import maf2paf

        maf2paf(reader, out, device, args.query_name)
    else:
        from .tools.convert import maf2chain

        maf2chain(reader, out, device, args.query_name)


def _dispatch_call(args, device):
    """`call -f maf`, the serial branch of wgatools_tpu.cli._dispatch_call:
    contigs from the MAF index beside the input, when there is one."""
    from wgatools_tpu.tools.index import index_path_for, load_index

    from .tools.caller import call_var_maf

    mafindex = None
    if args.input and args.input != "-":
        idx_path = index_path_for(args.input)
        if os.path.exists(idx_path):
            mafindex = load_index(idx_path)
    if mafindex is None:
        log.warning("maf index not found, will not generate contig info")
    regex = (_wrap_regex_full_match(args.query_regex) if args.query_regex
             else None)
    call_var_maf(MafReader(open_input(args.input)), mafindex,
                 open_output(args.outfile, args.rewrite), args.snp, args.inv,
                 args.svlen, device, args.sample, args.query_name, regex,
                 args.chunk_size)
