"""`python -m wgatools_tpu_torch`: the wgatools command line on the port.

The parser is the TPU package's own (wgatools_tpu.cli.build_parser), so
subcommands, aliases and flags are the same.  `stat` on MAF and
`paf2chain` run on the port; every other subcommand exits 1 as not yet
ported.  The device comes from WGA_TORCH_DEVICE (core.device).  The
multi-process modes of the TPU package (-t > 1, WGA_TPU_DIST) are not
ported: the port runs one process, and its output bytes are the same.
"""

import logging

from wgatools_tpu.cli import build_parser
from wgatools_tpu.core.metrics import METRICS
from wgatools_tpu.errors import WGAError
from wgatools_tpu.io.compression import open_input, open_output
from wgatools_tpu.io.maf import MafReader
from wgatools_tpu.io.paf import PafReader
from wgatools_tpu.log import init_logger

from .core.device import torch_device

log = logging.getLogger("wgatools_tpu_torch")

PORTED = {"stat": "stat", "st": "stat", "paf2chain": "paf2chain",
          "p2c": "paf2chain"}


def main(argv=None):
    args = build_parser().parse_args(argv)
    init_logger(args.verbose)
    cmd = PORTED.get(args.command)
    if cmd is None or (cmd == "stat" and args.format != "maf"):
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
    if cmd == "stat":
        from .tools.stat import stat_maf

        stat_maf(MafReader(open_input(args.input)),
                 open_output(args.outfile, args.rewrite), device, args.each,
                 args.query_name)
    else:
        from .tools.convert import paf2chain

        paf2chain(PafReader(open_input(args.input)),
                  open_output(args.outfile, args.rewrite), device)
