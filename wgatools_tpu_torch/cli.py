"""`python -m wgatools_tpu_torch`: the wgatools command line on the port.

The parser is the TPU package's own (wgatools_tpu.cli.build_parser), so
subcommands, aliases and flags are the same, and every subcommand runs:

- the device branches run on the port, on the device WGA_TORCH_DEVICE
  names (core.device): `stat` (MAF and PAF), `call -f maf`, `maf2paf`,
  `maf2chain`, `paf2chain`, `chain2paf`, `pafcov` and `validate`;
- the host-only subcommands, `call -f paf`, and `-t > 1` on a plain file
  (the fork pools of wgatools_tpu.parallel.host_pool) go to
  wgatools_tpu.cli.dispatch, the TPU package's own routing, which reaches
  only its jax-free host code there.

The distributed modes (WGA_TPU_DIST) are not ported: the port refuses them
with exit 1 and writes nothing, rather than run the whole tool on every
rank.  WGA_TPU_TRACE=<dir> writes a torch.profiler trace (core.metrics).
"""

import logging
import os

from wgatools_tpu import cli as host_cli
from wgatools_tpu.cli import _wrap_regex_full_match, build_parser
from wgatools_tpu.core.metrics import METRICS
from wgatools_tpu.errors import WGAError
from wgatools_tpu.io.chain import ChainReader
from wgatools_tpu.io.compression import open_input, open_output
from wgatools_tpu.io.maf import MafReader
from wgatools_tpu.io.paf import PafReader
from wgatools_tpu.log import init_logger
from wgatools_tpu.parallel.dist_tools import dist_requested
from wgatools_tpu.parallel.host_pool import is_plain_seekable

from .core.device import torch_device
from .core.metrics import maybe_trace

log = logging.getLogger("wgatools_tpu_torch")

# the subcommands (and aliases) with a device branch on the port
PORTED = {"stat": "stat", "st": "stat", "paf2chain": "paf2chain",
          "p2c": "paf2chain", "maf2paf": "maf2paf", "m2p": "maf2paf",
          "maf2chain": "maf2chain", "m2c": "maf2chain", "call": "call",
          "c": "call", "chain2paf": "chain2paf", "c2p": "chain2paf",
          "pafcov": "pafcov", "pc": "pafcov", "validate": "validate",
          "vf": "validate"}


def main(argv=None):
    args = build_parser().parse_args(argv)
    init_logger(args.verbose)
    if dist_requested():
        log.error("distributed mode (WGA_TPU_DIST) is not yet ported to "
                  "wgatools_tpu_torch: unset it to run one process")
        return 1
    try:
        with maybe_trace(), METRICS.stage("total"):
            dispatch(args)
    except WGAError as e:
        log.error(str(e))
        return 1
    except BrokenPipeError:
        return 0
    finally:
        if args.verbose >= 2:
            METRICS.report()
    return 0


def dispatch(args):
    cmd = PORTED.get(args.command)
    host_route = (
        cmd is None
        or (cmd == "call" and args.format == "paf")
        or (args.threads > 1 and is_plain_seekable(args.input))
    )
    if host_route:
        host_cli.dispatch(args)
        return
    if cmd == "validate":
        _dispatch_validate(args)
        return
    if cmd == "call":
        _dispatch_call(args)
        return
    device = torch_device()
    out, rw = args.outfile, args.rewrite
    if cmd == "paf2chain":
        from .tools.convert import paf2chain

        paf2chain(PafReader(open_input(args.input)), open_output(out, rw),
                  device)
    elif cmd == "chain2paf":
        from .tools.convert import chain2paf

        chain2paf(ChainReader(open_input(args.input)), open_output(out, rw),
                  device)
    elif cmd == "pafcov":
        from .tools.pafcov import pafcov

        pafcov(PafReader(open_input(args.input)), open_output(out, rw), device)
    elif cmd == "stat" and args.format == "paf":
        from .tools.stat import stat_paf

        stat_paf(PafReader(open_input(args.input)), open_output(out, rw),
                 device, args.each)
    elif cmd == "stat":
        from .tools.stat import stat_maf

        stat_maf(MafReader(open_input(args.input)), open_output(out, rw),
                 device, args.each, args.query_name)
    elif cmd == "maf2paf":
        from .tools.convert import maf2paf

        maf2paf(MafReader(open_input(args.input)), open_output(out, rw),
                device, args.query_name)
    else:
        from .tools.convert import maf2chain

        maf2chain(MafReader(open_input(args.input)), open_output(out, rw),
                  device, args.query_name)


def _dispatch_validate(args):
    """`validate [-f FIX]`, the serial branch of wgatools_tpu.cli.dispatch:
    the fixed PAF must not overwrite the input (utils.rs:750-758)."""
    from .tools.validate import validate_paf

    fix_requested = args.fix is not None
    if fix_requested and args.fix == (args.input if args.input else "stdin"):
        raise WGAError("fixed file should not be the same as output file")
    device = torch_device()
    fix_writer = open_output(args.fix, True) if fix_requested else None
    validate_paf(PafReader(open_input(args.input)),
                 open_output(args.outfile, args.rewrite), fix_writer,
                 fix_requested, device)


def _dispatch_call(args):
    """`call -f maf`, the serial branch of wgatools_tpu.cli._dispatch_call:
    contigs from the MAF index beside the input, when there is one."""
    from wgatools_tpu.tools.index import index_path_for, load_index

    from .tools.caller import call_var_maf

    device = torch_device()
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
