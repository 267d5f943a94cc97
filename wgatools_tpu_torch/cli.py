"""`python -m wgatools_tpu_torch`: the wgatools command line on the port
(reference: src/cli.rs, src/main.rs).

The parser is a copy of wgatools_tpu/cli.py's: the same subcommand names,
visible aliases, and global flags (-o/--outfile, -r/--rewrite,
-t/--threads, -v).  Every subcommand runs on this package:

- the device branches, `stat` (MAF and PAF), `call -f maf`, `maf2paf`,
  `maf2chain`, `paf2chain`, `chain2paf`, `pafcov` and `validate`, run on
  the device WGA_TORCH_DEVICE names ("cuda", the default, or "cpu"), unless
  WGA_TPU_DEVICE is set to "", "0" or "false": then they run the host
  engine, as the TPU package's CLI does, and the process imports no torch
  (core.device; -v logs the route taken);
- the host-only subcommands, `call -f paf`, and `-t > 1` on a plain file
  (the fork pools of parallel.host_pool) run the host engine, and import
  no torch either.

Under WGA_TPU_DIST the distributed modes run where wgatools_tpu/cli.py
runs them: maf2paf, maf2chain, paf2chain, chain2paf, stat (MAF and PAF),
dotplot, `filter -f paf -a N`, pafcov, validate and `call -f maf` on a
plain seekable input (the drivers of parallel.dist_tools), and pafpseudo
on any input (each rank writes its stripe of the targets).  The ranks join
one process group (parallel.distributed: NCCL on the card, gloo on the
CPU) from JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID;
without them the one process runs the driver alone.  Process 0 writes the
output.  A rank keeps its group across the calls of main() in one process
and destroys it at exit, or at once after a call that failed (which marks
the failure on the group's store for the other ranks).
Everywhere else (other subcommands, stdin and compressed inputs) the serial
tool runs, as in the TPU package.  WGA_TPU_TRACE=<dir> writes a
torch.profiler trace (core.metrics).
"""

import argparse
import logging
import os
import re
import sys

from . import __version__
from .core.metrics import METRICS, maybe_trace
from .errors import WGAError
from .log import init_logger

log = logging.getLogger("wgatools_tpu_torch")


def _u64(s):
    """u64-typed flag values (clap rejects negatives for u64/usize
    fields; a negative chunk length would loop forever -- round-5
    review finding)."""
    try:
        v = int(s)
    except ValueError:
        raise argparse.ArgumentTypeError(f"`{s}` is not an integer")
    if v < 0:
        raise argparse.ArgumentTypeError(
            f"`{s}` is negative (u64 in wgatools)"
        )
    return v


def _add_global_flags(p, skip_shorts=()):
    """Global flags on one subparser (clap `global = true`, cli.rs:20-36).

    skip_shorts: shorts shadowed by a subcommand-local flag, exactly as
    clap resolves them -- chain2maf's `-t target` (cli.rs:86-88) and
    maf-ext's `-r regions` (cli.rs:114-117) win over the global
    -t/--threads and -r/--rewrite, which stay reachable long-form."""

    def flag(short, *names, **kw):
        if short.lstrip("-") in skip_shorts:
            p.add_argument(*names, **kw)
        else:
            p.add_argument(short, *names, **kw)

    flag(
        "-o",
        "--outfile",
        default="-",
        help='Output file ("-" for stdout), names ending in .gz/.bz2/.xz '
        "are compressed automatically",
    )
    flag(
        "-r",
        "--rewrite",
        action="store_true",
        help="Bool, if rewrite output file [default: false]",
    )
    flag("-t", "--threads", type=_u64, default=1, help="Threads, default 1")
    flag(
        "-v",
        "--verbose",
        action="count",
        default=0,
        help="Logging level [-v: Info, -vv: Debug, -vvv: Trace, default: Warn]",
    )


def _wrap_regex_full_match(s: str):
    """Regexes are wrapped to full-match (reference: cli.rs:332-343)."""
    pattern = s
    if not pattern.startswith("^"):
        pattern = "^" + pattern
    if not pattern.endswith("$"):
        pattern = pattern + "$"
    return re.compile(pattern)


def build_parser():
    parser = argparse.ArgumentParser(
        prog="wgatools-tpu",
        description="a TPU-native toolkit for Whole Genome Alignment Files "
        "manipulation",
    )
    parser.add_argument("--version", action="version", version=__version__)
    sub = parser.add_subparsers(dest="command", required=True)

    def cmd(name, aliases, help_, skip_shorts=()):
        p = sub.add_parser(name, aliases=aliases, help=help_)
        _add_global_flags(p, skip_shorts)
        return p

    p = cmd("maf2paf", ["m2p"], "Convert MAF format to PAF format")
    p.add_argument("input", nargs="?", default=None)
    p.add_argument("-q", "--query-name", "--query_name",
                   dest="query_name", default=None)

    p = cmd("maf2chain", ["m2c"], "Convert MAF format to Chain format")
    p.add_argument("input", nargs="?", default=None)
    p.add_argument("-q", "--query-name", "--query_name",
                   dest="query_name", default=None)

    p = cmd("paf2maf", ["p2m"], "Convert PAF format to MAF format")
    p.add_argument("input", nargs="?", default=None)
    p.add_argument("-g", "--target", required=True)
    p.add_argument("-q", "--query", required=True)

    p = cmd("paf2chain", ["p2c"], "Convert PAF format to Chain format")
    p.add_argument("input", nargs="?", default=None)

    p = cmd(
        "chain2maf",
        ["c2m"],
        "Convert Chain format to MAF format",
        skip_shorts=("t",),
    )
    p.add_argument("input", nargs="?", default=None)
    # -t shadows the global --threads here, as clap does (cli.rs:86-88);
    # -g kept as a compatibility alias from earlier releases
    p.add_argument("-t", "-g", "--target", required=True)
    p.add_argument("-q", "--query", required=True)

    p = cmd("chain2paf", ["c2p"], "Convert Chain format to PAF format")
    p.add_argument("input", nargs="?", default=None)

    p = cmd("maf-index", ["mi"], "Build index for MAF file")
    p.add_argument("input")

    p = cmd(
        "maf-ext",
        ["me"],
        "Extract specific region from MAF file with index",
        skip_shorts=("r",),
    )
    p.add_argument("input", nargs="?", default=None)
    # -r shadows the global --rewrite here, as clap does (cli.rs:114-117,
    # comma-delimited); -R kept as a compatibility alias
    p.add_argument("-r", "-R", "--regions", default=None)
    p.add_argument("-f", "--file", default=None)

    p = cmd("chunk", ["ch"], "Chunk MAF file by length")
    p.add_argument("input", nargs="?", default=None)
    p.add_argument("-l", "--length", type=_u64, required=True)

    p = cmd("call", ["c"], "Call Variants from MAF/PAF file")
    p.add_argument("input", nargs="?", default=None)
    p.add_argument("-n", "--sample", default="sample")
    p.add_argument("-s", "--snp", action="store_true")
    p.add_argument("-i", "--inv", action="store_true")
    p.add_argument("-l", "--svlen", type=_u64, default=50)
    p.add_argument("-f", "--format", choices=["maf", "paf"], default="maf")
    p.add_argument("--target", default=None)
    p.add_argument("-q", "--query", default=None)
    p.add_argument("--query-name", "--query_name", dest="query_name",
                   default=None)
    p.add_argument("--query-regex", dest="query_regex", default=None)
    p.add_argument("-c", "--chunk-size", "--chunk_size",
                   dest="chunk_size", type=_u64, default=1000000)

    p = cmd("tview", ["tv"], "View MAF file in terminal")
    p.add_argument("input")
    p.add_argument("-s", "--step", type=_u64, default=10)

    p = cmd("stat", ["st"], "Statistics for Alignment file")
    p.add_argument("input", nargs="?", default=None)
    p.add_argument("-f", "--format", choices=["maf", "paf"], default="maf")
    p.add_argument("-e", "--each", action="store_true")
    p.add_argument("-q", "--query-name", "--query_name",
                   dest="query_name", default=None)

    p = cmd("dotplot", ["dp"], "Plot dotplot for Alignment file")
    p.add_argument("input", nargs="?", default=None)
    p.add_argument(
        "-f", "--format", choices=["maf", "paf"], default="maf"
    )
    p.add_argument(
        "--out-format", "--out_format", dest="out_format",
        choices=["html", "json", "csv"], default="html"
    )
    p.add_argument(
        "-m",
        "--mode",
        choices=["base-level", "overview"],
        default="base-level",
    )
    p.add_argument("-d", "--no-identity", "--no_identity",
                   dest="no_identity", action="store_true")
    p.add_argument("-l", "--length", type=_u64, default=None)
    p.add_argument("-q", "--query-name", "--query_name",
                   dest="query_name", default=None)
    p.add_argument("--color", default=None)

    p = cmd("filter", ["fl"], "Filter records for Alignment file")
    p.add_argument("input", nargs="?", default=None)
    p.add_argument(
        "-f", "--format", choices=["maf", "paf", "chain"], default="maf"
    )
    p.add_argument("-b", "--min-block-size", "--min_block_size",
                   dest="min_block_size", type=_u64, default=0)
    p.add_argument("-q", "--min-query-size", "--min_query_size",
                   dest="min_query_size", type=_u64, default=0)
    p.add_argument("-a", "--min-align-size", "--min_align_size",
                   dest="min_align_size", type=_u64, default=None)

    p = cmd("rename", ["rn"], "Rename MAF records with prefix")
    p.add_argument("input", nargs="?", default=None)
    p.add_argument("-p", "--prefixs", required=True)

    p = cmd("maf2sam", ["m2s"], "DEV: maf2sam")
    p.add_argument("input", nargs="?", default=None)
    # EXTRA beyond the reference's stub: a working MAF -> SAM conversion
    # (the reference ignores the input and prints a noodles example,
    # converter.rs:94-125; see PARITY.md)
    p.add_argument("--real", action="store_true")

    p = cmd("pafcov", ["pc"], "Calculate coverage for PAF file")
    p.add_argument("input", nargs="?", default=None)

    p = cmd(
        "pafpseudo",
        ["pp"],
        "Generate pesudo-maf for divergence analysis from PAF file",
    )
    p.add_argument("input", nargs="?", default=None)
    p.add_argument("-f", "--fasta", default=None)
    p.add_argument("-g", "--target", default=None)

    p = cmd("gen-completion", ["gc"], "Generate completion script for shell")
    p.add_argument("-s", "--shell", required=True, choices=["bash", "zsh", "fish"])

    p = cmd(
        "validate",
        ["vf"],
        "Validate and fix query&target position in PAF file by CIGAR",
    )
    p.add_argument("input", nargs="?", default=None)
    p.add_argument("-f", "--fix", default=None)

    # OPTIONAL EXTRA (not reference parity): pileup exists in the
    # reference only as dead code (tools/pileup.rs never compiled,
    # CLI entry commented out at cli.rs:315-324) -- this is a working
    # equivalent with deterministic output; see tools/pileup.py +
    # PARITY.md
    p = cmd("pileup", ["pl"], "EXTRA: merged MAF pileup (dead code in wgatools)")
    p.add_argument("input", nargs="?", default=None)
    p.add_argument("-a", "--all", action="store_true", dest="all_sites")

    # OPTIONAL EXTRA: trimovp is dead code too (tools/trimovp.rs fully
    # commented out; CLI entry commented at cli.rs:286-292 with alias
    # "tr") -- working deterministic equivalent, see tools/trimovp.py
    p = cmd("trimovp", ["tr"], "EXTRA: trim PAF overlaps (dead code in wgatools)")
    p.add_argument("input", nargs="?", default=None)

    # OPTIONAL EXTRA: paf2blocks is dead code (converter.rs:128-145 +
    # cigar.rs:83-152 commented out, no CLI entry ever) -- working
    # equivalent, see tools/convert.py paf2blocks + PARITY.md
    p = cmd("paf2blocks", ["p2b"], "EXTRA: PAF to blocks TSV (dead code in wgatools)")
    p.add_argument("input", nargs="?", default=None)

    return parser


def _start_dist(input_path):
    """Where wgatools_tpu/cli.py starts a distributed driver (under
    WGA_TPU_DIST, on a plain seekable input): join the ranks' process group
    and return True.  False elsewhere, where the serial tool runs."""
    from .parallel.dist_tools import dist_requested
    from .parallel.host_pool import is_plain_seekable

    if dist_requested() and is_plain_seekable(input_path):
        from .parallel.distributed import maybe_initialize_distributed

        maybe_initialize_distributed()
        return True
    return False


def main(argv=None):
    from .parallel.dist_tools import dist_requested

    args = build_parser().parse_args(argv)
    init_logger(args.verbose)
    done = False
    try:
        with maybe_trace(), METRICS.stage("total"):
            dispatch(args)
            METRICS.settle(wait=True)
        done = True
    except WGAError as e:
        log.error(str(e))
        return 1
    except BrokenPipeError:
        return 0
    finally:
        if dist_requested() and not done:
            from .parallel.distributed import shutdown_distributed

            shutdown_distributed(failed=True)
        _log_launches()
        if args.verbose >= 2:
            METRICS.report()
    return 0


def _log_launches():
    """-v: the launches of each kernel this process made, as JSON, when it
    loaded the kernels (each rank of a distributed run says its own)."""
    import json
    import sys

    build = sys.modules.get(f"{__package__}.kernels._build")
    if build is not None:
        log.info("kernel launches: %s", json.dumps(build.LAUNCHES))


def _device():
    """The device of a device branch: None, the host engine, when
    WGA_TPU_DEVICE is "", "0" or "false" (torch is not imported); else the
    torch device WGA_TORCH_DEVICE names.  -v logs which.

    The device route's process start happens here, each part in its METRICS
    stage the first time: `import_torch`, `cuda_init` (the first allocation
    on the card creates the context) and `lib_load` (the native library)."""
    from . import native
    from .core.device import ROUTE_ENV, device_requested, torch_device

    if not device_requested():
        log.info("route: the host engine (%s=%r)", ROUTE_ENV,
                 os.environ[ROUTE_ENV])
        return None
    if "torch" not in sys.modules:
        with METRICS.stage("import_torch"):
            import torch  # noqa: F401
    device = torch_device()
    if device.type == "cuda":
        import torch

        if not torch.cuda.is_initialized():
            with METRICS.stage("cuda_init"):
                torch.empty(1, device=device)
        log.info("route: device %s (%s)", device,
                 torch.cuda.get_device_name(device))
    else:
        log.info("route: device %s", device)
    if not native.loaded():
        with METRICS.stage("lib_load"):
            native.load()
    return device


def dispatch(args):
    from .io.chain import ChainReader
    from .io.compression import open_input, open_output
    from .io.maf import MafReader
    from .io.paf import PafReader
    from .parallel.host_pool import is_plain_seekable

    cmd = args.command
    out = args.outfile
    rw = args.rewrite
    # the fork pools of -t > 1 need a plain (seekable, uncompressed) file
    pooled = getattr(args, "threads", 1) > 1 and is_plain_seekable(
        getattr(args, "input", None))

    if cmd in ("maf2paf", "m2p"):
        from .parallel.host_pool import parallel_maf2paf
        from .tools.convert import maf2paf

        if _start_dist(args.input):
            from .parallel.dist_tools import dist_output, distributed_maf2paf

            distributed_maf2paf(
                args.input, dist_output(out, rw), args.query_name
            )
        elif pooled:
            parallel_maf2paf(
                args.input, open_output(out, rw), args.threads, args.query_name
            )
        else:
            maf2paf(MafReader(open_input(args.input)), open_output(out, rw),
                    _device(), args.query_name)
    elif cmd in ("maf2chain", "m2c"):
        from .parallel.host_pool import parallel_maf2chain
        from .tools.convert import maf2chain

        if _start_dist(args.input):
            from .parallel.dist_tools import dist_output, distributed_maf2chain

            distributed_maf2chain(
                args.input, dist_output(out, rw), args.query_name
            )
        elif pooled:
            parallel_maf2chain(
                args.input, open_output(out, rw), args.threads, args.query_name
            )
        else:
            maf2chain(MafReader(open_input(args.input)), open_output(out, rw),
                      _device(), args.query_name)
    elif cmd in ("paf2maf", "p2m"):
        from .tools.convert import paf2maf

        paf2maf(
            PafReader(open_input(args.input)),
            open_output(out, rw),
            args.target,
            args.query,
        )
    elif cmd in ("paf2chain", "p2c"):
        from .parallel.host_pool import parallel_paf2chain
        from .tools.convert import paf2chain

        if _start_dist(args.input):
            from .parallel.dist_tools import dist_output, distributed_paf2chain

            distributed_paf2chain(args.input, dist_output(out, rw))
        elif pooled:
            parallel_paf2chain(args.input, open_output(out, rw), args.threads)
        else:
            paf2chain(PafReader(open_input(args.input)), open_output(out, rw),
                      _device())
    elif cmd in ("chain2maf", "c2m"):
        from .tools.convert import chain2maf

        chain2maf(
            ChainReader(open_input(args.input)),
            open_output(out, rw),
            args.target,
            args.query,
        )
    elif cmd in ("chain2paf", "c2p"):
        from .parallel.host_pool import parallel_chain2paf
        from .tools.convert import chain2paf

        if _start_dist(args.input):
            from .parallel.dist_tools import dist_output, distributed_chain2paf

            distributed_chain2paf(args.input, dist_output(out, rw))
        elif pooled:
            parallel_chain2paf(args.input, open_output(out, rw), args.threads)
        else:
            chain2paf(ChainReader(open_input(args.input)),
                      open_output(out, rw), _device())
    elif cmd in ("maf2sam", "m2s"):
        from .tools.convert import maf2sam

        maf2sam(
            MafReader(open_input(args.input)), open_output(out, rw),
            real=args.real,
        )
    elif cmd in ("maf-index", "mi"):
        from .tools.index import build_index, index_path_for

        outpath = index_path_for(args.input) if out == "-" else out
        build_index(MafReader.from_path(args.input), open_output(outpath, True))
    elif cmd in ("maf-ext", "me"):
        from .errors import StdinNotAllowed
        from .tools.index import index_path_for, load_index
        from .tools.mafextra import maf_extract_idx

        if args.input is None or args.input == "-":
            raise StdinNotAllowed()
        regions = args.regions.split(",") if args.regions else None
        mafindex = load_index(index_path_for(args.input))
        failed = maf_extract_idx(
            regions,
            args.file,
            MafReader.from_path(args.input),
            mafindex,
            open_output(out, rw),
        )
        for region in failed:
            log.warning("Failed region: %s", region)
    elif cmd in ("chunk", "ch"):
        from .tools.chunk import chunk_maf

        chunk_maf(MafReader(open_input(args.input)), args.length, open_output(out, rw))
    elif cmd in ("call", "c"):
        _dispatch_call(args, out, rw, pooled)
    elif cmd in ("stat", "st"):
        from .parallel.host_pool import parallel_stat_maf, parallel_stat_paf
        from .tools.stat import stat_maf, stat_paf

        if _start_dist(args.input):
            from .parallel import dist_tools

            if args.format == "paf":
                dist_tools.distributed_stat_paf(
                    args.input, dist_tools.dist_output(out, rw), args.each
                )
            else:
                # <input>.index is the shard manifest when present
                dist_tools.distributed_stat_maf(
                    args.input, dist_tools.dist_output(out, rw), args.each,
                    args.query_name,
                )
        elif args.format == "maf":
            if pooled:
                parallel_stat_maf(
                    args.input,
                    open_output(out, rw),
                    args.threads,
                    args.each,
                    args.query_name,
                )
            else:
                stat_maf(MafReader(open_input(args.input)),
                         open_output(out, rw), _device(), args.each,
                         args.query_name)
        elif pooled:
            parallel_stat_paf(
                args.input, open_output(out, rw), args.threads, args.each
            )
        else:
            stat_paf(PafReader(open_input(args.input)), open_output(out, rw),
                     _device(), args.each)
    elif cmd in ("dotplot", "dp"):
        from .tools.dotplot import dotplot

        dist = _start_dist(args.input)
        if dist:
            from .parallel.dist_tools import dist_output

            w = dist_output(out, rw)
        else:
            w = open_output(out, rw)
        dotplot(
            args.input,
            w,
            args.format,
            args.out_format,
            args.mode,
            args.no_identity,
            args.length if args.length is not None else 50,
            args.query_name,
            args.color,
            threads=args.threads if pooled else 1,
            dist=dist,
        )
    elif cmd in ("filter", "fl"):
        from .tools.filter import (
            filter_chain,
            filter_maf,
            filter_paf,
            filter_paf_align_pair,
        )

        dist = (args.format == "paf" and args.min_align_size is not None
                and _start_dist(args.input))
        # in distributed mode only process 0 may open the real output
        # (dist_tools.dist_output): the distributed branch opens it
        w = None if dist else open_output(out, rw)
        if args.format == "maf":
            filter_maf(
                MafReader(open_input(args.input)),
                w,
                args.min_block_size,
                args.min_query_size,
            )
        elif args.format == "paf":
            if args.min_align_size is not None:
                log.warning(
                    "`min_align_size` is set, will not filter paf "
                    "`min_block_size` and `min_query_size`"
                )
                from .parallel.host_pool import parallel_filter_paf_align_pair

                if dist:
                    from .parallel.dist_tools import (
                        dist_output,
                        distributed_filter_paf_align_pair,
                    )

                    distributed_filter_paf_align_pair(
                        args.input, dist_output(out, rw), args.min_align_size
                    )
                elif pooled:
                    parallel_filter_paf_align_pair(
                        args.input, w, args.threads, args.min_align_size
                    )
                else:
                    filter_paf_align_pair(
                        PafReader(open_input(args.input)),
                        w,
                        args.min_align_size,
                    )
            else:
                filter_paf(
                    PafReader(open_input(args.input)),
                    w,
                    args.min_block_size,
                    args.min_query_size,
                )
        else:
            filter_chain(
                ChainReader(open_input(args.input)),
                w,
                args.min_block_size,
                args.min_query_size,
            )
    elif cmd in ("rename", "rn"):
        from .tools.rename import rename_maf

        rename_maf(
            MafReader(open_input(args.input)),
            open_output(out, rw),
            args.prefixs.split(","),
        )
    elif cmd in ("pafcov", "pc"):
        from .parallel.host_pool import parallel_pafcov
        from .tools.pafcov import pafcov

        if _start_dist(args.input):
            from .parallel.dist_tools import dist_output, distributed_pafcov

            distributed_pafcov(args.input, dist_output(out, rw))
        elif pooled:
            parallel_pafcov(args.input, open_output(out, rw), args.threads)
        else:
            pafcov(PafReader(open_input(args.input)), open_output(out, rw),
                   _device())
    elif cmd in ("pafpseudo", "pp"):
        from .parallel.dist_tools import dist_requested
        from .tools.pseudomaf import generate_pseudo_maf

        stripe = None
        if dist_requested():
            from .parallel.distributed import (
                maybe_initialize_distributed,
                process_index_count,
            )

            maybe_initialize_distributed()
            stripe = process_index_count()
        generate_pseudo_maf(
            PafReader(open_input(args.input)),
            out,
            args.fasta,
            args.target,
            rw,
            threads=args.threads,
            stripe=stripe,
        )
    elif cmd in ("gen-completion", "gc"):
        from .tools.completion import gen_completion

        gen_completion(args.shell, open_output(out, rw))
    elif cmd in ("validate", "vf"):
        from .parallel.host_pool import parallel_validate_paf
        from .tools.validate import validate_paf

        fix_requested = args.fix is not None
        if fix_requested:
            # fixed output must not clobber the input (utils.rs:750-758)
            input_path = args.input if args.input else "stdin"
            if args.fix == input_path:
                raise WGAError(
                    "fixed file should not be the same as output file"
                )
        if _start_dist(args.input):
            from .parallel.dist_tools import (
                dist_output,
                distributed_validate_paf,
            )

            # the fixed output through dist_output too: only rank 0 may
            # open a real file (another rank would race the overwrite guard)
            fix_writer = dist_output(args.fix, True) if fix_requested else None
            distributed_validate_paf(
                args.input,
                dist_output(out, rw),
                fix_writer,
                fix_requested,
            )
        elif pooled:
            fix_writer = open_output(args.fix, True) if fix_requested else None
            parallel_validate_paf(
                args.input,
                open_output(out, rw),
                args.threads,
                fix_writer,
                fix_requested,
            )
        else:
            device = _device()
            fix_writer = open_output(args.fix, True) if fix_requested else None
            validate_paf(
                PafReader(open_input(args.input)),
                open_output(out, rw),
                fix_writer,
                fix_requested,
                device,
            )
    elif cmd in ("tview", "tv"):
        from .tools.tview import tview

        tview(args.input, args.step)
    elif cmd in ("pileup", "pl"):
        from .tools.pileup import pileup

        pileup(
            MafReader(open_input(args.input)),
            open_output(out, rw),
            args.all_sites,
        )
    elif cmd in ("trimovp", "tr"):
        from .tools.trimovp import trim_ovp

        trim_ovp(PafReader(open_input(args.input)), open_output(out, rw))
    elif cmd in ("paf2blocks", "p2b"):
        from .tools.convert import paf2blocks

        paf2blocks(PafReader(open_input(args.input)), open_output(out, rw))
    else:
        raise WGAError(f"unknown command {cmd}")


def _dispatch_call(args, out, rw, pooled):
    from .io.compression import open_input, open_output
    from .io.maf import MafReader
    from .io.paf import PafReader
    from .tools.caller import call_var_maf, call_var_paf

    if args.format == "maf":
        from .parallel.host_pool import parallel_call_maf
        from .tools.index import index_path_for, load_index

        mafindex = None
        if args.input and args.input != "-":
            idx_path = index_path_for(args.input)
            if os.path.exists(idx_path):
                mafindex = load_index(idx_path)
        if mafindex is None:
            log.warning("maf index not found, will not generate contig info")
        regex = (
            _wrap_regex_full_match(args.query_regex)
            if args.query_regex
            else None
        )
        # no `and mafindex` here: distributed_call_maf loads its own index
        # and falls back to a raw offset scan without one
        if _start_dist(args.input):
            from .parallel.dist_tools import dist_output, distributed_call_maf

            distributed_call_maf(
                args.input,
                dist_output(out, rw),
                args.snp,
                args.inv,
                args.svlen,
                args.sample,
                args.query_name,
                regex,
                args.chunk_size,
                _device(),
            )
        elif pooled:
            parallel_call_maf(
                args.input,
                open_output(out, rw),
                args.threads,
                mafindex,
                args.snp,
                args.inv,
                args.svlen,
                args.sample,
                args.query_name,
                regex,
                args.chunk_size,
            )
        else:
            call_var_maf(
                MafReader(open_input(args.input)),
                mafindex,
                open_output(out, rw),
                args.snp,
                args.inv,
                args.svlen,
                _device(),
                args.sample,
                args.query_name,
                regex,
                args.chunk_size,
            )
    else:
        if not args.target or not args.query:
            raise WGAError("target and query are necessary")
        call_var_paf(
            PafReader(open_input(args.input)),
            args.target,
            args.query,
            open_output(out, rw),
            args.snp,
            args.svlen,
            args.sample,
        )
