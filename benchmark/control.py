"""The control of a cell's output check: the plain reference put in the
program's place with one of the configuration's guarantees broken (see
each reference's `answer(..., control=True)`), at the cell's own size.
It must come out as not correct: prints, for each seed, the numbers the
benchmark compares and their limits.

    python3 benchmark/control.py --workload <name> --seeds 1 2 3

The benchmark's own runs never run it.  It needs no card.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

import harness


def readings(workload, seed):
    """The compared numbers of the control on the input of `seed`."""
    spec = harness.cell_spec(workload)
    gen = spec["config"]["generator"]
    reference = harness.load_part("reference", spec["traffic"]["reference"])
    workdir = tempfile.mkdtemp(prefix="wgabench-control-")
    try:
        path = os.path.join(workdir, "input" + spec["config"]["suffix"])
        harness.load_part("gen", gen["name"]).generate(path, seed, **gen["params"])
        equal, lines = harness.compare(reference.answer(path),
                                       reference.answer(path, control=True))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return {"differing_outputs": int(not equal), "differing_lines": lines}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    failed_all = True
    for seed in args.seeds:
        r = readings(args.workload, seed)
        failed_all &= r["differing_outputs"] > 0
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": r, "limits": {"differing_outputs": 0,
                                                   "differing_lines": 0}}))
    print(f"control not correct on every seed: {failed_all}", file=sys.stderr)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
