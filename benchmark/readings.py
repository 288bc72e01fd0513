"""The readings that set a cell's limits (`check.limits` in its file): the
check's numbers for the port over many seeds, for the control in its place
and for planted faults, each on its own seeds, in one process.

    python3 -m benchmark.readings --workload <cell> --port-seeds 1 2 ... \
        [--control-seeds ...] [--faults half_batch altered --fault-seeds ...] \
        [--seconds S] [--out readings.jsonl]

Without `--seconds` there is no timed window: a train cell's check reads
set-up's first iteration and the one after it, a rollout cell runs until
the steps its check samples have run. One JSON line per run, on standard output and in `--out`.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import manifest
from .faults import FAULTS
from .harness import run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--port-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[], choices=sorted(FAULTS))
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("[readings] needs a CUDA card", file=sys.stderr)
        return 2
    cell = manifest.load_cell(args.workload)
    runs = [("port", None, s) for s in args.port_seeds] + [("control", None, s) for s in args.control_seeds]
    runs += [("port", f, s) for f in args.faults for s in args.fault_seeds]
    out = open(args.out, "a") if args.out else None
    try:
        for system, fault, seed in runs:
            t0 = time.perf_counter()
            r = run_cell(cell, seed, args.seconds, False, "cuda", t0, system=system,
                         fault=FAULTS[fault] if fault else None)
            line = json.dumps({"cell": cell.name, "system": system, "fault": fault, "seed": seed,
                               "correct": r["correct"], "attempted": r["attempted"], "seconds": time.perf_counter() - t0,
                               "numbers": {k: v["value"] for k, v in r["check"].items()}})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
