#!/usr/bin/env python3
"""The readings that a cell's limits of ``correct`` are set from, on the
card, several seeds in one process (the imports and the card's start paid
once):

    python3 bench_cuda/calibrate.py --workload <cell> --seeds 1 2 3 \
        --seconds 8 [--stand-in program|control|<fault>]

Each seed is one run of the cell (``harness.run_cell``) with the stand-in
in the program's place: the program itself, the control (the reference
one step below the configuration's precision, ``control.py``), or the
program with a fault of its family's ``FAULTS`` planted. It prints one
JSON line a seed with the numbers compared. The benchmark's own runs
never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--stand-in", default="program",
                    help="program, control or a fault of the family")
    args = ap.parse_args()
    import torch
    from bench_cuda import control, harness, spec
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    bench = spec.benchmark()
    if args.stand_in == "program":
        make = None
    elif args.stand_in == "control":
        make = control.ControlProgram
    else:
        cfg = spec.config(spec.cell(bench, args.workload)["config"])
        make = control.faulty(args.stand_in, spec.family(cfg["family"]))
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = harness.run_cell(bench, args.workload, seed, args.seconds, False,
                             "cuda:0", t0, make_program=make)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "stand_in": args.stand_in,
                          "attempted": r["attempted"],
                          "checks": {k: v["value"]
                                     for k, v in r["checks"].items()},
                          "readings": r["readings"],
                          "metrics": r["metrics"],
                          "seconds": time.perf_counter() - t0}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
