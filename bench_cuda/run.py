#!/usr/bin/env python3
"""Run one cell of the benchmark and print its result line.

    python3 bench_cuda/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. The last line of standard output is one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), device (and with --trace 1 busy_s,
window_s and a breakdown), and last the numbers compared for ``correct``
with their limits, which are also the last lines of standard error. It
exits non-zero and prints no result without enough cards, or when the
process has loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

FORBIDDEN = ("jax", "jaxlib", "flax", "voicefixer_tpu")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (``voicefixer_tpu_torch`` is not ``voicefixer_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from bench_cuda import harness, spec
    bench = spec.benchmark()
    chips = spec.cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", T_START)
    found = forbidden_modules()
    if found:
        print(f"the process loaded {found}: the benchmark runs the port "
              "alone", file=sys.stderr)
        return 3
    harness.print_checks(result)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
