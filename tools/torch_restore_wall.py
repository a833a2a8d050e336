#!/usr/bin/env python3
"""Mode-0 restore of one 30 s chunk through ``VoiceFixer.restore_inmem`` at
full width on one CUDA card, in both precisions: chip_smoke.py's main path
(``DEFAULT_CONFIG``, random weights from its seed, 0.1-sigma white noise),
timed by the host clock, wav in to wav out, over --reps calls after two
warm-up calls, and the profiler's summed device time of one call.

    python3 tools/torch_restore_wall.py [--root DIR] [--reps N]

--root imports ``voicefixer_tpu_torch`` from another checkout (for example
a ``git archive`` of an earlier commit, unpacked into a directory that
.gitignore lists), whose kernels it builds there; the timing helpers are
this checkout's. Run it on two checkouts in turns (A, B, B, A) in one call
to compare them: the wall time follows the host, which varies from call
to call. Prints the card's name and power limit, one line per precision,
and one JSON object as the last line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--reps", type=int, default=10)
    opts = ap.parse_args()
    root = opts.root.resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import numpy as np
    import torch

    from voicefixer_tpu_torch.config import DEFAULT_CONFIG
    from voicefixer_tpu_torch.ops.precision import precision
    from voicefixer_tpu_torch.pipeline.restore import VoiceFixer
    if not torch.cuda.is_available():
        print("torch_restore_wall: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; package from {root}", flush=True)
    vf = VoiceFixer.random(cs.SEED, DEFAULT_CONFIG,
                           device=torch.device("cuda", 0))
    rng = np.random.default_rng(cs.SEED)
    wav = (0.1 * rng.standard_normal(DEFAULT_CONFIG.pipeline.seg_length)
           ).astype(np.float32)
    rows = []
    for mode in ("production", "parity"):
        with precision(mode):
            for _ in range(2):
                vf.restore_inmem(wav)
            walls = []
            for _ in range(opts.reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                vf.restore_inmem(wav)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            busy = sum(ms for _, ms, _ in
                       cs._device_kernels(lambda: vf.restore_inmem(wav)))
        row = {"mode": mode, "wall_ms": walls,
               "median_ms": statistics.median(walls), "min_ms": min(walls),
               "device_busy_ms": busy}
        rows.append(row)
        print(f"  {mode}: ms per 30 s chunk median {row['median_ms']:.2f}, "
              f"min {row['min_ms']:.2f} (of {opts.reps}); device busy "
              f"{busy:.2f} ms, idle share "
              f"{max(0.0, 1 - busy / row['median_ms']):.3f}", flush=True)
    print(card)
    print(json.dumps({"root": str(root), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
