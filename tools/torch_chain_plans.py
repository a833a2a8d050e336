#!/usr/bin/env python3
"""The bfloat16 launches of the vocoder's ResStack stages (stage 0: C=512
at T=21 042, stage 1: C=256 at T=147 294; and the fused stages' whole
up_res_stream, stage 2: 256 -> 128 and stage 3: 128 -> 64, x3; a 30 s
chunk) on one CUDA card under candidate chain plans of the wgmma chain
kernel, each held to the plain version and timed by CUDA events:

    python3 tools/torch_chain_plans.py [--reps N] [--json PATH]

A candidate covers the blocks 0 .. k of the stage that its groups cover (a
chain, and for a shorter chain the single blocks after it), so that chain
against chain plus res_shift_single compare like for like. Prints first the
weight bytes each stage's chain reads from L2 (chip_smoke.chain_weight_bytes)
under the planner's plan, then one line a candidate (ms, weight bytes) with the cuDNN sequence of the same
blocks; with --json, writes the lines as JSON to PATH. A fused stage's
candidate is its whole plan (the first group the chain with the upsample);
its line gives the first group's weight ring (K rows a stage, stages).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# (stage, C, T, candidates); a candidate is ((i0, i1, tm or None), ...) and
# None for tm is one res_shift_single block
STAGES = (
    (0, 512, 21042, [((0, 2, 54),)]),
    (1, 256, 147294, [((0, 3, 98),), ((0, 2, 118), (2, 3, None))]),
)
# (stage, Cin, Cout, T, candidate first groups); the blocks after a first
# group are single blocks
UP_STAGES = (
    (2, 256, 128, 147294, [(0, 4, 298), (0, 4, 234), (0, 4, 170),
                           (0, 3, 226), (0, 3, 162)]),
    (3, 128, 64, 441882, [(0, 5, 518), (0, 5, 454), (0, 5, 390),
                          (0, 4, 554), (0, 4, 426)]),
)


def main() -> int:
    import torch

    from voicefixer_tpu_torch.kernels import resstack
    from voicefixer_tpu_torch.ops.precision import tf32_off

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--json", type=Path)
    opts = ap.parse_args()
    reps = opts.reps
    dils = resstack.stack_dilations(8)
    for stage, ch, t, _ in STAGES:
        groups = resstack.plan_stack(ch, dils, 2)
        now = sum(cs.chain_weight_bytes(ch, t, dils[i0:i1], tm)
                  for i0, i1, tm in groups if tm is not None)
        print(f"stage {stage}: weights from L2 {now / 1e9:.3f} GB with the "
              f"plan {groups[0]}", flush=True)
    if not torch.cuda.is_available():
        print("torch_chain_plans: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(cs.SEED)
    rows = []
    with tf32_off(), torch.inference_mode():
        for stage, ch, t, candidates in STAGES:
            x = torch.randn((1, t, ch), generator=gen).to(dev, torch.bfloat16)
            bank = cs._bank(gen, 8, ch, dev, torch.bfloat16)
            print(f"stage {stage}: C={ch}, T={t}; planner "
                  f"{resstack.plan_stack(ch, dils, 2)}", flush=True)
            for groups in candidates:
                end = groups[-1][1]
                ref = resstack.res_chain_reference(
                    x, *(v[:end] for v in bank), dils[:end], cs.SLOPE_RES)
                lib = cs.cuda_ms(lambda: cs._cudnn_blocks(  # noqa: B023
                    x, tuple(v[:end] for v in bank), dils[:end], None), reps)

                def run(groups=groups):
                    y = x
                    for i0, i1, tm in groups:
                        sub = tuple(v[i0:i1] for v in bank)
                        if tm is None:
                            y = resstack.res_shift_single(
                                y, *(v[0] for v in sub), dils[i0],
                                cs.SLOPE_RES)
                        else:
                            y = resstack.res_chain(y, *sub, dils[i0:i1],
                                                   cs.SLOPE_RES, tm=tm)
                    return y
                err = cs.compare(f"stage {stage} {groups}", run(), ref,
                                 2 ** -7, 1e-3, chained=end)
                ms = cs.cuda_ms(run, reps)
                wbytes = sum(cs.chain_weight_bytes(ch, t, dils[i0:i1], tm)
                             for i0, i1, tm in groups if tm is not None)
                rows.append({"stage": stage, "ch": ch, "t": t,
                             "groups": groups, "ms": ms,
                             "weight_gb": wbytes / 1e9, "cudnn_ms": lib,
                             "max_abs_err": err, "card": card})
                print(f"  {groups}: {ms:.3f} ms, weights from L2 "
                      f"{wbytes / 1e9:.3f} GB; cuDNN sequence of the same "
                      f"blocks {lib:.3f} ms", flush=True)
        from voicefixer_tpu_torch.kernels import resstream
        planner = resstream.up_plan
        for stage, cin, cout, t, firsts in UP_STAGES:
            x = torch.randn((1, t, cin), generator=gen).to(dev,
                                                           torch.bfloat16)
            # chip_smoke.py's weights of the transposed convolution
            w = ((torch.rand((6, cin, cout), generator=gen) * 2 - 1)
                 * (1 / (cin * 6)) ** 0.5).to(dev, torch.bfloat16)
            b = (0.01 * torch.randn((cout,), generator=gen)).to(
                dev, torch.bfloat16)
            args = (x, w, b, *cs._bank(gen, 8, cout, dev, torch.bfloat16),
                    dils, 3, cs.SLOPE_RES)
            ref = resstream.up_res_stream_reference(*args)
            print(f"stage {stage}: {cin} -> {cout}, T={t}; planner "
                  f"{planner(cin, cout, 3, dils, 2)}", flush=True)
            for first in firsts:
                groups = (first,) + tuple((i, i + 1, None)
                                          for i in range(first[1], 8))
                resstream.up_plan = lambda *a, g=groups: g
                try:
                    err = cs.compare(f"stage {stage} {first}",
                                     resstream.up_res_stream(*args), ref,
                                     2 ** -7, 1e-3, chained=8)
                    ms = cs.cuda_ms(
                        lambda: resstream.up_res_stream(*args), reps)  # noqa: B023
                finally:
                    resstream.up_plan = planner
                ring = resstack.wgmma_ring(cout, dils[:first[1]], first[2],
                                           up=(cin, 3))
                rows.append({"stage": stage, "ch": cout, "t": t,
                             "groups": groups, "ms": ms, "ring": ring,
                             "max_abs_err": err, "card": card})
                print(f"  {first} then single blocks: {ms:.3f} ms; first "
                      f"group's ring {ring[1]} stages of {ring[0]} K rows",
                      flush=True)
    if opts.json:
        opts.json.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
