#!/usr/bin/env python3
"""The vocoder's ResStack kernels at the full-width shapes of a 30 s chunk,
on one CUDA card, timed two ways: CUDA events around the call
(chip_smoke.py's ``cuda_ms``: the host's time between launches included)
and the profiler's device time of all the call's kernels (``device_ms``),
the device time also split by launch kind (the x + sin(x) pre-pass, chain
kernels, single-block kernels). Each result is held to the plain version
first, at chip_smoke.py's tolerances.

    python3 tools/torch_vocoder_stages.py [--root DIR]

The calls: ``up_res_stream`` at stages 2 and 3 (K4: 256 -> 128 at T =
147 294 and 128 -> 64 at T = 441 882, scale 3), ``res_stack`` at stages 0
and 1 (K2 and K3: C = 512 at T = 21 042 and C = 256 at T = 147 294, every
launch of the stage) and ``res_stream`` on the whole signal of stages 2
and 3 (K7: C = 128 at T = 441 882 and C = 64 at T = 1 325 646), each in
float32 and bfloat16.

--root imports ``voicefixer_tpu_torch`` from another checkout (for example
a ``git archive`` of an earlier commit, unpacked into a directory that
.gitignore lists), whose kernels it builds there; the timing helpers are
this checkout's. Run it on two checkouts in turns (A, B, B, A) in one call
to compare them. Prints the card's name and power limit, one line per
(call, type), and one JSON object as the last line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=HERE)
    root = ap.parse_args().root.resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    from voicefixer_tpu_torch.kernels import resstack, resstream
    from voicefixer_tpu_torch.ops.precision import tf32_off
    if not torch.cuda.is_available():
        print("torch_vocoder_stages: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; package from {root}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(cs.SEED)
    dils = resstack.stack_dilations(8)

    def calls(dtype):
        """(name, fn, plain) of every call at its full-width shape."""
        dt = getattr(torch, dtype)
        for stage, cin, cout, t in ((2, 256, 128, 147294),
                                    (3, 128, 64, 441882)):
            x = torch.randn((1, t, cin), generator=gen).to(dev, dt)
            w = ((torch.rand((6, cin, cout), generator=gen) * 2 - 1)
                 * (1 / (cin * 6)) ** 0.5).to(dev, dt)
            b = (0.01 * torch.randn((cout,), generator=gen)).to(dev, dt)
            args = (x, w, b, *cs._bank(gen, 8, cout, dev, dt), dils, 3,
                    cs.SLOPE_RES, cs.SLOPE_ACT)
            yield (f"up_res_stream stage {stage}",
                   lambda a=args: resstream.up_res_stream(*a),
                   lambda a=args: resstream.up_res_stream_reference(*a))
        for stage, ch, t in ((0, 512, 21042), (1, 256, 147294)):
            x = torch.randn((1, t, ch), generator=gen).to(dev, dt)
            bank = cs._bank(gen, 8, ch, dev, dt)
            params = [{"c1": {"w": bank[0][i], "b": bank[1][i]},
                       "c2": {"w": bank[2][i], "b": bank[3][i]}}
                      for i in range(8)]
            yield (f"res_stack stage {stage}",
                   lambda x=x, p=params: resstack.res_stack(
                       p, x, 3, cs.SLOPE_RES, cs.SLOPE_ACT),
                   lambda x=x, bank=bank: resstack.res_chain_reference(
                       x, *bank, dils, cs.SLOPE_RES, cs.SLOPE_ACT))
        for stage, ch, t in ((2, 128, 441882), (3, 64, 1325646)):
            x = torch.randn((1, t, ch), generator=gen).to(dev, dt)
            bank = cs._bank(gen, 8, ch, dev, dt)
            yield (f"res_stream stage {stage}",
                   lambda x=x, bank=bank: resstream.res_stream(
                       x, *bank, dils, cs.SLOPE_RES, cs.SLOPE_ACT),
                   lambda x=x, bank=bank: resstream.res_stream_reference(
                       x, *bank, dils, cs.SLOPE_RES, cs.SLOPE_ACT))

    def kind(name):
        return ("pre-pass" if "sin_residual" in name else
                "chain" if "chain" in name else
                "single" if "shift" in name else "other")

    rows = []
    with tf32_off(), torch.inference_mode():
        for dtype in ("float32", "bfloat16"):
            for name, fn, plain in calls(dtype):
                err = cs.compare(f"{name} {dtype}", fn(), plain(),
                                 **cs._res_tol(dtype, 8))
                torch.cuda.synchronize()
                split: dict = {}
                for kname, ms, n in cs._device_kernels(
                        lambda: [fn() for _ in range(3)]):
                    k = kind(kname)
                    ms0, n0 = split.get(k, (0.0, 0))
                    split[k] = (ms0 + ms / 3, n0 + n // 3)
                row = {"call": name, "dtype": dtype, "err": err,
                       "events_ms": cs.cuda_ms(fn, 5),
                       "device_ms": cs.device_ms(fn, 5),
                       "split": {k: [round(ms, 4), n]
                                 for k, (ms, n) in split.items()}}
                rows.append(row)
                print(f"  {name} {dtype}: events {row['events_ms']:.3f} ms, "
                      f"device {row['device_ms']:.3f} ms; by launch kind "
                      + ", ".join(f"{k} {ms:.3f} ms ({n}x)"
                                  for k, (ms, n) in split.items()),
                      flush=True)
    print(card)
    print(json.dumps({"root": str(root), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
