#!/usr/bin/env python3
"""The ConvBlockRes kernel (K9 conv_block_res) and its cuDNN yardstick at
the eight shapes of the ResUNet's 24 blocks in a 30 s chunk, on one CUDA
card, timed two ways: CUDA events around the call (chip_smoke.py's
``cuda_ms``: the host's time between launches included) and the profiler's
device time of the kernels (``device_ms``). Each kernel result is held to
the plain version first.

    python3 tools/torch_convblock_shapes.py [--root DIR]

--root imports ``voicefixer_tpu_torch`` from another checkout (for example
a ``git archive`` of an earlier commit, unpacked into a directory that
.gitignore lists), whose kernels it builds there; the timing helpers are
this checkout's. Where the package can pack a block's operands once
(``resunet.pack_conv_blocks``, as ``VoiceFixer(conv_block_kernel=True)``
does), they are packed before timing. Prints the card's name and power
limit, one line per (type, shape), the sums over the 24 blocks, and one
JSON object as the last line.
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

    from voicefixer_tpu_torch.config import DEFAULT_CONFIG as C
    from voicefixer_tpu_torch.kernels import convblock
    from voicefixer_tpu_torch.models import resunet
    from voicefixer_tpu_torch.ops.conv import fold_bn_eval
    from voicefixer_tpu_torch.ops.precision import tf32_off
    from voicefixer_tpu_torch.utils.weights import tree_map
    if not torch.cuda.is_available():
        print("torch_convblock_shapes: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; package from {root}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(cs.SEED)
    rnd = lambda shape, sc=1.0: sc * torch.randn(shape, generator=gen)  # noqa: E731
    slope = C.unet.leaky_slope
    rows, totals = [], {}
    with tf32_off(), torch.inference_mode():
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            for (t, f, ci, co), k in cs.conv_block_shapes().items():
                def bn(c):
                    return {"gamma": 1 + 0.1 * rnd((c,)),
                            "beta": 0.1 * rnd((c,)),
                            "mean": 0.05 * rnd((c,)),
                            "var": (1 + 0.1 * rnd((c,))).abs()}
                p = {"bn1": bn(ci),
                     "conv1": {"w": rnd((3, 3, ci, co), (2 / (9 * ci)) ** .5)},
                     "bn2": bn(co),
                     "conv2": {"w": rnd((3, 3, co, co), (2 / (9 * co)) ** .5)}}
                if ci != co:
                    p["shortcut"] = {"w": rnd((1, 1, ci, co), ci ** -0.5),
                                     "b": 0.1 * rnd((co,))}
                p = tree_map(lambda v: v.to(dev, dt), fold_bn_eval(p))
                if hasattr(resunet, "pack_conv_blocks"):
                    p = resunet.pack_conv_blocks({"block": p})["block"]
                x = rnd((1, t, f, ci)).to(dev, dt)
                fn = lambda: convblock.conv_block_res(x, p, slope)  # noqa: E731,B023
                lib = lambda: resunet._conv_block_res(p, x, slope)  # noqa: E731,B023
                tol = (1e-4, 1e-4) if dtype == "float32" else (2 ** -7,
                                                              2 ** -6)
                err = cs.compare(f"{dtype} [{t}, {f}] {ci}->{co}", fn(),
                                 convblock.conv_block_res_reference(x, p,
                                                                    slope),
                                 *tol)
                row = {"dtype": dtype, "shape": [t, f, ci, co], "blocks": k,
                       "err": err,
                       "events_ms": cs.cuda_ms(fn, 10),
                       "library_events_ms": cs.cuda_ms(lib, 10),
                       "device_ms": cs.device_ms(fn, 10, cs.K9_GROUP),
                       "library_device_ms": cs.device_ms(lib, 10)}
                rows.append(row)
                for key in ("events_ms", "library_events_ms", "device_ms",
                            "library_device_ms"):
                    totals[dtype, key] = (totals.get((dtype, key), 0.0)
                                          + k * row[key])
                print(f"  {dtype} [{t}, {f}] {ci}->{co} x{k}: events kernel "
                      f"{row['events_ms']:.4f} ms, library "
                      f"{row['library_events_ms']:.4f}; device kernel "
                      f"{row['device_ms']:.4f} ms, library "
                      f"{row['library_device_ms']:.4f}", flush=True)
    for (dtype, key), ms in totals.items():
        print(f"  {dtype} {key}: {ms:.4f} ms over the 24 blocks", flush=True)
    print(card)
    print(json.dumps({"root": str(root), "rows": rows,
                      "totals": {f"{d}:{k}": v
                                 for (d, k), v in totals.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
