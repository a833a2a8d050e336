#!/usr/bin/env python3
"""Device time of the vocoder's dilated ResStack convolutions in the PyTorch
port, at the shapes of a 30 s chunk (B=1), on one CUDA card:

    python3 tools/torch_dilated_conv.py

For each stage (C, T), type (float32, bfloat16) and dilation 3^i (i < 8), it
times cuDNN's dilated convolution as such ("direct") and the same
convolution folded into an undilated one over [T/d, d]
(``ops.conv._conv1d_folded``, "folded"), by CUDA events over a few launches
after a warm-up, with TF32 off. Prints one line per (stage, type) with both
rows of milliseconds, and the card's name and power limit. ``ops.conv.conv1d``
folds where these timings favour it.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from voicefixer_tpu_torch.ops.conv import _conv1d_folded  # noqa: E402
from voicefixer_tpu_torch.ops.precision import tf32_off  # noqa: E402

STAGES = ((512, 21042), (256, 147294), (128, 441882), (64, 1325646))


def cuda_ms(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def direct(x, w, b, d):
    """cuDNN's dilated convolution on the [B, C, 1, T] channels-last view."""
    y = F.conv2d(x.unsqueeze(1).permute(0, 3, 1, 2),
                 w.permute(2, 1, 0).unsqueeze(2), b, padding=(0, d),
                 dilation=(1, d))
    return y.permute(0, 2, 3, 1)[:, 0]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_dilated_conv: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(card)
    gen = torch.Generator().manual_seed(0)
    with tf32_off(), torch.inference_mode():
        for c, t in STAGES:
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn((1, t, c), generator=gen).to("cuda", dt)
                w = (0.02 * torch.randn((3, c, c), generator=gen)).to("cuda", dt)
                b = torch.zeros(c, device="cuda", dtype=dt)
                dils = [3 ** i for i in range(8)]
                rows = {
                    "direct": [cuda_ms(lambda: direct(x, w, b, d)) for d in dils],
                    "folded": [cuda_ms(lambda: _conv1d_folded(x, w, b, d, d))
                               for d in dils],
                }
                for name, ms in rows.items():
                    print(f"C={c} T={t} {str(dt)[6:]} {name} ms by dilation "
                          f"{dils}: {[round(v, 3) for v in ms]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
