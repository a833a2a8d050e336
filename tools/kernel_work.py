#!/usr/bin/env python3
"""Launches, work and H100 bound of the ResStack kernels of the JAX package
(K2 res_chain, K3 res_shift_single, K4 up_res_stream), which the port has
yet to write, on mode-0 restore of one 30 s chunk (B=1), for the port's
kernel table (PERF.md):

    python tools/kernel_work.py

Launches are those of the JAX package's usual production configuration,
with the K2/K3 groups of stages 0-1 from its own
``kernels.resstack.plan_chain``. Work per launch is the FLOPs and bytes of
its function (each input read once, each output written once) in bfloat16,
and the bound the least time one NVIDIA H100 SXM could take for them, by
``chip_smoke.bound_ms`` (the larger of bytes over the memory rate and FLOPs
over the bf16 tensor-core peak). The ported kernels' work and bounds come
from ``chip_smoke.py``'s own run. Analytic: it runs no kernel.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from chip_smoke import PEAK_BF16, bound_ms, upsample_work  # noqa: E402

FRAMES = 3001                 # STFT frames of 1 323 000 samples at hop 441
MEL_T = FRAMES + FRAMES % 2 + 4   # after the vocoder's tail pad
STAGES = [(1024, 512, 7), (512, 256, 7), (256, 128, 3), (128, 64, 3)]
BF16 = 2


def res_work(ch: int, t: int, n_blocks: int):
    """n consecutive ResStack blocks (two k=3 convs each) at (C, T)."""
    return (n_blocks * 12 * ch * ch * t,
            BF16 * (2 * t * ch + n_blocks * 2 * (3 * ch * ch + ch)))


def main() -> int:
    from voicefixer_tpu.kernels.resstack import plan_chain

    rows = []
    dils = tuple(3 ** i for i in range(8))
    t = MEL_T
    for i, (cin, cout, s) in enumerate(STAGES):
        t_out = t * s
        if i < 2:
            for i0, i1, tt in plan_chain(cout, dils, 2, 2, t_cap=8192,
                                         t_total=t_out):
                name = ("K3 res_shift_single" if isinstance(tt, tuple)
                        else "K2 res_chain" if tt is not None
                        else "XLA conv (no kernel)")
                fl, by = res_work(cout, t_out, i1 - i0)
                rows.append((f"{name} stage {i} blocks {i0}-{i1 - 1}", fl, by))
        else:
            # the upsample fused with all eight blocks: the upsampled signal
            # is neither written by the one nor read by the other
            fl, by = res_work(cout, t_out, len(dils))
            up_fl, up_by = upsample_work(t, s, cin, cout, BF16)
            rows.append((f"K4 up_res_stream stage {i}", fl + up_fl,
                         by + up_by - 2 * BF16 * t_out * cout))
        t = t_out

    print(f"{'kernel':42s} {'launches':>8s} {'GFLOP':>9s} {'MB':>9s} "
          f"{'bound ms':>9s}  by")
    for name, flops, nbytes in rows:
        ms, by = bound_ms(nbytes, flops, PEAK_BF16)
        print(f"{name:42s} {1:8d} {flops / 1e9:9.2f} {nbytes / 1e6:9.2f} "
              f"{ms:9.4f}  {by} (bf16)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
