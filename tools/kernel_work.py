#!/usr/bin/env python3
"""Work and H100 bound of the TPU kernels of the JAX package that the port
has yet to write (K7 res_stream, K8 gru_seq, K9 conv_block_res), at the
shapes the JAX package would run them on one 30 s chunk (B=1), for the
port's kernel table (PERF.md):

    python tools/kernel_work.py

Work per launch is the FLOPs and bytes of the kernel's function (each input
read once, each output written once) in bfloat16, and the bound the least
time one NVIDIA H100 SXM could take for them, by ``chip_smoke.bound_ms`` (the
larger of bytes over the memory rate and FLOPs over the bf16 tensor-core
peak). The formulas shared with ported kernels come from ``chip_smoke.py``,
which computes the ported kernels' work and bounds from its own run's
inputs. Analytic: it runs no kernel.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import PEAK_BF16, bound_ms, gru_work, res_work  # noqa: E402

FRAMES = 3001                 # STFT frames of 1 323 000 samples at hop 441
BF16 = 2
# ResUNet levels: channels, and the [T, F] grid of a level (T padded to a
# multiple of 64, the last of 128 mel bins dropped, halved per level)
UNET_CHANNELS = (32, 64, 128, 256, 384, 384)
UNET_T, UNET_F = 3008, 127


def conv_block_work(t: int, f: int, ch: int, size: int):
    """One ConvBlockRes at equal widths on [t, f, ch]: folded BN and
    LeakyReLU, two 3x3 convolutions of ch x ch, the residual add."""
    return (2 * 2 * 9 * ch * ch * t * f,
            size * (2 * t * f * ch + 2 * 9 * ch * ch + 4 * ch))


def main() -> int:
    rows = []
    # K7: the stage-2 ResStack alone (C=128 after the x3 upsample of
    # 147 294 rows), all eight blocks in one launch
    rows.append(("K7 res_stream C=128 T=441882, 8 blocks",
                 *res_work(128, 441882, 8, BF16)))
    # K8: one direction of one GRU layer of the denoiser
    rows.append((f"K8 gru_seq T={FRAMES} H=256, one direction",
                 *gru_work(FRAMES, 256, BF16, directions=1)))
    # K9: one ConvBlockRes at each width of the ResUNet
    for level, ch in enumerate(UNET_CHANNELS):
        t, f = UNET_T >> level, UNET_F >> level
        rows.append((f"K9 conv_block_res [1, {t}, {f}, {ch}]",
                     *conv_block_work(t, f, ch, BF16)))

    print(f"{'kernel':48s} {'GFLOP':>9s} {'MB':>9s} {'bound ms':>9s}  by")
    for name, flops, nbytes in rows:
        ms, by = bound_ms(nbytes, flops, PEAK_BF16)
        print(f"{name:48s} {flops / 1e9:9.3f} {nbytes / 1e6:9.2f} "
              f"{ms:9.4f}  {by} (bf16)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
