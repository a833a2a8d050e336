#!/usr/bin/env python3
"""Run-to-run reproducibility of the main path on one CUDA card: each stage
of a full-width 30 s chunk (chip_smoke.py's weights from its seed, 0.1-sigma
white noise, parity) runs twice on the same inputs, and the largest
difference between the two outputs is printed, stage by stage; then once
more with cuDNN's deterministic algorithms (``torch.backends.cudnn
.deterministic``). A stage whose two runs differ sums in an order that
changes from run to run.

    python3 tools/torch_run_to_run.py [--reps N]

Prints the card's name and power limit, one line per stage and setting,
and one JSON object as the last line.
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
    ap.add_argument("--reps", type=int, default=3,
                    help="runs of each stage compared with the first")
    opts = ap.parse_args()
    sys.path.insert(0, str(HERE))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import numpy as np
    import torch

    from voicefixer_tpu_torch.config import DEFAULT_CONFIG as C
    from voicefixer_tpu_torch.models import analysis, denoiser, resunet
    from voicefixer_tpu_torch.ops.norm import from_log, to_log
    from voicefixer_tpu_torch.ops.precision import tf32_off
    from voicefixer_tpu_torch.pipeline import vocoder_facade
    from voicefixer_tpu_torch.pipeline.restore import VoiceFixer
    if not torch.cuda.is_available():
        print("torch_run_to_run: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    device = torch.device("cuda", 0)
    vf = VoiceFixer.random(cs.SEED, C, device=device)
    p, vp = vf.params, vf.vocoder_params
    wav = torch.from_numpy((0.1 * np.random.default_rng(cs.SEED)
                            .standard_normal(C.pipeline.seg_length))
                           .astype(np.float32)[None]).to(device)
    result = {}
    for deterministic in (False, True):
        torch.backends.cudnn.deterministic = deterministic
        with tf32_off(), torch.inference_mode():
            mel = analysis.wav_to_mel(wav, C)
            mask = denoiser.apply(p["denoiser"], mel, C.denoiser)
            x = torch.stack([to_log(mel), to_log(mask * mel)], -1)
            den = from_log(analysis.apply(p, mel, C)["mel"])
            stages = {
                "stft_mel (K5)": lambda: analysis.wav_to_mel(wav, C),
                "denoiser (K6, linears)": lambda: denoiser.apply(
                    p["denoiser"], mel, C.denoiser),
                "resunet (cuDNN)": lambda: resunet.apply(p["unet"], x,
                                                         C.unet),
                "vocoder (K1-K4, cuDNN)": lambda: vocoder_facade.synthesize(
                    vp, den, C.vocoder),
                "restore_batch": lambda: vf._restore_batch(
                    wav.cpu().numpy())[0],
            }
            for name, fn in stages.items():
                first = torch.as_tensor(fn()).float()
                diff = max(float((torch.as_tensor(fn()).float() - first)
                                 .abs().max()) for _ in range(opts.reps))
                key = f"{name}{', cudnn deterministic' if deterministic else ''}"
                result[key] = diff
                print(f"  {key}: max abs diff over {opts.reps} reruns "
                      f"{diff:.3e} (max |out| "
                      f"{float(first.abs().max()):.3e})", flush=True)
    torch.backends.cudnn.deterministic = False
    print(json.dumps({"card": card, "max_abs_diff": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
