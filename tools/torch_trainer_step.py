#!/usr/bin/env python3
"""The analysis-stage trainer's step at ``DEFAULT_CONFIG`` on one CUDA card,
as chip_smoke.py's trainer phase takes it (parameters from seed 0,
``reference_optimizer(warmup_steps=1)``, a batch of two 3 s pairs: 0.1-sigma
noise and that plus 0.05-sigma noise, from a numpy seed), float32 with TF32
off: --steps steps after two warm-up steps, each split by CUDA events into
forward (``losses.analysis_loss``), backward and optimizer, their medians,
and the profiler's device time of one step: in all, and of K6's forward
and backward kernels.

    python3 tools/torch_trainer_step.py [--root DIR] [--steps N]

--root imports ``voicefixer_tpu_torch`` from another checkout (for example
a ``git archive`` of an earlier commit, unpacked into a directory that
.gitignore lists), whose kernels it builds there. Run it on two checkouts
in turns (A, B, B, A) in one call to compare them: a step's time follows
the host, which varies from call to call. Prints the card's name and power
limit and one JSON object as the last line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
SEED = 0
BATCH, SECONDS = 2, 3.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--steps", type=int, default=10)
    opts = ap.parse_args()
    root = opts.root.resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("torch_trainer_step: no CUDA device", file=sys.stderr)
        return 2
    from voicefixer_tpu_torch import kernels
    from voicefixer_tpu_torch.config import DEFAULT_CONFIG as C
    from voicefixer_tpu_torch.models import analysis
    from voicefixer_tpu_torch.ops.precision import tf32_off
    from voicefixer_tpu_torch.train import losses
    from voicefixer_tpu_torch.train import step as st

    device = torch.device("cuda", 0)
    params = analysis.init(C, torch.Generator().manual_seed(SEED), device)
    state = st.init_train_state(params, st.reference_optimizer(
        warmup_steps=1), device=device)
    rng = np.random.default_rng(SEED + 5)
    n = int(SECONDS * C.pipeline.sample_rate)
    clean = (0.1 * rng.standard_normal((BATCH, n))).astype(np.float32)
    noisy = (clean + 0.05 * rng.standard_normal((BATCH, n))).astype(
        np.float32)
    wn, wc = (torch.from_numpy(v).to(device) for v in (noisy, clean))
    gen = torch.Generator(device).manual_seed(SEED)

    def step(ev=None):
        state.optimizer.zero_grad(set_to_none=True)
        if ev:
            ev[0].record()
        with tf32_off():
            total, _ = losses.analysis_loss(state.params, wn, wc, C, gen)
            if ev:
                ev[1].record()
            total.backward()
        if ev:
            ev[2].record()
        st.update(state)
        if ev:
            ev[3].record()

    for _ in range(2):
        step()
    split = []
    for _ in range(opts.steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        step(ev)
        torch.cuda.synchronize()
        split.append([ev[k].elapsed_time(ev[k + 1]) for k in range(3)])
    med = [statistics.median(c) for c in zip(*split)]
    kernels.reset_launches()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.launches.items() if v}
    k6 = {"forward": 0.0, "backward": 0.0}
    busy = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)) / 1e3
        busy += ms
        if "gru_bidir" in e.key:
            k6["backward" if "backward" in e.key else "forward"] += ms
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(f"{root}: ms per step, median of {opts.steps} (events): forward "
          f"{med[0]:.2f}, backward {med[1]:.2f}, optimizer {med[2]:.2f}; "
          f"one step's device time {busy:.2f} ms, K6 forward "
          f"{k6['forward']:.3f} and backward kernels {k6['backward']:.3f}; "
          f"launches {launches}", flush=True)
    print(card)
    print(json.dumps({"root": str(root), "forward_ms": med[0],
                      "backward_ms": med[1], "optimizer_ms": med[2],
                      "device_ms": busy, "k6_device_ms": k6,
                      "launches": launches,
                      "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
