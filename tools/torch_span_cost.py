#!/usr/bin/env python3
"""What the port's program spans cost on one CUDA card's host:
``utils.profiling.annotate`` entered and left with nothing inside, in µs
a span, with the profiler off and under ``torch.profiler`` (CPU and CUDA
activities), each over --n spans less the same loop around
``contextlib.nullcontext``, the median of --reps; its parts
(``record_function``, the NVTX push and pop, ``torch.cuda.is_available``)
each alone; and what the weight casts (``vf.cast``) cost at full width
with random weights in production: the ResUNet's tree and the vocoder's
(``utils.weights.cast_tree``: on every call for a caller's float32 tree,
once for an instance), each the median of --casts, by the host's clock (the call's return) and by CUDA
events (its kernels' span on the card), with the profiler off and, by
the host's clock, under it. With --requests it also restores one 12 s
clip in both precisions and one 8.5 min recording in production (17
segments, in one call and in calls of at most 6 rows), each under the
profiler after a warm-up, and counts the ``vf.*`` spans a request.

    python3 tools/torch_span_cost.py [--root DIR] [--n N] [--reps R]
                                     [--casts C] [--requests]

--root imports ``voicefixer_tpu_torch`` from another checkout (a
``git archive`` of an earlier commit, unpacked into a directory that
.gitignore lists), so that two commits' spans are timed in one call, in
turns (A, B, B, A). Prints the card's name and power limit, and one JSON
object as the last line.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def _per_span_us(enter, n: int, reps: int, profiled: bool) -> float:
    """Median over reps of (n spans of ``enter`` less n null contexts),
    in µs a span."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def loop(cm):
        t0 = time.perf_counter()
        for _ in range(n):
            with cm("vf.cost"):
                pass
        return time.perf_counter() - t0

    def null(_name):
        return contextlib.nullcontext()

    out = []
    for _ in range(reps):
        if profiled:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                spans, base = loop(enter), loop(null)
            torch.cuda.synchronize()
        else:
            spans, base = loop(enter), loop(null)
        out.append((spans - base) / n * 1e6)
    return statistics.median(out)


def _cast_ms(reps: int) -> dict:
    """The per-call casts of one production request at full width: for
    the ResUNet's tree and the vocoder's, the leaves cast and the median
    over reps of host ms (to the cast's return, off and profiled) and of
    device ms (CUDA events around it, off)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from voicefixer_tpu_torch.config import DEFAULT_CONFIG
    from voicefixer_tpu_torch.models import resunet
    from voicefixer_tpu_torch.ops.precision import precision
    from voicefixer_tpu_torch.pipeline.restore import VoiceFixer
    from voicefixer_tpu_torch.utils.weights import tree_map
    try:
        from voicefixer_tpu_torch.utils.weights import cast_tree
    except ImportError:  # a checkout from before cast_tree
        cast_tree = resunet._cast
    bf16 = torch.bfloat16
    with precision("production"):
        vf = VoiceFixer.random(19, DEFAULT_CONFIG,
                               device=torch.device("cuda", 0))
    trees = {"resunet": (vf.params["unet"], lambda t: cast_tree(t, bf16)),
             "vocoder": (vf.vocoder_params, lambda t: cast_tree(t, bf16))}
    out = {}
    for name, (tree, cast) in trees.items():
        host, dev, prof_host = [], [], []
        leaves = []
        tree_map(leaves.append, tree)
        for _ in range(reps):
            torch.cuda.synchronize()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            a.record()
            cast(tree)
            b.record()
            host.append((time.perf_counter() - t0) * 1e3)
            b.synchronize()
            dev.append(a.elapsed_time(b))
        for _ in range(reps):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                t0 = time.perf_counter()
                cast(tree)
                prof_host.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
        out[name] = {"leaves": len(leaves),
                     "host_ms_off": statistics.median(host),
                     "device_ms_off": statistics.median(dev),
                     "host_ms_profiled": statistics.median(prof_host)}
    del vf
    torch.cuda.empty_cache()
    return out


def _spans_a_request(vf, wav) -> dict:
    """The vf.* ranges of one restore_inmem under the profiler, by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    vf.restore_inmem(wav)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        vf.restore_inmem(wav)
        torch.cuda.synchronize()
    cpu = torch.autograd.DeviceType.CPU
    names = collections.Counter(e.name for e in prof.events()
                                if e.name.startswith("vf.")
                                and e.device_type == cpu)
    return dict(sorted(names.items()))


def _requests() -> dict:
    import numpy as np
    import torch

    from voicefixer_tpu_torch.config import DEFAULT_CONFIG
    from voicefixer_tpu_torch.ops.precision import precision
    from voicefixer_tpu_torch.pipeline import plan
    from voicefixer_tpu_torch.pipeline.restore import VoiceFixer
    sr = DEFAULT_CONFIG.pipeline.sample_rate
    rng = np.random.default_rng(19)

    def wav(seconds):
        return (0.1 * rng.standard_normal(int(seconds * sr))
                ).astype(np.float32)
    out = {}
    clip, long = wav(12.0), wav(510.0)
    for mode in ("production", "parity"):
        with precision(mode):
            vf = VoiceFixer.random(19, DEFAULT_CONFIG,
                                   device=torch.device("cuda", 0))
            out[f"{mode}.clip_12s"] = _spans_a_request(vf, clip)
            if mode == "production":
                out["production.long_510s"] = _spans_a_request(vf, long)
                cap = plan.rows_per_call
                plan.rows_per_call = lambda *a, **k: min(cap(*a, **k), 6)
                try:
                    out["production.long_510s_cap6"] = _spans_a_request(
                        vf, long)
                finally:
                    plan.rows_per_call = cap
            del vf
            torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--casts", type=int, default=9)
    ap.add_argument("--requests", action="store_true")
    opts = ap.parse_args()
    root = opts.root.resolve()
    sys.path.insert(0, str(root))

    import torch

    from voicefixer_tpu_torch.utils.profiling import annotate
    if not torch.cuda.is_available():
        print("torch_span_cost: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; package from {root}", flush=True)
    torch.zeros(1, device="cuda")
    @contextlib.contextmanager
    def nvtx(name):
        torch.cuda.nvtx.range_push(name)
        yield
        torch.cuda.nvtx.range_pop()

    @contextlib.contextmanager
    def is_available(_name):
        torch.cuda.is_available()
        yield
    result = {
        "card": card, "root": str(root),
        "span_us_off": _per_span_us(annotate, opts.n, opts.reps, False),
        "span_us_profiled": _per_span_us(annotate, opts.n // 10, opts.reps,
                                         True),
        # the parts of a span, with the profiler off
        "record_function_us": _per_span_us(
            torch.profiler.record_function, opts.n, opts.reps, False),
        "nvtx_us": _per_span_us(nvtx, opts.n, opts.reps, False),
        "is_available_us": _per_span_us(is_available, opts.n, opts.reps,
                                        False),
    }
    if opts.casts:
        result["casts"] = _cast_ms(opts.casts)
    if opts.requests:
        result["spans_a_request"] = _requests()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
