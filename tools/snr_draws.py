#!/usr/bin/env python3
"""Production-against-parity SNR of mode-0 restore over several random weight
draws, at full width (DEFAULT_CONFIG), on the CPU, for the JAX package or the
PyTorch port:

    python tools/snr_draws.py --package jax --seeds 0 1 2 3
    python tools/snr_draws.py --package torch --seeds 0 1 2 3

Weights come from each package's own init: jax.random.PRNGKey(seed) split in
two as bench.py does, or torch.Generator().manual_seed(seed) in the port's
VoiceFixer.random. The input is 0.1 x white noise from numpy seed 0,
--seconds long, and goes through restore_segment in production precision
and in parity precision. Prints one line per draw: seed, output peak, SNR
in dB. Each package runs in its own process; the port never imports JAX.

With --weights DIR the port runs on the JAX package's draws instead, which
ties the port's full-width precision policy to the reference's:

    python tools/snr_draws.py --package jax --seeds 0 --seconds 1 --weights DIR
    python tools/snr_draws.py --package torch --seeds 0 --seconds 1 --weights DIR

The first writes each JAX draw's parameter trees and its SNR into DIR; the
second loads them through the port's ``load_pytree_npz`` and
``from_jax_params``, and exits 1 when the port's SNR on those weights is
more than --match-db from the JAX package's.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def snr_db(prod, ref) -> float:
    prod, ref = np.asarray(prod, np.float64), np.asarray(ref, np.float64)
    return float(10 * np.log10((np.sum(ref * ref) + 1e-20)
                               / (np.sum((prod - ref) ** 2) + 1e-20)))


def _paths(weights: str, seed: int):
    return {k: os.path.join(weights, f"jax_seed{seed}_{k}")
            for k in ("analysis.npz", "vocoder.npz", "snr.json")}


def jax_draw(seed: int, wav: np.ndarray, weights: str | None = None):
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    from voicefixer_tpu.config import DEFAULT_CONFIG
    from voicefixer_tpu.models import analysis, vocoder
    from voicefixer_tpu.ops.conv import fold_bn_eval
    from voicefixer_tpu.ops.precision import precision
    from voicefixer_tpu.pipeline.restore import restore_segment
    from voicefixer_tpu.utils.weights import save_pytree_npz

    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    aparams = analysis.init(k1, DEFAULT_CONFIG)
    vparams = vocoder.init(k2, DEFAULT_CONFIG.vocoder)
    if weights:
        os.makedirs(weights, exist_ok=True)
        paths = _paths(weights, seed)
        save_pytree_npz(jax.device_get(aparams), paths["analysis.npz"])
        save_pytree_npz(jax.device_get(vparams), paths["vocoder.npz"])
    params = fold_bn_eval(aparams)
    out = {}
    for mode in ("default", "highest"):
        with precision(mode):  # read at trace time: a fresh jit per mode
            fn = jax.jit(functools.partial(restore_segment, cfg=DEFAULT_CONFIG))
            out[mode] = np.asarray(fn(params, vparams, wav)[0])
    return out["default"], out["highest"]


def torch_draw(seed: int, wav: np.ndarray, weights: str | None = None):
    import torch

    from voicefixer_tpu_torch.config import DEFAULT_CONFIG
    from voicefixer_tpu_torch.ops.precision import precision
    from voicefixer_tpu_torch.pipeline.restore import (VoiceFixer,
                                                      restore_segment)
    from voicefixer_tpu_torch.utils.weights import (from_jax_params,
                                                    load_pytree_npz)

    if weights:
        paths = _paths(weights, seed)
        vf = VoiceFixer(*from_jax_params(load_pytree_npz(paths["analysis.npz"]),
                                         load_pytree_npz(paths["vocoder.npz"])),
                        DEFAULT_CONFIG, device="cpu")
    else:
        vf = VoiceFixer.random(seed, DEFAULT_CONFIG, device="cpu")
    out = {}
    for mode in ("production", "parity"):
        with precision(mode):
            out[mode] = restore_segment(vf.params, vf.vocoder_params,
                                        torch.from_numpy(wav),
                                        DEFAULT_CONFIG)[0].float().numpy()
    return out["production"], out["parity"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--weights", default=None,
                    help="directory for the JAX draws the port runs on")
    ap.add_argument("--match-db", type=float, default=1.0)
    args = ap.parse_args()
    wav = (0.1 * np.random.default_rng(0).standard_normal(
        int(44100 * args.seconds))).astype(np.float32)
    draw = jax_draw if args.package == "jax" else torch_draw
    ok = True
    for seed in args.seeds:
        prod, ref = draw(seed, wav, args.weights)
        snr = snr_db(prod, ref)
        line = (f"{args.package} seed {seed}: peak {np.abs(ref).max():.6f}, "
                f"production vs parity SNR {snr:.2f} dB")
        if args.weights:
            path = _paths(args.weights, seed)["snr.json"]
            if args.package == "jax":
                with open(path, "w") as f:
                    json.dump({"snr_db": snr, "seconds": args.seconds}, f)
                line += " (JAX draw saved)"
            else:
                with open(path) as f:
                    want = json.load(f)["snr_db"]
                agree = abs(snr - want) <= args.match_db
                ok &= agree
                line += (f" on the JAX package's draw, whose own is "
                         f"{want:.2f} dB: {'within' if agree else 'NOT within'}"
                         f" {args.match_db} dB")
        print(line, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
