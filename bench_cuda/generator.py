"""The one traffic generator: a mix file's parameters and a seed in, the
requests' inputs out.

A mix (``traffic/<name>.json``) states:

- ``about``: who sends such traffic, and the public source of its lengths;
- ``loop``: "closed" with ``clients``: 1, the one kind of loop there is:
  each request is sent when the previous one has returned;
- ``entry``: the program's entry point that serves a request, a module
  ``entries/<entry>.py`` found by name, and ``kwargs``, the keyword
  arguments it passes to that entry (the entry refuses those whose answers
  the reference cannot judge);
- ``per_request``: recordings a request carries (1 when absent), the next
  ones of the order;
- ``seconds``: the recordings' lengths, {"dist": "uniform", "log_uniform"
  or "lognormal", "min", "max"}; "lognormal" also takes ``median`` and
  ``sigma`` (of the natural logarithm) and is cut to [min, max];
- ``pool``: how many distinct recordings are made; the window cycles
  through them. Their lengths are the distribution's quantiles at
  (i + 0.5) / pool, the same in every run, and the seed draws their order
  and their content, so that every seed asks for the same work;
- ``warmup``: requests before the window (set-up), the first of the order;
- ``check``: what ``correct`` compares: ``requests`` answers kept from the
  window (a uniform sample drawn from the seed) and, of each recording, at
  most ``segments`` 30 s segments (the last one, padded, always among
  them);
- ``trace_requests``: requests recorded by the profiler in a traced run;
- ``degradation``: the noise's SNR range in dB (``snr_db``) and the share
  of the peak at which the recording is clipped (``clip``).

The recordings are synthetic degraded speech, made on the device in bulk:
a harmonic source on a moving pitch, shaped by three moving formants and a
syllable envelope with pauses, plus white noise, then clipped and scaled
to a peak of 0.9. What the program computes does not depend on the
content, only on the lengths.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np
import torch

LOOPS = {("closed", 1)}
DISTS = ("uniform", "log_uniform", "lognormal")
HARMONICS = 48
CHUNK = 1 << 20  # samples a pass on the device


def validate(mix: dict):
    if (mix["loop"], mix["clients"]) not in LOOPS:
        raise ValueError(f"loop {mix['loop']!r} with {mix['clients']} "
                         f"clients: only {sorted(LOOPS)}")
    d = mix["seconds"]
    if d["dist"] not in DISTS:
        raise ValueError(f"dist {d['dist']!r}: one of {DISTS}")
    if not 0 < d["min"] <= d["max"]:
        raise ValueError(f"seconds {d}")
    if d["dist"] == "lognormal" and not (d["median"] > 0 and d["sigma"] > 0):
        raise ValueError(f"lognormal needs a median and a sigma: {d}")
    if not 1 <= mix.get("per_request", 1) <= mix["pool"]:
        raise ValueError(f"per_request {mix.get('per_request')} of a pool "
                         f"of {mix['pool']}")


def lengths(mix: dict, sample_rate: int) -> list:
    """The pool's lengths in samples: the distribution's quantiles at
    (i + 0.5) / pool, in increasing order."""
    d, n = mix["seconds"], mix["pool"]
    lo, hi = float(d["min"]), float(d["max"])
    out = []
    for i in range(n):
        q = (i + 0.5) / n
        if d["dist"] == "uniform":
            s = lo + q * (hi - lo)
        elif d["dist"] == "log_uniform":
            s = lo * (hi / lo) ** q
        else:
            s = d["median"] * math.exp(d["sigma"] * NormalDist().inv_cdf(q))
        out.append(int(round(min(max(s, lo), hi) * sample_rate)))
    return out


def order(mix: dict, seed: int) -> np.ndarray:
    """The pool's indices in the order the window sends them, drawn from
    the seed; the window cycles through it."""
    return np.random.default_rng([int(seed), 7]).permutation(mix["pool"])


def request(mix: dict, order: np.ndarray, k: int) -> list:
    """The pool indices of the k-th request: the next ``per_request`` of
    the order, cycling."""
    n = mix.get("per_request", 1)
    return [int(order[(k * n + j) % len(order)]) for j in range(n)]


def _speech(n: int, sr: int, gen: torch.Generator, device,
            snr_db: tuple, clip: float) -> torch.Tensor:
    """One recording of n samples, float32 on ``device``, peak 0.9."""
    def u(lo, hi, k=1):
        return lo + (hi - lo) * torch.rand(k, generator=gen, device=device,
                                           dtype=torch.float64)
    f0, vib, vib_hz, drift_hz = u(90, 220), u(0.05, 0.15), u(3, 6), \
        u(0.1, 0.4)
    ph = u(0, 2 * math.pi, 8)
    formants = [(u(350, 800), u(100, 250), u(0.3, 1.5)),
                (u(900, 2200), u(200, 500), u(0.3, 1.5)),
                (u(2300, 3200), u(100, 300), u(0.3, 1.5))]
    syl_hz, pause_hz = u(3, 5), u(0.15, 0.35)
    k = torch.arange(1, HARMONICS + 1, device=device, dtype=torch.float64)
    out = torch.empty(n, dtype=torch.float32, device=device)
    for s0 in range(0, n, CHUNK):
        t = torch.arange(s0, min(n, s0 + CHUNK), device=device,
                         dtype=torch.float64) / sr
        w = 2 * math.pi
        # the pitch and its phase, the integral of 2 pi f0(t)
        pitch = f0 * (1 + vib * torch.sin(w * vib_hz * t + ph[0])
                      + 0.3 * torch.sin(w * drift_hz * t + ph[1]))
        phase = w * f0 * (t - vib / (w * vib_hz) * torch.cos(
            w * vib_hz * t + ph[0]) - 0.3 / (w * drift_hz) * torch.cos(
            w * drift_hz * t + ph[1]))
        harm = k[:, None] * pitch[None]  # [K, n] Hz
        amp = torch.zeros_like(harm)
        for i, (fc, dev, rate) in enumerate(formants):
            centre = fc * (1 + 0.2 * torch.sin(w * rate * t + ph[2 + i]))
            amp += torch.exp(-0.5 * ((harm - centre) / (dev + 0.1 * fc)) ** 2)
        amp *= (harm < sr / 2) / k[:, None].sqrt()
        voiced = (torch.sin(k[:, None] * torch.remainder(phase, w))
                  * amp).sum(0)
        env = (0.5 + 0.5 * torch.sin(w * syl_hz * t + ph[5])) ** 2
        env *= torch.sigmoid(8 * torch.sin(w * pause_hz * t + ph[6]) + 4)
        out[s0: s0 + t.numel()] = (voiced * env).float()
    out /= out.abs().max().clamp(min=1e-6)
    snr = u(*snr_db)
    sigma = out.pow(2).mean().sqrt() * 10 ** (-snr / 20)
    noise = torch.randn(n, generator=gen, device=device)
    out += sigma.float() * noise
    level = clip * out.abs().max()
    out = out.clamp(-level, level)
    return out * (0.9 / out.abs().max())


def recordings(mix: dict, seed: int, sample_rate: int, device) -> list:
    """The pool's recordings as float32 numpy waves, made on ``device``
    from ``seed``."""
    validate(mix)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    deg = mix["degradation"]
    waves = [_speech(n, sample_rate, gen, device, tuple(deg["snr_db"]),
                     float(deg["clip"]))
             for n in lengths(mix, sample_rate)]
    return [w.cpu().numpy() for w in waves]

