"""K10: BigVGAN's anti-aliased SnakeBeta activation (csrc/snake_aa.cu),
upstream's ``Activation1d(SnakeBeta)`` on a channel-last signal.

y = down(snake(up(x))): a 2x upsample by the 12-tap Kaiser-windowed sinc
(replicate pad 5, transposed conv of stride 2 times 2, crop 15 a side),
SnakeBeta u + sin^2(alpha u) / (beta + 1e-9) with alpha = exp(log_alpha)
and beta = exp(log_beta) per channel, then a 2x downsample by the same
filter (replicate pad (5, 6) of the activated signal, conv of stride 2).
Float32 inside; the output is rounded once to x's type (float32 or
bfloat16). It replaces no TPU kernel: the JAX package has no BigVGAN.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from voicefixer_tpu_torch import kernels
from voicefixer_tpu_torch.kernels import build

EPS = 1e-9  # SnakeBeta's guard against a division by zero


def kaiser_sinc_filter() -> torch.Tensor:
    """Upstream's ``kaiser_sinc_filter1d(cutoff=0.25, half_width=0.3,
    kernel_size=12)``, the filter of a 2x resampling, float32 [12]:
    2 cutoff window sinc(2 cutoff t) at t = arange(-6, 6) + 0.5, normalised
    to sum 1. The Kaiser window's beta is 0.1102 (A - 8.7) for the
    attenuation A = 2.285 (6 - 1) pi (4 half_width) + 7.95 = 51.0 (the
    branch of upstream's formula for A > 50): beta = 4.66."""
    cutoff, half_width, half = 0.25, 0.3, 6
    atten = 2.285 * (half - 1) * math.pi * 4 * half_width + 7.95
    window = torch.kaiser_window(2 * half, periodic=False,
                                 beta=0.1102 * (atten - 8.7))
    time = torch.arange(-half, half) + 0.5
    f = 2 * cutoff * window * torch.sinc(2 * cutoff * time)
    return f / f.sum()


FILTER = kaiser_sinc_filter()


def snake_aa_reference(x: torch.Tensor, log_alpha: torch.Tensor,
                       log_beta: torch.Tensor) -> torch.Tensor:
    """Plain version, in the kernel's polyphase form: with x~ the input's
    replicate pad (a clamp of the index),
    u[2j] = 2 sum_{d=-3..2} x~[j+d] f[5-2d],
    u[2j+1] = 2 sum_{d=-2..3} x~[j+d] f[6-2d],
    a = u + sin^2(alpha u) / (beta + 1e-9),
    y[t] = sum_k f[k] a[clamp(2t + k - 5, 0, 2T - 1)]."""
    bsz, t, c = x.shape
    f = FILTER.to(x.device)
    xf = x.float()
    rows = torch.arange(t, device=x.device)

    def shifted(d):
        return xf[:, (rows + d).clamp(0, t - 1)]
    even = sum(2 * f[5 - 2 * d] * shifted(d) for d in range(-3, 3))
    odd = sum(2 * f[6 - 2 * d] * shifted(d) for d in range(-2, 4))
    u = torch.stack([even, odd], 2).reshape(bsz, 2 * t, c)
    alpha = torch.exp(log_alpha.float())
    inv_beta = 1.0 / (torch.exp(log_beta.float()) + EPS)
    a = u + inv_beta * torch.sin(u * alpha) ** 2
    m = 2 * rows
    y = sum(f[k] * a[:, (m + k - 5).clamp(0, 2 * t - 1)] for k in range(12))
    return y.to(x.dtype)


def snake_aa(x: torch.Tensor, log_alpha: torch.Tensor,
             log_beta: torch.Tensor) -> torch.Tensor:
    """x: [B, T, C]; log_alpha, log_beta: [C] (upstream's parameters with
    ``snake_logscale``). Returns [B, T, C] in x's type."""
    if kernels.on_cpu(x, log_alpha, log_beta):
        return snake_aa_reference(x, log_alpha, log_beta)
    kernels.check_no_grad("snake_aa", x, log_alpha, log_beta)
    bsz, t, c = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"snake_aa: dtype {x.dtype}")
    if log_alpha.shape != (c,) or log_beta.shape != (c,):
        raise ValueError(f"snake_aa: x {tuple(x.shape)}, log_alpha "
                         f"{tuple(log_alpha.shape)}, log_beta "
                         f"{tuple(log_beta.shape)}")
    x = x.contiguous()
    log_alpha = log_alpha.to(x.dtype).contiguous()
    log_beta = log_beta.to(x.dtype).contiguous()
    y = torch.empty_like(x)
    lib, taps = _lib()
    rc = lib.vf_snake_aa(
        x.data_ptr(), log_alpha.data_ptr(), log_beta.data_ptr(), y.data_ptr(),
        bsz, t, c, taps, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, rc, "snake_aa")
    kernels.launches["snake_aa"] += 1
    return y


@functools.cache
def _lib():
    """The library and the filter's taps as a host array, which each launch
    copies into the kernel's arguments."""
    lib = build.load("snake_aa")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vf_snake_aa.argtypes = [p, p, p, p, i, i, i,
                                ctypes.POINTER(ctypes.c_float), i, p]
    lib.vf_snake_aa.restype = i
    return lib, (ctypes.c_float * len(FILTER))(*FILTER.tolist())
