"""BigVGAN-v2 44 kHz (128 bands, 512x) in plain float32 PyTorch, TF32 off,
for the port's tests: upstream's equations (NVIDIA/BigVGAN ``bigvgan.py``,
``activations.py``, ``alias_free_activation/torch/``,
``meldataset.py``) written out with ``F.conv1d``, ``F.conv_transpose1d``
and ``F.pad(mode="replicate")`` in upstream's [B, C, T] layout, on
upstream's state dict. It imports nothing of the port and nothing of JAX.
``bench_cuda/reference/bigvgan.py`` is the benchmark's own copy (with the
lower precisions of its control); a test holds the two to each other.

Departures from upstream: the Kaiser filter is computed here, not read
from the state dict's buffers (they hold the same numbers); a state dict
without weight norm (plain ``weight``) is read too.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def slaney_mel_basis(sr, n_fft, n_mels, fmin, fmax) -> np.ndarray:
    """``librosa.filters.mel`` (Slaney scale and norm), float32
    [n_mels, 1 + n_fft // 2]."""
    f_sp, min_hz, logstep = 200.0 / 3, 1000.0, math.log(6.4) / 27.0
    min_mel = min_hz / f_sp

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= min_hz, min_mel
                        + np.log(np.maximum(f, 1e-10) / min_hz) / logstep,
                        f / f_sp)

    def mel_to_hz(m):
        return np.where(m >= min_mel, min_hz * np.exp(logstep * (m - min_mel)),
                        f_sp * m)

    fmax = sr / 2.0 if fmax is None else fmax
    freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax),
                                  n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = np.subtract.outer(mel_f, freqs)
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_f[2:] - mel_f[:-2]))[:, None]
    return weights.astype(np.float32)


def log_mel(wave: torch.Tensor, cfg) -> torch.Tensor:
    """Upstream's ``mel_spectrogram``: [B, N] -> [B, num_mels, N // hop]."""
    basis = torch.as_tensor(slaney_mel_basis(
        cfg.sampling_rate, cfg.n_fft, cfg.num_mels, cfg.fmin, cfg.fmax))
    pad = (cfg.n_fft - cfg.hop_size) // 2
    y = F.pad(wave[:, None], (pad, pad), mode="reflect")[:, 0]
    spec = torch.stft(y, cfg.n_fft, hop_length=cfg.hop_size,
                      win_length=cfg.win_size,
                      window=torch.hann_window(cfg.win_size), center=False,
                      return_complex=True)
    mag = torch.sqrt(torch.view_as_real(spec).pow(2).sum(-1) + 1e-9)
    return torch.log(torch.clamp(basis @ mag, min=1e-5))


def kaiser_sinc_filter1d(cutoff, half_width, kernel_size) -> torch.Tensor:
    """Upstream's filter ([1, 1, k]), for an even kernel size."""
    half_size = kernel_size // 2
    amp = 2.285 * (half_size - 1) * math.pi * 4 * half_width + 7.95
    if amp > 50.0:
        beta = 0.1102 * (amp - 8.7)
    elif amp >= 21.0:
        beta = 0.5842 * (amp - 21) ** 0.4 + 0.07886 * (amp - 21.0)
    else:
        beta = 0.0
    window = torch.kaiser_window(kernel_size, beta=beta, periodic=False)
    x = 2 * cutoff * (torch.arange(-half_size, half_size) + 0.5)
    sinc = torch.where(x == 0, torch.tensor(1.0),
                       torch.sin(math.pi * x) / math.pi / x)
    filt = 2 * cutoff * window * sinc
    return (filt / filt.sum()).view(1, 1, kernel_size)


FILTER = kaiser_sinc_filter1d(0.25, 0.3, 12)


def weight(sd: dict, prefix: str) -> torch.Tensor:
    """Weight norm folded in float64: g v / ||v|| over all but dim 0, from
    weight_g / weight_v or parametrizations.weight.original0 / 1."""
    if f"{prefix}.weight" in sd:
        return torch.as_tensor(sd[f"{prefix}.weight"]).float()
    g_key, v_key = f"{prefix}.weight_g", f"{prefix}.weight_v"
    if g_key not in sd:
        g_key = f"{prefix}.parametrizations.weight.original0"
        v_key = f"{prefix}.parametrizations.weight.original1"
    g = torch.as_tensor(sd[g_key]).double()
    v = torch.as_tensor(sd[v_key]).double()
    norm = v.pow(2).sum(dim=tuple(range(1, v.ndim)), keepdim=True).sqrt()
    return (g * v / norm).float()


def activation1d(x: torch.Tensor, log_alpha, log_beta) -> torch.Tensor:
    """``Activation1d(SnakeBeta(alpha_logscale=True))`` on [B, C, T]."""
    c = x.shape[1]
    f = FILTER.expand(c, -1, -1)
    u = F.pad(x, (5, 5), mode="replicate")
    u = 2 * F.conv_transpose1d(u, f, stride=2, groups=c)[..., 15:-15]
    alpha = torch.exp(torch.as_tensor(log_alpha).float())[None, :, None]
    beta = torch.exp(torch.as_tensor(log_beta).float())[None, :, None]
    u = u + (1.0 / (beta + 1e-9)) * torch.sin(u * alpha) ** 2
    return F.conv1d(F.pad(u, (5, 6), mode="replicate"), f, stride=2,
                    groups=c)


def generate(sd: dict, mel: torch.Tensor, cfg) -> torch.Tensor:
    """Upstream's ``BigVGAN.forward``: log-mel [B, num_mels, T] -> wave
    [B, T * hop] (``cfg``: a ``BigVGANConfig`` or the same fields)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _generate(sd, mel, cfg)
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _act(sd, x, prefix):
    return activation1d(x, sd[f"{prefix}.act.alpha"], sd[f"{prefix}.act.beta"])


def _conv(sd, x, prefix, padding, dilation=1, bias=True):
    b = torch.as_tensor(sd[f"{prefix}.bias"]).float() if bias else None
    return F.conv1d(x, weight(sd, prefix), b, padding=padding,
                    dilation=dilation)


def _generate(sd, mel, cfg):
    x = _conv(sd, mel.float(), "conv_pre", 3)
    n_k = len(cfg.resblock_kernel_sizes)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                   cfg.upsample_kernel_sizes)):
        x = F.conv_transpose1d(x, weight(sd, f"ups.{i}.0"),
                               torch.as_tensor(sd[f"ups.{i}.0.bias"]).float(),
                               stride=u, padding=(k - u) // 2)
        xs = None
        for j, (kr, dils) in enumerate(zip(cfg.resblock_kernel_sizes,
                                           cfg.resblock_dilation_sizes)):
            p, y = f"resblocks.{i * n_k + j}", x
            for m, d in enumerate(dils):
                xt = _act(sd, y, f"{p}.activations.{2 * m}")
                xt = _conv(sd, xt, f"{p}.convs1.{m}", d * (kr - 1) // 2, d)
                xt = _act(sd, xt, f"{p}.activations.{2 * m + 1}")
                xt = _conv(sd, xt, f"{p}.convs2.{m}", (kr - 1) // 2)
                y = xt + y
            xs = y if xs is None else xs + y
        x = xs / n_k
    x = _conv(sd, _act(sd, x, "activation_post"), "conv_post", 3,
              bias=False)
    return torch.clamp(x[:, 0], -1.0, 1.0)
