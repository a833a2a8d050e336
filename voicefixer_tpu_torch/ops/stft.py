"""STFT pieces of the analysis stage, as in ``voicefixer_tpu/ops/stft.py``:
centre reflect padding of n_fft//2, a periodic Hann window folded into the
DFT matrices, and the np.fft sign convention
(real = sum x w cos, imag = -sum x w sin).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from voicefixer_tpu_torch.config import STFTConfig


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window (scipy.signal.get_window('hann', N, fftbins=True))."""
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    return w.astype(dtype)


def _padded_window(n_fft: int, win_length: int) -> np.ndarray:
    w = hann_window(win_length)
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        w = np.pad(w, (pad, n_fft - win_length - pad))
    return w


@functools.lru_cache(maxsize=8)
def dft_matrices(n_fft: int, win_length: int, device: torch.device):
    """Windowed DFT matrices (W_re, W_im), each [n_fft, n_freqs] float32.

    The angle 2*pi*n*k/N is reduced exactly first: n*k mod N in integers, so
    cos and sin see arguments in [0, 2*pi) and the float32 rounding of the
    angle never grows with n*k (``dft_matrices_ingraph`` in the JAX package
    does the same)."""
    n_freqs = n_fft // 2 + 1
    n = torch.arange(n_fft, dtype=torch.int64, device=device)[:, None]
    k = torch.arange(n_freqs, dtype=torch.int64, device=device)[None, :]
    ang = ((n * k) % n_fft).to(torch.float32) * np.float32(2.0 * math.pi / n_fft)
    w = torch.as_tensor(_padded_window(n_fft, win_length), device=device)[:, None]
    return torch.cos(ang) * w, -torch.sin(ang) * w


def num_frames(n_samples: int, cfg: STFTConfig) -> int:
    padded = n_samples + 2 * (cfg.n_fft // 2) if cfg.center else n_samples
    return (padded - cfg.n_fft) // cfg.hop_length + 1


def center_pad(x: torch.Tensor, cfg: STFTConfig) -> torch.Tensor:
    """[B, N] -> [B, N + 2*(n_fft//2)] with the configured pad mode."""
    if not cfg.center:
        return x
    pad = cfg.n_fft // 2
    return F.pad(x[:, None], (pad, pad), mode=cfg.pad_mode)[:, 0]


def frame_signal(x: torch.Tensor, cfg: STFTConfig) -> torch.Tensor:
    """[B, N] -> [B, T, n_fft] overlapping frames after centre padding."""
    return center_pad(x, cfg).unfold(-1, cfg.n_fft, cfg.hop_length)


def stft_real_imag(x: torch.Tensor, cfg: STFTConfig):
    """[B, N] -> (real, imag), each [B, T, n_freqs]."""
    frames = frame_signal(x, cfg)
    w_re, w_im = dft_matrices(cfg.n_fft, cfg.win_length, x.device)
    return frames @ w_re, frames @ w_im


def spectrogram(x: torch.Tensor, cfg: STFTConfig,
                eps: float = 0.0) -> torch.Tensor:
    """Magnitude spectrogram sqrt(max(re^2 + im^2, eps))."""
    real, imag = stft_real_imag(x, cfg)
    power = real * real + imag * imag
    if eps > 0.0:
        power = torch.clamp(power, min=eps)
    return torch.sqrt(power)
