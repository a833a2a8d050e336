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


def _padded_window(n_fft: int, win_length: int,
                   dtype=np.float32) -> np.ndarray:
    w = hann_window(win_length, dtype)
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


@functools.lru_cache(maxsize=8)
def fft_tables(n_fft: int, win_length: int, device: torch.device):
    """(window, twiddles) for an FFT of n_fft points on ``device``: the
    periodic Hann window zero-padded to n_fft, [n_fft] float32, and
    exp(-2 pi i k / n_fft) as (cos, -sin) pairs, [n_fft, 2] float32, taken
    in float64 and rounded once. Built once per (n_fft, win_length,
    device)."""
    ang = 2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    tw = np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)
    win = _padded_window(n_fft, win_length)
    return (torch.as_tensor(win, device=device),
            torch.as_tensor(tw, device=device))


def num_frames(n_samples: int, cfg: STFTConfig) -> int:
    padded = n_samples + 2 * (cfg.n_fft // 2) if cfg.center else n_samples
    return (padded - cfg.n_fft) // cfg.hop_length + 1


def center_pad(x: torch.Tensor, cfg: STFTConfig) -> torch.Tensor:
    """[..., N] -> [..., N + 2*(n_fft//2)] with the configured pad mode.

    "reflect" is ``jnp.pad``'s (and numpy's) for any pad length: a pad of N
    samples or more reflects again off the far end, with period 2(N - 1),
    and a single sample is repeated. ``F.pad`` covers pad < N only."""
    if not cfg.center:
        return x
    pad = cfg.n_fft // 2
    n = x.shape[-1]
    if cfg.pad_mode != "reflect" or pad < n:
        y = F.pad(x.reshape(-1, 1, n), (pad, pad), mode=cfg.pad_mode)
        return y.reshape(*x.shape[:-1], n + 2 * pad)
    idx = torch.arange(-pad, n + pad, device=x.device)
    if n == 1:
        idx = torch.zeros_like(idx)
    else:
        idx = torch.remainder(idx, 2 * (n - 1))
        idx = torch.where(idx < n, idx, 2 * (n - 1) - idx)
    return x[..., idx]


def frame_signal(x: torch.Tensor, cfg: STFTConfig) -> torch.Tensor:
    """[..., N] -> [..., T, n_fft] overlapping frames after centre
    padding."""
    return center_pad(x, cfg).unfold(-1, cfg.n_fft, cfg.hop_length)


def stft_real_imag(x: torch.Tensor, cfg: STFTConfig):
    """[..., N] -> (real, imag), each [..., T, n_freqs]."""
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


def spectrogram_phase(x: torch.Tensor, cfg: STFTConfig, eps: float = 1e-8):
    """(mag, cos, sin), each [..., T, n_freqs]; eps clamps the power before
    the square root."""
    real, imag = stft_real_imag(x, cfg)
    power = real * real + imag * imag
    mag = torch.sqrt(torch.clamp(power, min=eps))
    return mag, real / mag, imag / mag


def wav_to_spectrogram_phase(x: torch.Tensor, cfg: STFTConfig,
                             eps: float = 1e-8):
    """[B, C, N] -> (mag, cos, sin), each [B, C, T, n_freqs]: the channels
    as a batch axis."""
    return spectrogram_phase(x, cfg, eps=eps)


def spectrogram_to_wav(mag: torch.Tensor, cos: torch.Tensor,
                       sin: torch.Tensor, cfg: STFTConfig,
                       length: int | None = None) -> torch.Tensor:
    """The inverse of ``spectrogram_phase``: [..., T, n_freqs] -> [..., N]."""
    return istft(mag * cos, mag * sin, cfg, length=length)


@functools.lru_cache(maxsize=8)
def idft_matrices(n_fft: int, win_length: int, device: torch.device):
    """(M_re, M_im), each [n_freqs, n_fft] float32: one frame's irfft times
    the window, real @ M_re + imag @ M_im, imag in the np.fft sign
    convention. Hermitian weights 1 at DC and Nyquist, else 2; the angle is
    reduced exactly in integers first, as in ``dft_matrices``."""
    n_freqs = n_fft // 2 + 1
    k = torch.arange(n_freqs, dtype=torch.int64, device=device)[:, None]
    n = torch.arange(n_fft, dtype=torch.int64, device=device)[None, :]
    ang = ((k * n) % n_fft).to(torch.float32) * np.float32(2.0 * math.pi / n_fft)
    c = torch.where((k == 0) | (k == n_freqs - 1), 1.0, 2.0)
    w = _padded_window(n_fft, win_length, np.float64) / n_fft
    w = torch.as_tensor(w.astype(np.float32), device=device)[None, :]
    return c * torch.cos(ang) * w, -c * torch.sin(ang) * w


def _window_sq_sum(cfg: STFTConfig, t: int, device) -> torch.Tensor:
    """The overlap-add of t shifted copies of w^2, [n_fft + hop*(t-1)]:
    prefix sums of w^2's hop-sized chunks at the head, the full sum inside,
    suffix sums at the tail; a loop for fewer frames than chunks."""
    hop, n_fft = cfg.hop_length, cfg.n_fft
    rows = (n_fft - 1) // hop + 1
    total = n_fft + hop * (t - 1)
    w = _padded_window(n_fft, cfg.win_length, np.float64)
    if t >= rows:
        wr = torch.as_tensor(np.pad(w * w, (0, rows * hop - n_fft)).reshape(
            rows, hop), dtype=torch.float32, device=device)
        csum = torch.cumsum(wr, dim=0)
        full = csum[-1:]
        return torch.cat([csum[:rows - 1], full.expand(t - rows + 1, hop),
                          full - csum[:rows - 1]]).reshape(-1)[:total]
    wsq = np.zeros(total)
    for ti in range(t):
        wsq[ti * hop: ti * hop + n_fft] += w * w
    return torch.as_tensor(wsq, dtype=torch.float32, device=device)


def istft(real: torch.Tensor, imag: torch.Tensor, cfg: STFTConfig,
          length: int | None = None) -> torch.Tensor:
    """Inverse STFT by windowed overlap-add, librosa's semantics: real, imag
    [..., T, n_freqs] -> [..., n_samples], divided by the overlap-add of the
    squared window where it exceeds 1e-10, the centre pad cut off, then cut
    to ``length``. Each frame is split into hop-sized rows that are added
    shifted, whole rows at a time."""
    m_re, m_im = idft_matrices(cfg.n_fft, cfg.win_length, real.device)
    frames = real @ m_re.to(real.dtype) + imag @ m_im.to(real.dtype)
    t = frames.shape[-2]
    hop, n_fft = cfg.hop_length, cfg.n_fft
    total = n_fft + hop * (t - 1)
    batch = frames.shape[:-2]
    rows = (n_fft - 1) // hop + 1
    total_rows = t + rows - 1
    fr = F.pad(frames, (0, rows * hop - n_fft)).reshape(*batch, t, rows, hop)
    y = None
    for k in range(rows):
        contrib = F.pad(fr[..., :, k, :], (0, 0, k, total_rows - t - k))
        y = contrib if y is None else y + contrib
    y = y.reshape(*batch, total_rows * hop)[..., :total]
    wsq = _window_sq_sum(cfg, t, frames.device)
    wsq = torch.where(wsq > 1e-10, wsq, torch.ones_like(wsq))
    y = y / wsq.to(frames.dtype)
    if cfg.center:
        y = y[..., n_fft // 2: total - n_fft // 2]
    if length is not None:
        y = y[..., :length]
    return y
