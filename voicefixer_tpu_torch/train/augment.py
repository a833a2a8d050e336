"""Training-time waveform augmentation, as ``voicefixer_tpu/train/
augment.py``: a random gain and additive noise at a random SNR, each draw
from an explicit ``torch.Generator`` (on the tensors' device)."""

from __future__ import annotations

import torch


def uniform(generator: torch.Generator, low: float, high: float, shape=(),
            device=None) -> torch.Tensor:
    """U(low, high) of ``shape``, float32."""
    u = torch.rand(shape, generator=generator, device=device)
    return low + (high - low) * u


def random_gain(generator: torch.Generator, wav: torch.Tensor,
                low_db: float = -12.0, high_db: float = 6.0) -> torch.Tensor:
    """A random gain in dB per utterance. wav: [B, N]."""
    db = uniform(generator, low_db, high_db, (wav.shape[0], 1), wav.device)
    return wav * 10.0 ** (db / 20.0)


def add_noise_and_scale(generator: torch.Generator, clean: torch.Tensor,
                        noise: torch.Tensor, snr_low_db: float = 0.0,
                        snr_high_db: float = 30.0):
    """Mix noise into clean at a random SNR per utterance, then apply one
    random gain to both. clean, noise: [B, N]. Returns (noisy, clean), the
    input pair of ``train.losses.analysis_loss``."""
    eps = 1e-8
    rms_c = clean.pow(2).mean(dim=-1, keepdim=True).sqrt() + eps
    rms_n = noise.pow(2).mean(dim=-1, keepdim=True).sqrt() + eps
    snr = uniform(generator, snr_low_db, snr_high_db, (clean.shape[0], 1),
                  clean.device)
    noisy = clean + noise * (rms_c / rms_n / 10.0 ** (snr / 20.0))
    gain = 10.0 ** (uniform(generator, -12.0, 6.0, (clean.shape[0], 1),
                            clean.device) / 20.0)
    return noisy * gain, clean * gain
