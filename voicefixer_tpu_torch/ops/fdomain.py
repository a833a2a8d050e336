"""Complex and subband spectrogram transforms, as
``voicefixer_tpu/ops/fdomain.py`` (upstream's ``FDomainHelper``), on the
port's ``ops.stft`` and ``ops.pqmf``.

Layouts and channel orders are the JAX package's: waves [B, C, N]; complex
spectrograms [B, 2C, T, F] with channel c at rows (2c, 2c+1); subband
signals [B, C*S, N/S] with channel c's subbands at rows [cS, (c+1)S). With
subband = S the STFT runs at n_fft/S, hop/S and win/S on the S-times
decimated subband signals. Every function runs on the device its input
lies on.
"""

from __future__ import annotations

import dataclasses

import torch

from voicefixer_tpu_torch.config import STFTConfig
from voicefixer_tpu_torch.ops import pqmf
from voicefixer_tpu_torch.ops.stft import (istft, spectrogram,
                                           spectrogram_phase, stft_real_imag)


def subband_config(cfg: STFTConfig, subband: int) -> STFTConfig:
    """STFT settings for S-times decimated subband signals."""
    return dataclasses.replace(cfg, n_fft=cfg.n_fft // subband,
                               hop_length=cfg.hop_length // subband,
                               win_length=cfg.win_length // subband)


# ------------------------------------------------------------- magnitude path

def wav_to_spectrogram(x: torch.Tensor, cfg: STFTConfig,
                       eps: float = 1e-8) -> torch.Tensor:
    """[B, C, N] -> magnitude [B, C, T, F]."""
    return spectrogram(x, cfg, eps=eps)


def spectrogram_to_wav_with_phase_from(x: torch.Tensor, mag: torch.Tensor,
                                       cfg: STFTConfig,
                                       length: int | None = None
                                       ) -> torch.Tensor:
    """``mag`` [B, C, T, F] resynthesised with the phase of ``x`` [B, C, N]
    -> [B, C, N]."""
    _, cos, sin = spectrogram_phase(x, cfg, eps=1e-8)
    return istft(mag * cos, mag * sin, cfg, length=length)


def spectrogram_phase_to_wav(sps: torch.Tensor, coss: torch.Tensor,
                             sins: torch.Tensor, cfg: STFTConfig,
                             length: int | None = None) -> torch.Tensor:
    """(mag, cos, sin) [B, C, T, F] -> [B, C, N]."""
    return istft(sps * coss, sps * sins, cfg, length=length)


# --------------------------------------------------------------- complex path

def complex_spectrogram(x: torch.Tensor, cfg: STFTConfig) -> torch.Tensor:
    """[B, N] -> [B, 2, T, F], real and imaginary parts on the channel
    axis."""
    real, imag = stft_real_imag(x, cfg)
    return torch.stack([real, imag], dim=-3)


def reverse_complex_spectrogram(spec: torch.Tensor, cfg: STFTConfig,
                                length: int | None = None) -> torch.Tensor:
    """[B, 2, T, F] -> [B, N]."""
    return istft(spec[..., 0, :, :], spec[..., 1, :, :], cfg, length=length)


def wav_to_complex_spectrogram(x: torch.Tensor, cfg: STFTConfig
                               ) -> torch.Tensor:
    """[B, C, N] -> [B, 2C, T, F], channel c at rows (2c, 2c+1)."""
    b, c, _ = x.shape
    real, imag = stft_real_imag(x, cfg)        # [B, C, T, F]
    ri = torch.stack([real, imag], dim=2)      # [B, C, 2, T, F]
    return ri.reshape(b, 2 * c, *ri.shape[-2:])


def complex_spectrogram_to_wav(spec: torch.Tensor, cfg: STFTConfig,
                               length: int | None = None) -> torch.Tensor:
    """[B, 2C, T, F] -> [B, C, N]."""
    b, c2, t, f = spec.shape
    ri = spec.reshape(b, c2 // 2, 2, t, f)
    return istft(ri[:, :, 0], ri[:, :, 1], cfg, length=length)


# --------------------------------------------------------------- subband path

def _analysis(x: torch.Tensor, subband: int) -> torch.Tensor:
    """[B, C, N] -> [B, C*S, N/S], channel c's subbands at rows
    [c*S, (c+1)*S)."""
    b, c, n = x.shape
    sub = pqmf.analysis(x.reshape(b * c, n, 1), bands=subband)
    return sub.transpose(-1, -2).reshape(b, c * subband, -1)


def _synthesis(sub: torch.Tensor, subband: int) -> torch.Tensor:
    """[B, C*S, N'] -> [B, C, N'*S], the inverse of ``_analysis``."""
    b, sc, n = sub.shape
    c = sc // subband
    sb = sub.reshape(b * c, subband, n).transpose(-1, -2)
    wav = pqmf.synthesis(sb, bands=subband)  # [B*C, N, 1]
    return wav[..., 0].reshape(b, c, -1)


def wav_to_complex_subband_spectrogram(x: torch.Tensor, cfg: STFTConfig,
                                       subband: int) -> torch.Tensor:
    """[B, C, N] -> [B, 2*S*C, T', F']."""
    return wav_to_complex_spectrogram(_analysis(x, subband),
                                      subband_config(cfg, subband))


def complex_subband_spectrogram_to_wav(spec: torch.Tensor, cfg: STFTConfig,
                                       subband: int,
                                       length: int | None = None
                                       ) -> torch.Tensor:
    """[B, 2*S*C, T', F'] -> [B, C, N]; ``length`` is per subband."""
    sub = complex_spectrogram_to_wav(spec, subband_config(cfg, subband),
                                     length=length)
    return _synthesis(sub, subband)


def wav_to_mag_phase_subband_spectrogram(x: torch.Tensor, cfg: STFTConfig,
                                         subband: int, eps: float = 1e-8):
    """[B, C, N] -> (sps, coss, sins), each [B, S*C, T', F']."""
    return spectrogram_phase(_analysis(x, subband),
                             subband_config(cfg, subband), eps=eps)


def mag_phase_subband_spectrogram_to_wav(sps: torch.Tensor,
                                         coss: torch.Tensor,
                                         sins: torch.Tensor, cfg: STFTConfig,
                                         subband: int,
                                         length: int | None = None
                                         ) -> torch.Tensor:
    """(sps, coss, sins) [B, S*C, T', F'] -> [B, C, N]; ``length`` is per
    subband."""
    sub = istft(sps * coss, sps * sins, subband_config(cfg, subband),
                length=length)
    return _synthesis(sub, subband)
