"""Frozen configuration dataclasses for the PyTorch port.

An own copy of ``voicefixer_tpu/config.py``: the port imports nothing of the
JAX package. The field values and the two scaled-down configs are the same,
so one config object describes the same model in both packages. Upstream
VoiceFixer keeps these hyperparameters in ``voicefixer/vocoder/config.py``
and in the ``sample_rate == 44100`` branches of
``voicefixer/restorer/model.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class STFTConfig:
    """Analysis-stage STFT settings (upstream restorer/model.py)."""

    n_fft: int = 2048
    hop_length: int = 441
    win_length: int = 2048
    center: bool = True
    pad_mode: str = "reflect"
    window: str = "hann"
    # power floor before the square root (upstream fDomainHelper.py)
    mag_eps: float = 1e-8

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1


@dataclasses.dataclass(frozen=True)
class MelConfig:
    """Mel filterbank settings: htk scale, norm=None for the analysis stage."""

    n_mels: int = 128
    sample_rate: int = 44100
    f_min: float = 0.0
    f_max: float = 22050.0
    n_stft: int = 1025


@dataclasses.dataclass(frozen=True)
class DenoiserConfig:
    """Mel-domain mask net (upstream restorer/model.py)."""

    n_mel: int = 128
    dropout: float = 0.5
    gru_layers: int = 2
    num_gru_blocks: int = 2
    # fc1 -> base_width, fc4 -> 2*base_width, GRU hidden = base_width
    base_width: int = 256


@dataclasses.dataclass(frozen=True)
class ResUNetConfig:
    """6-encoder/6-decoder residual U-Net (upstream model_kqq_bn.py)."""

    in_channels: int = 2
    encoder_channels: Tuple[int, ...] = (32, 64, 128, 256, 384, 384)
    center_channels: int = 384
    blocks_per_stage: int = 4
    bn_momentum: float = 0.01
    bn_eps: float = 1e-5
    leaky_slope: float = 0.01

    @property
    def levels(self) -> int:
        return len(self.encoder_channels)

    @property
    def downsample_ratio(self) -> int:
        return 2 ** self.levels


@dataclasses.dataclass(frozen=True)
class VocoderConfig:
    """TFGAN-style 441x upsampling generator (upstream vocoder/config.py)."""

    in_channels: int = 128
    cond_channels: int = 512
    channels: int = 1024
    upsample_scales: Tuple[int, ...] = (7, 7, 3, 3)
    resstack_depth: Tuple[int, ...] = (8, 8, 8, 8)
    resstack_kernel: Tuple[int, ...] = (3, 3, 3, 3)
    out_channels: int = 1
    leaky_slope_act: float = 0.2  # between stages
    leaky_slope_res: float = 0.01  # inside a ResStack
    min_db: float = -115.0
    max_abs_value: float = 4.0
    min_level_db: float = -100.0
    ref_level_db: float = 20.0
    num_mels: int = 128
    sample_rate: int = 44100
    hop_length: int = 441

    @property
    def total_upsample(self) -> int:
        return int(np.prod(self.upsample_scales))


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end restore pipeline: 30 s segments at 44.1 kHz."""

    sample_rate: int = 44100
    seg_length_seconds: int = 30
    hf_removal_ratio: float = 0.95
    # zero-pad short and tail chunks to seg_length so every batch has one
    # shape; outputs are trimmed back, so lengths are unchanged
    pad_short_to_seg: bool = True

    @property
    def seg_length(self) -> int:
        return self.sample_rate * self.seg_length_seconds


def mel_weight_curve(n_mels: int = 128,
                     a: float = 18.8927416350036,
                     b: float = 0.0269863588184314,
                     percent: float = 1.0) -> np.ndarray:
    """Fitted exponential mel-weight curve that bridges the analysis stage's
    unnormalized mel to the vocoder's librosa-normalized mel."""
    x = np.linspace(1, n_mels, num=n_mels)
    return (a * np.exp(percent * b * x)).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class VoiceFixerConfig:
    """Top-level bundle for the two-stage pipeline at 44.1 kHz."""

    stft: STFTConfig = dataclasses.field(default_factory=STFTConfig)
    mel: MelConfig = dataclasses.field(default_factory=MelConfig)
    denoiser: DenoiserConfig = dataclasses.field(default_factory=DenoiserConfig)
    unet: ResUNetConfig = dataclasses.field(default_factory=ResUNetConfig)
    vocoder: VocoderConfig = dataclasses.field(default_factory=VocoderConfig)
    pipeline: PipelineConfig = dataclasses.field(default_factory=PipelineConfig)


DEFAULT_CONFIG = VoiceFixerConfig()


def small_tp_config() -> VoiceFixerConfig:
    """Small config whose channel widths are wide enough (>= 64) for the
    "model" axis to shard convolutions (``parallel.sharding``'s
    min_channels): the tensor-parallel tests. Not numerically related to
    any trained checkpoint."""
    return VoiceFixerConfig(
        denoiser=DenoiserConfig(base_width=64),
        unet=ResUNetConfig(encoder_channels=(16, 64), blocks_per_stage=1,
                           center_channels=64),
        vocoder=VocoderConfig(cond_channels=64, channels=256),
        pipeline=PipelineConfig(seg_length_seconds=1),
    )


def tiny_test_config() -> VoiceFixerConfig:
    """Scaled-down config (same structure, tiny channels, 1 s segments) for
    tests. Not numerically related to any trained checkpoint."""
    return VoiceFixerConfig(
        denoiser=DenoiserConfig(base_width=64),
        unet=ResUNetConfig(encoder_channels=(4, 8), blocks_per_stage=1,
                           center_channels=8),
        vocoder=VocoderConfig(cond_channels=16, channels=32),
        pipeline=PipelineConfig(seg_length_seconds=1),
    )
