"""Log-domain transforms and the vocoder's dB/normalize chain, as in
``voicefixer_tpu/ops/norm.py``."""

from __future__ import annotations

import math

import torch

from voicefixer_tpu_torch.config import VocoderConfig

_LOG10 = math.log(10.0)


def to_log(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """log10(clip(x, min=eps))."""
    return torch.log(torch.clamp(x, min=eps)) / _LOG10


def from_log(x: torch.Tensor, max_value: float = 5.0) -> torch.Tensor:
    """10 ** clip(x, max=max_value)."""
    return torch.exp(torch.clamp(x, max=max_value) * _LOG10)


def amp_to_db(x: torch.Tensor, cfg: VocoderConfig) -> torch.Tensor:
    """20*log10(max(min_level, x)), min_level = 10^(min_level_db/20)."""
    min_level = math.exp(cfg.min_level_db / 20.0 * _LOG10)
    return 20.0 * torch.log(torch.clamp(x, min=min_level)) / _LOG10


def db_normalize(s: torch.Tensor, cfg: VocoderConfig) -> torch.Tensor:
    """Symmetric clip-normalize to +-max_abs_value over the min_db range."""
    m = cfg.max_abs_value
    return torch.clamp((2.0 * m) * ((s - cfg.min_db) / (-cfg.min_db)) - m,
                       -m, m)


def vocoder_normalize_mel(mel: torch.Tensor,
                          cfg: VocoderConfig) -> torch.Tensor:
    """db_normalize(amp_to_db(|mel|) - ref_level_db)."""
    return db_normalize(amp_to_db(torch.abs(mel), cfg) - cfg.ref_level_db, cfg)
