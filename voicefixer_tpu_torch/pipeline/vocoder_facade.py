"""Synthesis stage: analysis-convention linear mel -> 44.1 kHz waveform, as
``voicefixer_tpu/pipeline/vocoder_facade.py::synthesize`` (upstream
Vocoder.forward)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from voicefixer_tpu_torch.config import VocoderConfig, mel_weight_curve
from voicefixer_tpu_torch.models import vocoder as vocoder_model
from voicefixer_tpu_torch.ops.norm import vocoder_normalize_mel


def pad_tail(mel: torch.Tensor, pad_value: float) -> torch.Tensor:
    """Append T%2 + 4 frames of ``pad_value`` along time ([B, T, C])."""
    t = mel.shape[1]
    return F.pad(mel, (0, 0, 0, t % 2 + 4), value=pad_value)


def synthesize(params: dict, mel: torch.Tensor,
               cfg: VocoderConfig) -> torch.Tensor:
    """mel [B, T, 128], linear, analysis convention -> wav [B, S, 1]. The
    mel-weight curve bridges it to the vocoder's librosa convention."""
    w = torch.as_tensor(mel_weight_curve(cfg.num_mels), dtype=mel.dtype,
                        device=mel.device)
    mel = vocoder_normalize_mel(mel / w, cfg)
    mel = pad_tail(mel, -cfg.max_abs_value)
    return vocoder_model.apply(params, mel, cfg)
