"""Analysis-stage training losses, as ``voicefixer_tpu/train/losses.py``:
the runnable part of upstream's generator objective, two L1 terms.

- targ_loss: the denoiser's masked linear mel against the clean mel;
- mel_loss: the restored log10 mel against the log of the clean mel.

Both mels come from ``analysis.wav_to_sp_mel`` (the plain STFT, which
autograd differentiates); the analysis stage runs in training mode.
"""

from __future__ import annotations

import torch

from voicefixer_tpu_torch.config import VoiceFixerConfig
from voicefixer_tpu_torch.models import analysis
from voicefixer_tpu_torch.ops.norm import to_log


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs().mean()


def analysis_loss(params: dict, wav_noisy: torch.Tensor,
                  wav_clean: torch.Tensor, cfg: VoiceFixerConfig,
                  generator: torch.Generator | None = None,
                  targ_weight: float = 1.0, mel_weight: float = 1.0):
    """wav_noisy, wav_clean: [B, N] paired 44.1 kHz waves. Returns
    (total, {"loss", "targ_loss", "mel_loss"}), scalars. ``generator``
    draws the denoiser's dropout (``analysis.apply``)."""
    _, mel_noisy = analysis.wav_to_sp_mel(wav_noisy, cfg)
    _, mel_clean = analysis.wav_to_sp_mel(wav_clean, cfg)
    out = analysis.apply(params, mel_noisy, cfg, training=True,
                         generator=generator)
    targ_loss = l1(out["clean"], mel_clean)
    mel_loss = l1(out["mel"], to_log(mel_clean))
    total = targ_weight * targ_loss + mel_weight * mel_loss
    return total, {"loss": total, "targ_loss": targ_loss,
                   "mel_loss": mel_loss}
