"""Analysis stage, eval mode, as ``voicefixer_tpu/models/analysis.py``:
wav -> STFT magnitude -> mel (one kernel) -> denoiser mask -> ResUNet ->
restored log10 mel.
"""

from __future__ import annotations

import torch

from voicefixer_tpu_torch.config import VoiceFixerConfig
from voicefixer_tpu_torch.kernels.stft import stft_mel
from voicefixer_tpu_torch.models import denoiser as dn
from voicefixer_tpu_torch.models import resunet
from voicefixer_tpu_torch.ops import mel as vmel
from voicefixer_tpu_torch.ops.norm import to_log


def mel_fbank(cfg: VoiceFixerConfig, device) -> torch.Tensor:
    """The analysis mel filterbank [n_freqs, n_mels] (htk, norm=None)."""
    m = cfg.mel
    return torch.as_tensor(vmel.melscale_fbanks(
        m.n_stft, m.f_min, m.f_max, m.n_mels, m.sample_rate), device=device)


def wav_to_mel(wav: torch.Tensor, cfg: VoiceFixerConfig) -> torch.Tensor:
    """wav [B, N] -> linear mel [B, T, n_mels], float32, through the fused
    STFT->mel kernel; the [B, T, 1025] spectrogram is never stored."""
    return stft_mel(wav.float(), mel_fbank(cfg, wav.device), cfg.stft)


def apply(params: dict, mel_orig: torch.Tensor,
          cfg: VoiceFixerConfig) -> dict:
    """mel_orig: [B, T, 128] linear mel. Returns {'mel': restored log10 mel,
    'clean': masked linear mel, 'unet_out'}, each [B, T, 128]."""
    mask = dn.apply(params["denoiser"], mel_orig, cfg.denoiser)
    clean = mask * mel_orig
    x = to_log(clean)
    unet_in = torch.stack([to_log(mel_orig), x], dim=-1)  # [B, T, 128, 2]
    unet_out = resunet.apply(params["unet"], unet_in, cfg.unet)[..., 0]
    return {"mel": unet_out + x, "clean": clean, "unet_out": unet_out}


def restore_mel(params: dict, wav: torch.Tensor,
                cfg: VoiceFixerConfig) -> torch.Tensor:
    """wav [B, N] -> restored log10 mel [B, T, 128]."""
    return apply(params, wav_to_mel(wav, cfg), cfg)["mel"]


def init(cfg: VoiceFixerConfig, generator: torch.Generator,
         device="cpu") -> dict:
    return {"denoiser": dn.init(cfg.denoiser, generator, device),
            "unet": resunet.init(cfg.unet, generator, device)}
