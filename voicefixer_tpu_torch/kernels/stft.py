"""Fused STFT -> magnitude -> mel (csrc/stft_mel.cu), the port of
``voicefixer_tpu/kernels/stft.py::stft_mel``.

mel = sqrt(max(|STFT(wav)|^2, mag_eps)) @ fb, always in float32.
"""

from __future__ import annotations

import ctypes

import torch

from voicefixer_tpu_torch import kernels
from voicefixer_tpu_torch.kernels import build
from voicefixer_tpu_torch.config import STFTConfig
from voicefixer_tpu_torch.ops import stft as vstft

MAX_MELS = 128  # the mel width one block holds (csrc/stft_mel.cu MELS)


def stft_mel_reference(wav: torch.Tensor, fb: torch.Tensor,
                       cfg: STFTConfig) -> torch.Tensor:
    """Plain version: frames @ DFT matrices, magnitude, @ fb."""
    return vstft.spectrogram(wav, cfg, eps=cfg.mag_eps) @ fb


def stft_mel(wav: torch.Tensor, fb: torch.Tensor,
             cfg: STFTConfig) -> torch.Tensor:
    """wav [B, N] float32, fb [n_freqs, n_mels] float32 -> mel [B, T, n_mels]
    with T = N // hop + 1 (centre padding)."""
    if kernels.on_cpu(wav, fb):
        return stft_mel_reference(wav, fb, cfg)
    if wav.dtype != torch.float32 or fb.dtype != torch.float32:
        raise TypeError("stft_mel takes float32 wav and fb")
    n_freqs, n_mels = fb.shape
    if n_freqs != cfg.n_fft // 2 + 1 or n_mels > MAX_MELS \
            or cfg.n_fft % 32 != 0:
        raise ValueError(f"stft_mel: unsupported n_fft={cfg.n_fft}, "
                         f"fb {tuple(fb.shape)}")
    bsz, n = wav.shape
    wav_p = vstft.center_pad(wav, cfg).contiguous()
    fb = fb.contiguous()
    n_frames = vstft.num_frames(n, cfg)
    w_re, w_im = vstft.dft_matrices(cfg.n_fft, cfg.win_length, wav.device)
    out = torch.empty((bsz, n_frames, n_mels), dtype=torch.float32,
                      device=wav.device)
    lib = _lib()
    rc = lib.vf_stft_mel(
        wav_p.data_ptr(), wav_p.shape[1], bsz, n_frames, cfg.n_fft,
        cfg.hop_length, w_re.data_ptr(), w_im.data_ptr(), n_freqs,
        fb.data_ptr(), n_mels, cfg.mag_eps, out.data_ptr(),
        torch.cuda.current_stream(wav.device).cuda_stream)
    build.check(lib, rc, "stft_mel")
    kernels.launches["stft_mel"] += 1
    return out


def _lib():
    lib = build.load("stft_mel")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vf_stft_mel.argtypes = [p, i, i, i, i, i, p, p, i, p, i,
                                ctypes.c_float, p, p]
    lib.vf_stft_mel.restype = i
    return lib
