"""Fused STFT -> magnitude -> mel (csrc/stft_mel.cu), the port of
``voicefixer_tpu/kernels/stft.py::stft_mel``.

mel = sqrt(max(|STFT(wav)|^2, mag_eps)) @ fb, always in float32. The kernel
runs a shared-memory FFT per pair of frames and multiplies each mel column
over its band of non-zero filterbank rows only; the plain version multiplies
by the dense windowed-DFT matrices.
"""

from __future__ import annotations

import ctypes

import torch

from voicefixer_tpu_torch import kernels
from voicefixer_tpu_torch.kernels import build
from voicefixer_tpu_torch.config import STFTConfig
from voicefixer_tpu_torch.ops import stft as vstft

MAX_MELS = 128  # the mel width one block holds (csrc/stft_mel.cu MAX_MELS)
MIN_FFT, MAX_FFT = 64, 4096


def stft_mel_reference(wav: torch.Tensor, fb: torch.Tensor,
                       cfg: STFTConfig) -> torch.Tensor:
    """Plain version: frames @ DFT matrices, magnitude, @ fb."""
    return vstft.spectrogram(wav, cfg, eps=cfg.mag_eps) @ fb


def stft_mel(wav: torch.Tensor, fb: torch.Tensor,
             cfg: STFTConfig) -> torch.Tensor:
    """wav [B, N] float32, fb [n_freqs, n_mels] float32 -> mel [B, T, n_mels]
    with T = N // hop + 1 (centre padding). On the card: an FFT kernel for a
    power-of-two n_fft in [64, 4096], hop and win_length at most n_fft, at
    most 128 mel columns; anything else raises ValueError."""
    if kernels.on_cpu(wav, fb):
        return stft_mel_reference(wav, fb, cfg)
    if wav.dtype != torch.float32 or fb.dtype != torch.float32:
        raise TypeError("stft_mel takes float32 wav and fb")
    n_fft, hop = cfg.n_fft, cfg.hop_length
    if not (MIN_FFT <= n_fft <= MAX_FFT and n_fft & (n_fft - 1) == 0
            and 1 <= hop <= n_fft and 1 <= cfg.win_length <= n_fft
            and fb.ndim == 2 and fb.shape[0] == n_fft // 2 + 1
            and 1 <= fb.shape[1] <= MAX_MELS):
        raise ValueError(f"stft_mel: unsupported n_fft={n_fft}, hop={hop}, "
                         f"win_length={cfg.win_length}, fb {tuple(fb.shape)}")
    bsz, n = wav.shape
    n_mels = fb.shape[1]
    wav_p = vstft.center_pad(wav, cfg).contiguous()
    fb = fb.contiguous()
    n_frames = vstft.num_frames(n, cfg)
    if n_frames < 1:
        raise ValueError(f"stft_mel: {n} samples give no frame")
    win, tw = vstft.fft_tables(n_fft, cfg.win_length, wav.device)
    out = torch.empty((bsz, n_frames, n_mels), dtype=torch.float32,
                      device=wav.device)
    # first and last non-zero row of each mel column, found by a pre-pass
    bands = torch.empty((2, n_mels), dtype=torch.int32, device=wav.device)
    lib = _lib()
    rc = lib.vf_stft_mel(
        wav_p.data_ptr(), wav_p.shape[1], bsz, n_frames, n_fft, hop,
        win.data_ptr(), tw.data_ptr(), fb.data_ptr(), n_mels, cfg.mag_eps,
        bands.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(wav.device).cuda_stream)
    build.check(lib, rc, "stft_mel")
    kernels.launches["stft_mel"] += 1
    return out


def _lib():
    lib = build.load("stft_mel")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vf_stft_mel.argtypes = [p, i, i, i, i, i, p, p, p, i,
                                ctypes.c_float, p, p, p]
    lib.vf_stft_mel.restype = i
    return lib
