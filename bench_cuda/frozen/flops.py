"""Analytic FLOPs of one mode-0 chunk in the JAX package's formulation
(the STFT as a matrix DFT): a frozen copy of
``voicefixer_tpu_torch/utils/flops.py`` at commit 005ebc2, read by the
``mfu`` metric. ``cfg`` is any object with the configuration's attribute
names (``bench_cuda.model_config.namespace``), so the yardstick imports
nothing of the program."""

from __future__ import annotations

import math

ORIGIN = "voicefixer_tpu_torch/utils/flops.py"
FROZEN = (
    'vocoder_flops',
    'resunet_flops',
    'denoiser_flops',
    'stft_flops',
    'pipeline_flops',
)


def vocoder_flops(cfg, t_mel: int) -> int:
    """The vocoder's forward on t_mel frames (``cfg``: VocoderConfig)."""
    c = cfg.channels
    f = 0
    # condnet: five k3 convolutions (in -> cond, then cond -> cond)
    f += t_mel * 3 * cfg.in_channels * cfg.cond_channels * 2
    f += 4 * t_mel * 3 * cfg.cond_channels * cfg.cond_channels * 2
    # pre conv k7 cond -> C
    f += t_mel * 7 * cfg.cond_channels * c * 2
    t = t_mel
    for i, s in enumerate(cfg.upsample_scales):
        ci, co = c // (2 ** i), c // (2 ** (i + 1))
        t *= s
        # polyphase transposed conv k = 2s: two taps an output sample
        f += t * 2 * ci * co * 2
        # ResStack: depth blocks x 2 convolutions x k taps
        k = cfg.resstack_kernel[i]
        f += cfg.resstack_depth[i] * 2 * k * t * co * co * 2
    # post conv k7 C/16 -> 1
    f += t * 7 * (c // 16) * cfg.out_channels * 2
    return f


def resunet_flops(cfg, t_frames: int, n_freq: int = 128) -> int:
    """The residual U-Net's forward on a [t, n_freq] patch (``cfg``:
    ResUNetConfig), t padded to the downsample ratio."""
    t = math.ceil(t_frames / cfg.downsample_ratio) * cfg.downsample_ratio
    fq = n_freq - 1
    f = 0

    def block(h, w, ci, co):
        conv = h * w * 9 * ci * co * 2 + h * w * 9 * co * co * 2
        sc = h * w * ci * co * 2 if ci != co else 0
        return conv + sc

    enc_in = cfg.in_channels
    h, w = t, fq
    for co in cfg.encoder_channels:
        f += block(h, w, enc_in, co)
        f += (cfg.blocks_per_stage - 1) * block(h, w, co, co)
        enc_in = co
        h, w = h // 2, w // 2
    f += block(h, w, cfg.center_channels, cfg.center_channels)
    prev = cfg.center_channels
    for co in reversed(cfg.encoder_channels):
        # transposed conv k3 s2, then the concat-skip blocks
        h, w = h * 2, w * 2
        f += h * w * 9 * prev * co * 2 // 4  # one tap set an output
        f += block(h, w, 2 * co, co)
        f += (cfg.blocks_per_stage - 1) * block(h, w, co, co)
        prev = co
    c0 = cfg.encoder_channels[0]
    f += block(t, fq, c0, c0) + t * fq * c0 * 1 * 2
    return f


def denoiser_flops(cfg, t_frames: int) -> int:
    """The denoiser's forward on t_frames frames (``cfg``: DenoiserConfig):
    its four dense layers, then per GRU layer and direction the input
    projection and the recurrent product."""
    n, u = cfg.n_mel, cfg.base_width
    f = t_frames * (n * u + u * 2 * u + 2 * u * 2 * u + 2 * u * n) * 2
    for _ in range(cfg.num_gru_blocks):
        for _ in range(cfg.gru_layers):
            in_dim = 2 * u
            f += 2 * t_frames * (in_dim * 3 * u + u * 3 * u) * 2
    return f


def stft_flops(cfg, n_samples: int) -> int:
    """The STFT as a matrix DFT and the mel projection on n_samples
    (``cfg``: VoiceFixerConfig)."""
    t = n_samples // cfg.stft.hop_length + 1
    f = t * cfg.stft.win_length * (cfg.stft.n_fft + 2) * 2
    f += t * (cfg.stft.n_fft // 2 + 1) * cfg.mel.n_mels * 2
    return f


def pipeline_flops(cfg: VoiceFixerConfig, seconds: float = 30.0) -> int:
    """Forward FLOPs of one mode-0 chunk of ``seconds`` of audio."""
    n = int(cfg.pipeline.sample_rate * seconds)
    t_mel = n // cfg.stft.hop_length + 1
    return (stft_flops(cfg, n) + denoiser_flops(cfg.denoiser, t_mel)
            + resunet_flops(cfg.unet, t_mel)
            + vocoder_flops(cfg.vocoder, t_mel))
