"""Analytic FLOP count of the restore pipeline, as
``voicefixer_tpu/utils/flops.py`` and integer-equal to it: 2 FLOPs a
multiply-add, the convolutions, products and GRU cells only (LeakyReLU,
BN and masks are small beside them).

It counts the work of the JAX package's formulation, whatever runs it
here, so that a share of the card's peak reads the same work on either
side: the STFT is a matrix DFT ([frames, win] x [win, n_fft + 2]) although
the port's ``stft_mel`` kernel runs an FFT, and the vocoder's upsample two
taps an output although ``up_res_stream`` fuses it with its ResStack.
numpy and the standard library only.
"""

from __future__ import annotations

import math

from voicefixer_tpu_torch.config import VoiceFixerConfig


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


def bigvgan_flops(cfg, t_mel) -> float:
    """BigVGAN-v2's generator on t_mel frames (``cfg``: BigVGANConfig, or
    any object with its attribute names; t_mel may be a fraction, as for
    one audio second): conv_pre, the transposed-conv upsamples (kernel /
    rate taps an output sample), the AMP blocks' convolutions (two a
    dilation) and conv_post. The 109 anti-aliased activations (about 58
    FLOP an element, 2 % of the rest) are left out, as the vocoder's
    activations are."""
    c = cfg.upsample_initial_channel
    t = t_mel
    f = t * 7 * cfg.num_mels * c * 2
    for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                   cfg.upsample_kernel_sizes)):
        ci, co = c // 2 ** i, c // 2 ** (i + 1)
        t *= u
        f += t * (k // u) * ci * co * 2
        for kr, dils in zip(cfg.resblock_kernel_sizes,
                            cfg.resblock_dilation_sizes):
            f += len(dils) * 2 * kr * t * co * co * 2
    f += t * 7 * co * 2  # conv_post, co -> 1
    return f
