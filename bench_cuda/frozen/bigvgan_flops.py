"""Analytic FLOPs of BigVGAN-v2's generator: a frozen copy of
``voicefixer_tpu_torch/utils/flops.py``'s ``bigvgan_flops`` as the
``bigvgan`` family first read it, read by the ``mfu`` metric through the
family's ``flops_per_segment``. ``cfg`` is any object with the
configuration's attribute names (``families/bigvgan.namespace``), so the
yardstick imports nothing of the program;
``bench_cuda/tests/test_bench_bigvgan.py`` holds it equal to its origin."""

from __future__ import annotations

ORIGIN = "voicefixer_tpu_torch/utils/flops.py"
FROZEN = (
    'bigvgan_flops',
)


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
