"""BigVGAN-v2's generator (Lee et al., ICLR 2023, arXiv 2206.04658;
NVIDIA/BigVGAN ``bigvgan.py``, ``resblock`` "1") in the port's layout
[B, T, C]: log-mel [B, T, num_mels] -> wave [B, T * hop].

- ``conv_pre``: k7, zero padding 3, num_mels -> C0;
- per stage i: the transposed-conv upsample (kernel 2u, stride u, padding
  u/2, no activation in front: K1 without its x + sin x pre-pass), then the
  mean of three AMPBlock1 (kernels 3, 7, 11), inside a ``vf.amp`` span;
- an AMPBlock1 of kernel k, for each dilation d: xt = A(x), conv k at
  dilation d (padding d (k-1)/2), A, conv k (padding (k-1)/2), x = x + xt;
- A: the anti-aliased SnakeBeta (K10, ``kernels.snake_aa``);
- the end: A, ``conv_post`` (k7, padding 3, no bias) in float32, then a
  clamp to [-1, 1] (no tanh).

Production precision stores activations and weights in bfloat16, as the
vocoder does; there the AMP blocks' convolutions are K11
(``kernels.amp_conv``: 108 launches a pass, each ``convs2`` with the
block's residual). In float32 they go to cuDNN (``ops.conv.conv1d``), as
``conv_pre`` and ``conv_post`` do in both.

The tree, in upstream's order: {"conv_pre": {"w", "b"}, "ups": [{"w",
"b"}] * 6 (transposed-conv weights [2u, Cin, Cout] in torch tap order),
"resblocks": [{"convs1": [{"w", "b"}] * 3, "convs2": [...], "acts":
[{"alpha", "beta"}] * 6}] * 18 (block 3 i + j is stage i's kernel j;
acts[2 m] before convs1[m], acts[2 m + 1] before convs2[m]; alpha and beta
are upstream's log-scale parameters), "act_post": {"alpha", "beta"},
"conv_post": {"w"}}.
"""

from __future__ import annotations

import torch

from voicefixer_tpu_torch.config import BigVGANConfig
from voicefixer_tpu_torch.kernels.amp_conv import amp_conv
from voicefixer_tpu_torch.kernels.snake_aa import snake_aa
from voicefixer_tpu_torch.kernels.upsample import upsample
from voicefixer_tpu_torch.ops.conv import conv1d
from voicefixer_tpu_torch.ops.precision import activation_dtype
from voicefixer_tpu_torch.utils.profiling import annotate
from voicefixer_tpu_torch.utils.weights import ensure_dtype, uniform

INIT_STD = 0.01  # upstream's init_weights: every conv but conv_pre


def activation(p: dict, x: torch.Tensor) -> torch.Tensor:
    return snake_aa(x, p["alpha"], p["beta"])


def amp_block(p: dict, x: torch.Tensor, kernel: int,
              dilations) -> torch.Tensor:
    """One AMPBlock1. In bfloat16 both convs of a step are K11, the second
    with the residual in its sum; in float32 they go to cuDNN and the
    residual is added after."""
    for m, d in enumerate(dilations):
        c1, c2 = p["convs1"][m], p["convs2"][m]
        xt = activation(p["acts"][2 * m], x)
        if x.dtype == torch.bfloat16:
            xt = amp_conv(xt, c1["w"], c1["b"], dilation=d)
            xt = activation(p["acts"][2 * m + 1], xt)
            x = amp_conv(xt, c2["w"], c2["b"], residual=x)
            continue
        xt = conv1d(xt, c1["w"], c1["b"], padding=d * (kernel - 1) // 2,
                    dilation=d)
        xt = activation(p["acts"][2 * m + 1], xt)
        xt = conv1d(xt, c2["w"], c2["b"], padding=(kernel - 1) // 2)
        x = x + xt
    return x


def amp_stage(blocks: list, x: torch.Tensor,
              cfg: BigVGANConfig) -> torch.Tensor:
    """The mean of a stage's AMP blocks, each on the stage's input."""
    out = None
    for p, k, dils in zip(blocks, cfg.resblock_kernel_sizes,
                          cfg.resblock_dilation_sizes):
        y = amp_block(p, x, k, dils)
        out = y if out is None else out + y
    return out / len(blocks)


def apply(params: dict, mel: torch.Tensor,
          cfg: BigVGANConfig) -> torch.Tensor:
    """mel: [B, T, num_mels] log-mel -> wave [B, T * hop] in [-1, 1],
    float32. params are cast to the activation type on this call unless
    ``utils.weights.cast_tree`` made them in it (an instance's tree, cast
    once)."""
    adt = activation_dtype()
    if adt != torch.float32:
        params = ensure_dtype(params, adt)
    pre = params["conv_pre"]
    x = conv1d(mel.to(adt), pre["w"], pre["b"], padding=3)
    n_kernels = len(cfg.resblock_kernel_sizes)
    for i, (up, u) in enumerate(zip(params["ups"], cfg.upsample_rates)):
        x = upsample(x, up["w"], up["b"], u, sin_residual=False)
        with annotate("vf.amp"):
            x = amp_stage(params["resblocks"][i * n_kernels:
                                              (i + 1) * n_kernels], x, cfg)
    x = activation(params["act_post"], x)
    # bfloat16 operands are exact in float32: the last conv accumulates and
    # returns float32, as the vocoder's post-conv does
    y = conv1d(x.float(), params["conv_post"]["w"].float(), padding=3)
    return torch.clamp(y[..., 0], -1.0, 1.0)


def init(cfg: BigVGANConfig, generator: torch.Generator,
         device="cpu") -> dict:
    """Upstream's initialisation, weight norm folded (g = ||v||, so W = v):
    every conv but conv_pre N(0, 0.01); conv_pre and every bias torch's
    default, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with fan_in the weight's
    dim 1 times its taps (Cout k for a transposed conv); log alpha and
    log beta 0 (alpha = beta = 1). Drawn on the CPU from ``generator``."""
    def normal(shape):
        return (INIT_STD * torch.randn(shape, generator=generator)).to(device)

    def default_bias(co, fan_in):
        return uniform((co,), fan_in ** -0.5, generator, device)

    def snake(c):
        return {"alpha": torch.zeros(c, device=device),
                "beta": torch.zeros(c, device=device)}

    ch = cfg.channels
    params = {"conv_pre": {
        "w": uniform((7, cfg.num_mels, ch[0]), (7 * cfg.num_mels) ** -0.5,
                     generator, device),
        "b": default_bias(ch[0], 7 * cfg.num_mels)},
        "ups": [], "resblocks": []}
    for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                   cfg.upsample_kernel_sizes)):
        params["ups"].append({"w": normal((k, ch[i], ch[i + 1])),
                              "b": default_bias(ch[i + 1], ch[i + 1] * k)})
        c = ch[i + 1]
        for kr, dils in zip(cfg.resblock_kernel_sizes,
                            cfg.resblock_dilation_sizes):
            conv = lambda: {"w": normal((kr, c, c)),  # noqa: E731
                            "b": default_bias(c, c * kr)}
            params["resblocks"].append({
                "convs1": [conv() for _ in dils],
                "convs2": [conv() for _ in dils],
                "acts": [snake(c) for _ in range(2 * len(dils))]})
    params["act_post"] = snake(ch[-1])
    params["conv_post"] = {"w": normal((7, ch[-1], 1))}
    return params
