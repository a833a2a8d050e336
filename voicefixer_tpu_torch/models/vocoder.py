"""TFGAN-style 441x upsampling vocoder generator, as
``voicefixer_tpu/models/vocoder.py``: condnet (5 x conv k3 + ELU),
reflect-pad-3 pre-conv k7, four stages of (upsample -> depth-8 dilated
ResStack -> LeakyReLU 0.2) with scales (7, 7, 3, 3), then reflect-pad-3
post-conv k7 to one channel and tanh.

Layout [B, T, C]. The upsample of every stage is the kernel
``kernels.upsample.upsample``. The ResStack convolutions are cuDNN
convolutions (dilation 3^i, zero 'same' padding); their TPU kernels are the
next slice of the port. Production precision stores activations and weights
in bfloat16; the post-conv accumulates and returns float32 either way.
"""

from __future__ import annotations

import math

import torch

from voicefixer_tpu_torch.config import VocoderConfig
from voicefixer_tpu_torch.kernels.upsample import upsample
from voicefixer_tpu_torch.ops.conv import (conv1d, elu, leaky_relu,
                                          reflection_pad1d)
from voicefixer_tpu_torch.ops.precision import activation_dtype
from voicefixer_tpu_torch.utils.weights import tree_map, uniform


def _res_stack(params: list, x: torch.Tensor, kernel: int,
               slope: float) -> torch.Tensor:
    """ResStack: blocks x + C2(lrelu(C1(lrelu(x)))), C1 dilated 3^(i%10)."""
    for i, layer in enumerate(params):
        dil = 3 ** (i % 10)
        h = conv1d(leaky_relu(x, slope), layer["c1"]["w"], layer["c1"]["b"],
                   padding=(kernel * dil - dil) // 2, dilation=dil)
        h = conv1d(leaky_relu(h, slope), layer["c2"]["w"], layer["c2"]["b"],
                   padding=(kernel - 1) // 2)
        x = x + h
    return x


def _post_conv(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Reflection pad 3 + conv k7 C -> 1 + tanh, in float32 (the bfloat16
    operands are exact in float32, as in the JAX package's float32
    accumulation)."""
    w, b = params["w"], params["b"]
    pad = (w.shape[0] - 1) // 2
    y = conv1d(reflection_pad1d(x, pad).float(), w.float(), b.float())
    return torch.tanh(y)


def apply(params: dict, mel: torch.Tensor, cfg: VocoderConfig) -> torch.Tensor:
    """mel: [B, T, n_mels] (normalized, +-4, tail-padded) -> waveform
    [B, T*441, 1] in [-1, 1], in mel's type."""
    adt = activation_dtype()
    if adt != mel.dtype:
        params = tree_map(lambda t: t.to(adt), params)
    x = mel.to(adt)
    for layer in params["condnet"]:
        x = elu(conv1d(x, layer["w"], layer["b"], padding=1))
    x = conv1d(reflection_pad1d(x, 3), params["pre"]["w"], params["pre"]["b"])
    x = leaky_relu(x, cfg.leaky_slope_act)
    for i, stage in enumerate(params["stages"]):
        x = upsample(x, stage["up"]["w"], stage["up"]["b"],
                     cfg.upsample_scales[i])
        x = _res_stack(stage["res"], x, cfg.resstack_kernel[i],
                       cfg.leaky_slope_res)
        x = leaky_relu(x, cfg.leaky_slope_act)
    return _post_conv(params["post"], x).to(mel.dtype)


def init(cfg: VocoderConfig, generator: torch.Generator,
         device="cpu") -> dict:
    """Same tree, shapes and distributions as the JAX ``vocoder.init``:
    U(-sqrt(1/(ci*k)), +sqrt(1/(ci*k))) weights, zero biases."""
    def conv(ci, co, k):
        return {"w": uniform((k, ci, co), math.sqrt(1.0 / (ci * k)),
                             generator, device),
                "b": torch.zeros(co, device=device)}

    ch = cfg.channels
    params = {
        "condnet": [conv(cfg.in_channels if i == 0 else cfg.cond_channels,
                         cfg.cond_channels, 3) for i in range(5)],
        "pre": conv(cfg.cond_channels, ch, 7),
        "stages": [],
        "post": conv(ch // 16, cfg.out_channels, 7),
    }
    for i, s in enumerate(cfg.upsample_scales):
        ci, co = ch // (2 ** i), ch // (2 ** (i + 1))
        k = cfg.resstack_kernel[i]
        params["stages"].append({
            "up": conv(ci, co, 2 * s),
            "res": [{"c1": conv(co, co, k), "c2": conv(co, co, k)}
                    for _ in range(cfg.resstack_depth[i])],
        })
    return params
