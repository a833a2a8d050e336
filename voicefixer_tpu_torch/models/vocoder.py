"""TFGAN-style 441x upsampling vocoder generator, as
``voicefixer_tpu/models/vocoder.py``: condnet (5 x conv k3 + ELU),
reflect-pad-3 pre-conv k7, four stages of (upsample -> depth-8 dilated
ResStack -> LeakyReLU 0.2) with scales (7, 7, 3, 3), then reflect-pad-3
post-conv k7 to one channel and tanh.

Layout [B, T, C]. Every stage runs through the port's kernels, by one
static rule on the stage's width: a stage of at most FUSE_MAX_CHANNELS
output channels is one ``up_res_stack`` (upsample, ResStack and LeakyReLU
fused, ``kernels.resstream``: at those widths the stage is bound by the
bytes it moves, so the upsampled signal stays out of global memory); a
wider one is ``upsample`` then ``res_stack`` (chains and shifted-tap
blocks, ``kernels.resstack``) with the stage's LeakyReLU folded into its
last launch. At full width stages 0-1 (C = 512, 256) take the second form
and stages 2-3 (C = 128, 64) the first. Production precision stores
activations and weights in bfloat16; the post-conv accumulates and returns
float32 either way.
"""

from __future__ import annotations

import math

import torch

from voicefixer_tpu_torch.config import VocoderConfig
from voicefixer_tpu_torch.kernels.resstack import (FUSE_MAX_CHANNELS,
                                                   res_stack, up_res_stack)
from voicefixer_tpu_torch.kernels.upsample import upsample
from voicefixer_tpu_torch.ops.conv import (conv1d, elu, leaky_relu,
                                          reflection_pad1d)
from voicefixer_tpu_torch.ops.precision import activation_dtype
from voicefixer_tpu_torch.utils.weights import ensure_dtype, uniform


def _res_stack(params: list, x: torch.Tensor, kernel: int, slope: float,
               final_slope=None, mask_bounds=None):
    """One stage's ResStack -> (out, activated), the JAX package's contract:
    the kernels fold the stage's LeakyReLU(final_slope) into their last
    launch, so activated says the caller must not apply it again.
    ``mask_bounds`` is a time shard's signal window (``parallel.sp``)."""
    return (res_stack(params, x, kernel, slope, final_slope=final_slope,
                      mask_bounds=mask_bounds), final_slope is not None)


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
    [B, T*441, 1] in [-1, 1], in mel's type. params are cast to the
    activation type on this call unless ``utils.weights.cast_tree`` made
    them in it (the instances' trees, cast once)."""
    adt = activation_dtype()
    if adt != mel.dtype:
        params = ensure_dtype(params, adt)
    x = mel.to(adt)
    for layer in params["condnet"]:
        x = elu(conv1d(x, layer["w"], layer["b"], padding=1))
    x = conv1d(reflection_pad1d(x, 3), params["pre"]["w"], params["pre"]["b"])
    x = leaky_relu(x, cfg.leaky_slope_act)
    for i, stage in enumerate(params["stages"]):
        scale, kernel = cfg.upsample_scales[i], cfg.resstack_kernel[i]
        if stage["up"]["w"].shape[2] <= FUSE_MAX_CHANNELS:
            x = up_res_stack(stage["up"], stage["res"], x, scale, kernel,
                             cfg.leaky_slope_res,
                             final_slope=cfg.leaky_slope_act)
        else:
            x = upsample(x, stage["up"]["w"], stage["up"]["b"], scale)
            x = res_stack(stage["res"], x, kernel, cfg.leaky_slope_res,
                          final_slope=cfg.leaky_slope_act)
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
