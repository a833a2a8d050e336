"""6-encoder/6-decoder residual U-Net over log-mel spectrograms, eval mode,
as ``voicefixer_tpu/models/resunet.py``.

Layout [B, T, F, C] at the functions; each ConvBlockRes is
bn -> leaky(0.01) -> 3x3 conv -> bn -> leaky -> 3x3 conv, plus a residual or
a 1x1 shortcut. The 3x3 convs are cuDNN convolutions (they were XLA
convolutions in the JAX package). As there, the fused ConvBlockRes kernel
(``kernels.convblock``) is opt-in, through
``ops.precision.conv_block_kernel``: with it on, every block that
``convblock.eligible`` takes goes to the kernel. BN runs as one multiply-add
on the (scale, shift) leaves that ``fold_bn_eval`` adds at construction.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from voicefixer_tpu_torch.config import ResUNetConfig
from voicefixer_tpu_torch.kernels import convblock
from voicefixer_tpu_torch.ops.conv import (avg_pool2d, batch_norm, conv2d,
                                          conv_transpose2d, leaky_relu)
from voicefixer_tpu_torch.ops.precision import (activation_dtype,
                                               use_conv_block_kernel)
from voicefixer_tpu_torch.utils.weights import tree_map, uniform


def _conv_block_res(p: dict, x: torch.Tensor, slope: float) -> torch.Tensor:
    if use_conv_block_kernel() and convblock.eligible(p, x):
        return convblock.conv_block_res(x, p, slope)
    h = conv2d(leaky_relu(batch_norm(x, p["bn1"]), slope), p["conv1"]["w"],
               padding=(1, 1))
    h = conv2d(leaky_relu(batch_norm(h, p["bn2"]), slope), p["conv2"]["w"],
               padding=(1, 1))
    if "shortcut" in p:
        return conv2d(x, p["shortcut"]["w"], p["shortcut"]["b"]) + h
    return x + h


def _encoder_block(p: dict, x: torch.Tensor, slope: float, n_blocks: int):
    for i in range(n_blocks):
        x = _conv_block_res(p[f"block{i + 1}"], x, slope)
    return avg_pool2d(x), x


def _decoder_block(p: dict, x: torch.Tensor, skip: torch.Tensor,
                   slope: float, n_blocks: int) -> torch.Tensor:
    """bn -> relu -> convT(k3, s2), drop the last time row, concat skip,
    then the conv blocks."""
    h = conv_transpose2d(torch.relu(batch_norm(x, p["bn1"])), p["conv1"]["w"],
                         stride=(2, 2))
    h = torch.cat([h[:, :-1], skip], dim=-1)
    for i in range(n_blocks):
        h = _conv_block_res(p[f"block{i + 2}"], h, slope)
    return h


def apply(params: dict, x: torch.Tensor, cfg: ResUNetConfig) -> torch.Tensor:
    """x: [B, T, 128, 2] log-mel stack -> [B, T, 128, 1]. Pads T to a
    multiple of 2^levels with zeros, drops the last freq bin, runs the
    U-Net, zero-pads the freq bin back and crops T. Production precision
    runs it in bfloat16."""
    slope = cfg.leaky_slope
    in_dtype = x.dtype
    adt = activation_dtype()
    if adt != x.dtype:
        params = tree_map(lambda t: t.to(adt), params)
        x = x.to(adt)
    origin_t = x.shape[1]
    ratio = cfg.downsample_ratio
    pad_len = math.ceil(origin_t / ratio) * ratio - origin_t
    x = F.pad(x, (0, 0, 0, 0, 0, pad_len))[:, :, :-1]  # [B, T', 127, C]

    skips = []
    h = x
    for i in range(cfg.levels):
        h, pre = _encoder_block(params[f"enc{i + 1}"], h, slope,
                                cfg.blocks_per_stage)
        skips.append(pre)
    h = _conv_block_res(params["center"], h, slope)
    for i in range(cfg.levels):
        h = _decoder_block(params[f"dec{i + 1}"], h, skips[-1 - i], slope,
                           cfg.blocks_per_stage)
    h = _conv_block_res(params["after1"], h, slope)
    h = conv2d(h, params["after2"]["w"], params["after2"]["b"])
    h = F.pad(h, (0, 0, 0, 1))  # restore the freq bin
    return h[:, :origin_t].to(in_dtype)


def _channel_plan(cfg: ResUNetConfig):
    enc = [(cfg.in_channels, cfg.encoder_channels[0])]
    for i in range(1, cfg.levels):
        enc.append((cfg.encoder_channels[i - 1], cfg.encoder_channels[i]))
    dec, prev = [], cfg.center_channels
    for out in reversed(cfg.encoder_channels):
        dec.append((prev, out))
        prev = out
    return enc, dec


def init(cfg: ResUNetConfig, generator: torch.Generator,
         device="cpu") -> dict:
    """Same tree, shapes and distributions as the JAX ``resunet.init``."""
    def bn(c):
        return {"gamma": torch.ones(c, device=device),
                "beta": torch.zeros(c, device=device),
                "mean": torch.zeros(c, device=device),
                "var": torch.ones(c, device=device)}

    def conv_w(ci, co, k=3):
        bound = math.sqrt(6.0 / ((ci + co) * k * k))
        return {"w": uniform((k, k, ci, co), bound, generator, device)}

    def conv_block(ci, co):
        p = {"bn1": bn(ci), "conv1": conv_w(ci, co), "bn2": bn(co),
             "conv2": conv_w(co, co)}
        if ci != co:
            p["shortcut"] = conv_w(ci, co, 1)
            p["shortcut"]["b"] = torch.zeros(co, device=device)
        return p

    enc_plan, dec_plan = _channel_plan(cfg)
    nb = cfg.blocks_per_stage
    params = {}
    for i, (ci, co) in enumerate(enc_plan):
        blocks = {"block1": conv_block(ci, co)}
        for j in range(2, nb + 1):
            blocks[f"block{j}"] = conv_block(co, co)
        params[f"enc{i + 1}"] = blocks
    params["center"] = conv_block(cfg.center_channels, cfg.center_channels)
    for i, (ci, co) in enumerate(dec_plan):
        stage = {"bn1": bn(ci), "conv1": conv_w(ci, co),
                 "block2": conv_block(2 * co, co)}
        for j in range(3, nb + 2):
            stage[f"block{j}"] = conv_block(co, co)
        params[f"dec{i + 1}"] = stage
    c0 = cfg.encoder_channels[0]
    params["after1"] = conv_block(c0, c0)
    params["after2"] = conv_w(c0, 1, 1)
    params["after2"]["b"] = torch.zeros(1, device=device)
    return params
