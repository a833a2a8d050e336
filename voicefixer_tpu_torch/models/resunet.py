"""6-encoder/6-decoder residual U-Net over log-mel spectrograms, as
``voicefixer_tpu/models/resunet.py``.

Layout [B, T, F, C] at the functions; each ConvBlockRes is
bn -> leaky(0.01) -> 3x3 conv -> bn -> leaky -> 3x3 conv, plus a residual or
a 1x1 shortcut. The 3x3 convs are cuDNN convolutions (they were XLA
convolutions in the JAX package). As there, the fused ConvBlockRes kernel
(``kernels.convblock``) is opt-in, through
``ops.precision.conv_block_kernel``: with it on, every block that
``convblock.eligible`` takes goes to the kernel. BN runs as one multiply-add
on the (scale, shift) leaves that ``fold_bn_eval`` adds at construction.

In training (mode 2 and the trainer) BN takes the batch's statistics, and,
as in the JAX package, the activations stay float32 and no block goes to
the fused kernel (it folds eval BN).

Under a model axis (``parallel.tp.use_mesh``) a block's weights may hold
only this rank's output channels (``parallel.sharding.shard_params``): each
convolution makes its slice and ``tp.channel_sharded`` gathers the rest, so
BN, the residual adds and the pooling see whole activations. The fused
kernel needs every channel, so it does not run there, even under
``conv_block_kernel``: the blocks take the sliced cuDNN path, as the JAX
package's do.
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
from voicefixer_tpu_torch.parallel import tp
from voicefixer_tpu_torch.utils.weights import tree_map, uniform


def _conv_block_res(p: dict, x: torch.Tensor, slope: float,
                    training: bool = False) -> torch.Tensor:
    if (not training and use_conv_block_kernel() and not tp.model_parallel()
            and convblock.eligible(p, x)):
        return convblock.conv_block_res(x, p, slope)
    co = p["bn2"]["gamma"].shape[0]  # replicated: the block's full width
    h = tp.channel_sharded(
        conv2d, leaky_relu(batch_norm(x, p["bn1"], training), slope),
        p["conv1"]["w"], None, co, padding=(1, 1))
    h = tp.channel_sharded(
        conv2d, leaky_relu(batch_norm(h, p["bn2"], training), slope),
        p["conv2"]["w"], None, co, padding=(1, 1))
    if "shortcut" in p:
        return tp.channel_sharded(conv2d, x, p["shortcut"]["w"],
                                  p["shortcut"]["b"], co) + h
    return x + h


def _cast(tree, dtype: torch.dtype):
    """tree's tensors in dtype; the fused kernel's operands ("packed", one
    set a type) as they are."""
    if isinstance(tree, dict):
        return {k: v if k == "packed" else _cast(v, dtype)
                for k, v in tree.items()}
    return tree_map(lambda t: t.to(dtype), tree)


def pack_conv_blocks(params: dict) -> dict:
    """A copy of the tree in which every folded ConvBlockRes of 3x3
    convolutions and at most ``convblock.MAX_CHANNELS`` channels carries
    the fused kernel's operands under "packed": packed once a type, from
    the block as ``apply`` casts it (``convblock.pack_operands``). The
    kernel packs a block without them on every call. Like the folded batch
    norms, they do not follow a later in-place change of the weights."""
    if not isinstance(params, dict):
        return params
    out = {k: pack_conv_blocks(v) for k, v in params.items()
           if k != "packed"}
    w = out.get("conv1", {}).get("w")
    if (w is not None and "conv2" in out and "scale" in out.get("bn1", {})
            and "scale" in out.get("bn2", {})
            and tuple(w.shape[:2]) == (3, 3)
            and max(w.shape[2:]) <= convblock.MAX_CHANNELS):
        out["packed"] = {key: convblock.pack_operands(_cast(out, dt), dt)
                         for dt, key in convblock.DTYPE_KEYS.items()}
    return out


def _encoder_block(p: dict, x: torch.Tensor, slope: float, n_blocks: int,
                   training: bool):
    for i in range(n_blocks):
        x = _conv_block_res(p[f"block{i + 1}"], x, slope, training)
    return avg_pool2d(x), x


def _decoder_block(p: dict, x: torch.Tensor, skip: torch.Tensor,
                   slope: float, n_blocks: int,
                   training: bool) -> torch.Tensor:
    """bn -> relu -> convT(k3, s2), drop the last time row, concat skip,
    then the conv blocks."""
    h = tp.channel_sharded(
        conv_transpose2d, torch.relu(batch_norm(x, p["bn1"], training)),
        p["conv1"]["w"], None, skip.shape[-1], stride=(2, 2))
    h = torch.cat([h[:, :-1], skip], dim=-1)
    for i in range(n_blocks):
        h = _conv_block_res(p[f"block{i + 2}"], h, slope, training)
    return h


def apply(params: dict, x: torch.Tensor, cfg: ResUNetConfig,
          training: bool = False) -> torch.Tensor:
    """x: [B, T, 128, 2] log-mel stack -> [B, T, 128, 1]. Pads T to a
    multiple of 2^levels with zeros, drops the last freq bin, runs the
    U-Net, zero-pads the freq bin back and crops T. Production precision
    runs it in bfloat16, except in training."""
    slope = cfg.leaky_slope
    in_dtype = x.dtype
    adt = activation_dtype()
    if not training and adt != x.dtype:
        params = _cast(params, adt)
        x = x.to(adt)
    origin_t = x.shape[1]
    ratio = cfg.downsample_ratio
    pad_len = math.ceil(origin_t / ratio) * ratio - origin_t
    x = F.pad(x, (0, 0, 0, 0, 0, pad_len))[:, :, :-1]  # [B, T', 127, C]

    skips = []
    h = x
    for i in range(cfg.levels):
        h, pre = _encoder_block(params[f"enc{i + 1}"], h, slope,
                                cfg.blocks_per_stage, training)
        skips.append(pre)
    h = _conv_block_res(params["center"], h, slope, training)
    for i in range(cfg.levels):
        h = _decoder_block(params[f"dec{i + 1}"], h, skips[-1 - i], slope,
                           cfg.blocks_per_stage, training)
    h = _conv_block_res(params["after1"], h, slope, training)
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
