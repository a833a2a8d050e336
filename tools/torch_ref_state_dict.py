#!/usr/bin/env python3
"""Upstream-layout torch checkpoints with random weights, drawn from a seed
with numpy: the two files that ``pipeline.checkpoints`` reads in either
package, at the widths of any config.

- the analysis checkpoint (vf.ckpt): a flat state dict under
  ``generator.denoiser.*`` (upstream restorer/model.py's Sequential
  indices) and ``generator.unet.*`` (model_kqq_bn.py's module names), BN
  layers with their running statistics;
- the vocoder checkpoint (model.ckpt-1490000_trimed.pt): {"generator":
  state_dict} (upstream vocoder generator.py's indices) whose convolutions
  are stored with weight norm, as ``weight_g``/``weight_v`` or as
  ``parametrizations.weight.original0/1``, or plain (``weight``).

The config is read by field names only (``denoiser``, ``unet``,
``vocoder``), so either package's config serves. The converters of both
packages hard-code upstream's structure: 6 encoder levels of 4 blocks, 2
bidirectional GRU layers in each of 2 blocks, 4 vocoder stages of 8 blocks.
The widths are free.

    python3 tools/torch_ref_state_dict.py OUT_DIR [--seed N]

writes OUT_DIR/vf.ckpt and OUT_DIR/model.pt at DEFAULT_CONFIG's widths.
The functions import numpy and torch only; run as a script it also reads
the port's config.
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np

WEIGHT_NORM = ("weight_g", "parametrizations", None)


class _Drawer:
    """Fills a flat state dict in a fixed key order from one generator."""

    def __init__(self, seed, weight_norm=None):
        if weight_norm not in WEIGHT_NORM:
            raise ValueError(f"weight_norm must be one of {WEIGHT_NORM}")
        self.rng = np.random.default_rng(seed)
        self.weight_norm = weight_norm
        self.sd: dict = {}

    def uniform(self, shape, bound):
        return self.rng.uniform(-bound, bound, shape).astype(np.float32)

    def weight(self, prefix, w):
        """``w`` at ``prefix``, as weight norm's (g, v) where asked: v = w,
        g = ||v|| (over every dim but 0) times U(0.9, 1.1)."""
        if self.weight_norm is None:
            self.sd[f"{prefix}.weight"] = w
            return
        norm = np.sqrt(np.sum(w.astype(np.float64) ** 2,
                              axis=tuple(range(1, w.ndim)), keepdims=True))
        g = (norm * self.rng.uniform(0.9, 1.1, norm.shape)).astype(np.float32)
        if self.weight_norm == "weight_g":
            self.sd[f"{prefix}.weight_g"] = g
            self.sd[f"{prefix}.weight_v"] = w
        else:
            self.sd[f"{prefix}.parametrizations.weight.original0"] = g
            self.sd[f"{prefix}.parametrizations.weight.original1"] = w

    def bias(self, prefix, n):
        self.sd[f"{prefix}.bias"] = self.uniform((n,), 0.05)

    def bn(self, prefix, c):
        r = self.rng
        self.sd[f"{prefix}.weight"] = (
            1 + 0.1 * np.abs(r.standard_normal(c))).astype(np.float32)
        self.sd[f"{prefix}.bias"] = (0.1 * r.standard_normal(c)).astype(
            np.float32)
        self.sd[f"{prefix}.running_mean"] = (
            0.1 * r.standard_normal(c)).astype(np.float32)
        self.sd[f"{prefix}.running_var"] = (
            1 + 0.1 * np.abs(r.standard_normal(c))).astype(np.float32)
        self.sd[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)

    def linear(self, prefix, i, o):
        self.sd[f"{prefix}.weight"] = self.uniform((o, i),
                                                   math.sqrt(6 / (i + o)))
        self.bias(prefix, o)

    def gru(self, prefix, i, h, layers):
        bound = 1 / math.sqrt(h)
        for layer in range(layers):
            for sfx in ("", "_reverse"):
                n_in = i if layer == 0 else 2 * h
                self.sd[f"{prefix}.weight_ih_l{layer}{sfx}"] = self.uniform(
                    (3 * h, n_in), bound)
                self.sd[f"{prefix}.weight_hh_l{layer}{sfx}"] = self.uniform(
                    (3 * h, h), bound)
                self.sd[f"{prefix}.bias_ih_l{layer}{sfx}"] = self.uniform(
                    (3 * h,), bound)
                self.sd[f"{prefix}.bias_hh_l{layer}{sfx}"] = self.uniform(
                    (3 * h,), bound)

    def conv2d(self, prefix, ci, co, k, bias=False, transposed=False):
        shape = (ci, co, k, k) if transposed else (co, ci, k, k)
        self.weight(prefix, self.uniform(
            shape, math.sqrt(6 / ((ci + co) * k * k))))
        if bias:
            self.bias(prefix, co)

    def conv1d(self, prefix, ci, co, k, transposed=False):
        shape = (ci, co, k) if transposed else (co, ci, k)
        self.weight(prefix, self.uniform(shape, math.sqrt(1 / (ci * k))))
        self.bias(prefix, co)

    def conv_block(self, prefix, ci, co):
        self.bn(f"{prefix}.bn1", ci)
        self.conv2d(f"{prefix}.conv1", ci, co, 3)
        self.bn(f"{prefix}.bn2", co)
        self.conv2d(f"{prefix}.conv2", co, co, 3)
        if ci != co:
            self.conv2d(f"{prefix}.shortcut", ci, co, 1, bias=True)


def analysis_state_dict(cfg, seed: int = 0) -> dict:
    """The analysis module's flat state dict {key: np.ndarray} at ``cfg``'s
    widths."""
    d = _Drawer([seed, 0])
    dn, p = cfg.denoiser, "generator.denoiser"
    n, u = dn.n_mel, dn.base_width
    d.bn(f"{p}.0", 1)
    d.linear(f"{p}.1", n, u)
    d.bn(f"{p}.3", 1)
    d.linear(f"{p}.4", u, 2 * u)
    for blk in (7, 8):
        d.bn(f"{p}.{blk}.bn", 1)
        d.gru(f"{p}.{blk}.gru", 2 * u, u, dn.gru_layers)
    d.bn(f"{p}.9", 1)
    d.linear(f"{p}.11", 2 * u, 2 * u)
    d.bn(f"{p}.13", 1)
    d.linear(f"{p}.15", 2 * u, n)

    un, p = cfg.unet, "generator.unet"
    enc = list(un.encoder_channels)
    ci = un.in_channels
    for i, co in enumerate(enc, 1):
        for j in range(1, un.blocks_per_stage + 1):
            d.conv_block(f"{p}.encoder_block{i}.conv_block{j}",
                         ci if j == 1 else co, co)
        ci = co
    d.conv_block(f"{p}.conv_block7", un.center_channels, un.center_channels)
    ci = un.center_channels
    for i, co in enumerate(reversed(enc), 1):
        q = f"{p}.decoder_block{i}"
        d.bn(f"{q}.bn1", ci)
        d.conv2d(f"{q}.conv1", ci, co, 3, transposed=True)
        d.conv_block(f"{q}.conv_block2", 2 * co, co)
        for j in range(3, un.blocks_per_stage + 2):
            d.conv_block(f"{q}.conv_block{j}", co, co)
        ci = co
    d.conv_block(f"{p}.after_conv_block1", enc[0], enc[0])
    d.conv2d(f"{p}.after_conv2", enc[0], 1, 1, bias=True)
    return d.sd


def vocoder_state_dict(cfg, seed: int = 0,
                       weight_norm: str | None = "weight_g") -> dict:
    """The vocoder generator's flat state dict at ``cfg.vocoder``'s widths,
    every convolution stored as ``weight_norm`` says."""
    v = cfg.vocoder
    d = _Drawer([seed, 1], weight_norm)
    for i, idx in enumerate((0, 2, 4, 6, 8)):
        d.conv1d(f"condnet.{idx}", v.in_channels if i == 0
                 else v.cond_channels, v.cond_channels, 3)
    d.conv1d("generator.1", v.cond_channels, v.channels, 7)
    for i, s in enumerate(v.upsample_scales):
        ci, co = v.channels // 2 ** i, v.channels // 2 ** (i + 1)
        d.conv1d(f"generator.{3 + 3 * i}.layer", ci, co, 2 * s,
                 transposed=True)
        for b in range(v.resstack_depth[i]):
            for sub in (1, 3):
                d.conv1d(f"generator.{4 + 3 * i}.layers.{b}.{sub}", co, co,
                         v.resstack_kernel[i])
    d.conv1d(f"generator.{4 + 3 * len(v.upsample_scales)}",
             v.channels // 2 ** len(v.upsample_scales), v.out_channels, 7)
    return d.sd


def write_checkpoints(cfg, seed: int, analysis_path: str, vocoder_path: str,
                      weight_norm: str | None = "weight_g"):
    """torch.save both files as upstream stores them."""
    import torch

    def tensors(sd):
        return {k: torch.from_numpy(np.ascontiguousarray(a))
                for k, a in sd.items()}
    torch.save(tensors(analysis_state_dict(cfg, seed)), analysis_path)
    torch.save({"generator": tensors(vocoder_state_dict(cfg, seed,
                                                         weight_norm))},
               vocoder_path)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    from voicefixer_tpu_torch.config import DEFAULT_CONFIG
    os.makedirs(args.out_dir, exist_ok=True)
    write_checkpoints(DEFAULT_CONFIG, args.seed, os.path.join(args.out_dir, "vf.ckpt"),
                      os.path.join(args.out_dir, "model.pt"))


if __name__ == "__main__":
    main()
