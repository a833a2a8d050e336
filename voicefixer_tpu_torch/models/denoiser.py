"""Mel-domain denoiser mask net, eval mode, as
``voicefixer_tpu/models/denoiser.py``: BatchNorm2d(1) / Linear / ReLU around
two stacked 2-layer bidirectional GRUs, ending in a sigmoid mask on the
linear mel. Activations are [B, T, F]; each BatchNorm2d(1) normalizes the
whole tensor with scalar running statistics. Dropout is off in eval mode.
"""

from __future__ import annotations

import math

import torch

from voicefixer_tpu_torch.config import DenoiserConfig
from voicefixer_tpu_torch.ops import gru as vgru
from voicefixer_tpu_torch.utils.weights import uniform


def _bn_scalar(x: torch.Tensor, p: dict) -> torch.Tensor:
    """BatchNorm2d(1) in eval mode on [B, T, F]."""
    inv = torch.rsqrt(p["var"][0] + 1e-5)
    return (x - p["mean"][0]) * (inv * p["gamma"][0]) + p["beta"][0]


def _linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def apply(params: dict, mel: torch.Tensor,
          cfg: DenoiserConfig) -> torch.Tensor:
    """mel: [B, T, n_mel] linear mel -> sigmoid mask [B, T, n_mel]. Layer
    names follow the upstream nn.Sequential indices."""
    x = _bn_scalar(mel, params["bn0"])
    x = torch.relu(_linear(x, params["fc1"]))
    x = _bn_scalar(x, params["bn3"])
    x = torch.relu(_linear(x, params["fc4"]))
    for name in ("gru7", "gru8"):
        x = _bn_scalar(x, params[name]["bn"])
        x = vgru.gru(x, params[name]["gru"], cfg.gru_layers,
                     bidirectional=True)
    x = torch.relu(_bn_scalar(x, params["bn9"]))
    x = _linear(x, params["fc11"])
    x = torch.relu(_bn_scalar(x, params["bn13"]))
    return torch.sigmoid(_linear(x, params["fc15"]))


def init(cfg: DenoiserConfig, generator: torch.Generator,
         device="cpu") -> dict:
    """Same tree, shapes and distributions as the JAX ``denoiser.init``."""
    n, u = cfg.n_mel, cfg.base_width

    def bn():
        return {"gamma": torch.ones(1, device=device),
                "beta": torch.zeros(1, device=device),
                "mean": torch.zeros(1, device=device),
                "var": torch.ones(1, device=device)}

    def fc(i, o):
        return {"w": uniform((i, o), math.sqrt(6.0 / (i + o)), generator,
                             device),
                "b": torch.zeros(o, device=device)}

    return {
        "bn0": bn(),
        "fc1": fc(n, u),
        "bn3": bn(),
        "fc4": fc(u, 2 * u),
        "gru7": {"bn": bn(),
                 "gru": vgru.init_gru_params(generator, 2 * u, u,
                                             cfg.gru_layers, device)},
        "gru8": {"bn": bn(),
                 "gru": vgru.init_gru_params(generator, 2 * u, u,
                                             cfg.gru_layers, device)},
        "bn9": bn(),
        "fc11": fc(2 * u, 2 * u),
        "bn13": bn(),
        "fc15": fc(2 * u, n),
    }
