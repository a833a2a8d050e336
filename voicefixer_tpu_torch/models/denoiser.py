"""Mel-domain denoiser mask net, as ``voicefixer_tpu/models/denoiser.py``:
BatchNorm2d(1) / Linear / ReLU / Dropout around two stacked 2-layer
bidirectional GRUs, ending in a sigmoid mask on the linear mel. Activations
are [B, T, F]; each BatchNorm2d(1) normalizes the whole tensor with scalar
statistics: the running ones in eval, the batch's in training (mode 2 and
the trainer), where dropout is live too, drawn from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import math

import torch

from voicefixer_tpu_torch.config import DenoiserConfig
from voicefixer_tpu_torch.ops import gru as vgru
from voicefixer_tpu_torch.parallel.tp import batch_moments
from voicefixer_tpu_torch.utils.weights import uniform


def _bn_scalar(x: torch.Tensor, p: dict, training: bool) -> torch.Tensor:
    """BatchNorm2d(1) on [B, T, F]: one channel covering everything (in
    training, the rows of every data rank inside
    ``parallel.tp.global_batch_stats``)."""
    if training:
        mean, var = batch_moments(x)
    else:
        mean, var = p["mean"][0], p["var"][0]
    inv = torch.rsqrt(var + 1e-5)
    return (x - mean) * (inv * p["gamma"][0]) + p["beta"][0]


def _dropout(x: torch.Tensor, rate: float, training: bool,
             generator: torch.Generator | None) -> torch.Tensor:
    """Keep each element with probability 1 - rate, scaled by 1 / keep."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def _linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def apply(params: dict, mel: torch.Tensor, cfg: DenoiserConfig,
          training: bool = False,
          generator: torch.Generator | None = None) -> torch.Tensor:
    """mel: [B, T, n_mel] linear mel -> sigmoid mask [B, T, n_mel]. Layer
    names follow the upstream nn.Sequential indices. ``training``: batch
    statistics and dropout after fc4 and after fc11, drawn from
    ``generator`` (on mel's device), by default one seeded 0."""
    if training and generator is None:
        generator = torch.Generator(mel.device).manual_seed(0)
    x = _bn_scalar(mel, params["bn0"], training)
    x = torch.relu(_linear(x, params["fc1"]))
    x = _bn_scalar(x, params["bn3"], training)
    x = _linear(x, params["fc4"])
    x = torch.relu(_dropout(x, cfg.dropout, training, generator))
    for name in ("gru7", "gru8"):
        x = _bn_scalar(x, params[name]["bn"], training)
        x = vgru.gru(x, params[name]["gru"], cfg.gru_layers,
                     bidirectional=True)
    x = torch.relu(_bn_scalar(x, params["bn9"], training))
    x = _linear(x, params["fc11"])
    x = _dropout(x, cfg.dropout, training, generator)
    x = torch.relu(_bn_scalar(x, params["bn13"], training))
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
