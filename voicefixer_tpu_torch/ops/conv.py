"""Convolution, pooling and normalization primitives with the JAX package's
channels-last layouts.

Layouts, as in ``voicefixer_tpu/ops/conv.py``: 1D activations are [B, W, C],
2D activations [B, H, W, C]. Weights are [K, Cin, Cout] and
[Kh, Kw, Cin, Cout]; transposed-conv weights keep torch's tap order (not
flipped). Each function hands PyTorch an NCHW view with channels-last
strides, so cuDNN runs its channels-last convolutions and the activations are
never transposed in memory. A 1D convolution is a 2D one with H = 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from voicefixer_tpu_torch.parallel.tp import batch_moments


def _nwc_as_nchw(x: torch.Tensor) -> torch.Tensor:
    """[B, W, C] -> [B, C, 1, W] view."""
    return x.unsqueeze(1).permute(0, 3, 1, 2)


def _nchw_as_nwc(y: torch.Tensor) -> torch.Tensor:
    """[B, C, 1, W] -> [B, W, C] view."""
    return y.permute(0, 2, 3, 1)[:, 0]


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           stride: int = 1, padding: int = 0,
           dilation: int = 1) -> torch.Tensor:
    """x: [B, W, Cin]; w: [K, Cin, Cout]; symmetric zero padding."""
    y = F.conv2d(_nwc_as_nchw(x), w.permute(2, 1, 0).unsqueeze(2), b,
                 stride=(1, stride), padding=(0, padding),
                 dilation=(1, dilation))
    return _nchw_as_nwc(y)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           stride=(1, 1), padding=(0, 0), dilation=(1, 1)) -> torch.Tensor:
    """x: [B, H, W, Cin]; w: [Kh, Kw, Cin, Cout]."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b,
                 stride=tuple(stride), padding=tuple(padding),
                 dilation=tuple(dilation))
    return y.permute(0, 2, 3, 1)


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor | None = None, stride: int = 1,
                     padding: int = 0, output_padding: int = 0
                     ) -> torch.Tensor:
    """torch ConvTranspose1d. x: [B, T, Cin]; w: [K, Cin, Cout] in torch tap
    order. Output length (T-1)*s - 2p + K + op."""
    y = F.conv_transpose2d(_nwc_as_nchw(x), w.permute(1, 2, 0).unsqueeze(2),
                           b, stride=(1, stride), padding=(0, padding),
                           output_padding=(0, output_padding))
    return _nchw_as_nwc(y)


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor | None = None, stride=(1, 1),
                     padding=(0, 0), output_padding=(0, 0)) -> torch.Tensor:
    """torch ConvTranspose2d. x: [B, H, W, Cin]; w: [Kh, Kw, Cin, Cout] in
    torch tap order."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w.permute(2, 3, 0, 1), b,
                           stride=tuple(stride), padding=tuple(padding),
                           output_padding=tuple(output_padding))
    return y.permute(0, 2, 3, 1)


def avg_pool2d(x: torch.Tensor, window=(2, 2)) -> torch.Tensor:
    """torch F.avg_pool2d on [B, H, W, C] (floor mode drops ragged rows)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), tuple(window)).permute(0, 2, 3, 1)


def batch_norm(x: torch.Tensor, params: dict, training: bool = False,
               eps: float = 1e-5) -> torch.Tensor:
    """Channel-last batch norm. In eval, the running statistics, as the
    folded (scale, shift) leaves where ``fold_bn_eval`` added them. In
    training (mode 2 and the trainer) the batch's statistics over every
    non-channel axis, the variance biased, with gamma and beta (never the
    folded leaves); the running statistics are not updated, as in the JAX
    package. Inside ``parallel.tp.global_batch_stats`` the statistics span
    the rows of every data rank."""
    if training:
        mean, var = batch_moments(x, tuple(range(x.ndim - 1)))
    elif "scale" in params:
        return x * params["scale"] + params["shift"]
    else:
        mean, var = params["mean"], params["var"]
    inv = torch.rsqrt(var + eps)
    return (x - mean) * (inv * params["gamma"]) + params["beta"]


def fold_batch_norm(params: dict, eps: float = 1e-5):
    """(scale, shift) with bn(x) == x * scale + shift in eval mode."""
    scale = params["gamma"] / torch.sqrt(params["var"] + eps)
    shift = params["beta"] - params["mean"] * scale
    return scale, shift


def fold_bn_eval(params, eps: float = 1e-5):
    """Copy of a parameter tree in which every BN dict also carries its eval
    (scale, shift). gamma/beta/mean/var stay."""
    if isinstance(params, dict):
        out = {k: fold_bn_eval(v, eps) for k, v in params.items()}
        if all(k in params for k in ("gamma", "beta", "mean", "var")):
            out["scale"], out["shift"] = fold_batch_norm(params, eps)
        return out
    if isinstance(params, (list, tuple)):
        return type(params)(fold_bn_eval(v, eps) for v in params)
    return params


def reflection_pad1d(x: torch.Tensor, pad: int) -> torch.Tensor:
    """nn.ReflectionPad1d on [B, W, C] (pads W)."""
    return F.pad(x.transpose(1, 2), (pad, pad), mode="reflect").transpose(1, 2)


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def elu(x: torch.Tensor) -> torch.Tensor:
    return F.elu(x)
