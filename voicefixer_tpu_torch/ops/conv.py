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

# conv1d folds a bfloat16 dilated convolution from this dilation and this
# input width up (see _conv1d_folded)
FOLD_MIN_DILATION = 27
FOLD_MIN_CHANNELS = 512


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
    if (x.dtype == torch.bfloat16 and dilation >= FOLD_MIN_DILATION
            and x.shape[-1] >= FOLD_MIN_CHANNELS and stride == 1
            and padding % dilation == 0):
        return _conv1d_folded(x, w, b, padding, dilation)
    y = F.conv2d(_nwc_as_nchw(x), w.permute(2, 1, 0).unsqueeze(2), b,
                 stride=(1, stride), padding=(0, padding),
                 dilation=(1, dilation))
    return _nchw_as_nwc(y)


def _conv1d_folded(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                   padding: int, dilation: int) -> torch.Tensor:
    """A stride-1 dilated conv1d as an undilated conv over the signal folded
    to [W/d, d]: output q*d + r reads input rows q - padding/d + k of column
    r. The same products and sums. conv1d takes it only where it wins on an
    H100 (tools/torch_dilated_conv.py): in bfloat16 at C >= 512 and
    dilation >= 27, where cuDNN runs the dilated form on a direct kernel
    some 300x slower. Everywhere else cuDNN's dilated convolution is as fast
    or faster."""
    bsz, width, cin = x.shape
    k = w.shape[0]
    d = dilation
    rows = -(-width // d)
    out_width = width + 2 * padding - (k - 1) * d
    xf = F.pad(x, (0, 0, 0, rows * d - width)).view(bsz, rows, d, cin)
    y = F.conv2d(xf.permute(0, 3, 1, 2), w.permute(2, 1, 0).unsqueeze(3), b,
                 padding=(padding // d, 0))
    return y.permute(0, 2, 3, 1).reshape(bsz, -1, y.shape[1])[:, :out_width]


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


def batch_norm(x: torch.Tensor, params: dict,
               eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode channel-last batch norm on running statistics. Uses the
    folded (scale, shift) leaves when ``fold_bn_eval`` added them."""
    if "scale" in params:
        return x * params["scale"] + params["shift"]
    inv = torch.rsqrt(params["var"] + eps)
    return (x - params["mean"]) * (inv * params["gamma"]) + params["beta"]


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
