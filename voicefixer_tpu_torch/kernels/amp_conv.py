"""K11: BigVGAN's AMP convolution in bfloat16 (csrc/amp_conv.cu), both
convs of every AMPBlock1 step of ``models/bigvgan.py``:

y[t] = b + sum_j x[t + (j - (k-1)/2) d] @ w[j]  (+ residual[t])

on a channel-last signal x [B, T, C], w [k, C, C] (tap, in, out), zero
padding d (k-1)/2 a side; float32 accumulation, one rounding to x's type.
The residual is the block's x, added in the same sum, so the launch of
``convs2`` writes the block's new x. It replaces no TPU kernel: upstream's
AMP convs are plain ``Conv1d`` and the JAX package has no BigVGAN.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from voicefixer_tpu_torch import kernels
from voicefixer_tpu_torch.kernels import build

MAX_HALO = 64  # d (k-1)/2 the kernel's slab takes; BigVGAN's largest is 25
# (columns a chunk, 64-row tiles a warpgroup): a time tile is 128 * the
# second rows
TILES = ((256, 1), (128, 1), (64, 2), (64, 1))
# a ring stage's fixed cost (barriers, the slab's A loads), in units of
# one column of one 64-row tile's product
STAGE_COST = 64


def tile(t: int, c: int, batch: int, sms: int) -> tuple[int, int]:
    """The kernel's tile for [batch, t, c] on a card of ``sms`` SMs:
    among the chunk widths that divide c rounded up to 64, the one whose
    jobs (time tile, column chunk, batch row) finish first, a job taking
    time in proportion to its columns times its tiles plus STAGE_COST, in
    waves of ``sms`` jobs; ties to the larger tile."""
    cp = -(-c // 64) * 64
    best = None
    for n, mt in TILES:
        if cp % n:
            continue
        jobs = batch * -(-t // (128 * mt)) * (cp // n)
        key = (-(-jobs // sms) * (n * mt + STAGE_COST), -n * mt, -n)
        if best is None or key < best[0]:
            best = (key, (n, mt))
    return best[1]


def amp_conv_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       dilation: int = 1,
                       residual: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: the taps' products summed in float32 with the bias
    and the residual, rounded once to x's type."""
    k, t = w.shape[0], x.shape[1]
    pad = dilation * (k - 1) // 2
    xf = F.pad(x.float(), (0, 0, pad, pad))
    y = b.float() + sum(xf[:, j * dilation:j * dilation + t] @ w[j].float()
                        for j in range(k))
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype)


def amp_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             dilation: int = 1,
             residual: torch.Tensor | None = None) -> torch.Tensor:
    """x: [B, T, C]; w: [k, C, C], k odd; b: [C]; residual: [B, T, C] or
    None. Returns [B, T, C] in x's type. On the card: bfloat16 throughout,
    C a multiple of 8, d (k-1)/2 at most MAX_HALO."""
    extra = () if residual is None else (residual,)
    if kernels.on_cpu(x, w, b, *extra):
        return amp_conv_reference(x, w, b, dilation, residual)
    kernels.check_no_grad("amp_conv", x, w, b, *extra)
    bsz, t, c = x.shape
    k = w.shape[0]
    if any(v.dtype != torch.bfloat16 for v in (x, w, b, *extra)):
        raise TypeError("amp_conv: the kernel takes bfloat16 alone, got "
                        f"{[v.dtype for v in (x, w, b, *extra)]}")
    if (c % 8 or w.shape != (k, c, c) or k % 2 == 0 or b.shape != (c,)
            or dilation < 1 or dilation * (k - 1) // 2 > MAX_HALO
            or (residual is not None and residual.shape != x.shape)):
        r = None if residual is None else tuple(residual.shape)
        raise ValueError(f"amp_conv: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)}, dilation "
                         f"{dilation}, residual {r}")
    x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
    if residual is not None:
        residual = residual.contiguous()
    lib = _lib()
    y = torch.empty_like(x)
    n_cols, m_tiles = tile(t, c, bsz, _sms(x.device))
    rc = lib.vf_amp_conv(
        x.data_ptr(), w.data_ptr(), b.data_ptr(),
        None if residual is None else residual.data_ptr(), y.data_ptr(),
        bsz, t, c, k, dilation, n_cols, m_tiles,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, rc, "amp_conv")
    kernels.launches["amp_conv"] += 1
    return y


@functools.cache
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _lib():
    lib = build.load("amp_conv")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vf_amp_conv.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.vf_amp_conv.restype = i
    return lib
