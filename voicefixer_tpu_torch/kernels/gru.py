"""Bidirectional GRU recurrence (csrc/gru_bidir.cu), the port of
``voicefixer_tpu/kernels/gru.py::gru_seq_bidir``.

Torch nn.GRU gate math over hoisted input projections (gate order r, z, n):
    hp = h @ W_hh^T + b_hh
    r = sigmoid(x_r + hp_r), z = sigmoid(x_z + hp_z)
    n = tanh(x_n + r * hp_n), h' = (1 - z) * n + z * h
The state is float32. With matmul_dtype=bfloat16 both h and W_hh^T are
rounded to bfloat16 before the product, which accumulates in float32.
"""

from __future__ import annotations

import ctypes

import torch

from voicefixer_tpu_torch import kernels
from voicefixer_tpu_torch.kernels import build

MAX_HIDDEN = 256  # csrc/gru_bidir.cu holds H/4 K-values per thread


def _step(x: torch.Tensor, h: torch.Tensor, w_t: torch.Tensor,
          b: torch.Tensor, matmul_dtype: torch.dtype) -> torch.Tensor:
    hidden = h.shape[-1]
    hp = h.to(matmul_dtype).float() @ w_t + b
    r = torch.sigmoid(x[:, :hidden] + hp[:, :hidden])
    z = torch.sigmoid(x[:, hidden:2 * hidden] + hp[:, hidden:2 * hidden])
    n = torch.tanh(x[:, 2 * hidden:] + r * hp[:, 2 * hidden:])
    return (1.0 - z) * n + z * h


def gru_bidir_reference(xf: torch.Tensor, xb: torch.Tensor,
                        w_f: torch.Tensor, w_b: torch.Tensor,
                        b_f: torch.Tensor, b_b: torch.Tensor,
                        matmul_dtype: torch.dtype = torch.float32):
    """Plain version: a Python loop over the T steps of both directions."""
    bsz, t_total, g = xf.shape
    hidden = g // 3
    wf = w_f.to(matmul_dtype).float()
    wb = w_b.to(matmul_dtype).float()
    hf = xf.new_zeros((bsz, hidden))
    hb = xf.new_zeros((bsz, hidden))
    outf = xf.new_empty((bsz, t_total, hidden))
    outb = xf.new_empty((bsz, t_total, hidden))
    for i in range(t_total):
        j = t_total - 1 - i
        hf = _step(xf[:, i], hf, wf, b_f, matmul_dtype)
        hb = _step(xb[:, j], hb, wb, b_b, matmul_dtype)
        outf[:, i] = hf
        outb[:, j] = hb
    return outf, outb


def gru_bidir(xf: torch.Tensor, xb: torch.Tensor, w_f: torch.Tensor,
              w_b: torch.Tensor, b_f: torch.Tensor, b_b: torch.Tensor,
              matmul_dtype: torch.dtype = torch.float32):
    """xf, xb: [B, T, 3H] float32 input projections of the two directions;
    w_f, w_b: [H, 3H] (W_hh^T); b_f, b_b: [3H]. Returns (fwd, bwd), each
    [B, T, H] float32; bwd runs from t = T-1 down to 0."""
    if kernels.on_cpu(xf, xb, w_f, w_b, b_f, b_b):
        return gru_bidir_reference(xf, xb, w_f, w_b, b_f, b_b, matmul_dtype)
    bsz, t_total, g = xf.shape
    hidden = g // 3
    if (g % 3 or hidden > MAX_HIDDEN or xb.shape != xf.shape
            or w_f.shape != (hidden, g) or w_b.shape != (hidden, g)):
        raise ValueError(f"gru_bidir: unsupported shapes x {tuple(xf.shape)}, "
                         f"w {tuple(w_f.shape)}")
    if matmul_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gru_bidir: matmul_dtype {matmul_dtype}")
    if xf.dtype != torch.float32 or xb.dtype != torch.float32:
        raise TypeError("gru_bidir takes float32 projections")
    xf, xb = xf.contiguous(), xb.contiguous()
    wf = w_f.to(matmul_dtype).contiguous()
    wb = w_b.to(matmul_dtype).contiguous()
    bf = b_f.float().contiguous()
    bb = b_b.float().contiguous()
    outf = torch.empty((bsz, t_total, hidden), dtype=torch.float32,
                       device=xf.device)
    outb = torch.empty_like(outf)
    lib = _lib()
    rc = lib.vf_gru_bidir(
        xf.data_ptr(), xb.data_ptr(), wf.data_ptr(), wb.data_ptr(),
        bf.data_ptr(), bb.data_ptr(), outf.data_ptr(), outb.data_ptr(),
        bsz, t_total, hidden, int(matmul_dtype == torch.bfloat16),
        torch.cuda.current_stream(xf.device).cuda_stream)
    build.check(lib, rc, "gru_bidir")
    kernels.launches["gru_bidir"] += 1
    return outf, outb


def _lib():
    lib = build.load("gru_bidir")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vf_gru_bidir.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, p]
    lib.vf_gru_bidir.restype = i
    return lib
