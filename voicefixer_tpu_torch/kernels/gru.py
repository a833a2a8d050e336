"""GRU recurrence (csrc/gru_bidir.cu), the port of
``voicefixer_tpu/kernels/gru.py``: ``gru_bidir`` (``gru_seq_bidir`` there,
both directions of a layer in one launch) and ``gru_seq`` (one direction,
forward or reverse, float32 only as there).

Torch nn.GRU gate math over hoisted input projections (gate order r, z, n):
    hp = h @ W_hh^T + b_hh
    r = sigmoid(x_r + hp_r), z = sigmoid(x_z + hp_z)
    n = tanh(x_n + r * hp_n), h' = (1 - z) * n + z * h
The state is float32. With matmul_dtype=bfloat16 both h and W_hh^T are
rounded to bfloat16 before the product, which accumulates in float32.

On the card a cluster of thread blocks runs each direction of a batch row,
each block owning a slice of the hidden units; each step its warps push
their new values of h into every block's shared memory, completing on that
block's mbarrier (csrc/gru_bidir.cu).
"""

from __future__ import annotations

import ctypes

import torch

from voicefixer_tpu_torch import kernels
from voicefixer_tpu_torch.kernels import build

MAX_HIDDEN = 256  # csrc/gru_bidir.cu holds H/8 K-values per lane and column


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
    [B, T, H] float32; bwd runs from t = T-1 down to 0. On the card both
    are views of the one [B, T, 2H] tensor of ``gru_bidir_cat``."""
    if kernels.on_cpu(xf, xb, w_f, w_b, b_f, b_b):
        return gru_bidir_reference(xf, xb, w_f, w_b, b_f, b_b, matmul_dtype)
    out = _launch_bidir(xf, xb, w_f, w_b, b_f, b_b, matmul_dtype)
    hidden = out.shape[-1] // 2
    return out[..., :hidden], out[..., hidden:]


def gru_bidir_cat(xf: torch.Tensor, xb: torch.Tensor, w_f: torch.Tensor,
                  w_b: torch.Tensor, b_f: torch.Tensor, b_b: torch.Tensor,
                  matmul_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``gru_bidir`` with both directions in one [B, T, 2H] tensor, fwd in
    the first H columns: what a bidirectional layer hands the next. The
    kernel writes it in place; the plain version concatenates."""
    if kernels.on_cpu(xf, xb, w_f, w_b, b_f, b_b):
        return torch.cat(gru_bidir_reference(xf, xb, w_f, w_b, b_f, b_b,
                                             matmul_dtype), dim=-1)
    return _launch_bidir(xf, xb, w_f, w_b, b_f, b_b, matmul_dtype)


def _launch_bidir(xf, xb, w_f, w_b, b_f, b_b, matmul_dtype) -> torch.Tensor:
    bsz, t_total, g = xf.shape
    hidden = g // 3
    if (g % 3 or hidden > MAX_HIDDEN or t_total < 1 or xb.shape != xf.shape
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
    out = torch.empty((bsz, t_total, 2 * hidden), dtype=torch.float32,
                      device=xf.device)
    lib = _lib()
    rc = lib.vf_gru_bidir(
        xf.data_ptr(), xb.data_ptr(), wf.data_ptr(), wb.data_ptr(),
        bf.data_ptr(), bb.data_ptr(), out.data_ptr(), bsz, t_total, hidden,
        int(matmul_dtype == torch.bfloat16),
        torch.cuda.current_stream(xf.device).cuda_stream)
    build.check(lib, rc, "gru_bidir")
    kernels.launches["gru_bidir"] += 1
    return out


def gru_seq_reference(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                      b_hh: torch.Tensor, reverse: bool = False):
    """Plain version of ``gru_seq``: a Python loop over the T steps."""
    bsz, t_total, g = x_proj.shape
    w = w_hh_t.float()
    h = x_proj.new_zeros((bsz, g // 3))
    out = x_proj.new_empty((bsz, t_total, g // 3))
    steps = range(t_total - 1, -1, -1) if reverse else range(t_total)
    for t in steps:
        h = _step(x_proj[:, t], h, w, b_hh, torch.float32)
        out[:, t] = h
    return out


def gru_seq(x_proj: torch.Tensor, w_hh_t: torch.Tensor, b_hh: torch.Tensor,
            reverse: bool = False) -> torch.Tensor:
    """One direction of the recurrence. x_proj: [B, T, 3H] float32
    (x @ W_ih^T + b_ih); w_hh_t: [H, 3H]; b_hh: [3H]. Returns [B, T, H];
    ``reverse`` walks t from T-1 down to 0. The product is true float32."""
    if kernels.on_cpu(x_proj, w_hh_t, b_hh):
        return gru_seq_reference(x_proj, w_hh_t, b_hh, reverse)
    bsz, t_total, g = x_proj.shape
    hidden = g // 3
    if (g % 3 or hidden > MAX_HIDDEN or t_total < 1
            or w_hh_t.shape != (hidden, g) or b_hh.shape != (g,)):
        raise ValueError(f"gru_seq: unsupported shapes x "
                         f"{tuple(x_proj.shape)}, w {tuple(w_hh_t.shape)}, "
                         f"b {tuple(b_hh.shape)} (H <= {MAX_HIDDEN})")
    for v in (x_proj, w_hh_t, b_hh):
        if v.dtype != torch.float32:
            raise TypeError(f"gru_seq is float32 only, got {v.dtype}")
    x_proj, w, b = (v.contiguous() for v in (x_proj, w_hh_t, b_hh))
    out = torch.empty((bsz, t_total, hidden), dtype=torch.float32,
                      device=x_proj.device)
    lib = _lib()
    rc = lib.vf_gru_seq(
        x_proj.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), bsz,
        t_total, hidden, int(bool(reverse)),
        torch.cuda.current_stream(x_proj.device).cuda_stream)
    build.check(lib, rc, "gru_seq")
    kernels.launches["gru_seq"] += 1
    return out


def _lib():
    lib = build.load("gru_bidir")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vf_gru_bidir.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
    lib.vf_gru_bidir.restype = i
    lib.vf_gru_seq.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.vf_gru_seq.restype = i
    return lib
