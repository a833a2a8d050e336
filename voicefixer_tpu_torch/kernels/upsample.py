"""One vocoder upsample stage (csrc/upsample.cu), the port of
``voicefixer_tpu/kernels/upsample.py::upsample``.

y = ConvTranspose1d(x + sin(x)), kernel 2s, stride s, padding s//2 + s%2,
output padding s%2, so y has exactly T*s samples. sin is taken in float32;
the products take x's type (float32 in parity mode, bfloat16 in production)
and accumulate in float32. On the card it is one GEMM per batch row, rows
q in [0, T], K = 2*Cin, with row q of the result stored at (q*s - p)*Cout of
the flat output: wgmma on TMA-loaded tiles in bfloat16 (Cin and Cout
multiples of 8), a float32 product on the FMA units for any channel counts.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from voicefixer_tpu_torch import kernels
from voicefixer_tpu_torch.kernels import build


def upsample_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       scale: int) -> torch.Tensor:
    """Plain version, polyphase: z[q*s + rho] = a[q] @ W[rho]
    + a[q-1] @ W[rho+s] for q in [0, T], then y = z[p : p + T*s] + b."""
    bsz, t, _ = x.shape
    cout = w.shape[2]
    s = scale
    xf = x.float()
    a = (xf + torch.sin(xf)).to(x.dtype).float()
    wf = w.float()
    a = F.pad(a, (0, 0, 1, 1))  # a[-1] = a[T] = 0
    z = (torch.einsum("btc,rco->btro", a[:, 1:], wf[:s])
         + torch.einsum("btc,rco->btro", a[:, :-1], wf[s:]))
    z = z.reshape(bsz, (t + 1) * s, cout)
    p = s // 2 + s % 2
    return (z[:, p:p + t * s] + b.float()).to(x.dtype)


def upsample(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             scale: int) -> torch.Tensor:
    """x: [B, T, Cin]; w: [2s, Cin, Cout] in torch tap order; b: [Cout].
    Returns [B, T*s, Cout] in x's type."""
    if kernels.on_cpu(x, w, b):
        return upsample_reference(x, w, b, scale)
    kernels.check_no_grad("upsample", x, w, b)
    bsz, t, cin = x.shape
    k, wcin, cout = w.shape
    if k != 2 * scale or wcin != cin or b.shape != (cout,):
        raise ValueError(f"upsample: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)}, scale {scale}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"upsample: dtype {x.dtype}")
    if x.dtype == torch.bfloat16 and (cin % 8 or cout % 8):
        raise ValueError(f"upsample: bfloat16 needs Cin and Cout in "
                         f"multiples of 8, got {cin}, {cout}")
    x = x.contiguous()
    w = w.to(x.dtype).contiguous()
    b = b.to(x.dtype).contiguous()
    a = torch.empty_like(x)  # x + sin(x), the kernel's pre-pass
    y = torch.empty((bsz, t * scale, cout), dtype=x.dtype, device=x.device)
    lib = _lib()
    rc = lib.vf_upsample(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), a.data_ptr(), y.data_ptr(),
        bsz, t, cin, cout, scale, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, rc, "upsample")
    kernels.launches["upsample"] += 1
    return y


def _lib():
    lib = build.load("upsample")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vf_upsample.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.vf_upsample.restype = i
    return lib
