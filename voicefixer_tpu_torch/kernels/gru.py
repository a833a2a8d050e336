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

``gru_bidir_cat`` is differentiable (``GruBidir``; the JAX package's kernel
has none, its trainer differentiates the plain ``lax.scan``). On the card
the backward's reverse-time recurrence is a kernel of its own
(``vf_gru_bidir_backward``, the same clusters pushing dhp), between two
float32 matrix products; ``gru_bidir_backward`` is its plain version, in
PyTorch ops. ``gru_seq`` has no backward and raises under grad.
"""

from __future__ import annotations

import ctypes

import torch

from voicefixer_tpu_torch import kernels
from voicefixer_tpu_torch.kernels import build
from voicefixer_tpu_torch.ops.precision import tf32_off

MAX_HIDDEN = 256  # csrc/gru_bidir.cu holds H/8 K-values per lane and column


def _rounded(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """v rounded to dtype, in v's type; its gradient passes the rounding
    unchanged (as autodiff of a bfloat16 product does in the JAX package).
    The difference is exact, so the value is the rounded one."""
    if dtype == v.dtype:
        return v
    return v + (v.to(dtype).to(v.dtype) - v).detach()


def _step(x: torch.Tensor, h: torch.Tensor, w_t: torch.Tensor,
          b: torch.Tensor, matmul_dtype: torch.dtype) -> torch.Tensor:
    hidden = h.shape[-1]
    hp = _rounded(h, matmul_dtype) @ w_t + b
    r = torch.sigmoid(x[:, :hidden] + hp[:, :hidden])
    z = torch.sigmoid(x[:, hidden:2 * hidden] + hp[:, hidden:2 * hidden])
    n = torch.tanh(x[:, 2 * hidden:] + r * hp[:, 2 * hidden:])
    return (1.0 - z) * n + z * h


def gru_bidir_reference(xf: torch.Tensor, xb: torch.Tensor,
                        w_f: torch.Tensor, w_b: torch.Tensor,
                        b_f: torch.Tensor, b_b: torch.Tensor,
                        matmul_dtype: torch.dtype = torch.float32):
    """Plain version: a Python loop over the T steps of both directions, in
    the projections' type (float64 too, for ``gradcheck``)."""
    bsz, t_total, g = xf.shape
    hidden = g // 3
    wf = _rounded(w_f.to(xf.dtype), matmul_dtype)
    wb = _rounded(w_b.to(xf.dtype), matmul_dtype)
    hf = xf.new_zeros((bsz, hidden))
    hb = xf.new_zeros((bsz, hidden))
    outf, outb = [], []
    for i in range(t_total):
        j = t_total - 1 - i
        hf = _step(xf[:, i], hf, wf, b_f, matmul_dtype)
        hb = _step(xb[:, j], hb, wb, b_b, matmul_dtype)
        outf.append(hf)
        outb.append(hb)
    return torch.stack(outf, dim=1), torch.stack(outb[::-1], dim=1)


def gru_bidir(xf: torch.Tensor, xb: torch.Tensor, w_f: torch.Tensor,
              w_b: torch.Tensor, b_f: torch.Tensor, b_b: torch.Tensor,
              matmul_dtype: torch.dtype = torch.float32):
    """xf, xb: [B, T, 3H] float32 input projections of the two directions;
    w_f, w_b: [H, 3H] (W_hh^T); b_f, b_b: [3H]. Returns (fwd, bwd), each
    [B, T, H] float32; bwd runs from t = T-1 down to 0. Both are views of
    the one [B, T, 2H] tensor of ``gru_bidir_cat``."""
    out = gru_bidir_cat(xf, xb, w_f, w_b, b_f, b_b, matmul_dtype)
    hidden = out.shape[-1] // 2
    return out[..., :hidden], out[..., hidden:]


def gru_bidir_cat(xf: torch.Tensor, xb: torch.Tensor, w_f: torch.Tensor,
                  w_b: torch.Tensor, b_f: torch.Tensor, b_b: torch.Tensor,
                  matmul_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``gru_bidir`` with both directions in one [B, T, 2H] tensor, fwd in
    the first H columns: what a bidirectional layer hands the next. The
    kernel writes it in place; the plain version concatenates. Where grad
    mode is on and an input requires grad, the call goes through
    ``GruBidir``, whose forward is the same kernel (or, on the CPU, the same
    plain version) and whose backward launches ``vf_gru_bidir_backward``
    (on the CPU, its plain version ``gru_bidir_backward``)."""
    args = (xf, xb, w_f, w_b, b_f, b_b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return GruBidir.apply(*args, matmul_dtype)
    return _forward(*args, matmul_dtype)


def _forward(xf, xb, w_f, w_b, b_f, b_b, matmul_dtype) -> torch.Tensor:
    if kernels.on_cpu(xf, xb, w_f, w_b, b_f, b_b):
        return torch.cat(gru_bidir_reference(xf, xb, w_f, w_b, b_f, b_b,
                                             matmul_dtype), dim=-1)
    return _launch_bidir(xf, xb, w_f, w_b, b_f, b_b, matmul_dtype)


class GruBidir(torch.autograd.Function):
    """K6 with a backward. The forward keeps the inputs and the [B, T, 2H]
    output, whose rows are every h_{t-1} the recurrence saw."""

    @staticmethod
    def forward(ctx, xf, xb, w_f, w_b, b_f, b_b, matmul_dtype):
        out = _forward(xf, xb, w_f, w_b, b_f, b_b, matmul_dtype)
        ctx.save_for_backward(xf, xb, w_f, w_b, b_f, b_b, out)
        ctx.matmul_dtype = matmul_dtype
        return out

    @staticmethod
    def backward(ctx, grad_out):
        args = (grad_out, *ctx.saved_tensors, ctx.matmul_dtype)
        if kernels.on_cpu(*args[:-1]):
            return (*gru_bidir_backward(*args), None)
        return (*_launch_backward(*args), None)


def gru_bidir_backward(grad_out, xf, xb, w_f, w_b, b_f, b_b, out,
                       matmul_dtype=torch.float32):
    """Backpropagation through time of ``gru_bidir_cat``, in PyTorch ops.
    grad_out, out: [B, T, 2H]; the rest as ``gru_bidir``. Returns the
    gradients of (xf, xb, w_f, w_b, b_f, b_b).

    The backward direction is flipped in time, so both directions run one
    forward recurrence each and share every launch: [2, B, T, ...] tensors,
    direction first. From ``out`` come h_{t-1} (zeros at each direction's
    start); the gates are recomputed for all t at once, hp = h_{t-1} W + b
    being one product a direction. The loop over t, from the last step
    down, carries dh (dh_{T-1} = grad_{T-1}):
        dhp_t = dh_t * [c_r, c_z, c_n * r]_t,
        dh_{t-1} = grad_{t-1} + dh_t * z_t + dhp_t W^T,
    with c_n = (1 - z)(1 - n^2), c_r = c_n hp_n r (1 - r) and
    c_z = (h_{t-1} - n) z (1 - z). Then dW = H_prev^T dHP, db = sum dHP
    and dx = dh * [c_r, c_z, c_n] are whole-sequence products. Under a
    bfloat16 matmul_dtype h and W enter the products rounded, as in the
    forward, and the rounding counts as identity."""
    bsz, t_total, g = xf.shape
    hidden = g // 3
    dt = xf.dtype
    flip = lambda v: torch.flip(v, dims=(1,))  # noqa: E731
    x = torch.stack([xf, flip(xb)])                        # [2, B, T, 3H]
    o = torch.stack([out[..., :hidden], flip(out[..., hidden:])])
    grad = torch.stack([grad_out[..., :hidden],
                        flip(grad_out[..., hidden:])]).to(dt)
    w = torch.stack([w_f, w_b]).to(matmul_dtype).to(dt)   # [2, H, 3H]
    b = torch.stack([b_f, b_b]).to(dt)
    h_prev = torch.cat([o.new_zeros((2, bsz, 1, hidden)), o[:, :, :-1]],
                       dim=2).to(dt)                      # [2, B, T, H]
    hq = h_prev.to(matmul_dtype).to(dt)
    hp = (hq.reshape(2, -1, hidden) @ w).reshape(2, bsz, t_total, g) \
        + b[:, None, None]
    xr, xz, xn = x.split(hidden, dim=-1)
    hr, hz, hn = hp.split(hidden, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    c_n = (1 - z) * (1 - n * n)
    c_r = c_n * hn * r * (1 - r)
    c_z = (h_prev - n) * z * (1 - z)
    coef = torch.stack([c_r, c_z, c_n * r], dim=3)         # [2, B, T, 3, H]
    w_t = w.transpose(1, 2)                                # [2, 3H, H]
    # per-step views made once: the loop is host-bound, three launches a
    # step (the next step's grad_t enters as the addend of dh_t * z_t)
    grads, coefs, zs = grad.unbind(2), coef.unbind(2), z.unbind(2)
    dh = grads[-1]
    dhs = [dh]
    for t in range(t_total - 1, 0, -1):
        dhp = (coefs[t] * dh.unsqueeze(2)).view(2, bsz, g)
        dh = torch.baddbmm(torch.addcmul(grads[t - 1], dh, zs[t]), dhp, w_t)
        dhs.append(dh)
    dh = torch.stack(dhs[::-1], dim=2)                     # [2, B, T, H]
    dhp = (dh[:, :, :, None] * coef).reshape(2, bsz, t_total, g)
    dx = torch.cat([dhp[..., :2 * hidden], dh * c_n], dim=-1)
    dw = hq.reshape(2, -1, hidden).transpose(1, 2) @ dhp.reshape(2, -1, g)
    db = dhp.sum(dim=(1, 2))
    return (dx[0], flip(dx[1]), dw[0].to(w_f.dtype), dw[1].to(w_b.dtype),
            db[0].to(b_f.dtype), db[1].to(b_b.dtype))


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
    kernels.check_no_grad("gru_bidir", xf, xb, w_f, w_b, b_f, b_b)
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


def _launch_backward(grad_out, xf, xb, w_f, w_b, b_f, b_b, out,
                     matmul_dtype):
    """``gru_bidir_backward`` on the card: hp = h_{t-1} W + b and, after the
    kernel's recurrence, dW = H_prev^T dHP and db = sum dHP, as float32
    products of h and W rounded to matmul_dtype (the plain version's
    arithmetic, TF32 off); the directions in their own time order, the
    backward one's h_{t-1} being its state at t + 1."""
    bsz, t_total, g = xf.shape
    hidden = g // 3
    if (g % 3 or hidden > MAX_HIDDEN or t_total < 1 or xb.shape != xf.shape
            or w_f.shape != (hidden, g) or w_b.shape != (hidden, g)
            or out.shape != (bsz, t_total, 2 * hidden)
            or grad_out.shape != out.shape):
        raise ValueError(f"gru_bidir_backward: unsupported shapes x "
                         f"{tuple(xf.shape)}, w {tuple(w_f.shape)}, out "
                         f"{tuple(out.shape)}")
    if matmul_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gru_bidir_backward: matmul_dtype {matmul_dtype}")
    if xf.dtype != torch.float32 or xb.dtype != torch.float32 \
            or out.dtype != torch.float32:
        raise TypeError("gru_bidir_backward takes float32 projections and "
                        "states")
    kernels.check_no_grad("gru_bidir_backward", grad_out, xf, xb, w_f, w_b,
                          b_f, b_b, out)
    lib = _lib()
    with tf32_off():
        xf, xb, out = xf.contiguous(), xb.contiguous(), out.contiguous()
        grad = grad_out.float().contiguous()
        w = torch.stack([w_f, w_b]).to(matmul_dtype)       # [2, H, 3H]
        wq = w.float()
        b = torch.stack([b_f, b_b]).float()
        h_prev = out.new_zeros((2, bsz, t_total, hidden))
        h_prev[0, :, 1:] = out[:, :-1, :hidden]
        h_prev[1, :, :-1] = out[:, 1:, hidden:]
        hq = h_prev.to(matmul_dtype).float().view(2, -1, hidden)
        hp = hq @ wq + b[:, None]                          # [2, B*T, 3H]
        dx = torch.empty((2, bsz, t_total, g), dtype=torch.float32,
                         device=xf.device)
        dhp = torch.empty_like(dx)
        rc = lib.vf_gru_bidir_backward(
            xf.data_ptr(), xb.data_ptr(), hp.data_ptr(), w[0].data_ptr(),
            w[1].data_ptr(), out.data_ptr(), grad.data_ptr(),
            dx[0].data_ptr(), dx[1].data_ptr(), dhp.data_ptr(), bsz,
            t_total, hidden, int(matmul_dtype == torch.bfloat16),
            torch.cuda.current_stream(xf.device).cuda_stream)
        build.check(lib, rc, "gru_bidir_backward")
        kernels.launches["gru_bidir_backward"] += 1
        dhp = dhp.view(2, -1, g)
        dw = hq.transpose(1, 2) @ dhp
        db = dhp.sum(dim=1)
    return (dx[0], dx[1], dw[0].to(w_f.dtype), dw[1].to(w_b.dtype),
            db[0].to(b_f.dtype), db[1].to(b_b.dtype))


def gru_seq_reference(x_proj: torch.Tensor, w_hh_t: torch.Tensor,
                      b_hh: torch.Tensor, reverse: bool = False):
    """Plain version of ``gru_seq``: a Python loop over the T steps."""
    bsz, t_total, g = x_proj.shape
    w = w_hh_t.to(x_proj.dtype)
    h = x_proj.new_zeros((bsz, g // 3))
    out = x_proj.new_empty((bsz, t_total, g // 3))
    steps = range(t_total - 1, -1, -1) if reverse else range(t_total)
    for t in steps:
        h = _step(x_proj[:, t], h, w, b_hh, x_proj.dtype)
        out[:, t] = h
    return out


def gru_seq(x_proj: torch.Tensor, w_hh_t: torch.Tensor, b_hh: torch.Tensor,
            reverse: bool = False) -> torch.Tensor:
    """One direction of the recurrence. x_proj: [B, T, 3H] float32
    (x @ W_ih^T + b_ih); w_hh_t: [H, 3H]; b_hh: [3H]. Returns [B, T, H];
    ``reverse`` walks t from T-1 down to 0. The product is true float32."""
    if kernels.on_cpu(x_proj, w_hh_t, b_hh):
        return gru_seq_reference(x_proj, w_hh_t, b_hh, reverse)
    kernels.check_no_grad("gru_seq", x_proj, w_hh_t, b_hh)
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
    lib.vf_gru_bidir_backward.argtypes = [p] * 10 + [i, i, i, i, p]
    lib.vf_gru_bidir_backward.restype = i
    return lib
