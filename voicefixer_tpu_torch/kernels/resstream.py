"""A whole ResStack behind one entry point, the port of
``voicefixer_tpu/kernels/resstream.py``: ``up_res_stream``, the polyphase
upsample of a = x + sin(x), the stage's ResStack blocks and the stage's
LeakyReLU; and ``res_stream`` (csrc/resstream.cu), the blocks and the
LeakyReLU on a signal that is already at the full rate, optionally inside a
signal window (``mask_bounds``), which the time-sharded vocoder runs on
every shard.

    a    = (x + sin(x)) in float32, cast to x's type
    z[q*s + rho] = a[q] @ W[rho] + a[q-1] @ W[rho+s] + b_up   float32
    u[n] = z[n + p] cast to x's type, p = s//2 + s%2, n in [0, T*s)
    out  = the blocks of ``kernels.resstack`` on u, then lrelu(final_slope)

The stack is cut into groups of blocks by ``resstack.plan_stack``. The
first group of ``up_res_stream`` is one kernel with the upsample in front,
on a tile of u that only ever exists in shared memory
(``vf_up_chain_f32`` of csrc/resstack_f32.cu, ``vf_up_chain_wgmma`` of
csrc/resstack_wgmma.cu); each later group is a chain or a single block of
``kernels.resstack``'s kernels at the same width (bfloat16 single blocks:
csrc/resstack.cu), which reads the full-rate signal once and writes it
once. The wrapper walks the groups itself and counts the call once, as
``up_res_stream``. ``passes`` says how many times a plan writes and reads
the full-rate signal. ``res_stream`` walks its groups in csrc/resstream.cu,
from x itself, on resblock.cuh's kernels.

The JAX ``res_stream`` needs C in multiples of 128 and has ``mask_t_total``,
``fold_offset`` and ``fold_ch`` for its two-halves lane fold of C = 64, and a
VMEM plan (``stream_vmem_bytes``): TPU mechanics without a counterpart here.
Any C that the tap products take runs as it is.
"""

from __future__ import annotations

import ctypes

import torch

from voicefixer_tpu_torch import kernels
from voicefixer_tpu_torch.kernels import build, resstack
from voicefixer_tpu_torch.kernels.resstack import (FUSE_MAX_CHANNELS,
                                                   check_stack_args,
                                                   clamp_bounds, int_array,
                                                   plan_stack,
                                                   res_chain_reference,
                                                   slope_args)
from voicefixer_tpu_torch.kernels.upsample import upsample_reference


def passes(groups) -> tuple:
    """(writes, reads) of the full-rate signal by a plan's launches: every
    group writes it once, every group after the first reads it once."""
    return len(groups), len(groups) - 1


def up_plan(cin: int, cout: int, scale: int, dils, itemsize: int) -> tuple:
    """``up_res_stream``'s groups: planned for the kernels it runs (the
    bfloat16 wgmma chain or the float32 FMA one at N = C), the first a chain
    with the upsample's source rows and work counted."""
    return plan_stack(cout, tuple(dils), itemsize, first_chain=True,
                      route="wgmma" if itemsize == 2 else "f32",
                      up=(cin, scale))


def up_res_stream_reference(x_src, w_up, b_up, w1s, b1s, w2s, b2s, dils,
                            scale: int, slope: float = 0.2,
                            final_slope=None):
    """Plain version of ``up_res_stream``."""
    u = upsample_reference(x_src, w_up, b_up, scale)
    return res_chain_reference(u, w1s, b1s, w2s, b2s, dils, slope,
                               final_slope)


def up_res_stream(x_src: torch.Tensor, w_up, b_up, w1s, b1s, w2s, b2s,
                  dils, scale: int, slope: float = 0.2,
                  final_slope=None) -> torch.Tensor:
    """x_src: [B, T, Cin], the stage's input before x + sin(x); w_up:
    [2s, Cin, Cout] in torch tap order (read in place); b_up: [Cout]; w1s,
    w2s: [n, 3, Cout, Cout]; b1s, b2s: [n, Cout]. Returns [B, T*s, Cout] in
    x_src's type. On the card Cout is at most FUSE_MAX_CHANNELS."""
    dils = tuple(int(d) for d in dils)
    if kernels.on_cpu(x_src, w_up, b_up, w1s, b1s, w2s, b2s):
        return up_res_stream_reference(x_src, w_up, b_up, w1s, b1s, w2s, b2s,
                                       dils, scale, slope, final_slope)
    bsz, t_in, cin = x_src.shape
    k, wcin, cout = w_up.shape
    n = len(dils)
    if k != 2 * scale or wcin != cin or b_up.shape != (cout,):
        raise ValueError(f"up_res_stream: x {tuple(x_src.shape)}, w_up "
                         f"{tuple(w_up.shape)}, b_up {tuple(b_up.shape)}, "
                         f"scale {scale}")
    if cout > FUSE_MAX_CHANNELS:
        raise ValueError(f"up_res_stream: Cout {cout} > "
                         f"{FUSE_MAX_CHANNELS}")
    t = t_in * scale
    y = torch.empty((bsz, t, cout), dtype=x_src.dtype, device=x_src.device)
    check_stack_args("up_res_stream", y, (w1s, w2s), (b1s, b2s), n)
    bf16 = x_src.dtype == torch.bfloat16
    if bf16 and cin % 8:
        raise ValueError(f"up_res_stream: bfloat16 needs Cin in multiples "
                         f"of 8, got {cin}")
    if n < 1 or min(dils) < 1:
        raise ValueError(f"up_res_stream: dilations {dils}")
    groups = up_plan(cin, cout, scale, dils, x_src.element_size())
    dt = x_src.dtype
    x_src, w_up, b_up, w1s, b1s, w2s, b2s = (
        v.to(dt).contiguous() for v in (x_src, w_up, b_up, w1s, b1s, w2s,
                                        b2s))
    a = torch.empty_like(x_src)  # x + sin(x), the first kernel's pre-pass
    scratch = [torch.empty_like(y) for _ in range(min(2, len(groups) - 1))]
    stream = torch.cuda.current_stream(x_src.device).cuda_stream
    cur = None
    for g, (i0, i1, tm) in enumerate(groups):
        last = g + 1 == len(groups)
        dst = y if last else scratch[g % 2]
        bank = (w1s[i0].data_ptr(), b1s[i0].data_ptr(), w2s[i0].data_ptr(),
                b2s[i0].data_ptr())
        slopes = slope_args(slope, final_slope if last else None)
        if g == 0:
            lib = resstack._wgmma_lib() if bf16 else resstack._f32_lib()
            fn = lib.vf_up_chain_wgmma if bf16 else lib.vf_up_chain_f32
            rc = fn(x_src.data_ptr(), a.data_ptr(), w_up.data_ptr(),
                    b_up.data_ptr(), *bank, dst.data_ptr(), bsz, t_in, cin,
                    cout, scale, i1 - i0, int_array(dils[i0:i1]), tm,
                    *slopes, stream)
        elif tm is None:
            lib = resstack._lib() if bf16 else resstack._f32_lib()
            fn = (lib.vf_res_shift_single if bf16
                  else lib.vf_res_shift_single_f32)
            rc = fn(cur.data_ptr(), *bank, dst.data_ptr(), bsz, t, cout,
                    dils[i0], *slopes, 0, t, stream)
        else:
            lib = resstack._wgmma_lib() if bf16 else resstack._f32_lib()
            fn = lib.vf_res_chain_wgmma if bf16 else lib.vf_res_chain_f32
            rc = fn(cur.data_ptr(), *bank, dst.data_ptr(), bsz, t, cout,
                    i1 - i0, int_array(dils[i0:i1]), tm, *slopes, 0, t,
                    stream)
        build.check(lib, rc, "up_res_stream")
        cur = dst
    kernels.launches["up_res_stream"] += 1
    return y


def res_stream_reference(x, w1s, b1s, w2s, b2s, dils, slope: float = 0.2,
                         final_slope=None, mask_bounds=None):
    """Plain version of ``res_stream``: the blocks one after the other."""
    return res_chain_reference(x, w1s, b1s, w2s, b2s, dils, slope,
                               final_slope, mask_bounds)


def res_stream(x: torch.Tensor, w1s, b1s, w2s, b2s, dils,
               slope: float = 0.2, final_slope=None,
               mask_bounds=None) -> torch.Tensor:
    """The whole len(dils)-block stack in one call. x: [B, T, C]; w1s, w2s:
    [n, 3, C, C]; b1s, b2s: [n, C]; ``mask_bounds`` the signal window
    (lo, hi) in rows, clamped to [0, T]. Returns [B, T, C] in x's type."""
    dils = tuple(int(d) for d in dils)
    if kernels.on_cpu(x, w1s, b1s, w2s, b2s):
        return res_stream_reference(x, w1s, b1s, w2s, b2s, dils, slope,
                                    final_slope, mask_bounds)
    n = len(dils)
    check_stack_args("res_stream", x, (w1s, w2s), (b1s, b2s), n)
    if n < 1 or min(dils) < 1:
        raise ValueError(f"res_stream: dilations {dils}")
    bsz, t, ch = x.shape
    groups = plan_stack(ch, dils, x.element_size())
    x = x.contiguous()
    w1s, b1s, w2s, b2s = (v.to(x.dtype).contiguous()
                          for v in (w1s, b1s, w2s, b2s))
    y = torch.empty_like(x)
    scratch = [torch.empty_like(x) for _ in range(min(2, len(groups) - 1))]
    ptr = [s.data_ptr() for s in scratch] + [None, None]
    lib = _lib()
    rc = lib.vf_res_stream(
        x.data_ptr(), w1s.data_ptr(), b1s.data_ptr(), w2s.data_ptr(),
        b2s.data_ptr(), y.data_ptr(), ptr[0], ptr[1], bsz, t, ch, n,
        int_array(dils), len(groups), int_array([g[1] for g in groups]),
        int_array([g[2] or 0 for g in groups]),
        *slope_args(slope, final_slope), *clamp_bounds(mask_bounds, t),
        int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, rc, "res_stream")
    kernels.launches["res_stream"] += 1
    return y


def _lib():
    lib = build.load("resstream")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ip = ctypes.POINTER(ctypes.c_int)
    lib.vf_res_stream.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, ip, i,
                                  ip, ip, f, f, i, i, i, i, p]
    lib.vf_res_stream.restype = i
    return lib
