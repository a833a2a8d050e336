"""A whole ResStack behind one entry point, the port of
``voicefixer_tpu/kernels/resstream.py``: ``up_res_stream``, the polyphase
upsample of a = x + sin(x), the stage's ResStack blocks and the stage's
LeakyReLU; and ``res_stream``, the blocks and the LeakyReLU on a signal that
is already at the full rate, optionally inside a signal window
(``mask_bounds``), which the time-sharded vocoder runs on every shard.

    a    = (x + sin(x)) in float32, cast to x's type
    z[q*s + rho] = a[q] @ W[rho] + a[q-1] @ W[rho+s] + b_up   float32
    u[n] = z[n + p] cast to x's type, p = s//2 + s%2, n in [0, T*s)
    out  = the blocks of ``kernels.resstack`` on u, then lrelu(final_slope)

The stack is cut into groups of blocks by ``resstack.plan_stack``, planned
for the chain kernel of the type (csrc/resstack_wgmma.cu in bfloat16,
csrc/resstack_f32.cu in float32, at N = C). The first group of
``up_res_stream`` is one kernel with the upsample in front, on a tile of u
that only ever exists in shared memory (``vf_up_chain_f32``,
``vf_up_chain_wgmma``); every other group, and every group of
``res_stream``, is a chain or a single block of ``kernels.resstack``'s
kernels at the same width, which reads the full-rate signal once and
writes it once, under the window where there is one. The wrappers walk the
groups themselves and count each call once. ``passes`` says how many times
a plan writes and reads the full-rate signal.

The JAX ``res_stream`` needs C in multiples of 128 and has ``mask_t_total``,
``fold_offset`` and ``fold_ch`` for its two-halves lane fold of C = 64, and a
VMEM plan (``stream_vmem_bytes``): TPU mechanics without a counterpart here.
Any C that the tap products take runs as it is.
"""

from __future__ import annotations

import torch

from voicefixer_tpu_torch import kernels
from voicefixer_tpu_torch.kernels import build
from voicefixer_tpu_torch.kernels.resstack import (FUSE_MAX_CHANNELS,
                                                   chain_entry,
                                                   check_stack_args,
                                                   clamp_bounds, int_array,
                                                   plan_stack,
                                                   res_chain_reference,
                                                   shift_entry, slope_args,
                                                   up_chain_entry)
from voicefixer_tpu_torch.kernels.upsample import upsample_reference


def passes(groups) -> tuple:
    """(writes, reads) of the full-rate signal by a plan's launches: every
    group writes it once, every group after the first reads it once."""
    return len(groups), len(groups) - 1


def up_plan(cin: int, cout: int, scale: int, dils, itemsize: int) -> tuple:
    """``up_res_stream``'s groups: the first a chain with the upsample's
    source rows and work counted."""
    return plan_stack(cout, tuple(dils), itemsize, first_chain=True,
                      up=(cin, scale))


def _run_group(src, dst, w1s, b1s, w2s, b2s, dils, group, slopes, bounds):
    """One group (i0, i1, tm) of a plan on src [B, T, C] into dst: a chain
    (tm) or a single block (tm None) of ``kernels.resstack``'s kernels,
    under the signal window ``bounds`` = (lo, hi)."""
    i0, i1, tm = group
    bsz, t, ch = src.shape
    bank = (w1s[i0].data_ptr(), b1s[i0].data_ptr(), w2s[i0].data_ptr(),
            b2s[i0].data_ptr())
    stream = torch.cuda.current_stream(src.device).cuda_stream
    if tm is None:
        lib, fn = shift_entry(src.dtype)
        rc = fn(src.data_ptr(), *bank, dst.data_ptr(), bsz, t, ch, dils[i0],
                *slopes, *bounds, stream)
    else:
        lib, fn = chain_entry(src.dtype)
        rc = fn(src.data_ptr(), *bank, dst.data_ptr(), bsz, t, ch, i1 - i0,
                int_array(dils[i0:i1]), tm, *slopes, *bounds, stream)
    return lib, rc


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
    if x_src.dtype == torch.bfloat16 and cin % 8:
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
        slopes = slope_args(slope, final_slope if last else None)
        if g == 0:
            lib, fn = up_chain_entry(dt)
            rc = fn(x_src.data_ptr(), a.data_ptr(), w_up.data_ptr(),
                    b_up.data_ptr(), w1s[i0].data_ptr(), b1s[i0].data_ptr(),
                    w2s[i0].data_ptr(), b2s[i0].data_ptr(), dst.data_ptr(),
                    bsz, t_in, cin, cout, scale, i1 - i0,
                    int_array(dils[i0:i1]), tm, *slopes, stream)
        else:
            lib, rc = _run_group(cur, dst, w1s, b1s, w2s, b2s, dils,
                                 (i0, i1, tm), slopes, (0, t))
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
    (lo, hi) in rows, clamped to [0, T]. Returns [B, T, C] in x's type.
    The groups of ``plan_stack`` run one after the other, each on the
    previous one's output in one of two scratch buffers, each under the
    window."""
    dils = tuple(int(d) for d in dils)
    if kernels.on_cpu(x, w1s, b1s, w2s, b2s):
        return res_stream_reference(x, w1s, b1s, w2s, b2s, dils, slope,
                                    final_slope, mask_bounds)
    n = len(dils)
    check_stack_args("res_stream", x, (w1s, w2s), (b1s, b2s), n)
    if n < 1 or min(dils) < 1:
        raise ValueError(f"res_stream: dilations {dils}")
    t = x.shape[1]
    groups = plan_stack(x.shape[-1], dils, x.element_size())
    bounds = clamp_bounds(mask_bounds, t)
    x = x.contiguous()
    w1s, b1s, w2s, b2s = (v.to(x.dtype).contiguous()
                          for v in (w1s, b1s, w2s, b2s))
    y = torch.empty_like(x)
    scratch = [torch.empty_like(x) for _ in range(min(2, len(groups) - 1))]
    cur = x
    for g, group in enumerate(groups):
        last = g + 1 == len(groups)
        dst = y if last else scratch[g % 2]
        lib, rc = _run_group(cur, dst, w1s, b1s, w2s, b2s, dils, group,
                             slope_args(slope, final_slope if last else None),
                             bounds)
        build.check(lib, rc, "res_stream")
        cur = dst
    kernels.launches["res_stream"] += 1
    return y
