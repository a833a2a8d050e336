"""The vocoder's ResStack (csrc/resstack.cu, csrc/resblock.cuh; bfloat16
chains csrc/resstack_wgmma.cu), the port of
``voicefixer_tpu/kernels/resstack.py``: ``res_chain`` (n consecutive blocks
in one kernel, intermediates in shared memory), ``res_shift_single`` (one
block, its +-d taps read at row offsets), the dispatcher ``res_stack`` over
one stage's blocks, and ``up_res_stack`` (the stage fused with its upsample,
``kernels.resstream``).

One block, on x: [B, T, C] with k = 3 convolutions and zero 'same' padding:

    a  = lrelu(x, slope)                     float32, cast to x's type
    h  = sum_j a[t + (j-1)*d] @ W1[j] + b1   float32 sums
    hb = lrelu(h, slope), 0 outside [0, T), cast to x's type
    y  = sum_j hb[t + j - 1] @ W2[j] + b2 + x, cast to x's type

x's type is float32 in parity mode and bfloat16 in production; products take
operands of that type and accumulate in float32. The last block of a stage
applies the stage's LeakyReLU in float32 before the cast (``final_slope``).

``mask_bounds = (lo, hi)`` narrows the signal to the rows [lo, hi) of the
array, as the time-sharded vocoder needs on [halo | samples | halo]: x reads
as zero outside the window, hb is zero outside it and so is every block's y,
as if the array ended there (``bounds_mask`` of
``voicefixer_tpu/models/vocoder.py`` and the JAX kernels' traced bounds).
The bounds are host integers: each shard knows its window.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from voicefixer_tpu_torch import kernels
from voicefixer_tpu_torch.kernels import build
from voicefixer_tpu_torch.utils.weights import res_bank

# of csrc/resblock.cuh
BM = 64                 # rows of a product tile
STAGE_BYTES = 32768     # staging tiles of the tap product
MAX_BLOCKS = 8          # blocks of one chain
SMEM_LIMIT = 232448     # dynamic shared memory one thread block may take
# Two thread blocks on an SM hide each other's waits at the barriers of the
# tap product, which gains more than a longer chain does (PERF.md): a chain
# takes the whole SM only where no chain fits half of it. 1 KB a block is
# the runtime's.
SMEM_BUDGETS = (SMEM_LIMIT // 2 - 1024, SMEM_LIMIT)
# A chain computes block i over the tile widened by its halo, in whole
# 64-row product tiles. Below this share of useful rows the blocks run on
# their own instead.
MIN_EFFICIENCY = 0.65
# widest stack that runs behind one entry point: fused with its upsample
# (``up_res_stack``) or, under ``mask_bounds``, as ``res_stream``
FUSE_MAX_CHANNELS = 128
# of csrc/resstack_wgmma.cu, the bfloat16 chain: two consumer warpgroups of
# 64-row wgmma tiles over 256-column chunks, a ring of at least two 32-deep
# weight stages (16 KB a chunk, 16 bytes of barriers each; 64-deep where two
# of those fit), slab and h rows of the width rounded up to WG_ALIGN plus 16
# bytes, one thread block an SM
WG_ROWS = 64
WG_COLS = 256
WG_CONSUMERS = 2
WG_STAGE_BYTES = 16384
WG_MIN_STAGES = 2
WG_ALIGN = 64


def stack_dilations(depth: int) -> tuple:
    return tuple(3 ** (i % 10) for i in range(depth))


# ------------------------------------------------------------ plain versions

def _lrelu(v: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(v > 0, v, slope * v)


def _taps(a: torch.Tensor, w: torch.Tensor, d: int) -> torch.Tensor:
    """sum_j a[t + (j-1)*d] @ w[j], zero outside [0, T); float32."""
    t = a.shape[1]
    ap = F.pad(a, (0, 0, d, d))
    wf = w.float()
    return sum(torch.matmul(ap[:, j * d: j * d + t], wf[j]) for j in range(3))


def clamp_bounds(mask_bounds, t: int) -> tuple:
    """(lo, hi) as ints within [0, t]; None is the whole array."""
    if mask_bounds is None:
        return 0, t
    lo, hi = (int(v) for v in mask_bounds)
    lo = min(max(lo, 0), t)
    return lo, min(max(hi, lo), t)


def _window(v: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """v with the rows outside [lo, hi) zeroed."""
    if lo <= 0 and hi >= v.shape[1]:
        return v
    out = torch.zeros_like(v)
    out[:, lo:hi] = v[:, lo:hi]
    return out


def _block_reference(x, w1, b1, w2, b2, d, slope, final_slope,
                     mask_bounds=None):
    lo, hi = clamp_bounds(mask_bounds, x.shape[1])
    xf = _window(x.float(), lo, hi)
    a = _lrelu(xf, slope).to(x.dtype).float()
    h = _taps(a, w1, d) + b1.float()
    hb = _window(_lrelu(h, slope), lo, hi).to(x.dtype).float()
    y = _window(_taps(hb, w2, 1) + b2.float() + xf, lo, hi)
    if final_slope is not None:
        y = _lrelu(y, final_slope)
    return y.to(x.dtype)


def res_shift_single_reference(x, w1, b1, w2, b2, dil: int,
                               slope: float = 0.2, final_slope=None,
                               mask_bounds=None):
    """Plain version of ``res_shift_single``."""
    return _block_reference(x, w1, b1, w2, b2, dil, slope, final_slope,
                            mask_bounds)


def res_chain_reference(x, w1s, b1s, w2s, b2s, dils, slope: float = 0.2,
                        final_slope=None, mask_bounds=None):
    """Plain version of ``res_chain``: the blocks one after the other, each
    output cast to x's type."""
    n = len(dils)
    for i, d in enumerate(dils):
        x = _block_reference(x, w1s[i], b1s[i], w2s[i], b2s[i], d, slope,
                             final_slope if i == n - 1 else None, mask_bounds)
    return x


# ------------------------------------------------------------------ planning

def chain_extents(dils) -> tuple:
    """E[i] = sum over k >= i of (d_k + 1): the rows a side that block i's
    input must reach beyond the output tile."""
    e = [0]
    for d in reversed(list(dils)):
        e.append(e[-1] + d + 1)
    return tuple(reversed(e))


def chain_smem_bytes(ch: int, dils, tm: int, itemsize: int) -> int:
    """Shared memory of one thread block of the WMMA chain kernel (float32,
    and the fused stages' groups): the staging tiles, the input slab (tile +
    halo) and the widest block's h; rows are padded by 16 bytes."""
    e = chain_extents(dils)
    rows = (tm + 2 * e[0]) + (tm + 2 * e[1] + 2)
    return STAGE_BYTES + rows * (ch + 16 // itemsize) * itemsize


def wgmma_chain(ch: int, itemsize: int) -> bool:
    """Whether ``plan_stack`` plans for the bfloat16 wgmma chain kernel: the
    unfused stages (C > FUSE_MAX_CHANNELS) in bfloat16. Narrower stacks are
    planned for the fused kernels, which run the WMMA chain."""
    return itemsize == 2 and ch > FUSE_MAX_CHANNELS


def wgmma_smem_bytes(ch: int, dils, tm: int,
                     stages: int = WG_MIN_STAGES) -> int:
    """Shared memory of one thread block of the bfloat16 chain kernel with
    ``stages`` ring stages: 1 KB of alignment, the ring and its barriers,
    the slab and the widest block's h."""
    e = chain_extents(dils)
    rows = (tm + 2 * e[0]) + (tm + 2 * e[1] + 2)
    chunks = -(-ch // WG_COLS)
    return (1024 + stages * (chunks * WG_STAGE_BYTES + 16)
            + rows * (-(-ch // WG_ALIGN) * WG_ALIGN + 8) * 2)


def wgmma_passes(ch: int, dils, tm: int) -> int:
    """Passes over the weights that one thread block of the bfloat16 chain
    kernel makes: per product, its (64-row tile, 256-column chunk) pairs two
    at a time."""
    chunks = -(-ch // WG_COLS)
    return sum(-(-(-(-rows // WG_ROWS) * chunks) // WG_CONSUMERS)
               for eo in chain_extents(dils)[1:]
               for rows in (tm + 2 * eo + 2, tm + 2 * eo))


def chain_tile(ch: int, dils, itemsize: int, budget: int = SMEM_LIMIT,
               wgmma: bool = False):
    """(tm, efficiency) of the best output tile of a chain over ``dils``, or
    None when no tile fits ``budget`` bytes of shared memory. Tiles make the
    first block's h a whole number of product tiles; efficiency is the share
    of product rows that are output rows. With ``wgmma``, the bfloat16 chain
    kernel's accounting: its shared memory, and product rows counted as the
    two warpgroups' 64-row tiles of every pass, busy or not."""
    e = chain_extents(dils)
    best = None
    k = 1
    while True:
        tm = k * BM - 2 * e[1] - 2
        smem = (wgmma_smem_bytes(ch, dils, max(tm, 1)) if wgmma
                else chain_smem_bytes(ch, dils, max(tm, 1), itemsize))
        if smem > budget:
            return best
        if tm >= 1:
            if wgmma:
                done = (wgmma_passes(ch, dils, tm) * WG_CONSUMERS * WG_ROWS
                        / -(-ch // WG_COLS))
            else:
                done = sum((-(-(tm + 2 * eo + 2) // BM)
                            + -(-(tm + 2 * eo) // BM)) * BM for eo in e[1:])
            eff = 2 * len(dils) * tm / done
            if best is None or eff > best[1]:
                best = (tm, eff)
        k += 1


@functools.lru_cache(maxsize=64)
def plan_stack(ch: int, dils: tuple, itemsize: int,
               first_chain: bool = False) -> tuple:
    """Cut a stack's blocks into kernel launches: ((i0, i1, tm), ...) over
    range(len(dils)). A group with a tile ``tm`` is a chain; ``tm`` None is
    one block for ``res_shift_single``. Greedy: from each block, the longest
    chain of at least two blocks that fits the first of SMEM_BUDGETS it can
    at MIN_EFFICIENCY or better, else the block alone. With ``first_chain``
    the first group is a chain even when it is one block (the fused upsample
    feeds a chain). The bfloat16 chain kernel takes one thread block an SM
    (``wgmma_chain``): its only budget is SMEM_LIMIT."""
    n = len(dils)
    wgmma = wgmma_chain(ch, itemsize)
    groups = []
    i = 0
    while i < n:
        pick = None
        for budget in (SMEM_LIMIT,) if wgmma else SMEM_BUDGETS:
            for j in range(min(n, i + MAX_BLOCKS), i + 1, -1):
                tile = chain_tile(ch, dils[i:j], itemsize, budget, wgmma)
                if tile is not None and tile[1] >= MIN_EFFICIENCY:
                    pick = (i, j, tile[0])
                    break
            if pick is not None:
                break
        if pick is None and first_chain and i == 0:
            tile = chain_tile(ch, dils[:1], itemsize, wgmma=wgmma)
            if tile is None:
                raise ValueError(f"no chain tile fits shared memory at "
                                 f"C={ch}, itemsize {itemsize}")
            pick = (0, 1, tile[0])
        if pick is None:
            pick = (i, i + 1, None)
        groups.append(pick)
        i = pick[1]
    return tuple(groups)


# ------------------------------------------------------------------ wrappers

def check_stack_args(name, x, ws, bs, n):
    bsz, t, ch = x.shape
    for w in ws:
        if tuple(w.shape) != (n, 3, ch, ch):
            raise ValueError(f"{name}: x {tuple(x.shape)}, weights "
                             f"{tuple(w.shape)}, expected {(n, 3, ch, ch)}")
    for b in bs:
        if tuple(b.shape) != (n, ch):
            raise ValueError(f"{name}: bias {tuple(b.shape)}, expected "
                             f"{(n, ch)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {x.dtype}")
    if x.dtype == torch.bfloat16 and ch % 8:
        raise ValueError(f"{name}: bfloat16 needs C in multiples of 8, "
                         f"got {ch}")
    if t * ch >= 2 ** 31:
        raise ValueError(f"{name}: T*C = {t * ch} does not fit 31 bits")


def slope_args(slope, final_slope):
    return (float(slope), float(final_slope or 0.0),
            int(final_slope is not None))


def int_array(values):
    return (ctypes.c_int * len(values))(*values)


def res_chain(x: torch.Tensor, w1s, b1s, w2s, b2s, dils,
              slope: float = 0.2, final_slope=None, tm: int | None = None,
              mask_bounds=None):
    """len(dils) consecutive blocks in one kernel. x: [B, T, C]; w1s, w2s:
    [n, 3, C, C] (block, tap, in, out) in torch tap order; b1s, b2s: [n, C].
    ``tm`` is the output tile of a thread block, by default the planner's;
    ``mask_bounds`` the signal window (lo, hi) in rows. bfloat16 runs the
    wgmma chain kernel, float32 the WMMA one."""
    dils = tuple(int(d) for d in dils)
    if kernels.on_cpu(x, w1s, b1s, w2s, b2s):
        return res_chain_reference(x, w1s, b1s, w2s, b2s, dils, slope,
                                   final_slope, mask_bounds)
    n = len(dils)
    check_stack_args("res_chain", x, (w1s, w2s), (b1s, b2s), n)
    if not 1 <= n <= MAX_BLOCKS or min(dils) < 1:
        raise ValueError(f"res_chain: dilations {dils}")
    bsz, t, ch = x.shape
    bf16 = x.dtype == torch.bfloat16
    if tm is None:
        tile = chain_tile(ch, dils, x.element_size(), wgmma=bf16)
        tm = tile[0] if tile is not None else 1
    smem = (wgmma_smem_bytes(ch, dils, tm) if bf16
            else chain_smem_bytes(ch, dils, tm, x.element_size()))
    if smem > SMEM_LIMIT:
        raise ValueError(f"res_chain: C={ch}, dilations {dils}, tile {tm} "
                         f"do not fit {SMEM_LIMIT} bytes of shared memory")
    x = x.contiguous()
    w1s, b1s, w2s, b2s = (v.to(x.dtype).contiguous()
                          for v in (w1s, b1s, w2s, b2s))
    y = torch.empty_like(x)
    args = (x.data_ptr(), w1s.data_ptr(), b1s.data_ptr(), w2s.data_ptr(),
            b2s.data_ptr(), y.data_ptr(), bsz, t, ch, n, int_array(dils), tm,
            *slope_args(slope, final_slope), *clamp_bounds(mask_bounds, t))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if bf16:
        lib = _wgmma_lib()
        rc = lib.vf_res_chain_wgmma(*args, stream)
    else:
        lib = _lib()
        rc = lib.vf_res_chain(*args, stream)
    build.check(lib, rc, "res_chain")
    kernels.launches["res_chain"] += 1
    return y


def res_shift_single(x: torch.Tensor, w1, b1, w2, b2, dil: int,
                     slope: float = 0.2, final_slope=None, mask_bounds=None):
    """One block at dilation ``dil``. x: [B, T, C]; w1, w2: [3, C, C];
    b1, b2: [C]; ``mask_bounds`` the signal window (lo, hi) in rows."""
    if kernels.on_cpu(x, w1, b1, w2, b2):
        return res_shift_single_reference(x, w1, b1, w2, b2, dil, slope,
                                          final_slope, mask_bounds)
    check_stack_args("res_shift_single", x, (w1[None], w2[None]),
                     (b1[None], b2[None]), 1)
    if dil < 1:
        raise ValueError(f"res_shift_single: dilation {dil}")
    bsz, t, ch = x.shape
    x = x.contiguous()
    w1, b1, w2, b2 = (v.to(x.dtype).contiguous() for v in (w1, b1, w2, b2))
    y = torch.empty_like(x)
    lib = _lib()
    rc = lib.vf_res_shift_single(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), y.data_ptr(), bsz, t, ch, int(dil),
        *slope_args(slope, final_slope), *clamp_bounds(mask_bounds, t),
        int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, rc, "res_shift_single")
    kernels.launches["res_shift_single"] += 1
    return y


def res_stack(params: list, x: torch.Tensor, kernel: int, slope: float,
              final_slope=None, mask_bounds=None) -> torch.Tensor:
    """One stage's ResStack, block i at dilation 3^(i%10), through the
    launches ``plan_stack`` picks: runs of small dilations through
    ``res_chain``, the others through ``res_shift_single``. ``final_slope``
    folds the stage's LeakyReLU into the last launch. Under ``mask_bounds``
    (a time shard's signal window) a stack of at most FUSE_MAX_CHANNELS
    channels goes to ``kernels.resstream.res_stream`` instead, one entry
    point for the whole stack, as in the JAX package."""
    if kernel != 3:
        raise ValueError(f"res_stack: kernel size {kernel}, only 3 is ported")
    dils = stack_dilations(len(params))
    if mask_bounds is not None and x.shape[-1] <= FUSE_MAX_CHANNELS:
        from voicefixer_tpu_torch.kernels.resstream import res_stream
        return res_stream(x, *res_bank(params), dils, slope, final_slope,
                          mask_bounds)
    groups = plan_stack(x.shape[-1], dils, x.element_size())
    for i0, i1, tm in groups:
        fs = final_slope if i1 == len(params) else None
        if tm is None:
            p = params[i0]
            x = res_shift_single(x, p["c1"]["w"], p["c1"]["b"], p["c2"]["w"],
                                 p["c2"]["b"], dils[i0], slope, fs,
                                 mask_bounds)
        else:
            x = res_chain(x, *res_bank(params[i0:i1]), dils[i0:i1], slope,
                          fs, tm=tm, mask_bounds=mask_bounds)
    return x


def up_res_stack(up_params: dict, res_params: list, x_src: torch.Tensor,
                 scale: int, kernel: int, slope: float,
                 final_slope=None) -> torch.Tensor:
    """One whole stage (upsample, ResStack, stage LeakyReLU) through
    ``kernels.resstream.up_res_stream``: the upsampled signal is never
    written before block 0 has run on it."""
    from voicefixer_tpu_torch.kernels.resstream import up_res_stream
    if kernel != 3:
        raise ValueError(f"up_res_stack: kernel size {kernel}, only 3 is "
                         "ported")
    return up_res_stream(x_src, up_params["w"], up_params["b"],
                         *res_bank(res_params),
                         stack_dilations(len(res_params)), scale, slope,
                         final_slope)


def _lib():
    lib = build.load("resstack")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ip = ctypes.POINTER(ctypes.c_int)
    lib.vf_res_chain.argtypes = [p, p, p, p, p, p, i, i, i, i, ip, i, f, f,
                                 i, i, i, p]
    lib.vf_res_chain.restype = i
    lib.vf_res_shift_single.argtypes = [p, p, p, p, p, p, i, i, i, i, f, f,
                                        i, i, i, i, p]
    lib.vf_res_shift_single.restype = i
    return lib


def _wgmma_lib():
    lib = build.load("resstack_wgmma")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vf_res_chain_wgmma.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                       ctypes.POINTER(ctypes.c_int), i, f, f,
                                       i, i, i, p]
    lib.vf_res_chain_wgmma.restype = i
    return lib
