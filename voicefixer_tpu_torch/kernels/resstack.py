"""The vocoder's ResStack (float32: csrc/resstack_f32.cu; bfloat16:
csrc/resstack_wgmma.cu), the port of
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

MAX_BLOCKS = 8          # blocks of one chain
SMEM_LIMIT = 232448     # dynamic shared memory one thread block may take
# A chain computes block i over the tile widened by its halo, in whole
# product tiles. Below this share of useful rows the blocks run on their
# own instead.
MIN_EFFICIENCY = 0.65
# widest stack that runs behind one entry point: fused with its upsample
# (``up_res_stack``) or, under ``mask_bounds``, as ``res_stream``
FUSE_MAX_CHANNELS = 128
# of csrc/resstack_wgmma.cu, the bfloat16 chain and single block: two
# consumer warpgroups of 64-row wgmma tiles over column chunks of WG_COLS
# (the width rounded up to WG_ALIGN where it is at most FUSE_MAX_CHANNELS:
# N = C), a ring of at least two 32-deep weight stages (32 K rows of every
# chunk, 16 bytes of barriers each; 64-deep where two of those fit and the
# width is one chunk), slab and h rows of the width rounded up to WG_ALIGN
# plus 16 bytes, one thread block an SM
WG_ROWS = 64
WG_COLS = 256
WG_CONSUMERS = 2
WG_MIN_DEPTH = 32
WG_MIN_STAGES = 2
WG_ALIGN = 64
# At N = C (up to FUSE_MAX_CHANNELS) a chain keeps a ring of at least this
# many 64-deep stages: with two 32-deep ones the fused stages ran 22-37 %
# slower on an H100 (tools/torch_chain_plans.py, PERF.md)
WG_MIN_RING = 3
# of csrc/resstack_f32.cu, the float32 chain and single block: a ring of
# F32_STAGES K steps, each a BM x 16 A tile (rows 20 floats apart) and a
# 16 x BN weight tile; slab and h rows of the width rounded up to 16 plus 4
# floats; one thread block an SM. 256 threads hold 8 columns each of a BN-
# column tile and TR rows each: BM = TR * 2048 / BN rows (F32_TILES, by the
# width the tile covers).
F32_STAGES = 3
F32_TILES = {256: 8, 128: 8, 64: 4}   # BN: TR


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


def up_source_rows(slab_rows: int, scale: int) -> int:
    """Rows q of the slow-rate source that the polyphase upsample of a slab
    of ``slab_rows`` full-rate rows reads, at most: the slab's rows fall on
    the phases of at most (slab_rows - 1) // s + 2 rows q, each tap pair
    reads q and q - 1."""
    return (slab_rows - 1) // scale + 3


def f32_tile(ch: int) -> tuple:
    """(BM, BN) of the float32 tap product at width ``ch``: BN the least of
    64, 128 and 256 that covers the width (256 above it: column passes)."""
    bn = 64 if ch <= 64 else 128 if ch <= 128 else 256
    return F32_TILES[bn] * 2048 // bn, bn


def f32_smem_bytes(ch: int, dils, tm: int) -> int:
    """Shared memory of one thread block of the float32 chain kernel: the
    ring, the slab (tile + halo) and the widest block's h. The fused
    upsample adds nothing: its source rows and polyphase weights come
    through the same ring."""
    bm, bn = f32_tile(ch)
    e = chain_extents(dils)
    rows = (tm + 2 * e[0]) + (tm + 2 * e[1] + 2)
    return (F32_STAGES * (bm * 20 + 16 * bn) * 4
            + rows * (-(-ch // 16) * 16 + 4) * 4)


def route_smem_bytes(itemsize: int, ch: int, dils, tm: int, up=None) -> int:
    """Shared memory of one thread block of the chain kernel of a type: the
    bfloat16 wgmma kernel (itemsize 2) or the float32 FMA one; ``up`` =
    (Cin, scale) for a chain with the fused upsample in front."""
    if itemsize == 2:
        return wgmma_smem_bytes(ch, dils, tm, up=up)
    return f32_smem_bytes(ch, dils, tm)


def wg_cols(ch: int) -> int:
    """Columns of one bfloat16 wgmma, a column chunk: the width rounded up
    to WG_ALIGN up to FUSE_MAX_CHANNELS, else WG_COLS."""
    if ch <= FUSE_MAX_CHANNELS:
        return -(-ch // WG_ALIGN) * WG_ALIGN
    return WG_COLS


def wgmma_smem_bytes(ch: int, dils, tm: int, stages: int = WG_MIN_STAGES,
                     up=None) -> int:
    """Shared memory of one thread block of the bfloat16 chain kernel with
    ``stages`` ring stages: 1 KB of alignment, the ring and its barriers,
    the slab and the widest block's h. With the fused upsample (``up`` =
    (Cin, scale)) the slow-rate source rows of the slab, Cin rounded up to
    WG_ALIGN wide, are staged where h will be: the larger of the two. A
    polyphase weight stage is one phase's 32 x N box: the size of a
    block's stage."""
    e = chain_extents(dils)
    cols = wg_cols(ch)
    chunks = -(-ch // cols)
    ld = -(-ch // WG_ALIGN) * WG_ALIGN + 8
    slab_rows = tm + 2 * e[0]
    h_bytes = (tm + 2 * e[1] + 2) * ld * 2
    if up is not None:
        cin, scale = up
        src = up_source_rows(slab_rows, scale) * (
            -(-cin // WG_ALIGN) * WG_ALIGN + 8) * 2
        h_bytes = max(h_bytes, src)
    return (1024 + stages * (chunks * WG_MIN_DEPTH * cols * 2 + 16)
            + slab_rows * ld * 2 + h_bytes)


def wgmma_ring(ch: int, dils, tm: int, up=None) -> tuple:
    """(K rows a stage, stages) of the bfloat16 chain kernel's weight ring,
    as csrc/resstack_wgmma.cu's launch_chain picks them from the room left
    beside the slab and h: 64 rows where two such stages fit and the width
    is one chunk, else 32; as many stages as fit, at most 8."""
    cols = wg_cols(ch)
    chunks = -(-ch // cols)
    room = SMEM_LIMIT - wgmma_smem_bytes(ch, dils, tm, stages=0, up=up)
    deep = 2 * WG_MIN_DEPTH
    depth = (deep if chunks == 1 and room >= WG_MIN_STAGES * (
        chunks * deep * cols * 2 + 16) else WG_MIN_DEPTH)
    return depth, min(8, room // (chunks * depth * cols * 2 + 16))


def wgmma_shift_tile(ch: int) -> tuple:
    """(tm, K rows a stage, stages) of the bfloat16 single-block kernel
    (csrc/resstack_wgmma.cu, vf_res_shift_wgmma) at width ``ch``, as its
    entry point picks them: a tile is tm output rows from h over tm + 2
    rows, two 64-row tiles at one column chunk (one pass of both
    warpgroups), one tile at more (a pass covers its chunks). A ring stage
    holds every chunk's weights and a 64-row box of x rows for each
    warpgroup; 64 K rows deep where two such stages fit beside h and the
    width is one chunk, else 32; as many stages as fit, at most 8. The
    signal's length and the dilation change none of it."""
    cols = wg_cols(ch)
    chunks = -(-ch // cols)
    tm = WG_ROWS * (2 if chunks == 1 else 1) - 2
    ld = -(-ch // WG_ALIGN) * WG_ALIGN + 8
    room = SMEM_LIMIT - 1024 - (tm + 2) * ld * 2

    def stage(depth):
        return (chunks * depth * cols * 2 + WG_CONSUMERS * WG_ROWS * depth * 2
                + 16)

    deep = 2 * WG_MIN_DEPTH
    depth = (deep if chunks == 1 and room >= WG_MIN_STAGES * stage(deep)
             else WG_MIN_DEPTH)
    return tm, depth, min(8, room // stage(depth))


def wgmma_shift_executed_flops(ch: int, t: int) -> int:
    """FLOPs that the bfloat16 single-block kernel runs on [1, t, ch],
    discarded rows and padding included: per thread block
    (``wgmma_shift_tile``), both convolutions over tm + 2 rows, three taps
    of K = ch rounded up to WG_ALIGN, at every column chunk's width."""
    tm = wgmma_shift_tile(ch)[0]
    cols = wg_cols(ch)
    k = -(-ch // WG_ALIGN) * WG_ALIGN
    return -(-t // tm) * 2 * (tm + 2) * 2 * 3 * k * -(-ch // cols) * cols


def wgmma_passes(ch: int, dils, tm: int) -> int:
    """Passes over the weights that one thread block of the bfloat16 chain
    kernel makes: per product, its (64-row tile, column chunk) pairs two at
    a time."""
    chunks = -(-ch // wg_cols(ch))
    return sum(-(-(-(-rows // WG_ROWS) * chunks) // WG_CONSUMERS)
               for eo in chain_extents(dils)[1:]
               for rows in (tm + 2 * eo + 2, tm + 2 * eo))


def up_passes(slab_rows: int, scale: int) -> int:
    """Passes of the bfloat16 chain's fused upsample: per phase, its 64-row
    tiles of source rows q two at a time."""
    q_rows = up_source_rows(slab_rows, scale) - 1
    return scale * -(-(-(-q_rows // WG_ROWS)) // WG_CONSUMERS)


def chain_tile(ch: int, dils, itemsize: int, up=None):
    """(tm, efficiency) of the best output tile of a chain over ``dils``, or
    None when no tile fits the shared memory of the type's chain kernel
    (``route_smem_bytes``). Tiles make the first block's h a whole number
    of product tiles; efficiency is the share of executed product FLOPs
    that are output rows' FLOPs: whole product tiles (float32
    ``f32_tile``'s BM), in bfloat16 the two warpgroups' 64-row tiles of
    every pass, busy or not. With ``up`` = (Cin, scale) the fused
    upsample's product counts too: per phase, whole tiles of source rows
    q, 2*Cin deep. At N = C a bfloat16 tile must leave WG_MIN_RING 64-deep
    ring stages."""
    wgmma = itemsize == 2
    e = chain_extents(dils)
    bm = WG_ROWS if wgmma else f32_tile(ch)[0]
    ring = wgmma and ch <= FUSE_MAX_CHANNELS
    block = 6 * ch * ch           # FLOPs of one row of one convolution
    best = None
    k = 1
    while True:
        tm = k * bm - 2 * e[1] - 2
        if route_smem_bytes(itemsize, ch, dils, max(tm, 1), up) > SMEM_LIMIT:
            return best
        if tm >= 1 and not (ring and wgmma_ring(ch, dils, tm, up) <
                            (2 * WG_MIN_DEPTH, WG_MIN_RING)):
            if wgmma:
                done = (wgmma_passes(ch, dils, tm) * WG_CONSUMERS * WG_ROWS
                        / -(-ch // wg_cols(ch)))
            else:
                done = sum((-(-(tm + 2 * eo + 2) // bm)
                            + -(-(tm + 2 * eo) // bm)) * bm for eo in e[1:])
            useful, done = 2 * len(dils) * tm * block, done * block
            if up is not None:
                cin, scale = up
                row = 4 * cin * ch   # FLOPs of one upsampled row
                slab_rows = tm + 2 * e[0]
                if wgmma:
                    q_done = (up_passes(slab_rows, scale) * WG_CONSUMERS
                              * WG_ROWS)
                else:
                    q_rows = up_source_rows(slab_rows, scale) - 1
                    q_done = scale * -(-q_rows // bm) * bm
                useful, done = useful + tm * row, done + q_done * row
            eff = useful / done
            if best is None or eff > best[1]:
                best = (tm, eff)
        k += 1


@functools.lru_cache(maxsize=64)
def plan_stack(ch: int, dils: tuple, itemsize: int,
               first_chain: bool = False, up: tuple | None = None) -> tuple:
    """Cut a stack's blocks into kernel launches: ((i0, i1, tm), ...) over
    range(len(dils)). A group with a tile ``tm`` is a chain; ``tm`` None is
    one block for ``res_shift_single``. Greedy: from each block, the longest
    chain of at least two blocks that fits shared memory at MIN_EFFICIENCY
    or better, else the block alone. With ``first_chain`` the first group is
    a chain even when it is one block (the fused upsample feeds a chain);
    ``up`` = (Cin, scale) counts that upsample's shared memory and work in
    the first group. Chains are planned for the type's chain kernel."""
    n = len(dils)
    groups = []
    i = 0
    while i < n:
        fused = up if i == 0 else None
        pick = None
        for j in range(min(n, i + MAX_BLOCKS), i + 1, -1):
            tile = chain_tile(ch, dils[i:j], itemsize, fused)
            if tile is not None and tile[1] >= MIN_EFFICIENCY:
                pick = (i, j, tile[0])
                break
        if pick is None and first_chain and i == 0:
            tile = chain_tile(ch, dils[:1], itemsize, up=fused)
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
    wgmma chain kernel, float32 the FMA one of csrc/resstack_f32.cu."""
    dils = tuple(int(d) for d in dils)
    if kernels.on_cpu(x, w1s, b1s, w2s, b2s):
        return res_chain_reference(x, w1s, b1s, w2s, b2s, dils, slope,
                                   final_slope, mask_bounds)
    n = len(dils)
    check_stack_args("res_chain", x, (w1s, w2s), (b1s, b2s), n)
    if not 1 <= n <= MAX_BLOCKS or min(dils) < 1:
        raise ValueError(f"res_chain: dilations {dils}")
    bsz, t, ch = x.shape
    if tm is None:
        tile = chain_tile(ch, dils, x.element_size())
        tm = tile[0] if tile is not None else 1
    if route_smem_bytes(x.element_size(), ch, dils, tm) > SMEM_LIMIT:
        raise ValueError(f"res_chain: C={ch}, dilations {dils}, tile {tm} "
                         f"do not fit {SMEM_LIMIT} bytes of shared memory")
    x = x.contiguous()
    w1s, b1s, w2s, b2s = (v.to(x.dtype).contiguous()
                          for v in (w1s, b1s, w2s, b2s))
    y = torch.empty_like(x)
    args = (x.data_ptr(), w1s.data_ptr(), b1s.data_ptr(), w2s.data_ptr(),
            b2s.data_ptr(), y.data_ptr(), bsz, t, ch, n, int_array(dils), tm,
            *slope_args(slope, final_slope), *clamp_bounds(mask_bounds, t))
    lib, fn = chain_entry(x.dtype)
    rc = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, rc, "res_chain")
    kernels.launches["res_chain"] += 1
    return y


def res_shift_single(x: torch.Tensor, w1, b1, w2, b2, dil: int,
                     slope: float = 0.2, final_slope=None, mask_bounds=None):
    """One block at dilation ``dil``. x: [B, T, C]; w1, w2: [3, C, C];
    b1, b2: [C]; ``mask_bounds`` the signal window (lo, hi) in rows.
    float32 runs the FMA kernel of csrc/resstack_f32.cu, bfloat16 the wgmma
    one of csrc/resstack_wgmma.cu."""
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
    lib, fn = shift_entry(x.dtype)
    rc = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), y.data_ptr(), bsz, t, ch, int(dil),
            *slope_args(slope, final_slope), *clamp_bounds(mask_bounds, t),
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


# argument types of a chain entry point and of a single-block one
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
CHAIN_ARGS = [_P] * 6 + [_I] * 4 + [ctypes.POINTER(ctypes.c_int), _I, _F,
                                    _F, _I, _I, _I, _P]
SHIFT_ARGS = [_P] * 6 + [_I] * 4 + [_F, _F, _I, _I, _I, _P]
# of an entry point of K4's first group: the upsample and a chain
UP_CHAIN_ARGS = [_P] * 9 + [_I] * 6 + [ctypes.POINTER(ctypes.c_int), _I, _F,
                                       _F, _I, _P]


def _f32_lib():
    lib = build.load("resstack_f32")
    lib.vf_res_chain_f32.argtypes = CHAIN_ARGS
    lib.vf_res_chain_f32.restype = _I
    lib.vf_res_shift_single_f32.argtypes = SHIFT_ARGS
    lib.vf_res_shift_single_f32.restype = _I
    lib.vf_up_chain_f32.argtypes = UP_CHAIN_ARGS
    lib.vf_up_chain_f32.restype = _I
    return lib


def _wgmma_lib():
    lib = build.load("resstack_wgmma")
    lib.vf_res_chain_wgmma.argtypes = CHAIN_ARGS
    lib.vf_res_chain_wgmma.restype = _I
    lib.vf_up_chain_wgmma.argtypes = UP_CHAIN_ARGS
    lib.vf_up_chain_wgmma.restype = _I
    lib.vf_res_shift_wgmma.argtypes = SHIFT_ARGS
    lib.vf_res_shift_wgmma.restype = _I
    return lib


def chain_entry(dtype):
    """(library, entry point) of the chain kernel of a type."""
    if dtype == torch.bfloat16:
        lib = _wgmma_lib()
        return lib, lib.vf_res_chain_wgmma
    lib = _f32_lib()
    return lib, lib.vf_res_chain_f32


def up_chain_entry(dtype):
    """(library, entry point) of the chain kernel of a type with the
    upsample in front (``kernels.resstream.up_res_stream``'s first group)."""
    if dtype == torch.bfloat16:
        lib = _wgmma_lib()
        return lib, lib.vf_up_chain_wgmma
    lib = _f32_lib()
    return lib, lib.vf_up_chain_f32


def shift_entry(dtype):
    """(library, entry point) of the single-block kernel of a type."""
    if dtype == torch.bfloat16:
        lib = _wgmma_lib()
        return lib, lib.vf_res_shift_wgmma
    lib = _f32_lib()
    return lib, lib.vf_res_shift_single_f32
