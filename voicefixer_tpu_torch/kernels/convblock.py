"""The ResUNet's ConvBlockRes in one kernel (csrc/convblock.cu), the port of
``voicefixer_tpu/kernels/convblock.py::conv_block_res``.

On x: [B, T, F, Ci] with folded eval-mode batch norms (scale, shift):

    a1  = lrelu(x*s1 + t1)            float32, cast to x's type
    h1  = conv3x3(a1, W1)             float32 sums, zero 'same' padding
    a2  = lrelu(h1*s2 + t2)           float32 (h1 is never rounded), cast
    out = conv3x3(a2, W2) + res       float32, cast to x's type once

with res = x @ Wsc + bsc (the 1x1 shortcut on the un-normalised input) or x
itself. x's type is float32 in parity mode and bfloat16 in production;
products take operands of that type and accumulate in float32.

The ResUNet routes a block here only on request
(``ops.precision.conv_block_kernel``) and only when ``eligible`` takes it:
at most MAX_CHANNELS channels in and out, as in the JAX package, and a row
tile that fits a thread block's shared memory.
"""

from __future__ import annotations

import ctypes

import torch

from voicefixer_tpu_torch import kernels
from voicefixer_tpu_torch.kernels import build
from voicefixer_tpu_torch.kernels.resstack import (BM, MIN_EFFICIENCY,
                                                   SMEM_BUDGETS, STAGE_BYTES,
                                                   _lrelu)
from voicefixer_tpu_torch.ops.conv import conv2d
from voicefixer_tpu_torch.utils.weights import (pack_bn, pack_conv3x3,
                                                pack_shortcut)

# widest block the kernel takes; wider ones stay on the library convolution
MAX_CHANNELS = 128
RES_PAD = 4  # of csrc/convblock.cu


def tile_smem_bytes(f: int, co: int, tm: int, itemsize: int,
                    shortcut: bool) -> int:
    """Shared memory of one thread block: the staging tiles, a2 over the
    tile and F + 2 rows a side (rows padded by 16 bytes), and the float32
    shortcut tile."""
    rows = tm + 2 * (f + 2)
    return (STAGE_BYTES + rows * (co + 16 // itemsize) * itemsize
            + (tm * (co + RES_PAD) * 4 if shortcut else 0))


def plan_tile(f: int, co: int, itemsize: int, shortcut: bool):
    """Rows of the flattened (T, F + 1) stream per thread block, or None
    when no tile fits. Tiles make conv1's rows (tile plus halo) a whole
    number of 64-row product tiles. The first of SMEM_BUDGETS (two thread
    blocks an SM) that reaches MIN_EFFICIENCY useful product rows wins, else
    the most efficient tile of the whole SM."""
    best = None
    for budget in SMEM_BUDGETS:
        k = 1
        while True:
            tm = k * BM - 2 * (f + 2)
            if tile_smem_bytes(f, co, max(tm, 1), itemsize,
                               shortcut) > budget:
                break
            if tm >= 1:
                eff = 2 * tm / (k * BM + -(-tm // BM) * BM)
                if best is None or eff > best[1]:
                    best = (tm, eff)
            k += 1
        if best is not None and best[1] >= MIN_EFFICIENCY:
            break
    return None if best is None else best[0]


def eligible(params: dict, x: torch.Tensor) -> bool:
    """True when the kernel takes this block: folded batch norms, 3x3
    convolutions, at most MAX_CHANNELS channels in and out (a multiple of 8
    out in bfloat16), float32 or bfloat16, and a tile that fits."""
    if "scale" not in params.get("bn1", {}) or x.dim() != 4:
        return False
    w1, w2 = params["conv1"]["w"], params["conv2"]["w"]
    if tuple(w1.shape[:2]) != (3, 3) or tuple(w2.shape[:2]) != (3, 3):
        return False
    ci, co = w1.shape[2], w1.shape[3]
    if ci > MAX_CHANNELS or co > MAX_CHANNELS or x.shape[-1] != ci:
        return False
    if "shortcut" not in params and ci != co:
        return False
    if x.dtype not in (torch.float32, torch.bfloat16):
        return False
    if x.dtype == torch.bfloat16 and co % 8:
        return False
    return plan_tile(x.shape[2], co, x.element_size(),
                     "shortcut" in params) is not None


def conv_block_res_reference(x: torch.Tensor, params: dict,
                             slope: float) -> torch.Tensor:
    """Plain version of ``conv_block_res``, rounding where the kernel does."""
    dt = x.dtype

    def bn_act(v, bn):
        a = v * bn["scale"].float() + bn["shift"].float()
        return _lrelu(a, slope).to(dt).float()

    def conv3(a, w):
        return conv2d(a, w.to(dt).float(), padding=(1, 1))

    xf = x.float()
    h1 = conv3(bn_act(xf, params["bn1"]), params["conv1"]["w"])
    h2 = conv3(bn_act(h1, params["bn2"]), params["conv2"]["w"])
    if "shortcut" in params:
        sc = params["shortcut"]
        res = (xf @ sc["w"].to(dt).float()[0, 0]) + sc["b"].to(dt).float()
    else:
        res = xf
    return (h2 + res).to(dt)


def conv_block_res(x: torch.Tensor, params: dict,
                   slope: float) -> torch.Tensor:
    """x: [B, T, F, Ci]; params: {"bn1", "bn2": {"scale", "shift"},
    "conv1": {"w": [3, 3, Ci, Co]}, "conv2": {"w": [3, 3, Co, Co]},
    optional "shortcut": {"w": [1, 1, Ci, Co], "b": [Co]}}. Returns
    [B, T, F, Co] in x's type."""
    tensors = [x, params["conv1"]["w"], params["conv2"]["w"],
               params["bn1"]["scale"], params["bn2"]["scale"]]
    if kernels.on_cpu(*tensors):
        return conv_block_res_reference(x, params, slope)
    if not eligible(params, x):
        raise ValueError(
            f"conv_block_res: x {tuple(x.shape)} {x.dtype}, conv1 "
            f"{tuple(params['conv1']['w'].shape)}: not a block the kernel "
            f"takes (folded batch norms, 3x3, at most {MAX_CHANNELS} "
            "channels, float32 or bfloat16)")
    bsz, t, f, ci = x.shape
    co = params["conv1"]["w"].shape[3]
    shortcut = "shortcut" in params
    tm = plan_tile(f, co, x.element_size(), shortcut)
    x = x.contiguous()
    dt = x.dtype
    w1 = pack_conv3x3(params["conv1"]["w"], dt)
    w2 = pack_conv3x3(params["conv2"]["w"], dt)
    wsc = pack_shortcut(params["shortcut"], dt) if shortcut else None
    s1, t1 = pack_bn(params["bn1"])
    s2, t2 = pack_bn(params["bn2"])
    y = torch.empty((bsz, t, f, co), dtype=dt, device=x.device)
    lib = _lib()
    rc = lib.vf_conv_block_res(
        x.data_ptr(), y.data_ptr(), w1.data_ptr(), w2.data_ptr(),
        wsc.data_ptr() if shortcut else None, s1.data_ptr(), t1.data_ptr(),
        s2.data_ptr(), t2.data_ptr(), bsz, t, f, ci, w1.shape[0] // 9, co,
        tm, float(slope), int(dt == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, rc, "conv_block_res")
    kernels.launches["conv_block_res"] += 1
    return y


def _lib():
    lib = build.load("convblock")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vf_conv_block_res.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i,
                                      i, i, i, f, i, p]
    lib.vf_conv_block_res.restype = i
    return lib
