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

The kernel reads (T, F) as one stream of T*(F + 1) rows. Each thread block
owns a run of consecutive rows of one batch row and walks it in steps over
two rings of rows in shared memory (a1 and a2), computing conv1's halo once
a run; ``plan_stream`` picks the product width, the step and the run from
the shared memory and the SM count, and ``walk`` gives the products a run
executes. The ResUNet routes a block here only on
request (``ops.precision.conv_block_kernel``) and only when ``eligible``
takes it: at most MAX_CHANNELS channels in and out, as in the JAX package,
and rings that fit a thread block's shared memory.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from voicefixer_tpu_torch import kernels
from voicefixer_tpu_torch.kernels import build
from voicefixer_tpu_torch.kernels.resstack import SMEM_LIMIT, _lrelu
from voicefixer_tpu_torch.ops.conv import conv2d
from voicefixer_tpu_torch.utils.weights import pack_bn

# widest block the kernel takes; wider ones stay on the library convolution
MAX_CHANNELS = 128
SMS = 132             # SMs of an H100 SXM: plan_stream's default
K_STEP = 16           # channels of a K step; Ci and Co are rounded up to it
F32_STAGES = 3        # of csrc/convblock.cu: the float32 weight ring
F32_ROWS = (8, 4)     # rows of a thread's float32 tile, preferred first
WG_ROWS = 64          # rows of a bfloat16 tile: one consumer warpgroup's
WG_G = 128            # rows of a bfloat16 pass: two warpgroups
WG_BK = 64            # K rows of a bfloat16 weight stage
WG_STAGES = (4, 8)    # weight ring stages wanted, at most
WG_MIN_STAGES = 2     # of csrc/convblock.cu: DEPTH stages in flight
WG_MAX_STEP = 16 * WG_G
# fixed cost of a product (copying a1 rows, barriers), in rows: a
# tie-break between plans of about the same executed rows
PRODUCT_ROWS = {4: 4, 2: 32}


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _ceil(a, b) * b


def product_width(co: int) -> int:
    """Columns of the kernel's product for Co output channels: 32, 64 or
    128, the padding columns zero weights."""
    return 32 if co <= 32 else 64 if co <= 64 else 128


def walk(s0: int, s1: int, f: int, bm: int, tile: int, front: int):
    """The products of the run [s0, s1), in csrc/convblock.cu's walk()
    order: ("conv1", q0, rows) computes a2 rows [q0, q0 + rows), ("conv2",
    q0, rows) output rows; rows are whole tiles, at most bm. conv1 starts
    front + hb rows before s0 (hb = F + 2, a tap's reach) and first covers
    the halo, up to s0 + hb; then each step computes the a2 rows its outputs
    below s1 read, and the outputs."""
    hb = f + 2
    a2_end = s0 - hb - front
    out = []
    while a2_end < s0 + hb:
        c1 = min(bm, _round_up(s0 + hb - a2_end, tile))
        out.append(("conv1", a2_end, c1))
        a2_end += c1
    y = s0
    while y < s1:
        c2 = min(bm, _round_up(s1 - y, tile))
        need = min(y + c2, s1) + hb
        if a2_end < need:
            c1 = min(bm, _round_up(need - a2_end, tile))
            out.append(("conv1", a2_end, c1))
            a2_end += c1
        out.append(("conv2", y, c2))
        y += c2
    return out


@dataclass(frozen=True)
class Plan:
    """How csrc/convblock.cu walks one block's stream of rows = T*(F + 1)
    rows a batch row: runs of ``run`` output rows, one a thread block, each
    walked (``walk``) in products of whole ``tile``-row tiles, at most
    ``bm`` rows, over the a1 and a2 rings of ``ring1`` and ``ring2`` rows."""
    np: int        # product columns
    cp1: int       # Ci rounded up to K_STEP
    cp2: int       # Co rounded up to K_STEP
    bm: int        # rows of a step
    tile: int      # rows of a product's granule
    front: int     # a2 rows computed before the halo
    ring1: int
    ring2: int
    run: int
    runs: int      # runs a batch row
    tr: int        # float32: rows of a thread's tile (0 in bfloat16)
    stages: int    # bfloat16: weight ring stages (0 in float32)
    smem: int      # bytes of dynamic shared memory
    f: int

    def products(self, length: int):
        return walk(0, length, self.f, self.bm, self.tile, self.front)

    def block_rows(self, rows: int) -> int:
        """Product rows the busiest thread block executes (the first run)."""
        return sum(r for _, _, r in self.products(min(self.run, rows)))

    def executed_flops(self, rows: int, shortcut: bool) -> int:
        """FLOPs the kernel runs over a batch row, discarded rows and
        padding included: conv1 (9 taps of cp1) and conv2 (9 taps of cp2,
        then the shortcut's cp1) at np columns; in bfloat16 a product's K
        is whole WG_BK-deep weight stages."""
        c1, c2 = self.executed_rows(rows)
        k1, k2 = 9 * self.cp1, 9 * self.cp2 + (self.cp1 if shortcut else 0)
        if self.stages:
            k1, k2 = _round_up(k1, WG_BK), _round_up(k2, WG_BK)
        return 2 * self.np * (c1 * k1 + c2 * k2)

    def executed_rows(self, rows: int) -> tuple:
        """(conv1, conv2) product rows summed over a batch row's runs."""
        last = rows - (self.runs - 1) * self.run
        out = [0, 0]
        for length, n in ((self.run, self.runs - 1), (last, 1)):
            for kind, _, r in self.products(length):
                out[kind == "conv2"] += n * r
        return tuple(out)


def rings(f: int, bm: int, tile: int, front: int) -> tuple:
    """(ring1, ring2): the a1 ring holds a step and a tap's reach a side;
    the a2 ring a step, a tap's reach behind it and the a2 rows conv1 has
    computed ahead of the outputs."""
    hb = f + 2
    return bm + 2 * hb, bm + _round_up(2 * hb + front, tile) - front


def f32_front(f: int, bm: int) -> int:
    """float32 conv1 starts this many rows early, so that the halo is a
    whole number of its bm-row tiles."""
    return _round_up(2 * (f + 2), bm) - 2 * (f + 2)


def f32_smem_bytes(np_: int, tr: int, cp1: int, cp2: int, f: int) -> int:
    """The float32 kernel's shared memory: the weight ring and the two
    rings of rows (K_STEP-rounded widths plus 4 floats)."""
    bm = tr * 2048 // np_
    r1, r2 = rings(f, bm, bm, f32_front(f, bm))
    return 4 * (F32_STAGES * K_STEP * np_ + r1 * (cp1 + 4) + r2 * (cp2 + 4))


def wgmma_smem_bytes(np_: int, bm: int, cp1: int, cp2: int, f: int,
                     stages: int) -> int:
    """The bfloat16 kernel's shared memory: alignment, the weight ring and
    its barriers, the two rings of rows (widths plus 8 bf16) and the folded
    batch norms (float32)."""
    r1, r2 = rings(f, bm, WG_ROWS, 0)
    return (1024 + stages * (WG_BK * np_ * 2 + 16)
            + 2 * (r1 * (cp1 + 8) + r2 * (cp2 + 8)) + 8 * (cp1 + cp2))


def _geometries(f: int, ci: int, co: int, itemsize: int):
    """(bm, tile, front, tr, stages, smem) of every layout that fits,
    preferred first."""
    np_ = product_width(co)
    cp1, cp2 = _round_up(ci, K_STEP), _round_up(co, K_STEP)
    out = []
    if itemsize == 4:
        for tr in F32_ROWS:
            smem = f32_smem_bytes(np_, tr, cp1, cp2, f)
            if smem <= SMEM_LIMIT:
                bm = tr * 2048 // np_
                out.append((bm, bm, f32_front(f, bm), tr, 0, smem))
        return out
    for want in (WG_STAGES[0], WG_MIN_STAGES):
        for bm in range(WG_MAX_STEP, 0, -WG_G):
            fixed = wgmma_smem_bytes(np_, bm, cp1, cp2, f, 0)
            stages = min(WG_STAGES[1],
                         (SMEM_LIMIT - fixed) // (WG_BK * np_ * 2 + 16))
            if stages >= want:
                out.append((bm, WG_ROWS, 0, 0, stages,
                            wgmma_smem_bytes(np_, bm, cp1, cp2, f, stages)))
        if out:
            return out
    return out


@functools.lru_cache(maxsize=256)
def plan_stream(t: int, f: int, ci: int, co: int, itemsize: int,
                batch: int = 1, run: int | None = None,
                bm: int | None = None, sms: int = SMS):
    """The kernel's plan for x [batch, t, f, ci] -> co channels of
    ``itemsize`` bytes on a card of ``sms`` SMs, or None when no layout
    fits. Among the layouts that fit and the run lengths, the least rows an
    SM executes in series (waves x the busiest block's product rows, plus
    PRODUCT_ROWS a product), then the longer step. ``run`` and ``bm`` force
    those choices (tools, tests)."""
    rows = t * (f + 1)
    np_ = product_width(co)
    cp1, cp2 = _round_up(ci, K_STEP), _round_up(co, K_STEP)
    best = None
    for step, tile, front, tr, stages, smem in _geometries(f, ci, co,
                                                          itemsize):
        if bm is not None and step != bm:
            continue
        if run is not None:
            cands = {run}
        else:  # per wave count, the shortest run that fills it
            cands = {rows}
            for waves in range(1, 9):
                per_row = sms * waves // batch
                if per_row >= 1:
                    cands.add(_ceil(rows, per_row))
                    cands.add(_round_up(_ceil(rows, per_row), step))
        for r in sorted(cands):
            p = Plan(np_, cp1, cp2, step, tile, front,
                     *rings(f, step, tile, front), r, _ceil(rows, r), tr,
                     stages, smem, f)
            prods = p.products(min(r, rows))
            cost = (_ceil(batch * p.runs, sms)
                    * sum(n + PRODUCT_ROWS[itemsize] for _, _, n in prods))
            key = (cost, -step, r)
            if best is None or key < best[0]:
                best = (key, p)
    return None if best is None else best[1]


def eligible(params: dict, x: torch.Tensor) -> bool:
    """True when the kernel takes this block: folded batch norms, 3x3
    convolutions, at most MAX_CHANNELS channels in and out (a multiple of 8
    out in bfloat16), float32 or bfloat16, and rings that fit."""
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
    return plan_stream(x.shape[1], x.shape[2], ci, co,
                       x.element_size()) is not None


def pack_weights(params: dict, dtype: torch.dtype, np_: int):
    """(w1, w2, bsc) as the kernel reads them: K rows (tap-major (dt, df),
    then channel, Ci and Co rounded up to K_STEP) by np_ output columns,
    zero past Ci, Co; the 1x1 shortcut as w2's last rows. float32 keeps
    [K, np_]; bfloat16 is transposed to [np_, K], K contiguous, for the
    TMA's K-major boxes. bsc is the shortcut's bias [Co] in dtype, or
    None."""
    co = params["conv1"]["w"].shape[3]

    def k_rows(w):
        cp = _ceil(w.shape[2], K_STEP) * K_STEP
        w = F.pad(w.to(dtype), (0, np_ - co, 0, cp - w.shape[2]))
        return w.reshape(-1, np_)

    w1 = k_rows(params["conv1"]["w"])
    w2 = k_rows(params["conv2"]["w"])
    bsc = None
    if "shortcut" in params:
        w2 = torch.cat([w2, k_rows(params["shortcut"]["w"])])
        bsc = params["shortcut"]["b"].to(dtype).contiguous()
    if dtype == torch.bfloat16:
        w1, w2 = w1.t(), w2.t()
    return w1.contiguous(), w2.contiguous(), bsc


DTYPE_KEYS = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def pack_operands(params: dict, dtype: torch.dtype) -> dict:
    """The block's operands as the kernel reads them in ``dtype``: "w1",
    "w2" and, with the shortcut, "bsc" from ``pack_weights`` at the
    product's width; "s1", "t1", "s2", "t2" the folded batch norms
    (float32)."""
    co = params["conv1"]["w"].shape[3]
    with torch.no_grad():
        w1, w2, bsc = pack_weights(params, dtype, product_width(co))
        s1, t1 = pack_bn(params["bn1"])
        s2, t2 = pack_bn(params["bn2"])
    out = {"w1": w1, "w2": w2, "s1": s1, "t1": t1, "s2": s2, "t2": t2}
    if bsc is not None:
        out["bsc"] = bsc
    return out


def operands(params: dict, dtype: torch.dtype) -> dict:
    """The operands that the parameters' owner packed once under "packed"
    (``models.resunet.pack_conv_blocks``), else ``pack_operands`` now."""
    done = params.get("packed", {}).get(DTYPE_KEYS[dtype])
    return done if done is not None else pack_operands(params, dtype)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """SMs of a CUDA device (the planner's run length and waves follow
    them); SMS elsewhere."""
    if device.type != "cuda":
        return SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    kernels.check_no_grad("conv_block_res", x, params)
    if not eligible(params, x):
        raise ValueError(
            f"conv_block_res: x {tuple(x.shape)} {x.dtype}, conv1 "
            f"{tuple(params['conv1']['w'].shape)}: not a block the kernel "
            f"takes (folded batch norms, 3x3, at most {MAX_CHANNELS} "
            "channels, float32 or bfloat16)")
    bsz, t, f, ci = x.shape
    co = params["conv1"]["w"].shape[3]
    plan = plan_stream(t, f, ci, co, x.element_size(), bsz,
                       sms=sm_count(x.device))
    y = launch(x, params, slope, plan)
    kernels.launches["conv_block_res"] += 1
    return y


def launch(x: torch.Tensor, params: dict, slope: float, plan: Plan,
           lib: ctypes.CDLL | None = None) -> torch.Tensor:
    """One launch of csrc/convblock.cu under ``plan`` (``conv_block_res``
    chooses it; tools time others, and copies of the library bound by
    ``bind``). Raises on a CUDA error."""
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    bsz, t, f, ci = x.shape
    co = params["conv1"]["w"].shape[3]
    dt = x.dtype
    ops = operands(params, dt)
    y = torch.empty((bsz, t, f, co), dtype=dt, device=x.device)
    lib = lib or _lib()
    rc = lib.vf_conv_block_res(
        x.data_ptr(), y.data_ptr(), ops["w1"].data_ptr(),
        ops["w2"].data_ptr(), ops["bsc"].data_ptr() if "bsc" in ops else None,
        *(ops[k].data_ptr() for k in ("s1", "t1", "s2", "t2")), bsz, t, f,
        ci, co, plan.np, plan.run, plan.bm, plan.tr, plan.stages,
        float(slope), int(dt == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, rc, "conv_block_res")
    return y


def _lib():
    return bind(build.load("convblock"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares vf_conv_block_res's arguments on a loaded library."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vf_conv_block_res.argtypes = [p] * 9 + [i] * 10 + [f, i, p]
    lib.vf_conv_block_res.restype = i
    return lib
