#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: build every kernel from
the sources in this checkout, hold each against its plain PyTorch version at
the shapes its path gives it, drive full-width mode-0 restore through
``VoiceFixer`` in parity and production precision, and check the output. The
nine kernels: stft_mel, gru_bidir, upsample, the vocoder's ResStack kernels
res_chain, res_shift_single and up_res_stream, and res_stream, gru_seq and
conv_block_res, each also timed against the library call (cuFFT, cuDNN) that
computes the same function and that the port does not use.

Four paths are driven, each with the launch counts set to 0 just before and
read and asserted just after: the default main path; the same restore with
the vocoder time-sharded four ways on the one card (res_stream, and
res_chain and res_shift_single under a signal window); the same restore with
the fused ConvBlockRes kernel opted in (conv_block_res); and a two-layer
unidirectional GRU (gru_seq).

    python3 chip_smoke.py
    python3 chip_smoke.py --cards N    # N >= 2 cards: only the sharded
                                       # path, shard i on card i, against
                                       # the unsharded restore on card 0

Needs one CUDA card and nvcc. Exits non-zero, printing no result, when there
is no card or a phase fails. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it is the card's name and
power limit, and the one before that the per-kernel JSON record. Every time
printed is measured in this run on this card.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

SEED = 0

# peak rates of one H100 SXM (NVIDIA data sheet, dense): float32 outside the
# tensor cores, bfloat16 tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

# file:line of the TPU kernel each CUDA kernel replaces
REPLACES = {
    "stft_mel": "voicefixer_tpu/kernels/stft.py:65",
    "gru_bidir": "voicefixer_tpu/kernels/gru.py:134",
    "upsample": "voicefixer_tpu/kernels/upsample.py:151",
    "res_chain": "voicefixer_tpu/kernels/resstack.py:293",
    "res_shift_single": "voicefixer_tpu/kernels/resstack.py:464",
    "up_res_stream": "voicefixer_tpu/kernels/resstream.py:552",
    "res_stream": "voicefixer_tpu/kernels/resstream.py:416",
    "gru_seq": "voicefixer_tpu/kernels/gru.py:193",
    "conv_block_res": "voicefixer_tpu/kernels/convblock.py:132",
}
SOURCES = {
    "stft_mel": "voicefixer_tpu_torch/csrc/stft_mel.cu",
    "gru_bidir": "voicefixer_tpu_torch/csrc/gru_bidir.cu",
    "upsample": "voicefixer_tpu_torch/csrc/upsample.cu",
    "res_chain": "voicefixer_tpu_torch/csrc/resstack_f32.cu",
    "res_shift_single": "voicefixer_tpu_torch/csrc/resstack_f32.cu",
    "up_res_stream": "voicefixer_tpu_torch/csrc/resstack_f32.cu",
    # walks its groups over the kernels of resstack_f32.cu and
    # resstack_wgmma.cu (kernels/resstack.py's entry points)
    "res_stream": "voicefixer_tpu_torch/kernels/resstream.py",
    "gru_seq": "voicefixer_tpu_torch/csrc/gru_bidir.cu",
    "conv_block_res": "voicefixer_tpu_torch/csrc/convblock.cu",
}
# a kernel whose bfloat16 path has a source of its own
SOURCES_BF16 = {
    "res_chain": "voicefixer_tpu_torch/csrc/resstack_wgmma.cu",
    "res_shift_single": "voicefixer_tpu_torch/csrc/resstack_wgmma.cu",
    "up_res_stream": "voicefixer_tpu_torch/csrc/resstack_wgmma.cu",
}
KERNELS = tuple(SOURCES)
# slopes of the vocoder's LeakyReLUs: inside a ResStack, after a stage
SLOPE_RES, SLOPE_ACT = 0.01, 0.2
SHARDS = 4          # time shards of the sharded vocoder path, on the one card
GRU_FRAMES = 3001   # STFT frames of a 30 s chunk
# The sharded path against the unsharded one on the same weights. float32:
# a shard's kernels sum every element in the unsharded kernels' order (a
# tile's position does not change a K loop), but the shards' upsamples are
# float32 matrix products where the unsharded path runs its own kernels,
# so sums differ in their order (about 1e-7 relative) and travel through
# four stages of 8 blocks; the JAX package's tests hold 2e-5 at 32 channels
# and 4 blocks. On a waveform in [-1, 1]:
SHARD_ATOL = 1e-3
# The fused ConvBlockRes path against the library convolutions, float32:
# 24 blocks summed in another order, then the whole vocoder.
CONVBLOCK_ATOL = 1e-3
# Production against parity. bench.py's end-to-end floor (SNR_FLOOR_E2E,
# bench.py:149) was met by the JAX package's own weight draw. The same
# precision policy gives from about 30 to 41 dB over other random draws, in
# the JAX package and the port alike, and the port matches the JAX package
# on the JAX package's weights (tools/snr_draws.py). This script's draw
# does not meet it, and the line says so. What fails the run: the card's
# SNR more than SNR_MATCH_DB from the SNR of the plain versions on the CPU
# for the same weights and input, or the 30 s chunk under SNR_FLOOR_DB, a
# guard against regressions 3 dB under the lowest draw measured.
BENCH_SNR_DB = 35.0
SNR_FLOOR_DB = 27.5
SNR_MATCH_DB = 1.0
SNR_SECONDS = 2  # the CPU side runs the full-width plain path


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn over reps calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, group: str | None = None,
              per_call: int | None = None) -> float:
    """Mean device time of one call of fn after a warm-up (torch.profiler
    over reps calls): of its kernels of one ``_kernel_group``, or of all.
    Unlike cuda_ms it leaves out the host's time between launches, which
    sets the pace of a call whose kernels take less time than its Python.
    A profile may come back without some of the kernels' events (one that
    saw none is taken again): with ``per_call``, the group's launches in
    one call, the time is the mean of the launches seen times per_call."""
    fn()
    for _ in range(3):
        rows = [(t, n) for name, t, n in
                _device_kernels(lambda: [fn() for _ in range(reps)])
                if group is None or _kernel_group(name) == group]
        launched = sum(n for _, n in rows)
        if not launched:
            continue
        if not per_call:
            return sum(t for t, _ in rows) / reps
        if launched != reps * per_call:
            log(f"  (the profile saw {launched} of {reps * per_call} "
                f"launches of {group}: their mean)")
        return sum(t for t, _ in rows) / launched * per_call
    raise AssertionError(f"three profiles saw no device time of "
                         f"{group or 'any kernel'}")


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# The least work of each kernel's function, (FLOPs, bytes), each input read
# once and each output written once.

def stft_work(n: int, t: int, n_fft: int, n_freqs: int, n_mels: int,
              fb_nnz: int):
    """STFT -> magnitude -> mel of an n-sample float32 wave into t frames, as
    an FFT computes it: a real FFT of n_fft points per frame (2.5 n log2 n
    FLOPs), the magnitude of each bin, and the mel product over the fb_nnz
    entries of this run's filterbank that are not zero (a triangular
    filterbank has about two a frequency bin, a dense one n_freqs * n_mels).
    The plain version's dense DFT and dense mel product are far more."""
    flops = (t * 2.5 * n_fft * math.log2(n_fft) + 4 * t * n_freqs
             + 2 * t * fb_nnz)
    return flops, 4 * (n + n_freqs * n_mels + t * n_mels)


def gru_work(t: int, h: int, w_size: int, directions: int = 2):
    """One GRU layer over t steps, both directions unless told otherwise:
    float32 projections in, h·W_hh and the gates per step, float32 states
    out."""
    flops = directions * t * (2 * h * 3 * h + 12 * h)
    return flops, directions * (4 * (t * 3 * h + 3 * h + t * h)
                                + h * 3 * h * w_size)


def upsample_work(t: int, s: int, cin: int, cout: int, size: int):
    """x + sin(x), then a ConvTranspose1d of kernel 2s and stride s: two
    taps of Cin x Cout per output sample."""
    return (2 * t * s * 2 * cin * cout,
            size * (t * cin + 2 * s * cin * cout + cout + t * s * cout))


def res_work(ch: int, t: int, n_blocks: int, size: int):
    """n consecutive ResStack blocks (two k=3 convs of C x C each) on
    [t, C]: the signal read once and written once, the weights read once."""
    return (n_blocks * 12 * ch * ch * t,
            size * (2 * t * ch + n_blocks * 2 * (3 * ch * ch + ch)))


def res_executed_flops(ch: int, t: int, dils, tm, itemsize: int) -> int:
    """FLOPs that one ResStack launch runs on [1, t, ch] (a chain over
    ``dils`` at tile ``tm``, or a single block, tm None), discarded rows
    and padding included. A chain computes block i's h over tm + 2*E[i+1] +
    2 rows and its output over tm + 2*E[i+1]. float32
    (csrc/resstack_f32.cu): every product is BM-row tiles
    (``resstack.f32_tile``) of 6*C^2 FLOP a row; a single block computes h
    over BM rows for BM - 2 output rows. bfloat16 (csrc/resstack_wgmma.cu):
    64-row wgmma tiles of N = C rounded up to 64 (256-column chunks above
    128 channels), K per tap likewise, the busy warpgroups' only; a single
    block as ``resstack.wgmma_shift_executed_flops`` counts it."""
    from voicefixer_tpu_torch.kernels import resstack
    if itemsize == 4:
        bm = resstack.f32_tile(ch)[0]
        per_row = 6 * ch * ch * bm
        if tm is None:
            return -(-t // (bm - 2)) * 2 * per_row
        tiles = sum(-(-(tm + 2 * eo + k) // bm)
                    for eo in resstack.chain_extents(dils)[1:]
                    for k in (2, 0))
        return -(-t // tm) * tiles * per_row
    if tm is None:
        return resstack.wgmma_shift_executed_flops(ch, t)
    bm, kp = resstack.WG_ROWS, -(-ch // 64) * 64
    n = -(-ch // resstack.wg_cols(ch)) * resstack.wg_cols(ch)
    conv_rows = sum(-(-(tm + 2 * eo + k) // bm) * bm
                    for eo in resstack.chain_extents(dils)[1:]
                    for k in (2, 0))
    return -(-t // tm) * conv_rows * 2 * 3 * kp * n


def up_res_executed_flops(cin: int, cout: int, s: int, t_in: int,
                          itemsize: int) -> int:
    """FLOPs that up_res_stream's kernels run on [1, t_in, cin] -> [1,
    t_in*s, cout] (``resstream.up_plan``), discarded rows and padding
    included. The first group: per time tile, its upsample's rows q of the
    slab (per phase whole tiles of rows q, K = 2 * Cin, rounded up to 64 in
    bfloat16) and its blocks' halo recompute; every group's blocks as
    ``res_executed_flops`` counts them."""
    from voicefixer_tpu_torch.kernels import resstack, resstream
    dils = resstack.stack_dilations(8)
    t = t_in * s
    pad = s // 2 + s % 2
    groups = resstream.up_plan(cin, cout, s, dils, itemsize)
    if itemsize == 4:
        bm, n, kin = resstack.f32_tile(cout)[0], cout, cin
    else:
        bm, n = resstack.WG_ROWS, resstack.wg_cols(cout)
        kin = -(-cin // 64) * 64
    total = 0
    for i0, i1, tm in groups:
        total += res_executed_flops(cout, t, dils[i0:i1], tm, itemsize)
        if i0 == 0:
            ext = resstack.chain_extents(dils[i0:i1])
            for j in range(-(-t // tm)):
                slab0 = j * tm - ext[0]
                q_lo = (slab0 + pad) // s
                nq = (slab0 + tm + 2 * ext[0] - 1 + pad) // s - q_lo + 1
                total += s * -(-nq // bm) * bm * 2 * 2 * kin * n
    return total


def conv_block_executed_flops(t: int, f: int, ci: int, co: int,
                              itemsize: int, batch: int = 1,
                              sms: int | None = None) -> int:
    """FLOPs that the ConvBlockRes kernel (csrc/convblock.cu) runs on
    [batch, t, f, ci] on a card of ``sms`` SMs (default
    ``kernels.convblock.SMS``), discarded rows and padding included: conv1
    over each run's halo and steps (9 taps of Ci rounded up to 16), conv2
    and the shortcut's K rows over the steps, every product at the width
    rounded up to 32, 64 or 128 columns, in bfloat16 its K to whole weight
    stages (``kernels.convblock.plan_stream``, ``Plan.executed_flops``)."""
    from voicefixer_tpu_torch.kernels import convblock
    p = convblock.plan_stream(t, f, ci, co, itemsize, batch,
                              sms=sms or convblock.SMS)
    return batch * p.executed_flops(t * (f + 1), ci != co)


def chain_weight_bytes(ch: int, t: int, dils, tm: int) -> int:
    """Weight bytes that a bfloat16 chain reads from L2 over a [1, t, ch]
    signal: every thread block streams the 3*C^2 bytes of each convolution
    once per pass of the bfloat16 wgmma kernel
    (``resstack.wgmma_passes``)."""
    from voicefixer_tpu_torch.kernels import resstack
    return (-(-t // tm) * resstack.wgmma_passes(ch, dils, tm) * 3 * ch * ch
            * 2)


def up_res_work(t: int, s: int, cin: int, cout: int, n_blocks: int,
                size: int):
    """The upsample fused with n blocks: the upsampled signal is neither
    written by the one nor read by the other."""
    fl, by = res_work(cout, t * s, n_blocks, size)
    up_fl, up_by = upsample_work(t, s, cin, cout, size)
    return fl + up_fl, by + up_by - 2 * size * t * s * cout


def conv_block_work(t: int, f: int, ci: int, co: int, size: int):
    """One ConvBlockRes on [t, f, ci]: two folded batch norms with
    LeakyReLU, a 3x3 convolution ci -> co and one co -> co, and the 1x1
    shortcut where ci != co; x read once, the output written once."""
    sc = ci != co
    return (t * f * (2 * 9 * co * (ci + co) + (2 * ci * co if sc else 0)
                     + 4 * (ci + co)),
            size * (t * f * (ci + co) + 9 * co * (ci + co)
                    + ((ci + 1) * co if sc else 0)) + 8 * (ci + co))


def conv_block_shapes() -> dict:
    """{(t, f, ci, co): blocks} of the ResUNet blocks of one full-width 30 s
    chunk that the fused kernel takes, from the model's channel plan and
    ``kernels.convblock.MAX_CHANNELS``."""
    from voicefixer_tpu_torch.config import DEFAULT_CONFIG as C
    from voicefixer_tpu_torch.kernels.convblock import MAX_CHANNELS
    from voicefixer_tpu_torch.models.resunet import _channel_plan
    u = C.unet
    enc, dec = _channel_plan(u)
    t0 = -(-GRU_FRAMES // u.downsample_ratio) * u.downsample_ratio
    f0 = C.mel.n_mels - 1
    blocks = []  # (level, ci, co)
    for lvl, (ci, co) in enumerate(enc):
        blocks += [(lvl, ci, co)] + [(lvl, co, co)] * (u.blocks_per_stage - 1)
    for i, (ci, co) in enumerate(dec):
        lvl = u.levels - 1 - i
        blocks += [(lvl, 2 * co, co)] + [(lvl, co, co)] * (u.blocks_per_stage
                                                           - 1)
    blocks.append((0, enc[0][1], enc[0][1]))  # after1
    shapes: dict = {}
    for lvl, ci, co in blocks:
        if ci <= MAX_CHANNELS and co <= MAX_CHANNELS:
            key = (t0 >> lvl, f0 >> lvl, ci, co)
            shapes[key] = shapes.get(key, 0) + 1
    return shapes


def expected_launches(size: int, shards: int = 1,
                      conv_blocks: bool = False) -> dict:
    """Launches of each kernel per batch of full-width mode-0 restore at an
    activation size of ``size`` bytes, from the vocoder's dispatch rule and
    the ResStack planner. With ``shards`` > 1 the vocoder runs time-sharded:
    no upsample kernel (the shards' upsamples are matrix products), the
    narrow stages one res_stream a shard, the wide ones the planner's
    launches a shard. With ``conv_blocks`` the ResUNet's eligible blocks go
    to conv_block_res. Checks that the ResStack kernels cover every block."""
    from voicefixer_tpu_torch.config import DEFAULT_CONFIG as C
    from voicefixer_tpu_torch.kernels.resstack import (plan_stack,
                                                       stack_dilations)
    from voicefixer_tpu_torch.models.vocoder import FUSE_MAX_CHANNELS
    v = C.vocoder
    want = dict.fromkeys(KERNELS, 0)
    want["stft_mel"], want["gru_bidir"] = 1, 4
    if conv_blocks:
        want["conv_block_res"] = sum(conv_block_shapes().values())
    blocks = 0
    for i, depth in enumerate(v.resstack_depth):
        cout = v.channels // 2 ** (i + 1)
        if cout <= FUSE_MAX_CHANNELS:
            want["res_stream" if shards > 1 else "up_res_stream"] += shards
            blocks += depth
            continue
        if shards == 1:
            want["upsample"] += 1
        for i0, i1, tm in plan_stack(cout, stack_dilations(depth), size):
            want["res_chain" if tm is not None
                 else "res_shift_single"] += shards
            blocks += i1 - i0
    if blocks != sum(v.resstack_depth):
        raise AssertionError(f"the plan leaves a block out: {want}, "
                             f"{blocks} blocks")
    return want


def shard_shape(stage: int):
    """(rows, (lo, hi)) of the last shard's [halo | samples | halo] array
    after stage ``stage`` of the SHARDS-way vocoder on a 30 s chunk, as
    ``parallel.sp.apply_sp`` forms it: its window ends inside the array."""
    from voicefixer_tpu_torch.config import DEFAULT_CONFIG as C
    from voicefixer_tpu_torch.kernels.resstack import stack_dilations
    v = C.vocoder
    t0 = GRU_FRAMES + GRU_FRAMES % 2 + 4   # frames after the tail pad
    t_loc, rate = -(-t0 // SHARDS), 1
    for s in v.upsample_scales[:stage + 1]:
        t_loc, rate = t_loc * s, rate * s
    h = -(-sum(d + 1 for d in stack_dilations(v.resstack_depth[stage]))
          // 8) * 8
    lo = h - (SHARDS - 1) * t_loc
    return t_loc + 2 * h, (lo, lo + t0 * rate)


def compare(name, got, ref, rtol, atol, chained=0):
    """Max abs error; raises when |got - ref| > atol + rtol*|ref| anywhere.
    ``chained``: bfloat16 through that many ResStack blocks in one call,
    where one ulp of an intermediate (of magnitude up to max|ref|) travels
    along the residual path into outputs of any magnitude: at most 0.5 % of
    the elements per block may miss atol + rtol*|ref|, and none
    2^-7*max|ref| + rtol*|ref|."""
    import torch
    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - ref).abs()
    if chained:
        share = float((err > atol + rtol * ref.abs()).float().mean())
        if share > 0.005 * chained:
            raise AssertionError(f"{name}: {share:.4f} of the elements miss "
                                 f"{atol:.1e} + {rtol:.1e}*|ref|")
        atol = 2 ** -7 * float(ref.abs().max())
    worst = float((err - rtol * ref.abs()).max())
    max_err = float(err.max())
    ok = worst <= atol
    log(f"  {name}: max_abs_err={max_err:.3e} (max |ref| "
        f"{float(ref.abs().max()):.3e}; tol atol {atol:.1e} + rtol "
        f"{rtol:.1e}*|ref|) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return max_err


def phase_card():
    import torch
    log("== card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"  {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    return card


def phase_build():
    from voicefixer_tpu_torch.kernels import build
    log("== build")
    t0 = time.perf_counter()
    took = build.build_all()
    log(f"  built {sorted(took) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s (nvcc in parallel)")
    for name in build.SOURCES:
        build.load(name)
        report = (build.BUILD / f"{name}.log")
        if report.exists():
            for line in report.read_text().splitlines():
                if any(k in line for k in ("registers", "spill",
                                           "Performance", "wgmma")):
                    log(f"  {name}: {line.strip()}")


def _stft_case(gen, device, small=None):
    """The 30 s chunk through the model's own STFT; ``small`` = (n_fft, hop,
    win_length, n_mels, samples, batch): checked and not timed."""
    import torch
    from voicefixer_tpu_torch.config import DEFAULT_CONFIG as C
    from voicefixer_tpu_torch.config import STFTConfig
    from voicefixer_tpu_torch.kernels import stft
    from voicefixer_tpu_torch.models.analysis import mel_fbank
    from voicefixer_tpu_torch.ops.mel import melscale_fbanks
    from voicefixer_tpu_torch.ops.stft import num_frames
    if small is None:
        cfg, n, batch = C.stft, C.pipeline.seg_length, 1
        fb = mel_fbank(C, device)
    else:
        n_fft, hop, win_length, n_mels, n, batch = small
        cfg = STFTConfig(n_fft=n_fft, hop_length=hop, win_length=win_length)
        fb = torch.as_tensor(melscale_fbanks(
            cfg.n_freqs, C.mel.f_min, C.mel.f_max, n_mels,
            C.mel.sample_rate), device=device)
    wav = (0.1 * torch.randn((batch, n), generator=gen)).to(device)
    t = num_frames(n, cfg)
    flops, work_bytes = stft_work(n, t, cfg.n_fft, cfg.n_freqs, fb.shape[1],
                                  int((fb != 0).sum()))
    fn = lambda: stft.stft_mel(wav, fb, cfg)  # noqa: E731
    plain = lambda: stft.stft_mel_reference(wav, fb, cfg)  # noqa: E731
    win = torch.hann_window(cfg.win_length, periodic=True, device=device)

    def library():
        spec = torch.stft(wav, cfg.n_fft, cfg.hop_length, cfg.win_length,
                          window=win, center=True, pad_mode="reflect",
                          return_complex=True)
        return spec.abs().transpose(1, 2) @ fb

    # the plain version's dense float32 DFT of n_fft taps carries more
    # rounding error than the FFT: the difference is the plain version's own
    return {"name": "stft_mel", "dtype": "float32",
            "main_path": small is None,
            "shape": f"wav [{batch}, {n}] n_fft {cfg.n_fft} hop "
                     f"{cfg.hop_length} window {cfg.win_length} -> "
                     f"[{batch}, {t}, {fb.shape[1]}]",
            "fn": fn, "plain": plain, "library": library, "reps": 20,
            "rtol": 1e-4, "atol": 1e-3, "per_chunk": 1,
            "bytes": work_bytes, "flops": flops, "peak": PEAK_FP32}


def _gru_case(gen, device, dtype):
    import torch
    from voicefixer_tpu_torch.config import DEFAULT_CONFIG as C
    from voicefixer_tpu_torch.kernels import gru
    h = C.denoiser.base_width
    t = 3001
    bound = 1 / h ** 0.5
    u = lambda *s: ((torch.rand(s, generator=gen) * 2 - 1) * bound  # noqa: E731
                    ).to(device)
    x = torch.randn((1, t, 2 * h), generator=gen).to(device)
    w_ih, w_ih_b = u(3 * h, 2 * h), u(3 * h, 2 * h)
    w_hh, w_hh_b = u(3 * h, h), u(3 * h, h)
    b_ih, b_ih_b, b_hh, b_hh_b = u(3 * h), u(3 * h), u(3 * h), u(3 * h)
    xf, xb = x @ w_ih.T + b_ih, x @ w_ih_b.T + b_ih_b
    wf, wb = w_hh.T.contiguous(), w_hh_b.T.contiguous()
    mm = getattr(torch, dtype)
    fn = lambda: gru.gru_bidir(xf, xb, wf, wb, b_hh, b_hh_b, mm)  # noqa: E731
    plain = lambda: gru.gru_bidir_reference(  # noqa: E731
        xf, xb, wf, wb, b_hh, b_hh_b, mm)
    lib_gru = torch.nn.GRU(2 * h, h, batch_first=True, bidirectional=True
                           ).to(device=device, dtype=mm)
    with torch.no_grad():
        for p, v in ((lib_gru.weight_ih_l0, w_ih), (lib_gru.weight_hh_l0, w_hh),
                     (lib_gru.bias_ih_l0, b_ih), (lib_gru.bias_hh_l0, b_hh),
                     (lib_gru.weight_ih_l0_reverse, w_ih_b),
                     (lib_gru.weight_hh_l0_reverse, w_hh_b),
                     (lib_gru.bias_ih_l0_reverse, b_ih_b),
                     (lib_gru.bias_hh_l0_reverse, b_hh_b)):
            p.copy_(v)
    x_lib = x.to(mm)

    def library():
        with torch.no_grad():
            return lib_gru(x_lib)[0]

    flops, work_bytes = gru_work(t, h, 2 if dtype == "bfloat16" else 4)
    return {"name": "gru_bidir", "dtype": dtype, "shape": f"x [1, {t}, {3 * h}]",
            "fn": fn, "plain": plain, "library": library, "reps": 3,
            "pair": True, "steps": t, "device": True,
            "device_group": "K6 gru_bidir", "device_launches": 1,
            "rtol": 1e-4 if dtype == "float32" else 2e-2,
            "atol": 1e-4 if dtype == "float32" else 2e-2,
            "per_chunk": 4, "bytes": work_bytes, "flops": flops,
            "peak": PEAK_FP32 if dtype == "float32" else PEAK_BF16}


def _gru_seq_case(gen, device, reverse, batch, per_chunk):
    """One direction at the denoiser's width; per_chunk 0: checked and
    timed, not a launch of the unidirectional path."""
    import torch
    from voicefixer_tpu_torch.config import DEFAULT_CONFIG as C
    from voicefixer_tpu_torch.kernels import gru
    h, t, cin = C.denoiser.base_width, GRU_FRAMES, 128
    bound = 1 / h ** 0.5
    u = lambda *s: ((torch.rand(s, generator=gen) * 2 - 1) * bound  # noqa: E731
                    ).to(device)
    x = torch.randn((batch, t, cin), generator=gen).to(device)
    w_ih, w_hh, b_ih, b_hh = u(3 * h, cin), u(3 * h, h), u(3 * h), u(3 * h)
    xp = x @ w_ih.T + b_ih
    w_t = w_hh.T.contiguous()
    lib_gru = torch.nn.GRU(cin, h, batch_first=True).to(device)
    with torch.no_grad():
        for p, v in ((lib_gru.weight_ih_l0, w_ih), (lib_gru.weight_hh_l0, w_hh),
                     (lib_gru.bias_ih_l0, b_ih), (lib_gru.bias_hh_l0, b_hh)):
            p.copy_(v)
    x_lib = x.flip(1) if reverse else x

    def library():
        with torch.no_grad():
            return lib_gru(x_lib)[0]

    flops, work_bytes = gru_work(t, h, 4, directions=1)
    return {"name": "gru_seq", "dtype": "float32",
            "shape": f"x [{batch}, {t}, {3 * h}] reverse={reverse}",
            "fn": lambda: gru.gru_seq(xp, w_t, b_hh, reverse),
            "plain": lambda: gru.gru_seq_reference(xp, w_t, b_hh, reverse),
            "library": library, "reps": 3, "rtol": 1e-4, "atol": 1e-4,
            "per_chunk": per_chunk, "main_path": batch == 1, "steps": t,
            "device": True, "device_group": "K8 gru_seq",
            "device_launches": 1,
            "bytes": batch * work_bytes, "flops": batch * flops,
            "peak": PEAK_FP32}


def _upsample_case(gen, device, dtype, stage, t, small=None):
    """Stage ``stage`` of the vocoder at t input rows; ``small`` = (scale,
    Cin, Cout, batch) instead of a stage: checked and not timed."""
    import torch
    import torch.nn.functional as F
    from voicefixer_tpu_torch.config import DEFAULT_CONFIG as C
    from voicefixer_tpu_torch.kernels import upsample
    v = C.vocoder
    if small is None:
        s, batch = v.upsample_scales[stage], 1
        cin, cout = v.channels // 2 ** stage, v.channels // 2 ** (stage + 1)
        what = f"stage {stage}"
    else:
        s, cin, cout, batch = small
        what = f"scale {s}"
    dt = getattr(torch, dtype)
    bound = (1 / (cin * 2 * s)) ** 0.5
    x = torch.randn((batch, t, cin), generator=gen).to(device, dt)
    w = ((torch.rand((2 * s, cin, cout), generator=gen) * 2 - 1) * bound
         ).to(device, dt)
    b = (0.01 * torch.randn((cout,), generator=gen)).to(device, dt)
    fn = lambda: upsample.upsample(x, w, b, s)  # noqa: E731
    plain = lambda: upsample.upsample_reference(x, w, b, s)  # noqa: E731
    x_ncw = x.transpose(1, 2).contiguous()
    w_t = w.permute(1, 2, 0).contiguous()  # torch [Cin, Cout, K]
    pad = s // 2 + s % 2

    def library():
        return F.conv_transpose1d(x_ncw + torch.sin(x_ncw), w_t, b, stride=s,
                                  padding=pad, output_padding=s % 2)

    flops, work_bytes = upsample_work(t, s, cin, cout, x.element_size())
    # bfloat16: outputs are rounded once, so the two sides may differ by one
    # bfloat16 ulp (2^-8 relative) where their float32 sums straddle a
    # rounding boundary
    return {"name": "upsample", "dtype": dtype, "main_path": small is None,
            "shape": f"{what}: [{batch}, {t}, {cin}] -> [{batch}, {t * s}, "
                     f"{cout}]",
            "fn": fn, "plain": plain, "library": library, "reps": 10,
            "rtol": 1e-4 if dtype == "float32" else 2 ** -7,
            "atol": 1e-4 if dtype == "float32" else 1e-3,
            "per_chunk": 1, "bytes": work_bytes, "flops": flops,
            "peak": PEAK_FP32 if dtype == "float32" else PEAK_BF16}


def _bank(gen, n, ch, device, dt):
    """(w1s, b1s, w2s, b2s) of n random ResStack blocks at width ch."""
    import torch
    bound = (1 / (3 * ch)) ** 0.5
    w = lambda: ((torch.rand((n, 3, ch, ch), generator=gen) * 2 - 1)  # noqa: E731
                 * bound).to(device, dt)
    b = lambda: (0.01 * torch.randn((n, ch), generator=gen)  # noqa: E731
                 ).to(device, dt)
    return w(), b(), w(), b()


def _cudnn_blocks(x, bank, dils, final_slope):
    """The ResStack blocks as the port ran them before it had kernels for
    them: leaky_relu, a dilated cuDNN convolution, leaky_relu, a cuDNN
    convolution, add. The yardstick only."""
    import torch.nn.functional as F
    from voicefixer_tpu_torch.ops.conv import conv1d
    w1s, b1s, w2s, b2s = bank
    for i, d in enumerate(dils):
        h = conv1d(F.leaky_relu(x, SLOPE_RES), w1s[i], b1s[i], padding=d,
                   dilation=d)
        x = x + conv1d(F.leaky_relu(h, SLOPE_RES), w2s[i], b2s[i], padding=1)
    return x if final_slope is None else F.leaky_relu(x, final_slope)


def _res_tol(dtype, chained):
    """float32: sums in another order over up to eight chained blocks.
    bfloat16: one ulp (2^-8 relative) where the float32 sums straddle a
    rounding boundary; see compare() for chained blocks."""
    if dtype == "float32":
        return {"rtol": 1e-4, "atol": 1e-4}
    return {"rtol": 2 ** -7, "atol": 1e-3, "chained": chained}


def _res_cases(gen, device, dtype, ch, t, main_path=True, bounds=None):
    """One case per launch that ``res_stack`` makes on a [1, t, ch] stage;
    with ``bounds`` under that signal window, as a time shard runs them."""
    import torch
    from voicefixer_tpu_torch.kernels import resstack
    dt = getattr(torch, dtype)
    dils = resstack.stack_dilations(8)
    x = torch.randn((1, t, ch), generator=gen).to(device, dt)
    bank = _bank(gen, 8, ch, device, dt)
    cases = []
    for i0, i1, tm in resstack.plan_stack(ch, dils, x.element_size()):
        fs = SLOPE_ACT if i1 == 8 else None
        name_note = ""
        sub, d = tuple(v[i0:i1] for v in bank), dils[i0:i1]
        if tm is None:
            one = tuple(v[0] for v in sub)
            name = "res_shift_single"
            fn = lambda one=one, d=d, fs=fs: resstack.res_shift_single(  # noqa: E731
                x, *one, d[0], SLOPE_RES, fs, bounds)
            plain = lambda one=one, d=d, fs=fs: (  # noqa: E731
                resstack.res_shift_single_reference(x, *one, d[0], SLOPE_RES,
                                                    fs, bounds))
        else:
            name = "res_chain"
            fn = lambda sub=sub, d=d, fs=fs, tm=tm: resstack.res_chain(  # noqa: E731
                x, *sub, d, SLOPE_RES, fs, tm=tm, mask_bounds=bounds)
            plain = lambda sub=sub, d=d, fs=fs: resstack.res_chain_reference(  # noqa: E731
                x, *sub, d, SLOPE_RES, fs, bounds)
            if dtype == "bfloat16":
                name_note = (f" tile {tm}, weights from L2 "
                             f"{chain_weight_bytes(ch, t, d, tm) / 1e9:.3f} GB")
        library = lambda sub=sub, d=d, fs=fs: _cudnn_blocks(x, sub, d, fs)  # noqa: E731
        flops, work_bytes = res_work(ch, t, i1 - i0, x.element_size())
        cases.append({
            "name": name, "dtype": dtype, "main_path": main_path,
            "shape": f"[1, {t}, {ch}] dilations {d}"
                     + (f" window {bounds}" if bounds else "") + name_note,
            "executed": res_executed_flops(ch, t, d, tm, x.element_size()),
            "fn": fn,
            "plain": plain, "library": library, "reps": 3, "per_chunk": 1,
            "device": True,
            **_res_tol(dtype, i1 - i0 if i1 - i0 > 1 else 0), "bytes": work_bytes,
            "flops": flops,
            "peak": PEAK_FP32 if dtype == "float32" else PEAK_BF16})
    return cases


def _up_res_case(gen, device, dtype, cin, cout, s, t, main_path=True):
    import torch
    import torch.nn.functional as F
    from voicefixer_tpu_torch.kernels import resstack, resstream
    dt = getattr(torch, dtype)
    dils = resstack.stack_dilations(8)
    x = torch.randn((1, t, cin), generator=gen).to(device, dt)
    bound = (1 / (cin * 2 * s)) ** 0.5
    w = ((torch.rand((2 * s, cin, cout), generator=gen) * 2 - 1) * bound
         ).to(device, dt)
    b = (0.01 * torch.randn((cout,), generator=gen)).to(device, dt)
    bank = _bank(gen, 8, cout, device, dt)
    args = (x, w, b, *bank, dils, s, SLOPE_RES, SLOPE_ACT)
    w_t = w.permute(1, 2, 0).contiguous()  # torch [Cin, Cout, K]
    pad = s // 2 + s % 2

    def library():
        x_ncw = x.transpose(1, 2)
        u = F.conv_transpose1d(x_ncw + torch.sin(x_ncw), w_t, b, stride=s,
                               padding=pad, output_padding=s % 2)
        return _cudnn_blocks(u.transpose(1, 2), bank, dils, SLOPE_ACT)

    groups = resstream.up_plan(cin, cout, s, dils, x.element_size())
    writes, reads = resstream.passes(groups)
    flops, work_bytes = up_res_work(t, s, cin, cout, 8, x.element_size())
    return {"name": "up_res_stream", "dtype": dtype, "main_path": main_path,
            "shape": f"[1, {t}, {cin}] -> [1, {t * s}, {cout}], groups "
                     f"{list(groups)}: the full-rate signal is "
                     f"written {writes}x and read {reads}x",
            "executed": up_res_executed_flops(cin, cout, s, t,
                                              x.element_size()),
            "fn": lambda: resstream.up_res_stream(*args),
            "plain": lambda: resstream.up_res_stream_reference(*args),
            "library": library, "reps": 3, "per_chunk": 1, "device": True,
            "split": True,
            **_res_tol(dtype, 8), "bytes": work_bytes, "flops": flops,
            "peak": PEAK_FP32 if dtype == "float32" else PEAK_BF16}


def _res_stream_case(gen, device, dtype, ch, t, bounds=None, per_chunk=0,
                     main_path=True):
    """The whole eight-block stack in one call; per_chunk: launches at this
    shape on the sharded path (0: timed, not in the kernel record)."""
    import torch
    from voicefixer_tpu_torch.kernels import resstack, resstream
    dt = getattr(torch, dtype)
    dils = resstack.stack_dilations(8)
    x = torch.randn((1, t, ch), generator=gen).to(device, dt)
    bank = _bank(gen, 8, ch, device, dt)
    args = (x, *bank, dils, SLOPE_RES, SLOPE_ACT, bounds)

    def library():
        y = x
        if bounds is not None:
            y = torch.zeros_like(x)
            y[:, max(bounds[0], 0):bounds[1]] = x[:, max(bounds[0], 0):bounds[1]]
        return _cudnn_blocks(y, bank, dils, SLOPE_ACT)

    groups = resstack.plan_stack(ch, dils, x.element_size())
    # the window's rows only are work: the rest is written as zeros
    t_work = t if bounds is None else min(bounds[1], t) - max(bounds[0], 0)
    flops, work_bytes = res_work(ch, t_work, 8, x.element_size())
    work_bytes += x.element_size() * (t - t_work) * ch
    return {"name": "res_stream", "dtype": dtype, "main_path": main_path,
            "shape": f"[1, {t}, {ch}] window {bounds}, groups "
                     f"{list(groups)}",
            "executed": sum(res_executed_flops(ch, t, dils[i0:i1], tm,
                                               x.element_size())
                            for i0, i1, tm in groups),
            "fn": lambda: resstream.res_stream(*args),
            "plain": lambda: resstream.res_stream_reference(*args),
            "library": library, "reps": 3, "per_chunk": per_chunk,
            "device": True, "split": True,
            **_res_tol(dtype, 8), "bytes": work_bytes, "flops": flops,
            "peak": PEAK_FP32 if dtype == "float32" else PEAK_BF16}


def _conv_block_case(gen, device, dtype, t, f, ci, co, per_chunk):
    import torch
    from voicefixer_tpu_torch.config import DEFAULT_CONFIG as C
    from voicefixer_tpu_torch.kernels import convblock
    from voicefixer_tpu_torch.models import resunet
    from voicefixer_tpu_torch.ops.conv import fold_bn_eval
    from voicefixer_tpu_torch.utils.weights import tree_map
    dt = getattr(torch, dtype)
    rnd = lambda shape, sc=1.0: sc * torch.randn(shape, generator=gen)  # noqa: E731

    def bn(c):
        return {"gamma": 1 + 0.1 * rnd((c,)), "beta": 0.1 * rnd((c,)),
                "mean": 0.05 * rnd((c,)), "var": (1 + 0.1 * rnd((c,))).abs()}

    p = {"bn1": bn(ci), "conv1": {"w": rnd((3, 3, ci, co),
                                           (2 / (9 * ci)) ** 0.5)},
         "bn2": bn(co), "conv2": {"w": rnd((3, 3, co, co),
                                           (2 / (9 * co)) ** 0.5)}}
    if ci != co:
        p["shortcut"] = {"w": rnd((1, 1, ci, co), ci ** -0.5),
                         "b": 0.1 * rnd((co,))}
    p = tree_map(lambda v: v.to(device, dt), fold_bn_eval(p))
    # the operands packed once, as VoiceFixer(conv_block_kernel=True) does
    p = resunet.pack_conv_blocks({"block": p})["block"]
    x = rnd((1, t, f, ci)).to(device, dt)
    slope = C.unet.leaky_slope
    if not convblock.eligible(p, x):
        raise AssertionError(f"conv_block_res does not take [{t}, {f}] "
                             f"{ci}->{co} {dtype}")
    flops, work_bytes = conv_block_work(t, f, ci, co, x.element_size())
    sms = convblock.sm_count(x.device)
    plan = convblock.plan_stream(t, f, ci, co, x.element_size(), sms=sms)
    layout = (f"{plan.tr} x 8 a thread" if plan.tr
              else f"{plan.stages} weight stages")
    # bfloat16: the output is rounded once; a2 is rounded where the plain
    # version rounds it, so one ulp of a2 (2^-8 relative) where the float32
    # sums straddle a boundary reaches the output through conv2
    return {"name": "conv_block_res", "dtype": dtype,
            "shape": f"[1, {t}, {f}, {ci}] -> {co}, "
                     f"{'1x1 shortcut' if ci != co else 'identity'}; "
                     f"{plan.runs} runs of {plan.run} rows, steps of "
                     f"{plan.bm}, {plan.np} columns, {layout}",
            "executed": conv_block_executed_flops(t, f, ci, co,
                                                  x.element_size(), sms=sms),
            "args": (x, p, slope),
            "fn": lambda: convblock.conv_block_res(x, p, slope),
            "plain": lambda: convblock.conv_block_res_reference(x, p, slope),
            "library": lambda: resunet._conv_block_res(p, x, slope),
            "reps": 5, "per_chunk": per_chunk, "device": True,
            "device_group": K9_GROUP,
            "rtol": 1e-4 if dtype == "float32" else 2 ** -7,
            "atol": 1e-4 if dtype == "float32" else 2 ** -6,
            "bytes": work_bytes, "flops": flops,
            "peak": PEAK_FP32 if dtype == "float32" else PEAK_BF16}


def phase_kernels(device):
    """Each kernel against its plain version at the shapes its path gives
    it."""
    import torch
    from voicefixer_tpu_torch.ops.precision import tf32_off
    log("== kernels against their plain versions (their paths' shapes)")
    gen = torch.Generator().manual_seed(SEED)
    cases = [_stft_case(gen, device)]
    # a short window in a small transform, an odd frame count, batch 3; a
    # last pass of radix 2 at hop = n_fft; the largest transform
    cases += [_stft_case(gen, device, (256, 100, 200, 40, 5000, 3)),
              _stft_case(gen, device, (128, 128, 128, 16, 3000, 2)),
              _stft_case(gen, device, (4096, 512, 4000, 128, 20000, 1))]
    # the unidirectional path launches the forward direction twice a call
    cases += [_gru_seq_case(gen, device, False, 1, 2),
              _gru_seq_case(gen, device, True, 1, 0),
              _gru_seq_case(gen, device, True, 2, 0)]
    t2, w2 = shard_shape(2)
    t3, w3 = shard_shape(3)
    for dtype in ("float32", "bfloat16"):
        cases.append(_gru_case(gen, device, dtype))
        # frames after the tail pad: 3001 + 1 + 4, then x7, x7, x3
        for stage, t in enumerate((3006, 21042)):
            cases.append(_upsample_case(gen, device, dtype, stage, t))
        # rows q = 0 .. T fill exactly one 128 x 128 tile at T = 127; one
        # row less and one more; batch 2, where the row above a batch row's
        # first must read zero, with a ragged K step and column tile
        for t, small in ((127, (7, 64, 128, 1)), (126, (7, 64, 128, 1)),
                         (128, (7, 64, 128, 1)), (127, (3, 40, 136, 2))):
            cases.append(_upsample_case(gen, device, dtype, 0, t, small))
        for ch, t in ((512, 21042), (256, 147294)):
            cases += _res_cases(gen, device, dtype, ch, t)
        cases.append(_up_res_case(gen, device, dtype, 256, 128, 3, 147294))
        cases.append(_up_res_case(gen, device, dtype, 128, 64, 3, 441882))
        # signals shorter than the dilations: every outer tap falls outside
        # the signal and the result is the bias-only one
        cases += _res_cases(gen, device, dtype, 64, 20, main_path=False)
        cases.append(_up_res_case(gen, device, dtype, 32, 16, 3, 7,
                                  main_path=False))
        # res_stream: a whole stage's signal, then the last shard's arrays
        # of the sharded path (its window ends inside the array), then a
        # signal shorter than the dilations
        cases.append(_res_stream_case(gen, device, dtype, 128, 441882))
        cases.append(_res_stream_case(gen, device, dtype, 128, t2, w2, SHARDS))
        cases.append(_res_stream_case(gen, device, dtype, 64, t3, w3, SHARDS))
        cases.append(_res_stream_case(gen, device, dtype, 64, 20, (3, 15),
                                      main_path=False))
        # the wide stages' launches under a shard's window
        for stage, ch in ((0, 512), (1, 256)):
            t_s, w_s = shard_shape(stage)
            cases += _res_cases(gen, device, dtype, ch, t_s, main_path=False,
                                bounds=w_s)
        for (t, f, ci, co), k in conv_block_shapes().items():
            cases.append(_conv_block_case(gen, device, dtype, t, f, ci, co, k))
    rows = []
    with tf32_off(), torch.inference_mode():
        for c in cases:
            got, ref = c["fn"](), c["plain"]()
            torch.cuda.synchronize()
            if c.get("pair"):
                errs = [compare(f"{c['name']} {c['dtype']} {c['shape']} {d}",
                                g, r, c["rtol"], c["atol"])
                        for d, g, r in zip(("fwd", "bwd"), got, ref)]
                err = max(errs)
            else:
                err = compare(f"{c['name']} {c['dtype']} {c['shape']}", got,
                              ref, c["rtol"], c["atol"],
                              c.get("chained", 0))
            del got, ref
            if not c.get("main_path", True):
                continue  # checked, not a shape of the main path: not timed
            ms = cuda_ms(c["fn"], c["reps"])
            plain_ms = cuda_ms(c["plain"], max(1, c["reps"] // 5), warmup=0)
            try:  # a yardstick only: the port never calls it
                lib_ms = cuda_ms(c["library"], c["reps"])
            except RuntimeError as e:
                log(f"  library call unavailable: {str(e).splitlines()[0]}")
                lib_ms = None
            bms, by = bound_ms(c["bytes"], c["flops"], c["peak"])
            rate = ("" if not c.get("executed") else
                    f"; executed {c['executed'] / 1e9:.1f} GFLOP, "
                    f"{c['executed'] / ms / 1e9:.1f} TFLOP/s executed, "
                    f"{c['flops'] / ms / 1e9:.1f} useful")
            if lib_ms:
                rate += f"; {ms / lib_ms:.2f}x the library's time"
            log(f"  {c['name']} {c['dtype']} {c['shape']}: kernel {ms:.3f} ms, "
                f"plain {plain_ms:.3f} ms, library {lib_ms} ms, bound "
                f"{bms:.4f} ms ({by}; {c['flops'] / 1e9:.2f} GFLOP, "
                f"{c['bytes'] / 1e6:.1f} MB){rate}")
            dev_ms = lib_dev_ms = None
            if c.get("device"):
                # besides the events, which also time the host between
                # launches: the kernel's and the library's device time (of
                # the kernel's group, or of every kernel of its call)
                dev_ms = device_ms(c["fn"], c["reps"], c.get("device_group"),
                                   c.get("device_launches"))
                dev_rate = (f"{c.get('executed', c['flops']) / dev_ms / 1e9:.3f}"
                            " TFLOP/s executed")
                if c.get("device_launches"):  # a profile of the library's
                    # thousands of launches drops some: events only there
                    log(f"  {c['name']} {c['dtype']} {c['shape']}: device "
                        f"time kernel {dev_ms:.3f} ms; {dev_rate}")
                else:
                    lib_dev_ms = device_ms(c["library"], c["reps"])
                    log(f"  {c['name']} {c['dtype']} {c['shape']}: device "
                        f"time kernel {dev_ms:.3f} ms, library "
                        f"{lib_dev_ms:.3f} ms; {dev_rate}; "
                        f"{dev_ms / lib_dev_ms:.2f}x the library's time")
            if c.get("steps"):  # a recurrence: its pace is the step's latency
                log(f"  {c['name']} {c['dtype']} {c['shape']}: "
                    f"{ms / c['steps'] * 1e3:.4f} us a step by events, "
                    f"{dev_ms / c['steps'] * 1e3:.4f} by device time")
            if c.get("split"):
                _launch_split(c)
            rows.append({**c, "err": err, "ms": ms, "plain_ms": plain_ms,
                         "lib_ms": lib_ms, "bound_ms": bms, "bound_by": by,
                         "dev_ms": dev_ms, "lib_dev_ms": lib_dev_ms})
    return rows


def _launch_split(c):
    """Device time of one call of a stack's kernels by launch kind: the
    x + sin(x) pre-pass (up_res_stream only), the chain kernels (the only
    chain of the full-width plans is the first group; up_res_stream's
    carries the upsample) and the single-block kernels (profiler, mean of
    three calls)."""
    kinds = {"pre-pass": 0.0, "chain": 0.0, "single blocks": 0.0}
    launches = dict.fromkeys(kinds, 0)
    c["fn"]()
    for name, ms, n in _device_kernels(lambda: [c["fn"]() for _ in
                                                range(3)]):
        kind = ("pre-pass" if "sin_residual" in name else
                "chain" if "chain" in name else
                "single blocks" if "shift" in name else None)
        if kind is None:
            continue
        kinds[kind] += ms / 3
        launches[kind] += n // 3
    log(f"  {c['name']} {c['dtype']} {c['shape'].split(',')[0]} by launch "
        "(device time): " + ", ".join(
            f"{k} {v:.3f} ms ({launches[k]}x)" for k, v in kinds.items()))


def _snr_db(prod, ref):
    import numpy as np
    prod, ref = np.asarray(prod, np.float64), np.asarray(ref, np.float64)
    return float(10 * np.log10((np.sum(ref * ref) + 1e-20)
                               / (np.sum((prod - ref) ** 2) + 1e-20)))


def phase_main_path(device):
    """Full-width mode-0 restore through VoiceFixer, both precisions."""
    import numpy as np
    import torch
    from voicefixer_tpu_torch import kernels
    from voicefixer_tpu_torch.config import DEFAULT_CONFIG
    from voicefixer_tpu_torch.models import analysis
    from voicefixer_tpu_torch.models import denoiser, resunet
    from voicefixer_tpu_torch.ops.norm import from_log, to_log
    from voicefixer_tpu_torch.ops.precision import precision, tf32_off
    from voicefixer_tpu_torch.pipeline import vocoder_facade
    from voicefixer_tpu_torch.pipeline.restore import VoiceFixer

    log("== main path: VoiceFixer.random(DEFAULT_CONFIG).restore_inmem, mode 0")
    t0 = time.perf_counter()
    vf = VoiceFixer.random(SEED, DEFAULT_CONFIG, device=device)
    log(f"  random full-width weights in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    seg = DEFAULT_CONFIG.pipeline.seg_length
    wavs = {"30s": (0.1 * rng.standard_normal(seg)).astype(np.float32),
            "45s": (0.1 * rng.standard_normal(seg * 3 // 2)).astype(np.float32)}
    outs, counts = {}, {}
    for mode in ("parity", "production"):
        with precision(mode):
            for name, wav in wavs.items():
                # both inputs are one batch
                outs[mode, name], counts[mode, name] = _counted_restore(
                    mode, name, vf, wav,
                    expected_launches(4 if mode == "parity" else 2))
            wall = _timed_restore(mode, "default path", vf, wavs["30s"],
                                  device)
            # stage breakdown on device time, one 30 s batch
            wav = torch.from_numpy(wavs["30s"][None]).to(device)
            p, vp, cfg = vf.params, vf.vocoder_params, vf.config
            with tf32_off(), torch.inference_mode():
                mel = analysis.wav_to_mel(wav, cfg)
                mask = denoiser.apply(p["denoiser"], mel, cfg.denoiser)
                x = torch.stack([to_log(mel), to_log(mask * mel)], -1)
                den = from_log(analysis.apply(p, mel, cfg)["mel"])
                stages = {
                    "stft_mel": lambda: analysis.wav_to_mel(wav, cfg),
                    "denoiser": lambda: denoiser.apply(p["denoiser"], mel,
                                                       cfg.denoiser),
                    "resunet": lambda: resunet.apply(p["unet"], x, cfg.unet),
                    "vocoder": lambda: vocoder_facade.synthesize(
                        vp, den, cfg.vocoder),
                }
                parts = {k: cuda_ms(f, 2) for k, f in stages.items()}
            log(f"  {mode} stage device ms (30 s): "
                + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()))
            _profile(mode, lambda: vf.restore_inmem(wavs["30s"]), wall)
            with tf32_off(), torch.inference_mode():
                _vocoder_convs(mode, stages["vocoder"])
    for name in wavs:
        snr = _snr_db(outs["production", name], outs["parity", name])
        log(f"  SNR production vs parity, {name}: {snr:.2f} dB (regression "
            f"floor {SNR_FLOOR_DB}; bench.py's {BENCH_SNR_DB} dB "
            f"{'met' if snr >= BENCH_SNR_DB else 'NOT met'} by this draw)")
        if snr < SNR_FLOOR_DB:
            raise AssertionError(f"{name}: SNR {snr:.2f} dB < {SNR_FLOOR_DB}")
    phase_snr_vs_plain(vf, device)
    return vf, wavs["30s"], outs, counts


def _timed_restore(mode: str, what: str, vf, wav, device):
    """Best-of-3 host-clock ms of vf.restore_inmem(wav)."""
    import torch
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vf.restore_inmem(wav)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    log(f"  {mode} {what}: ms per 30 s chunk (host clock, wav in to wav out) "
        f"{['%.1f' % w for w in walls]}; min {min(walls):.1f} ms = "
        f"{30.0 / (min(walls) / 1e3):.1f} audio-s/s on "
        f"{torch.cuda.get_device_name(device)}")
    return min(walls)


def _counted_restore(mode: str, what: str, vf, wav, want: dict):
    """One restore, after a warm-up (cuDNN plans, kernel load), with the
    launch counts set to 0 just before and read just after; the counts must
    be ``want`` and the output sound."""
    import numpy as np
    import torch
    from voicefixer_tpu_torch import kernels
    vf.restore_inmem(wav)
    torch.cuda.synchronize()
    kernels.reset_launches()
    out = vf.restore_inmem(wav)
    counts = dict(kernels.launches)
    if out.shape != wav.shape or not np.isfinite(out).all() \
            or float(np.abs(out).max()) > 1.0:
        raise AssertionError(f"{mode} {what}: bad output shape {out.shape} / "
                             f"finite {np.isfinite(out).all()} / peak "
                             f"{float(np.abs(out).max())}")
    if counts != want:
        raise AssertionError(f"{mode} {what}: launches {counts} != {want}")
    log(f"  {mode} {what}: {len(out)} samples, peak "
        f"{float(np.abs(out).max()):.4f}, launches {counts}")
    return out, counts


def _held_to_default(mode: str, what: str, out, outs, atol: float,
                     margin_db: float = 0.0):
    """A path's output against the default path's on the same weights and
    input. Parity: max abs difference within atol. Production: bfloat16
    roundings flip where float32 sums in another order straddle a boundary,
    so the path must stand to the parity output as the default production
    path does (SNR within SNR_MATCH_DB), and differ from the default
    production output by no more than production differs from parity, less
    ``margin_db``: 0 for a path that rounds at the same places, 3 for one
    that rounds elsewhere (two unrelated errors of that size add up to 3 dB
    more)."""
    import numpy as np
    ref = outs[mode, "30s"]
    err = float(np.abs(out - ref).max())
    if mode == "parity":
        log(f"  {mode} {what} against the default path: max abs diff "
            f"{err:.3e} (tol {atol:.0e})")
        if not err <= atol:
            raise AssertionError(f"{what}: parity output differs from the "
                                 "default path's")
        return
    snr_default = _snr_db(ref, outs["parity", "30s"])
    snr_path = _snr_db(out, outs["parity", "30s"])
    direct = _snr_db(out, ref)
    log(f"  {mode} {what}: SNR against parity {snr_path:.2f} dB (default "
        f"path {snr_default:.2f} dB, must agree within {SNR_MATCH_DB} dB); "
        f"against the default production output {direct:.2f} dB (must "
        f"reach {snr_default - margin_db:.2f}); max abs diff {err:.3e}")
    if abs(snr_path - snr_default) > SNR_MATCH_DB \
            or direct < snr_default - margin_db:
        raise AssertionError(f"{what}: production output strays from the "
                             "default path's")


def _denoised_mel(vf, wav, device):
    """(unet input, denoised linear mel) of one 30 s batch, for stage
    timings."""
    import torch
    from voicefixer_tpu_torch.models import analysis, denoiser
    from voicefixer_tpu_torch.ops.norm import from_log, to_log
    w = torch.from_numpy(wav[None]).to(device)
    mel = analysis.wav_to_mel(w, vf.config)
    mask = denoiser.apply(vf.params["denoiser"], mel, vf.config.denoiser)
    x = torch.stack([to_log(mel), to_log(mask * mel)], -1)
    den = from_log(analysis.apply(vf.params, mel, vf.config)["mel"])
    return x, den


def phase_sharded_path(vf, wav, outs, device):
    """The same restore with the vocoder cut into SHARDS time shards, all on
    this card, one after the other: res_stream on the narrow stages,
    res_chain and res_shift_single under a signal window on the wide ones,
    no upsample kernel and no library convolution inside the four stages."""
    import torch
    from voicefixer_tpu_torch.ops.precision import precision, tf32_off
    from voicefixer_tpu_torch.parallel.sp import synthesize_sp
    from voicefixer_tpu_torch.pipeline.restore import VoiceFixer
    log(f"== sharded path: VoiceFixer(model_devices=({str(device)!r},) * "
        f"{SHARDS}).restore_inmem, mode 0")
    sp = VoiceFixer(vf.params, vf.vocoder_params, vf.config, device=device,
                    model_devices=(device,) * SHARDS)
    counts = {}
    for mode in ("parity", "production"):
        with precision(mode):
            want = expected_launches(4 if mode == "parity" else 2,
                                     shards=SHARDS)
            out, counts[mode] = _counted_restore(
                mode, f"{SHARDS} shards", sp, wav, want)
            _held_to_default(mode, f"{SHARDS} shards", out, outs, SHARD_ATOL)
            wall = _timed_restore(mode, f"{SHARDS} shards", sp, wav, device)
            with tf32_off(), torch.inference_mode():
                _, den = _denoised_mel(vf, wav, device)
                voc = lambda: synthesize_sp(  # noqa: E731
                    sp.vocoder_params, den, sp.config.vocoder,
                    sp.model_devices)
                log(f"  {mode} sharded vocoder stage device ms (30 s): "
                    f"{cuda_ms(voc, 2):.2f} by CUDA events, "
                    f"{sum(r[1] for r in _device_kernels(voc)):.2f} summed "
                    "kernel time (profiler)")
            _profile(mode, lambda: sp.restore_inmem(wav), wall)
            with tf32_off(), torch.inference_mode():
                # condnet 5, pre-conv, a post-conv a shard, two edge patches
                _vocoder_convs(mode, voc, 8 + SHARDS)
    return counts


def phase_cards(n: int):
    """The sharded path on n real cards (one process, shard i on card i)
    against the unsharded restore on card 0, same weights and input: launch
    counts, agreement and best-of-3 ms per chunk of both."""
    import numpy as np
    import torch
    from voicefixer_tpu_torch.config import DEFAULT_CONFIG
    from voicefixer_tpu_torch.ops.precision import precision
    from voicefixer_tpu_torch.pipeline.restore import VoiceFixer
    log(f"== sharded path on {n} cards against one card")
    devices = tuple(torch.device("cuda", i) for i in range(n))
    vf = VoiceFixer.random(SEED, DEFAULT_CONFIG, device=devices[0])
    sp = VoiceFixer(vf.params, vf.vocoder_params, DEFAULT_CONFIG,
                    device=devices[0], model_devices=devices)
    wav = (0.1 * np.random.default_rng(SEED).standard_normal(
        DEFAULT_CONFIG.pipeline.seg_length)).astype(np.float32)
    outs = {}
    for mode in ("parity", "production"):
        size = 4 if mode == "parity" else 2
        with precision(mode):
            outs[mode, "30s"], _ = _counted_restore(
                mode, "1 card", vf, wav, expected_launches(size))
            _timed_restore(mode, "1 card", vf, wav, devices[0])
            out, _ = _counted_restore(mode, f"{n} cards", sp, wav,
                                      expected_launches(size, shards=n))
            _held_to_default(mode, f"{n} cards", out, outs, SHARD_ATOL)
            _timed_restore(mode, f"{n} cards", sp, wav, devices[0])


def phase_conv_block_path(vf, wav, outs, device):
    """The same restore with the fused ConvBlockRes kernel opted in."""
    import torch
    from voicefixer_tpu_torch.models import resunet
    from voicefixer_tpu_torch.ops.precision import (conv_block_kernel,
                                                    precision, tf32_off)
    from voicefixer_tpu_torch.pipeline.restore import VoiceFixer
    log("== conv-block path: VoiceFixer(conv_block_kernel=True)"
        ".restore_inmem, mode 0")
    cb = VoiceFixer(vf.params, vf.vocoder_params, vf.config, device=device,
                    conv_block_kernel=True)
    counts = {}
    for mode in ("parity", "production"):
        with precision(mode):
            want = expected_launches(4 if mode == "parity" else 2,
                                     conv_blocks=True)
            out, counts[mode] = _counted_restore(mode, "fused conv blocks",
                                                 cb, wav, want)
            # the kernel keeps h1 in float32 where the library path rounds
            # every convolution's output to bfloat16
            _held_to_default(mode, "fused conv blocks", out, outs,
                             CONVBLOCK_ATOL, margin_db=3.0)
            _timed_restore(mode, "fused conv blocks", cb, wav, device)
            with tf32_off(), torch.inference_mode():
                x, _ = _denoised_mel(vf, wav, device)
                # the default instance's tree, and the opt-in's with the
                # kernel's operands packed at construction
                unet = lambda tree: lambda: resunet.apply(  # noqa: E731
                    tree["unet"], x, vf.config.unet)
                # summed kernel time: CUDA events around this stage's many
                # small launches also time the host
                busy = lambda fn: sum(r[1] for r in _device_kernels(fn))  # noqa: E731
                lib_ms = busy(unet(vf.params))
                with conv_block_kernel():
                    k_ms = busy(unet(cb.params))
                    # raises when no kernel of the group is seen
                    k9 = device_ms(unet(cb.params), 1, K9_GROUP)
            log(f"  {mode} resunet stage, summed kernel ms (profiler, 30 s): "
                f"{k_ms:.2f} with {want['conv_block_res']} blocks through "
                f"conv_block_res ({k9:.2f} ms in the kernel), {lib_ms:.2f} on "
                "the library convolutions")
    return counts


def phase_gru_path(device):
    """A two-layer unidirectional GRU through ``ops.gru.gru``: one gru_seq
    launch a layer, against cuDNN's GRU on the same weights."""
    import torch
    from voicefixer_tpu_torch import kernels
    from voicefixer_tpu_torch.ops.gru import gru, init_gru_params
    from voicefixer_tpu_torch.ops.precision import tf32_off
    cin, h, layers = 128, 256, 2
    log(f"== unidirectional GRU path: ops.gru.gru, {layers} layers, In={cin}, "
        f"H={h}, T={GRU_FRAMES}")
    gen = torch.Generator().manual_seed(SEED + 2)
    params = init_gru_params(gen, cin, h, layers, device, bidirectional=False)
    x = torch.randn((1, GRU_FRAMES, cin), generator=gen).to(device)
    lib = torch.nn.GRU(cin, h, num_layers=layers, batch_first=True).to(device)
    with torch.no_grad():
        for layer in range(layers):
            for k in ("w_ih", "w_hh", "b_ih", "b_hh"):
                getattr(lib, k.replace("w_", "weight_").replace("b_", "bias_")
                        + f"_l{layer}").copy_(params[f"l{layer}"][k])
    with tf32_off(), torch.inference_mode():
        kernels.reset_launches()
        out = gru(x, params, layers, bidirectional=False)
        counts = dict(kernels.launches)
        torch.cuda.synchronize()
        want = dict.fromkeys(KERNELS, 0)
        want["gru_seq"] = layers
        if counts != want:
            raise AssertionError(f"gru path: launches {counts} != {want}")
        ref = lib(x)[0]
        if out.shape != (1, GRU_FRAMES, h) or not bool(
                torch.isfinite(out).all()):
            raise AssertionError(f"gru path: bad output {tuple(out.shape)}")
        # float32 on both sides; cuDNN sums in another order over 3001 steps
        compare("gru path against nn.GRU", out, ref, 1e-4, 1e-4)
        ms = cuda_ms(lambda: gru(x, params, layers, False), 3)
        lib_ms = cuda_ms(lambda: lib(x), 3)
    log(f"  launches {counts}; {ms:.3f} ms a call (projections and "
        f"{layers} gru_seq launches), nn.GRU {lib_ms:.3f} ms")
    return counts


# csrc/convblock.cu's kernels: conv_block_f32_kernel and
# conv_block_wgmma_kernel
K9_GROUP = "K9 conv_block_res"


def _kernel_group(name: str) -> str:
    # the ResStack kernels: chains (K2, K4's and K7's) and single blocks
    # (K3, K4's and K7's) of csrc/resstack_wgmma.cu in bfloat16 and of
    # csrc/resstack_f32.cu in float32
    for key, group in (("stft_mel", "K5 stft_mel"),
                       ("gru_bidir", "K6 gru_bidir"),
                       ("gru_seq", "K8 gru_seq"),
                       ("conv_block_", K9_GROUP),
                       ("sin_residual", "x+sin(x) pre-pass of K1 and K4"),
                       ("upsample", "K1 upsample"),
                       ("chain_wgmma_kernel",
                        "K2/K4/K7-bf16 chain_wgmma_kernel"),
                       ("shift_wgmma_kernel",
                        "K3/K4/K7-bf16 shift_wgmma_kernel"),
                       ("chain_f32_kernel", "K2/K4/K7-f32 chain_f32_kernel"),
                       ("shift_f32_kernel", "K3/K4/K7-f32 shift_f32_kernel"),
                       ("nchwToNhwc", "layout copies"),
                       ("nhwcToNchw", "layout copies"),
                       ("fprop", "cuDNN conv"), ("implicit", "cuDNN conv"),
                       ("cudnn", "cuDNN conv"), ("conv", "cuDNN conv"),
                       ("gemm", "matrix products"),
                       ("xmma", "matrix products"),
                       ("cutlass", "matrix products")):
        if key in name:
            return group
    return "elementwise and copies"


def _device_kernels(fn):
    """[(kernel name, device ms, launches)] of one call of fn
    (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.key, getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0)) / 1e3,
             e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def _vocoder_convs(mode: str, fn, outside: int = 7):
    """The vocoder stage alone: its ResStacks run through the port's
    kernels, so the only library convolutions left are the ``outside`` ones
    (the condnet's five, the pre-conv and the post-conv). The 64
    convolutions of the ResStacks would show here."""
    rows = [r for r in _device_kernels(fn)
            if _kernel_group(r[0]) == "cuDNN conv"]
    n = sum(r[2] for r in rows)
    log(f"  {mode} vocoder stage: {n} library convolution kernels, "
        f"{sum(r[1] for r in rows):.2f} ms ({outside} convolutions outside "
        "the ResStacks)")
    if n >= 32:
        raise AssertionError(f"{mode}: {n} convolution kernels in the "
                             "vocoder: a ResStack still runs on the library")


def _profile(mode: str, fn, wall_ms: float):
    """Device time by kernel over one 30 s restore (torch.profiler), and the
    device's idle share of the unprofiled wall time."""
    rows = _device_kernels(fn)
    busy = sum(ms for _, ms, _ in rows)
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    groups: dict = {}
    for name, ms, _ in rows:
        g = _kernel_group(name)
        groups[g] = groups.get(g, 0.0) + ms
    log(f"  {mode} device time by kernel group (profiler, one 30 s chunk): "
        + ", ".join(f"{g} {ms:.2f} ms" for g, ms in
                    sorted(groups.items(), key=lambda kv: -kv[1]))
        + f"; busy {busy:.1f} ms of {wall_ms:.1f} ms wall, idle share "
        f"{max(0.0, 1 - busy / wall_ms):.3f}")
    for name, ms, n in sorted(rows, key=lambda r: -r[1])[:8]:
        log(f"    {ms:8.2f} ms {n:4d}x {name[:90]}")


def phase_snr_vs_plain(vf, device):
    """Production-vs-parity SNR of the card against that of the plain versions
    on the CPU, same full-width weights, a short input: the card's kernels and
    convolutions must lose no more than the production policy itself."""
    import numpy as np
    import torch
    from voicefixer_tpu_torch.ops.precision import precision
    from voicefixer_tpu_torch.pipeline.restore import restore_segment
    from voicefixer_tpu_torch.utils.weights import tree_map

    cfg = vf.config
    rng = np.random.default_rng(SEED + 1)
    wav = torch.from_numpy((0.1 * rng.standard_normal(
        SNR_SECONDS * cfg.pipeline.sample_rate)).astype(np.float32))
    cpu = lambda t: t.cpu()  # noqa: E731
    sides = {"card": (vf.params, vf.vocoder_params, wav.to(device)),
             "cpu": (tree_map(cpu, vf.params),
                     tree_map(cpu, vf.vocoder_params), wav)}
    snr = {}
    t0 = time.perf_counter()
    for side, (p, vp, w) in sides.items():
        out = {}
        for mode in ("production", "parity"):
            with precision(mode):
                out[mode] = restore_segment(p, vp, w, cfg)[0].float().cpu()
        snr[side] = _snr_db(out["production"].numpy(), out["parity"].numpy())
    log(f"  SNR production vs parity, {SNR_SECONDS} s: card "
        f"{snr['card']:.2f} dB, CPU plain versions {snr['cpu']:.2f} dB (must "
        f"agree within {SNR_MATCH_DB} dB; {time.perf_counter() - t0:.1f} s)")
    if abs(snr["card"] - snr["cpu"]) > SNR_MATCH_DB:
        raise AssertionError("the card's production path loses more than the "
                             "plain versions do")


def phase_small_reference(device):
    """The port on the card against the port's plain versions on the CPU,
    same weights, tiny config, a 2.5-segment input with a padded tail."""
    import numpy as np
    from voicefixer_tpu_torch.config import tiny_test_config
    from voicefixer_tpu_torch.pipeline.restore import VoiceFixer
    log("== small input: card against CPU plain versions (tiny config)")
    cfg = tiny_test_config()
    cpu = VoiceFixer.random(SEED, cfg, device="cpu")
    gpu = VoiceFixer(cpu.params, cpu.vocoder_params, cfg, device=device)
    wav = (0.1 * np.random.default_rng(1).standard_normal(
        int(cfg.pipeline.seg_length * 2.5))).astype(np.float32)
    a, b = gpu.restore_inmem(wav), cpu.restore_inmem(wav)
    err = float(np.abs(a - b).max())
    log(f"  max abs diff {err:.3e} over {len(a)} samples (tol 1e-4)")
    if a.shape != wav.shape or not err <= 1e-4:
        raise AssertionError("card and CPU disagree on the small input")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    try:
        import voicefixer_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run it from the root of a checkout ({e})",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = phase_card()
    phase_build()
    if len(sys.argv) > 1:
        if len(sys.argv) != 3 or sys.argv[1] != "--cards" \
                or not 2 <= int(sys.argv[2]) <= torch.cuda.device_count():
            print("chip_smoke: usage: chip_smoke.py [--cards N], 2 <= N <= "
                  f"{torch.cuda.device_count()} cards", file=sys.stderr)
            return 2
        phase_cards(int(sys.argv[2]))
        print(card)
        return 0
    rows = phase_kernels(device)
    vf, wav, outs, counts = phase_main_path(device)
    sp_counts = phase_sharded_path(vf, wav, outs, device)
    cb_counts = phase_conv_block_path(vf, wav, outs, device)
    gru_counts = phase_gru_path(device)
    del vf
    phase_small_reference(device)

    def launches(name, mode):
        """From the run of the path that launches the kernel."""
        if name == "res_stream":
            return sp_counts[mode][name]
        if name == "conv_block_res":
            return cb_counts[mode][name]
        if name == "gru_seq":
            return gru_counts[name]
        return counts[mode, "30s"][name]

    record = []
    for name in KERNELS:
        for dtype in ("float32", "bfloat16"):
            rs = [r for r in rows if r["name"] == name and r["dtype"] == dtype
                  and r["per_chunk"]]
            if not rs:
                continue
            mode = "production" if dtype == "bfloat16" else "parity"
            total = lambda key: sum(r["per_chunk"] * r[key] for r in rs)  # noqa: E731
            by_bytes = sum(r["per_chunk"] * r["bound_ms"] for r in rs
                           if r["bound_by"] == "bytes")
            record.append({
                "name": f"{name}:{dtype}", "route": "cuda",
                "source": (SOURCES_BF16.get(name, SOURCES[name])
                           if dtype == "bfloat16" else SOURCES[name]),
                "replaces": REPLACES[name],
                "launches": launches(name, mode),
                "max_abs_err": max(r["err"] for r in rs),
                "ms": total("ms"), "plain_ms": total("plain_ms"),
                "bound_ms": total("bound_ms"),
                "bound_by": ("bytes" if 2 * by_bytes > total("bound_ms")
                             else "operations"),
                "library_ms": (None if None in [r["lib_ms"] for r in rs]
                               else total("lib_ms")),
            })
            if rs[0]["dev_ms"] is not None:  # K4, K6, K8, K9: device time
                record[-1]["device_ms"] = total("dev_ms")
                if rs[0]["lib_dev_ms"] is not None:
                    record[-1]["library_device_ms"] = total("lib_dev_ms")
    log(f"== done in {time.perf_counter() - t_start:.1f} s; times are per "
        "30 s chunk (B=1), summed over the launches that the kernel's path "
        "makes (the default path; res_stream: the sharded path; "
        "conv_block_res: the conv-block path; gru_seq: the GRU path)")
    print(json.dumps({"kernels": record}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
