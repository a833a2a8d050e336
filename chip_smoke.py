#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: build every kernel from
the sources in this checkout, hold each against its plain PyTorch version at
the shapes its path gives it, drive full-width mode-0 restore through
``VoiceFixer`` in parity and production precision, and check the output. The
nine kernels: stft_mel, gru_bidir, upsample, the vocoder's ResStack kernels
res_chain, res_shift_single and up_res_stream, and res_stream, gru_seq and
conv_block_res, each also timed against the library call (cuFFT, cuDNN) that
computes the same function and that the port does not use.

These paths are driven, each with the launch counts set to 0 just before
and read and asserted just after: the default main path; the same restore
with the vocoder time-sharded four ways on the one card (res_stream, and
res_chain and res_shift_single under a signal window); the same restore with
the fused ConvBlockRes kernel opted in (conv_block_res); a two-layer
unidirectional GRU (gru_seq); mode 2 (batch statistics and dropout, the
launches of mode 0, none of conv_block_res); a custom vocoder hook (only
stft_mel and gru_bidir); the analysis-stage trainer (``train/``: gru_bidir
under grad, its backward in torch ops, ``kernels.gru.GruBidir``), whose
first step is held to the same step with the GRU on its plain version; and
the distributed entry points on a real NCCL group of one process
(``parallel.distributed.initialize`` from the VF_* variables,
``make_mesh()`` = (1, 1), ``parallel.inference.restore_wavs`` in modes 0
and 1 held to ``restore_inmem``, its peak memory per chunk row, and a
trainer step on the mesh held to the step without one); and the file path,
three runs of the command line (``voicefixer_tpu_torch.__main__.main``) on
upstream-layout torch checkpoints written by ``tools/torch_ref_state_dict.py``:
mode 0, FLAC with overlap-add, mode 1. K6's backward is held to autograd
through the plain loop and timed against ``nn.GRU``'s.

    python3 chip_smoke.py
    python3 chip_smoke.py --cards N    # N >= 2 cards: the paths that need N

With ``--cards N`` it runs the vocoder time-sharded in one process (shard i
on card i) against the unsharded restore on card 0, then starts N worker
processes, one a card, on NCCL (this script with ``--rank-worker``; each is
killed after RANKS_TIMEOUT_S): (a) ``restore_wavs`` on a (N, 1) mesh over
2N + 1 chunks, held to one-card ``restore_inmem``, and its aggregate
audio-s/s; (b) the vocoder over NCCL on (1, N) held to the one-process
sharded output and to the unsharded one, with the halo exchange's ms per
stage; (c) tensor-parallel restore on (1, N) (the ResUNet channel-sharded,
the vocoder time-sharded; no conv_block_res launch under the opt-in) held
to the default output; (d) the trainer on (N, 1) and, for N >= 4, (N/2, 2)
held to the one-process step on the whole batch with the plain GRU, ms per
step with the all-reduce's share; (e) the command line in folder mode with
``--coordinator`` in N processes against the one-process command line.

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
# The file path: seconds of audio, a 30 s segment and a 15 s one. Its files
# hold int16 samples (``audio_io.save_wave`` truncates x * 2**15), held to
# the API's output written the same way within FILE_LSB steps: one for
# float32 sums in another order across a truncation boundary, one to spare.
# Mode 1's preprocessing on the card against the CPU: a 2048-point DFT and
# its inverse in float32, on samples of magnitude ~0.4.
FILE_SECONDS = 45
FILE_LSB = 2
HF_ATOL = 1e-4
# The trainer: batches of two 3 s pairs (``train.data.PairedDataset``'s
# default chunk), 301 STFT frames; three counted steps, then timed ones.
TRAIN_BATCH, TRAIN_SECONDS, TRAIN_STEPS, TRAIN_TIMED = 2, 3.0, 3, 3
TRAIN_FRAMES = 301
# K6's backward (torch ops on the kernel's states) against autograd through
# the plain loop (on the loop's own states), relative to each gradient's
# largest element: the states differ by the forward's float32 rounding
# (1e-5) or, in bfloat16, by an ulp of h (2^-8) now and then, carried
# through the reverse recurrence.
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2 ** -6}
# The trainer's first step with K6 against the same step with the GRU on
# its plain version, cuDNN deterministic on both. The loss, with the plain
# GRU's own forward: within 1e-4 relative. The gradients: the step's
# gradients are not continuous in the GRU's outputs (the ReLUs and clamps
# after it; a random 1e-7 relative change of those outputs moved them by
# up to 3.6e-3 of a leaf's largest element on the CPU at tiny_test_config),
# so the plain step takes the kernel's output values (r + (k - r).detach())
# and differentiates through the plain loop: each leaf within 1e-3 of its
# largest element (floored at 1e-3 of the largest gradient anywhere, for
# the biases ahead of a batch-statistics BN, whose gradient is rounding
# noise). K6's backward alone agrees to about 1e-6 (GRAD_TOL's phase); the
# backward of the batch-statistics BNs in front of it subtracts means of
# gradients and amplifies that (3.5e-5 on the CPU at tiny_test_config, the
# forward there the same on both sides).
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL = 1e-4, 1e-3


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
    build_s = time.perf_counter() - t0
    log(f"  built {sorted(took) or 'nothing (cached)'} in "
        f"{build_s:.1f} s (nvcc in parallel)")
    for name in build.SOURCES:
        build.load(name)
        report = (build.BUILD / f"{name}.log")
        if report.exists():
            for line in report.read_text().splitlines():
                if any(k in line for k in ("registers", "spill",
                                           "Performance", "wgmma")):
                    log(f"  {name}: {line.strip()}")
    return build_s


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


def _timed_restore(mode: str, what: str, vf, wav, device,
                   kwargs: dict | None = None):
    """Best-of-3 host-clock ms of vf.restore_inmem(wav, **kwargs)."""
    import torch
    kwargs = kwargs or {}
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vf.restore_inmem(wav, **kwargs)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    log(f"  {mode} {what}: ms per 30 s chunk (host clock, wav in to wav out) "
        f"{['%.1f' % w for w in walls]}; min {min(walls):.1f} ms = "
        f"{30.0 / (min(walls) / 1e3):.1f} audio-s/s on "
        f"{torch.cuda.get_device_name(device)}")
    return min(walls)


def _counted_restore(mode: str, what: str, vf, wav, want: dict,
                     kwargs: dict | None = None):
    """One restore (``restore_inmem(wav, **kwargs)``), after a warm-up
    (cuDNN plans, kernel load), with the launch counts set to 0 just before
    and read just after; the counts must be ``want`` and the output
    sound."""
    import numpy as np
    import torch
    from voicefixer_tpu_torch import kernels
    kwargs = kwargs or {}
    vf.restore_inmem(wav, **kwargs)
    torch.cuda.synchronize()
    kernels.reset_launches()
    out = vf.restore_inmem(wav, **kwargs)
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
    del sp
    return vf, wav, outs


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


def phase_gru_backward(device):
    """K6 under grad (``kernels.gru.GruBidir``) at the trainer's shape, H =
    256, B = 2, T = 301, and at H = 1, T = 5, both types: the gradients of
    both directions' projections, W and b against autograd through the
    plain loop on the card; the backward timed against ``nn.GRU``'s (cuDNN)
    on the same weights, whose backward also runs its input projection's.
    Returns {dtype: {"ms", "library_ms", "err"}} of one launch's backward
    at the trainer's shape."""
    import torch
    from voicefixer_tpu_torch import kernels
    from voicefixer_tpu_torch.config import DEFAULT_CONFIG as C
    from voicefixer_tpu_torch.kernels.gru import (gru_bidir_cat,
                                                  gru_bidir_reference)
    from voicefixer_tpu_torch.ops.precision import tf32_off
    log("== K6 backward: GruBidir against autograd through the plain loop")
    h0 = C.denoiser.base_width
    gen = torch.Generator().manual_seed(SEED + 4)
    res = {}
    with tf32_off():
        for dtype in ("float32", "bfloat16"):
            mm = getattr(torch, dtype)
            for h, t, b in ((h0, TRAIN_FRAMES, TRAIN_BATCH), (1, 5, 2)):
                bound = h ** -0.5
                u = lambda *s: ((torch.rand(s, generator=gen) * 2 - 1)  # noqa: E731
                                * bound).to(device)
                x = torch.randn((b, t, 2 * h), generator=gen).to(device)
                w_ih = [u(3 * h, 2 * h) for _ in range(2)]
                w_hh = [u(3 * h, h) for _ in range(2)]
                b_ih = [u(3 * h) for _ in range(2)]
                b_hh = [u(3 * h) for _ in range(2)]
                args = [(x @ w_ih[0].T + b_ih[0]).requires_grad_(),
                        (x @ w_ih[1].T + b_ih[1]).requires_grad_(),
                        w_hh[0].T.contiguous().requires_grad_(),
                        w_hh[1].T.contiguous().requires_grad_(),
                        b_hh[0].clone().requires_grad_(),
                        b_hh[1].clone().requires_grad_()]
                kernels.reset_launches()
                y = gru_bidir_cat(*args, matmul_dtype=mm)
                gout = torch.randn(tuple(y.shape), generator=gen).to(device)
                got = torch.autograd.grad(y, args, gout, retain_graph=True)
                torch.cuda.synchronize()
                if kernels.launches["gru_bidir"] != 1:
                    raise AssertionError(f"K6 under grad: launches "
                                         f"{kernels.launches}")
                ref = torch.autograd.grad(torch.cat(gru_bidir_reference(
                    *args, matmul_dtype=mm), -1), args, gout)
                errs = []
                for name, a, r in zip(("xf", "xb", "w_f", "w_b", "b_f",
                                       "b_b"), got, ref):
                    if not bool(torch.isfinite(a).all()):
                        raise AssertionError(f"K6 backward {name}: "
                                             "non-finite")
                    errs.append(float((a - r).abs().max())
                                / max(float(r.abs().max()), 1e-30))
                log(f"  K6 backward {dtype} H={h} T={t} B={b}: max |err| / "
                    f"max |ref| per gradient (xf, xb, w_f, w_b, b_f, b_b) "
                    + ", ".join(f"{e:.2e}" for e in errs)
                    + f" (tol {GRAD_TOL[dtype]:.1e})")
                if max(errs) > GRAD_TOL[dtype]:
                    raise AssertionError("K6's backward disagrees with "
                                         "autograd through the plain loop")
                if h != h0:
                    continue
                bwd = lambda: torch.autograd.grad(  # noqa: E731
                    y, args, gout, retain_graph=True)
                ms = cuda_ms(bwd, 3)
                fwd_ms = cuda_ms(lambda: gru_bidir_cat(
                    *args, matmul_dtype=mm), 3)
                plain_ms = cuda_ms(lambda: torch.autograd.grad(
                    torch.cat(gru_bidir_reference(*args, matmul_dtype=mm),
                              -1), args, gout), 1, warmup=0)
                lib = torch.nn.GRU(2 * h, h, batch_first=True,
                                   bidirectional=True).to(device=device,
                                                          dtype=mm)
                with torch.no_grad():
                    for sfx, i in (("", 0), ("_reverse", 1)):
                        getattr(lib, "weight_ih_l0" + sfx).copy_(w_ih[i])
                        getattr(lib, "weight_hh_l0" + sfx).copy_(w_hh[i])
                        getattr(lib, "bias_ih_l0" + sfx).copy_(b_ih[i])
                        getattr(lib, "bias_hh_l0" + sfx).copy_(b_hh[i])
                x_lib = x.to(mm).requires_grad_()
                y_lib = lib(x_lib)[0]
                g_lib = gout.to(mm)
                lib_args = [x_lib] + list(lib.parameters())
                lib_ms = cuda_ms(lambda: torch.autograd.grad(
                    y_lib, lib_args, g_lib, retain_graph=True), 3)
                log(f"  K6 backward {dtype} [{b}, {t}, {3 * h}]: "
                    f"{ms:.3f} ms a launch ({ms / t * 1e3:.2f} us a step; "
                    f"the forward under grad {fwd_ms:.3f} ms), autograd "
                    f"through the plain loop {plain_ms:.1f} ms, nn.GRU's "
                    f"backward {lib_ms:.3f} ms ({ms / lib_ms:.2f}x)")
                res[dtype] = {"ms": ms, "library_ms": lib_ms,
                              "err": max(errs)}
    return res


def phase_mode2_path(vf, wav, outs, device):
    """Mode 2 through ``VoiceFixer.restore_inmem(mode=2, seed=0)`` at full
    width on the 30 s chunk, both precisions: the launches are mode 0's (K9
    none even with ``conv_block_kernel=True``: mode 2 takes no fused
    block), two runs with seed 0 are identical under
    ``torch.backends.cudnn.deterministic`` and seed 1 differs, the output
    is finite and of the input's length. Returns {precision: counts}."""
    import numpy as np
    import torch
    from voicefixer_tpu_torch.ops.precision import precision
    from voicefixer_tpu_torch.pipeline.restore import VoiceFixer
    log("== mode 2: VoiceFixer.restore_inmem(mode=2, seed=0), 30 s")
    cb = VoiceFixer(vf.params, vf.vocoder_params, vf.config, device=device,
                    conv_block_kernel=True)
    counts = {}
    for mode in ("parity", "production"):
        with precision(mode):
            want = expected_launches(4 if mode == "parity" else 2)
            m2 = {"mode": 2, "seed": 0}
            out, counts[mode] = _counted_restore(mode, "mode 2", vf, wav,
                                                 want, m2)
            _counted_restore(mode, "mode 2, conv_block_kernel=True", cb, wav,
                             want, m2)
            prev = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True
            try:
                a, b, c = (vf.restore_inmem(wav, mode=2, seed=k)
                           for k in (0, 0, 1))
            finally:
                torch.backends.cudnn.deterministic = prev
            same, differ = bool(np.array_equal(a, b)), float(
                np.abs(a - c).max())
            log(f"  {mode} mode 2: seed 0 twice identical {same}; seed 1 "
                f"max abs diff {differ:.3e}; against mode 0 "
                f"{float(np.abs(out - outs[mode, '30s']).max()):.3e}")
            if not same or differ == 0.0:
                raise AssertionError(f"{mode} mode 2 is not deterministic "
                                     "given its seed")
            _timed_restore(mode, "mode 2", vf, wav, device, m2)
    return counts


def phase_vocoder_hook(vf, wav, device):
    """``your_vocoder_func``: the hook sees the denoised linear mel [1, 1,
    T, 128] as a CUDA tensor; only the analysis stage's kernels launch
    (stft_mel 1, gru_bidir 4), in mode 0 and mode 2."""
    import torch
    log("== vocoder hook: restore_inmem(your_vocoder_func=...)")
    seen = []
    hop = vf.config.vocoder.hop_length

    def hook(mel):
        seen.append((tuple(mel.shape), mel.device, mel.dtype))
        return torch.zeros((1, 1, mel.shape[2] * hop), device=mel.device)

    want = dict.fromkeys(KERNELS, 0)
    want["stft_mel"], want["gru_bidir"] = 1, 4
    for mode in (0, 2):
        seen.clear()
        _counted_restore("parity", f"mode {mode} with a hook", vf, wav, want,
                         {"mode": mode, "your_vocoder_func": hook})
        shape, dev, dtype = seen[-1]
        log(f"  the hook saw {shape} {dtype} on {dev}")
        if len(shape) != 4 or shape[:2] != (1, 1) or shape[3] != 128 \
                or dev != device:
            raise AssertionError(f"the hook saw {seen[-1]}")


def phase_trainer(device):
    """The analysis-stage trainer at DEFAULT_CONFIG: parameters drawn from
    SEED, WAV pairs written to a temporary directory from a numpy seed and
    read by ``train.data.PairedDataset`` (batches of TRAIN_BATCH x
    TRAIN_SECONDS), ``reference_optimizer(warmup_steps=1)``. TRAIN_STEPS
    steps through ``make_train_step``, each with gru_bidir launched 4 times
    and nothing else; step 1's loss and gradients against the same step
    with the GRU on its plain version; the first update (lr 0) leaves the
    parameters, the second moves them. Then TRAIN_TIMED steps timed by
    CUDA events, split into forward, backward and optimizer, and the peak
    of allocated memory. Returns (counts of the last step, timings)."""
    import os
    import tempfile

    import numpy as np
    import torch
    from voicefixer_tpu_torch import kernels
    from voicefixer_tpu_torch.config import DEFAULT_CONFIG as C
    from voicefixer_tpu_torch.kernels.gru import gru_bidir_reference
    from voicefixer_tpu_torch.models import analysis
    from voicefixer_tpu_torch.ops import gru as ops_gru
    from voicefixer_tpu_torch.ops.precision import tf32_off
    from voicefixer_tpu_torch.train import losses
    from voicefixer_tpu_torch.train import step as st
    from voicefixer_tpu_torch.train.data import PairedDataset
    from voicefixer_tpu_torch.utils import audio_io
    from voicefixer_tpu_torch.utils.params import count_parameters

    sr = C.pipeline.sample_rate
    params = analysis.init(C, torch.Generator().manual_seed(SEED), device)
    log(f"== trainer: DEFAULT_CONFIG analysis stage "
        f"({count_parameters(params)} parameters), batches of "
        f"{TRAIN_BATCH} x {TRAIN_SECONDS} s")
    with tempfile.TemporaryDirectory() as d:
        rng = np.random.default_rng(SEED + 5)
        dirs = {k: os.path.join(d, k) for k in ("clean", "degraded")}
        for path in dirs.values():
            os.makedirs(path)
        for i in range(3):
            clean = 0.1 * rng.standard_normal(5 * sr)
            noisy = clean + 0.05 * rng.standard_normal(5 * sr)
            for k, v in (("clean", clean), ("degraded", noisy)):
                audio_io.save_wave(v.astype(np.float32),
                                   os.path.join(dirs[k], f"u{i}.wav"), sr)
        it = PairedDataset(dirs["clean"], dirs["degraded"], sample_rate=sr,
                           chunk_seconds=TRAIN_SECONDS,
                           seed=SEED).batches(TRAIN_BATCH)
        batches = [next(it) for _ in range(TRAIN_STEPS + TRAIN_TIMED)]
        it.close()
    spec = st.reference_optimizer(warmup_steps=1)
    state = st.init_train_state(params, spec, device=device)
    step = st.make_train_step(C, spec)
    p0 = [p.detach().clone() for p in state.leaves()]
    gen = torch.Generator(device).manual_seed(SEED)
    want = dict.fromkeys(KERNELS, 0)
    want["gru_bidir"] = 4
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for i in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            kernels.reset_launches()
            state, m = step(state, *batches[i], gen)
            torch.cuda.synchronize()
            counts = dict(kernels.launches)
            loss = float(m["loss"])
            moved = sum(not torch.equal(p, q)
                        for p, q in zip(state.leaves(), p0))
            log(f"  step {i + 1}: loss {loss:.5f} (targ "
                f"{float(m['targ_loss']):.5f}, mel "
                f"{float(m['mel_loss']):.5f}); {moved} of {len(p0)} "
                f"leaves changed; launches {counts}")
            if counts != want or not math.isfinite(loss):
                raise AssertionError(f"trainer step {i + 1}: launches "
                                     f"{counts} != {want}, loss {loss}")
            if (i == 0) != (moved == 0):
                raise AssertionError(f"trainer step {i + 1}: {moved} leaves "
                                     "moved (lr 0 at the first update only)")
            if i == 0:
                loss1 = loss
                grads1 = [p.grad.detach().clone() for p in state.leaves()]
        # step 1 again, the GRU on its plain version: the loss of its own
        # forward (no kernel launched), then the gradients through the
        # plain loop on the kernel's output values
        ref_state = st.init_train_state(params, spec, device=device)
        real = ops_gru.gru_bidir_cat

        def plain(*a, matmul_dtype):
            return torch.cat(gru_bidir_reference(
                *a, matmul_dtype=matmul_dtype), -1)

        def plain_on_kernel_values(*a, matmul_dtype):
            with torch.no_grad():
                k = real(*a, matmul_dtype=matmul_dtype)
            r = plain(*a, matmul_dtype=matmul_dtype)
            return r + (k - r).detach()

        try:
            ops_gru.gru_bidir_cat = plain
            kernels.reset_launches()
            wn, wc = (torch.as_tensor(b, device=device) for b in batches[0])
            with torch.no_grad(), tf32_off():
                total, _ = losses.analysis_loss(
                    ref_state.params, wn, wc, C,
                    torch.Generator(device).manual_seed(SEED))
            torch.cuda.synchronize()
            if any(kernels.launches.values()):
                raise AssertionError(f"the plain step launched "
                                     f"{kernels.launches}")
            ops_gru.gru_bidir_cat = plain_on_kernel_values
            st.forward_backward(ref_state, *batches[0], C,
                                torch.Generator(device).manual_seed(SEED))
            torch.cuda.synchronize()
        finally:
            ops_gru.gru_bidir_cat = real
    finally:
        torch.backends.cudnn.deterministic = prev
    refs = [p.grad for p in ref_state.leaves()]
    top = max(float(r.abs().max()) for r in refs)
    errs = [float((g - r).abs().max()) / max(float(r.abs().max()),
                                             1e-3 * top)
            for g, r in zip(grads1, refs)]
    names = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        else:
            names.append(path)
    walk(ref_state.params, "")
    worst = sorted(zip(errs, names), reverse=True)[:3]
    log("  worst gradient leaves: " + ", ".join(f"{n} {e:.2e}"
                                                for e, n in worst))
    loss_err = abs(loss1 - float(total)) / abs(float(total))
    log(f"  step 1 against the plain GRU: loss {loss1:.6f} / "
        f"{float(total):.6f} (rel {loss_err:.2e}, tol {TRAIN_LOSS_RTOL:.0e});"
        f" {len(refs)} gradient leaves against the plain loop's on the "
        f"kernel's values, worst max |err| / max |ref| {max(errs):.2e} (tol "
        f"{TRAIN_GRAD_TOL:.0e}; median {sorted(errs)[len(errs) // 2]:.2e})")
    if loss_err > TRAIN_LOSS_RTOL or max(errs) > TRAIN_GRAD_TOL:
        raise AssertionError("the trainer's step with K6 disagrees with the "
                             "plain GRU's")
    del ref_state, refs, grads1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    split, walls = [], []
    for batch in batches[TRAIN_STEPS:]:
        wn, wc = (torch.as_tensor(b, device=device) for b in batch)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state.optimizer.zero_grad(set_to_none=True)
        ev[0].record()
        with tf32_off():
            total, _ = losses.analysis_loss(state.params, wn, wc, C, gen)
            ev[1].record()
            total.backward()
        ev[2].record()
        st.update(state)
        ev[3].record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        split.append([ev[k].elapsed_time(ev[k + 1]) for k in range(3)])
    peak = torch.cuda.max_memory_allocated(device)
    med = [sorted(c)[len(c) // 2] for c in zip(*split)]
    log(f"  ms per step (CUDA events, median of {TRAIN_TIMED}): forward "
        f"{med[0]:.2f}, backward {med[1]:.2f}, optimizer {med[2]:.2f}; "
        f"host clock {['%.1f' % w for w in walls]}; peak allocated "
        f"{peak / 2 ** 30:.2f} GiB on {torch.cuda.get_device_name(device)}")
    return counts, {"forward_ms": med[0], "backward_ms": med[1],
                    "optimizer_ms": med[2], "peak_bytes": peak}


def _int16(x):
    """What ``audio_io.save_wave`` writes of a float waveform in [-1, 1]."""
    import numpy as np
    return (np.asarray(x, np.float32) * 2 ** 15).astype(np.int16)


def _hold_file(what: str, path: str, ref):
    """The int16 file at ``path`` against ``ref`` written the same way:
    within FILE_LSB steps (16-bit quantisation of two float waveforms)."""
    import numpy as np
    from voicefixer_tpu_torch.utils import audio_io
    _, data = audio_io.read_audio(path)
    got = np.round(data[:, 0] * 2 ** 15).astype(np.int32)
    want = _int16(ref).astype(np.int32)
    if got.shape != want.shape:
        raise AssertionError(f"{what}: {got.shape} samples, want "
                             f"{want.shape}")
    err = int(np.abs(got - want).max())
    log(f"  {what}: {got.shape[0]} samples, max |file - reference| {err} "
        f"LSB (tol {FILE_LSB}); file vs float reference max abs "
        f"{float(np.abs(data[:, 0] - ref).max()):.3e}")
    if not err <= FILE_LSB:
        raise AssertionError(f"{what}: the file differs from the reference")


def phase_file_path(device, card: str, build_s: float):
    """The file and CLI entry points at full width: upstream-layout torch
    checkpoints drawn from SEED (the vocoder's with weight norm), written to
    a temporary directory and run through ``python -m voicefixer_tpu_torch``
    in this process on 45 s of audio: WAV to WAV in mode 0, FLAC to FLAC
    with 1 s of overlap (two windows, one batch), WAV to WAV in mode 1.
    Each run's launches are counted and asserted. The files are held to
    ``VoiceFixer(ckpt=..., vocoder_ckpt=...)`` on the same samples, mode 1's
    preprocessing on the card to the same on the CPU, and the ``Vocoder``
    facade to ``vocoder_facade.synthesize`` and its oracle's length."""
    import os
    import tempfile

    import numpy as np
    import torch
    from tools.torch_ref_state_dict import write_checkpoints
    from voicefixer_tpu_torch import __main__ as cli
    from voicefixer_tpu_torch import kernels
    from voicefixer_tpu_torch.config import DEFAULT_CONFIG as C
    from voicefixer_tpu_torch.models import analysis
    from voicefixer_tpu_torch.ops.precision import tf32_off
    from voicefixer_tpu_torch.pipeline import vocoder_facade
    from voicefixer_tpu_torch.pipeline.restore import (
        VoiceFixer, _fit_length, overlap_add, remove_higher_frequency)
    from voicefixer_tpu_torch.utils import audio_io

    t_phase = time.perf_counter()
    sr, seg = C.pipeline.sample_rate, C.pipeline.seg_length
    n = int(FILE_SECONDS * sr)
    log(f"== file path: python -m voicefixer_tpu_torch on full-width torch "
        f"checkpoints, {FILE_SECONDS} s of audio")
    with tempfile.TemporaryDirectory() as d:
        ana, voc = os.path.join(d, "vf.ckpt"), os.path.join(d, "model.pt")
        t0 = time.perf_counter()
        write_checkpoints(C, SEED, ana, voc, "weight_g")
        log(f"  checkpoints {os.path.getsize(ana) / 2 ** 20:.0f} + "
            f"{os.path.getsize(voc) / 2 ** 20:.0f} MiB written in "
            f"{time.perf_counter() - t0:.1f} s")
        wav = (0.1 * np.random.default_rng(SEED + 3).standard_normal(n)
               ).astype(np.float32)
        src = {"wav": os.path.join(d, "in.wav"),
               "flac": os.path.join(d, "in.flac")}
        for path in src.values():
            audio_io.save_wave(wav, path, sr)
        runs = {"mode 0, WAV": ("wav", "out0.wav", []),
                "overlap 1.0 s, FLAC": ("flac", "out_ov.flac",
                                        ["--chunk-overlap", "1.0"]),
                "mode 1, WAV": ("wav", "out1.wav", ["--mode", "1"])}
        # the CLI's precision is parity; each run is one batch of two
        want = expected_launches(4)
        walls, counts = {}, {}
        for what, (kind, out, extra) in runs.items():
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            rc = cli.main(["-i", src[kind], "-o", os.path.join(d, out),
                           "--ckpt", ana, "--vocoder-ckpt", voc, "--silent"]
                          + extra)
            torch.cuda.synchronize()
            walls[what] = time.perf_counter() - t0
            counts[what] = dict(kernels.launches)
            if rc != 0 or counts[what] != want:
                raise AssertionError(f"CLI {what}: exit {rc}, launches "
                                     f"{counts[what]} != {want}")
            log(f"  CLI {what}: {walls[what]:.2f} s, launches "
                f"{counts[what]}")

        vf = VoiceFixer(ckpt=ana, vocoder_ckpt=voc, config=C, device=device)
        x = audio_io.load_wav(src["wav"], sr)
        if not np.array_equal(audio_io.load_wav(src["flac"], sr), x):
            raise AssertionError("the FLAC input decodes to other samples")
        ref0 = vf.restore_inmem(x)
        log(f"  two restore_inmem of the same samples: max abs diff "
            f"{float(np.abs(vf.restore_inmem(x) - ref0).max()):.3e}")
        _hold_file("mode 0 file against restore_inmem",
                   os.path.join(d, "out0.wav"), ref0)
        ramp = min(sr, seg // 2)
        positions = list(range(0, n - seg + 1, seg - ramp))
        if positions[-1] + seg < n:
            positions.append(n - seg)
        outs, _ = vf._restore_batch(np.stack([x[p:p + seg]
                                              for p in positions]))
        _hold_file(f"overlap file against overlap_add of {len(positions)} "
                   "restore_batch windows", os.path.join(d, "out_ov.flac"),
                   overlap_add([_fit_length(o, seg) for o in outs],
                               positions, n, ramp))
        _hold_file("mode 1 file against restore_inmem(mode=1)",
                   os.path.join(d, "out1.wav"), vf.restore_inmem(x, mode=1))

        with tf32_off(), torch.inference_mode():
            hf = {dev: remove_higher_frequency(
                torch.from_numpy(x[:seg]).to(dev), C, return_cutoff=True)
                for dev in (device, torch.device("cpu"))}
        (a, cut_a), (b, cut_b) = hf[device], hf[torch.device("cpu")]
        err = float((a.cpu() - b).abs().max())
        log(f"  remove_higher_frequency, 30 s: cutoff bin {cut_a} on the "
            f"card, {cut_b} on the CPU; {a.shape[0]} samples, max abs diff "
            f"{err:.3e} (tol {HF_ATOL:.0e})")
        if cut_a != cut_b or a.shape != b.shape or not err <= HF_ATOL:
            raise AssertionError("mode 1's preprocessing: card and CPU "
                                 "disagree")

        voc_f = vocoder_facade.Vocoder(ckpt=voc, config=C, device=device)
        with tf32_off(), torch.inference_mode():
            mel = analysis.wav_to_mel(torch.from_numpy(x[None, :seg]).to(
                device), C)
            ref = vocoder_facade.synthesize(vf.vocoder_params, mel,
                                            C.vocoder)[..., 0].cpu().numpy()
        got = voc_f.forward(mel.cpu().numpy())
        t = n // C.stft.hop_length + 1
        oracle = voc_f.oracle(src["wav"], None)
        s_want = (t + t % 2 + 4) * C.vocoder.hop_length
        log(f"  Vocoder.forward on a 30 s mel {tuple(mel.shape)} -> "
            f"{got.shape}, equal to synthesize: "
            f"{bool(np.array_equal(got[:, 0], ref))}; oracle on the input "
            f"file -> {oracle.shape} (want (1, {s_want}))")
        if not np.array_equal(got[:, 0], ref) \
                or oracle.shape != (1, s_want) \
                or not np.isfinite(oracle).all():
            raise AssertionError("the Vocoder facade disagrees")
    first = next(iter(walls))
    log(f"  CLI wall seconds per audio second (model load, conversion, file "
        f"I/O and restore) on {card}: "
        + "; ".join(f"{k} {v / FILE_SECONDS:.4f}" for k, v in walls.items())
        + f"; {first} with the kernels' build ({build_s:.1f} s) "
        f"{(walls[first] + build_s) / FILE_SECONDS:.4f}; the phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return walls, counts


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
    same weights, tiny config, a 2.5-segment input with a padded tail; in
    mode 0, then in mode 2 (dropout 0, segment by segment)."""
    import dataclasses

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
    # mode 2 with dropout 0: the CPU's and the card's generators draw
    # different streams
    cfg0 = dataclasses.replace(cfg, denoiser=dataclasses.replace(
        cfg.denoiser, dropout=0.0))
    a, b = (VoiceFixer(cpu.params, cpu.vocoder_params, cfg0,
                       device=dev).restore_inmem(wav, mode=2, seed=SEED)
            for dev in (device, "cpu"))
    err = float(np.abs(a - b).max())
    log(f"  mode 2, dropout 0: max abs diff {err:.3e} over {len(a)} samples "
        "(tol 1e-4)")
    if a.shape != wav.shape or not err <= 1e-4:
        raise AssertionError("card and CPU disagree in mode 2")


# ----------------------------------------------------------------------
# Process groups: a world of one on the one card, and with --cards N
# one worker process a card (this script with --rank-worker) on NCCL.

PG_ATOL = 1e-5            # restore_wavs against restore_inmem, parity
#                           (the JAX package's, tests/test_parallel_inference.py:31)
PG_TRAIN_RTOL = 1e-6      # a step on a (1, 1) mesh against the step without
RANKS_TIMEOUT_S = 900     # a worker still running then is killed: a failure
# The multi-rank trainer against the one-process step on the whole batch
# with K6 on its plain version. The loss within RANKS_LOSS_RTOL. The
# gradients: their sums run in another order on the ranks (BN statistics
# all-reduced, each rank's loss mean, cuDNN at another batch), and the step's
# gradients are not continuous in its forward values (the L1 losses' signs,
# the ReLUs). Computing the one-process step's BN moments in two passes
# instead of torch.var_mean's one already moves a leaf by about 1e-3 of its
# largest element (tiny_test_config on the CPU, 3 s pairs), and at full
# width 1.14e-3 of the whole gradient's norm and 5e-2 of a leaf's largest
# element (this phase on 2 H100s, PERF.md). So it measures that spread for
# each reference (``_grad_errors`` of the two-pass step against the
# one-pass one) and holds the ranks' gradients to RANKS_SPREAD times it:
# the whole gradient against its norm, each leaf against its largest
# element (floored as TRAIN_GRAD_TOL's), never tighter than RANKS_GRAD_L2
# and RANKS_GRAD_LEAF. A gradient not averaged (an error of 1 or more), a
# sharded input's gradient not summed over the model group, or statistics
# of a rank's own rows exceed that many times over.
RANKS_LOSS_RTOL = 1e-5
RANKS_GRAD_L2, RANKS_GRAD_LEAF, RANKS_SPREAD = 1e-3, 1e-2, 4.0
# A file of the multi-process CLI against the one-process CLI's: int16
# samples within one step (the batches hold other rows, whose convolutions
# may sum in another order).
CLI_LSB = 1
TP_MARGIN_DB = 3.0        # the channel-sharded analysis rounds elsewhere


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _require_nccl(what: str):
    """Raise unless the process group is NCCL: on the card nothing may
    carry on on gloo."""
    import torch
    backend = torch.distributed.get_backend()
    if backend != "nccl":
        raise AssertionError(f"{what}: backend {backend}, not nccl")


def _noise(lengths, seed: int = SEED) -> list:
    """White noise of 0.1 sigma, one wave a length (samples), from seed."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [(0.1 * rng.standard_normal(n)).astype(np.float32)
            for n in lengths]


def rank_launches(size: int, vocoder_only: bool = False) -> dict:
    """A rank's launches per batch on a mesh with a model axis: one time
    shard of the vocoder a rank (``expected_launches`` of 2 shards,
    halved), the analysis stage whole (K5 and K6 replicated)."""
    want = expected_launches(size, shards=2)
    for k in ("res_stream", "res_chain", "res_shift_single"):
        want[k] //= 2
    if vocoder_only:
        want["stft_mel"] = want["gru_bidir"] = 0
    return want


def _hold_wavs(mode: str, what: str, got: list, ref: list, parity_ref: list):
    """Per file: parity within PG_ATOL of ref; production at an SNR against
    ref within SNR_MATCH_DB of production's SNR against parity."""
    import numpy as np
    for i, (g, r) in enumerate(zip(got, ref)):
        if g.shape != r.shape or not np.isfinite(g).all():
            raise AssertionError(f"{what}: file {i} shape {g.shape} / "
                                 f"{r.shape} or not finite")
        if mode == "parity":
            err = float(np.abs(g - r).max())
            log(f"  {mode} {what}, file {i} ({len(g)} samples): max abs "
                f"diff {err:.3e} (tol {PG_ATOL:.0e})")
            if not err <= PG_ATOL:
                raise AssertionError(f"{what}: file {i} differs")
        else:
            snr = _snr_db(g, r)
            floor = _snr_db(r, parity_ref[i]) - SNR_MATCH_DB
            log(f"  {mode} {what}, file {i}: SNR {snr:.2f} dB against "
                f"restore_inmem (must reach {floor:.2f})")
            if snr < floor:
                raise AssertionError(f"{what}: file {i} strays")


def _peak_per_row(vf, wav, rows=(1, 5)):
    """(fixed, per row) bytes of the peak allocated memory of restore_wavs
    over batches of rows[0] and rows[1] copies of one 30 s chunk."""
    import torch
    from voicefixer_tpu_torch.parallel.inference import restore_wavs
    peaks = []
    for r in rows:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        restore_wavs(vf, [wav] * r, 0)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
    per_row = (peaks[1] - peaks[0]) / (rows[1] - rows[0])
    return peaks[0] - rows[0] * per_row, per_row


def _train_pairs(n_pairs: int):
    """n_pairs of 3 s (clean, noisy = clean + 0.05 sigma noise)."""
    import numpy as np
    from voicefixer_tpu_torch.config import DEFAULT_CONFIG as C
    n = int(TRAIN_SECONDS * C.pipeline.sample_rate)
    rng = np.random.default_rng(SEED + 7)
    clean = (0.1 * rng.standard_normal((n_pairs, n))).astype(np.float32)
    noisy = (clean + 0.05 * rng.standard_normal((n_pairs, n))).astype(
        np.float32)
    return noisy, clean


def _dropout0(cfg):
    import dataclasses
    return dataclasses.replace(cfg, denoiser=dataclasses.replace(
        cfg.denoiser, dropout=0.0))


def phase_process_group(device):
    """The distributed entry points on a real NCCL group of one process:
    ``distributed.initialize`` from VF_COORDINATOR (localhost and a free
    port), VF_NUM_PROCESSES=1 and VF_PROCESS_ID=0; ``make_mesh()`` is
    (1, 1). restore_wavs in modes 0 and 1 over three waves (30.1 s, 0.25 s,
    60 s: five chunks, one batch), in both precisions, each file held to
    restore_inmem on the same VoiceFixer and each batch's launches counted;
    the peak allocated memory per chunk row; one trainer step pair on the
    mesh against the same steps without one. The group is taken down and
    the variables restored after."""
    import os

    import numpy as np
    import torch
    from voicefixer_tpu_torch import kernels
    from voicefixer_tpu_torch.config import DEFAULT_CONFIG as C
    from voicefixer_tpu_torch.models import analysis, vocoder
    from voicefixer_tpu_torch.ops.precision import precision
    from voicefixer_tpu_torch.parallel import distributed
    from voicefixer_tpu_torch.parallel.inference import restore_wavs
    from voicefixer_tpu_torch.parallel.mesh import make_mesh
    from voicefixer_tpu_torch.pipeline.restore import VoiceFixer
    from voicefixer_tpu_torch.train import step as st
    from voicefixer_tpu_torch import __main__ as cli

    t_phase = time.perf_counter()
    env = {"VF_COORDINATOR": f"localhost:{_free_port()}",
           "VF_NUM_PROCESSES": "1", "VF_PROCESS_ID": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    log(f"== process group of one: {env}")
    try:
        if not distributed.initialize():
            raise AssertionError("initialize() found no coordinator")
        _require_nccl("process group of one")
        mesh = make_mesh()
        shape = (mesh.size(0), mesh.size(1))
        log(f"  backend {torch.distributed.get_backend()}, mesh {shape} on "
            f"{distributed.local_device()}")
        if shape != (1, 1):
            raise AssertionError(f"mesh {shape}")
        gen = torch.Generator().manual_seed(SEED)
        ap = analysis.init(C, gen, device)
        vp = vocoder.init(C.vocoder, gen, device)
        vf = VoiceFixer(ap, vp, C, device=device, mesh=mesh)
        sr, seg = C.pipeline.sample_rate, C.pipeline.seg_length
        wavs = _noise([seg + sr // 10, sr // 4, 2 * seg])
        got, ref = {}, {}
        for mode in ("parity", "production"):
            size = 4 if mode == "parity" else 2
            with precision(mode):
                for m in (0, 1):
                    ref[mode, m] = [vf.restore_inmem(w, mode=m) for w in wavs]
                    torch.cuda.synchronize()
                    kernels.reset_launches()
                    t0 = time.perf_counter()
                    got[mode, m] = restore_wavs(vf, wavs, m)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    counts = dict(kernels.launches)
                    log(f"  {mode} restore_wavs mode {m}: 5 chunks in one "
                        f"batch, {wall * 1e3:.1f} ms, launches {counts}")
                    if counts != expected_launches(size):
                        raise AssertionError(
                            f"restore_wavs launches {counts} != "
                            f"{expected_launches(size)}")
                fixed, per_row = _peak_per_row(vf, wavs[2][:seg])
                rows_fit = int((0.9 * torch.cuda.get_device_properties(
                    device).total_memory - fixed) // per_row)
                log(f"  {mode} restore_wavs peak allocated memory: "
                    f"{per_row / 2 ** 30:.3f} GiB per 30 s chunk row "
                    f"+ {fixed / 2 ** 30:.3f} GiB fixed (batches of 1 and 5 "
                    f"rows); {rows_fit} rows fit 90 % of this card; the "
                    f"CLI's ROWS_PER_CARD is {cli.ROWS_PER_CARD}")
                if rows_fit < cli.ROWS_PER_CARD:
                    raise AssertionError("ROWS_PER_CARD rows do not fit")
        for mode in ("parity", "production"):
            for m in (0, 1):
                _hold_wavs(mode, f"restore_wavs mode {m}", got[mode, m],
                           ref[mode, m], ref["parity", m])
        del vf, ap, vp, got, ref
        torch.cuda.empty_cache()
        _pg_trainer(device, mesh)
    finally:
        distributed.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    log(f"  process-group phase took {time.perf_counter() - t_phase:.1f} s")


def _pg_trainer(device, mesh):
    """Two steps at DEFAULT_CONFIG on two 3 s pairs, warm-up 1 (the second
    update moves the parameters), on the (1, 1) mesh and without one, from
    one state and one generator seed, cuDNN deterministic: the losses
    equal, every leaf within PG_TRAIN_RTOL of its largest element."""
    import torch
    from voicefixer_tpu_torch.config import DEFAULT_CONFIG as C
    from voicefixer_tpu_torch.models import analysis
    from voicefixer_tpu_torch.train import step as st
    params = analysis.init(C, torch.Generator().manual_seed(SEED), device)
    noisy, clean = _train_pairs(TRAIN_BATCH)
    spec = st.reference_optimizer(warmup_steps=1)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    got = {}
    try:
        for m in (None, mesh):
            state = st.init_train_state(params, spec, device)
            if m is not None:
                state = st.place_train_state(state, m)
            step = st.make_train_step(C, spec, mesh=m)
            gen = torch.Generator(device).manual_seed(SEED)
            losses_ = []
            for _ in range(2):
                state, metrics = step(state, noisy, clean, gen)
                losses_.append(float(metrics["loss"]))
            got[m is None] = (losses_, [p.detach().clone()
                                        for p in state.leaves()])
            del state
    finally:
        torch.backends.cudnn.deterministic = prev
    err = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
              for a, b in zip(got[False][1], got[True][1]))
    log(f"  trainer on the (1, 1) mesh: losses {got[False][0]} against "
        f"{got[True][0]} without; leaves after the second update: worst "
        f"max |diff| / max |leaf| {err:.2e} (tol {PG_TRAIN_RTOL:.0e})")
    if got[False][0] != got[True][0] or err > PG_TRAIN_RTOL:
        raise AssertionError("the (1, 1) mesh's step differs")


def _rank_log(rank: int):
    def out(*a):
        log(f"  [rank {rank}]", *a)
    return out


def rank_worker(rank: int, n: int, port: int, d: str) -> int:
    """One rank of the --cards N phases, on card ``rank``: (a) restore_wavs
    on (N, 1), (b) the vocoder over NCCL on (1, N), (c) tensor-parallel
    restore on (1, N), (d) the trainer on (N, 1) and (N/2, 2). Reads the
    parent's inputs from ``d``, writes rank 0's outputs and every rank's
    report (rank_K.json) there."""
    import json
    import os

    import torch
    from voicefixer_tpu_torch.config import DEFAULT_CONFIG
    from voicefixer_tpu_torch.models import analysis, vocoder
    from voicefixer_tpu_torch.parallel import distributed
    from voicefixer_tpu_torch.parallel.mesh import make_mesh
    cfg = DEFAULT_CONFIG
    distributed.initialize(f"localhost:{port}", n, rank,
                           timeout_s=RANKS_TIMEOUT_S)
    device = distributed.local_device()
    say = _rank_log(rank)
    say(f"backend {torch.distributed.get_backend()} on {device} "
        f"({torch.cuda.get_device_name(device)})")
    _require_nccl(f"rank {rank}")
    report = {}
    try:
        gen = torch.Generator().manual_seed(SEED)
        ap = analysis.init(cfg, gen, device)
        vp = vocoder.init(cfg.vocoder, gen, device)
        dp, mp = make_mesh(n, 1), make_mesh(1, n)
        _rank_restore_wavs(cfg, ap, vp, dp, d, report, say)
        _rank_vocoder(cfg, vp, mp, d, report, say)
        _rank_tp_restore(cfg, ap, vp, mp, d, report, say)
        del ap, vp
        torch.cuda.empty_cache()
        _rank_trainer(cfg, dp, d, report, say)
    finally:
        distributed.shutdown()
    with open(os.path.join(d, f"rank_{rank}.json"), "w") as f:
        json.dump(report, f)
    return 0


def _rank_sync():
    import torch
    from voicefixer_tpu_torch.parallel import distributed
    torch.cuda.synchronize()
    distributed.barrier()


def _rank_restore_wavs(cfg, ap, vp, mesh, d, report, say):
    """(a): 2N + 1 chunks (a (2N - 1) x 30 s + 0.1 s wave and a 0.25 s
    one) on the (N, 1) mesh, both precisions; every rank's launches per
    batch; rank 0 holds each file to restore_inmem on its own card. The
    aggregate audio-s/s of the N cards, best of 3."""
    import numpy as np
    import torch
    from voicefixer_tpu_torch import kernels
    from voicefixer_tpu_torch.ops.precision import precision
    from voicefixer_tpu_torch.parallel.inference import restore_wavs
    from voicefixer_tpu_torch.pipeline.restore import VoiceFixer
    n, rank = mesh.size(0), mesh.get_local_rank("data")
    sr, seg = cfg.pipeline.sample_rate, cfg.pipeline.seg_length
    wavs = _noise([(2 * n - 1) * seg + sr // 10, sr // 4], SEED + 11)
    seconds = sum(len(w) for w in wavs) / sr
    vf = VoiceFixer(ap, vp, cfg, device=ap["unet"]["after2"]["w"].device,
                    mesh=mesh)
    got, ref = {}, {}
    for mode in ("parity", "production"):
        with precision(mode):
            restore_wavs(vf, wavs)  # warm-up
            _rank_sync()
            kernels.reset_launches()
            got[mode] = restore_wavs(vf, wavs)
            counts = dict(kernels.launches)
            want = expected_launches(4 if mode == "parity" else 2)
            if counts != want:
                raise AssertionError(f"restore_wavs launches {counts} != "
                                     f"{want}")
            walls = []
            for _ in range(3):
                _rank_sync()
                t0 = time.perf_counter()
                restore_wavs(vf, wavs)
                _rank_sync()
                walls.append(time.perf_counter() - t0)
            report[f"dp_{mode}_audio_s_per_s"] = seconds / min(walls)
            report[f"dp_{mode}_wall_ms"] = [w * 1e3 for w in walls]
            say(f"(a) {mode} restore_wavs of {seconds:.2f} s in "
                f"{3 * n} rows ({2 * n + 1} chunks): "
                f"{['%.1f' % (w * 1e3) for w in walls]} ms, "
                f"{seconds / min(walls):.1f} audio-s/s on {n} cards; "
                f"launches {counts}")
            if rank == 0:
                ref[mode] = [vf.restore_inmem(w) for w in wavs]
    if rank == 0:
        for mode in ("parity", "production"):
            _hold_wavs(mode, "(a) restore_wavs on the data axis", got[mode],
                       ref[mode], ref["parity"])


def _rank_vocoder(cfg, vp, mesh, d, report, say):
    """(b): synthesize_sp on the (1, N) mesh on the parent's denoised mel of
    the 30 s chunk, both precisions: a rank's launches, the halo exchange's
    ms by CUDA events around each exchange (summed per stage), ms per chunk
    best of 3; rank 0 writes the waveform."""
    import os

    import numpy as np
    import torch
    from voicefixer_tpu_torch import kernels
    from voicefixer_tpu_torch.ops.precision import precision, tf32_off
    from voicefixer_tpu_torch.parallel import sp
    rank = mesh.get_local_rank("model")
    device = vp["pre"]["w"].device
    real = sp._exchange_halo_ranks
    marks = []

    def timed(x, h, m):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        y = real(x, h, m)
        b.record()
        marks.append((a, b))
        return y

    for mode in ("parity", "production"):
        mel = torch.from_numpy(np.load(os.path.join(d, f"mel_{mode}.npy"))
                               ).to(device)
        with precision(mode), tf32_off(), torch.inference_mode():
            def synth():
                return sp.synthesize_sp(vp, mel, cfg.vocoder, mesh=mesh)
            synth()
            _rank_sync()
            kernels.reset_launches()
            sp._exchange_halo_ranks = timed
            try:
                out = synth()
            finally:
                sp._exchange_halo_ranks = real
            torch.cuda.synchronize()
            counts = dict(kernels.launches)
            want = rank_launches(4 if mode == "parity" else 2, True)
            if counts != want:
                raise AssertionError(f"vocoder launches {counts} != {want}")
            ms = [a.elapsed_time(b) for a, b in marks]
            marks.clear()
            stages = [ms[2 * i] + ms[2 * i + 1] for i in range(4)] + ms[8:]
            walls = []
            for _ in range(3):
                _rank_sync()
                t0 = time.perf_counter()
                synth()
                _rank_sync()
                walls.append((time.perf_counter() - t0) * 1e3)
        report[f"sp_{mode}_halo_ms"] = stages
        report[f"sp_{mode}_ms"] = walls
        say(f"(b) {mode} vocoder over NCCL: halo exchange ms per stage "
            f"(upsample's row + the ResStack's halo; then the post-conv's) "
            f"{['%.3f' % t for t in stages]}, {sum(stages):.2f} ms of a "
            f"chunk; ms per chunk {['%.1f' % w for w in walls]}; launches "
            f"{counts}")
        if rank == 0:
            np.save(os.path.join(d, f"voc_{mode}.npy"),
                    out.float().cpu().numpy())


def _rank_tp_restore(cfg, ap, vp, mesh, d, report, say):
    """(c): restore_inmem of the 30 s chunk on VoiceFixer(mesh=(1, N)), both
    precisions: a rank's launches, ms per chunk best of 3; rank 0 writes
    the outputs. Then conv_block_kernel=True: no conv_block_res launch."""
    import os

    import numpy as np
    import torch
    from voicefixer_tpu_torch import kernels
    from voicefixer_tpu_torch.ops.precision import precision
    from voicefixer_tpu_torch.pipeline.restore import VoiceFixer
    rank = mesh.get_local_rank("model")
    device = vp["pre"]["w"].device
    wav = _noise([cfg.pipeline.seg_length])[0]
    for cb in (False, True):
        vf = VoiceFixer(ap, vp, cfg, device=device, mesh=mesh,
                        conv_block_kernel=cb)
        leaf = vf.params["unet"]["center"]["conv1"]["w"]
        for mode in (("parity", "production") if not cb else ("parity",)):
            with precision(mode):
                vf.restore_inmem(wav)
                _rank_sync()
                kernels.reset_launches()
                out = vf.restore_inmem(wav)
                counts = dict(kernels.launches)
                want = rank_launches(4 if mode == "parity" else 2)
                if counts != want:
                    raise AssertionError(f"TP restore launches {counts} != "
                                         f"{want}")
                if cb:
                    say(f"(c) conv_block_kernel=True under the model axis: "
                        f"launches {counts} (conv_block_res 0)")
                    continue
                walls = []
                for _ in range(3):
                    _rank_sync()
                    t0 = time.perf_counter()
                    vf.restore_inmem(wav)
                    _rank_sync()
                    walls.append((time.perf_counter() - t0) * 1e3)
                report[f"tp_{mode}_ms"] = walls
                say(f"(c) {mode} tensor-parallel restore: ms per 30 s chunk "
                    f"{['%.1f' % w for w in walls]}; launches {counts}; "
                    f"the centre block's conv1 {tuple(leaf.shape)} on this "
                    "rank")
                if rank == 0:
                    np.save(os.path.join(d, f"tp_{mode}.npy"), out)
        del vf
        torch.cuda.empty_cache()


def _rank_trainer(cfg, dp, d, report, say):
    """(d): the trainer at dropout 0 on (N, 1), then (N/2, 2) for N >= 4,
    two 3 s pairs a data rank: step 1's loss and gradients (gathered
    whole) written by rank 0; then TRAIN_TIMED steps split into forward,
    backward, all-reduce and optimizer by CUDA events, and the peak of
    allocated memory."""
    import os

    import numpy as np
    import torch
    from voicefixer_tpu_torch.models import analysis
    from voicefixer_tpu_torch.ops.precision import tf32_off
    from voicefixer_tpu_torch.parallel import tp
    from voicefixer_tpu_torch.parallel.mesh import (axis_group, axis_size,
                                                    make_mesh, shard_batch)
    from voicefixer_tpu_torch.parallel.sharding import (gather_params,
                                                        param_specs)
    from voicefixer_tpu_torch.train import losses
    from voicefixer_tpu_torch.train import step as st
    from voicefixer_tpu_torch.utils.weights import tree_leaves, tree_map
    from voicefixer_tpu_torch.parallel import distributed
    device = distributed.local_device()
    n = dp.size(0)
    cfg0 = _dropout0(cfg)
    with np.load(os.path.join(d, "train_batch.npz")) as z:
        noisy, clean = torch.from_numpy(z["noisy"]), torch.from_numpy(
            z["clean"])
    params = analysis.init(cfg, torch.Generator().manual_seed(SEED), device)
    spec = st.reference_optimizer(warmup_steps=1)
    shapes = [(n, 1)] + ([(n // 2, 2)] if n >= 4 else [])
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for nd, nm in shapes:
            tag = f"{nd}x{nm}"
            mesh = dp if nm == 1 else make_mesh(nd, nm)
            rank = torch.distributed.get_rank()
            state = st.place_train_state(
                st.init_train_state(params, spec, device), mesh)
            step = st.make_train_step(cfg0, spec, mesh=mesh)
            rows = TRAIN_BATCH * nd
            wn, wc = (shard_batch(mesh, t[:rows]).to(device)
                      for t in (noisy, clean))
            state, m = step(state, wn, wc)
            grads = gather_params(
                tree_map(lambda p: p.grad.detach(), state.params),
                param_specs(params, nm), mesh)
            if rank == 0:
                np.savez(os.path.join(d, f"train_{tag}.npz"),
                         loss=np.array(float(m["loss"])),
                         **{f"g{j}": g.cpu().numpy()
                            for j, g in enumerate(tree_leaves(grads))})
            del grads
            gen = None
            split = []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            for _ in range(TRAIN_TIMED):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
                _rank_sync()
                state.optimizer.zero_grad(set_to_none=True)
                ev[0].record()
                with tf32_off(), tp.use_mesh(mesh), \
                        tp.global_batch_stats(mesh):
                    total, _ = losses.analysis_loss(state.params, wn, wc,
                                                    cfg0, gen)
                    ev[1].record()
                    total.backward()
                ev[2].record()
                for p in state.leaves():
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                if axis_size(mesh, "data") > 1:
                    st.all_reduce_mean([p.grad for p in state.leaves()],
                                       axis_group(mesh, "data"))
                ev[3].record()
                st.update(state)
                ev[4].record()
                torch.cuda.synchronize()
                split.append([ev[k].elapsed_time(ev[k + 1])
                              for k in range(4)])
            peak = torch.cuda.max_memory_allocated(device)
            med = [sorted(c)[len(c) // 2] for c in zip(*split)]
            report[f"train_{tag}_ms"] = med
            report[f"train_{tag}_peak_bytes"] = peak
            say(f"(d) trainer on ({nd}, {nm}), {TRAIN_BATCH} pairs a data rank: ms per "
                f"step (events, median of {TRAIN_TIMED}) forward {med[0]:.2f}, "
                f"backward {med[1]:.2f}, all-reduce {med[2]:.2f} "
                f"({med[2] / sum(med):.1%}), optimizer {med[3]:.2f}; peak "
                f"allocated {peak / 2 ** 30:.2f} GiB")
            del state, step
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = prev


def _two_pass_moments(x, dims=None):
    """``parallel.tp.batch_moments``'s sums on one process: the mean, then
    the mean square deviation."""
    def total(t):
        return t.sum() if dims is None else t.sum(dim=dims)
    count = x.numel() if dims is None else x.numel() // x.shape[-1]
    mean = total(x) / count
    d = x - mean
    return mean, total(d * d) / count


def _trainer_reference(cfg, device, noisy, clean, two_pass: bool = False):
    """The one-process step on the whole batch at dropout 0 with K6 on its
    plain version, cuDNN deterministic, as the trainer phase holds its
    step: the loss of the plain forward, and the gradients of the plain
    loop taken on K6's output values, K6 launched on TRAIN_BATCH rows at a
    time as each data rank launches it. ``two_pass``: the BN moments in
    two passes, as the ranks sum them, for the spread of the gradients
    under another rounding of the same step."""
    import torch
    from voicefixer_tpu_torch.kernels.gru import gru_bidir_reference
    from voicefixer_tpu_torch.models import analysis, denoiser
    from voicefixer_tpu_torch.ops import conv
    from voicefixer_tpu_torch.ops import gru as ops_gru
    from voicefixer_tpu_torch.ops.precision import tf32_off
    from voicefixer_tpu_torch.train import losses
    from voicefixer_tpu_torch.train import step as st
    cfg0 = _dropout0(cfg)
    params = analysis.init(cfg, torch.Generator().manual_seed(SEED), device)
    state = st.init_train_state(params, st.reference_optimizer(), device)
    real = ops_gru.gru_bidir_cat

    def plain(*a, matmul_dtype):
        return torch.cat(gru_bidir_reference(*a, matmul_dtype=matmul_dtype),
                         -1)

    def plain_on_kernel_values(xf, xb, *a, matmul_dtype):
        with torch.no_grad():
            k = torch.cat([real(xf[i:i + TRAIN_BATCH], xb[i:i + TRAIN_BATCH],
                                *a, matmul_dtype=matmul_dtype)
                           for i in range(0, xf.shape[0], TRAIN_BATCH)])
        r = plain(xf, xb, *a, matmul_dtype=matmul_dtype)
        return r + (k - r).detach()

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    moments = conv.batch_moments
    if two_pass:
        conv.batch_moments = denoiser.batch_moments = _two_pass_moments
    wn, wc = (torch.as_tensor(t, device=device) for t in (noisy, clean))
    try:
        ops_gru.gru_bidir_cat = plain
        with torch.no_grad(), tf32_off():
            total, _ = losses.analysis_loss(state.params, wn, wc, cfg0)
        ops_gru.gru_bidir_cat = plain_on_kernel_values
        st.forward_backward(state, wn, wc, cfg0)
    finally:
        ops_gru.gru_bidir_cat = real
        conv.batch_moments = denoiser.batch_moments = moments
        torch.backends.cudnn.deterministic = prev
    return float(total), [p.grad.detach().cpu() for p in state.leaves()]


def phase_ranks(n: int, vf, wav, outs):
    """The --cards N multi-process phases: inputs and references here (the
    denoised mel and the vocoder's output one-process sharded over the N
    cards and unsharded; the trainer's one-process step on the whole
    batch), then N workers, one a card, on NCCL (timeout RANKS_TIMEOUT_S),
    then (b)-(d) held here, then (e) the CLI in folder mode over 2N files
    with --coordinator, against the one-process CLI."""
    import json
    import os
    import tempfile

    import numpy as np
    import torch
    from voicefixer_tpu_torch.config import DEFAULT_CONFIG as C
    from voicefixer_tpu_torch.ops.precision import precision, tf32_off
    from voicefixer_tpu_torch.parallel.sp import synthesize_sp
    from voicefixer_tpu_torch.pipeline import vocoder_facade
    from voicefixer_tpu_torch.utils.weights import tree_map
    device = vf.device
    cards = _cards(n)
    with tempfile.TemporaryDirectory() as d:
        log(f"== {n} processes on {n} cards, NCCL")
        voc_ref, voc_sp, voc_sp_ms = {}, {}, {}
        copies = [tree_map(lambda t, c=c: t.to(c), vf.vocoder_params)
                  for c in cards]
        for mode in ("parity", "production"):
            with precision(mode), tf32_off(), torch.inference_mode():
                _, mel = _denoised_mel(vf, wav, device)
                np.save(os.path.join(d, f"mel_{mode}.npy"),
                        mel.float().cpu().numpy())
                voc_ref[mode, "30s"] = vocoder_facade.synthesize(
                    vf.vocoder_params, mel, C.vocoder).float().cpu().numpy()
                sharded = lambda: synthesize_sp(  # noqa: E731
                    copies, mel, C.vocoder, cards)
                voc_sp[mode] = sharded().float().cpu().numpy()
                voc_sp_ms[mode] = cuda_ms(sharded, 3)
            log(f"  {mode} vocoder one process over {n} cards: "
                f"{voc_sp_ms[mode]:.1f} ms per 30 s chunk (CUDA events)")
        noisy, clean = _train_pairs(2 * n)
        np.savez(os.path.join(d, "train_batch.npz"), noisy=noisy,
                 clean=clean)
        train_ref, spread = {}, {}
        for tag, rows in [(f"{n}x1", 2 * n)] + ([(f"{n // 2}x2", n)]
                                                 if n >= 4 else []):
            train_ref[tag] = _trainer_reference(C, device, noisy[:rows],
                                                clean[:rows])
            _, other = _trainer_reference(C, device, noisy[:rows],
                                          clean[:rows], True)
            spread[tag] = _grad_errors(other, train_ref[tag][1])
            log(f"  {rows} pairs: the one-process step's gradients with its "
                "BN moments in two passes against one (the spread of "
                f"another rounding): whole {spread[tag][0]:.2e} of its "
                "norm; worst leaves " + ", ".join(
                    f"{nm} {e:.2e}" for e, nm in spread[tag][1][:3]))
        del copies
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

        port = _free_port()
        failed = _run_ranks(
            [[sys.executable, os.path.abspath(__file__), "--rank-worker",
              str(k), str(n), str(port), d] for k in range(n)], d, "rank")
        if failed:
            raise AssertionError(f"rank workers failed: {failed}")
        reports = []
        for k in range(n):
            with open(os.path.join(d, f"rank_{k}.json")) as f:
                reports.append(json.load(f))

        for mode in ("parity", "production"):
            got = np.load(os.path.join(d, f"voc_{mode}.npy"))
            err = float(np.abs(got - voc_sp[mode]).max())
            log(f"  {mode} (b) vocoder over NCCL against one process over "
                f"the same {n} cards: max abs diff {err:.3e}")
            if mode == "parity" and not err <= 1e-6:
                raise AssertionError("(b) differs from the one-process "
                                     "sharded vocoder")
            _held_to_default(mode, f"(b) vocoder over {n} ranks",
                             got[..., 0], {k: v[..., 0] for k, v in
                                           voc_ref.items()}, SHARD_ATOL)
            halo = [r[f"sp_{mode}_halo_ms"] for r in reports]
            log(f"  {mode} (b) halo exchange ms per stage, per rank: "
                + "; ".join(str(['%.3f' % t for t in h]) for h in halo)
                + f"; ms per chunk (rank 0) "
                f"{min(reports[0][f'sp_{mode}_ms']):.1f} against "
                f"{voc_sp_ms[mode]:.1f} in one process")
            tp_out = np.load(os.path.join(d, f"tp_{mode}.npy"))
            _held_to_default(mode, f"(c) tensor parallel over {n} ranks",
                             tp_out, outs, SHARD_ATOL, TP_MARGIN_DB)
            log(f"  {mode} (a) {reports[0][f'dp_{mode}_audio_s_per_s']:.1f} "
                f"audio-s/s on {n} cards; (c) "
                f"{min(reports[0][f'tp_{mode}_ms']):.1f} ms per 30 s chunk")
        for tag, (loss, ref) in train_ref.items():
            with np.load(os.path.join(d, f"train_{tag}.npz")) as z:
                got_loss = float(z["loss"])
                grads = [z[f"g{j}"] for j in range(len(ref))]
            whole, worst = _grad_errors(grads, ref)
            tol_whole = max(RANKS_GRAD_L2, RANKS_SPREAD * spread[tag][0])
            tol_leaf = max(RANKS_GRAD_LEAF,
                           RANKS_SPREAD * spread[tag][1][0][0])
            rel = abs(got_loss - loss) / abs(loss)
            ms = reports[0][f"train_{tag}_ms"]
            log(f"  (d) trainer on ({tag.replace('x', ', ')}) against one "
                f"process on the whole batch with the plain GRU: loss "
                f"{got_loss:.6f} / {loss:.6f} (rel {rel:.2e}, tol "
                f"{RANKS_LOSS_RTOL:.0e}); whole gradient {whole:.2e} of its "
                f"norm (tol {tol_whole:.2e}); worst leaves "
                + ", ".join(f"{nm} {e:.2e}" for e, nm in worst[:3])
                + f" (tol {tol_leaf:.2e}); ms per step {sum(ms):.2f}, "
                f"all-reduce {ms[2] / sum(ms):.1%}")
            if rel > RANKS_LOSS_RTOL or whole > tol_whole \
                    or worst[0][0] > tol_leaf:
                raise AssertionError(f"(d) the trainer on {tag} disagrees")
        _ranks_cli(n, vf, d)


def _grad_errors(got: list, ref: list):
    """(|got - ref| / |ref| over every leaf at once, [(error, name)] of each
    leaf's max |got - ref| over its largest |ref|, floored at 1e-3 of the
    largest anywhere, worst first)."""
    import numpy as np
    ref = [np.asarray(r, np.float64) for r in ref]
    got = [np.asarray(g, np.float64) for g in got]
    top = max(float(np.abs(r).max()) for r in ref)
    errs = [float(np.abs(g - r).max()) / max(float(np.abs(r).max()),
                                             1e-3 * top)
            for g, r in zip(got, ref)]
    whole = math.sqrt(sum(float(((g - r) ** 2).sum())
                          for g, r in zip(got, ref))
                      / sum(float((r ** 2).sum()) for r in ref))
    names = _leaf_names()
    return whole, sorted(zip(errs, names), reverse=True)


def _cards(n: int) -> tuple:
    import torch
    return tuple(torch.device("cuda", i) for i in range(n))


def _leaf_names() -> list:
    """The analysis tree's leaf paths, in its order."""
    import torch
    from voicefixer_tpu_torch.config import DEFAULT_CONFIG as cfg
    from voicefixer_tpu_torch.models import analysis
    names = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        else:
            names.append(path)
    walk(analysis.init(cfg, torch.Generator(), "meta"), "")
    return names


def _run_ranks(cmds: list, d: str, what: str) -> list:
    """Run one process a command, their output to files in ``d``, and wait
    for all under RANKS_TIMEOUT_S; echo each one's standard output. A
    process that fails or outlasts the timeout is a failure, listed in the
    result; none is left running. Returns the failures."""
    import os
    logs = [(open(os.path.join(d, f"{what}{k}.out"), "w+"),
             open(os.path.join(d, f"{what}{k}.err"), "w+"))
            for k in range(len(cmds))]
    procs = [subprocess.Popen(c, stdout=o, stderr=e, text=True)
             for c, (o, e) in zip(cmds, logs)]
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    failed = []
    try:
        for k, p in enumerate(procs):
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                failed.append(f"{what} {k}: still running after "
                              f"{RANKS_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for k, (p, (o, e)) in enumerate(zip(procs, logs)):
        o.seek(0)
        e.seek(0)
        for line in o.read().splitlines():
            log(line)
        if p.returncode:
            failed.append(f"{what} {k}: exit {p.returncode}")
            log(f"  [{what} {k}] stderr:\n{e.read()[-4000:]}")
        o.close()
        e.close()
    return failed


def _ranks_cli(n: int, vf, d: str):
    """(e): the CLI in folder mode over 2N files (1.0 to 3.1 s) with
    --coordinator localhost:<port> in N processes, and in this process
    without: the same file names, each rank reporting its share files[k::N]
    in one batched run, every file within CLI_LSB of the one-process
    file."""
    import os

    import numpy as np
    import torch
    from voicefixer_tpu_torch import __main__ as cli
    from voicefixer_tpu_torch.models import analysis, vocoder
    from voicefixer_tpu_torch.utils import audio_io
    from voicefixer_tpu_torch.utils.weights import save_pytree_npz
    cfg = vf.config
    sr = cfg.pipeline.sample_rate
    indir = os.path.join(d, "in")
    os.makedirs(indir)
    for i, w in enumerate(_noise([int(sr * (1.0 + 0.3 * i))
                                  for i in range(2 * n)], SEED + 13)):
        audio_io.save_wave(w, os.path.join(indir, f"f{i}.wav"), sr)
    ana, voc = os.path.join(d, "ana.npz"), os.path.join(d, "voc.npz")
    gen = torch.Generator().manual_seed(SEED)
    save_pytree_npz(analysis.init(cfg, gen), ana)
    save_pytree_npz(vocoder.init(cfg.vocoder, gen), voc)
    flags = ["--ckpt", ana, "--vocoder-ckpt", voc]
    one = os.path.join(d, "one")
    t0 = time.perf_counter()
    cli.main(["-ifdr", indir, "-ofdr", one, "--silent"] + flags)
    log(f"  (e) one-process CLI over {2 * n} files: "
        f"{time.perf_counter() - t0:.1f} s")
    out = os.path.join(d, "out")
    port = _free_port()
    t0 = time.perf_counter()
    failed = _run_ranks(
        [[sys.executable, "-m", "voicefixer_tpu_torch", "-ifdr", indir,
          "-ofdr", out, "--coordinator", f"localhost:{port}",
          "--num-processes", str(n), "--process-id", str(k)] + flags
         for k in range(n)], d, "cli")
    if failed:
        raise AssertionError(f"(e) CLI processes failed: {failed}")
    log(f"  (e) CLI in {n} processes: {time.perf_counter() - t0:.1f} s "
        "(each process's start-up included)")
    files = sorted(os.listdir(indir))
    if sorted(os.listdir(out)) != sorted(os.listdir(one)):
        raise AssertionError(f"(e) files {sorted(os.listdir(out))}")
    for k in range(n):
        with open(os.path.join(d, f"cli{k}.out")) as f:
            lines = [ln for ln in f.read().splitlines() if "files, mode" in ln]
        share = len(files[k::n])
        if len(lines) != 1 or f"({share} files, mode 0, process {k}/{n})" \
                not in lines[0]:
            raise AssertionError(f"(e) rank {k} did not restore its "
                                 f"{share} files: {lines}")
    worst = 0
    for f in files:
        a, b = (np.round(audio_io.read_audio(os.path.join(p, f))[1][:, 0]
                         * 2 ** 15).astype(np.int32) for p in (out, one))
        if a.shape != b.shape:
            raise AssertionError(f"(e) {f}: {a.shape} != {b.shape}")
        worst = max(worst, int(np.abs(a - b).max()))
    log(f"  (e) {len(files)} files, each written by the rank files[k::{n}] "
        f"gives it, against the one-process CLI: worst {worst} int16 steps "
        f"(tol {CLI_LSB})")
    if worst > CLI_LSB:
        raise AssertionError("(e) the multi-process CLI's files differ")


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
    if sys.argv[1:2] == ["--rank-worker"]:
        rank, n, port = (int(a) for a in sys.argv[2:5])
        return rank_worker(rank, n, port, sys.argv[5])
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = phase_card()
    build_s = phase_build()
    if len(sys.argv) > 1:
        if len(sys.argv) != 3 or sys.argv[1] != "--cards" \
                or not 2 <= int(sys.argv[2]) <= torch.cuda.device_count():
            print("chip_smoke: usage: chip_smoke.py [--cards N], 2 <= N <= "
                  f"{torch.cuda.device_count()} cards", file=sys.stderr)
            return 2
        n = int(sys.argv[2])
        phase_ranks(n, *phase_cards(n))
        log(f"== done in {time.perf_counter() - t_start:.1f} s on {n} cards")
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    rows = phase_kernels(device)
    vf, wav, outs, counts = phase_main_path(device)
    sp_counts = phase_sharded_path(vf, wav, outs, device)
    cb_counts = phase_conv_block_path(vf, wav, outs, device)
    gru_counts = phase_gru_path(device)
    gru_bwd = phase_gru_backward(device)
    phase_mode2_path(vf, wav, outs, device)
    phase_vocoder_hook(vf, wav, device)
    del vf, outs
    phase_trainer(device)
    phase_process_group(device)
    phase_small_reference(device)
    phase_file_path(device, card, build_s)

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
            if name == "gru_bidir":  # per trainer step: 4 launches' backward
                record[-1]["backward_ms"] = 4 * gru_bwd[dtype]["ms"]
                record[-1]["library_backward_ms"] = \
                    4 * gru_bwd[dtype]["library_ms"]
    log(f"== done in {time.perf_counter() - t_start:.1f} s; times are per "
        "30 s chunk (B=1), summed over the launches that the kernel's path "
        "makes (the default path; res_stream: the sharded path; "
        "conv_block_res: the conv-block path; gru_seq: the GRU path); "
        "gru_bidir's backward_ms and library_backward_ms per trainer step "
        f"(4 launches at B={TRAIN_BATCH}, T={TRAIN_FRAMES})")
    print(json.dumps({"kernels": record}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
