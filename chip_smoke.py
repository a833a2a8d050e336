#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: build every kernel of the
mode-0 path from the sources in this checkout, hold each against its plain
PyTorch version at the main path's shapes, drive full-width mode-0 restore
through ``VoiceFixer`` in parity and production precision, and check the
output.

    python3 chip_smoke.py

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
}
SOURCES = {
    "stft_mel": "voicefixer_tpu_torch/csrc/stft_mel.cu",
    "gru_bidir": "voicefixer_tpu_torch/csrc/gru_bidir.cu",
    "upsample": "voicefixer_tpu_torch/csrc/upsample.cu",
}
# launches of each kernel per batch of the mode-0 path
PER_BATCH = {"stft_mel": 1, "gru_bidir": 4, "upsample": 4}
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


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# The least work of each kernel's function, (FLOPs, bytes), each input read
# once and each output written once. tools/kernel_work.py uses them too.

def stft_work(n: int, t: int, n_fft: int, n_freqs: int, n_mels: int):
    """STFT -> magnitude -> mel of an n-sample float32 wave into t frames, as
    an FFT computes it: a real FFT of n_fft points per frame (2.5 n log2 n
    FLOPs), the magnitude of each bin, the mel product. The dense DFT that
    the kernel runs is 25x more work than this."""
    flops = (t * 2.5 * n_fft * math.log2(n_fft) + 4 * t * n_freqs
             + 2 * t * n_freqs * n_mels)
    return flops, 4 * (n + n_freqs * n_mels + t * n_mels)


def gru_work(t: int, h: int, w_size: int):
    """Both directions of one GRU layer over t steps: float32 projections
    in, h·W_hh and the gates per step, float32 states out."""
    flops = 2 * t * (2 * h * 3 * h + 12 * h)
    return flops, 4 * (2 * t * 3 * h + 2 * 3 * h + 2 * t * h) \
        + 2 * h * 3 * h * w_size


def upsample_work(t: int, s: int, cin: int, cout: int, size: int):
    """x + sin(x), then a ConvTranspose1d of kernel 2s and stride s: two
    taps of Cin x Cout per output sample."""
    return (2 * t * s * 2 * cin * cout,
            size * (t * cin + 2 * s * cin * cout + cout + t * s * cout))


def compare(name, got, ref, rtol, atol):
    """Max abs error; raises when |got - ref| > atol + rtol*|ref| anywhere."""
    import torch
    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - ref).abs()
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
                if "registers" in line or "spill" in line:
                    log(f"  {name}: {line.strip()}")


def _stft_case(gen, device):
    import torch
    from voicefixer_tpu_torch.config import DEFAULT_CONFIG as C
    from voicefixer_tpu_torch.kernels import stft
    from voicefixer_tpu_torch.models.analysis import mel_fbank
    from voicefixer_tpu_torch.ops.stft import num_frames
    n = C.pipeline.seg_length
    wav = (0.1 * torch.randn((1, n), generator=gen)).to(device)
    fb = mel_fbank(C, device)
    flops, work_bytes = stft_work(n, num_frames(n, C.stft), C.stft.n_fft,
                                  C.stft.n_freqs, fb.shape[1])
    fn = lambda: stft.stft_mel(wav, fb, C.stft)  # noqa: E731
    plain = lambda: stft.stft_mel_reference(wav, fb, C.stft)  # noqa: E731
    win = torch.hann_window(C.stft.win_length, periodic=True, device=device)

    def library():
        spec = torch.stft(wav, C.stft.n_fft, C.stft.hop_length,
                          C.stft.win_length, window=win, center=True,
                          pad_mode="reflect", return_complex=True)
        return spec.abs().transpose(1, 2) @ fb

    return {"name": "stft_mel", "dtype": "float32", "shape": f"wav [1, {n}]",
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
            "pair": True,
            "rtol": 1e-4 if dtype == "float32" else 2e-2,
            "atol": 1e-4 if dtype == "float32" else 2e-2,
            "per_chunk": 4, "bytes": work_bytes, "flops": flops,
            "peak": PEAK_FP32 if dtype == "float32" else PEAK_BF16}


def _upsample_case(gen, device, dtype, stage, t):
    import torch
    import torch.nn.functional as F
    from voicefixer_tpu_torch.config import DEFAULT_CONFIG as C
    from voicefixer_tpu_torch.kernels import upsample
    v = C.vocoder
    s = v.upsample_scales[stage]
    cin, cout = v.channels // 2 ** stage, v.channels // 2 ** (stage + 1)
    dt = getattr(torch, dtype)
    bound = (1 / (cin * 2 * s)) ** 0.5
    x = torch.randn((1, t, cin), generator=gen).to(device, dt)
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
    return {"name": "upsample", "dtype": dtype,
            "shape": f"stage {stage}: [1, {t}, {cin}] -> [1, {t * s}, {cout}]",
            "fn": fn, "plain": plain, "library": library, "reps": 10,
            "rtol": 1e-4 if dtype == "float32" else 2 ** -7,
            "atol": 1e-4 if dtype == "float32" else 1e-3,
            "per_chunk": 1, "bytes": work_bytes, "flops": flops,
            "peak": PEAK_FP32 if dtype == "float32" else PEAK_BF16}


def phase_kernels(device):
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    from voicefixer_tpu_torch.ops.precision import tf32_off
    log("== kernels against their plain versions (main-path shapes, B=1)")
    gen = torch.Generator().manual_seed(SEED)
    cases = [_stft_case(gen, device)]
    for dtype in ("float32", "bfloat16"):
        cases.append(_gru_case(gen, device, dtype))
        # frames after the tail pad: 3001 + 1 + 4, then x7, x7, x3
        for stage, t in enumerate((3006, 21042, 147294, 441882)):
            cases.append(_upsample_case(gen, device, dtype, stage, t))
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
                              ref, c["rtol"], c["atol"])
            ms = cuda_ms(c["fn"], c["reps"])
            plain_ms = cuda_ms(c["plain"], max(1, c["reps"] // 5), warmup=0)
            try:  # a yardstick only: the port never calls it
                lib_ms = cuda_ms(c["library"], c["reps"])
            except RuntimeError as e:
                log(f"  library call unavailable: {str(e).splitlines()[0]}")
                lib_ms = None
            bms, by = bound_ms(c["bytes"], c["flops"], c["peak"])
            log(f"  {c['name']} {c['dtype']} {c['shape']}: kernel {ms:.3f} ms, "
                f"plain {plain_ms:.3f} ms, library {lib_ms} ms, bound "
                f"{bms:.4f} ms ({by}; {c['flops'] / 1e9:.2f} GFLOP, "
                f"{c['bytes'] / 1e6:.1f} MB)")
            rows.append({**c, "err": err, "ms": ms, "plain_ms": plain_ms,
                         "lib_ms": lib_ms, "bound_ms": bms, "bound_by": by})
    return rows


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
    outs, counts, timing = {}, {}, {}
    for mode in ("parity", "production"):
        with precision(mode):
            vf.restore_inmem(wavs["30s"])  # warm-up: cuDNN plans, kernel load
            torch.cuda.synchronize()
            for name, wav in wavs.items():
                kernels.reset_launches()
                out = vf.restore_inmem(wav)
                counts[mode, name] = dict(kernels.launches)
                outs[mode, name] = out
                if out.shape != wav.shape or not np.isfinite(out).all() \
                        or float(np.abs(out).max()) > 1.0:
                    raise AssertionError(
                        f"{mode} {name}: bad output shape {out.shape} / "
                        f"finite {np.isfinite(out).all()} / peak "
                        f"{float(np.abs(out).max())}")
                want = dict(PER_BATCH)  # both inputs are one batch
                if counts[mode, name] != want:
                    raise AssertionError(f"{mode} {name}: launches "
                                         f"{counts[mode, name]} != {want}")
                log(f"  {mode} {name}: {len(out)} samples, peak "
                    f"{float(np.abs(out).max()):.4f}, launches "
                    f"{counts[mode, name]}")
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                vf.restore_inmem(wavs["30s"])
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            timing[mode] = walls
            log(f"  {mode}: ms per 30 s chunk (host clock, wav in to wav out) "
                f"{['%.1f' % w for w in walls]}; min {min(walls):.1f} ms = "
                f"{30.0 / (min(walls) / 1e3):.1f} audio-s/s on "
                f"{torch.cuda.get_device_name(device)}")
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
            _profile(mode, lambda: vf.restore_inmem(wavs["30s"]), min(walls))
    for name in wavs:
        snr = _snr_db(outs["production", name], outs["parity", name])
        log(f"  SNR production vs parity, {name}: {snr:.2f} dB (regression "
            f"floor {SNR_FLOOR_DB}; bench.py's {BENCH_SNR_DB} dB "
            f"{'met' if snr >= BENCH_SNR_DB else 'NOT met'} by this draw)")
        if snr < SNR_FLOOR_DB:
            raise AssertionError(f"{name}: SNR {snr:.2f} dB < {SNR_FLOOR_DB}")
    phase_snr_vs_plain(vf, device)
    return counts, timing


def _kernel_group(name: str) -> str:
    for key, group in (("stft_mel", "K5 stft_mel"),
                       ("gru_bidir", "K6 gru_bidir"),
                       ("upsample", "K1 upsample"), ("conv", "cuDNN conv"),
                       ("xmma", "cuDNN conv"), ("cutlass", "cuDNN conv"),
                       ("nchwToNhwc", "layout copies"),
                       ("nhwcToNchw", "layout copies")):
        if key in name:
            return group
    return "elementwise and copies"


def _profile(mode: str, fn, wall_ms: float):
    """Device time by kernel over one 30 s restore (torch.profiler), and the
    device's idle share of the unprofiled wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0)) / 1e3,
             e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
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
    for name, ms, n in sorted(rows, key=lambda r: -r[1])[:6]:
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
    rows = phase_kernels(device)
    counts, _ = phase_main_path(device)
    phase_small_reference(device)

    record = []
    for name in ("stft_mel", "gru_bidir", "upsample"):
        for dtype in ("float32", "bfloat16"):
            rs = [r for r in rows if r["name"] == name and r["dtype"] == dtype]
            if not rs:
                continue
            mode = "production" if dtype == "bfloat16" else "parity"
            k = rs[0]["per_chunk"]
            by_bytes = sum(r["bound_ms"] for r in rs if r["bound_by"] == "bytes")
            lib = [r["lib_ms"] for r in rs]
            record.append({
                "name": f"{name}:{dtype}", "route": "cuda",
                "source": SOURCES[name], "replaces": REPLACES[name],
                "launches": counts[mode, "30s"][name],
                "max_abs_err": max(r["err"] for r in rs),
                "ms": k * sum(r["ms"] for r in rs),
                "plain_ms": k * sum(r["plain_ms"] for r in rs),
                "bound_ms": k * sum(r["bound_ms"] for r in rs),
                "bound_by": ("bytes" if 2 * by_bytes
                             > sum(r["bound_ms"] for r in rs)
                             else "operations"),
                "library_ms": None if None in lib else k * sum(lib),
            })
    log(f"== done in {time.perf_counter() - t_start:.1f} s; times are per "
        "30 s chunk (B=1), summed over the launches the main path makes")
    print(json.dumps({"kernels": record}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
