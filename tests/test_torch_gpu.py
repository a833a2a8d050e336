"""The port's CUDA kernels on the card against their plain versions at small
and ragged shapes (partial tiles, widths that are not multiples of the
block, batch > 1). chip_smoke.py holds the tiny-config pipeline on the card
against the CPU. Needs a CUDA card and nvcc, and skips elsewhere. It
imports no JAX, so on a machine without JAX run it without the suite's
conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances: float32 results against the plain float32 version summed in
another order; bfloat16 outputs may differ by one bfloat16 ulp (2^-8
relative) where the two float32 sums straddle a rounding boundary. Through
chained ResStack blocks such an ulp of an intermediate travels along the
residual path into outputs of any magnitude: those cases allow
2^-7*max|ref| + 2^-7*|ref|.
"""

import pytest
import torch

from voicefixer_tpu_torch import kernels
from voicefixer_tpu_torch.kernels import convblock
from voicefixer_tpu_torch.kernels.gru import (gru_bidir, gru_bidir_reference,
                                              gru_seq, gru_seq_reference)
from voicefixer_tpu_torch.kernels.resstack import (plan_stack, res_chain,
                                                   res_chain_reference,
                                                   res_shift_single,
                                                   res_shift_single_reference,
                                                   res_stack)
from voicefixer_tpu_torch.kernels.resstream import (res_stream,
                                                    res_stream_reference,
                                                    up_res_stream,
                                                    up_res_stream_reference)
from voicefixer_tpu_torch.ops.conv import fold_bn_eval
from voicefixer_tpu_torch.kernels.stft import stft_mel, stft_mel_reference
from voicefixer_tpu_torch.kernels.upsample import (upsample,
                                                   upsample_reference)
from voicefixer_tpu_torch.ops.precision import tf32_off

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with tf32_off():
        yield torch.device("cuda")


def _randn(gen, shape, scale=1.0):
    return scale * torch.randn(shape, generator=gen)


@pytest.mark.parametrize("scale,cin,cout,t,b,dtype", [
    (7, 64, 32, 100, 2, "float32"),
    (3, 20, 10, 37, 1, "float32"),
    (2, 16, 70, 65, 3, "float32"),
    (3, 128, 64, 130, 2, "bfloat16"),
    (7, 40, 24, 33, 1, "bfloat16"),   # a k-step straddles a[q] | a[q-1]
    (7, 64, 128, 127, 1, "bfloat16"),   # rows q = 0..T: exactly one tile
    (7, 64, 128, 126, 1, "bfloat16"),   # one row short of it
    (7, 64, 128, 128, 1, "bfloat16"),   # one row into the next tile
    (3, 192, 136, 127, 2, "bfloat16"),  # batch 2; Cout no multiple of 128
    (2, 64, 128, 127, 1, "float32"),
    (3, 32, 128, 128, 2, "float32"),
    (7, 24, 200, 126, 1, "float32"),    # Cout no multiple of the tile
    (3, 8, 8, 1, 2, "float32"),         # a single input row
    (3, 8, 8, 1, 2, "bfloat16"),
])
def test_upsample_kernel(cuda, scale, cin, cout, t, b, dtype):
    gen = torch.Generator().manual_seed(0)
    dt = getattr(torch, dtype)
    x = _randn(gen, (b, t, cin)).to(cuda, dt)
    w = _randn(gen, (2 * scale, cin, cout), 0.05).to(cuda, dt)
    bias = _randn(gen, (cout,), 0.05).to(cuda, dt)
    n0 = kernels.launches["upsample"]
    got = upsample(x, w, bias, scale)
    assert kernels.launches["upsample"] == n0 + 1
    ref = upsample_reference(x, w, bias, scale)
    assert got.shape == ref.shape == (b, t * scale, cout)
    tol = (1e-5, 1e-5) if dtype == "float32" else (2 ** -7, 1e-3)
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol[0],
                               atol=tol[1])


def test_upsample_first_launch_after_cold_build(cuda):
    """The float32 kernel as the first launch of eight new processes, each
    straight after a cold build (tools/torch_first_launch.py): one such
    launch once returned wrong numbers, and no cause was found."""
    import subprocess
    import sys
    from pathlib import Path
    tool = Path(__file__).resolve().parent.parent / "tools" / \
        "torch_first_launch.py"
    run = subprocess.run([sys.executable, str(tool), "--loop", "8"],
                         capture_output=True, text=True)
    assert run.returncode == 0, run.stdout + run.stderr


def test_upsample_bfloat16_refuses_ragged_channels(cuda):
    x = torch.zeros((1, 8, 20), device=cuda, dtype=torch.bfloat16)
    w = torch.zeros((6, 20, 16), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        upsample(x, w, torch.zeros(16, device=cuda, dtype=torch.bfloat16), 3)


# H no multiple of the cluster or of a warp's units (20, 100, 200; 1: one
# block of the cluster owns a unit), T shorter than the kernel's x ring (3)
# and no multiple of it (70), batch 3, the main path's H = 256, and batch 8:
# 16 clusters, more than an H100 runs at once in clusters of 16, so the
# launch takes clusters of 8
GRU_SHAPES = [(128, 7, 2), (100, 50, 3), (20, 3, 3), (200, 70, 3),
              (1, 5, 2), (256, 700, 1), (64, 20, 8)]


@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden,t,b", GRU_SHAPES)
def test_gru_bidir_kernel(cuda, hidden, t, b, mm):
    from voicefixer_tpu_torch.kernels.gru import gru_bidir_cat
    gen = torch.Generator().manual_seed(1)
    g = 3 * hidden
    xf, xb = (_randn(gen, (b, t, g)).to(cuda) for _ in range(2))
    wf, wb = (_randn(gen, (hidden, g), 0.1).to(cuda) for _ in range(2))
    bf, bb = (_randn(gen, (g,), 0.1).to(cuda) for _ in range(2))
    dt = getattr(torch, mm)
    n0 = dict(kernels.launches)
    got = gru_bidir(xf, xb, wf, wb, bf, bb, dt)
    cat = gru_bidir_cat(xf, xb, wf, wb, bf, bb, dt)
    assert kernels.launches["gru_bidir"] == n0["gru_bidir"] + 2
    assert kernels.launches["gru_seq"] == n0["gru_seq"]
    ref = gru_bidir_reference(xf, xb, wf, wb, bf, bb, dt)
    # bfloat16 at H = 256: the kernel's summation order moves an h across a
    # bfloat16 rounding boundary now and then, one ulp of h (2^-8 at
    # |h| < 1) that the next products carry (tests/test_torch_kernels.py::
    # test_gru_cluster_model_matches_pallas measures it on the CPU)
    tol = (1e-5 if mm == "float32" else 2e-3 if hidden < 256 else 2 ** -8)
    for g_, r_ in zip(got, ref):
        assert g_.shape == (b, t, hidden)
        torch.testing.assert_close(g_, r_, rtol=tol, atol=tol)
    torch.testing.assert_close(cat, torch.cat(got, -1), rtol=0, atol=0)


def _stft_cfg(n_fft, hop, win):
    from voicefixer_tpu_torch.config import STFTConfig
    return STFTConfig(n_fft=n_fft, hop_length=hop, win_length=win)


def _fbank(n_fft, n_mels, cuda):
    from voicefixer_tpu_torch.ops.mel import melscale_fbanks
    return torch.as_tensor(melscale_fbanks(n_fft // 2 + 1, 0.0, 22050.0,
                                           n_mels, 44100), device=cuda)


@pytest.mark.parametrize("n,b,n_fft,hop,win,n_mels", [
    (20000, 2, 2048, 441, 2048, 128),
    (4410, 1, 2048, 441, 2048, 128),
    (5000, 3, 256, 100, 200, 40),     # short window, 51 frames (odd)
    (4999, 3, 256, 100, 200, 40),     # the same, 50 frames
    (150, 2, 256, 200, 256, 16),      # shorter than a hop: one frame
    (3000, 1, 64, 64, 64, 8),         # the smallest transform, hop = n_fft
    (9000, 2, 128, 37, 100, 128),     # a last pass of radix 2
    (9000, 1, 1024, 300, 1024, 64),
    (20000, 2, 4096, 512, 4000, 128),  # one pair a block
    (500, 2, 2048, 441, 2048, 128),   # shorter than the centre pad
])
def test_stft_mel_kernel(cuda, n, b, n_fft, hop, win, n_mels):
    gen = torch.Generator().manual_seed(2)
    cfg = _stft_cfg(n_fft, hop, win)
    wav = _randn(gen, (b, n), 0.3).to(cuda)
    fb = _fbank(n_fft, n_mels, cuda)
    n0 = kernels.launches["stft_mel"]
    got = stft_mel(wav, fb, cfg)
    assert kernels.launches["stft_mel"] == n0 + 1
    ref = stft_mel_reference(wav, fb, cfg)
    assert got.shape == ref.shape == (b, n // hop + 1, n_mels)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def test_stft_mel_kernel_dense_fbank(cuda):
    """A filterbank without zeros: every band is the whole spectrum."""
    gen = torch.Generator().manual_seed(14)
    cfg = _stft_cfg(256, 100, 256)
    wav = _randn(gen, (2, 3000), 0.3).to(cuda)
    fb = _randn(gen, (129, 24), 0.1).to(cuda)
    fb[:, 3] = 0.0  # and one column of zeros
    got = stft_mel(wav, fb, cfg)
    ref = stft_mel_reference(wav, fb, cfg)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_fft,hop,win,n_mels", [
    (1000, 250, 1000, 64),    # no power of two
    (8192, 441, 8192, 128),   # more than the kernel holds
    (256, 300, 256, 40),      # hop beyond n_fft
    (256, 100, 256, 129),     # too many mel columns
])
def test_stft_mel_kernel_refuses(cuda, n_fft, hop, win, n_mels):
    wav = torch.zeros((1, 20000), device=cuda)
    fb = torch.zeros((n_fft // 2 + 1, n_mels), device=cuda)
    with pytest.raises(ValueError):
        stft_mel(wav, fb, _stft_cfg(n_fft, hop, win))


def _bank(gen, n, ch, cuda, dt):
    """(w1s, b1s, w2s, b2s) of n blocks at width ch."""
    scale = 0.5 / (3 * ch) ** 0.5
    return tuple(_randn(gen, shape, sc).to(cuda, dt)
                 for shape, sc in (((n, 3, ch, ch), scale), ((n, ch), 0.05),
                                   ((n, 3, ch, ch), scale), ((n, ch), 0.05)))


def _close_chained(got, ref, dtype):
    got, ref = got.float(), ref.float()
    if dtype == "float32":
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=2e-5)
    else:
        torch.testing.assert_close(
            got, ref, rtol=2 ** -7, atol=2 ** -7 * float(ref.abs().max()))


@pytest.mark.parametrize("ch,t,b,dils,tm,dtype", [
    (24, 333, 2, (1, 3, 9), None, "float32"),
    (2, 77, 1, (1, 3), 5, "float32"),          # tiles far smaller than the halo
    (16, 50, 2, (27, 81), None, "float32"),    # dilations beyond the signal
    (128, 701, 2, (1, 3, 9), None, "bfloat16"),
    (24, 333, 1, (1, 3), 17, "bfloat16"),
    (512, 300, 1, (1, 3), None, "bfloat16"),
    # the wgmma chain: several tiles with a ragged last one; two row tiles
    # a pass (C = 256) and both column chunks in one pass (C = 512)
    (256, 1000, 1, (1, 3, 9), None, "bfloat16"),
    (256, 1000, 2, (1, 3), 118, "bfloat16"),
    (512, 500, 2, (1, 3), None, "bfloat16"),
    (128, 300, 1, (1,), None, "bfloat16"),                      # n = 1
    (64, 400, 1, (1, 3, 1, 3, 1, 3, 1, 3), None, "bfloat16"),  # n = 8
    (40, 200, 2, (1, 3, 9), None, "bfloat16"),  # ragged against the boxes
    (16, 20, 1, (27, 81), None, "bfloat16"),    # T < d
    # the float32 FMA chain: stage 1's plan with a ragged last tile and
    # batch 2; three blocks; C = 512 (two column passes, the one-row tile
    # that fits); h over two 64-row tiles at a ragged C; T < d at C = 256
    (256, 300, 2, (1, 3), 54, "float32"),
    (256, 130, 1, (1, 3, 9), 34, "float32"),
    (512, 40, 1, (1, 3), None, "float32"),
    (6, 150, 2, (1, 3), 100, "float32"),
    (64, 20, 1, (27, 81), None, "float32"),
])
def test_res_chain_kernel(cuda, ch, t, b, dils, tm, dtype):
    gen = torch.Generator().manual_seed(3)
    dt = getattr(torch, dtype)
    x = _randn(gen, (b, t, ch)).to(cuda, dt)
    bank = _bank(gen, len(dils), ch, cuda, dt)
    for final_slope in (None, 0.3):
        n0 = kernels.launches["res_chain"]
        got = res_chain(x, *bank, dils, 0.2, final_slope, tm=tm)
        assert kernels.launches["res_chain"] == n0 + 1
        ref = res_chain_reference(x, *bank, dils, 0.2, final_slope)
        _close_chained(got, ref, dtype)


@pytest.mark.parametrize("ch,t,dils,bounds", [
    (512, 777, (1, 3), (100, 650)),
    (512, 777, (1, 3), (-5, 400)),
    (256, 1500, (1, 3, 9), (200, 1201)),
    (256, 1500, (1, 3, 9), (40, 41)),
    (40, 300, (1, 3), (10, 250)),
])
def test_res_chain_wgmma_windows(cuda, ch, t, dils, bounds):
    """The bfloat16 chain under a signal window at the widths of the
    vocoder's unfused stages and a ragged one: rows outside the window come
    out as zeros."""
    gen = torch.Generator().manual_seed(15)
    dt = torch.bfloat16
    x = _randn(gen, (2, t, ch)).to(cuda, dt)
    bank = _bank(gen, len(dils), ch, cuda, dt)
    got = res_chain(x, *bank, dils, 0.2, 0.3, mask_bounds=bounds)
    ref = res_chain_reference(x, *bank, dils, 0.2, 0.3, bounds)
    _close_chained(got, ref, "bfloat16")
    lo, hi = max(bounds[0], 0), min(bounds[1], t)
    assert float(got[:, :lo].float().abs().sum()) == 0.0
    assert float(got[:, hi:].float().abs().sum()) == 0.0


def test_res_chain_first_launch_after_cold_build(cuda):
    """The bfloat16 chain as the first launch of two new processes, each
    straight after a cold build (tools/torch_first_launch.py --case
    res_chain)."""
    import subprocess
    import sys
    from pathlib import Path
    tool = Path(__file__).resolve().parent.parent / "tools" / \
        "torch_first_launch.py"
    run = subprocess.run([sys.executable, str(tool), "--case", "res_chain",
                          "--loop", "2"], capture_output=True, text=True)
    assert run.returncode == 0, run.stdout + run.stderr


@pytest.mark.parametrize("case", ["res_chain_f32", "res_shift_single_f32"])
def test_res_f32_first_launch_after_cold_build(cuda, case):
    """The float32 chain and single block, whose operands go through a
    cp.async ring, as the first launch of two new processes, each straight
    after a cold build (tools/torch_first_launch.py --case CASE)."""
    import subprocess
    import sys
    from pathlib import Path
    tool = Path(__file__).resolve().parent.parent / "tools" / \
        "torch_first_launch.py"
    run = subprocess.run([sys.executable, str(tool), "--case", case,
                          "--loop", "2"], capture_output=True, text=True)
    assert run.returncode == 0, run.stdout + run.stderr


@pytest.mark.parametrize("case", ["res_shift_single_bf16", "res_stream_f32",
                                  "res_stream_bf16"])
def test_res_single_and_stream_first_launch_after_cold_build(cuda, case):
    """The bfloat16 single block (weights and tap rows by TMA and
    mbarriers) and res_stream under a window in either type, as the first
    launch of two new processes, each straight after a cold build of its
    one source (tools/torch_first_launch.py --case CASE)."""
    import subprocess
    import sys
    from pathlib import Path
    tool = Path(__file__).resolve().parent.parent / "tools" / \
        "torch_first_launch.py"
    run = subprocess.run([sys.executable, str(tool), "--case", case,
                          "--loop", "2"], capture_output=True, text=True)
    assert run.returncode == 0, run.stdout + run.stderr


@pytest.mark.parametrize("ch,t,b,dil,dtype", [
    (24, 333, 2, 9, "float32"),
    (2, 1001, 1, 729, "float32"),
    (16, 100, 2, 729, "float32"),      # T < d: the bias-only result
    (128, 2000, 2, 729, "bfloat16"),
    (40, 63, 1, 2187, "bfloat16"),
    (512, 500, 1, 81, "bfloat16"),
    # the bfloat16 wgmma block: C = 256 (one 256-column chunk, 126-row
    # tiles) at batch 2 and the largest dilation; C = 64 (N = 64, eight
    # 64-deep stages) over many tiles; C = 8, one tile shorter than 126
    # rows; C = 264, two chunks, the second mostly zero columns
    (256, 1000, 2, 2187, "bfloat16"),
    (64, 3001, 1, 27, "bfloat16"),
    (8, 10, 1, 3, "bfloat16"),
    (264, 130, 1, 9, "bfloat16"),
    # the float32 FMA block: C = 512 (two column passes) at a short T and
    # batch 2; tile boundaries at 62 and 124; the bias-only result at
    # C = 512; a width that is no multiple of 4
    (512, 200, 2, 81, "float32"),
    (256, 130, 1, 3, "float32"),
    (512, 50, 1, 729, "float32"),
    (6, 70, 2, 27, "float32"),
])
def test_res_shift_single_kernel(cuda, ch, t, b, dil, dtype):
    gen = torch.Generator().manual_seed(4)
    dt = getattr(torch, dtype)
    x = _randn(gen, (b, t, ch)).to(cuda, dt)
    w1, b1, w2, b2 = (v[0] for v in _bank(gen, 1, ch, cuda, dt))
    n0 = kernels.launches["res_shift_single"]
    got = res_shift_single(x, w1, b1, w2, b2, dil, 0.2, 0.3)
    assert kernels.launches["res_shift_single"] == n0 + 1
    ref = res_shift_single_reference(x, w1, b1, w2, b2, dil, 0.2, 0.3)
    tol = (1e-4, 2e-5) if dtype == "float32" else (2 ** -7, 1e-3)
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol[0],
                               atol=tol[1])


@pytest.mark.parametrize("cin,cout,scale,t,b,dtype", [
    (32, 24, 3, 333, 2, "float32"),
    (4, 2, 7, 1500, 1, "float32"),
    (8, 16, 3, 11, 2, "float32"),       # every dilation beyond the signal
    (128, 64, 3, 3001, 2, "bfloat16"),
    (256, 128, 3, 1000, 1, "bfloat16"),
    (40, 24, 7, 97, 1, "bfloat16"),     # C = 24 pads N with zero weights
    # the full-width plans (stages 2 and 3) at a short T whose last tile
    # ends mid-tile, in both types; batch 2; C = 24 and a signal shorter
    # than every dilation in bfloat16. Every first tile's slab starts
    # before q = 0.
    (256, 128, 3, 1000, 1, "float32"),
    (128, 64, 3, 1001, 1, "float32"),
    (128, 64, 3, 1001, 1, "bfloat16"),
    (256, 128, 3, 501, 2, "float32"),
    (256, 128, 3, 501, 2, "bfloat16"),
    (128, 64, 3, 700, 2, "float32"),
    (32, 24, 3, 333, 2, "bfloat16"),
    (8, 16, 3, 11, 2, "bfloat16"),
])
def test_up_res_stream_kernel(cuda, cin, cout, scale, t, b, dtype):
    gen = torch.Generator().manual_seed(5)
    dt = getattr(torch, dtype)
    dils = tuple(3 ** i for i in range(8))
    x = _randn(gen, (b, t, cin)).to(cuda, dt)
    w_up = _randn(gen, (2 * scale, cin, cout), 0.7 / (2 * cin) ** 0.5
                  ).to(cuda, dt)
    b_up = _randn(gen, (cout,), 0.05).to(cuda, dt)
    bank = _bank(gen, 8, cout, cuda, dt)
    n0 = dict(kernels.launches)
    got = up_res_stream(x, w_up, b_up, *bank, dils, scale, 0.01, 0.2)
    assert kernels.launches["up_res_stream"] == n0["up_res_stream"] + 1
    assert kernels.launches["res_chain"] == n0["res_chain"]
    assert kernels.launches["res_shift_single"] == n0["res_shift_single"]
    ref = up_res_stream_reference(x, w_up, b_up, *bank, dils, scale, 0.01,
                                  0.2)
    assert got.shape == ref.shape == (b, t * scale, cout)
    _close_chained(got, ref, dtype)


def test_res_stack_kernels(cuda):
    """The dispatcher: chains and shifted-tap blocks cover all eight blocks,
    the stage activation is in the last launch."""
    gen = torch.Generator().manual_seed(6)
    ch, t = 256, 3000
    dils = tuple(3 ** i for i in range(8))
    x = _randn(gen, (1, t, ch)).to(cuda)
    w1s, b1s, w2s, b2s = _bank(gen, 8, ch, cuda, torch.float32)
    params = [{"c1": {"w": w1s[i], "b": b1s[i]},
               "c2": {"w": w2s[i], "b": b2s[i]}} for i in range(8)]
    groups = plan_stack(ch, dils, 4)
    chains = sum(1 for g in groups if g[2] is not None)
    kernels.reset_launches()
    got = res_stack(params, x, 3, 0.01, final_slope=0.2)
    assert kernels.launches["res_chain"] == chains >= 1
    assert kernels.launches["res_shift_single"] == len(groups) - chains >= 1
    ref = res_chain_reference(x, w1s, b1s, w2s, b2s, dils, 0.01, 0.2)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("fn", ["res_chain", "res_shift_single",
                                "up_res_stream"])
def test_resstack_bfloat16_refuses_ragged_channels(cuda, fn):
    dt = torch.bfloat16
    gen = torch.Generator().manual_seed(7)
    ch = 20
    x = torch.zeros((1, 50, ch), device=cuda, dtype=dt)
    w1s, b1s, w2s, b2s = _bank(gen, 8, ch, cuda, dt)
    with pytest.raises(ValueError):
        if fn == "res_chain":
            res_chain(x, w1s[:2], b1s[:2], w2s[:2], b2s[:2], (1, 3))
        elif fn == "res_shift_single":
            res_shift_single(x, w1s[0], b1s[0], w2s[0], b2s[0], 9)
        else:
            up_res_stream(torch.zeros((1, 50, 16), device=cuda, dtype=dt),
                          torch.zeros((6, 16, ch), device=cuda, dtype=dt),
                          torch.zeros(ch, device=cuda, dtype=dt),
                          w1s, b1s, w2s, b2s,
                          tuple(3 ** i for i in range(8)), 3)


# ------------------------------------------- gru_seq, res_stream, convblock

@pytest.mark.parametrize("hidden,t,b,reverse", [
    (128, 7, 2, False), (100, 50, 3, True), (256, 301, 2, False),
    (256, 301, 1, True), (20, 3, 3, False), (200, 70, 3, True),
    (1, 5, 2, False), (256, 700, 1, False), (64, 20, 15, True)])
def test_gru_seq_kernel(cuda, hidden, t, b, reverse):
    gen = torch.Generator().manual_seed(8)
    g = 3 * hidden
    x = _randn(gen, (b, t, g)).to(cuda)
    w = _randn(gen, (hidden, g), 0.1).to(cuda)
    bias = _randn(gen, (g,), 0.1).to(cuda)
    n0 = dict(kernels.launches)
    got = gru_seq(x, w, bias, reverse=reverse)
    assert kernels.launches["gru_seq"] == n0["gru_seq"] + 1
    assert kernels.launches["gru_bidir"] == n0["gru_bidir"]
    ref = gru_seq_reference(x, w, bias, reverse=reverse)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_gru_seq_refuses(cuda):
    """Wider than the kernel holds, or not float32: raises, no plain
    version on the card."""
    x = torch.zeros((1, 4, 3 * 300), device=cuda)
    with pytest.raises(ValueError):
        gru_seq(x, torch.zeros((300, 900), device=cuda),
                torch.zeros(900, device=cuda))
    x = torch.zeros((1, 4, 96), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        gru_seq(x, torch.zeros((32, 96), device=cuda, dtype=torch.bfloat16),
                torch.zeros(96, device=cuda, dtype=torch.bfloat16))


BOUNDS = [(100, 250), (-5, 120), (200, 10 ** 6), (40, 41)]


@pytest.mark.parametrize("ch,dtype", [(24, "float32"), (256, "float32"),
                                      (512, "float32"), (128, "bfloat16"),
                                      (64, "bfloat16"), (256, "bfloat16"),
                                      (512, "bfloat16")])
def test_res_chain_and_shift_kernels_with_bounds(cuda, ch, dtype):
    """The signal window: rows outside it are zero padding at every block
    and come out as zeros, also where the window leaves the array; the
    single blocks' tiles (62 rows in float32 and in bfloat16 at C = 512,
    else 126) end inside the windows, and the bfloat16 block's tap rows
    come from a tensor map over the window's rows."""
    gen = torch.Generator().manual_seed(9)
    dt = getattr(torch, dtype)
    t = 333
    x = _randn(gen, (2, t, ch)).to(cuda, dt)
    bank = _bank(gen, 3, ch, cuda, dt)
    one = tuple(v[0] for v in bank)
    for bounds in BOUNDS:
        got = res_chain(x, *bank, (1, 3, 9), 0.2, 0.3, mask_bounds=bounds)
        ref = res_chain_reference(x, *bank, (1, 3, 9), 0.2, 0.3, bounds)
        _close_chained(got, ref, dtype)
        lo, hi = max(bounds[0], 0), min(bounds[1], t)
        assert float(got[:, :lo].float().abs().sum()) == 0.0
        assert float(got[:, hi:].float().abs().sum()) == 0.0
        for dil in (9, 729):
            got = res_shift_single(x, *one, dil, 0.2, 0.3, bounds)
            ref = res_shift_single_reference(x, *one, dil, 0.2, 0.3, bounds)
            _close_chained(got, ref, dtype)


@pytest.mark.parametrize("ch,t,b,dtype,bounds", [
    (128, 4001, 1, "float32", None),
    (128, 4001, 2, "float32", (700, 3500)),
    (64, 9000, 1, "float32", (-50, 8000)),
    (24, 333, 2, "float32", (30, 10 ** 6)),
    (16, 20, 1, "float32", None),            # T < d for most blocks
    (128, 4001, 1, "bfloat16", (700, 3500)),
    (64, 9000, 2, "bfloat16", None),
    (40, 50, 1, "bfloat16", (10, 30)),       # a window inside one dilation
    # planned for the wgmma chain at N = C: one chain, then three (C = 64)
    # or four (C = 128) single blocks, under a window that ends mid-tile
    (64, 5000, 2, "bfloat16", (-50, 4000)),
    (128, 3000, 1, "bfloat16", (1, 2999)),
])
def test_res_stream_kernel(cuda, ch, t, b, dtype, bounds):
    """The whole eight-block stack behind one entry point and one count:
    its groups launch the chain and single-block kernels of the type
    without counting as res_chain or res_shift_single."""
    gen = torch.Generator().manual_seed(10)
    dt = getattr(torch, dtype)
    dils = tuple(3 ** i for i in range(8))
    x = _randn(gen, (b, t, ch)).to(cuda, dt)
    bank = _bank(gen, 8, ch, cuda, dt)
    n0 = dict(kernels.launches)
    got = res_stream(x, *bank, dils, 0.01, 0.2, bounds)
    assert kernels.launches["res_stream"] == n0["res_stream"] + 1
    assert kernels.launches["res_chain"] == n0["res_chain"]
    assert kernels.launches["res_shift_single"] == n0["res_shift_single"]
    ref = res_stream_reference(x, *bank, dils, 0.01, 0.2, bounds)
    _close_chained(got, ref, dtype)


def test_res_stack_with_bounds_dispatch(cuda):
    """Under a window a narrow stack is one res_stream launch; a wide one
    goes through the planner's chains and shifted-tap blocks."""
    gen = torch.Generator().manual_seed(11)
    dils = tuple(3 ** i for i in range(8))
    for ch, t in ((64, 3000), (256, 3000)):
        x = _randn(gen, (1, t, ch)).to(cuda)
        w1s, b1s, w2s, b2s = _bank(gen, 8, ch, cuda, torch.float32)
        params = [{"c1": {"w": w1s[i], "b": b1s[i]},
                   "c2": {"w": w2s[i], "b": b2s[i]}} for i in range(8)]
        kernels.reset_launches()
        got = res_stack(params, x, 3, 0.01, final_slope=0.2,
                        mask_bounds=(100, 2500))
        if ch == 64:
            assert kernels.launches["res_stream"] == 1
            assert kernels.launches["res_chain"] == 0
        else:
            groups = plan_stack(ch, dils, 4)
            assert kernels.launches["res_stream"] == 0
            assert (kernels.launches["res_chain"]
                    + kernels.launches["res_shift_single"]) == len(groups)
        ref = res_chain_reference(x, w1s, b1s, w2s, b2s, dils, 0.01, 0.2,
                                  (100, 2500))
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=2e-5)


def _conv_block_params(gen, ci, co, cuda, dt):
    def bn(c):
        return {"gamma": 1 + 0.1 * _randn(gen, (c,)),
                "beta": 0.1 * _randn(gen, (c,)),
                "mean": 0.05 * _randn(gen, (c,)),
                "var": (1 + 0.1 * _randn(gen, (c,))).abs()}
    p = {"bn1": bn(ci), "conv1": {"w": _randn(gen, (3, 3, ci, co),
                                              1 / (9 * ci) ** 0.5)},
         "bn2": bn(co), "conv2": {"w": _randn(gen, (3, 3, co, co),
                                              1 / (9 * co) ** 0.5)}}
    if ci != co:
        p["shortcut"] = {"w": _randn(gen, (1, 1, ci, co), 1 / ci ** 0.5),
                         "b": 0.1 * _randn(gen, (co,))}
    p = fold_bn_eval(p)

    def to(v):
        return ({k: to(u) for k, u in v.items()} if isinstance(v, dict)
                else v.to(cuda, dt))
    return to(p)


@pytest.mark.parametrize("t,f,ci,co,b,dtype", [
    (40, 15, 32, 32, 2, "float32"),
    (48, 31, 16, 32, 1, "float32"),
    (40, 7, 64, 64, 1, "float32"),
    (64, 127, 2, 32, 1, "float32"),     # the first block: two channels in
    (33, 9, 6, 10, 2, "float32"),       # widths that are no multiple of 4
    (30, 31, 128, 128, 1, "float32"),
    (40, 15, 32, 32, 2, "bfloat16"),
    (64, 127, 2, 32, 1, "bfloat16"),
    (48, 31, 64, 128, 1, "bfloat16"),
    (40, 63, 128, 64, 1, "bfloat16"),
    (3, 5, 8, 8, 1, "bfloat16"),        # a signal smaller than one tile
])
def test_conv_block_res_kernel(cuda, t, f, ci, co, b, dtype):
    gen = torch.Generator().manual_seed(12)
    dt = getattr(torch, dtype)
    p = _conv_block_params(gen, ci, co, cuda, dt)
    x = _randn(gen, (b, t, f, ci), 0.5).to(cuda, dt)
    assert convblock.eligible(p, x)
    n0 = kernels.launches["conv_block_res"]
    got = convblock.conv_block_res(x, p, 0.01)
    assert kernels.launches["conv_block_res"] == n0 + 1
    ref = convblock.conv_block_res_reference(x, p, 0.01)
    assert got.shape == ref.shape == (b, t, f, co)
    tol = (1e-4, 2e-5) if dtype == "float32" else (2 ** -7, 2e-3)
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol[0],
                               atol=tol[1])


FULL_WIDTH_BLOCKS = [(3008, 127, 2, 32), (3008, 127, 32, 32),
                     (3008, 127, 64, 32), (1504, 63, 32, 64),
                     (1504, 63, 64, 64), (1504, 63, 128, 64),
                     (752, 31, 64, 128), (752, 31, 128, 128)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,f,ci,co", FULL_WIDTH_BLOCKS)
def test_conv_block_res_full_width(cuda, t, f, ci, co, dtype):
    """The 24 blocks' eight shapes of a 30 s chunk under the planner's own
    plan, at chip_smoke.py's tolerances (float32 sums in another order over
    up to 9 * 192 terms; bfloat16: an ulp of a2 through conv2)."""
    gen = torch.Generator().manual_seed(14)
    dt = getattr(torch, dtype)
    p = _conv_block_params(gen, ci, co, cuda, dt)
    x = _randn(gen, (1, t, f, ci)).to(cuda, dt)
    got = convblock.conv_block_res(x, p, 0.01)
    ref = convblock.conv_block_res_reference(x, p, 0.01)
    tol = (1e-4, 1e-4) if dtype == "float32" else (2 ** -7, 2 ** -6)
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol[0],
                               atol=tol[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,f,ci,co,b,run", [
    (40, 31, 64, 128, 2, 300),   # batch 2, the shortcut; runs end inside a
                                 # time step (300 = 9 * 32 + 12)
    (60, 15, 32, 32, 1, 333),    # the identity; a last run of 294 rows
    (25, 127, 2, 32, 1, 1000),   # the first block; several steps a run
])
def test_conv_block_res_run_boundaries(cuda, t, f, ci, co, b, run, dtype):
    """Forced run lengths that end inside a time step: every run computes
    conv1's halo again, and its rows are stored once."""
    gen = torch.Generator().manual_seed(15)
    dt = getattr(torch, dtype)
    p = _conv_block_params(gen, ci, co, cuda, dt)
    x = _randn(gen, (b, t, f, ci), 0.5).to(cuda, dt)
    plan = convblock.plan_stream(t, f, ci, co, dt.itemsize, b, run=run)
    assert plan.run == run and plan.runs > 1
    got = convblock.launch(x, p, 0.01, plan)
    ref = convblock.conv_block_res_reference(x, p, 0.01)
    tol = (1e-4, 2e-5) if dtype == "float32" else (2 ** -7, 2e-3)
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol[0],
                               atol=tol[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_block_res_packed_operands(cuda, dtype):
    """A block whose operands its owner packed once
    (``resunet.pack_conv_blocks``, as ``VoiceFixer(conv_block_kernel=True)``
    does) gives the result of the same block packed at the call."""
    from voicefixer_tpu_torch.models import resunet
    gen = torch.Generator().manual_seed(16)
    dt = getattr(torch, dtype)
    p = _conv_block_params(gen, 32, 64, cuda, torch.float32)
    x = _randn(gen, (2, 40, 31, 32), 0.5).to(cuda, dt)
    packed = resunet.pack_conv_blocks({"b": p})["b"]
    assert convblock.operands(packed, dt) is packed["packed"][dtype]
    cast = resunet._cast(p, dt)
    got = convblock.conv_block_res(x, resunet._cast(packed, dt), 0.01)
    want = convblock.conv_block_res(x, cast, 0.01)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("t,f,ci,co,dtype", [(12, 64, 128, 128, "float32"),
                                             (4, 621, 32, 32, "bfloat16")])
def test_conv_block_res_at_the_rings_limit(cuda, t, f, ci, co, dtype):
    """The widest F that ``eligible`` takes for these widths: rings that
    fill the shared memory."""
    gen = torch.Generator().manual_seed(17)
    dt = getattr(torch, dtype)
    p = _conv_block_params(gen, ci, co, cuda, dt)
    x = _randn(gen, (1, t, f, ci), 0.5).to(cuda, dt)
    assert convblock.eligible(p, x)
    wider = torch.empty((1, t, f + 1, ci), device="meta", dtype=dt)
    assert not convblock.eligible(p, wider)
    got = convblock.conv_block_res(x, p, 0.01)
    ref = convblock.conv_block_res_reference(x, p, 0.01)
    tol = (1e-4, 2e-5) if dtype == "float32" else (2 ** -7, 2e-3)
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol[0],
                               atol=tol[1])


@pytest.mark.parametrize("case", ["conv_block_res_f32",
                                  "conv_block_res_bf16"])
def test_conv_block_res_first_launch_after_cold_build(cuda, case):
    """The ConvBlockRes kernel in either type, whose weights and rows go
    through cp.async (float32) or TMA and mbarriers (bfloat16), as the first
    launch of two new processes, each straight after a cold build
    (tools/torch_first_launch.py --case CASE)."""
    import subprocess
    import sys
    from pathlib import Path
    tool = Path(__file__).resolve().parent.parent / "tools" / \
        "torch_first_launch.py"
    run = subprocess.run([sys.executable, str(tool), "--case", case,
                          "--loop", "2"], capture_output=True, text=True)
    assert run.returncode == 0, run.stdout + run.stderr


@pytest.mark.parametrize("case", ["gru_bidir_f32", "gru_bidir_bf16",
                                  "gru_seq"])
def test_gru_first_launch_after_cold_build(cuda, case):
    """The GRU recurrence, whose blocks exchange h through st.async and
    mbarrier phases, as the first launch of two new processes, each
    straight after a cold build (tools/torch_first_launch.py --case CASE):
    a wrong phase parity shows as a trap or a stale h."""
    import subprocess
    import sys
    from pathlib import Path
    tool = Path(__file__).resolve().parent.parent / "tools" / \
        "torch_first_launch.py"
    run = subprocess.run([sys.executable, str(tool), "--case", case,
                          "--loop", "2"], capture_output=True, text=True)
    assert run.returncode == 0, run.stdout + run.stderr


@pytest.mark.parametrize("case", ["up_res_stream_f32",
                                  "up_res_stream_bf16"])
def test_up_res_stream_first_launch_after_cold_build(cuda, case):
    """The fused stage in either type, whose first group takes its operands
    through cp.async (float32) or TMA and mbarriers (bfloat16), as the
    first launch of two new processes, each straight after a cold build
    (tools/torch_first_launch.py --case CASE)."""
    import subprocess
    import sys
    from pathlib import Path
    tool = Path(__file__).resolve().parent.parent / "tools" / \
        "torch_first_launch.py"
    run = subprocess.run([sys.executable, str(tool), "--case", case,
                          "--loop", "2"], capture_output=True, text=True)
    assert run.returncode == 0, run.stdout + run.stderr


def test_conv_block_res_refuses(cuda):
    """A block the kernel does not take raises on the card."""
    gen = torch.Generator().manual_seed(13)
    p = _conv_block_params(gen, 256, 256, cuda, torch.float32)
    x = torch.zeros((1, 8, 7, 256), device=cuda)
    assert not convblock.eligible(p, x)
    with pytest.raises(ValueError):
        convblock.conv_block_res(x, p, 0.01)


# ------------------------------------------------------------- gradients

def grad_error(got, ref):
    """max |got - ref| over max |ref|."""
    return float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                1e-30)


# The backward reads the kernel's states where autograd through the plain
# loop reads the loop's own: their gradients differ by what the forward
# states differ by (1e-5 in float32; in bfloat16 an ulp of h, 2^-8, now
# and then), carried through the reverse recurrence. Held relative to the
# gradient's largest element: 1e-4 in float32, 2^-6 in bfloat16.
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2 ** -6}


@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden,t,b", [(256, 301, 2), (1, 5, 2)])
def test_gru_bidir_backward_kernel(cuda, hidden, t, b, mm):
    """K6 under grad: one launch through ``GruBidir`` (the trainer's H and
    3 s of frames, and H = 1), its gradients for the projections, W and b
    of both directions against autograd through the plain loop on the
    card."""
    from voicefixer_tpu_torch.kernels.gru import gru_bidir_cat
    gen = torch.Generator().manual_seed(13)
    g = 3 * hidden
    scales = (1.0, 1.0, 0.1, 0.1, 0.1, 0.1)
    shapes = [(b, t, g)] * 2 + [(hidden, g)] * 2 + [(g,)] * 2
    args = [_randn(gen, s, c).to(cuda).requires_grad_()
            for s, c in zip(shapes, scales)]
    dt = getattr(torch, mm)
    n0 = kernels.launches["gru_bidir"]
    out = gru_bidir_cat(*args, matmul_dtype=dt)
    assert kernels.launches["gru_bidir"] == n0 + 1
    gout = _randn(gen, tuple(out.shape)).to(cuda)
    got = torch.autograd.grad(out, args, gout)
    assert kernels.launches["gru_bidir"] == n0 + 1  # the backward: torch ops
    ref = torch.autograd.grad(
        torch.cat(gru_bidir_reference(*args, matmul_dtype=dt), -1), args,
        gout)
    for name, a, r in zip(("xf", "xb", "w_f", "w_b", "b_f", "b_b"), got, ref):
        assert a.shape == r.shape and bool(torch.isfinite(a).all()), name
        assert grad_error(a, r) <= GRAD_TOL[mm], (name, grad_error(a, r))


def _grad_guard_calls(cuda):
    """One call a ctypes wrapper, small shapes on the card, the input that
    requires grad passed through ``w``."""
    from voicefixer_tpu_torch.config import DEFAULT_CONFIG
    from voicefixer_tpu_torch.models.analysis import mel_fbank
    r = lambda *s: torch.randn(s, device=cuda)  # noqa: E731
    c = 8
    bn = {"scale": r(c), "shift": r(c)}
    block = {"bn1": bn, "bn2": bn, "conv1": {"w": r(3, 3, c, c)}}
    return {
        "stft_mel": lambda w: stft_mel(w(r(1, 4096)),
                                       mel_fbank(DEFAULT_CONFIG, cuda),
                                       DEFAULT_CONFIG.stft),
        "upsample": lambda w: upsample(r(1, 4, c), w(r(6, c, c)), r(c), 3),
        "res_chain": lambda w: res_chain(r(1, 16, c), r(1, 3, c, c),
                                         w(r(1, c)), r(1, 3, c, c), r(1, c),
                                         (1,)),
        "res_shift_single": lambda w: res_shift_single(
            r(1, 16, c), r(3, c, c), r(c), w(r(3, c, c)), r(c), 1),
        "up_res_stream": lambda w: up_res_stream(
            w(r(1, 4, c)), r(6, c, c), r(c), r(1, 3, c, c), r(1, c),
            r(1, 3, c, c), r(1, c), (1,), 3),
        "res_stream": lambda w: res_stream(r(1, 16, c), r(1, 3, c, c),
                                           r(1, c), r(1, 3, c, c),
                                           w(r(1, c)), (1,)),
        "gru_seq": lambda w: gru_seq(r(1, 3, 6), r(2, 6), w(r(6))),
        "conv_block_res": lambda w: convblock.conv_block_res(
            w(r(1, 4, 4, c)), {**block, "conv2": {"w": r(3, 3, c, c)}},
            0.01),
    }


@pytest.mark.parametrize("name", ["stft_mel", "upsample", "res_chain",
                                  "res_shift_single", "up_res_stream",
                                  "res_stream", "gru_seq", "conv_block_res"])
def test_kernel_raises_under_grad(cuda, name):
    """Every kernel but K6 has no backward: with grad mode on and an input
    that requires grad its wrapper raises before it launches; under
    no_grad the same call launches."""
    call = _grad_guard_calls(cuda)[name]
    n0 = kernels.launches[name]
    with pytest.raises(RuntimeError, match=f"^{name}: the CUDA kernel has "
                       "no backward"):
        call(lambda t: t.requires_grad_())
    assert kernels.launches[name] == n0
    with torch.no_grad():
        call(lambda t: t.requires_grad_())
    assert kernels.launches[name] == n0 + 1


# ------------------------------------------- a process group of one (NCCL)

@pytest.fixture
def nccl_world(cuda, tmp_path):
    """This process as a world of one on NCCL, by a rendezvous file; the
    group is taken down after the test."""
    from voicefixer_tpu_torch.parallel import distributed
    assert distributed.initialize("file://" + str(tmp_path / "rdzv"), 1, 0)
    try:
        yield torch.distributed.get_backend()
    finally:
        distributed.shutdown()


@pytest.mark.parametrize("case", ["restore_wavs", "train_step", "halo"])
def test_world_of_one_nccl(nccl_world, case):
    """On the card the group is NCCL and ``make_mesh()`` is (1, 1). Over
    it: restore_wavs equals restore_inmem per file (1e-5, the JAX tests'
    tolerance); a trainer step on the mesh equals the step without one
    (the same kernels on the same inputs); exchange_halo on one rank pads
    with zeros and gather of the batch is the batch."""
    import numpy as np
    from voicefixer_tpu_torch.config import tiny_test_config
    from voicefixer_tpu_torch.models import analysis
    from voicefixer_tpu_torch.parallel.inference import restore_wavs
    from voicefixer_tpu_torch.parallel.mesh import global_batch, make_mesh
    from voicefixer_tpu_torch.parallel.sp import exchange_halo
    from voicefixer_tpu_torch.pipeline.restore import VoiceFixer
    from voicefixer_tpu_torch.train import step as st
    assert nccl_world == "nccl"
    mesh = make_mesh()
    assert (mesh.size(0), mesh.size(1)) == (1, 1)
    cfg = tiny_test_config()
    rng = np.random.default_rng(0)
    if case == "restore_wavs":
        vf = VoiceFixer.random(0, cfg, mesh=mesh)
        assert vf.device.type == "cuda"
        wavs = [(0.1 * rng.standard_normal(n)).astype(np.float32)
                for n in (50000, 11025, 88200)]
        for mode in (0, 1):
            for w, out in zip(wavs, restore_wavs(vf, wavs, mode)):
                ref = vf.restore_inmem(w, mode=mode)
                assert out.shape == ref.shape
                assert np.abs(out - ref).max() <= 1e-5
    elif case == "train_step":
        params = analysis.init(cfg, torch.Generator().manual_seed(0))
        wav = [torch.from_numpy((0.1 * rng.standard_normal((2, 4410)))
                                .astype(np.float32)) for _ in range(2)]
        spec = st.reference_optimizer(warmup_steps=1)
        got = {}
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True  # cuDNN repeats exactly
        for m in (None, mesh):
            state = st.init_train_state(params, spec, "cuda")
            if m is not None:
                state = st.place_train_state(state, m)
            step = st.make_train_step(cfg, spec, mesh=m)
            for _ in range(2):
                state, metrics = step(state, *wav,
                                      torch.Generator("cuda").manual_seed(1))
            got[m is None] = (float(metrics["loss"]),
                              [p.detach() for p in state.leaves()])
        torch.backends.cudnn.deterministic = deterministic
        assert got[True][0] == got[False][0]
        for a, b in zip(got[True][1], got[False][1]):
            assert torch.allclose(a, b, rtol=1e-6, atol=0)
    else:
        x = torch.randn(2, 8, 4, device="cuda")
        assert torch.equal(exchange_halo(x, 3, mesh),
                           torch.nn.functional.pad(x, (0, 0, 3, 3)))
        assert torch.equal(global_batch(mesh, x, 2), x)
