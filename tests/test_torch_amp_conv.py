"""K11 (``kernels/amp_conv.py``), BigVGAN's AMP convolution, on the CPU:
its plain version against ``ops.conv.conv1d`` with the residual added
after, the tile the shape chooses, the checks its wrapper makes before a
launch, and ``models/bigvgan.py::amp_block`` taking it in bfloat16 alone.
The kernel itself runs on the card: ``tests/test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

from tests.test_torch_weights import one_torch_thread  # noqa: F401
from voicefixer_tpu_torch import kernels
from voicefixer_tpu_torch.config import BigVGANConfig
from voicefixer_tpu_torch.kernels import amp_conv as k11
from voicefixer_tpu_torch.kernels import build
from voicefixer_tpu_torch.models import bigvgan
from voicefixer_tpu_torch.ops.conv import conv1d
from voicefixer_tpu_torch.ops.precision import precision
from voicefixer_tpu_torch.pipeline.vocoder_facade import BigVGAN

NARROW = BigVGANConfig(upsample_initial_channel=128)


def _operands(gen, b, t, c, k, dtype=torch.float32):
    x = torch.randn((b, t, c), generator=gen).to(dtype)
    w = (torch.randn((k, c, c), generator=gen) * (k * c) ** -0.5).to(dtype)
    bias = (0.05 * torch.randn((c,), generator=gen)).to(dtype)
    r = torch.randn((b, t, c), generator=gen).to(dtype)
    return x, w, bias, r


def _unfused(x, w, b, dilation=1, residual=None):
    """The convolution as the float32 path runs it: cuDNN's view, then the
    residual added by a separate pass."""
    y = conv1d(x, w, b, padding=dilation * (w.shape[0] - 1) // 2,
               dilation=dilation)
    return y if residual is None else residual + y


@pytest.mark.parametrize("d", [1, 3, 5])
@pytest.mark.parametrize("k", [3, 7, 11])
def test_plain_matches_conv1d(k, d):
    """Float32, C = 24 (the last stage's width), batch 2, with and without
    the residual; T = 4 is shorter than every halo d (k-1)/2 but k = 3 at
    d = 1, 3, so most of its taps read the padding."""
    gen = torch.Generator().manual_seed(10 * k + d)
    for t in (4, 37):
        x, w, b, r = _operands(gen, 2, t, 24, k)
        for res in (None, r):
            got = k11.amp_conv(x, w, b, d, res)
            assert got.shape == x.shape and got.dtype == x.dtype
            torch.testing.assert_close(got, _unfused(x, w, b, d, res),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("residual", [False, True])
def test_plain_bfloat16_rounds_once(residual):
    """In bfloat16 the plain version sums in float32 and rounds once: it
    equals the float32 sum of the same bfloat16 operands rounded, and lies
    within two roundings of the unfused path, which rounds the conv and
    then the add."""
    gen = torch.Generator().manual_seed(7)
    x, w, b, r = _operands(gen, 1, 50, 48, 7, torch.bfloat16)
    res = r if residual else None
    got = k11.amp_conv(x, w, b, 3, res)
    assert got.dtype == torch.bfloat16
    want = k11.amp_conv(x.float(), w.float(), b.float(), 3,
                        None if res is None else res.float())
    torch.testing.assert_close(got, want.to(torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(got.float(), _unfused(x, w, b, 3, res).float(),
                               rtol=2 ** -6, atol=1e-2)


def _k_order_model(x, w, b, d, residual):
    """K11's product in the kernel's K order, replayed in plain torch: per
    slab kc (64 input channels; one slab holding every channel where the
    taps fold, C <= 32) and weight stage j, per 8-channel group g of its 64
    K rows, the slab rows of tap g // groups at channels 8 (g % groups)
    against w's rows of that group (folded: rows 8 g of w as [k C, C];
    else rows 64 kc + 8 (g - 8 j) of tap j); groups past the last tap read
    tap 0 against zero rows. Holds the index arithmetic, none of the CUDA
    code."""
    bsz, t, c = x.shape
    k = w.shape[0]
    halo = d * (k - 1) // 2
    cp = -(-c // 64) * 64
    fold = c <= 32
    groups = c // 8 if fold else 8
    slab_stages = -(-k * c // 64) if fold else k
    slab = torch.zeros((bsz, t + 2 * halo, cp))
    slab[:, halo:halo + t, :c] = x.float()
    if fold:
        wk = torch.zeros((slab_stages * 64, cp))
        wk[:k * c, :c] = w.float().reshape(k * c, c)
    else:
        wk = torch.zeros((k, cp, cp))
        wk[:, :c, :c] = w.float()
    acc = torch.zeros((bsz, t, cp))
    for kc in range(cp // 64):
        for j in range(slab_stages):
            for g in range(8 * j, 8 * j + 8):
                tap, grp = divmod(g, groups)
                tap = tap if tap < k else 0
                a = slab[:, tap * d:tap * d + t,
                         64 * kc + 8 * grp:64 * kc + 8 * grp + 8]
                rows = (wk[8 * g:8 * g + 8] if fold else
                        wk[j, 64 * kc + 8 * (g - 8 * j):
                           64 * kc + 8 * (g - 8 * j) + 8])
                acc += a @ rows
    y = acc[..., :c] + b.float()
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype)


@pytest.mark.parametrize("c,k,d", [(8, 11, 5), (24, 3, 1), (24, 7, 3),
                                   (24, 11, 5), (32, 7, 5), (48, 11, 3),
                                   (64, 7, 1), (96, 3, 5), (200, 11, 1)])
def test_kernel_k_order_model(c, k, d):
    """The kernel's K order (taps folded into K at C <= 32, else a slab a
    64 channels) gives the plain version's answer."""
    gen = torch.Generator().manual_seed(c + k + d)
    x, w, b, r = _operands(gen, 2, 40, c, k)
    torch.testing.assert_close(_k_order_model(x, w, b, d, r),
                               k11.amp_conv(x, w, b, d, r), rtol=1e-5,
                               atol=1e-5)


# (T, C) of each stage of a 1.5 s, a 5 s and a 14.4 s clip (129, 431 and
# 1240 mel frames) and the tile the shape takes on 132 SMs
TILE_CASES = [
    (1032, 768, (64, 1)), (4128, 384, (128, 1)), (8256, 192, (64, 2)),
    (16512, 96, (128, 1)), (33024, 48, (64, 2)), (66048, 24, (64, 2)),
    (3448, 768, (256, 1)), (13792, 384, (128, 1)), (27584, 192, (64, 2)),
    (55168, 96, (128, 1)), (110336, 48, (64, 2)), (220672, 24, (64, 2)),
    (9920, 768, (256, 1)), (39680, 384, (128, 1)), (79360, 192, (64, 2)),
]


@pytest.mark.parametrize("t,c,want", TILE_CASES)
def test_tile_follows_the_shape(t, c, want):
    """The tile is one the kernel takes, its chunks cover C rounded up to
    64, and a short clip's widest stage gets narrow chunks, so that its
    jobs spread over the card where a longer clip's fill it with wide
    ones."""
    n, mt = k11.tile(t, c, 1, 132)
    assert (n, mt) in k11.TILES and (-(-c // 64) * 64) % n == 0
    assert (n, mt) == want
    jobs = -(-t // (128 * mt)) * (-(-c // 64) * 64 // n)
    assert jobs >= 81 or t * c < 81 * 128 * 64


class _Launched(Exception):
    """Raised in place of loading the kernel's library."""


def _bad_call(case):
    gen = torch.Generator().manual_seed(1)
    x, w, b, r = _operands(gen, 1, 16, 16, 3, torch.bfloat16)
    return {
        "bfloat16": lambda: k11.amp_conv(x, w, b, 2, r),
        "float32": lambda: k11.amp_conv(x.float(), w.float(), b.float()),
        "channels_12": lambda: k11.amp_conv(x[..., :12], w[:, :12, :12],
                                            b[:12]),
        "even_taps": lambda: k11.amp_conv(x, w[:2], b),
        "halo_65": lambda: k11.amp_conv(x, w, b, 65),
        "residual_shape": lambda: k11.amp_conv(x, w, b, 1, r[:, :8]),
    }[case]


@pytest.mark.parametrize("case,error", [
    ("bfloat16", _Launched), ("float32", TypeError),
    ("channels_12", ValueError), ("even_taps", ValueError),
    ("halo_65", ValueError), ("residual_shape", ValueError)])
def test_wrapper_checks_before_the_launch(monkeypatch, case, error):
    """Taken to its launch (``on_cpu`` patched to say CUDA, the library
    load patched to raise ``_Launched``), the wrapper raises on another
    type or on a shape the kernel does not take, and reaches the launch
    with bfloat16 operands it takes."""
    monkeypatch.setattr(kernels, "on_cpu", lambda *a: False)
    monkeypatch.setattr(build, "load", lambda *a: (_ for _ in ()).throw(
        _Launched()))
    with pytest.raises(error):
        _bad_call(case)()
    assert kernels.launches["amp_conv"] == 0


def _mel(frames=3):
    return np.random.default_rng(0).standard_normal((frames, 128)) - 4.0


@pytest.mark.parametrize("mode,calls", [("parity", 0), ("production", 108)])
def test_amp_block_takes_k11_in_bfloat16(monkeypatch, mode, calls):
    """A synthesize at narrow widths calls K11 for both convs of every
    AMPBlock1 step in bfloat16 (108 a pass, half with the residual) and
    never in float32, which stays on cuDNN."""
    seen = []
    real = bigvgan.amp_conv

    def counted(x, w, b, dilation=1, residual=None):
        seen.append(residual is not None)
        return real(x, w, b, dilation, residual)
    monkeypatch.setattr(bigvgan, "amp_conv", counted)
    vocoder = BigVGAN.random(0, NARROW, device="cpu")
    with precision(mode):
        out = vocoder.synthesize(_mel())
    assert out.shape == (1, 3 * NARROW.hop_size)
    assert len(seen) == calls and sum(seen) == calls // 2


def test_fused_residual_changes_only_rounding(monkeypatch):
    """The bfloat16 path with K11 (the residual in the conv's sum, one
    rounding) against the same path with each conv and add done apart,
    as before K11: within bfloat16's rounding of each other."""
    vocoder = BigVGAN.random(0, NARROW, device="cpu")
    with precision("production"):
        fused = vocoder.synthesize(_mel(5))
        monkeypatch.setattr(bigvgan, "amp_conv", _unfused)
        apart = vocoder.synthesize(_mel(5))
    rel = np.linalg.norm(fused - apart) / np.linalg.norm(apart)
    assert 0 < rel < 2e-2
