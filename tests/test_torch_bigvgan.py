"""BigVGAN-v2 in the port (``models/bigvgan.py``, ``kernels/snake_aa.py``,
K1 without its pre-pass, ``utils.weights.convert_bigvgan``, the
``BigVGAN`` facade) against the plain float32 reference
``tests/torch_reference_bigvgan.py``, on the CPU at narrowed widths:
upstream's structure (6 stages at rates 8, 4, 2, 2, 2, 2; AMP blocks of
kernels 3, 7, 11 at dilations 1, 3, 5) from 128 channels down to 2, a few
mel frames. The state dicts are upstream's own: the modules below have
upstream's names, wrapped in weight norm, and ``state_dict()`` gives the
keys."""

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from bench_cuda.reference import bigvgan as bench_reference
from tests import torch_reference_bigvgan as reference
from tests.test_torch_weights import one_torch_thread  # noqa: F401
from voicefixer_tpu_torch.config import BigVGANConfig
from voicefixer_tpu_torch.kernels.snake_aa import (FILTER, kaiser_sinc_filter,
                                                   snake_aa_reference)
from voicefixer_tpu_torch.kernels.upsample import upsample_reference
from voicefixer_tpu_torch.models import bigvgan
from voicefixer_tpu_torch.ops.precision import precision
from voicefixer_tpu_torch.pipeline.vocoder_facade import BigVGAN
from voicefixer_tpu_torch.utils.flops import bigvgan_flops
from voicefixer_tpu_torch.utils.weights import convert_bigvgan, tree_leaves

NARROW = BigVGANConfig(upsample_initial_channel=128)
FRAMES = 5
WEIGHT_NORMS = ("weight_g", "parametrizations")


class _Snake(nn.Module):
    def __init__(self, c, gen):
        super().__init__()
        self.alpha = nn.Parameter(0.3 * torch.randn(c, generator=gen))
        self.beta = nn.Parameter(0.3 * torch.randn(c, generator=gen))


class _Act(nn.Module):
    """Upstream's ``Activation1d``: ``act``, ``upsample.filter``,
    ``downsample.lowpass.filter``."""

    def __init__(self, c, gen):
        super().__init__()
        self.act = _Snake(c, gen)
        self.upsample = nn.Module()
        self.upsample.register_buffer("filter", FILTER.view(1, 1, 12).clone())
        self.downsample = nn.Module()
        self.downsample.lowpass = nn.Module()
        self.downsample.lowpass.register_buffer(
            "filter", FILTER.view(1, 1, 12).clone())


def _wn(module, style, gen, scale=1.0):
    """Weight norm in either of torch's key layouts, with a gain other
    than ||v|| (so that the fold matters) and a bias other than 0; the
    weight N(0, scale^2 / fan_in)."""
    with torch.no_grad():
        fan = module.weight[0].numel()
        module.weight.normal_(0.0, scale * fan ** -0.5, generator=gen)
        if module.bias is not None:
            module.bias.uniform_(-0.05, 0.05, generator=gen)
    if style == "weight_g":
        module = nn.utils.weight_norm(module)
        g = module.weight_g
    else:
        module = nn.utils.parametrizations.weight_norm(module)
        g = module.parametrizations.weight.original0
    with torch.no_grad():
        g.mul_(0.9 + 0.2 * torch.rand(g.shape, generator=gen))
    return module


def upstream_state_dict(cfg: BigVGANConfig, style: str, seed: int = 0):
    """A generator with upstream's module names at ``cfg``'s widths; its
    state dict as numpy arrays."""
    gen = torch.Generator().manual_seed(seed)
    ch = cfg.channels
    m = nn.Module()
    m.conv_pre = _wn(nn.Conv1d(cfg.num_mels, ch[0], 7, padding=3), style, gen)
    m.ups = nn.ModuleList()
    m.resblocks = nn.ModuleList()
    for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                   cfg.upsample_kernel_sizes)):
        m.ups.append(nn.ModuleList([_wn(nn.ConvTranspose1d(
            ch[i], ch[i + 1], k, u, padding=(k - u) // 2), style, gen)]))
        for kr, dils in zip(cfg.resblock_kernel_sizes,
                            cfg.resblock_dilation_sizes):
            block = nn.Module()
            c = ch[i + 1]
            block.convs1 = nn.ModuleList(
                [_wn(nn.Conv1d(c, c, kr), style, gen) for _ in dils])
            block.convs2 = nn.ModuleList(
                [_wn(nn.Conv1d(c, c, kr), style, gen) for _ in dils])
            block.activations = nn.ModuleList(
                [_Act(c, gen) for _ in range(2 * len(dils))])
            m.resblocks.append(block)
    m.activation_post = _Act(ch[-1], gen)
    # the wave well inside the clamp
    m.conv_post = _wn(nn.Conv1d(ch[-1], 1, 7, padding=3, bias=False), style,
                      gen, scale=0.03)
    return {k: v.detach().numpy().copy() for k, v in m.state_dict().items()}


def _mel(frames=FRAMES, seed=1):
    """A log-mel of noise through upstream's front end: [frames, 128]."""
    wave = torch.as_tensor(0.3 * np.random.default_rng(seed).standard_normal(
        frames * NARROW.hop_size), dtype=torch.float32)
    return reference.log_mel(wave[None], NARROW)[0].T.contiguous()


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def state():
    return upstream_state_dict(NARROW, "weight_g")


@pytest.mark.parametrize("style", WEIGHT_NORMS)
def test_port_matches_reference(style):
    sd = upstream_state_dict(NARROW, style, seed=3)
    mel = _mel()
    vocoder = BigVGAN(convert_bigvgan(sd, NARROW), NARROW, device="cpu")
    got = vocoder.synthesize(mel.numpy())
    want = reference.generate(sd, mel.T[None], NARROW)
    assert got.shape == (1, FRAMES * NARROW.hop_size)
    assert float(want.abs().max()) < 1.0  # the clamp leaves it as it is
    assert _rel(got, want) <= 1e-5


def test_production_precision_casts_once(state):
    """bfloat16 storage through the same path, the tree cast once an
    instance; within bfloat16's rounding of the float32 answer."""
    mel = _mel()
    vocoder = BigVGAN(convert_bigvgan(state, NARROW), NARROW, device="cpu")
    with precision("production"):
        a = vocoder.synthesize(mel)
        b = vocoder.synthesize(mel[None])
    assert (vocoder.weight_casts.misses, vocoder.weight_casts.hits) == (1, 1)
    np.testing.assert_array_equal(a, b)
    want = reference.generate(state, mel.T[None], NARROW)
    assert 1e-4 < _rel(a, want) < 0.1


@pytest.mark.parametrize("t", [1, 2, 7, 45])
def test_snake_aa_plain_matches_activation1d(t):
    """The kernel's polyphase form (``snake_aa_reference``) against
    upstream's pad / transposed conv / crop / conv, both ends of the signal
    included, with alpha and beta other than 1; 45 rows span a kernel tile
    of 32 and its halo."""
    gen = torch.Generator().manual_seed(t)
    c = 5
    x = torch.randn((2, t, c), generator=gen)
    la, lb = 0.5 * torch.randn(c, generator=gen), 0.5 * torch.randn(
        c, generator=gen)
    got = snake_aa_reference(x, la, lb)
    want = reference.activation1d(x.transpose(1, 2), la, lb).transpose(1, 2)
    assert got.shape == (2, t, c)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_kaiser_filter():
    """12 taps, symmetric, summing to 1, upstream's numbers, from a Kaiser
    window of beta 0.1102 (A - 8.7) = 4.66 (A = 2.285 * 5 * pi * 1.2 +
    7.95)."""
    f = kaiser_sinc_filter()
    assert f.shape == (12,)
    torch.testing.assert_close(f, f.flip(0), rtol=0, atol=1e-8)
    assert abs(float(f.sum()) - 1.0) < 1e-6
    torch.testing.assert_close(f, reference.FILTER.view(12), rtol=1e-6,
                               atol=1e-8)
    beta = 0.1102 * (2.285 * 5 * np.pi * 1.2 + 7.95 - 8.7)
    assert abs(beta - 4.66) < 0.01
    t = torch.arange(-6, 6) + 0.5
    g = torch.kaiser_window(12, periodic=False, beta=beta) * torch.sinc(
        0.5 * t)
    torch.testing.assert_close(f, g / g.sum(), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("s", [8, 4, 2])
def test_upsample_without_pre_pass(s):
    """K1's plain version without x + sin x at BigVGAN's even rates is
    upstream's ConvTranspose1d(kernel 2s, stride s, padding s/2)."""
    gen = torch.Generator().manual_seed(s)
    cin, cout, t = 24, 16, 9
    x = torch.randn((2, t, cin), generator=gen)
    w = torch.randn((2 * s, cin, cout), generator=gen) / cin
    b = torch.randn((cout,), generator=gen)
    got = upsample_reference(x, w, b, s, sin_residual=False)
    want = F.conv_transpose1d(x.transpose(1, 2), w.permute(1, 2, 0), b,
                              stride=s, padding=s // 2).transpose(1, 2)
    assert got.shape == (2, t * s, cout)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("style", WEIGHT_NORMS)
def test_convert_bigvgan_consumes_every_key(style):
    sd = upstream_state_dict(NARROW, style)
    tree = convert_bigvgan(sd, NARROW)
    n_k = len(NARROW.resblock_kernel_sizes)
    assert len(tree["ups"]) == 6 and len(tree["resblocks"]) == 6 * n_k
    assert tree["ups"][0]["w"].shape == (16, 128, 64)
    # block 5: stage 1 (64 -> 32 channels), kernel 11
    assert tree["resblocks"][5]["convs1"][2]["w"].shape == (11, 32, 32)
    assert "b" not in tree["conv_post"]
    w = reference.weight({k: torch.as_tensor(v) for k, v in sd.items()},
                         "resblocks.4.convs2.1")
    np.testing.assert_allclose(tree["resblocks"][4]["convs2"][1]["w"],
                               w.permute(2, 1, 0).numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(tree["resblocks"][7]["acts"][3]["beta"],
                                  sd["resblocks.7.activations.3.act.beta"])


@pytest.mark.parametrize("change", ["renamed", "missing", "filter"])
def test_convert_bigvgan_fails_loudly(state, change):
    sd = dict(state)
    if change == "renamed":
        sd["resblocks.2.convs1.0.bias_renamed"] = sd.pop(
            "resblocks.2.convs1.0.bias")
    elif change == "missing":
        del sd["activation_post.act.beta"]
    else:
        key = "resblocks.0.activations.1.upsample.filter"
        sd[key] = sd[key] * 1.01
    with pytest.raises((KeyError, ValueError)):
        convert_bigvgan(sd, NARROW)


def test_reference_copies_agree(state):
    """The benchmark's copy in float32 gives the test copy's log-mel and
    wave."""
    wave = torch.as_tensor(0.3 * np.random.default_rng(5).standard_normal(
        FRAMES * NARROW.hop_size + 100), dtype=torch.float32)[None]
    mel = reference.log_mel(wave, NARROW)
    torch.testing.assert_close(bench_reference.log_mel(wave, NARROW), mel,
                               rtol=0, atol=0)
    assert mel.shape == (1, 128, FRAMES)
    ref = bench_reference.Reference(
        {k: torch.as_tensor(v) for k, v in state.items()}, NARROW)
    got = ref.restore(mel[0].T.numpy())
    want = reference.generate(state, mel, NARROW)[0]
    torch.testing.assert_close(torch.as_tensor(got), want, rtol=1e-6,
                               atol=1e-9)


def test_published_sizes():
    """The published configuration: about 122 M parameters, 3.1e11 FLOPs an
    audio second, 109 activations a pass."""
    cfg = BigVGANConfig()
    tree = bigvgan.init(cfg, torch.Generator(), "meta")
    n = sum(t.numel() for t in tree_leaves(tree))
    assert 121e6 < n < 123e6
    acts = sum(len(b["acts"]) for b in tree["resblocks"]) + 1
    assert acts == 109
    assert bigvgan_flops(cfg, 44100 / 512) == pytest.approx(3.107e11,
                                                            rel=1e-3)

