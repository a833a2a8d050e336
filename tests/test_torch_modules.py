"""The port's modules against their JAX counterparts at tiny_test_config, on
the same parameters (numpy-filled JAX trees, through ``from_jax_params``) and
the same numpy-seeded inputs. Both sides run in float32 (parity mode); the
JAX side takes its plain path on the CPU, jitted as the JAX package runs it.

Tolerances: float32 results summed in another order by another library.
1e-5 where an output is O(1) after few layers (conv primitives, the
denoiser mask); 1e-4 relative for the mel (a 2048-tap DFT); 1e-4 for the
ResUNet and analysis stacks (tens of chained convs on log-mel inputs of
magnitude ~10); 2e-5 for the vocoder waveform (bounded by tanh).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicefixer_tpu.config import tiny_test_config as jax_tiny
from voicefixer_tpu.models import analysis as jax_analysis
from voicefixer_tpu.models import denoiser as jax_denoiser
from voicefixer_tpu.models import resunet as jax_resunet
from voicefixer_tpu.models import vocoder as jax_vocoder
from voicefixer_tpu.ops import conv as jax_conv
from voicefixer_tpu.pipeline import vocoder_facade as jax_facade

from voicefixer_tpu_torch.config import tiny_test_config
from voicefixer_tpu_torch.kernels.resstack import res_stack
from voicefixer_tpu_torch.models import analysis, denoiser, resunet, vocoder
from voicefixer_tpu_torch.ops import conv
from voicefixer_tpu_torch.pipeline import vocoder_facade
from voicefixer_tpu_torch.utils.weights import from_jax_params
from tests.test_torch_weights import (jax_param_trees,  # noqa: F401
                                      one_torch_thread)

CFG, JCFG = tiny_test_config(), jax_tiny()


@pytest.fixture(scope="module")
def params():
    """(jax analysis, jax vocoder, port analysis, port vocoder)."""
    ja, jv = jax_param_trees(0)
    pa, pv = from_jax_params(ja, jv, "cpu")
    return ja, jv, pa, pv


def _x(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, ref, tol, rtol=None):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), atol=tol,
                               rtol=tol if rtol is None else rtol)


_T = torch.from_numpy
_J = jnp.asarray


def _jit(fn, **static):
    return jax.jit(functools.partial(fn, **static))


def _conv_cases():
    x1, x2 = _x((2, 37, 6)), _x((2, 9, 11, 6))
    w1, w2 = _x((3, 6, 5), 1, 0.3), _x((3, 3, 6, 5), 2, 0.3)
    wt1 = _x((14, 6, 5), 3, 0.3)
    b = _x((5,), 4, 0.1)
    bn = {"gamma": _x((6,), 5) + 1, "beta": _x((6,), 6),
          "mean": _x((6,), 7), "var": np.abs(_x((6,), 8)) + 0.5}
    return {
        "conv1d": (lambda m, t: m.conv1d(t(x1), t(w1), t(b), padding=3,
                                         dilation=3)),
        "conv1d_stride": (lambda m, t: m.conv1d(t(x1), t(w1), t(b), stride=2)),
        "reflection_pad1d": (lambda m, t: m.reflection_pad1d(t(x1), 3)),
        "conv_transpose1d": (lambda m, t: m.conv_transpose1d(
            t(x1), t(wt1), t(b), stride=7, padding=4, output_padding=1)),
        "conv2d": (lambda m, t: m.conv2d(t(x2), t(w2), t(b), padding=(1, 1))),
        "conv_transpose2d": (lambda m, t: m.conv_transpose2d(
            t(x2), t(w2), stride=(2, 2))),
        "avg_pool2d": (lambda m, t: m.avg_pool2d(t(x2))),
        "batch_norm": (lambda m, t: m.batch_norm(
            t(x2), {k: t(v) for k, v in bn.items()})),
        "fold_bn_eval": (lambda m, t: m.batch_norm(
            t(x2), m.fold_bn_eval({k: t(v) for k, v in bn.items()}))),
        "leaky_relu": (lambda m, t: m.leaky_relu(t(x1), 0.2)),
        "elu": (lambda m, t: m.elu(t(x1))),
    }


@pytest.mark.parametrize("name", sorted(_conv_cases()))
def test_conv_primitive(name):
    fn = _conv_cases()[name]
    ref = fn(jax_conv, _J)
    got = fn(conv, _T)
    assert tuple(got.shape) == ref.shape
    _close(got, ref, 1e-5)


@pytest.mark.parametrize("dilation", [3, 27])
def test_conv1d_dilated_bfloat16(dilation):
    """A bfloat16 dilated conv1d, at C=8 and at C=512 with dilation 27 (the
    shape cuDNN is slow at on the card; the port once folded it, and no
    longer does since the ResStack runs through its own kernels). Both sides
    sum the same float32 products and round once, so they differ by at most
    one bfloat16 ulp (2^-8 relative) where the sums straddle a rounding
    boundary."""
    cin = 512 if dilation >= 27 else 8
    x, w, b = _x((2, 90, cin)), _x((3, cin, 6), 1, 0.3 / cin ** 0.5), \
        _x((6,), 4, 0.1)
    ref = jax_conv.conv1d(*(_J(a).astype(jnp.bfloat16) for a in (x, w, b)),
                          padding=dilation, dilation=dilation)
    got = conv.conv1d(*(_T(a).bfloat16() for a in (x, w, b)),
                      padding=dilation, dilation=dilation)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    _close(got.float(), ref.astype(jnp.float32), 1e-2, rtol=2 ** -7)


def test_wav_to_mel(params):
    wav = _x((2, 20000), 10, 0.3)
    ref = _jit(jax_analysis.wav_to_mel, cfg=JCFG)(_J(wav))
    got = analysis.wav_to_mel(_T(wav), CFG)
    _close(got, ref, 1e-5, rtol=1e-4)


@pytest.mark.parametrize("n", [1, 2, 500, 1024, 1025])
def test_wav_to_mel_short_wave(n):
    """Waves no longer than the centre pad (n_fft // 2 = 1024): the reflect
    pad reflects again off the far end, as ``jnp.pad`` does, and a single
    sample is repeated. Same tolerance as the long wave."""
    wav = _x((2, n), 12, 0.3)
    ref = _jit(jax_analysis.wav_to_mel, cfg=JCFG)(_J(wav))
    got = analysis.wav_to_mel(_T(wav), CFG)
    assert tuple(got.shape) == ref.shape
    _close(got, ref, 1e-5, rtol=1e-4)


def test_denoiser_apply(params):
    ja, _, pa, _ = params
    mel = np.abs(_x((2, 57, 128), 11))
    ref = _jit(jax_denoiser.apply, cfg=JCFG.denoiser)(ja["denoiser"], _J(mel))
    got = denoiser.apply(pa["denoiser"], _T(mel), CFG.denoiser)
    _close(got, ref, 1e-5)


@pytest.mark.parametrize("folded", [False, True])
def test_resunet_apply(params, folded):
    ja, _, pa, _ = params
    jp, pp = ja["unet"], pa["unet"]
    if folded:
        jp, pp = jax_conv.fold_bn_eval(jp), conv.fold_bn_eval(pp)
    x = _x((2, 70, 128, 2), 12, 3.0)
    ref = _jit(jax_resunet.apply, cfg=JCFG.unet)(jp, _J(x))
    got = resunet.apply(pp, _T(x), CFG.unet)
    assert tuple(got.shape) == ref.shape == (2, 70, 128, 1)
    _close(got, ref, 1e-4)


def test_analysis_apply(params):
    ja, _, pa, _ = params
    mel = np.abs(_x((1, 101, 128), 13)) + 1e-3
    ref = _jit(jax_analysis.apply, cfg=JCFG)(ja, _J(mel))
    got = analysis.apply(pa, _T(mel), CFG)
    for k in ("mel", "clean", "unet_out"):
        _close(got[k], ref[k], 1e-4)


def test_synthesize(params):
    _, jv, _, pv = params
    mel = np.abs(_x((2, 23, 128), 14)) * 2 + 1e-3
    ref = _jit(jax_facade.synthesize, cfg=JCFG.vocoder)(jv, _J(mel))
    got = vocoder_facade.synthesize(pv, _T(mel), CFG.vocoder)
    assert tuple(got.shape) == ref.shape == (2, (23 + 1 + 4) * 441, 1)
    _close(got, ref, 2e-5)


@pytest.mark.parametrize("stage", [0, 1, 3])
def test_res_stack(params, stage):
    """The ResStack dispatcher (chains, shifted-tap blocks, the stage's
    LeakyReLU in the last launch) against the JAX package's plain ResStack
    and activation. The signal is shorter than the largest dilations."""
    _, jv, _, pv = params
    ch = CFG.vocoder.channels // 2 ** (stage + 1)
    x = _x((2, 742, ch), 15 + stage)
    v = JCFG.vocoder
    ref, activated = jax.jit(functools.partial(
        jax_vocoder._res_stack, kernel=3, slope=v.leaky_slope_res))(
            jv["stages"][stage]["res"], _J(x))
    assert not activated  # the JAX package's plain path on the CPU
    ref = jax_conv.leaky_relu(ref, v.leaky_slope_act)
    got = res_stack(pv["stages"][stage]["res"], _T(x), 3,
                    CFG.vocoder.leaky_slope_res,
                    final_slope=CFG.vocoder.leaky_slope_act)
    _close(got, ref, 1e-5)


@pytest.mark.parametrize("fuse_max", [0, 8, 128])
def test_synthesize_dispatch(params, monkeypatch, fuse_max):
    """Every split of the stages between the fused form (up_res_stack) and
    the unfused one (upsample, then res_stack) gives the JAX package's
    waveform."""
    _, jv, _, pv = params
    monkeypatch.setattr(vocoder, "FUSE_MAX_CHANNELS", fuse_max)
    mel = np.abs(_x((1, 23, 128), 16)) * 2 + 1e-3
    ref = _jit(jax_facade.synthesize, cfg=JCFG.vocoder)(jv, _J(mel))
    got = vocoder_facade.synthesize(pv, _T(mel), CFG.vocoder)
    _close(got, ref, 2e-5)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_single_direction(reverse):
    """One direction of one layer (``kernels.gru.gru_seq`` behind the hoisted
    projection) against the JAX package's scan, T no multiple of 8, B = 2."""
    from voicefixer_tpu.ops import gru as jax_gru

    from voicefixer_tpu_torch.ops import gru
    cin, h, t = 24, 16, 61
    p = {"w_ih": _x((3 * h, cin), 20, 0.2), "w_hh": _x((3 * h, h), 21, 0.2),
         "b_ih": _x((3 * h,), 22, 0.1), "b_hh": _x((3 * h,), 23, 0.1)}
    x = _x((2, t, cin), 24)
    ref = jax_gru.gru_single_direction(
        _J(x), {k: _J(v) for k, v in p.items()}, reverse=reverse)
    got = gru.gru_single_direction(
        _T(x), {k: _T(v) for k, v in p.items()}, reverse=reverse)
    assert tuple(got.shape) == ref.shape == (2, t, h)
    _close(got, ref, 1e-5)


def test_gru_unidirectional_two_layers():
    """``gru(..., bidirectional=False)``: layer 1 takes H inputs, not 2H."""
    from voicefixer_tpu.ops import gru as jax_gru

    from voicefixer_tpu_torch.ops import gru
    cin, h, t = 24, 16, 45
    p = {}
    for layer, width in enumerate((cin, h)):
        p[f"l{layer}"] = {"w_ih": _x((3 * h, width), 30 + layer, 0.2),
                          "w_hh": _x((3 * h, h), 32 + layer, 0.2),
                          "b_ih": _x((3 * h,), 34 + layer, 0.1),
                          "b_hh": _x((3 * h,), 36 + layer, 0.1)}
    x = _x((2, t, cin), 38)
    conv_tree = lambda f: {k: {n: f(v) for n, v in d.items()}  # noqa: E731
                           for k, d in p.items()}
    ref = jax_gru.gru(_J(x), conv_tree(_J), 2, bidirectional=False)
    got = gru.gru(_T(x), conv_tree(_T), 2, bidirectional=False)
    assert tuple(got.shape) == ref.shape == (2, t, h)
    _close(got, ref, 1e-5)
    shapes = gru.init_gru_params(torch.Generator().manual_seed(0), cin, h, 2,
                                 "cpu", bidirectional=False)
    assert sorted(shapes) == ["l0", "l1"]
    assert {k: tuple(v.shape) for k, v in shapes["l1"].items()} == {
        k: v.shape for k, v in p["l1"].items()}


def test_vocoder_res_stack_contract(params):
    """``vocoder._res_stack`` returns (out, activated) as the JAX package's
    does, and passes the signal window on."""
    _, _, _, pv = params
    ch = CFG.vocoder.channels // 2
    x = _T(_x((1, 300, ch), 40))
    res = pv["stages"][0]["res"]
    out, activated = vocoder._res_stack(res, x, 3, 0.01, final_slope=0.2,
                                        mask_bounds=(20, 250))
    assert activated
    assert float(out[:, :20].abs().sum() + out[:, 250:].abs().sum()) == 0.0
    inner, _ = vocoder._res_stack(res, x[:, 20:250], 3, 0.01, final_slope=0.2)
    _close(out[:, 20:250], inner.numpy(), 1e-6)
    out, activated = vocoder._res_stack(res, x, 3, 0.01)
    assert not activated


# ------------------------------------ inverse STFT, mel basis, Vocoder

_STFT_CASES = {
    "default": ({}, 44100),
    "hop512_constant_odd": ({"hop_length": 512, "pad_mode": "constant"},
                            44101),
    "fewer_frames_than_rows": ({"hop_length": 512}, 1500),
    "short_window": ({"win_length": 1024, "hop_length": 300}, 9001),
}


@pytest.mark.parametrize("name", sorted(_STFT_CASES))
def test_istft_matches_jax(name):
    """``spectrogram_phase`` -> ``spectrogram_to_wav`` and ``istft`` with and
    without ``length``, against the JAX package at 1e-5. A bin's phase is
    known only to the sums' error over its magnitude, so cos and sin are
    held through mag * cos and mag * sin, the STFT's real and imaginary
    parts; the magnitude to 1e-5 relative."""
    from voicefixer_tpu.config import STFTConfig as JaxSTFT
    from voicefixer_tpu.ops import stft as jax_stft

    from voicefixer_tpu_torch.config import STFTConfig
    from voicefixer_tpu_torch.ops import stft
    kw, n = _STFT_CASES[name]
    pc, jc = STFTConfig(**kw), JaxSTFT(**kw)
    x = _x((2, n), 20, 0.1)
    jm, jcos, jsin = jax_stft.spectrogram_phase(_J(x), jc)
    m, cos, sin = stft.spectrogram_phase(_T(x), pc)
    _close(m, jm, 1e-5)
    _close(m * cos, jm * jcos, 1e-5)
    _close(m * sin, jm * jsin, 1e-5)
    ref = jax_stft.spectrogram_to_wav(jm, jcos, jsin, jc, length=n)
    got = stft.spectrogram_to_wav(m, cos, sin, pc, length=n)
    assert got.shape == ref.shape
    _close(got, ref, 1e-5)
    re, im = _x((2, 7, pc.n_freqs), 21), _x((2, 7, pc.n_freqs), 22)
    ref = jax_stft.istft(_J(re), _J(im), jc)
    got = stft.istft(_T(re), _T(im), pc)
    assert got.shape == ref.shape
    _close(got, ref, 1e-5)


def test_idft_matrices_match_jax():
    """The same angles, reduced exactly; the two libraries' float32 sin and
    cos differ by an ulp here and there."""
    from voicefixer_tpu.ops import stft as jax_stft

    from voicefixer_tpu_torch.ops import stft
    for n_fft, win in ((2048, 2048), (512, 400)):
        got = stft.idft_matrices(n_fft, win, torch.device("cpu"))
        ref = jax_stft.idft_matrices_ingraph(n_fft, win)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                       atol=1e-10)


@pytest.mark.parametrize("args", [(2048, 128, 44100), (1024, 80, 22050)])
def test_librosa_mel_basis_matches_jax(args):
    from voicefixer_tpu.ops import mel as jax_mel

    from voicefixer_tpu_torch.ops import mel
    np.testing.assert_array_equal(mel.librosa_mel_basis(*args),
                                  jax_mel.librosa_mel_basis(*args))
    np.testing.assert_array_equal(mel.melscale_fbanks(args[0] // 2 + 1),
                                  jax_mel.melscale_fbanks(args[0] // 2 + 1))


@pytest.fixture(scope="module")
def vocoders(params):
    _, jv, _, pv = params
    return (jax_facade.Vocoder(params=jv, config=JCFG),
            vocoder_facade.Vocoder(params=pv, config=CFG, device="cpu"))


def test_vocoder_facade_forward(vocoders):
    """``Vocoder.forward`` on [B, 1, T, 128] and [B, T, 128] -> [B, 1, S],
    against the JAX package's facade (the vocoder's 2e-5)."""
    jvoc, voc = vocoders
    mel = np.abs(_x((2, 1, 23, 128), 23, 10.0))
    ref = jvoc.forward(mel)
    got = voc.forward(mel)
    assert got.shape == ref.shape == (2, 1, (23 + 23 % 2 + 4) * 441)
    _close(got, ref, 2e-5)
    np.testing.assert_array_equal(voc(mel[:, 0]), got)
    with pytest.raises(ValueError, match="mel bins"):
        voc.forward(mel[..., :64])


@pytest.mark.parametrize("pad_mode", ["constant", "reflect"])
def test_vocoder_facade_oracle(vocoders, tmp_path, pad_mode):
    """Copy synthesis from a 22.05 kHz file (resampled, peak-normalised,
    librosa's mel) against the JAX package's, and the int16 file each
    writes within one LSB."""
    from scipy.io import wavfile
    jvoc, voc = vocoders
    src = str(tmp_path / "in.wav")
    wavfile.write(src, 22050, (_x(9000, 24, 3000.0)).astype(np.int16))
    ref = jvoc.oracle(src, str(tmp_path / "jax.wav"), pad_mode=pad_mode)
    got = voc.oracle(src, str(tmp_path / "port.wav"), pad_mode=pad_mode)
    t = 18000 // 441 + 1
    assert got.shape == ref.shape == (1, (t + t % 2 + 4) * 441)
    _close(got, ref, 2e-5)
    a = wavfile.read(str(tmp_path / "port.wav"))[1].astype(np.int32)
    b = wavfile.read(str(tmp_path / "jax.wav"))[1].astype(np.int32)
    assert np.abs(a - b).max() <= 1


def test_vocoder_facade_device_and_rate(monkeypatch):
    with pytest.raises(RuntimeError, match="44100"):
        vocoder_facade.Vocoder(sample_rate=16000, params={}, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        vocoder_facade.Vocoder.random(0, CFG)
