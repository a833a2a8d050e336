"""The port's PQMF (``ops.pqmf``), its complex and subband spectrogram
transforms (``ops.fdomain``), ``ops.stft.wav_to_spectrogram_phase`` and
``ops.norm.pad_tail_frames`` against the JAX package's, on the same
numpy-seeded inputs; and the port's own reconstruction floors, those of
``tests/test_pqmf.py`` and ``tests/test_fdomain.py``.

Tolerances, relative to the largest |reference|: 1e-5 for the PQMF (63-tap
float32 convolutions in another order), 1e-4 for the transforms (a 512-tap
DFT, its inverse, and the PQMF around them); a phase (cos, sin) is held
through the real and imaginary parts it stands for (``_held_mag_phase``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicefixer_tpu.config import STFTConfig as JSTFTConfig
from voicefixer_tpu.config import VocoderConfig as JVocoderConfig
from voicefixer_tpu.ops import fdomain as jax_fd
from voicefixer_tpu.ops import norm as jax_norm
from voicefixer_tpu.ops import pqmf as jax_pqmf
from voicefixer_tpu.ops import stft as jax_stft

from voicefixer_tpu_torch.config import STFTConfig, VocoderConfig
from voicefixer_tpu_torch.ops import fdomain as fd
from voicefixer_tpu_torch.ops import norm, pqmf, stft
from tests.test_torch_weights import one_torch_thread  # noqa: F401

CFG = STFTConfig(n_fft=512, hop_length=128, win_length=512)
JCFG = JSTFTConfig(n_fft=512, hop_length=128, win_length=512)
PQMF_TOL = 1e-5
FD_TOL = 1e-4


def _x(shape, seed=0, scale=0.3):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _held(got, ref, tol):
    """max |got - ref| within tol times the largest |ref|."""
    got = [got] if isinstance(got, torch.Tensor) else list(got)
    ref = [ref] if not isinstance(ref, (tuple, list)) else list(ref)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        g = g.numpy()
        assert g.shape == r.shape, (g.shape, r.shape)
        err = float(np.abs(g - r).max())
        assert err <= tol * float(np.abs(r).max()), err


def _held_mag_phase(got, ref, tol):
    """(mag, cos, sin): mag as ``_held``; cos and sin weighted by the
    reference magnitude, i.e. the real and imaginary parts they stand for.
    Where the magnitude is near 0 the phase is ill-conditioned: an error of
    1e-6 in a float32 DFT sum moves cos by 1e-6 / |X| at a bin of
    magnitude |X|."""
    mag = np.asarray(ref[0])
    _held(got[0], mag, tol)
    for g, r in zip(got[1:], ref[1:]):
        _held(got[0].new_tensor(mag) * g, mag * np.asarray(r), tol)


def _snr(a, b, edge=128):
    a = np.asarray(a, np.float64)[..., edge:-edge]
    b = np.asarray(b, np.float64)[..., edge:-edge]
    return 10 * np.log10((b * b).sum() / ((a - b) ** 2).sum())


# ------------------------------------------------------------------- PQMF

@pytest.mark.parametrize("bands", [2, 4, 8])
def test_pqmf_filters_equal(bands):
    for ours, theirs in zip(pqmf.design_pqmf_filters(bands),
                            jax_pqmf.design_pqmf_filters(bands)):
        assert ours.dtype == theirs.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("bands", [2, 4, 8])
def test_pqmf_matches_jax(bands):
    x = _x((2, 2048, 1), seed=bands)
    sub = pqmf.analysis(torch.from_numpy(x), bands=bands)
    jsub = jax_pqmf.analysis(jnp.asarray(x), bands=bands)
    _held(sub, jsub, PQMF_TOL)
    # synthesis on the same subbands
    s = np.asarray(jsub)
    _held(pqmf.synthesis(torch.from_numpy(s.copy()), bands=bands),
          jax_pqmf.synthesis(jnp.asarray(s), bands=bands), PQMF_TOL)


@pytest.mark.parametrize("bands", [2, 4, 8])
def test_pqmf_roundtrip(bands):
    """``tests/test_pqmf.py``'s floors: 25 dB at 2 bands, 35 at 4 and 8,
    the best lag within +-66 samples, the edges cut."""
    n = 4096
    t = np.arange(n) / 44100
    x = (np.sin(2 * np.pi * 440 * t) + 0.3 * np.sin(2 * np.pi * 3000 * t)
         + 0.05 * np.random.default_rng(0).standard_normal(n)).astype(
             np.float32)
    sub = pqmf.analysis(torch.from_numpy(x[None, :, None]), bands=bands)
    assert sub.shape == (1, n // bands, bands)
    rec = pqmf.synthesis(sub, bands=bands)[0, :, 0].numpy()
    assert rec.shape == (n,)
    d = 62
    a = x[d:-d]
    err = min(np.sqrt(np.mean((a - np.roll(rec, lag)[d:-d]) ** 2))
              for lag in range(-66, 67))
    snr = 20 * np.log10(np.sqrt(np.mean(a ** 2)) / (err + 1e-12))
    assert snr > (25.0 if bands == 2 else 35.0), snr


def test_pqmf_band_separation():
    t = np.arange(4096) / 44100
    x = np.sin(2 * np.pi * 1000 * t).astype(np.float32)[None, :, None]
    e = (pqmf.analysis(torch.from_numpy(x), bands=4)[0] ** 2).sum(0)
    assert e[0] > 100 * e[2] and e[0] > 100 * e[3]


# ---------------------------------------------------------------- fdomain

def _mag_phase(x):
    """(mag, cos, sin) of x from the JAX package, as numpy."""
    return [np.asarray(a) for a in jax_stft.wav_to_spectrogram_phase(
        jnp.asarray(x), JCFG)]


def _case(name, c):
    """(port result, JAX result) of fdomain function ``name`` on channel
    count c."""
    n = 8192
    x = _x((2, c, n), seed=c)
    sub_n = 16384
    xs = _x((2, c, sub_n), seed=10 + c)
    t = torch.from_numpy
    if name == "wav_to_spectrogram":
        return fd.wav_to_spectrogram(t(x), CFG), \
            jax_fd.wav_to_spectrogram(x, JCFG)
    if name == "spectrogram_to_wav_with_phase_from":
        mag = _x((2, c, 65, 257), seed=3, scale=1.0) ** 2
        return (fd.spectrogram_to_wav_with_phase_from(t(x), t(mag), CFG,
                                                      length=n),
                jax_fd.spectrogram_to_wav_with_phase_from(x, mag, JCFG,
                                                          length=n))
    if name == "spectrogram_phase_to_wav":
        sp, co, si = _mag_phase(x)
        return (fd.spectrogram_phase_to_wav(t(sp.copy()), t(co.copy()),
                                            t(si.copy()), CFG,
                                            length=n),
                jax_fd.spectrogram_phase_to_wav(sp, co, si, JCFG, length=n))
    if name == "complex_spectrogram":
        return fd.complex_spectrogram(t(x), CFG), \
            jax_fd.complex_spectrogram(x, JCFG)
    if name == "reverse_complex_spectrogram":
        spec = _x((2, c, 2, 65, 257), seed=4, scale=5.0)
        return (fd.reverse_complex_spectrogram(t(spec), CFG),
                jax_fd.reverse_complex_spectrogram(spec, JCFG))
    if name == "wav_to_complex_spectrogram":
        return fd.wav_to_complex_spectrogram(t(x), CFG), \
            jax_fd.wav_to_complex_spectrogram(x, JCFG)
    if name == "complex_spectrogram_to_wav":
        spec = _x((2, 2 * c, 65, 257), seed=5, scale=5.0)
        return (fd.complex_spectrogram_to_wav(t(spec), CFG, length=n - 7),
                jax_fd.complex_spectrogram_to_wav(spec, JCFG, length=n - 7))
    if name == "wav_to_complex_subband_spectrogram":
        return (fd.wav_to_complex_subband_spectrogram(t(xs), CFG, 4),
                jax_fd.wav_to_complex_subband_spectrogram(xs, JCFG, 4))
    if name == "complex_subband_spectrogram_to_wav":
        spec = np.asarray(jax_fd.wav_to_complex_subband_spectrogram(
            xs, JCFG, 4))
        return (fd.complex_subband_spectrogram_to_wav(
                    t(spec.copy()), CFG, 4, length=sub_n // 4),
                jax_fd.complex_subband_spectrogram_to_wav(
                    spec, JCFG, 4, length=sub_n // 4))
    if name == "wav_to_mag_phase_subband_spectrogram":
        return (fd.wav_to_mag_phase_subband_spectrogram(t(xs), CFG, 2),
                jax_fd.wav_to_mag_phase_subband_spectrogram(xs, JCFG, 2))
    if name == "mag_phase_subband_spectrogram_to_wav":
        sp, co, si = [np.asarray(a) for a in
                      jax_fd.wav_to_mag_phase_subband_spectrogram(xs, JCFG,
                                                                  8)]
        return (fd.mag_phase_subband_spectrogram_to_wav(
                    t(sp.copy()), t(co.copy()), t(si.copy()), CFG, 8,
                    length=sub_n // 8),
                jax_fd.mag_phase_subband_spectrogram_to_wav(
                    sp, co, si, JCFG, 8, length=sub_n // 8))
    if name == "wav_to_spectrogram_phase":
        return stft.wav_to_spectrogram_phase(t(x), CFG), _mag_phase(x)
    raise KeyError(name)


FUNCTIONS = ("wav_to_spectrogram", "spectrogram_to_wav_with_phase_from",
             "spectrogram_phase_to_wav", "complex_spectrogram",
             "reverse_complex_spectrogram", "wav_to_complex_spectrogram",
             "complex_spectrogram_to_wav",
             "wav_to_complex_subband_spectrogram",
             "complex_subband_spectrogram_to_wav",
             "wav_to_mag_phase_subband_spectrogram",
             "mag_phase_subband_spectrogram_to_wav",
             "wav_to_spectrogram_phase")


@pytest.mark.parametrize("c", [1, 2])
@pytest.mark.parametrize("name", FUNCTIONS)
def test_fdomain_matches_jax(name, c):
    got, ref = _case(name, c)
    if isinstance(got, tuple):  # (mag, cos, sin)
        _held_mag_phase(got, ref, FD_TOL)
    else:
        _held(got, ref, FD_TOL)


@pytest.mark.parametrize("subband", [2, 4, 8])
def test_subband_config_matches_jax(subband):
    for cfg, jcfg in ((CFG, JCFG), (STFTConfig(), JSTFTConfig())):
        ours = dataclasses.asdict(fd.subband_config(cfg, subband))
        theirs = dataclasses.asdict(jax_fd.subband_config(jcfg, subband))
        assert ours == theirs


@pytest.mark.parametrize("c", [1, 2])
def test_subband_roundtrips(c):
    """``tests/test_fdomain.py``'s floor, 55 dB inside the edges, for the
    complex and the mag-phase subband pairs at 4 subbands; the complex pair
    and the magnitude-and-phase pair without subbands within 1e-4."""
    x = _x((2, c, 16384), seed=20 + c)
    xt = torch.from_numpy(x)
    spec = fd.wav_to_complex_subband_spectrogram(xt, CFG, 4)
    assert spec.shape[1] == 8 * c
    back = fd.complex_subband_spectrogram_to_wav(spec, CFG, 4,
                                                 length=16384 // 4)
    assert back.shape == x.shape and _snr(back, x) > 55
    sps, coss, sins = fd.wav_to_mag_phase_subband_spectrogram(xt, CFG, 4)
    assert sps.shape[1] == 4 * c
    back = fd.mag_phase_subband_spectrogram_to_wav(sps, coss, sins, CFG, 4,
                                                   length=16384 // 4)
    assert back.shape == x.shape and _snr(back, x) > 55
    back = fd.complex_spectrogram_to_wav(
        fd.wav_to_complex_spectrogram(xt, CFG), CFG, length=16384)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-4)
    back = fd.spectrogram_phase_to_wav(
        *stft.wav_to_spectrogram_phase(xt, CFG), CFG, length=16384)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-4)


@pytest.mark.parametrize("t", [7, 8, 1])
def test_pad_tail_frames_matches_jax(t):
    mel = _x((2, 5, t), seed=t)
    got = norm.pad_tail_frames(torch.from_numpy(mel), VocoderConfig())
    ref = np.asarray(jax_norm.pad_tail_frames(jnp.asarray(mel),
                                              JVocoderConfig()))
    assert got.shape == ref.shape == (2, 5, t + t % 2 + 4)
    np.testing.assert_array_equal(got.numpy(), ref)
