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
from voicefixer_tpu.ops import conv as jax_conv
from voicefixer_tpu.pipeline import vocoder_facade as jax_facade

from voicefixer_tpu_torch.config import tiny_test_config
from voicefixer_tpu_torch.models import analysis, denoiser, resunet
from voicefixer_tpu_torch.ops import conv
from voicefixer_tpu_torch.pipeline import vocoder_facade
from voicefixer_tpu_torch.utils.weights import from_jax_params
from tests.test_torch_weights import jax_param_trees

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
def test_conv1d_dilated_bfloat16(dilation, monkeypatch):
    """A bfloat16 conv1d at dilation 27 and C=512 runs folded to [W/d, d]
    (ops/conv.py); at dilation 3 and C=8 it runs as such. Both sides sum the
    same float32 products and round once, so they differ by at most one
    bfloat16 ulp (2^-8 relative) where the sums straddle a rounding
    boundary."""
    folds = dilation >= conv.FOLD_MIN_DILATION
    cin = conv.FOLD_MIN_CHANNELS if folds else 8
    x, w, b = _x((2, 90, cin)), _x((3, cin, 6), 1, 0.3 / cin ** 0.5), \
        _x((6,), 4, 0.1)
    calls = []
    folded = conv._conv1d_folded
    monkeypatch.setattr(conv, "_conv1d_folded",
                        lambda *a: calls.append(1) or folded(*a))
    ref = jax_conv.conv1d(*(_J(a).astype(jnp.bfloat16) for a in (x, w, b)),
                          padding=dilation, dilation=dilation)
    got = conv.conv1d(*(_T(a).bfloat16() for a in (x, w, b)),
                      padding=dilation, dilation=dilation)
    assert len(calls) == int(folds)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    _close(got.float(), ref.astype(jnp.float32), 1e-2, rtol=2 ** -7)


def test_wav_to_mel(params):
    wav = _x((2, 20000), 10, 0.3)
    ref = _jit(jax_analysis.wav_to_mel, cfg=JCFG)(_J(wav))
    got = analysis.wav_to_mel(_T(wav), CFG)
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
