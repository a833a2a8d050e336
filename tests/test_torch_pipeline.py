"""Mode-0 restore of the port against the JAX package at tiny_test_config
(1 s segments), on the same parameters and numpy-seeded audio, float32 on
both sides.

Tolerance 1e-5 on the waveform (samples of magnitude ~0.1 after a few
hundred float32 layers summed in another order; the error seen is ~1e-7).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicefixer_tpu.config import tiny_test_config as jax_tiny
from voicefixer_tpu.ops.conv import fold_bn_eval as jax_fold
from voicefixer_tpu.pipeline import restore as jax_restore

from voicefixer_tpu_torch.config import tiny_test_config
from voicefixer_tpu_torch.ops.conv import fold_bn_eval
from voicefixer_tpu_torch.pipeline import restore
from voicefixer_tpu_torch.utils.weights import from_jax_params
from tests.test_torch_weights import jax_param_trees

CFG, JCFG = tiny_test_config(), jax_tiny()
TOL = 1e-5


@pytest.fixture(scope="module")
def params():
    ja, jv = jax_param_trees(3)
    pa, pv = from_jax_params(ja, jv, "cpu")
    return ja, jv, pa, pv


def _wav(n, seed):
    return (0.1 * np.random.default_rng(seed).standard_normal(n)
            ).astype(np.float32)


def test_restore_batch(params):
    ja, jv, pa, pv = params
    wav = np.stack([_wav(CFG.pipeline.seg_length, s) for s in (4, 5)])
    ref_out, ref_peaks = jax.jit(functools.partial(
        jax_restore.restore_batch, cfg=JCFG))(jax_fold(ja), jv,
                                              jnp.asarray(wav))
    out, peaks = restore.restore_batch(fold_bn_eval(pa), pv,
                                       torch.from_numpy(wav), CFG)
    assert out.shape == ref_out.shape
    np.testing.assert_allclose(peaks.numpy(), np.asarray(ref_peaks),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                               rtol=TOL, atol=TOL)
    assert float(out.abs().max()) <= 1.0  # tanh output: the cap holds


def _snr_db(prod, ref):
    prod, ref = np.asarray(prod, np.float64), np.asarray(ref, np.float64)
    return 10 * np.log10(np.sum(ref * ref) / np.sum((prod - ref) ** 2))


def test_production_precision_matches_jax(params):
    """Production precision stores the same tensors in bfloat16 as the JAX
    package does: its SNR against parity is the JAX package's within 1.5 dB
    (a cast added or dropped moves it by far more; the JAX package's CPU path
    keeps the GRU product in float32, the port rounds it as the TPU kernel
    does), and the two production outputs share most of their rounding error
    (an unrelated error of the same size would put them 3 dB below the JAX
    package's SNR)."""
    from voicefixer_tpu.ops.precision import precision as jax_precision

    from voicefixer_tpu_torch.ops.precision import precision

    ja, jv, pa, pv = params
    wav = np.stack([_wav(CFG.pipeline.seg_length, s) for s in (4, 5)])
    out = {}
    for mode, jax_mode in (("production", "default"), ("parity", "highest")):
        with jax_precision(jax_mode):  # read at trace time: a fresh jit
            out["jax", mode] = np.asarray(jax.jit(functools.partial(
                jax_restore.restore_batch, cfg=JCFG))(
                    jax_fold(ja), jv, jnp.asarray(wav))[0])
        with precision(mode):
            out["port", mode] = restore.restore_batch(
                fold_bn_eval(pa), pv, torch.from_numpy(wav), CFG)[0].numpy()
    snr_jax = _snr_db(out["jax", "production"], out["jax", "parity"])
    snr_port = _snr_db(out["port", "production"], out["port", "parity"])
    assert abs(snr_port - snr_jax) <= 1.5, (snr_port, snr_jax)
    assert _snr_db(out["port", "production"],
                   out["jax", "production"]) >= snr_jax - 3.0


def test_restore_inmem_mode0_padded_tail(params):
    """2.5 segments: three chunks, the last padded to a full segment, one
    batch, trimmed back to the input length."""
    ja, jv, pa, pv = params
    wav = _wav(int(CFG.pipeline.seg_length * 2.5), 6)
    jvf = jax_restore.VoiceFixer(params=ja, vocoder_params=jv, config=JCFG)
    ref = jvf.restore_inmem(wav, mode=0)
    vf = restore.VoiceFixer(pa, pv, config=CFG, device="cpu")
    got = vf.restore_inmem(wav, mode=0)
    assert got.shape == ref.shape == wav.shape
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kwargs", [{"mode": 1}, {"mode": 2},
                                    {"chunk_overlap_seconds": 1.0},
                                    {"your_vocoder_func": lambda m: m}])
def test_restore_inmem_unported_options_raise(params, kwargs):
    _, _, pa, pv = params
    vf = restore.VoiceFixer(pa, pv, config=CFG, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        vf.restore_inmem(_wav(1000, 7), **kwargs)


@pytest.mark.parametrize("est_len,ref_len", [(10, 10), (14, 10), (15, 10),
                                             (7, 10), (11, 10)])
def test_trim_center_matches_jax(est_len, ref_len):
    est = np.arange(est_len, dtype=np.float32)
    np.testing.assert_array_equal(restore._trim_center(est, ref_len),
                                  jax_restore._trim_center(est, ref_len))
