"""Mode-0 restore of the port against the JAX package at tiny_test_config
(1 s segments), on the same parameters and numpy-seeded audio, float32 on
both sides.

Tolerance 1e-5 on the waveform (samples of magnitude ~0.1 after a few
hundred float32 layers summed in another order; the error seen is ~1e-7).
"""

import dataclasses
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


def test_production_precision_matches_jax(params, monkeypatch):
    """Production precision stores the same tensors in bfloat16 as the JAX
    package does: its SNR against parity is the JAX package's within 1.5 dB
    (a cast added or dropped moves it by far more; the JAX package's CPU path
    keeps the GRU product in float32, the port rounds it as the TPU kernel
    does), and the two production outputs share most of their rounding error
    (an unrelated error of the same size would put them 3 dB below the JAX
    package's SNR).

    The port's ResStack kernels keep h in float32 up to its bias and
    LeakyReLU, as the JAX package's Pallas kernels do; the JAX package's
    plain path on the CPU (XLA convolutions) rounds every convolution's
    output to bfloat16 and loses about 2 dB more. So the JAX side here runs
    its ResStacks through its own kernels in interpret mode
    (``kernels.resstack.res_stack``, which pads these narrow widths to 128
    lanes), in both precisions."""
    from voicefixer_tpu import kernels as jax_kernels
    from voicefixer_tpu.kernels import resstack as jax_resstack
    from voicefixer_tpu.models import vocoder as jax_vocoder
    from voicefixer_tpu.ops.precision import precision as jax_precision

    from voicefixer_tpu_torch.ops.precision import precision

    def res_stack_interpret(p, x, kernel, slope, final_slope=None,
                            mask_bounds=None):
        return jax_resstack.res_stack(
            p, x, kernel, slope, final_slope=final_slope,
            matmul_dtype=jax_kernels.matmul_dtype(), interpret=True), \
            final_slope is not None

    monkeypatch.setattr(jax_vocoder, "_res_stack", res_stack_interpret)
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
    np.testing.assert_allclose(out["port", "parity"], out["jax", "parity"],
                               rtol=TOL, atol=TOL)


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


def test_restore_inmem_short_tail_unpadded(params):
    """pad_short_to_seg=False: the last segment, 500 samples, runs at its
    own length, shorter than the STFT's centre pad."""
    ja, jv, pa, pv = params
    jcfg = dataclasses.replace(JCFG, pipeline=dataclasses.replace(
        JCFG.pipeline, pad_short_to_seg=False))
    cfg = dataclasses.replace(CFG, pipeline=dataclasses.replace(
        CFG.pipeline, pad_short_to_seg=False))
    wav = _wav(cfg.pipeline.seg_length + 500, 9)
    ref = jax_restore.VoiceFixer(params=ja, vocoder_params=jv,
                                 config=jcfg).restore_inmem(wav, mode=0)
    got = restore.VoiceFixer(pa, pv, config=cfg,
                             device="cpu").restore_inmem(wav, mode=0)
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


def test_restore_inmem_sharded_vocoder(params):
    """``model_devices`` with two entries routes the vocoder through
    ``parallel.sp``; the result is the default path's (and so the JAX
    package's) within the pipeline's tolerance."""
    _, _, pa, pv = params
    wav = _wav(int(CFG.pipeline.seg_length * 1.5), 8)
    ref = restore.VoiceFixer(pa, pv, config=CFG, device="cpu").restore_inmem(wav)
    vf = restore.VoiceFixer(pa, pv, config=CFG, device="cpu",
                            model_devices=("cpu",) * 2)
    assert vf.model_devices == (torch.device("cpu"),) * 2
    assert isinstance(vf.vocoder_params, list) and len(vf.vocoder_params) == 2
    got = vf.restore_inmem(wav)
    assert got.shape == wav.shape
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_restore_batch_routes_to_synthesize_sp(params, monkeypatch):
    from voicefixer_tpu_torch.parallel import sp
    _, _, pa, pv = params
    calls = []
    real = sp.synthesize_sp
    monkeypatch.setattr(sp, "synthesize_sp", lambda *a: (calls.append(a[3]),
                                                         real(*a))[1])
    wav = torch.from_numpy(_wav(CFG.pipeline.seg_length, 9)[None])
    restore.restore_batch(fold_bn_eval(pa), pv, wav, CFG)
    restore.restore_batch(fold_bn_eval(pa), pv, wav, CFG,
                          model_devices=("cpu",))
    assert calls == []          # one model device: the unsharded vocoder
    restore.restore_batch(fold_bn_eval(pa), pv, wav, CFG,
                          model_devices=("cpu",) * 4)
    assert calls == [("cpu",) * 4]


def test_model_devices_cuda_without_card_raises(params, monkeypatch):
    _, _, pa, pv = params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        restore.VoiceFixer(pa, pv, config=CFG, device="cpu",
                           model_devices=("cuda:0",) * 4)


def test_conv_block_kernel_opt_in(params, monkeypatch):
    """The fused ConvBlockRes is off by default and leaves the default
    path's output as it was; opted in (the constructor's argument or the
    context manager), every eligible block goes through
    ``kernels.convblock.conv_block_res`` and the output agrees."""
    from voicefixer_tpu_torch.kernels import convblock
    from voicefixer_tpu_torch.ops.precision import (conv_block_kernel,
                                                    use_conv_block_kernel)
    _, _, pa, pv = params
    calls = []
    real = convblock.conv_block_res
    monkeypatch.setattr(convblock, "conv_block_res",
                        lambda x, p, slope: (calls.append(tuple(x.shape)),
                                             real(x, p, slope))[1])
    wav = _wav(CFG.pipeline.seg_length, 10)
    assert not use_conv_block_kernel()
    ref = restore.VoiceFixer(pa, pv, config=CFG, device="cpu").restore_inmem(wav)
    assert calls == []
    got = restore.VoiceFixer(pa, pv, config=CFG, device="cpu",
                             conv_block_kernel=True).restore_inmem(wav)
    # tiny config: enc1, enc2, center, dec1, dec2, after1, one block each
    assert len(calls) == 6 and not use_conv_block_kernel()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    with conv_block_kernel():
        got = restore.VoiceFixer(pa, pv, config=CFG,
                                 device="cpu").restore_inmem(wav)
    assert len(calls) == 12
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
