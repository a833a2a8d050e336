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
from voicefixer_tpu_torch.pipeline import plan, restore
from voicefixer_tpu_torch.utils.weights import from_jax_params
from tests.test_torch_weights import (jax_param_trees,  # noqa: F401
                                      one_torch_thread)

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


@pytest.mark.parametrize("est_len,ref_len", [(10, 10), (14, 10), (15, 10),
                                             (7, 10), (11, 10)])
def test_trim_center_matches_jax(est_len, ref_len):
    est = np.arange(est_len, dtype=np.float32)
    np.testing.assert_array_equal(plan.trim_center(est, ref_len),
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


# ------------------------------------------------ mode 1 and overlap-add


def _jax_cutoff(wav, jcfg):
    """The cutoff bin of the JAX package's ``remove_higher_frequency``, its
    lines on its own STFT (the function returns only the waveform)."""
    from voicefixer_tpu.ops import stft as jstft
    scfg = dataclasses.replace(jcfg.stft, hop_length=jcfg.stft.n_fft // 4,
                               pad_mode="constant")
    real, imag = jstft.stft_real_imag(jnp.asarray(wav)[None], scfg)
    mag = jnp.sqrt(real * real + imag * imag)
    feature = jnp.log10(mag + jax_restore.EPS)
    energy = jnp.sum(jnp.where(feature < 0, 0.0, feature), axis=(0, 1))
    cum = jnp.cumsum(energy)
    return int(jnp.argmax(cum >= jnp.sum(energy)
                          * jcfg.pipeline.hf_removal_ratio))


@pytest.mark.parametrize("n,seed", [(44100, 11), (30001, 12), (700, 13)])
def test_remove_higher_frequency_matches_jax(n, seed):
    """Mode 1's preprocessing: the same cutoff bin, samples within 1e-5, the
    shorter ISTFT length kept (hop * (T - 1); 0 samples for a segment
    shorter than one hop)."""
    wav = _wav(n, seed)
    ref = np.asarray(jax.jit(functools.partial(
        jax_restore.remove_higher_frequency, cfg=JCFG))(jnp.asarray(wav)))
    got, cutoff = restore.remove_higher_frequency(
        torch.from_numpy(wav), CFG, return_cutoff=True)
    assert cutoff == _jax_cutoff(wav, JCFG)
    assert got.shape == ref.shape == (512 * (n // 512),)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("a_len,n", [(10, 10), (14, 10), (15, 10), (7, 10),
                                     (0, 4)])
def test_fit_length_matches_jax(a_len, n):
    a = np.arange(2 * a_len, dtype=np.float32).reshape(2, a_len)
    np.testing.assert_array_equal(plan.fit_length(a, n),
                                  jax_restore._fit_length(a, n))


@pytest.mark.parametrize("total,seg,ramp", [(2500, 1000, 100),
                                            (1000, 1000, 0),
                                            (1900, 1000, 500)])
def test_overlap_add_matches_jax(total, seg, ramp):
    """The windows of ``_restore_overlap`` (a last one flush with the end),
    random chunks, crossfaded the same way; a constant signal comes back
    exactly."""
    rng = np.random.default_rng(total)
    stride = seg - ramp
    positions = list(range(0, max(total - seg, 0) + 1, stride))
    if positions[-1] + seg < total:
        positions.append(total - seg)
    chunks = [rng.standard_normal(seg).astype(np.float32) for _ in positions]
    got = restore.overlap_add(chunks, positions, total, ramp)
    np.testing.assert_array_equal(
        got, jax_restore.overlap_add(chunks, positions, total, ramp))
    ones = [np.ones(seg, np.float32)] * len(positions)
    np.testing.assert_array_equal(
        restore.overlap_add(ones, positions, total, ramp),
        np.ones(total, np.float32))


@pytest.mark.parametrize("kwargs", [{"chunk_overlap_seconds": 1.0},
                                    {"mode": 1},
                                    {"mode": 1, "chunk_overlap_seconds": 0.25}])
def test_restore_inmem_overlap_and_mode1(params, kwargs):
    """2.5 segments through the overlap path (1 s asks for more than half a
    segment: the ramp is capped at half, four windows in one batch), mode 1
    on hard seams (three shortened segments, the last padded), and mode 1
    under overlap (each window refitted to a full segment), against the JAX
    package on the same parameters."""
    ja, jv, pa, pv = params
    wav = _wav(int(CFG.pipeline.seg_length * 2.5), 14)
    ref = jax_restore.VoiceFixer(params=ja, vocoder_params=jv,
                                 config=JCFG).restore_inmem(wav, **kwargs)
    got = restore.VoiceFixer(pa, pv, config=CFG,
                             device="cpu").restore_inmem(wav, **kwargs)
    assert got.shape == ref.shape
    if kwargs.get("mode") == 1 and "chunk_overlap_seconds" not in kwargs:
        assert got.shape == (2 * 512 * (CFG.pipeline.seg_length // 512)
                             + 512 * (CFG.pipeline.seg_length // 2 // 512),)
    else:
        assert got.shape == wav.shape
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_overlap_needs_more_than_one_segment(params, monkeypatch):
    """One segment or less: the hard-seam path, whatever the overlap."""
    _, _, pa, pv = params
    vf = restore.VoiceFixer(pa, pv, config=CFG, device="cpu")
    monkeypatch.setattr(vf, "_restore_overlap", lambda *a: pytest.fail(
        "overlap path taken"))
    wav = _wav(CFG.pipeline.seg_length, 15)
    np.testing.assert_array_equal(
        vf.restore_inmem(wav, chunk_overlap_seconds=1.0), vf.restore_inmem(wav))


def test_restore_file_matches_jax(params, tmp_path):
    """``restore``, file to file: a 22.05 kHz stereo int16 WAV in, mixed to
    mono and resampled, restored, written as int16 WAV and as FLAC; the
    port's files and the JAX package's agree within one LSB."""
    from scipy.io import wavfile
    ja, jv, pa, pv = params
    src = str(tmp_path / "in.wav")
    stereo = (np.random.default_rng(16).standard_normal((33075, 2)) * 3000
              ).astype(np.int16)
    wavfile.write(src, 22050, stereo)
    jvf = jax_restore.VoiceFixer(params=ja, vocoder_params=jv, config=JCFG)
    vf = restore.VoiceFixer(pa, pv, config=CFG, device="cpu")
    for ext in ("wav", "flac"):
        jvf.restore(src, str(tmp_path / f"jax.{ext}"))
        vf.restore(src, str(tmp_path / f"port.{ext}"))
    from voicefixer_tpu_torch.utils import audio_io
    outs = {k: audio_io.read_audio(str(tmp_path / k))
            for k in ("jax.wav", "port.wav", "jax.flac", "port.flac")}
    for k, (sr, d) in outs.items():
        assert sr == 44100 and d.shape == (66150, 1), k
    np.testing.assert_array_equal(outs["port.wav"][1], outs["port.flac"][1])
    assert np.abs(outs["port.wav"][1] - outs["jax.wav"][1]).max() <= 1 / 32768


# ------------------------------------------------ mode 2 and the vocoder hook

def _no_dropout(cfg):
    """Mode 2 with dropout off: torch cannot draw the JAX package's PRNG
    streams, so the two packages meet on batch statistics alone."""
    return dataclasses.replace(cfg, denoiser=dataclasses.replace(
        cfg.denoiser, dropout=0.0))


@pytest.mark.parametrize("segments", [2.5, 1.0])
def test_restore_inmem_mode2_matches_jax(params, segments):
    """Mode 2 (batch-statistics BN, dropout 0) segment by segment against
    the JAX package: 2.5 segments (the tail runs unpadded at half a
    segment, with its own statistics) and one segment plus 700 samples."""
    ja, jv, pa, pv = params
    n = int(CFG.pipeline.seg_length * segments) + (700 if segments == 1.0
                                                   else 0)
    wav = _wav(n, 17)
    ref = jax_restore.VoiceFixer(params=ja, vocoder_params=jv,
                                 config=_no_dropout(JCFG)).restore_inmem(
        wav, mode=2, seed=3)
    got = restore.VoiceFixer(pa, pv, config=_no_dropout(CFG),
                             device="cpu").restore_inmem(wav, mode=2, seed=3)
    assert got.shape == ref.shape == wav.shape
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    eval_out = restore.VoiceFixer(pa, pv, config=CFG,
                                  device="cpu").restore_inmem(wav)
    assert not np.allclose(got, eval_out, atol=1e-3)  # statistics differ


def test_mode2_deterministic_given_seed(params):
    """Dropout at the config's rate: one seed gives one output, another
    seed another (the JAX package's test of its mode 2)."""
    _, _, pa, pv = params
    vf = restore.VoiceFixer(pa, pv, config=CFG, device="cpu")
    wav = _wav(11025, 18)
    a = vf.restore_inmem(wav, mode=2, seed=7)
    b = vf.restore_inmem(wav, mode=2, seed=7)
    c = vf.restore_inmem(wav, mode=2, seed=8)
    assert a.shape == wav.shape and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a, c)


def _hook_wave(mel):
    """A stand-in vocoder: each frame's mean mel value held for one hop,
    [1, 1, T * 441]; from a torch tensor a tensor, else an array."""
    if isinstance(mel, torch.Tensor):
        return mel[0, 0].mean(-1).repeat_interleave(441)[None, None]
    m = np.asarray(mel)
    return np.repeat(m[0, 0].mean(-1), 441)[None, None]


@pytest.mark.parametrize("mode", [0, 2])
def test_custom_vocoder_func_matches_jax(params, mode):
    """``your_vocoder_func`` sees each segment's denoised linear mel
    [1, 1, T, 128] (a tensor on the instance's device) and its output,
    here a tensor, replaces the vocoder's; the mels and the stitched
    output agree with the JAX package's (mode 2 at dropout 0). The mels
    are held on the log10 scale the analysis stage computes them on (the
    hook's linear mel is 10 to that power, up to ~1e4 here)."""
    ja, jv, pa, pv = params
    wav = _wav(int(CFG.pipeline.seg_length * 1.5), 19)
    seen = {"jax": [], "port": []}

    def hook(side):
        def fn(mel):
            seen[side].append(mel)
            return _hook_wave(mel)
        return fn

    ref = jax_restore.VoiceFixer(
        params=ja, vocoder_params=jv, config=_no_dropout(JCFG)).restore_inmem(
        wav, mode=mode, your_vocoder_func=hook("jax"))
    got = restore.VoiceFixer(pa, pv, config=_no_dropout(CFG),
                             device="cpu").restore_inmem(
        wav, mode=mode, your_vocoder_func=hook("port"))
    assert len(seen["port"]) == len(seen["jax"]) == 2
    for m_port, m_jax in zip(seen["port"], seen["jax"]):
        assert isinstance(m_port, torch.Tensor)
        assert m_port.device.type == "cpu"
        assert m_port.shape == m_jax.shape
        assert m_port.shape[:2] == (1, 1) and m_port.shape[3] == 128
        np.testing.assert_allclose(np.log10(m_port.numpy()),
                                   np.log10(np.asarray(m_jax)),
                                   rtol=TOL, atol=TOL)
    assert got.shape == ref.shape == wav.shape
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_custom_vocoder_func_array_output(params):
    """A hook that returns a numpy array (the JAX package's own test): all
    zeros, the input's length."""
    _, _, pa, pv = params
    vf = restore.VoiceFixer(pa, pv, config=CFG, device="cpu")
    wav = _wav(11025, 20)
    out = vf.restore_inmem(wav, your_vocoder_func=lambda mel: np.zeros(
        (1, 1, int(mel.shape[2]) * 441), dtype=np.float32))
    assert out.shape == wav.shape and np.all(out == 0)


def test_mode2_bypasses_the_conv_block_kernel(params, monkeypatch):
    """Under ``conv_block_kernel=True`` mode 2 sends no block to the fused
    kernel (it folds eval BN), and the packed tree keeps the unfolded BN
    leaves that mode 2 reads: the output is the default instance's."""
    from voicefixer_tpu_torch.kernels import convblock
    _, _, pa, pv = params
    calls = []
    monkeypatch.setattr(convblock, "conv_block_res",
                        lambda *a: calls.append(1))
    cb = restore.VoiceFixer(pa, pv, config=CFG, device="cpu",
                            conv_block_kernel=True)
    assert {"gamma", "beta", "scale", "packed"} <= (
        set(cb.params["unet"]["enc1"]["block1"]["bn1"])
        | set(cb.params["unet"]["enc1"]["block1"]))
    wav = _wav(CFG.pipeline.seg_length, 21)
    got = cb.restore_inmem(wav, mode=2, seed=1)
    assert calls == []
    ref = restore.VoiceFixer(pa, pv, config=CFG, device="cpu").restore_inmem(
        wav, mode=2, seed=1)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_restore_file_mode2(params, tmp_path):
    """``restore(mode=2)``, file to file, is ``restore_inmem(mode=2)`` of
    the file's samples, written as int16."""
    from voicefixer_tpu_torch.utils import audio_io
    _, _, pa, pv = params
    vf = restore.VoiceFixer(pa, pv, config=CFG, device="cpu")
    src, dst = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    audio_io.save_wave(_wav(30000, 22), src, 44100)
    vf.restore(src, dst, mode=2, seed=5)
    want = vf.restore_inmem(audio_io.load_wav(src, 44100), mode=2, seed=5)
    sr, data = audio_io.read_audio(dst)
    assert sr == 44100 and data.shape == (30000, 1)
    np.testing.assert_array_equal(
        np.round(data[:, 0] * 32768).astype(np.int32),
        (want * 2 ** 15).astype(np.int16).astype(np.int32))


# ------------------------------------------ weight trees cast once an instance


def _spy_casts(monkeypatch) -> list:
    """Every ``cast_tree`` call, the instances' and the per-call ones."""
    from voicefixer_tpu_torch.pipeline import vocoder_facade
    from voicefixer_tpu_torch.utils import weights
    calls = []
    real = weights.cast_tree

    def counted(tree, dtype):
        calls.append(dtype)
        return real(tree, dtype)
    for mod in (weights, restore, vocoder_facade):
        monkeypatch.setattr(mod, "cast_tree", counted)
    return calls


def _per_call_cast(vf, wav, mode=0, seed=0):
    """``restore_inmem`` of one full segment, through ``restore_batch`` on
    the instance's float32 trees, which it casts on the call."""
    from voicefixer_tpu_torch.ops.precision import conv_block_kernel
    gen = torch.Generator().manual_seed(seed) if mode == 2 else None
    with conv_block_kernel(vf.conv_block_kernel):
        out, _ = restore.restore_batch(
            vf.params, vf.vocoder_params, torch.from_numpy(wav[None]), CFG,
            model_devices=vf.model_devices, training=mode == 2,
            generator=gen)
    return plan.trim_center(out[0].numpy(), wav.shape[0])


def _float32(tree) -> bool:
    """Every leaf float32, the fused kernel's operands ("packed") aside."""
    if isinstance(tree, dict):
        return all(_float32(v) for k, v in tree.items() if k != "packed")
    if isinstance(tree, (list, tuple)):
        return all(_float32(v) for v in tree)
    return tree.dtype == torch.float32


@pytest.mark.parametrize("kwargs", [{}, {"model_devices": ("cpu", "cpu")},
                                    {"conv_block_kernel": True}])
def test_weights_cast_once_an_instance(params, monkeypatch, kwargs):
    """In production an instance casts its ResUNet and vocoder trees on its
    first call and serves later calls from them, bitwise the output of the
    per-call cast; a parity call casts and caches nothing; a reassigned
    tree is cast once more; mode 2 takes the float32 analysis tree and the
    cast vocoder; the stored trees stay float32."""
    from voicefixer_tpu_torch.ops.precision import precision
    _, _, pa, pv = params
    wav = _wav(CFG.pipeline.seg_length, 23)
    with precision("production"):
        vf = restore.VoiceFixer(pa, pv, config=CFG, device="cpu", **kwargs)
        casts = vf.weight_casts
        want = _per_call_cast(vf, wav)
        spied = _spy_casts(monkeypatch)
        for _ in range(3):
            np.testing.assert_array_equal(vf.restore_inmem(wav), want)
        assert (casts.misses, casts.hits) == (1, 2)
        # the ResUNet's tree and the vocoder's (a shared copy cast once)
        assert spied == [torch.bfloat16] * 2
        (_, (unet, voc)), = casts._entries.values()
        assert unet["unet"]["after2"]["w"].dtype == torch.bfloat16
        assert unet["denoiser"] is vf.params["denoiser"]
        if "model_devices" in kwargs:
            assert len(voc) == 2 and voc[0] is voc[1]
            assert voc[0]["post"]["w"].dtype == torch.bfloat16
        if "conv_block_kernel" in kwargs:
            block = vf.params["unet"]["enc1"]["block1"]
            assert unet["unet"]["enc1"]["block1"]["packed"] is block["packed"]
    with precision("parity"):
        vf.restore_inmem(wav)
    assert len(spied) == 2 and len(casts._entries) == 1
    assert (casts.misses, casts.hits) == (1, 2)
    with precision("production"):
        np.testing.assert_array_equal(vf.restore_inmem(wav), want)
        assert (casts.misses, casts.hits) == (1, 3)
        got = vf.restore_inmem(wav, mode=2, seed=4)
        assert (casts.misses, casts.hits) == (1, 4)
        np.testing.assert_array_equal(got, _per_call_cast(vf, wav, 2, 4))
        vf.params = dict(vf.params)
        for _ in range(2):
            np.testing.assert_array_equal(vf.restore_inmem(wav), want)
        assert (casts.misses, casts.hits) == (2, 5)
    assert _float32(vf.params) and _float32(vf.vocoder_params)


def test_vocoder_facade_casts_once(params, monkeypatch):
    """The ``Vocoder`` facade holds its tree as ``VoiceFixer`` does: cast
    once in production, bitwise the per-call cast's output, nothing cast
    in parity, again after ``params`` is reassigned."""
    from voicefixer_tpu_torch.ops.precision import precision
    from voicefixer_tpu_torch.pipeline import vocoder_facade
    _, _, _, pv = params
    voc = vocoder_facade.Vocoder(params=pv, config=CFG, device="cpu")
    casts = voc.weight_casts
    mel = np.abs(np.random.default_rng(24).standard_normal(
        (1, 1, 23, 128))).astype(np.float32)
    with precision("production"):
        want = vocoder_facade.synthesize(
            voc.params, torch.from_numpy(mel[:, 0]), CFG.vocoder)
        want = want[..., 0].numpy()[:, None]
        spied = _spy_casts(monkeypatch)
        for _ in range(2):
            np.testing.assert_array_equal(voc.forward(mel), want)
        assert (casts.misses, casts.hits, len(spied)) == (1, 1, 1)
    with precision("parity"):
        voc.forward(mel)
    assert (casts.misses, casts.hits, len(spied)) == (1, 1, 1)
    with precision("production"):
        voc.params = dict(voc.params)
        np.testing.assert_array_equal(voc.forward(mel), want)
        assert (casts.misses, casts.hits, len(spied)) == (2, 1, 2)
    assert _float32(voc.params)
