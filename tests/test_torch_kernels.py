"""The port's kernels, through their plain PyTorch versions (the wrappers take
them for CPU tensors), against the JAX package's Pallas kernels in interpret
mode, on the same numpy-seeded inputs.

Tolerances are the JAX kernel tests' own (tests/test_kernels.py): 1e-5 for
the float32 GRU recurrence, 2e-5 for the upsample, 1e-4 relative for the
STFT->mel (a 2048-tap float32 DFT summed in another order). The bfloat16 GRU
case allows 2e-3: h is rounded to bfloat16 before each product, and a last-
bit difference in the float32 state can flip one rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicefixer_tpu_torch.kernels.gru import gru_bidir
from voicefixer_tpu_torch.kernels.stft import stft_mel
from voicefixer_tpu_torch.kernels.upsample import upsample


def _rand(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("t,mm,tol", [(7, "float32", 1e-5),
                                      (300, "float32", 1e-5),
                                      (300, "bfloat16", 2e-3)])
def test_gru_bidir_matches_pallas(t, mm, tol):
    from voicefixer_tpu.kernels.gru import gru_seq_bidir

    b, h = 2, 128
    rng = np.random.default_rng(0)
    xf, xb = _rand(rng, (b, t, 3 * h)), _rand(rng, (b, t, 3 * h))
    wf, wb = _rand(rng, (h, 3 * h), 0.1), _rand(rng, (h, 3 * h), 0.1)
    bf, bb = _rand(rng, (3 * h,), 0.1), _rand(rng, (3 * h,), 0.1)

    ref_f, ref_b = gru_seq_bidir(*map(jnp.asarray, (xf, xb, wf, wb, bf, bb)),
                                 matmul_dtype=getattr(jnp, mm),
                                 interpret=True)
    got_f, got_b = gru_bidir(*map(torch.from_numpy, (xf, xb, wf, wb, bf, bb)),
                             matmul_dtype=getattr(torch, mm))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(ref_f),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(ref_b),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("scale,cin,cout", [(7, 64, 32), (3, 128, 64)])
def test_upsample_matches_pallas(scale, cin, cout):
    from voicefixer_tpu.kernels.upsample import upsample as jax_upsample

    t = 100
    rng = np.random.default_rng(1)
    w = _rand(rng, (2 * scale, cin, cout), 0.05)
    b = _rand(rng, (cout,), 0.05)
    x = _rand(rng, (2, t, cin))

    ref = jax_upsample(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), scale,
                       t_tile=256, interpret=True)
    got = upsample(torch.from_numpy(x), torch.from_numpy(w),
                   torch.from_numpy(b), scale)
    assert got.shape == ref.shape == (2, t * scale, cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


def test_stft_mel_matches_pallas():
    from voicefixer_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
    from voicefixer_tpu.kernels.stft import stft_mel as jax_stft_mel
    from voicefixer_tpu.ops import mel as jax_mel

    from voicefixer_tpu_torch.config import DEFAULT_CONFIG
    from voicefixer_tpu_torch.models.analysis import mel_fbank

    wav = _rand(np.random.default_rng(2), (2, 20000), 0.3)
    m = JAX_CONFIG.mel
    fb = jax_mel.melscale_fbanks(m.n_stft, m.f_min, m.f_max, m.n_mels,
                                 m.sample_rate, norm=None)
    ref = jax_stft_mel(jnp.asarray(wav), jnp.asarray(fb), JAX_CONFIG.stft,
                       t_tile=128, interpret=True)
    port_fb = mel_fbank(DEFAULT_CONFIG, "cpu")
    np.testing.assert_array_equal(port_fb.numpy(), fb)
    got = stft_mel(torch.from_numpy(wav), port_fb, DEFAULT_CONFIG.stft)
    assert got.shape == ref.shape == (2, 20000 // 441 + 1, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)


def test_wrappers_refuse_mixed_devices():
    """A wrapper takes its plain version only when every tensor lies on the
    CPU; tensors on other devices are refused, never rerouted."""
    x = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError):
        upsample(x, torch.zeros(6, 8, 4, device="meta"), torch.zeros(4), 3)
