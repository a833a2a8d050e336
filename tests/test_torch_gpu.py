"""The port's CUDA kernels on the card against their plain versions at small
and ragged shapes (partial tiles, widths that are not multiples of the
block, batch > 1). chip_smoke.py holds the tiny-config pipeline on the card
against the CPU. Needs a CUDA card and nvcc, and skips elsewhere. It
imports no JAX, so on a machine without JAX run it without the suite's
conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances: float32 results against the plain float32 version summed in
another order; bfloat16 outputs may differ by one bfloat16 ulp (2^-8
relative) where the two float32 sums straddle a rounding boundary.
"""

import pytest
import torch

from voicefixer_tpu_torch import kernels
from voicefixer_tpu_torch.kernels.gru import gru_bidir, gru_bidir_reference
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


def test_upsample_bfloat16_refuses_ragged_channels(cuda):
    x = torch.zeros((1, 8, 20), device=cuda, dtype=torch.bfloat16)
    w = torch.zeros((6, 20, 16), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        upsample(x, w, torch.zeros(16, device=cuda, dtype=torch.bfloat16), 3)


@pytest.mark.parametrize("hidden,t,b,mm", [(128, 7, 2, "float32"),
                                           (100, 50, 3, "float32"),
                                           (100, 50, 3, "bfloat16")])
def test_gru_bidir_kernel(cuda, hidden, t, b, mm):
    gen = torch.Generator().manual_seed(1)
    g = 3 * hidden
    xf, xb = (_randn(gen, (b, t, g)).to(cuda) for _ in range(2))
    wf, wb = (_randn(gen, (hidden, g), 0.1).to(cuda) for _ in range(2))
    bf, bb = (_randn(gen, (g,), 0.1).to(cuda) for _ in range(2))
    dt = getattr(torch, mm)
    got = gru_bidir(xf, xb, wf, wb, bf, bb, dt)
    ref = gru_bidir_reference(xf, xb, wf, wb, bf, bb, dt)
    tol = 1e-5 if mm == "float32" else 2e-3
    for g_, r_ in zip(got, ref):
        torch.testing.assert_close(g_, r_, rtol=tol, atol=tol)


@pytest.mark.parametrize("n,b", [(20000, 2), (4410, 1)])
def test_stft_mel_kernel(cuda, n, b):
    from voicefixer_tpu_torch.config import DEFAULT_CONFIG
    from voicefixer_tpu_torch.models.analysis import mel_fbank
    gen = torch.Generator().manual_seed(2)
    wav = _randn(gen, (b, n), 0.3).to(cuda)
    fb = mel_fbank(DEFAULT_CONFIG, cuda)
    got = stft_mel(wav, fb, DEFAULT_CONFIG.stft)
    ref = stft_mel_reference(wav, fb, DEFAULT_CONFIG.stft)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)

