"""Polyphase quadrature mirror filterbank (PQMF), as
``voicefixer_tpu/ops/pqmf.py``: a cosine-modulated Kaiser-windowed lowpass
prototype designed analytically, applied as strided convolutions.

    h_k[n] = 2 h(n) cos((2k+1) pi/(2N) (n - (L-1)/2) + (-1)^k pi/4)  analysis
    g_k[n] = 2 h(n) cos((2k+1) pi/(2N) (n - (L-1)/2) - (-1)^k pi/4)  synthesis

Layouts are the JAX package's: [B, T, 1] -> [B, T/S, S] and back. Analysis
is one ``F.conv1d`` with stride S; synthesis is one ``F.conv_transpose1d``
with stride S, which computes the JAX package's zero-stuffed upsample
followed by a convolution without materialising the zeros.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal import firwin


@functools.lru_cache(maxsize=8)
def design_pqmf_filters(bands: int = 4, taps: int = 62,
                        cutoff_ratio: float | None = None,
                        beta: float = 9.0):
    """(analysis [bands, L], synthesis [bands, L]) float32 filter banks,
    L = taps + 1. The default cutoffs maximise the reconstruction SNR of
    the Kaiser(beta=9) 63-tap prototype."""
    if cutoff_ratio is None:
        cutoff_ratio = {2: 0.265, 4: 0.142, 8: 0.0788}.get(
            bands, 0.5 / bands * 1.14)
    h = firwin(taps + 1, cutoff_ratio, window=("kaiser", beta))
    L = taps + 1
    n = np.arange(L)
    h_ana = np.zeros((bands, L))
    h_syn = np.zeros((bands, L))
    for k in range(bands):
        arg = (2 * k + 1) * np.pi / (2 * bands) * (n - (L - 1) / 2)
        phi = (-1) ** k * np.pi / 4
        h_ana[k] = 2 * h * np.cos(arg + phi)
        h_syn[k] = 2 * h * np.cos(arg - phi)
    return h_ana.astype(np.float32), h_syn.astype(np.float32)


def analysis(x: torch.Tensor, bands: int = 4, taps: int = 62) -> torch.Tensor:
    """[B, T, 1] -> [B, T/bands, bands]: a convolution with the analysis
    bank, stride ``bands``, zero padding L//2 on both sides."""
    h_ana, _ = design_pqmf_filters(bands, taps)
    L = h_ana.shape[1]
    w = torch.as_tensor(h_ana, dtype=x.dtype, device=x.device)[:, None]
    y = F.conv1d(x.transpose(1, 2), w, stride=bands, padding=L // 2)
    return y.transpose(1, 2)


def synthesis(subbands: torch.Tensor, bands: int = 4,
              taps: int = 62) -> torch.Tensor:
    """[B, T/bands, bands] -> [B, T, 1]: each band upsampled by ``bands``
    (zero-stuffed, scaled by ``bands``) and filtered with its synthesis
    filter, zero padding (L-1)//2, summed over bands.

    As a transposed convolution: out[n] = sum_k sum_m sub[m, k] w_k[n + p -
    m S], against the JAX package's sum_k sum_m S sub[m, k] g_k[m S - n +
    (L-1)/2]; so w_k is g_k reversed and scaled by S (a power of two: the
    same float32 products), p = (L-1)/2, and output_padding S - 1 makes
    the length (t-1) S - 2p + L + S - 1 = t S."""
    _, h_syn = design_pqmf_filters(bands, taps)
    L = h_syn.shape[1]
    w = torch.as_tensor(np.ascontiguousarray(h_syn[:, ::-1]) * bands,
                        dtype=subbands.dtype, device=subbands.device)
    y = F.conv_transpose1d(subbands.transpose(1, 2), w[:, None],
                           stride=bands, padding=(L - 1) // 2,
                           output_padding=bands - 1)
    return y.transpose(1, 2)
