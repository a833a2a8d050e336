"""Mel filterbank of the analysis stage: torchaudio-style fbanks, htk scale,
norm=None, applied as ``sp [.., T, F] @ fb [F, n_mels]``. An own numpy copy
of ``melscale_fbanks`` in ``voicefixer_tpu/ops/mel.py``.
"""

from __future__ import annotations

import functools

import numpy as np


def _hz_to_mel_htk(freq):
    return 2595.0 * np.log10(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(mels):
    return 700.0 * (10.0 ** (np.asarray(mels, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def melscale_fbanks(n_freqs: int = 1025, f_min: float = 0.0,
                    f_max: float = 22050.0, n_mels: int = 128,
                    sample_rate: int = 44100) -> np.ndarray:
    """Triangular mel filterbank [n_freqs, n_mels], htk scale, norm=None.
    The cached array is shared: callers copy it before writing."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max),
                        n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down_slopes = -slopes[:, :-2] / f_diff[:-1]
    up_slopes = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))
    return fb.astype(np.float32)
