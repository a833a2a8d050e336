"""Mel-spectrogram debug plots, as ``voicefixer_tpu/utils/plotting.py``
(upstream ``restorer/model.py``'s ``draw_and_save`` and ``clip``): log10
scale, shared colour limits, matplotlib's 'magma' map on a plain imshow.
Arrays or tensors on any device; matplotlib is imported only when a plot
is drawn.
"""

from __future__ import annotations

import numpy as np
import torch

EPS = 1e-8


def _numpy(m) -> np.ndarray:
    if isinstance(m, torch.Tensor):
        m = m.detach().cpu()
    return np.asarray(m)


def clip(*mels) -> tuple:
    """Shared (vmax, vmin) colour limits over several mels."""
    arrs = [_numpy(m) for m in mels]
    return (max(float(a.max()) for a in arrs),
            min(float(a.min()) for a in arrs))


def draw_and_save(mel, path: str, clip_max=None, clip_min=None,
                  needlog: bool = True, sr: int = 44100) -> None:
    """Draw a mel spectrogram into an image file.

    mel: [T, M] or any array or tensor whose last two axes are (frames, mel
    bins); element 0 of each leading axis is drawn. ``needlog`` draws
    log10(mel + EPS) and asserts a non-negative input. clip_max, clip_min:
    colour limits, the data's range by default."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    m = _numpy(mel).astype(np.float32)
    while m.ndim > 2:
        m = m[0]
    if clip_min is None:
        clip_max, clip_min = clip(m)
    if needlog:
        assert np.sum(m < 0) == 0, f"{np.sum(m < 0)}-{path}"
        m_log = np.log10(m + EPS)
    else:
        m_log = m

    fig, ax = plt.subplots(figsize=(15, 5))
    im = ax.imshow(m_log.T, origin="lower", aspect="auto", cmap="magma",
                   vmax=clip_max, vmin=clip_min)
    ax.set_xlabel("frames")
    ax.set_ylabel("mel bin")
    fig.colorbar(im, ax=ax)
    fig.savefig(path)
    plt.close(fig)
