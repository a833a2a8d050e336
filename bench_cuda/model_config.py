"""A configuration file as an object with the program's attribute names.

The frozen FLOP count and the plain reference read a configuration
through attributes (``cfg.unet.encoder_channels``); this builds that
object from the JSON alone, with the derived sizes they use, so that the
yardstick needs nothing of the program.
"""

from __future__ import annotations

from types import SimpleNamespace

SECTIONS = ("stft", "mel", "denoiser", "unet", "vocoder", "pipeline")


def _ns(d: dict) -> SimpleNamespace:
    return SimpleNamespace(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in d.items()})


def namespace(cfg: dict) -> SimpleNamespace:
    """The sections of ``cfg`` as attributes, lists as tuples, plus the
    sizes the program's config derives and the yardstick reads:
    ``stft.n_freqs``, ``unet.downsample_ratio`` and
    ``pipeline.seg_length``."""
    ns = SimpleNamespace(**{s: _ns(cfg[s]) for s in SECTIONS})
    ns.precision = cfg["precision"]
    ns.stft.n_freqs = ns.stft.n_fft // 2 + 1
    ns.unet.downsample_ratio = 2 ** len(ns.unet.encoder_channels)
    ns.pipeline.seg_length = (ns.pipeline.sample_rate
                              * ns.pipeline.seg_length_seconds)
    return ns

