"""Synthesis stage: analysis-convention linear mel -> 44.1 kHz waveform, as
``voicefixer_tpu/pipeline/vocoder_facade.py`` (upstream Vocoder.forward and
Vocoder.oracle); and ``BigVGAN``, a second vocoder beside it: BigVGAN-v2's
log-mel -> 44.1 kHz waveform (``models/bigvgan.py``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from voicefixer_tpu_torch import kernels
from voicefixer_tpu_torch.config import (DEFAULT_CONFIG, BigVGANConfig,
                                         VocoderConfig, VoiceFixerConfig,
                                         mel_weight_curve)
from voicefixer_tpu_torch.models import bigvgan as bigvgan_model
from voicefixer_tpu_torch.models import vocoder as vocoder_model
from voicefixer_tpu_torch.ops import mel as vmel
from voicefixer_tpu_torch.ops import stft as vstft
from voicefixer_tpu_torch.ops.norm import vocoder_normalize_mel
from voicefixer_tpu_torch.ops.precision import activation_dtype, tf32_off
from voicefixer_tpu_torch.utils.profiling import annotate
from voicefixer_tpu_torch.utils.weights import CastCache, cast_tree, tree_map


def pad_tail(mel: torch.Tensor, pad_value: float) -> torch.Tensor:
    """Append T%2 + 4 frames of ``pad_value`` along time ([B, T, C])."""
    t = mel.shape[1]
    return F.pad(mel, (0, 0, 0, t % 2 + 4), value=pad_value)


def synthesize(params: dict, mel: torch.Tensor, cfg: VocoderConfig,
               divide_weight: bool = True) -> torch.Tensor:
    """mel [B, T, 128], linear, analysis convention -> wav [B, S, 1]. The
    mel-weight curve bridges it to the vocoder's librosa convention;
    ``divide_weight=False`` skips that for a mel already in it (the oracle
    path)."""
    if divide_weight:
        w = torch.as_tensor(mel_weight_curve(cfg.num_mels), dtype=mel.dtype,
                            device=mel.device)
        mel = mel / w
    mel = vocoder_normalize_mel(mel, cfg)
    mel = pad_tail(mel, -cfg.max_abs_value)
    return vocoder_model.apply(params, mel, cfg)


class Vocoder:
    """Synthesis API mirroring upstream ``Vocoder(sample_rate)``; 44100 Hz
    only, as upstream.

    ckpt: a vocoder checkpoint (npz or torch), resolved as
    ``pipeline.checkpoints.load_vocoder_params`` does; params: the port's
    vocoder tree instead. device: None means CUDA, and raises without a
    card; pass "cpu" for the plain versions.

    ``params`` stays float32; production precision casts it to bfloat16
    once an instance, as ``VoiceFixer`` does (``weight_casts``)."""

    def __init__(self, sample_rate: int = 44100, ckpt: str | None = None,
                 params: dict | None = None,
                 config: VoiceFixerConfig = DEFAULT_CONFIG,
                 download: bool = True, device=None):
        from voicefixer_tpu_torch.pipeline.restore import resolve_device
        from voicefixer_tpu_torch.utils.weights import convert_tree, tree_map
        if sample_rate != 44100:
            raise RuntimeError("Error: VoiceFixer only supports 44100 sample"
                               " rate at present, as upstream does.")
        self.rate = sample_rate
        self.config = config
        self.device = resolve_device(device)
        if params is None:
            from voicefixer_tpu_torch.pipeline import checkpoints
            params = convert_tree(
                checkpoints.load_vocoder_params(ckpt, download=download),
                "vocoder", self.device)
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.weight_casts = CastCache()

    @classmethod
    def random(cls, seed: int = 0, config: VoiceFixerConfig = DEFAULT_CONFIG,
               device=None) -> "Vocoder":
        """A randomly initialised vocoder, drawn from ``seed`` on the CPU."""
        from voicefixer_tpu_torch.pipeline.restore import resolve_device
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        return cls(params=vocoder_model.init(config.vocoder, gen, device),
                   config=config, device=device)

    def _synthesize(self, mel: torch.Tensor, divide_weight: bool):
        adt = activation_dtype()
        params = (self.params if adt == torch.float32 else
                  self.weight_casts.get(adt, (self.params,), cast_tree))
        with tf32_off(), torch.inference_mode(), \
                kernels.current_device(self.device):
            wav = synthesize(params, mel, self.config.vocoder,
                             divide_weight=divide_weight)
        return wav[..., 0].float().cpu().numpy()  # [B, S]

    def forward(self, mel, cuda: bool = False) -> np.ndarray:
        """mel: linear, analysis convention, [B, 1, T, 128] (upstream's
        layout) or [B, T, 128]. Returns wav [B, 1, S]. ``cuda`` is accepted
        for upstream's signature; the device is the instance's."""
        mel = torch.as_tensor(mel, dtype=torch.float32, device=self.device)
        if mel.ndim == 4:  # [B, 1, T, 128]
            mel = mel[:, 0]
        if mel.shape[-1] != self.config.vocoder.num_mels:
            raise ValueError(f"expected {self.config.vocoder.num_mels} mel "
                             f"bins, got {mel.shape[-1]}")
        return self._synthesize(mel, True)[:, None, :]

    __call__ = forward

    def oracle(self, fpath: str, out_path: str | None, cuda: bool = False,
               pad_mode: str = "constant") -> np.ndarray:
        """Copy synthesis: wav -> peak normalise -> |STFT| (n_fft 2048, hop
        441, centred) -> librosa's htk/slaney mel -> the generator, no
        mel-weight division. pad_mode is librosa.stft's centre pad:
        'constant' for librosa >= 0.10, 'reflect' for older releases.
        Returns [1, S]; writes it to ``out_path`` (times 2**15, int16)
        unless that is None."""
        from voicefixer_tpu_torch.utils import audio_io
        wav = audio_io.read_wave(fpath, sample_rate=self.rate)[..., 0]
        wav = wav / np.max(np.abs(wav))
        scfg = dataclasses.replace(self.config.stft, pad_mode=pad_mode)
        basis = torch.as_tensor(vmel.librosa_mel_basis(
            scfg.n_fft, self.config.vocoder.num_mels, self.rate),
            device=self.device)
        with tf32_off(), torch.inference_mode():
            x = torch.as_tensor(wav, device=self.device)[None]
            mel = vstft.spectrogram(x, scfg) @ basis.T  # [1, T, 128]
        out = self._synthesize(mel, False)
        if out_path is not None:
            audio_io.save_wave(out[0] * 2 ** 15, out_path,
                               sample_rate=self.rate)
        return out


class BigVGAN:
    """BigVGAN-v2's generator as a vocoder: log-mel (upstream's front end:
    the Slaney mel of a Hann STFT's magnitude, n_fft 2048, hop 512, its log
    clamped at 1e-5, as a TTS acoustic model predicts it) -> 44.1 kHz
    wave.

    params: the tree of ``models/bigvgan.py`` (tensors or numpy arrays;
    ``utils.weights.convert_bigvgan`` makes it from upstream's state dict).
    device: None means CUDA, and raises without a card; "cpu" runs the
    plain versions. The tree is kept in float32; production precision
    casts it to bfloat16 once an instance (``weight_casts``)."""

    def __init__(self, params: dict, config: BigVGANConfig = BigVGANConfig(),
                 device=None):
        from voicefixer_tpu_torch.pipeline.restore import resolve_device
        self.config = config
        self.device = resolve_device(device)
        self.params = tree_map(lambda t: torch.as_tensor(
            t, dtype=torch.float32).to(self.device), params)
        self.weight_casts = CastCache()

    @classmethod
    def random(cls, seed: int = 0, config: BigVGANConfig = BigVGANConfig(),
               device=None) -> "BigVGAN":
        """Upstream's initialisation (``models.bigvgan.init``), drawn from
        ``seed`` on the CPU."""
        from voicefixer_tpu_torch.pipeline.restore import resolve_device
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        return cls(bigvgan_model.init(config, gen, device), config, device)

    @annotate("vf.request")
    def synthesize(self, mel) -> np.ndarray:
        """mel: log-mel [T, num_mels] or [B, T, num_mels] (numpy or a
        tensor). Returns the wave [B, T * hop], float32 numpy."""
        mel = torch.as_tensor(mel, dtype=torch.float32)
        if mel.ndim == 2:
            mel = mel[None]
        if mel.ndim != 3 or mel.shape[-1] != self.config.num_mels:
            raise ValueError(f"expected a log-mel [B, T, "
                             f"{self.config.num_mels}], got "
                             f"{tuple(mel.shape)}")
        adt = activation_dtype()
        params = (self.params if adt == torch.float32 else
                  self.weight_casts.get(adt, (self.params,), cast_tree))
        with tf32_off(), torch.inference_mode(), \
                kernels.current_device(self.device):
            with annotate("vf.upload"):
                mel = mel.to(self.device)
            with annotate("vf.vocoder"):
                wav = bigvgan_model.apply(params, mel, self.config)
            with annotate("vf.download"):
                return wav.cpu().numpy()
