"""End-to-end restoration, mode 0: wav -> analysis -> vocoder -> wav, as
``voicefixer_tpu/pipeline/restore.py`` (upstream VoiceFixer.restore_inmem):
30 s segments, short and tail segments zero-padded to a full segment, equal
lengths batched, a per-chunk peak cap, and the upstream centre trim.
"""

from __future__ import annotations

import numpy as np
import torch

from voicefixer_tpu_torch.config import DEFAULT_CONFIG, VoiceFixerConfig
from voicefixer_tpu_torch.models import analysis
from voicefixer_tpu_torch.models import vocoder as vocoder_model
from voicefixer_tpu_torch.ops.conv import fold_bn_eval
from voicefixer_tpu_torch.ops.norm import from_log
from voicefixer_tpu_torch.ops.precision import tf32_off
from voicefixer_tpu_torch.pipeline import vocoder_facade
from voicefixer_tpu_torch.utils.weights import tree_map


def _trim_center(est: np.ndarray, ref_len: int) -> np.ndarray:
    """Centre-trim est's last axis to ref_len, the JAX package's rule:
    an even excess loses half at each end; an odd excess keeps the head and
    crops the tail (upstream would return an empty array there); a shorter
    est is returned unchanged."""
    diff = abs(est.shape[-1] - ref_len)
    if est.shape[-1] > ref_len:
        if diff // 2 > 0:
            est = est[..., diff // 2: -(diff // 2)]
        return est[..., :ref_len]
    return est


def restore_batch(analysis_params: dict, vocoder_params: dict,
                  wav: torch.Tensor, cfg: VoiceFixerConfig):
    """A batch of equal-length chunks through both stages:
    wav [B, N] -> (wav_out [B, S], pre-cap peaks [B]). A chunk whose peak
    exceeds 1 is divided by it."""
    with tf32_off(), torch.inference_mode():
        mel_orig = analysis.wav_to_mel(wav, cfg)
        out = analysis.apply(analysis_params, mel_orig, cfg)
        denoised_mel = from_log(out["mel"])
        wav_out = vocoder_facade.synthesize(vocoder_params, denoised_mel,
                                            cfg.vocoder)[..., 0]
        peaks = wav_out.abs().amax(dim=-1)
        wav_out = torch.where((peaks > 1.0)[:, None],
                              wav_out / peaks[:, None], wav_out)
    return wav_out, peaks


def restore_segment(analysis_params: dict, vocoder_params: dict,
                    wav: torch.Tensor, cfg: VoiceFixerConfig):
    """One chunk: wav [N] -> (wav_out [S], peak)."""
    out, peaks = restore_batch(analysis_params, vocoder_params, wav[None], cfg)
    return out[0], peaks[0]


def resolve_device(device) -> torch.device:
    """None means CUDA. A CUDA device without a card raises: the port never
    carries on on the CPU unless asked to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch versions on the CPU")
    return dev


class VoiceFixer:
    """Restoration API mirroring upstream ``VoiceFixer``, mode 0.

    params / vocoder_params: the port's parameter trees (``analysis.init``
    and ``vocoder.init``, or ``utils.weights.from_jax_params``)."""

    def __init__(self, params: dict, vocoder_params: dict,
                 config: VoiceFixerConfig = DEFAULT_CONFIG, device=None):
        self.device = resolve_device(device)
        self.config = config
        to_dev = lambda t: t.to(self.device)  # noqa: E731
        self.params = fold_bn_eval(tree_map(to_dev, params))
        self.vocoder_params = tree_map(to_dev, vocoder_params)

    @classmethod
    def random(cls, seed: int = 0, config: VoiceFixerConfig = DEFAULT_CONFIG,
               device=None) -> "VoiceFixer":
        """Randomly initialized pipeline, drawn from ``seed`` on the CPU."""
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        return cls(analysis.init(config, gen, device),
                   vocoder_model.init(config.vocoder, gen, device),
                   config=config, device=device)

    def restore_inmem(self, wav_10k: np.ndarray, cuda: bool = False,
                      mode: int = 0, your_vocoder_func=None, seed: int = 0,
                      chunk_overlap_seconds: float = 0.0) -> np.ndarray:
        """wav [N] at 44.1 kHz -> restored wav [N]. ``cuda`` and ``seed`` are
        accepted for API compatibility; the device is the instance's."""
        if mode not in (0, 1, 2):
            raise ValueError(f"mode must be 0, 1, or 2, got {mode}")
        if mode != 0:
            raise NotImplementedError(
                f"mode {mode} is not ported yet: ROADMAP.md Queue 1 "
                "items 11-12")
        if your_vocoder_func is not None:
            raise NotImplementedError(
                "your_vocoder_func is not ported yet: ROADMAP.md Queue 1 "
                "item 12")
        if chunk_overlap_seconds > 0:
            raise NotImplementedError(
                "chunk_overlap_seconds (overlap_add, _restore_overlap) is not "
                "ported yet: ROADMAP.md Queue 1 item 8")
        wav_10k = np.asarray(wav_10k, dtype=np.float32).reshape(-1)
        seg_length = self.config.pipeline.seg_length
        segments = [wav_10k[s: s + seg_length]
                    for s in range(0, wav_10k.shape[0], seg_length)]
        orig_lens: dict = {}
        if self.config.pipeline.pad_short_to_seg:
            for i, seg in enumerate(segments):
                if seg.shape[0] < seg_length:
                    orig_lens[i] = seg.shape[0]
                    segments[i] = np.pad(seg, (0, seg_length - seg.shape[0]))
        groups: dict = {}
        for i, seg in enumerate(segments):
            groups.setdefault(seg.shape[0], []).append(i)
        res: list = [None] * len(segments)
        for seg_len, idxs in groups.items():
            batch = torch.from_numpy(np.stack([segments[i] for i in idxs]))
            outs, peaks = restore_batch(self.params, self.vocoder_params,
                                        batch.to(self.device), self.config)
            outs = outs.float().cpu().numpy()
            for j, i in enumerate(idxs):
                peak = float(peaks[j])
                if peak > 1.0:
                    print("Warning: Exceed energy limit,", peak)
                out = _trim_center(outs[j], seg_len)
                # a padded chunk's real audio is its head
                if i in orig_lens:
                    out = out[:orig_lens[i]]
                res[i] = out
        return np.concatenate(res, axis=-1)
