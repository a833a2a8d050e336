"""End-to-end restoration: wav -> analysis -> vocoder -> wav, as
``voicefixer_tpu/pipeline/restore.py`` (upstream VoiceFixer.restore_inmem
and restore): 30 s segments, short and tail segments zero-padded to a full
segment, equal lengths batched, a per-chunk peak cap, and the upstream
centre trim; or, with ``chunk_overlap_seconds``, overlapping windows
stitched by a crossfade. Mode 1 first zeroes the STFT bins above a
cumulative log-energy cutoff (``remove_higher_frequency``). Mode 2 runs the
analysis stage in training mode (batch statistics, live dropout from a
seeded generator), and it and a custom vocoder (``your_vocoder_func``) take
the segments one by one, unpadded, as upstream does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from voicefixer_tpu_torch import kernels
from voicefixer_tpu_torch.config import DEFAULT_CONFIG, VoiceFixerConfig
from voicefixer_tpu_torch.models import analysis, resunet
from voicefixer_tpu_torch.models import vocoder as vocoder_model
from voicefixer_tpu_torch.ops.conv import fold_bn_eval
from voicefixer_tpu_torch.ops.norm import from_log
from voicefixer_tpu_torch.ops import stft as vstft
from voicefixer_tpu_torch.ops.precision import (activation_dtype,
                                               conv_block_kernel, tf32_off,
                                               use_conv_block_kernel)
from voicefixer_tpu_torch.parallel import distributed, sp, tp
from voicefixer_tpu_torch.parallel.mesh import (axis_size, check_mesh,
                                                global_batch, shard_batch)
from voicefixer_tpu_torch.parallel.sharding import shard_params
from voicefixer_tpu_torch.pipeline import plan, vocoder_facade
from voicefixer_tpu_torch.utils.profiling import annotate
from voicefixer_tpu_torch.utils.weights import (CastCache, cast_tree,
                                              convert_tree, tree_map)

EPS = 1e-8


def remove_higher_frequency(wav: torch.Tensor, cfg: VoiceFixerConfig,
                            pad_mode: str = "constant",
                            return_cutoff: bool = False):
    """Mode 1's preprocessing: zero every STFT bin from the first one at
    which the cumulative log energy reaches ``hf_removal_ratio`` of its
    total, then invert. librosa.stft's defaults: n_fft 2048, hop
    n_fft // 4, centred with ``pad_mode``; the inverse gives hop * (T - 1)
    samples, a little fewer than went in, as upstream. wav [N] -> [N'];
    with ``return_cutoff`` also the cutoff bin (an int)."""
    scfg = dataclasses.replace(cfg.stft, hop_length=cfg.stft.n_fft // 4,
                               pad_mode=pad_mode)
    real, imag = vstft.stft_real_imag(wav[None], scfg)  # [1, T, F]
    mag = torch.sqrt(real * real + imag * imag)
    cos, sin = real / (mag + EPS), imag / (mag + EPS)
    feature = torch.log10(mag + EPS)
    feature = torch.where(feature < 0, torch.zeros_like(feature), feature)
    energy_level = feature.sum(dim=(0, 1))  # [F]
    threshold = energy_level.sum() * cfg.pipeline.hf_removal_ratio
    cum = torch.cumsum(energy_level, dim=0)
    cutoff = torch.argmax((cum >= threshold).to(torch.int32))  # first bin
    keep = torch.arange(mag.shape[-1], device=mag.device) < cutoff
    spec = mag * keep
    out = vstft.istft(spec * cos, spec * sin, scfg)[0]
    return (out, int(cutoff)) if return_cutoff else out


def overlap_add(chunks: list, positions: list, total: int,
                ramp: int) -> np.ndarray:
    """Weighted overlap-add: each chunk fades in and out linearly over
    ``ramp`` samples at its interior boundaries, and the weights are
    normalised, so a constant signal comes back exactly. The quality mode
    for long audio; the hard seams of upstream's concatenation are the
    default."""
    out = np.zeros(total, dtype=np.float64)
    wsum = np.zeros(total, dtype=np.float64)
    for chunk, pos in zip(chunks, positions):
        n = chunk.shape[-1]
        w = np.ones(n, dtype=np.float64)
        if pos > 0:
            w[:ramp] = np.linspace(0.0, 1.0, ramp, endpoint=False)
        if pos + n < total:
            w[n - ramp:] = np.linspace(1.0, 0.0, ramp, endpoint=False)
        out[pos:pos + n] += w * chunk.astype(np.float64)
        wsum[pos:pos + n] += w
    return (out / np.maximum(wsum, 1e-12)).astype(np.float32)


def restore_batch(analysis_params: dict, vocoder_params,
                  wav: torch.Tensor, cfg: VoiceFixerConfig,
                  model_devices=None, training: bool = False,
                  generator: torch.Generator | None = None, mesh=None):
    """A batch of equal-length chunks through both stages:
    wav [B, N] -> (wav_out [B, S], pre-cap peaks [B]). A chunk whose peak
    exceeds 1 is divided by it. With more than one entry in
    ``model_devices`` the vocoder runs time-sharded over them
    (``parallel.sp``), and ``vocoder_params`` may be a list of per-device
    copies. With a ``mesh`` of more than one "model" rank, every rank of
    the model group calls this with the same wav: the analysis stage runs
    channel-sharded (``parallel.tp``, ``analysis_params`` from
    ``parallel.sharding.shard_params``) and the vocoder time-sharded over
    the group. ``training`` and ``generator``: the analysis stage in mode 2
    (``analysis.apply``); its statistics span the batch. The stages are
    named in profiler traces (``utils.profiling.annotate``): vf.stft_mel,
    vf.denoiser, vf.resunet, vf.vocoder."""
    with tf32_off(), torch.inference_mode(), \
            kernels.current_device(wav.device), tp.use_mesh(mesh):
        with annotate("vf.stft_mel"):
            mel_orig = analysis.wav_to_mel(wav, cfg)
        out = analysis.apply(analysis_params, mel_orig, cfg,
                             training=training, generator=generator)
        denoised_mel = from_log(out["mel"])
        with annotate("vf.vocoder"):
            sharded = tp.model_parallel()
            devices = (None if sharded or len(model_devices or ()) < 2
                       else model_devices)
            if sharded or devices is not None:
                wav_out = sp.synthesize_sp(
                    vocoder_params, denoised_mel, cfg.vocoder, devices,
                    mesh if sharded else None)[..., 0]
            else:
                wav_out = vocoder_facade.synthesize(
                    vocoder_params, denoised_mel, cfg.vocoder)[..., 0]
        peaks = wav_out.abs().amax(dim=-1)
        wav_out = torch.where((peaks > 1.0)[:, None],
                              wav_out / peaks[:, None], wav_out)
    return wav_out, peaks


def restore_segment(analysis_params: dict, vocoder_params: dict,
                    wav: torch.Tensor, cfg: VoiceFixerConfig,
                    training: bool = False,
                    generator: torch.Generator | None = None):
    """One chunk: wav [N] -> (wav_out [S], peak)."""
    out, peaks = restore_batch(analysis_params, vocoder_params, wav[None],
                               cfg, training=training, generator=generator)
    return out[0], peaks[0]


def _cast_weights(params: dict, vocoder_params, dtype: torch.dtype):
    """The trees ``restore_batch`` takes in ``dtype``: the analysis tree
    with its ResUNet cast (the denoiser casts nothing), the vocoder tree or
    each per-device copy, a copy shared by devices cast once."""
    params = {**params, "unet": cast_tree(params["unet"], dtype)}
    if isinstance(vocoder_params, list):
        casts = {id(p): p for p in vocoder_params}
        casts = {k: cast_tree(p, dtype) for k, p in casts.items()}
        return params, [casts[id(p)] for p in vocoder_params]
    return params, cast_tree(vocoder_params, dtype)


def resolve_device(device) -> torch.device:
    """None means CUDA: in a process group (``parallel.distributed``) this
    process's device. A CUDA device without a card raises: the port never
    carries on on the CPU unless asked to."""
    if device is None and distributed.is_initialized():
        return distributed.local_device()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch versions on the CPU")
    return dev


class VoiceFixer:
    """Restoration API mirroring upstream ``VoiceFixer``, modes 0, 1 and 2.

    params / vocoder_params: the port's parameter trees (``analysis.init``
    and ``vocoder.init``, or ``utils.weights.from_jax_params``). Where one
    is None it is loaded from ``ckpt`` / ``vocoder_ckpt`` (an npz tree or a
    torch checkpoint) or the local caches, as
    ``pipeline.checkpoints.load_analysis_params`` and
    ``load_vocoder_params`` resolve them; ``download`` is accepted for the
    JAX package's signature, and nothing is downloaded.

    device: None means CUDA, and raises without a card; pass "cpu" for the
    plain versions.

    model_devices: the counterpart of the JAX package's mesh with a model
    axis. With more than one entry the vocoder runs time-sharded over them
    (``parallel.sp``), its weights copied to each; the analysis stage stays
    on ``device``. One device may be listed several times. One process
    drives all of them.

    mesh: a ("data", "model") mesh over processes
    (``parallel.mesh.make_mesh``), the JAX package's ``mesh=``. With more
    than one "model" rank, the analysis tree keeps this rank's slice of
    each large convolution (``parallel.sharding.shard_params``) and runs
    channel-sharded, the vocoder tree stays whole and runs time-sharded
    (``parallel.sp``), and every rank of a model group must make each
    restore call with the same input. The "data" axis is for
    ``parallel.inference.restore_wavs``. Not with ``model_devices``.

    conv_block_kernel: route the ResUNet blocks that
    ``kernels.convblock.eligible`` takes to the fused ConvBlockRes kernel
    instead of the library convolutions, their operands packed once here
    (``resunet.pack_conv_blocks``). Off by default, as in the JAX
    package. Under a model axis the blocks take the sliced library path
    all the same (the kernel needs every channel).

    ``params`` and ``vocoder_params`` stay float32. In production precision
    the instance casts the ResUNet's tree and the vocoder's (each
    per-device copy) to bfloat16 once, on the first call in that type
    (``weight_casts``, a ``utils.weights.CastCache``: its ``misses`` count
    the casts, its ``hits`` the calls served from them), and again only
    after ``params`` or ``vocoder_params`` is reassigned: like the folded
    batch norms and the packed operands, the cast copies do not follow
    in-place edits of the trees or their weights."""

    def __init__(self, params: dict | None = None,
                 vocoder_params: dict | None = None,
                 config: VoiceFixerConfig = DEFAULT_CONFIG, device=None,
                 model_devices=None, conv_block_kernel: bool = False,
                 ckpt: str | None = None, vocoder_ckpt: str | None = None,
                 download: bool = True, mesh=None):
        check_mesh(mesh)
        if mesh is not None and model_devices is not None:
            raise ValueError("mesh= and model_devices= do not combine")
        self.device = resolve_device(device)
        self.config = config
        self.mesh = mesh
        if params is None or vocoder_params is None:
            from voicefixer_tpu_torch.pipeline import checkpoints
            if params is None:
                params = convert_tree(
                    checkpoints.load_analysis_params(ckpt, download),
                    "analysis", self.device)
            if vocoder_params is None:
                vocoder_params = convert_tree(
                    checkpoints.load_vocoder_params(vocoder_ckpt, download),
                    "vocoder", self.device)
        self.conv_block_kernel = bool(conv_block_kernel)
        self.params = fold_bn_eval(
            tree_map(lambda t: t.to(self.device), params))
        if axis_size(mesh, "model") > 1:
            self.params = shard_params(self.params, mesh)
        elif self.conv_block_kernel:
            self.params["unet"] = resunet.pack_conv_blocks(
                self.params["unet"])
        self.model_devices = None
        if model_devices is not None and len(model_devices) > 1:
            self.model_devices = tuple(resolve_device(d)
                                       for d in model_devices)
            copies = {d: tree_map(lambda t, d=d: t.to(d), vocoder_params)
                      for d in dict.fromkeys(self.model_devices)}
            self.vocoder_params = [copies[d] for d in self.model_devices]
        else:
            self.vocoder_params = tree_map(lambda t: t.to(self.device),
                                           vocoder_params)
        self.weight_casts = CastCache()

    @classmethod
    def random(cls, seed: int = 0, config: VoiceFixerConfig = DEFAULT_CONFIG,
               device=None, **kwargs) -> "VoiceFixer":
        """Randomly initialized pipeline, drawn from ``seed`` on the CPU."""
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        return cls(analysis.init(config, gen, device),
                   vocoder_model.init(config.vocoder, gen, device),
                   config=config, device=device, **kwargs)

    def _hf(self, wav: np.ndarray) -> np.ndarray:
        """``remove_higher_frequency`` of one segment on the instance's
        device."""
        with tf32_off(), torch.inference_mode():
            out = remove_higher_frequency(
                torch.from_numpy(wav).to(self.device), self.config)
        return out.cpu().numpy()

    def _weights(self, training: bool = False) -> tuple:
        """(analysis tree, vocoder tree) for a call in the current
        precision: the stored float32 trees where the activation type is
        float32; else the instance's cast copies (``weight_casts``), the
        analysis tree float32 in training, where the ResUNet does not
        cast."""
        adt = activation_dtype()
        if adt == torch.float32:
            return self.params, self.vocoder_params
        params, vocoder_params = self.weight_casts.get(
            adt, (self.params, self.vocoder_params), _cast_weights)
        return (self.params if training else params), vocoder_params

    def _restore_batch_device(self, batch, training: bool = False,
                              generator: torch.Generator | None = None):
        """restore_batch of [B, N] chunks (numpy or a tensor) -> (outs
        [B, S], peaks [B]), float32 on the instance's device."""
        with annotate("vf.upload"):
            wav = torch.as_tensor(batch).to(self.device)
        params, vocoder_params = self._weights(training)
        with conv_block_kernel(self.conv_block_kernel
                               or use_conv_block_kernel()):
            outs, peaks = restore_batch(
                params, vocoder_params, wav, self.config,
                model_devices=self.model_devices, training=training,
                generator=generator, mesh=self.mesh)
        return outs.float(), peaks.float()

    def _to_host(self, *tensors) -> tuple:
        """The tensors as numpy (``vf.download``: on a card the copies,
        after the host has waited for the call's work)."""
        with annotate("vf.download"):
            return tuple(t.cpu().numpy() for t in tensors)

    def _restore_batch(self, batch: np.ndarray, training: bool = False,
                       generator: torch.Generator | None = None):
        """restore_batch of [B, N] chunks -> (outs [B, S], peaks [B]) as
        numpy."""
        return self._to_host(
            *self._restore_batch_device(batch, training, generator))

    def _calls(self, rows: list, data_mesh=None, max_batch=None):
        """Equal-length eval rows through ``_restore_batch_device`` in the
        calls that ``plan.split`` makes of them under ``plan.rows_per_call``
        (on the card one call of 26 full-width rows raises in the
        post-conv's 32-bit reflection pad): yields (the call's slice of
        ``rows``, outs [n, S], peaks [n]) on the host, call by call. Each
        call stacks its rows once. With a ``data_mesh`` every data rank
        restores its share of each call and gets all of it back;
        ``max_batch`` caps the rows of a global batch before the split."""
        with annotate("vf.plan"):
            cap = plan.rows_per_call(self, rows[0].shape[-1],
                                     plan.cap_group(self.mesh, data_mesh))
            calls = plan.split(len(rows), cap, axis_size(data_mesh, "data"),
                               max_batch)
        for call in calls:
            n = call.stop - call.start
            with annotate("vf.plan"):
                batch = shard_batch(data_mesh,
                                    torch.from_numpy(np.stack(rows[call])))
            outs, peaks = self._restore_batch_device(batch)
            # rebound to the host copies before the yield, so that the
            # device outputs are freed before the next call runs
            outs, peaks = self._to_host(global_batch(data_mesh, outs, n),
                                        global_batch(data_mesh, peaks, n))
            yield call, outs, peaks

    def _restore_eval(self, wavs: list, mode: int, data_mesh=None,
                      max_batch=None, warn: bool = True) -> list:
        """Modes 0 and 1 of a list of waves: each cut into segments
        (``plan.segments``), the segments of every wave grouped by length,
        each group restored in ``_calls`` and each row finished
        (``plan.finish``; ``warn``: print its peak warning); the restored
        waves in order."""
        pcfg = self.config.pipeline
        cut = [plan.segments(w, pcfg.seg_length, pcfg.pad_short_to_seg,
                             self._hf if mode == 1 else None) for w in wavs]
        with annotate("vf.plan"):
            groups: dict = {}
            for wi, (segs, _) in enumerate(cut):
                for si, seg in enumerate(segs):
                    groups.setdefault(seg.shape[0], []).append((wi, si))
        res = [[None] * len(segs) for segs, _ in cut]
        for seg_len, keys in groups.items():
            rows = [cut[wi][0][si] for wi, si in keys]
            for call, outs, peaks in self._calls(rows, data_mesh, max_batch):
                with annotate("vf.stitch"):
                    for (wi, si), out, peak in zip(keys[call], outs, peaks):
                        res[wi][si] = plan.finish(out, peak if warn else None,
                                                  seg_len, cut[wi][1][si])
        with annotate("vf.stitch"):
            return [np.concatenate(r, axis=-1) for r in res]

    def _denoised_mel(self, wav: np.ndarray, training: bool,
                      generator: torch.Generator | None) -> torch.Tensor:
        """The analysis stage of one segment: the denoised linear mel
        [1, 1, T, n_mels] on the instance's device, what upstream hands a
        custom vocoder."""
        with tf32_off(), torch.inference_mode(), \
                kernels.current_device(self.device), tp.use_mesh(self.mesh), \
                conv_block_kernel(self.conv_block_kernel
                                  or use_conv_block_kernel()):
            mel = analysis.restore_mel(
                self._weights(training)[0],
                torch.from_numpy(wav[None]).to(self.device),
                self.config, training=training, generator=generator)
            return from_log(mel)[:, None]

    @annotate("vf.request")
    def restore_inmem(self, wav_10k: np.ndarray, cuda: bool = False,
                      mode: int = 0, your_vocoder_func=None, seed: int = 0,
                      chunk_overlap_seconds: float = 0.0) -> np.ndarray:
        """wav [N] at 44.1 kHz -> restored wav [N] (mode 1: a little shorter,
        as upstream). mode 0: eval; mode 1: eval after
        ``remove_higher_frequency`` on each 30 s segment; mode 2: the
        analysis stage in training mode, its dropout drawn from one
        generator on the instance's device seeded ``seed``, which serves
        the segments in order. ``your_vocoder_func`` replaces the vocoder:
        it receives each segment's denoised linear mel [1, 1, T, n_mels] as
        a tensor on the device and returns the segment's samples (a tensor
        or anything numpy takes). Mode 2 and a custom vocoder run the
        segments one by one at their own lengths (mode 2's statistics are
        per segment). ``chunk_overlap_seconds`` > 0 stitches an input
        longer than one segment from overlapping windows
        (``_restore_overlap``) instead of hard seams; eval modes only.
        ``cuda`` is accepted for API compatibility; the device is the
        instance's."""
        if mode not in (0, 1, 2):
            raise ValueError(f"mode must be 0, 1, or 2, got {mode}")
        wav_10k = np.asarray(wav_10k, dtype=np.float32).reshape(-1)
        if mode == 2 or your_vocoder_func is not None:
            return self._restore_sequential(wav_10k, mode, seed,
                                            your_vocoder_func)
        if (chunk_overlap_seconds > 0
                and wav_10k.shape[0] > self.config.pipeline.seg_length):
            return self._restore_overlap(wav_10k, mode,
                                         chunk_overlap_seconds)
        return self._restore_eval([wav_10k], mode)[0]

    def _restore_sequential(self, wav: np.ndarray, mode: int, seed: int,
                            your_vocoder_func) -> np.ndarray:
        """Mode 2 and the custom vocoder: each segment alone, at its own
        length, trimmed to it."""
        training = mode == 2
        segs, _ = plan.segments(wav, self.config.pipeline.seg_length, False,
                                self._hf if mode == 1 else None)
        generator = (torch.Generator(self.device).manual_seed(seed)
                     if training else None)
        res = []
        for seg in segs:
            if your_vocoder_func is None:
                outs, peaks = self._restore_batch(seg[None], training,
                                                  generator)
                out, peak = outs[0], peaks[0]
            else:
                out = your_vocoder_func(
                    self._denoised_mel(seg, training, generator))
                if isinstance(out, torch.Tensor):
                    out = out.detach().float().cpu()
                out, peak = np.asarray(out).reshape(-1), None
            res.append(plan.finish(out, peak, seg.shape[0]))
        with annotate("vf.stitch"):
            return np.concatenate(res, axis=-1)

    def _restore_overlap(self, wav: np.ndarray, mode: int,
                         overlap_seconds: float) -> np.ndarray:
        """Full-segment windows ``overlap_seconds`` apart at their seams,
        restored in ``_calls``, stitched by ``overlap_add``. In mode 1 each
        window is ``remove_higher_frequency``'d and padded back to a full
        segment (the crossfade covers the sub-hop tail)."""
        seg = self.config.pipeline.seg_length
        n = wav.shape[0]
        with annotate("vf.plan"):
            ramp = min(int(overlap_seconds
                           * self.config.pipeline.sample_rate), seg // 2)
            stride = seg - ramp
            positions = list(range(0, max(n - seg, 0) + 1, stride))
            if positions[-1] + seg < n:
                positions.append(n - seg)
            windows = [wav[pos: pos + seg] for pos in positions]
        if mode == 1:
            windows = [plan.fit_length(self._hf(w), seg) for w in windows]
        chunks = [None] * len(windows)
        for call, outs, peaks in self._calls(windows):
            with annotate("vf.stitch"):
                chunks[call] = [plan.fit_length(plan.finish(o, p, seg), seg)
                                for o, p in zip(outs, peaks)]
        with annotate("vf.stitch"):
            return overlap_add(chunks, positions, n, ramp)

    def restore(self, input: str, output: str, cuda: bool = False,
                mode: int = 0, your_vocoder_func=None, seed: int = 0,
                chunk_overlap_seconds: float = 0.0):
        """File to file: read (any rate, mixed to mono, resampled to 44.1
        kHz), ``restore_inmem``, write int16 WAV or FLAC by the extension."""
        from voicefixer_tpu_torch.utils import audio_io
        sr = self.config.pipeline.sample_rate
        wav = audio_io.load_wav(input, sample_rate=sr)
        out = self.restore_inmem(wav, cuda=cuda, mode=mode,
                                 your_vocoder_func=your_vocoder_func,
                                 seed=seed,
                                 chunk_overlap_seconds=chunk_overlap_seconds)
        audio_io.save_wave(out, fname=output, sample_rate=sr)
