"""VoiceFixer at 44.1 kHz, the family of every configuration that states
``"family": "voicefixer"``: the analysis stage (STFT and mel, the GRU
denoiser, the 6-level ResUNet) and the TFGAN vocoder, restoring 30 s
segments of a wave. It delegates to the modules that hold this model:
``model_config`` (the configuration as attributes), ``weights`` (the
upstream-layout weights drawn on the device), ``program`` (the system
under test), ``reference/model.py`` (the plain reference) and
``frozen/flops.py`` (the FLOP count).

A family module defines these hooks; the harness (``harness.py``), the
check (``check.py``), the control (``control.py``) and the readers of
``mfu`` and ``kernels_roofline`` reach the model through them alone:

- ``namespace(cfg) -> ns``: the configuration file as an object, with
  ``ns.precision`` ("parity" or "production", ``ops.precision``'s names);
- ``draw(ns, seed, device) -> tuple of state dicts``: the weights, drawn
  on ``device`` from ``seed`` as float32 views of one buffer (so that
  ``weights.to_host`` copies them in one transfer), the same for the same
  seed;
- ``program(cfg, state, device)``: the system under test built from the
  host state dicts, with ``serve(entry, inputs, kwargs) -> answers``
  (through ``entries/<entry>.py``) and ``close()``;
- ``reference(state, ns, numerics="fp32")``: the plain reference on the
  device state dicts, with ``restore(input) -> answer``, the whole answer
  to one input; ``OWN``: for every precision the family's configurations
  state, the reference's numerics that round as that precision stores
  (None: none below float32);
  ``CONTROL``: per precision, the numerics one step below it;
- ``inputs(mix, seed, ns, device) -> [input]``: the pool of a mix, made on
  the device from the seed;
- ``units(ns, input) -> (audio_s, segments)``: the audio seconds and the
  segments (the unit of ``flops_per_segment`` and the per-segment
  readers) of one input;
- ``compare(ref, own, kept, rng, per) -> readings``: the numbers of
  ``correct`` for the kept (inputs, answers) pairs, ``per`` pieces of an
  answer at most, drawn by ``rng``, with ``own`` (the reference in
  ``OWN``'s numerics, or None) where the family compares against it
  (an entry's ``expected`` takes its place: ``check.whole_answers``);
- ``flops_per_segment(ns)``: the FLOPs of one segment, for ``mfu``;
- ``functions(ns)`` and ``SYMBOLS``: one segment's kernel functions and
  the names of the port's kernels that compute them, for
  ``kernels_roofline``;
- ``FAULTS``: {name: factory(cfg, state, device)}, the program with its
  timed path broken underneath, which ``correct`` has to reject;
- optionally ``narrow(cfg) -> cfg``: the configuration file at small
  widths, which the CPU tests run (``tests/narrow.py``; a configuration
  whose family has no ``narrow`` is copied there as it is).

Here the segments are 30 s pieces of a wave. ``compare``'s numbers:

- ``rel_err``: the worst over the sampled segments of
  ||program - reference|| / ||reference||, each 30 s segment cut from the
  program's whole answer at its own offset, so segmenting, padding, the
  peak cap, the centre trim and the concatenation are compared with the
  analysis stage and the vocoder. Of a long answer at most ``per``
  segments are compared, the last, padded one always among them.
- ``err_ratio`` (answers of a bfloat16 configuration): the worst over the
  segments of ``rel_err`` over the same of the reference computed in the
  configuration's own precision. A weight draw that amplifies rounding
  moves the program's error and the control's alike, so ``rel_err`` alone
  does not separate them; this ratio does.
- ``wrong_length`` and ``nonfinite``, as ``check.py`` counts them.

The faults: in ``VoiceFixer._restore_batch_device`` (one call of
equal-length rows, on the card) "half_batch" restores the first half of a
call's rows and answers the rest with their mean; "altered" shifts every
answer by one hop (441 samples) where it is produced.
"post_bias_dropped" and "pre_bias_dropped" hand the program's loader the
vocoder with the post-conv's or the pre-conv's bias zeroed, as a kernel
that skips that bias would compute.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from bench_cuda import check, generator, model_config, weights
from bench_cuda.frozen import flops, work
from bench_cuda.program import Program
from bench_cuda.reference.model import Reference, mel_filterbank, pad_to

OWN = {"parity": None, "production": "bf16"}
CONTROL = {"parity": "tf32", "production": "fp8"}
BLOCK_ROWS = 8  # segments the reference restores at once
# the __global__ functions of the port's csrc/*.cu
SYMBOLS = ("stft_mel_kernel", "mel_bands_kernel", "gru_bidir_kernel",
           "gru_seq_kernel", "gru_bidir_backward_kernel",
           "upsample_wgmma_kernel", "upsample_f32_kernel", "sin_residual",
           "chain_f32_kernel", "shift_f32_kernel", "chain_wgmma_kernel",
           "shift_wgmma_kernel", "conv_block_f32_kernel",
           "conv_block_wgmma_kernel")

namespace = model_config.namespace
draw = weights.draw  # (analysis, vocoder)


def narrow(cfg: dict) -> dict:
    """Upstream's structure (6 U-Net levels of 4 blocks, 4 vocoder stages
    of 8 blocks, which the program's loader needs) at small widths and 1 s
    segments."""
    cfg = copy.deepcopy(cfg)
    cfg["denoiser"]["base_width"] = 8
    cfg["unet"].update(encoder_channels=[2, 4, 4, 8, 8, 8],
                       blocks_per_stage=4, center_channels=8)
    cfg["vocoder"].update(cond_channels=16, channels=32)
    cfg["pipeline"]["seg_length_seconds"] = 1
    return cfg


def program(cfg: dict, state: tuple, device):
    return Program(cfg, *state, device)


def reference(state: tuple, ns, numerics: str = "fp32"):
    return Reference(*state, ns, numerics)


def inputs(mix: dict, seed: int, ns, device) -> list:
    """The mix's recordings at the configuration's sample rate."""
    return generator.recordings(mix, seed, ns.pipeline.sample_rate, device)


def units(ns, wave) -> tuple:
    n = wave.shape[0]
    return n / ns.pipeline.sample_rate, -(-n // ns.pipeline.seg_length)


def segments_to_compare(n_segments: int, k: int,
                        rng: np.random.Generator) -> list:
    """The last segment and up to k - 1 others drawn by rng, in order."""
    others = list(range(n_segments - 1))
    pick = rng.choice(others, size=min(k - 1, len(others)), replace=False) \
        if k > 1 and others else []
    return sorted(int(i) for i in pick) + [n_segments - 1]


def compare(ref, own, kept: list, rng, per: int) -> dict:
    """``rel_err``, with ``own`` also ``err_ratio``, over the sampled 30 s
    segments of the kept answers (see above)."""
    pairs, wrong = check.pairs(kept)
    rel, ratio, nonfinite = 0.0, 0.0, 0
    seg = ref.cfg.pipeline.seg_length
    todo = []  # (answer slice, input row, cut)
    for wav, out in pairs:
        if out.shape != wav.shape:
            wrong += 1
            continue
        nonfinite += int(np.count_nonzero(~np.isfinite(out)))
        n_seg = -(-wav.shape[0] // seg)
        for s in segments_to_compare(n_seg, per, rng):
            n = min(seg, wav.shape[0] - s * seg)
            todo.append((out[s * seg: s * seg + n],
                         pad_to(wav[s * seg: (s + 1) * seg], seg), n))
    for i in range(0, len(todo), BLOCK_ROWS):
        block = todo[i: i + BLOCK_ROWS]
        rows = torch.as_tensor(np.stack([r for _, r, _ in block]),
                               device=ref.device)
        res = ref.restore_rows(rows).cpu().numpy()
        mine = own.restore_rows(rows).cpu().numpy() if own else res
        for (got, _, n), want, near in zip(block, res, mine):
            rel = max(rel, check.rel(got, want[:n]))
            if own:
                ratio = max(ratio, check.rel(got, want[:n])
                            / max(check.rel(near[:n], want[:n]), 1e-30))
    return check.as_readings(rel, ratio if own else None, wrong, nonfinite)


def flops_per_segment(ns) -> int:
    """The frozen analytic FLOPs of one mode-0 segment."""
    return flops.pipeline_flops(ns, ns.pipeline.seg_length_seconds)


def functions(ns) -> list:
    """[(work(t_scale) -> (flops, bytes), peak)] of one segment's
    functions: ``work(1)`` is one segment's work, ``work(0)`` its weights'
    bytes alone. They are the STFT and mel (K5, float32), the four
    bidirectional GRU layers' recurrence (K6) and the four vocoder stages,
    each an upsample fused with its ResStack (K1 to K4; the fused form is
    the least whatever kernels run it)."""
    production = ns.precision == "production"
    size = 2 if production else 4
    peak = work.PEAK_BF16 if production else work.PEAK_FP32
    n = ns.pipeline.seg_length
    t = n // ns.stft.hop_length + 1
    m = ns.mel
    nnz = int((mel_filterbank(m.n_stft, m.f_min, m.f_max, m.n_mels,
                              m.sample_rate) != 0).sum())
    out = [(lambda k: work.stft_work(n * k, t * k, ns.stft.n_fft,
                                     ns.stft.n_freqs, m.n_mels, nnz),
            work.PEAK_FP32)]
    d = ns.denoiser
    for _ in range(d.num_gru_blocks * d.gru_layers):
        out.append((lambda k: work.gru_work(t * k, d.base_width, size),
                    peak))
    v = ns.vocoder
    t_in = t + t % 2 + 4
    for i, s in enumerate(v.upsample_scales):
        cin, cout = v.channels // 2 ** i, v.channels // 2 ** (i + 1)
        out.append((lambda k, t_in=t_in, s=s, cin=cin, cout=cout, i=i:
                    work.up_res_work(t_in * k, s, cin, cout,
                                     v.resstack_depth[i], size), peak))
        t_in *= s
    return out


def _bias_key(cfg: dict, where: str) -> str:
    """The upstream key of the vocoder's pre-conv or post-conv bias."""
    if where == "pre":
        return "generator.1.bias"
    return f"generator.{4 + 3 * len(cfg['vocoder']['upsample_scales'])}.bias"


def _half_batch(restore):
    def call(batch, *a, **k):
        n = max(1, len(batch) // 2)
        outs, peaks = restore(batch[:n], *a, **k)
        rest = len(batch) - n
        if rest:
            outs = torch.cat([outs, outs.mean(0, keepdim=True).expand(
                rest, -1)])
            peaks = torch.cat([peaks, peaks[:1].expand(rest)])
        return outs, peaks
    return call


def _altered(restore):
    def call(batch, *a, **k):
        outs, peaks = restore(batch, *a, **k)
        return torch.roll(outs, 441, dims=-1), peaks
    return call


def _patched(wrap):
    def make(cfg, state, device):
        prog = Program(cfg, *state, device)
        prog.vf._restore_batch_device = wrap(prog.vf._restore_batch_device)
        return prog
    return make


def _bias_dropped(where):
    def make(cfg, state, device):
        analysis_sd, vocoder_sd = state
        key = _bias_key(cfg, where)
        vocoder_sd = dict(vocoder_sd)
        vocoder_sd[key] = np.zeros_like(vocoder_sd[key])
        return Program(cfg, analysis_sd, vocoder_sd, device)
    return make


FAULTS = {"half_batch": _patched(_half_batch), "altered": _patched(_altered),
          "post_bias_dropped": _bias_dropped("post"),
          "pre_bias_dropped": _bias_dropped("pre")}
