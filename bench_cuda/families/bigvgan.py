"""BigVGAN-v2 44 kHz (128 bands, 512x), the family of every configuration
that states ``"family": "bigvgan"``: the generator alone, a log-mel in, a
44.1 kHz wave out, as a TTS service runs it after its acoustic model. The
hooks are ``families/voicefixer.py``'s; this module holds them all, with
the plain reference in ``reference/bigvgan.py``, the FLOP count in
``frozen/bigvgan_flops.py`` and K10's work in ``frozen/bigvgan_work.py``.

- ``namespace``: the configuration's ``model`` fields (the program's
  ``BigVGANConfig``) as attributes, with ``precision``.
- ``draw``: upstream's state dict (weight_g / weight_v, the resamplers'
  filter buffers as numpy arrays), float32 views of one buffer on the
  device: every conv N(0, ``draw.conv_std``) as upstream's
  ``init_weights`` but ``conv_pre`` (torch's default U(-1/sqrt(fan_in),
  1/sqrt(fan_in))), weight_g ||v|| times U(0.9, 1.1), every bias
  U(-``draw.bias``, ``draw.bias``), log alpha and log beta
  N(0, ``draw.log_snake_sigma``^2) (the configuration's ``assumed``).
- ``inputs``: the mix's seeded speech (``generator.recordings``) through
  the reference's log-mel front end, [frames, 128] float32, in set-up.
- ``units``: (a, a), a = frames * hop / sample rate, the answer's audio
  seconds: a segment is one audio second, a fraction for the last.
- ``compare``: whole answers, ``rel_err`` and ``err_ratio`` (the worst
  ``rel_err`` over the reference's own in bfloat16 storage), and the
  reading ``clamped_share``: the share of the reference's samples at the
  clamp (|y| = 1).
- ``flops_per_segment``: the frozen ``bigvgan_flops`` of one audio second.
- ``functions`` / ``SYMBOLS``: the six upsamples (K1, frozen
  ``upsample_work``) and the 109 activations (K10, frozen
  ``snake_aa_work``, float32 arithmetic); ``aa_act_functions``, K10's
  alone, which ``metrics/aa_act_roofline.py`` reads.
- ``FAULTS``, each of which ``correct`` must reject: "no_antialias"
  (SnakeBeta at the input rate, without the 2x resampling), "beta_ignored"
  (beta taken as 1) and "branch_dropped" (stage 2's k = 11 block left out
  of its mean), planted in ``models.bigvgan`` for the program's life.
"""

from __future__ import annotations

import contextlib
import copy
import math
from types import SimpleNamespace

import numpy as np
import torch

from bench_cuda import check, generator
from bench_cuda.frozen import bigvgan_flops, bigvgan_work, work
from bench_cuda.reference.bigvgan import FILTER, Reference, log_mel

# production precision alone: no float32 configuration of this family
OWN = {"production": "bf16"}
CONTROL = {"production": "fp8"}
SIZE = 2  # bytes an element stored: bfloat16
# the __global__ functions of csrc/upsample.cu and csrc/snake_aa.cu
SYMBOLS = ("upsample_wgmma_kernel", "upsample_f32_kernel", "snake_aa_kernel")
FAULT_STAGE = 2  # branch_dropped's stage


def _fields(cfg: dict) -> dict:
    """The ``model`` section, lists (and lists of lists) as tuples."""
    return {k: (tuple(tuple(x) if isinstance(x, list) else x for x in v)
                if isinstance(v, list) else v)
            for k, v in cfg["model"].items()}


def namespace(cfg: dict) -> SimpleNamespace:
    ns = SimpleNamespace(**_fields(cfg))
    ns.precision = cfg["precision"]
    ns.draw = SimpleNamespace(**cfg["draw"])
    ns.channels = tuple(ns.upsample_initial_channel // 2 ** i
                        for i in range(len(ns.upsample_rates) + 1))
    return ns


NARROW_CHANNELS = 128


def narrow(cfg: dict) -> dict:
    """Upstream's structure at 128 channels down to 2; the convs' std
    scaled by sqrt(published / narrow channels), so that each conv's gain,
    conv_std sqrt(C k), and with it the share of the AMP branches and of
    SnakeBeta's term in the wave, stays the published width's."""
    cfg = copy.deepcopy(cfg)
    wide = cfg["model"]["upsample_initial_channel"]
    cfg["model"]["upsample_initial_channel"] = NARROW_CHANNELS
    cfg["draw"]["conv_std"] *= math.sqrt(wide / NARROW_CHANNELS)
    return cfg


# --------------------------------------------------------------- weights

def layout(ns) -> list:
    """[(key, shape, kind)] of upstream's state dict, in its order; kind
    "normal" (conv_std), "pre" (conv_pre's uniform), "bias", "snake" or
    "gain" (of the key before it)."""
    out = []

    def conv(prefix, shape, kind="normal", bias=True):
        out.append((f"{prefix}.weight_g", (shape[0], 1, 1), "gain"))
        out.append((f"{prefix}.weight_v", shape, kind))
        if bias:
            out.append((f"{prefix}.bias", (shape[1] if kind == "up"
                                           else shape[0],), "bias"))

    def act(prefix, c):
        out.append((f"{prefix}.act.alpha", (c,), "snake"))
        out.append((f"{prefix}.act.beta", (c,), "snake"))

    ch = ns.channels
    conv("conv_pre", (ch[0], ns.num_mels, 7), "pre")
    n_k = len(ns.resblock_kernel_sizes)
    for i, k in enumerate(ns.upsample_kernel_sizes):
        conv(f"ups.{i}.0", (ch[i], ch[i + 1], k), "up")
        c = ch[i + 1]
        for j, (kr, dils) in enumerate(zip(ns.resblock_kernel_sizes,
                                           ns.resblock_dilation_sizes)):
            p = f"resblocks.{i * n_k + j}"
            for m in range(len(dils)):
                conv(f"{p}.convs1.{m}", (c, c, kr))
            for m in range(len(dils)):
                conv(f"{p}.convs2.{m}", (c, c, kr))
            for a in range(2 * len(dils)):
                act(f"{p}.activations.{a}", c)
    act("activation_post", ch[-1])
    conv("conv_post", (1, ch[-1], 7), bias=False)
    return out


def draw(ns, seed: int, device) -> tuple:
    """(upstream's state dict,): float32 views of one buffer on
    ``device`` drawn from ``seed``, the filter buffers as numpy arrays."""
    slots = layout(ns)
    sizes = [math.prod(shape) for _, shape, _ in slots]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    torch.randn(flat.shape, generator=gen, device=device, out=flat)
    d, sd, off = ns.draw, {}, 0
    uniform = []
    for (key, shape, kind), n in zip(slots, sizes):
        sd[key] = flat[off: off + n].view(shape)
        off += n
        if kind in ("normal", "up"):
            sd[key].mul_(d.conv_std)
        elif kind == "snake":
            sd[key].mul_(d.log_snake_sigma)
        else:  # pre, bias, gain: uniforms, drawn below
            uniform.append((key, shape, kind))
    for key, shape, kind in uniform:
        t = sd[key]
        torch.rand(t.shape, generator=gen, device=device, out=t)
        if kind == "pre":
            bound = (shape[1] * shape[2]) ** -0.5
            t.mul_(2 * bound).sub_(bound)
        elif kind == "bias":
            t.mul_(2 * d.bias).sub_(d.bias)
    for key, shape, kind in slots:
        if kind == "gain":
            v = sd[key[:-1] + "v"].double()
            norm = v.pow(2).sum(dim=(1, 2), keepdim=True).sqrt()
            sd[key].copy_((norm * (0.9 + 0.2 * sd[key].double())).float())
    taps = FILTER.numpy().copy()
    for key, _, kind in slots:
        if key.endswith(".act.beta"):
            prefix = key[:-len(".act.beta")]
            sd[f"{prefix}.upsample.filter"] = taps
            sd[f"{prefix}.downsample.lowpass.filter"] = taps
    return (sd,)


# --------------------------------------------------------------- program

class Program:
    """The port's ``BigVGAN`` facade on the state dict through the
    program's loader (``utils.weights.convert_bigvgan``), in the
    configuration's precision for its whole life; ``plant``, a context
    that breaks ``models.bigvgan`` underneath for the program's life."""

    def __init__(self, cfg: dict, state: tuple, device, plant=None):
        import dataclasses

        from voicefixer_tpu_torch import config as C
        from voicefixer_tpu_torch.ops.precision import precision
        from voicefixer_tpu_torch.pipeline.vocoder_facade import BigVGAN
        from voicefixer_tpu_torch.utils.weights import convert_bigvgan
        fields = {f.name for f in dataclasses.fields(C.BigVGANConfig)}
        if fields != set(cfg["model"]):
            raise KeyError(f"model section: the program has "
                           f"{sorted(fields - set(cfg['model']))} not in the "
                           f"file, the file has "
                           f"{sorted(set(cfg['model']) - fields)} unknown")
        config = C.BigVGANConfig(**_fields(cfg))
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(precision(cfg["precision"]))
        if plant is not None:
            self._stack.enter_context(plant())
        self.system = BigVGAN(convert_bigvgan(state[0], config), config,
                              device)

    def serve(self, entry, mels: list, kwargs: dict) -> list:
        return entry.call(self.system, mels, kwargs)

    def close(self):
        self.system = None
        self._stack.close()


def program(cfg: dict, state: tuple, device):
    return Program(cfg, state, device)


@contextlib.contextmanager
def _patched(name: str, make):
    """``models.bigvgan.<name>`` replaced by ``make(original)``."""
    from voicefixer_tpu_torch.models import bigvgan
    original = getattr(bigvgan, name)
    setattr(bigvgan, name, make(original))
    try:
        yield
    finally:
        setattr(bigvgan, name, original)


def _no_antialias(original):
    def activation(p, x):
        xf = x.float()
        alpha = torch.exp(p["alpha"].float())
        beta = torch.exp(p["beta"].float())
        return (xf + torch.sin(xf * alpha) ** 2 / (beta + 1e-9)).to(x.dtype)
    return activation


def _beta_ignored(original):
    def activation(p, x):
        return original({"alpha": p["alpha"],
                         "beta": torch.zeros_like(p["beta"])}, x)
    return activation


def _branch_dropped(original):
    def amp_stage(blocks, x, cfg):
        if x.shape[-1] == cfg.upsample_initial_channel >> (FAULT_STAGE + 1):
            blocks = blocks[:-1]
        return original(blocks, x, cfg)
    return amp_stage


def _fault(name, make):
    def factory(cfg, state, device):
        return Program(cfg, state, device, lambda: _patched(name, make))
    return factory


FAULTS = {"no_antialias": _fault("activation", _no_antialias),
          "beta_ignored": _fault("activation", _beta_ignored),
          "branch_dropped": _fault("amp_stage", _branch_dropped)}


# ------------------------------------------------------------- reference

def reference(state: tuple, ns, numerics: str = "fp32"):
    return Reference(state[0], ns, numerics)


def inputs(mix: dict, seed: int, ns, device) -> list:
    """The mix's recordings as log-mels [frames, num_mels], float32."""
    out = []
    for wave in generator.recordings(mix, seed, ns.sampling_rate, device):
        w = torch.as_tensor(wave, device=device)[None]
        out.append(log_mel(w, ns)[0].T.contiguous().cpu().numpy())
    return out


def units(ns, mel) -> tuple:
    a = mel.shape[0] * ns.hop_size / ns.sampling_rate
    return a, a


def compare(ref, own, kept: list, rng, per: int) -> dict:
    """Whole answers: ``rel_err``, ``err_ratio`` with ``own``, and the
    reference's ``clamped_share``."""
    done, wrong = check.pairs(kept)
    err, ratio, nonfinite, clamped, samples = 0.0, 0.0, 0, 0, 0
    for mel, out in done:
        want = ref.restore(mel)
        if out.shape != want.shape:
            wrong += 1
            continue
        nonfinite += int(np.count_nonzero(~np.isfinite(out)))
        clamped += int(np.count_nonzero(np.abs(want) >= 1.0))
        samples += want.size
        e = check.rel(out, want)
        err = max(err, e)
        if own:
            ratio = max(ratio, e / max(check.rel(own.restore(mel), want),
                                       1e-30))
    readings = check.as_readings(err, ratio if own else None, wrong,
                                 nonfinite)
    readings["clamped_share"] = clamped / max(samples, 1)
    return readings


# --------------------------------------------------------------- work

def flops_per_segment(ns) -> float:
    """The frozen analytic FLOPs of one audio second."""
    return bigvgan_flops.bigvgan_flops(ns, ns.sampling_rate / ns.hop_size)


def _stages(ns):
    """(cin, cout, rate, frames an audio second into the stage)."""
    t = ns.sampling_rate / ns.hop_size
    for i, u in enumerate(ns.upsample_rates):
        yield ns.channels[i], ns.channels[i + 1], u, t
        t *= u


def aa_act_functions(ns) -> list:
    """K10's functions of one audio second: 18 a stage at the stage's
    output shape, one at the last."""
    out = []
    n_acts = sum(2 * len(d) for d in ns.resblock_dilation_sizes)
    for _, cout, u, t in _stages(ns):
        fn = (lambda k, t=t * u, c=cout:
              bigvgan_work.snake_aa_work(t * k, c, SIZE))
        out += [(fn, work.PEAK_FP32)] * n_acts
    out.append((fn, work.PEAK_FP32))
    return out


def functions(ns) -> list:
    """One audio second's kernel functions: the six upsamples (K1 on the
    bf16 tensor cores) and the 109 activations (K10)."""
    ups = [(lambda k, t=t, u=u, ci=ci, co=co:
            work.upsample_work(t * k, u, ci, co, SIZE), work.PEAK_BF16)
           for ci, co, u, t in _stages(ns)]
    return ups + aa_act_functions(ns)
