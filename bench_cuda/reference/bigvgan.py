"""BigVGAN-v2 44 kHz (128 bands, 512x) in plain PyTorch: the benchmark's
reference for the ``bigvgan`` family.

It reads upstream's generator state dict (NVIDIA/BigVGAN ``bigvgan.py``:
``conv_pre``, ``ups.{i}.0``, ``resblocks.{n}.convs1.{m}`` / ``convs2.{m}``
/ ``activations.{a}.act.alpha|beta``, ``activation_post``, ``conv_post``,
weight norm as weight_g / weight_v or parametrizations) in upstream's
[B, C, T] layout, with
``F.conv1d``, ``F.conv_transpose1d`` and ``F.pad(mode="replicate")``, and
imports nothing of the program. The equations:

- the log-mel front end (``meldataset.mel_spectrogram``): reflect pad
  (n_fft - hop) / 2, ``torch.stft`` (Hann, ``center=False``), magnitude
  sqrt(re^2 + im^2 + 1e-9), librosa's Slaney mel basis (``fmax`` None: the
  Nyquist), log(clamp(x, 1e-5)): floor(N / hop) frames;
- ``conv_pre`` k7 padding 3; per stage the transposed conv (kernel k,
  stride u, padding (k - u) / 2), then the mean of the stage's AMPBlock1;
- AMPBlock1 of kernel k: for each dilation d, xt = A(x), conv at d
  (padding d (k - 1) / 2), A, conv (padding (k - 1) / 2), x = x + xt;
- A, ``Activation1d(SnakeBeta)``: 2x up (replicate pad 5, 2 times the
  grouped transposed conv of stride 2 by the 12-tap Kaiser sinc filter,
  crop 15 a side), x + sin^2(x alpha) / (beta + 1e-9) with alpha and beta
  the exponentials of the parameters, 2x down (replicate pad (5, 6), the
  grouped conv of stride 2 by the same filter);
- A, ``conv_post`` k7 padding 3 without bias, clamp to [-1, 1].

Departures from upstream: the Kaiser filter is computed here, not read
from the state dict's buffers (they hold the same numbers); a state dict
without weight norm (plain ``weight``) is read too.

``numerics`` is the precision it computes in: "fp32" (float32, TF32 off:
the reference); "bf16", production precision's own storage, which rounds to bfloat16 what the program stores in it (every
weight, bias and SnakeBeta parameter; the mel, and every convolution's,
upsample's and activation's output, residual sum, partial sum and mean of
the AMP blocks); "fp8", one step below that, the same places in float8
e4m3 with a per-tensor scale. ``conv_post`` takes its input exact and
returns float32 in every one, as the program's does.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

NUMERICS = ("fp32", "bf16", "fp8")
E4M3_MAX = 448.0
SNAKE_EPS = 1e-9
LOG_FLOOR = 1e-5


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with a per-tensor scale to its range."""
    x = x.float()
    scale = x.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


ROUND = {"fp32": lambda x: x,
         "bf16": lambda x: x.to(torch.bfloat16).float(), "fp8": _round_fp8}


# ------------------------------------------------------------ front end

def _hz_to_mel(f):
    """librosa's Slaney mel scale: linear to 1 kHz, logarithmic above."""
    f = np.asarray(f, np.float64)
    f_sp, min_hz = 200.0 / 3, 1000.0
    logstep = math.log(6.4) / 27.0
    return np.where(f >= min_hz, min_hz / f_sp
                    + np.log(np.maximum(f, 1e-10) / min_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f_sp, min_hz = 200.0 / 3, 1000.0
    min_mel, logstep = min_hz / f_sp, math.log(6.4) / 27.0
    return np.where(m >= min_mel, min_hz * np.exp(logstep * (m - min_mel)),
                    f_sp * m)


def slaney_mel_basis(sr: int, n_fft: int, n_mels: int, fmin: float,
                     fmax: float | None) -> np.ndarray:
    """``librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax)`` (htk False,
    norm "slaney"), float32 [n_mels, 1 + n_fft // 2]."""
    fmax = sr / 2.0 if fmax is None else fmax
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                   n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = np.subtract.outer(mel_f, fftfreqs)
    weights = np.zeros((n_mels, 1 + n_fft // 2))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.astype(np.float32)


def log_mel(wave: torch.Tensor, ns) -> torch.Tensor:
    """[B, N] float32 -> log-mel [B, num_mels, floor(N / hop)], upstream's
    ``mel_spectrogram`` (``ns``: the configuration's fields)."""
    basis = torch.as_tensor(slaney_mel_basis(
        ns.sampling_rate, ns.n_fft, ns.num_mels, ns.fmin, ns.fmax),
        device=wave.device)
    pad = (ns.n_fft - ns.hop_size) // 2
    y = F.pad(wave[:, None], (pad, pad), mode="reflect")[:, 0]
    window = torch.hann_window(ns.win_size, device=wave.device)
    spec = torch.stft(y, ns.n_fft, hop_length=ns.hop_size,
                      win_length=ns.win_size, window=window, center=False,
                      return_complex=True)
    mag = torch.sqrt(torch.view_as_real(spec).pow(2).sum(-1) + 1e-9)
    return torch.log(torch.clamp(basis @ mag, min=LOG_FLOOR))


# ----------------------------------------------------------- the filter

def kaiser_sinc_filter1d(cutoff: float, half_width: float,
                         kernel_size: int) -> torch.Tensor:
    """Upstream's ``alias_free_activation/torch/filter.py``: [1, 1, k]."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    amp = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if amp > 50.0:
        beta = 0.1102 * (amp - 8.7)
    elif amp >= 21.0:
        beta = 0.5842 * (amp - 21) ** 0.4 + 0.07886 * (amp - 21.0)
    else:
        beta = 0.0
    window = torch.kaiser_window(kernel_size, beta=beta, periodic=False)
    if even:
        time = torch.arange(-half_size, half_size) + 0.5
    else:
        time = torch.arange(kernel_size) - half_size
    x = 2 * cutoff * time
    sinc = torch.where(x == 0, torch.tensor(1.0),
                       torch.sin(math.pi * x) / math.pi / x)
    filt = 2 * cutoff * window * sinc
    filt /= filt.sum()
    return filt.view(1, 1, kernel_size)


FILTER = kaiser_sinc_filter1d(0.25, 0.3, 12)  # ratio 2, kernel 12


def weight_norm(sd: dict, prefix: str) -> torch.Tensor:
    """A convolution's weight, weight norm folded in float64: g v / ||v||,
    the norm over every dim but dim 0, from weight_g / weight_v or
    parametrizations.weight.original0 / 1."""
    if f"{prefix}.weight" in sd:
        return sd[f"{prefix}.weight"].float()
    g_key, v_key = f"{prefix}.weight_g", f"{prefix}.weight_v"
    if g_key not in sd:
        g_key = f"{prefix}.parametrizations.weight.original0"
        v_key = f"{prefix}.parametrizations.weight.original1"
    g, v = sd[g_key].double(), sd[v_key].double()
    norm = v.pow(2).sum(dim=tuple(range(1, v.ndim)), keepdim=True).sqrt()
    return (g * v / norm).float()


class Reference:
    """state: upstream's generator state dict (float32 tensors on one
    device; other entries, such as the filter buffers as numpy arrays,
    are not read); ns: the configuration (``families/bigvgan.namespace``)."""

    def __init__(self, state: dict, ns, numerics: str = "fp32"):
        if numerics not in NUMERICS:
            raise ValueError(f"numerics {numerics!r}: one of {NUMERICS}")
        self.ns, self.numerics = ns, numerics
        tensors = {k: v for k, v in state.items()
                   if isinstance(v, torch.Tensor)}
        self.device = next(iter(tensors.values())).device
        r = ROUND[numerics]
        self.p = {}
        for k, v in tensors.items():
            for g in (".weight_g", ".parametrizations.weight.original0"):
                if k.endswith(g):
                    prefix = k[:-len(g)]
                    self.p[prefix + ".weight"] = r(weight_norm(tensors,
                                                               prefix))
            if k.endswith((".bias", ".weight", ".alpha", ".beta")):
                self.p[k] = r(v.float())
        self.filter = FILTER.to(self.device)

    # --------------------------------------------------------- numerics
    def store(self, x: torch.Tensor) -> torch.Tensor:
        """An activation as the program stores it."""
        return ROUND[self.numerics](x)

    def conv(self, x, prefix, padding, dilation=1, bias=True):
        b = self.p[f"{prefix}.bias"] if bias else None
        return F.conv1d(x, self.p[f"{prefix}.weight"], b, padding=padding,
                        dilation=dilation)

    # ------------------------------------------------------------ model
    def activation(self, x, prefix):
        """Activation1d(SnakeBeta) on [B, C, T]."""
        c = x.shape[1]
        f = self.filter.expand(c, -1, -1)
        u = F.pad(x, (5, 5), mode="replicate")
        u = 2 * F.conv_transpose1d(u, f, stride=2, groups=c)[..., 15:-15]
        alpha = torch.exp(self.p[f"{prefix}.act.alpha"])[None, :, None]
        beta = torch.exp(self.p[f"{prefix}.act.beta"])[None, :, None]
        u = u + (1.0 / (beta + SNAKE_EPS)) * torch.sin(u * alpha) ** 2
        u = F.pad(u, (5, 6), mode="replicate")
        return self.store(F.conv1d(u, f, stride=2, groups=c))

    def amp_block(self, x, prefix, k, dilations):
        for m, d in enumerate(dilations):
            xt = self.activation(x, f"{prefix}.activations.{2 * m}")
            xt = self.store(self.conv(xt, f"{prefix}.convs1.{m}",
                                      d * (k - 1) // 2, d))
            xt = self.activation(xt, f"{prefix}.activations.{2 * m + 1}")
            xt = self.store(self.conv(xt, f"{prefix}.convs2.{m}",
                                      (k - 1) // 2))
            x = self.store(x + xt)
        return x

    def generate(self, mel: torch.Tensor) -> torch.Tensor:
        """log-mel [B, num_mels, T] -> wave [B, T * hop], float32."""
        ns = self.ns
        x = self.store(mel.float())
        x = self.store(self.conv(x, "conv_pre", 3))
        n_k = len(ns.resblock_kernel_sizes)
        for i, (u, k) in enumerate(zip(ns.upsample_rates,
                                       ns.upsample_kernel_sizes)):
            x = self.store(F.conv_transpose1d(
                x, self.p[f"ups.{i}.0.weight"], self.p[f"ups.{i}.0.bias"],
                stride=u, padding=(k - u) // 2))
            xs = None
            for j, (kr, dils) in enumerate(zip(ns.resblock_kernel_sizes,
                                               ns.resblock_dilation_sizes)):
                y = self.amp_block(x, f"resblocks.{i * n_k + j}", kr, dils)
                xs = y if xs is None else self.store(xs + y)
            x = self.store(xs / n_k)
        x = self.activation(x, "activation_post")
        x = self.conv(x, "conv_post", 3, bias=False)
        return torch.clamp(x[:, 0], -1.0, 1.0)

    @torch.no_grad()
    def restore(self, mel) -> np.ndarray:
        """One log-mel [T, num_mels] (numpy) -> its wave [T * hop]."""
        m = torch.as_tensor(np.asarray(mel), device=self.device)
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return self.generate(m.T[None])[0].cpu().numpy()
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev
