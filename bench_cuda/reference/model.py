"""VoiceFixer at 44.1 kHz in plain PyTorch: the benchmark's reference.

It reads the upstream-layout state dicts (``vf.ckpt``'s
``generator.denoiser.*`` and ``generator.unet.*``, the vocoder
generator's keys with weight norm) directly, in upstream's NCHW / NCT
layouts, with ``torch.stft``, ``nn.GRU`` and the ``torch.nn.functional``
convolutions. It imports nothing of the program. The mathematics is the
JAX package's formulation of upstream, which the program is held to in the
repository's tests:

- analysis: |STFT| (periodic Hann, centred, reflect pad) with a power floor,
  an htk mel filterbank without normalisation; the denoiser's scalar batch
  norms, linears and two 2-layer bidirectional GRUs ending in a sigmoid
  mask; the 6-level residual U-Net on [log mel, log masked mel], time
  padded to a multiple of 64 with zeros and the top frequency bin dropped
  and restored;
- synthesis: the mel divided by upstream's fitted weight curve, dB
  normalised to +-4, tail-padded by T % 2 + 4 frames of -4; the condnet, a
  reflect-padded pre-conv; four stages of x + sin(x), a transposed
  convolution (kernel 2s, stride s) and eight residual blocks at
  dilations 3^i; a reflect-padded post-conv and tanh;
- the pipeline (upstream ``restore_inmem``, mode 0): 30 s segments, a
  short or tail segment zero-padded to a full one, a segment whose peak
  exceeds 1 divided by it, the output centre-trimmed to the segment, a
  padded segment cut to its own length, the segments concatenated.

``numerics`` is the precision it computes in: "fp32" (float32, TF32 off:
the reference); "tf32", one step below float32, which rounds every
product's operands to TF32 (10-bit mantissa, float32 accumulation);
"bf16", production precision's own storage, which rounds to bfloat16
what the program stores in it (the U-Net's and the vocoder's parameters,
with the batch norms folded to a scale and a shift, and their
activations; the GRUs' recurrent weights);
"fp8", one step below that, the same places in float8 e4m3 with a
per-tensor scale. The GRUs' state is not rounded between steps in any
(``nn.GRU`` keeps it in float32).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

NUMERICS = ("fp32", "tf32", "bf16", "fp8")
# upstream's fitted curve between the analysis mel and the vocoder's
# librosa mel (voicefixer/tools/mel_scale.py: 18.89 * exp(0.02699 x))
MEL_WEIGHT = (18.8927416350036, 0.0269863588184314)
LOG10 = math.log(10.0)
E4M3_MAX = 448.0


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10-bit mantissa, to nearest, ties away from
    zero, as the tensor cores convert."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with a per-tensor scale to its range."""
    x = x.float()
    scale = x.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


@contextlib.contextmanager
def tf32_disabled():
    """Full float32 products and convolutions on a card."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                   sample_rate: int) -> np.ndarray:
    """Triangular filters on the htk mel scale, not normalised, [n_freqs,
    n_mels] float32: filter m rises from point m to m + 1 and falls to
    m + 2 of n_mels + 2 points equally spaced in mel."""
    freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    pts = mel_to_hz(np.linspace(hz_to_mel(f_min), hz_to_mel(f_max),
                                n_mels + 2))
    fb = np.zeros((n_freqs, n_mels))
    for m in range(n_mels):
        rise = (freqs - pts[m]) / (pts[m + 1] - pts[m])
        fall = (pts[m + 2] - freqs) / (pts[m + 2] - pts[m + 1])
        fb[:, m] = np.maximum(0.0, np.minimum(rise, fall))
    return fb.astype(np.float32)


def weight_norm(sd: dict, prefix: str) -> torch.Tensor:
    """A convolution's weight, with weight norm folded in float64: g * v /
    ||v||, the norm over every dim but dim 0."""
    if f"{prefix}.weight" in sd:
        return sd[f"{prefix}.weight"].float()
    g, v = sd[f"{prefix}.weight_g"].double(), sd[f"{prefix}.weight_v"].double()
    norm = v.pow(2).sum(dim=tuple(range(1, v.ndim)), keepdim=True).sqrt()
    return (g * v / norm).float()


class Reference:
    """analysis, vocoder: the upstream-layout state dicts (float32 tensors
    on one device); cfg: the configuration (``model_config.namespace``)."""

    def __init__(self, analysis: dict, vocoder: dict, cfg,
                 numerics: str = "fp32"):
        if numerics not in NUMERICS:
            raise ValueError(f"numerics {numerics!r}: one of {NUMERICS}")
        self.a, self.cfg, self.numerics = analysis, cfg, numerics
        self.device = next(iter(v for v in analysis.values()
                                if isinstance(v, torch.Tensor))).device
        self.v = {k: weight_norm(vocoder, k[:-len(".weight_g")])
                  for k in vocoder if k.endswith(".weight_g")}
        self.v = {k[:-len(".weight_g")] + ".weight": w
                  for k, w in self.v.items()}
        self.v.update({k: t for k, t in vocoder.items()
                       if k.endswith(".bias") or k.endswith(".weight")})
        m = cfg.mel
        self.fb = torch.as_tensor(mel_filterbank(
            m.n_stft, m.f_min, m.f_max, m.n_mels, m.sample_rate),
            device=self.device)
        self.grus = [self._gru(f"generator.denoiser.{i}.gru")
                     for i in (7, 8)]

    # --------------------------------------------------------- numerics
    def q(self, x: torch.Tensor, part: str) -> torch.Tensor:
        """x as the operands of a product in ``part`` ("analysis" for the
        STFT's mel and the denoiser's linears, "gru_ih", "gru_hh", "unet",
        "vocoder") are rounded under this reference's numerics."""
        if self.numerics == "tf32":
            return _round_tf32(x)
        if part in ("gru_hh", "unet", "vocoder"):
            if self.numerics == "bf16":
                return _round_bf16(x)
            if self.numerics == "fp8":
                return _round_fp8(x)
        return x

    def store(self, x: torch.Tensor, part: str) -> torch.Tensor:
        """An activation of ``part`` as the program stores it: rounded in
        "bf16" and "fp8" (the U-Net's and the vocoder's: every
        convolution's and batch norm's output, residual sum, pooling and
        stage activation), kept otherwise."""
        return self.q(x, part) if self.numerics in ("bf16", "fp8") else x

    # --------------------------------------------------------- analysis
    def wav_to_mel(self, wav: torch.Tensor) -> torch.Tensor:
        """[B, N] -> linear mel [B, T, n_mels]."""
        s = self.cfg.stft
        window = torch.hann_window(s.win_length, periodic=True,
                                   device=wav.device)
        spec = torch.stft(wav.float(), s.n_fft, s.hop_length, s.win_length,
                          window, center=s.center, pad_mode=s.pad_mode,
                          return_complex=True)
        power = spec.real ** 2 + spec.imag ** 2
        mag = torch.sqrt(torch.clamp(power, min=s.mag_eps)).transpose(1, 2)
        return self.q(mag, "analysis") @ self.q(self.fb, "analysis")

    def _bn_scalar(self, x, prefix):
        a = self.a
        return ((x - a[f"{prefix}.running_mean"])
                / torch.sqrt(a[f"{prefix}.running_var"] + 1e-5)
                * a[f"{prefix}.weight"] + a[f"{prefix}.bias"])

    def _linear(self, x, prefix):
        return (self.q(x, "analysis") @ self.q(self.a[f"{prefix}.weight"],
                                               "analysis").T
                + self.a[f"{prefix}.bias"])

    def _gru(self, prefix) -> torch.nn.GRU:
        d = self.cfg.denoiser
        u = d.base_width
        gru = torch.nn.GRU(2 * u, u, num_layers=d.gru_layers,
                           bidirectional=True, batch_first=True).to(
                               self.device)
        with torch.no_grad():
            for name, p in gru.named_parameters():
                part = "gru_hh" if "_hh_" in name else "gru_ih"
                w = self.a[f"{prefix}.{name}"]
                p.copy_(self.q(w, part) if name.startswith("weight") else w)
        return gru.eval()

    def denoiser(self, mel: torch.Tensor) -> torch.Tensor:
        """Linear mel [B, T, n_mel] -> sigmoid mask (eval: running
        statistics, no dropout)."""
        p = "generator.denoiser"
        x = self._bn_scalar(mel, f"{p}.0")
        x = torch.relu(self._linear(x, f"{p}.1"))
        x = self._bn_scalar(x, f"{p}.3")
        x = torch.relu(self._linear(x, f"{p}.4"))
        for i, gru in zip((7, 8), self.grus):
            x = self._bn_scalar(x, f"{p}.{i}.bn")
            x = gru(self.q(x, "gru_ih"))[0]
        x = torch.relu(self._bn_scalar(x, f"{p}.9"))
        x = self._linear(x, f"{p}.11")
        x = torch.relu(self._bn_scalar(x, f"{p}.13"))
        return torch.sigmoid(self._linear(x, f"{p}.15"))

    def _bn(self, x, prefix):
        """Eval batch norm as x * scale + shift per channel, its two
        parameters and each step stored as the U-Net stores them."""
        a = self.a
        scale = a[f"{prefix}.weight"] / torch.sqrt(
            a[f"{prefix}.running_var"] + self.cfg.unet.bn_eps)
        shift = a[f"{prefix}.bias"] - a[f"{prefix}.running_mean"] * scale
        x = self.store(x * self.q(scale, "unet")[:, None, None], "unet")
        return self.store(x + self.q(shift, "unet")[:, None, None], "unet")

    def _conv2d(self, x, prefix, padding=0, bias=False):
        w = self.a[f"{prefix}.weight"]
        b = self.q(self.a[f"{prefix}.bias"], "unet") if bias else None
        return self.store(F.conv2d(self.q(x, "unet"), self.q(w, "unet"), b,
                                   padding=padding), "unet")

    def _block(self, x, prefix):
        """ConvBlockRes: BN, LeakyReLU, 3x3 conv, twice, plus x or a 1x1
        shortcut of x."""
        slope = self.cfg.unet.leaky_slope
        h = F.leaky_relu(self._bn(x, f"{prefix}.bn1"), slope)
        h = self._conv2d(h, f"{prefix}.conv1", padding=1)
        h = F.leaky_relu(self._bn(h, f"{prefix}.bn2"), slope)
        h = self._conv2d(h, f"{prefix}.conv2", padding=1)
        if f"{prefix}.shortcut.weight" in self.a:
            x = self._conv2d(x, f"{prefix}.shortcut", bias=True)
        return self.store(x + h, "unet")

    def resunet(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 2, T, F] -> [B, T, F]."""
        u, p = self.cfg.unet, "generator.unet"
        t = x.shape[2]
        ratio = 2 ** len(u.encoder_channels)
        x = F.pad(x, (0, 0, 0, math.ceil(t / ratio) * ratio - t))[..., :-1]
        skips = []
        for i in range(1, len(u.encoder_channels) + 1):
            for j in range(1, u.blocks_per_stage + 1):
                x = self._block(x, f"{p}.encoder_block{i}.conv_block{j}")
            skips.append(x)
            x = self.store(F.avg_pool2d(x, 2), "unet")
        x = self._block(x, f"{p}.conv_block7")
        for i in range(1, len(u.encoder_channels) + 1):
            q = f"{p}.decoder_block{i}"
            h = torch.relu(self._bn(x, f"{q}.bn1"))
            h = self.store(F.conv_transpose2d(
                self.q(h, "unet"), self.q(self.a[f"{q}.conv1.weight"],
                                          "unet"), stride=2), "unet")
            x = torch.cat([h[:, :, :-1], skips[-i]], dim=1)
            for j in range(2, u.blocks_per_stage + 2):
                x = self._block(x, f"{q}.conv_block{j}")
        x = self._block(x, f"{p}.after_conv_block1")
        x = self._conv2d(x, f"{p}.after_conv2", bias=True)
        return F.pad(x, (0, 1))[:, 0, :t]

    def analysis(self, wav: torch.Tensor) -> torch.Tensor:
        """[B, N] -> the restored linear mel [B, T, n_mels]."""
        mel = self.wav_to_mel(wav)
        clean = self.denoiser(mel) * mel
        log_clean = torch.log10(torch.clamp(clean, min=1e-8))
        x = torch.stack([torch.log10(torch.clamp(mel, min=1e-8)),
                         log_clean], dim=1)
        log_mel = self.resunet(x) + log_clean
        return torch.pow(10.0, torch.clamp(log_mel, max=5.0))

    # -------------------------------------------------------- synthesis
    def _conv1d(self, x, prefix, padding=0, dilation=1, store=True):
        y = F.conv1d(self.q(x, "vocoder"),
                     self.q(self.v[f"{prefix}.weight"], "vocoder"),
                     self.q(self.v[f"{prefix}.bias"], "vocoder"),
                     padding=padding, dilation=dilation)
        return self.store(y, "vocoder") if store else y

    def vocoder(self, mel: torch.Tensor) -> torch.Tensor:
        """Linear mel [B, T, n_mels] in the analysis convention -> wave
        [B, (T + T % 2 + 4) * hop]."""
        v = self.cfg.vocoder
        n = v.num_mels
        curve = torch.as_tensor(
            MEL_WEIGHT[0] * np.exp(MEL_WEIGHT[1] * np.linspace(1, n, n)),
            dtype=torch.float32, device=mel.device)
        mel = (mel / curve).abs()
        db = 20.0 * torch.log10(torch.clamp(
            mel, min=10.0 ** (v.min_level_db / 20.0))) - v.ref_level_db
        m = v.max_abs_value
        x = torch.clamp(2 * m * (db - v.min_db) / (-v.min_db) - m, -m, m)
        t = x.shape[1]
        x = F.pad(x.transpose(1, 2), (0, t % 2 + 4), value=-m)  # [B, n, T']
        for i in (0, 2, 4, 6, 8):
            x = self.store(F.elu(self._conv1d(x, f"condnet.{i}",
                                              padding=1)), "vocoder")
        x = self._conv1d(F.pad(x, (3, 3), mode="reflect"), "generator.1")
        x = self.store(F.leaky_relu(x, v.leaky_slope_act), "vocoder")
        for i, s in enumerate(v.upsample_scales):
            up = f"generator.{3 + 3 * i}.layer"
            x = self.store(F.conv_transpose1d(
                self.q(x + torch.sin(x), "vocoder"),
                self.q(self.v[f"{up}.weight"], "vocoder"),
                self.q(self.v[f"{up}.bias"], "vocoder"), stride=s, padding=s // 2 + s % 2,
                output_padding=s % 2), "vocoder")
            for b in range(v.resstack_depth[i]):
                q = f"generator.{4 + 3 * i}.layers.{b}"
                d = 3 ** (b % 10)
                h = F.leaky_relu(x, v.leaky_slope_res)
                h = self._conv1d(h, f"{q}.1", padding=d, dilation=d)
                h = F.leaky_relu(h, v.leaky_slope_res)
                x = self.store(x + self._conv1d(h, f"{q}.3", padding=1),
                               "vocoder")
            x = self.store(F.leaky_relu(x, v.leaky_slope_act), "vocoder")
        post = f"generator.{4 + 3 * len(v.upsample_scales)}"
        # the post-conv accumulates and returns float32 in every precision
        x = self._conv1d(F.pad(x, (3, 3), mode="reflect"), post, store=False)
        return torch.tanh(x)[:, 0]

    # --------------------------------------------------------- pipeline
    def restore_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """Full segments [B, N] -> restored [B, N]: peak-capped, centre
        trimmed to N."""
        with tf32_disabled(), torch.inference_mode():
            out = self.vocoder(self.analysis(rows))
            peaks = out.abs().amax(dim=-1, keepdim=True)
            out = torch.where(peaks > 1.0, out / peaks, out)
            return center_trim(out, rows.shape[-1])

    def restore(self, wav: np.ndarray, block: int = 8) -> np.ndarray:
        """Upstream ``restore_inmem`` in mode 0: wav [N] -> [N], segments in
        blocks of ``block`` rows."""
        seg = self.cfg.pipeline.seg_length
        wav = np.asarray(wav, np.float32).reshape(-1)
        starts = list(range(0, wav.shape[0], seg))
        out = []
        for i in range(0, len(starts), block):
            rows = [pad_to(wav[s: s + seg], seg) for s in starts[i: i + block]]
            res = self.restore_rows(torch.as_tensor(
                np.stack(rows), device=self.device)).cpu().numpy()
            out += [r[: min(seg, wav.shape[0] - s)]
                    for r, s in zip(res, starts[i: i + block])]
        return np.concatenate(out)


def pad_to(x: np.ndarray, n: int) -> np.ndarray:
    return np.pad(x, (0, n - x.shape[0])) if x.shape[0] < n else x


def center_trim(x: torch.Tensor, n: int) -> torch.Tensor:
    """x's last axis cut to n: half the excess from each end, the odd
    sample from the tail."""
    excess = x.shape[-1] - n
    if excess <= 0:
        return x
    return x[..., excess // 2: excess // 2 + n]
