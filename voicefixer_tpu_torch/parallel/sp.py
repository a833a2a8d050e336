"""Time-sharded vocoder synthesis, as ``voicefixer_tpu/parallel/sp.py``: the
generator's time axis cut into one shard per model device, with halo rows
exchanged between neighbours before every ResStack.

The vocoder is narrow (64-512 channels) and long (1.3 M samples per 30 s
chunk), and everything in it is a convolution of finite reach, so each
device takes T/n of every stage and needs only the stage's receptive reach
from its neighbours. One process drives all shards: shard i lives on
``devices[i]``, a neighbour's rows arrive by ``.to(devices[i])``, and the
same device may be listed several times (the shards then run one after the
other on it).

Exactness, piece by piece:
- Interior boundaries: a stage computes on [halo | local | halo] and keeps
  the centre; the halo covers the stage's reach.
- The ends of the signal: absent neighbours give zeros, the convolutions'
  zero 'same' padding.
- The divisibility pad: the pre-conv's output is zero-padded to a multiple
  of the shard count. Those rows are not silence to the generator (biases
  propagate), so every ResStack gets the signal window ``mask_bounds`` and
  treats rows outside it as zero padding at every block. At at most
  ``FUSE_MAX_CHANNELS`` channels that is one ``res_stream`` launch per shard.
- The post-conv's reflection padding touches only the outermost 3 samples
  of the whole waveform, which are recomputed from the first shard's head
  and the last shard's tail.

The per-shard upsample is two matrix products on a = x + sin(x) with a
one-row halo, outside any kernel as in the JAX package (einsums there).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from voicefixer_tpu_torch import kernels
from voicefixer_tpu_torch.config import VocoderConfig, mel_weight_curve
from voicefixer_tpu_torch.kernels.resstack import stack_dilations
from voicefixer_tpu_torch.ops.conv import (conv1d, elu, leaky_relu,
                                          reflection_pad1d)
from voicefixer_tpu_torch.ops.norm import vocoder_normalize_mel
from voicefixer_tpu_torch.ops.precision import activation_dtype
from voicefixer_tpu_torch.utils.weights import tree_map


def exchange_halo(shards: list, h: int) -> list:
    """Per-shard [B, T_loc, C] -> per-shard [B, T_loc + 2h, C]: h rows from
    the neighbours on each side, from as many of them as the halo needs
    (h may exceed T_loc), zeros beyond the two ends. Every shard has the
    same T_loc; the result stays on the shard's device."""
    n = len(shards)
    t_loc = shards[0].shape[1]
    if h == 0:
        return list(shards)
    k = -(-h // t_loc)  # neighbours a side that the halo reaches
    out = []
    for i, x in enumerate(shards):
        def rows(j, part):
            if not 0 <= j < n:
                return x.new_zeros((x.shape[0], part.stop - part.start,
                                    x.shape[2]))
            return shards[j][:, part].to(x.device)
        first = t_loc - (h - (k - 1) * t_loc)  # of the farthest left one
        left = [rows(i - k, slice(first, t_loc))]
        left += [rows(j, slice(0, t_loc)) for j in range(i - k + 1, i)]
        right = [rows(j, slice(0, t_loc)) for j in range(i + 1, i + k)]
        right += [rows(i + k, slice(0, h - (k - 1) * t_loc))]
        out.append(torch.cat(left + [x] + right, dim=1))
    return out


def _upsample_local(params: list, shards: list, scale: int) -> list:
    """The stage's upsample on every shard (``params[j]``: the weights on
    shard j's device): with one halo row a side, the
    local output rows are z[p : p + s*T_loc] of the polyphase form
    z[(m + q0)*s + rho] = a[m] @ W[rho] + a[m-1] @ W[rho + s], the
    ConvTranspose1d(k=2s, stride s, padding p = s//2 + s%2, output padding
    s%2) of ``kernels.upsample``, with its rounding: a in x's type, float32
    sums, one cast. Rows beyond the signal are zeros, x + sin(x) keeps
    them zero, and they stand for the transposed conv's absent taps."""
    s = scale
    pad = s // 2 + s % 2
    out = []
    for p, xe in zip(params, exchange_halo(shards, 1)):
        w, b = p["w"].float(), p["b"].float()  # [2s, Cin, Cout], [Cout]
        cout = w.shape[2]
        xf = xe.float()
        a = (xf + torch.sin(xf)).to(xe.dtype).float()
        t_loc = xe.shape[1] - 2
        z = (torch.einsum("btc,rco->btro", a[:, 1:], w[:s])
             + torch.einsum("btc,rco->btro", a[:, :-1], w[s:]))
        z = z.reshape(xe.shape[0], (t_loc + 1) * s, cout)
        out.append((z[:, pad: pad + s * t_loc] + b).to(xe.dtype))
    return out


def _on(params, device):
    return tree_map(lambda t: t.to(device), params)


def apply_sp(params: dict, mel: torch.Tensor, cfg: VocoderConfig,
             devices) -> torch.Tensor:
    """``models.vocoder.apply`` with the four stages and the post-conv cut
    into len(devices) time shards: mel [B, T, n_mels] (normalized, +-4,
    tail-padded) -> wav [B, T*441, 1] on mel's device. The condnet and the
    pre-conv (global context, a few percent of the work) run once, on mel's
    device. ``params`` may be one tree (moved to each device as needed) or a
    list of per-device copies."""
    from voicefixer_tpu_torch.models.vocoder import _res_stack
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    per_dev = (list(params) if isinstance(params, (list, tuple))
               else [_on(params, d) for d in devices])
    adt = activation_dtype()
    if adt != mel.dtype:
        per_dev = [tree_map(lambda t: t.to(adt), p) for p in per_dev]
    p0 = _on(per_dev[0], mel.device)
    x = mel.to(adt)
    for layer in p0["condnet"]:
        x = elu(conv1d(x, layer["w"], layer["b"], padding=1))
    x = conv1d(reflection_pad1d(x, 3), p0["pre"]["w"], p0["pre"]["b"])
    x = leaky_relu(x, cfg.leaky_slope_act)

    t0 = x.shape[1]
    t_loc = -(-t0 // n)
    x = F.pad(x, (0, 0, 0, t_loc * n - t0))
    shards = [x[:, i * t_loc: (i + 1) * t_loc].to(d)
              for i, d in enumerate(devices)]
    rate = 1
    for i, s in enumerate(cfg.upsample_scales):
        shards = _upsample_local([p["stages"][i]["up"] for p in per_dev],
                                 shards, s)
        t_loc *= s
        rate *= s
        dils = stack_dilations(cfg.resstack_depth[i])
        h = -(-sum(d + 1 for d in dils) // 8) * 8
        ext = exchange_halo(shards, h)
        for j, xe in enumerate(ext):
            # the signal [0, t0*rate) in the rows of this shard's array
            lo = h - j * t_loc
            with kernels.current_device(xe.device):
                y, activated = _res_stack(
                    per_dev[j]["stages"][i]["res"], xe,
                    cfg.resstack_kernel[i], cfg.leaky_slope_res,
                    final_slope=cfg.leaky_slope_act,
                    mask_bounds=(lo, lo + t0 * rate))
            if not activated:
                y = leaky_relu(y, cfg.leaky_slope_act)
            shards[j] = y[:, h: h + t_loc]

    # post-conv with a zero halo; the reflected ends are patched below
    w_post, b_post = p0["post"]["w"].float(), p0["post"]["b"].float()
    pad_post = (w_post.shape[0] - 1) // 2
    parts = []
    for xe in exchange_halo(shards, pad_post):
        y = conv1d(xe.float(), w_post.to(xe.device), b_post.to(xe.device))
        parts.append(torch.tanh(y).to(mel.device))
    total = t0 * rate
    wav = torch.cat(parts, dim=1)[:, :total]

    def patch(edge, left: bool):
        xp = reflection_pad1d(edge.to(mel.device).float(), pad_post)
        seg = xp[:, : 3 * pad_post] if left else xp[:, -3 * pad_post:]
        return torch.tanh(conv1d(seg, w_post, b_post))

    end = total - (n - 1) * t_loc  # the signal's end inside the last shard
    wav[:, :pad_post] = patch(shards[0][:, :8], True)
    wav[:, total - pad_post:] = patch(shards[-1][:, end - 8: end], False)
    return wav.to(mel.dtype)


def synthesize_sp(params: dict, mel: torch.Tensor, cfg: VocoderConfig,
                  devices) -> torch.Tensor:
    """``pipeline.vocoder_facade.synthesize`` through ``apply_sp``: linear
    analysis-convention mel [B, T, 128] -> wav [B, S, 1]."""
    from voicefixer_tpu_torch.pipeline.vocoder_facade import pad_tail
    w = torch.as_tensor(mel_weight_curve(cfg.num_mels), dtype=mel.dtype,
                        device=mel.device)
    mel = vocoder_normalize_mel(mel / w, cfg)
    mel = pad_tail(mel, -cfg.max_abs_value)
    return apply_sp(params, mel, cfg, devices)
