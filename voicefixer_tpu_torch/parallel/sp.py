"""Time-sharded vocoder synthesis, as ``voicefixer_tpu/parallel/sp.py``: the
generator's time axis cut into one shard per model rank, with halo rows
exchanged between neighbours before every ResStack.

The vocoder is narrow (64-512 channels) and long (1.3 M samples per 30 s
chunk), and everything in it is a convolution of finite reach, so each
shard takes T/n of every stage and needs only the stage's receptive reach
from its neighbours. Two forms:

- across processes (``mesh=``): one process per card, each holding only its
  own time shard; halo rows move between neighbouring ranks of the mesh's
  "model" group by ``torch.distributed.batch_isend_irecv`` (NCCL on the
  cards, gloo on the CPU), and the waveform is all-gathered so that every
  rank returns all of it. The condnet and the pre-conv (global context, a
  few percent of the work) run on every rank.
- in one process (``devices=``): shard i lives on ``devices[i]``, a
  neighbour's rows arrive by ``.to(devices[i])``, and the same device may
  be listed several times (the shards then run one after the other on it).

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
  of the whole waveform, which are recomputed from the signal's first and
  last 8 rows of the last stage, wherever they lie.

The per-shard upsample is two matrix products on a = x + sin(x) with a
one-row halo, outside any kernel as in the JAX package (einsums there).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from voicefixer_tpu_torch import kernels
from voicefixer_tpu_torch.config import VocoderConfig, mel_weight_curve
from voicefixer_tpu_torch.kernels.resstack import stack_dilations
from voicefixer_tpu_torch.ops.conv import (conv1d, elu, leaky_relu,
                                          reflection_pad1d)
from voicefixer_tpu_torch.ops.norm import vocoder_normalize_mel
from voicefixer_tpu_torch.ops.precision import activation_dtype
from voicefixer_tpu_torch.parallel.mesh import (axis_group, axis_rank,
                                                axis_size)
from voicefixer_tpu_torch.utils.weights import tree_map


def exchange_halo(shards, h: int, mesh=None):
    """Per-shard [B, T_loc, C] -> per-shard [B, T_loc + 2h, C]: h rows from
    the neighbours on each side, from as many of them as the halo needs
    (h may exceed T_loc), zeros beyond the two ends. Every shard has the
    same T_loc. With ``mesh``, ``shards`` is this rank's shard (a tensor),
    its neighbours the adjacent ranks of the "model" group; without, a list
    of every shard, each result on its shard's device."""
    if mesh is not None:
        return _exchange_halo_ranks(shards, h, mesh)
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


def _exchange_halo_ranks(x: torch.Tensor, h: int, mesh) -> torch.Tensor:
    """``exchange_halo`` across processes, as the JAX package's ppermutes:
    k = ceil(h / T_loc) rounds, each sending what the last one received on
    to the next rank (in one round, only the h rows the neighbour needs).
    An end rank receives zeros from beyond the signal's end."""
    n, r = axis_size(mesh, "model"), axis_rank(mesh, "model")
    if h == 0:
        return x
    if n == 1:
        return F.pad(x, (0, 0, h, h))
    group = axis_group(mesh, "model")
    t_loc = x.shape[1]
    k = -(-h // t_loc)
    lcur, rcur = (x[:, t_loc - h:], x[:, :h]) if k == 1 else (x, x)
    lblocks, rblocks = [], []
    for _ in range(k):
        lnew, rnew = torch.zeros_like(lcur), torch.zeros_like(rcur)
        ops = []
        if r > 0:  # my rows go left, the left neighbour's come in
            peer = dist.get_global_rank(group, r - 1)
            ops += [dist.P2POp(dist.isend, rcur.contiguous(), peer, group),
                    dist.P2POp(dist.irecv, lnew, peer, group)]
        if r < n - 1:
            peer = dist.get_global_rank(group, r + 1)
            ops += [dist.P2POp(dist.isend, lcur.contiguous(), peer, group),
                    dist.P2POp(dist.irecv, rnew, peer, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        lcur, rcur = lnew, rnew
        lblocks.insert(0, lcur)
        rblocks.append(rcur)
    lcat, rcat = torch.cat(lblocks, dim=1), torch.cat(rblocks, dim=1)
    return torch.cat([lcat[:, lcat.shape[1] - h:], x, rcat[:, :h]], dim=1)


def _upsample_local(params: list, shards: list, scale: int,
                    exchange=exchange_halo) -> list:
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
    for p, xe in zip(params, exchange(shards, 1)):
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


def _rows(shards: list, first: int, t_loc: int, start: int, count: int,
          device, group) -> torch.Tensor:
    """Rows [start, start + count) of the whole signal in float32 on
    ``device``, from the local shards (shard j holds rows from
    (first + j) * t_loc on); with ``group``, summed over it, so that every
    rank has them wherever they lie."""
    x0 = shards[0]
    out = torch.zeros((x0.shape[0], count, x0.shape[2]), device=device)
    for j, x in enumerate(shards):
        g0 = (first + j) * t_loc
        a, b = max(start, g0), min(start + count, g0 + t_loc)
        if a < b:
            out[:, a - start: b - start] = x[:, a - g0: b - g0].to(device)
    if group is not None:
        dist.all_reduce(out, group=group)
    return out


def apply_sp(params, mel: torch.Tensor, cfg: VocoderConfig,
             devices=None, mesh=None) -> torch.Tensor:
    """``models.vocoder.apply`` with the four stages and the post-conv cut
    into time shards: mel [B, T, n_mels] (normalized, +-4, tail-padded) ->
    wav [B, T*441, 1] on mel's device.

    ``mesh``: one shard per rank of the mesh's "model" axis; every rank of
    that group calls this with the same mel and the vocoder tree on its own
    card, and every rank returns the whole waveform. ``devices``: every
    shard in this process, shard i on ``devices[i]``; ``params`` may be one
    tree (moved to each device as needed) or a list of per-device copies.
    The condnet and the pre-conv run on mel's device."""
    from voicefixer_tpu_torch.models.vocoder import _res_stack
    if (devices is None) == (mesh is None):
        raise ValueError("apply_sp takes devices= or mesh=, one of them")
    if mesh is not None:
        n, first, group = (axis_size(mesh, "model"),
                           axis_rank(mesh, "model"),
                           axis_group(mesh, "model"))
        devices, per_dev = [mel.device], [params]

        def exchange(shards, h):
            return [exchange_halo(shards[0], h, mesh)]
    else:
        devices = [torch.device(d) for d in devices]
        n, first, group, exchange = len(devices), 0, None, exchange_halo
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
    shards = [x[:, (first + i) * t_loc: (first + i + 1) * t_loc].to(d)
              for i, d in enumerate(devices)]
    rate = 1
    for i, s in enumerate(cfg.upsample_scales):
        shards = _upsample_local([p["stages"][i]["up"] for p in per_dev],
                                 shards, s, exchange)
        t_loc *= s
        rate *= s
        dils = stack_dilations(cfg.resstack_depth[i])
        h = -(-sum(d + 1 for d in dils) // 8) * 8
        ext = exchange(shards, h)
        for j, xe in enumerate(ext):
            # the signal [0, t0*rate) in the rows of this shard's array
            lo = h - (first + j) * t_loc
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
    for xe in exchange(shards, pad_post):
        y = conv1d(xe.float(), w_post.to(xe.device), b_post.to(xe.device))
        parts.append(torch.tanh(y).to(mel.device))
    if group is not None:
        gathered = [torch.empty_like(parts[0]) for _ in range(n)]
        dist.all_gather(gathered, parts[0].contiguous(), group=group)
        parts = gathered
    total = t0 * rate
    wav = torch.cat(parts, dim=1)[:, :total]

    def patch(edge, left: bool):
        xp = reflection_pad1d(edge, pad_post)
        seg = xp[:, : 3 * pad_post] if left else xp[:, -3 * pad_post:]
        return torch.tanh(conv1d(seg, w_post, b_post))

    edge = min(8, total)
    head = _rows(shards, first, t_loc, 0, edge, mel.device, group)
    tail = _rows(shards, first, t_loc, total - edge, edge, mel.device, group)
    wav[:, :pad_post] = patch(head, True)
    wav[:, total - pad_post:] = patch(tail, False)
    return wav.to(mel.dtype)


def synthesize_sp(params, mel: torch.Tensor, cfg: VocoderConfig,
                  devices=None, mesh=None) -> torch.Tensor:
    """``pipeline.vocoder_facade.synthesize`` through ``apply_sp`` (on
    ``devices`` or over ``mesh``): linear analysis-convention mel
    [B, T, 128] -> wav [B, S, 1]."""
    from voicefixer_tpu_torch.pipeline.vocoder_facade import pad_tail
    w = torch.as_tensor(mel_weight_curve(cfg.num_mels), dtype=mel.dtype,
                        device=mel.device)
    mel = vocoder_normalize_mel(mel / w, cfg)
    mel = pad_tail(mel, -cfg.max_abs_value)
    return apply_sp(params, mel, cfg, devices, mesh)
