"""The host side of an eval-mode request, for ``VoiceFixer.restore_inmem``
and ``parallel.inference.restore_wavs`` alike: how a wave is cut into
segments, how rows of one length are split into device calls, and how a
restored row is finished.

Memory: a chunk row at full width holds the vocoder's last stage, a
[1.33 M, 64] activation, and its neighbours at once, so the rows of one
request may not fit the card. They are therefore restored in as few equal
calls as keep a rank's rows within ``rows_per_call``: the card's free
memory over ``row_bytes``, and at most as many rows as keep that
activation under 2^31 elements, the least over the ranks that must make
the same calls (``cap_group``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from voicefixer_tpu_torch.ops.precision import activation_dtype
from voicefixer_tpu_torch.parallel.mesh import axis_group, axis_size
from voicefixer_tpu_torch.utils.profiling import annotate

# The peak device memory of one 30 s chunk row at full width, 1.383 GiB in
# parity and 0.699 GiB in production (chip_smoke.py on an H100 80GB HBM3,
# 700 W; PERF.md), is 4.38 and 4.42 times the vocoder's last activation
# ([1 325 646, 64] float32 or bfloat16); ROW_COPIES of it leave a margin.
ROW_COPIES = 4.5
# the share of the free memory that the rows of one call may take
FREE_SHARE = 0.9
# PyTorch's CUDA reflection pad (the vocoder's post-conv) indexes with 32-bit
# integers and raises on a tensor of 2^31 elements or more: 26 rows of the
# full-width last activation
INDEX_LIMIT = 2 ** 31 - 1


def row_elements(cfg, seg_len: int) -> int:
    """Elements of the vocoder's last activation for one chunk row of
    ``seg_len`` samples, [frames x upsample, channels / 2^stages]: a
    row's largest tensor."""
    v = cfg.vocoder
    t = seg_len // cfg.stft.hop_length + 1
    samples = (t + t % 2 + 4) * v.total_upsample
    return samples * (v.channels // 2 ** len(v.upsample_scales))


def row_bytes(cfg, seg_len: int) -> int:
    """Peak device bytes of one chunk row of ``seg_len`` samples:
    ROW_COPIES times its last activation in the precision's activation
    type."""
    size = torch.empty((), dtype=activation_dtype()).element_size()
    return int(ROW_COPIES * row_elements(cfg, seg_len) * size)


def free_rows(vf, seg_len: int) -> int | None:
    """Chunk rows of ``seg_len`` samples that one call restores on this
    rank's card: FREE_SHARE of its free memory (as the CUDA runtime reports
    it, plus what the caching allocator holds unused) over ``row_bytes``,
    at most INDEX_LIMIT over ``row_elements``, at least 1. None on the CPU:
    no cap."""
    if vf.device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(vf.device)
    free += (torch.cuda.memory_reserved(vf.device)
             - torch.cuda.memory_allocated(vf.device))
    rows = min(int(FREE_SHARE * free // row_bytes(vf.config, seg_len)),
               INDEX_LIMIT // row_elements(vf.config, seg_len))
    return max(1, rows)


def rows_per_call(vf, seg_len: int, group=None) -> int | None:
    """``free_rows``, the least over the ranks of the process group
    ``group`` (``cap_group``), so that all take the same calls; None
    reduces nothing."""
    rows = free_rows(vf, seg_len)
    if rows is not None and group is not None \
            and dist.get_world_size(group) > 1:
        t = torch.tensor([rows], device=vf.device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
        rows = int(t.item())
    return rows


def cap_group(mesh, data_mesh=None):
    """The ranks that must make the same calls: every rank where
    ``data_mesh`` has more than one (``restore_wavs`` gathers each call
    over it); else the "model" group of the instance's ``mesh`` where it
    has more than one rank (tensor-parallel restore); else None."""
    if data_mesh is not None and data_mesh.size() > 1:
        return dist.group.WORLD
    if axis_size(mesh, "model") > 1:
        return axis_group(mesh, "model")
    return None


def split(n: int, cap: int | None, n_data: int = 1,
          max_batch: int | None = None) -> list:
    """The calls that ``n`` rows take, as slices in order: batches of at
    most ``max_batch`` rows (one batch without it), each in as few equal
    calls as keep a share of a call over ``n_data`` data ranks within
    ``cap`` rows; None: one call a batch."""
    size = n if max_batch is None else max_batch
    calls = []
    for start in range(0, n, size):
        stop = min(start + size, n)
        n_calls = 1 if cap is None else math.ceil(
            math.ceil((stop - start) / n_data) / cap)
        step = math.ceil((stop - start) / n_calls)
        calls += [slice(i, min(i + step, stop))
                  for i in range(start, stop, step)]
    return calls


def segments(wav, seg_length: int, pad: bool, prepass=None):
    """One wave -> (segments, lengths): upstream's consecutive segments of
    ``seg_length`` samples, ``prepass`` applied to each (mode 1's
    ``remove_higher_frequency``, a device pass outside the ``vf.plan``
    spans), and with ``pad`` a short or tail segment zero-padded to the
    full segment; lengths[i] is segment i's before the pad, the restored
    head that ``finish`` keeps."""
    with annotate("vf.plan"):
        wav = np.asarray(wav, dtype=np.float32).reshape(-1)
        segs = [wav[s: s + seg_length]
                for s in range(0, wav.shape[0], seg_length)]
    if prepass is not None:
        segs = [prepass(seg) for seg in segs]
    with annotate("vf.plan"):
        lengths = [seg.shape[0] for seg in segs]
        if pad:
            segs = [np.pad(seg, (0, seg_length - seg.shape[0]))
                    if seg.shape[0] < seg_length else seg for seg in segs]
    return segs, lengths


def trim_center(est: np.ndarray, ref_len: int) -> np.ndarray:
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


def fit_length(a: np.ndarray, n: int) -> np.ndarray:
    """Centre-trim to n if longer, zero-pad at the tail if shorter."""
    a = trim_center(a, n)
    if a.shape[-1] < n:
        a = np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, n - a.shape[-1])])
    return a


def finish(out: np.ndarray, peak, length: int,
           keep: int | None = None) -> np.ndarray:
    """One restored row: upstream's warning where its pre-cap ``peak``
    exceeds 1 (None: no warning), the centre trim to the ``length`` that
    went in, and a padded segment's synthesized tail cut to ``keep``."""
    if peak is not None and peak > 1.0:
        print("Warning: Exceed energy limit,", float(peak))
    out = trim_center(out, length)
    return out if keep is None else out[..., :keep]
