"""Data-parallel batched restoration, as
``voicefixer_tpu/parallel/inference.py``: every chunk of every file is
gathered, the chunks are grouped by length and stacked into global batches
of at most ``max_batch``, and each data rank of the mesh restores its rows
of each batch on its own card. Chunks are independent in the eval modes
(BN on running statistics), so the result is the per-file
``VoiceFixer.restore_inmem`` of each file.

Memory: a chunk row at full width holds the vocoder's last stage, a
[1.33 M, 64] activation, and its neighbours at once, so a rank's share of
``max_batch`` rows may not fit its card. Each global batch is therefore
restored in as few calls as keep a rank's rows within ``rows_per_call``:
the card's free memory over ``row_bytes``, and at most as many rows as
keep that activation under 2^31 elements, the same on every rank.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from voicefixer_tpu_torch.ops.precision import activation_dtype
from voicefixer_tpu_torch.parallel import distributed
from voicefixer_tpu_torch.parallel.mesh import (axis_rank, axis_size,
                                                global_batch, shard_batch)
from voicefixer_tpu_torch.pipeline.restore import _trim_center
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


def rows_per_call(vf, seg_len: int, mesh=None) -> int | None:
    """Chunk rows of ``seg_len`` samples that one call restores on this
    rank's card: FREE_SHARE of its free memory (as the CUDA runtime reports
    it, plus what the caching allocator holds unused) over ``row_bytes``,
    at most
    INDEX_LIMIT over ``row_elements``, at least 1; the least over the
    mesh's ranks, so that all take the same calls. None on the CPU: no
    cap."""
    if vf.device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(vf.device)
    free += (torch.cuda.memory_reserved(vf.device)
             - torch.cuda.memory_allocated(vf.device))
    rows = min(int(FREE_SHARE * free // row_bytes(vf.config, seg_len)),
               INDEX_LIMIT // row_elements(vf.config, seg_len))
    rows = max(1, rows)
    if mesh is not None and mesh.size() > 1:
        t = torch.tensor([rows], device=vf.device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        rows = int(t.item())
    return rows


def _segments_of(vf, wav: np.ndarray, mode: int):
    """One waveform -> (segments, orig_lens): upstream's consecutive
    segments, mode 1's ``remove_higher_frequency`` applied to each, and with
    ``pad_short_to_seg`` a short or tail segment zero-padded to the full
    segment; orig_lens[i] is its length before the pad, the restored head
    kept after the centre trim. Mode 1's pre-pass runs on the device,
    outside the ``vf.plan`` spans."""
    seg_length = vf.config.pipeline.seg_length
    with annotate("vf.plan"):
        wav = np.asarray(wav, dtype=np.float32).reshape(-1)
        segs = [wav[s: s + seg_length]
                for s in range(0, wav.shape[0], seg_length)]
    if mode == 1:
        segs = [vf._hf(seg) for seg in segs]
    with annotate("vf.plan"):
        orig_lens = {}
        if vf.config.pipeline.pad_short_to_seg:
            for i, seg in enumerate(segs):
                if seg.shape[0] < seg_length:
                    orig_lens[i] = seg.shape[0]
                    segs[i] = np.pad(seg, (0, seg_length - seg.shape[0]))
    return segs, orig_lens


@annotate("vf.request")
def restore_wavs(vf, wavs, mode: int = 0, mesh=None,
                 max_batch: int = 64) -> list:
    """Restore a list of waveforms (1-D, 44.1 kHz) with chunk-level data
    parallelism; returns the restored waveforms, as ``vf.restore_inmem``
    gives each (eval modes 0 and 1 only).

    ``mesh``: default ``vf.mesh``; None runs every chunk in this process.
    With a mesh, every rank calls this with the same ``wavs`` and returns
    the whole list: each data rank restores its rows of each global batch
    of ``max_batch`` chunks (padded to a multiple of the data axis), and the
    rows are all-gathered. A ``VoiceFixer`` built on a mesh with a model
    axis restores each rank's rows tensor-parallel over it. A global
    batch whose share per rank exceeds ``rows_per_call`` is restored in
    equal calls; the results do not change. One ``vf.request`` span holds
    the call (``utils.profiling``)."""
    if mode not in (0, 1):
        raise ValueError("data-parallel restore supports eval modes 0/1; "
                         "mode 2's per-chunk BN statistics are inherently "
                         "sequential")
    mesh = mesh if mesh is not None else vf.mesh
    if axis_size(vf.mesh, "model") > 1 and mesh is not vf.mesh:
        raise ValueError("a VoiceFixer with a model axis restores on its "
                         "own mesh")
    primary = axis_rank(mesh, "data") == 0 and distributed.is_primary()

    split = [_segments_of(vf, w, mode) for w in wavs]
    with annotate("vf.plan"):
        orig_len = {(fi, si): n for fi, (_, lens) in enumerate(split)
                    for si, n in lens.items()}
        groups: dict = {}
        for fi, (segs, _) in enumerate(split):
            for si, seg in enumerate(segs):
                groups.setdefault(seg.shape[0], []).append((fi, si, seg))

    n_data = axis_size(mesh, "data")
    results: dict = {}
    for seg_len, items in groups.items():
        with annotate("vf.plan"):
            cap = rows_per_call(vf, seg_len, mesh)
            calls = []
            for start in range(0, len(items), max_batch):
                batch_items = items[start: start + max_batch]
                n_calls = 1 if cap is None else math.ceil(
                    math.ceil(len(batch_items) / n_data) / cap)
                step = math.ceil(len(batch_items) / n_calls)
                calls += [batch_items[i: i + step]
                          for i in range(0, len(batch_items), step)]
        for chunk_items in calls:
            batch = len(chunk_items)
            with annotate("vf.plan"):
                rows = shard_batch(mesh, torch.from_numpy(
                    np.stack([seg for _, _, seg in chunk_items])))
            outs, peaks = vf._restore_batch_device(rows)
            outs, peaks = vf._to_host(global_batch(mesh, outs, batch),
                                      global_batch(mesh, peaks, batch))
            with annotate("vf.stitch"):
                for j, (fi, si, _) in enumerate(chunk_items):
                    if peaks[j] > 1.0 and primary:
                        print("Warning: Exceed energy limit,",
                              float(peaks[j]))
                    out = _trim_center(outs[j], seg_len)
                    n = orig_len.get((fi, si))
                    if n is not None and n < out.shape[-1]:
                        out = out[..., :n]  # drop the synthesized padding tail
                    results[(fi, si)] = out

    with annotate("vf.stitch"):
        return [np.concatenate([results[(fi, si)]
                                for si in range(len(segs))], axis=-1)
                for fi, (segs, _) in enumerate(split)]
