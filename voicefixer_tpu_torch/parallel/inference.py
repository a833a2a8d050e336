"""Data-parallel batched restoration, as
``voicefixer_tpu/parallel/inference.py``: every chunk of every file is
gathered, the chunks are grouped by length and stacked into global batches
of at most ``max_batch``, and each data rank of the mesh restores its rows
of each batch on its own card. Chunks are independent in the eval modes
(BN on running statistics), so the result is the per-file
``VoiceFixer.restore_inmem`` of each file.

Memory: a chunk row at full width holds stage 3's [1.32 M, 64] activation
and its neighbours at once (PERF.md records the peak per row), so a rank's
share of ``max_batch`` rows must fit its card; the CLI bounds it
(``__main__.ROWS_PER_CARD``).
"""

from __future__ import annotations

import numpy as np
import torch

from voicefixer_tpu_torch.parallel import distributed
from voicefixer_tpu_torch.parallel.mesh import (axis_rank, axis_size,
                                                global_batch, shard_batch)
from voicefixer_tpu_torch.pipeline.restore import _trim_center


def _segments_of(vf, wav: np.ndarray, mode: int):
    """One waveform -> (segments, orig_lens): upstream's consecutive
    segments, mode 1's ``remove_higher_frequency`` applied to each, and with
    ``pad_short_to_seg`` a short or tail segment zero-padded to the full
    segment; orig_lens[i] is its length before the pad, the restored head
    kept after the centre trim."""
    seg_length = vf.config.pipeline.seg_length
    wav = np.asarray(wav, dtype=np.float32).reshape(-1)
    segs, orig_lens = [], {}
    for s in range(0, wav.shape[0], seg_length):
        seg = wav[s: s + seg_length]
        if mode == 1:
            seg = vf._hf(seg)
        if vf.config.pipeline.pad_short_to_seg and seg.shape[0] < seg_length:
            orig_lens[len(segs)] = seg.shape[0]
            seg = np.pad(seg, (0, seg_length - seg.shape[0]))
        segs.append(seg)
    return segs, orig_lens


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
    axis restores each rank's rows tensor-parallel over it."""
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
    orig_len = {(fi, si): n for fi, (_, lens) in enumerate(split)
                for si, n in lens.items()}
    groups: dict = {}
    for fi, (segs, _) in enumerate(split):
        for si, seg in enumerate(segs):
            groups.setdefault(seg.shape[0], []).append((fi, si, seg))

    results: dict = {}
    for seg_len, items in groups.items():
        for start in range(0, len(items), max_batch):
            chunk_items = items[start: start + max_batch]
            batch = len(chunk_items)
            stacked = torch.from_numpy(np.stack([seg for _, _, seg
                                                 in chunk_items]))
            outs, peaks = vf._restore_batch_device(shard_batch(mesh, stacked))
            outs = global_batch(mesh, outs, batch).cpu().numpy()
            peaks = global_batch(mesh, peaks, batch).cpu().numpy()
            for j, (fi, si, _) in enumerate(chunk_items):
                if peaks[j] > 1.0 and primary:
                    print("Warning: Exceed energy limit,", float(peaks[j]))
                out = _trim_center(outs[j], seg_len)
                n = orig_len.get((fi, si))
                if n is not None and n < out.shape[-1]:
                    out = out[..., :n]  # drop the synthesized padding tail
                results[(fi, si)] = out

    return [np.concatenate([results[(fi, si)] for si in range(len(segs))],
                           axis=-1) for fi, (segs, _) in enumerate(split)]
