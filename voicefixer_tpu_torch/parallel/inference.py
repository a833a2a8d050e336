"""Data-parallel batched restoration, as
``voicefixer_tpu/parallel/inference.py``: every chunk of every file is
gathered, the chunks are grouped by length and stacked into global batches
of at most ``max_batch``, and each data rank of the mesh restores its rows
of each batch on its own card. Chunks are independent in the eval modes
(BN on running statistics), so the result is the per-file
``VoiceFixer.restore_inmem`` of each file: both run the one request path
of ``pipeline.restore`` and ``pipeline.plan``, whose ``rows_per_call``
splits a global batch that does not fit the cards into equal calls.
"""

from __future__ import annotations

from voicefixer_tpu_torch.parallel import distributed
from voicefixer_tpu_torch.parallel.mesh import axis_rank, axis_size
from voicefixer_tpu_torch.utils.profiling import annotate


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
    batch whose share per rank exceeds ``pipeline.plan.rows_per_call`` is
    restored in equal calls; the results do not change. One
    ``vf.request`` span holds the call (``utils.profiling``)."""
    if mode not in (0, 1):
        raise ValueError("data-parallel restore supports eval modes 0/1; "
                         "mode 2's per-chunk BN statistics are inherently "
                         "sequential")
    mesh = mesh if mesh is not None else vf.mesh
    if axis_size(vf.mesh, "model") > 1 and mesh is not vf.mesh:
        raise ValueError("a VoiceFixer with a model axis restores on its "
                         "own mesh")
    primary = axis_rank(mesh, "data") == 0 and distributed.is_primary()
    return vf._restore_eval(list(wavs), mode, mesh, max_batch, warn=primary)
