"""The ("data", "model") mesh over processes, as
``voicefixer_tpu/parallel/mesh.py``.

- "data": chunks, utterances and training rows are independent, so a batch
  is cut into rows per data rank (and gradients averaged over it in
  training).
- "model": the analysis stage's wide convolutions are sharded by output
  channel over it (``parallel.tp``), and the vocoder's time axis
  (``parallel.sp``).

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over every
process, one process a card (``parallel.distributed``); "model" is the inner
axis, so a model group is consecutive ranks, one host's cards. Helpers
take ``mesh=None`` as this process alone.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from voicefixer_tpu_torch.parallel import distributed

AXES = ("data", "model")


def make_mesh(n_data: int | None = None, n_model: int = 1) -> DeviceMesh:
    """The ("data", "model") mesh over every process of the group; by
    default every rank on "data". The process group must be up
    (``distributed.initialize``). n_data x n_model must be the world
    size: a process cannot be left out of a mesh, unlike a device."""
    if not distributed.is_initialized():
        raise RuntimeError("make_mesh needs the process group: call "
                           "parallel.distributed.initialize first")
    world = distributed.process_count()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs "
                         f"{n_data * n_model} processes, not {world}")
    return init_device_mesh(distributed.local_device().type,
                            (n_data, n_model), mesh_dim_names=AXES)


def check_mesh(mesh):
    """TypeError unless ``mesh`` is None or a ("data", "model") mesh."""
    if mesh is not None and not (isinstance(mesh, DeviceMesh)
                                 and tuple(mesh.mesh_dim_names or ()) == AXES):
        raise TypeError(f"expected a ('data', 'model') DeviceMesh from "
                        f"parallel.mesh.make_mesh, got {type(mesh).__name__}")


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh.size(AXES.index(axis))


def axis_rank(mesh, axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    return mesh.get_group(axis)


def shard_batch(mesh, x: torch.Tensor) -> torch.Tensor:
    """This data rank's rows of a global batch [B, ...]: zero rows pad B to
    a multiple of the data axis (``global_batch`` trims them)."""
    n, r = axis_size(mesh, "data"), axis_rank(mesh, "data")
    per = -(-x.shape[0] // n)
    if per * n != x.shape[0]:
        x = torch.cat([x, x.new_zeros((per * n - x.shape[0],)
                                      + tuple(x.shape[1:]))])
    return x[r * per: (r + 1) * per]


def global_batch(mesh, x: torch.Tensor, rows: int | None = None):
    """Every data rank's rows [b, ...] -> the global batch [n*b, ...] on
    every rank, trimmed to ``rows``. Each rank passes the same b."""
    if axis_size(mesh, "data") > 1:
        parts = [torch.empty_like(x) for _ in range(axis_size(mesh, "data"))]
        dist.all_gather(parts, x.contiguous(),
                        group=axis_group(mesh, "data"))
        x = torch.cat(parts)
    return x if rows is None else x[:rows]


def rank_generator(mesh, seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, data rank): each data
    rank draws its own dropout, and the ranks of one model group, which
    compute the same replicated activations, draw the same."""
    state = np.random.SeedSequence([seed, axis_rank(mesh, "data")])
    return torch.Generator(device).manual_seed(
        int(state.generate_state(1, np.uint64)[0] >> np.uint64(1)))
