"""Which parameters the "model" axis shards, as
``voicefixer_tpu/parallel/sharding.py``: the output-channel (last) axis of a
large weight, where it is at least ``min_channels`` and divides the axis.
Small tensors stay replicated: biases, BN statistics, GRU cells, and the
whole denoiser, whose widths are the mel axis, a spatial axis for the
ResUNet downstream (and whose GRU is sequential and small). The policy and
its keys are the JAX package's.

Where GSPMD places a sharded array in the JAX package, here each rank keeps
its slice of every sharded leaf (``shard_params``), and ``gather_params``
puts a sharded tree back together, to write it out whole.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from voicefixer_tpu_torch.parallel.mesh import (axis_group, axis_rank,
                                                axis_size)

_REPLICATED_KEYS = ("gru", "bn", "mean", "var", "gamma", "beta", "denoiser")
MIN_CHANNELS = 64


def _axis_for(path: str, x, n_model: int, min_channels: int):
    if n_model == 1:
        return None
    leaf = path.rsplit("/", 1)[-1]
    if any(k in path for k in _REPLICATED_KEYS) or leaf == "b":
        return None
    shape = tuple(x.shape)
    if len(shape) >= 2 and shape[-1] >= min_channels \
            and shape[-1] % n_model == 0:
        return len(shape) - 1
    return None


def _walk(fn, node, path=""):
    if isinstance(node, dict):
        return {k: _walk(fn, v, f"{path}/{k}") for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_walk(fn, v, f"{path}/{i}")
                          for i, v in enumerate(node))
    return fn(path, node)


def param_specs(params, n_model: int, min_channels: int = MIN_CHANNELS):
    """A tree like ``params`` of the axis each leaf is sharded on over
    "model" (the last), or None where the leaf is replicated."""
    return _walk(lambda p, x: _axis_for(p, x, n_model, min_channels), params)


def shard_params(params, mesh, min_channels: int = MIN_CHANNELS):
    """This model rank's copy of ``params``: a sharded leaf's slice of its
    last axis, a replicated leaf whole."""
    n, r = axis_size(mesh, "model"), axis_rank(mesh, "model")

    def keep(path, x):
        ax = _axis_for(path, x, n, min_channels)
        if ax is None:
            return x
        return x.chunk(n, dim=ax)[r].contiguous()

    return _walk(keep, params)


def gather_params(params, specs, mesh):
    """The whole tree on every rank of the model group, from each rank's
    ``shard_params`` copy and the full tree's ``param_specs``."""
    n = axis_size(mesh, "model")

    def whole(x, ax):
        if ax is None or n == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.detach().contiguous(),
                        group=axis_group(mesh, "model"))
        return torch.cat(parts, dim=ax)

    flat_specs = {}
    _walk(lambda p, s: flat_specs.__setitem__(p, s), specs)
    return _walk(lambda p, x: whole(x, flat_specs[p]), params)
