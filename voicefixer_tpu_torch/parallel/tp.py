"""Tensor parallelism over the "model" axis, as
``voicefixer_tpu/parallel/tp.py``, with the collectives written out.

The JAX package shards the analysis stage's wide convolution weights by
output channel (``parallel.sharding``) and lets GSPMD insert the
collectives. Here they are inserted by hand at each sharded convolution
(``channel_sharded``), in Megatron's pattern of two autograd functions over
the model group:

- copy-in (``CopyToModel``): identity forward; the backward all-reduces
  (sums) the input's gradient, of which each rank computed its own output
  channels' share.
- gather-out (``GatherFromModel``): all-gather of the output channels
  forward; the backward keeps this rank's slice of the gradient. Not
  ``torch.distributed.nn.functional.all_gather``: its backward sums over
  the group, and every model rank computes the same replicated loss
  downstream, so that sum would scale the sharded weights' gradients by
  the axis size.

So BN, the residual adds and the pooling see whole activations, and every
replicated module keeps its kernel on every rank: the denoiser's GRU (K6)
and the STFT (K5). The fused ConvBlockRes kernel (K9) needs every channel
and does not run under a model axis, as in the JAX package.

Training-mode batch statistics span the data axis inside
``global_batch_stats``: ``batch_moments`` all-reduces the per-channel sums
through an autograd-aware all-reduce, so a data-parallel step normalizes
as the unsharded step on the whole batch does.

The active mesh is a context variable, set by ``use_mesh`` around a call;
with none (or one model rank) every helper is the plain computation.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist

from voicefixer_tpu_torch.parallel.mesh import (axis_group, axis_rank,
                                                axis_size)

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "vf_torch_tp_mesh", default=None)
_STATS_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "vf_torch_stats_group", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Run the models under ``mesh``'s model axis."""
    token = _ACTIVE.set(mesh)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active_mesh():
    return _ACTIVE.get()


def model_parallel() -> bool:
    """True when a mesh with more than one "model" rank is active."""
    return axis_size(_ACTIVE.get(), "model") > 1


@contextlib.contextmanager
def global_batch_stats(mesh):
    """Training-mode batch statistics over the whole batch of ``mesh``'s
    data axis (when it has more than one rank) instead of this rank's rows.
    Every data rank must run the same layers with the same row count."""
    group = (axis_group(mesh, "data") if axis_size(mesh, "data") > 1
             else None)
    token = _STATS_GROUP.set(group)
    try:
        yield
    finally:
        _STATS_GROUP.reset(token)


class AllReduceSum(torch.autograd.Function):
    """Sum over ``group`` forward; the gradient of every rank's copy of the
    sum summed back over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class CopyToModel(torch.autograd.Function):
    """Identity forward; all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class GatherFromModel(torch.autograd.Function):
    """[..., C/n] on each rank -> [..., C] on every rank (rank order);
    backward: this rank's C/n slice of the gradient."""

    @staticmethod
    def forward(ctx, y, group, n, rank):
        ctx.rank, ctx.c = rank, y.shape[-1]
        y = y.contiguous()
        parts = [torch.empty_like(y) for _ in range(n)]
        dist.all_gather(parts, y, group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.rank * ctx.c: (ctx.rank + 1) * ctx.c], None, None, \
            None


def channel_sharded(conv, x: torch.Tensor, w: torch.Tensor, b, out_channels:
                    int, **kwargs) -> torch.Tensor:
    """``conv(x, w, b, **kwargs)`` with ``out_channels`` output channels,
    where ``w`` may hold only this model rank's slice of them
    (``sharding.shard_params``): then x goes in through copy-in, the
    convolution makes this rank's channels (a whole bias is sliced to
    them), and gather-out returns all of them. The counterpart of the JAX
    package's ``constrain_channels``: the point where GSPMD would gather."""
    mesh = _ACTIVE.get()
    if axis_size(mesh, "model") == 1 or w.shape[-1] == out_channels:
        return conv(x, w, b, **kwargs)
    n, r = axis_size(mesh, "model"), axis_rank(mesh, "model")
    c = w.shape[-1]
    if c * n != out_channels:
        raise ValueError(f"a weight of {c} output channels is neither all "
                         f"{out_channels} nor a 1/{n} slice of them")
    group = axis_group(mesh, "model")
    if b is not None and b.shape[0] == out_channels:
        b = b[r * c: (r + 1) * c]
    y = conv(CopyToModel.apply(x, group), w, b, **kwargs)
    return GatherFromModel.apply(y, group, n, r)


def batch_moments(x: torch.Tensor, dims=None):
    """(mean, biased variance) of x over ``dims`` (all of them for None),
    two passes as ``jnp.mean`` and ``jnp.var``; inside
    ``global_batch_stats`` over the rows of every data rank."""
    group = _STATS_GROUP.get()
    if group is None:
        if dims is None:
            var, mean = torch.var_mean(x, correction=0)
        else:
            var, mean = torch.var_mean(x, dim=dims, correction=0)
        return mean, var
    count = (x.numel() if dims is None
             else x.numel() // x.shape[-1]) * dist.get_world_size(group)

    def total(t):
        s = t.sum() if dims is None else t.sum(dim=dims)
        return AllReduceSum.apply(s, group)

    mean = total(x) / count
    d = x - mean
    return mean, total(d * d) / count
