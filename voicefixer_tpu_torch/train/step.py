"""One training step of the analysis stage, as ``voicefixer_tpu/train/
step.py``: the loss of ``train.losses``, its gradients by autograd (through
the GRU kernel's backward on the card), and Adam with upstream's schedule;
with a mesh, data and tensor parallel over processes.

On a ("data", "model") mesh (``parallel.mesh.make_mesh``) each rank passes
its own rows of the global batch (``parallel.mesh.shard_batch``; the ranks
of one model group pass the same rows):
- "data": training-mode BN takes its statistics over the whole batch
  (``parallel.tp.global_batch_stats``), as GSPMD computes them for the JAX
  step; the gradients are averaged over the data group in a few flat
  buckets, so the update is the global batch mean's, and so are the
  metrics.
- "model": after ``place_train_state`` each rank holds its slice of the
  ResUNet's large convolutions and of their Adam moments
  (``parallel.sharding``), and the collectives of ``parallel.tp`` make the
  activations whole and the gradients right. The denoiser is replicated,
  its GRU (K6, ``kernels.gru.GruBidir``) on every rank.

Upstream's optimizer recipe: Adam at lr 3e-4, betas (0.5, 0.999), a linear
warm-up over 1000 steps, then a factor 0.85 every 15000 steps. As with
optax's ``scale_by_schedule`` in the JAX package, the schedule is read at
the number of updates made before, so the first update has lr 0.

The state holds the parameters as leaf tensors that require grad, the
optimizer bound to them, its scheduler, and the step count. Build it from
the raw tree of ``analysis.init`` or ``utils.weights.from_jax_params``, not
from ``VoiceFixer.params``, whose folded BN leaves and packed kernel
operands would not follow the updates.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from voicefixer_tpu_torch import kernels
from voicefixer_tpu_torch.config import VoiceFixerConfig
from voicefixer_tpu_torch.ops.precision import tf32_off
from voicefixer_tpu_torch.parallel import tp
from voicefixer_tpu_torch.parallel.mesh import (axis_group, axis_rank,
                                                axis_size, check_mesh,
                                                rank_generator)
from voicefixer_tpu_torch.parallel.sharding import param_specs, shard_params
from voicefixer_tpu_torch.pipeline.restore import resolve_device
from voicefixer_tpu_torch.train import losses
from voicefixer_tpu_torch.utils.weights import tree_leaves, tree_map

# gradients are averaged over the data group in flat buckets of this size
BUCKET_BYTES = 32 << 20


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """Adam and upstream's schedule (``reference_optimizer``); ``build``
    binds them to parameters."""
    lr: float
    beta1: float
    beta2: float
    warmup_steps: int
    gamma: float
    decay_every: int

    def factor(self, step: int) -> float:
        """The schedule's factor on lr after ``step`` updates."""
        warm = min(max(step / self.warmup_steps, 0.0), 1.0)
        return warm * self.gamma ** (step // self.decay_every)

    def build(self, leaves: list):
        opt = torch.optim.Adam(leaves, lr=self.lr,
                               betas=(self.beta1, self.beta2), eps=1e-8)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, self.factor)


def reference_optimizer(lr: float = 3e-4, beta1: float = 0.5,
                        beta2: float = 0.999, warmup_steps: int = 1000,
                        gamma: float = 0.85,
                        decay_every: int = 15000) -> OptimizerSpec:
    """Adam (eps 1e-8) with lr * clip(step / warmup, 0, 1) *
    gamma^(step // decay_every) at the step-th update, counted from 0."""
    return OptimizerSpec(lr, beta1, beta2, warmup_steps, gamma, decay_every)


@dataclasses.dataclass
class TrainState:
    params: dict
    optimizer: torch.optim.Adam
    scheduler: torch.optim.lr_scheduler.LambdaLR
    spec: OptimizerSpec
    step: int = 0

    def leaves(self) -> list:
        """The parameters in the tree's order, the optimizer's order."""
        return tree_leaves(self.params)


def init_train_state(params: dict, optimizer: OptimizerSpec | None = None,
                     device="cuda") -> TrainState:
    """A fresh state: a copy of ``params`` (a raw analysis tree) on
    ``device`` as leaves that require grad, Adam's moments empty, step 0.
    A CUDA device without a card raises."""
    spec = optimizer or reference_optimizer()
    dev = resolve_device(device)
    derived = _derived_leaves(params)
    if derived:
        raise ValueError(
            f"{derived[0]}: a folded or packed leaf (VoiceFixer.params); "
            "train the raw tree of analysis.init or from_jax_params")
    params = tree_map(lambda t: torch.as_tensor(t, dtype=torch.float32)
                      .to(dev).detach().clone().requires_grad_(), params)
    opt, sched = spec.build(tree_leaves(params))
    return TrainState(params, opt, sched, spec)


def _derived_leaves(tree, path="") -> list:
    """Paths of the leaves that ``fold_bn_eval`` and ``pack_conv_blocks``
    derive from the weights."""
    if not isinstance(tree, dict):
        return []
    out = []
    for k, v in tree.items():
        if k in ("scale", "shift", "packed"):
            out.append(f"{path}/{k}")
        else:
            out += _derived_leaves(v, f"{path}/{k}")
    return out


def set_step(state: TrainState, step: int):
    """Put the schedule at ``step`` updates made (a state carried over)."""
    state.step = int(step)
    state.scheduler = torch.optim.lr_scheduler.LambdaLR(
        state.optimizer, state.spec.factor, last_epoch=state.step - 1)


def make_train_step(cfg: VoiceFixerConfig,
                    optimizer: OptimizerSpec | None = None, mesh=None):
    """step(state, wav_noisy [B, N], wav_clean [B, N], generator=None) ->
    (state, metrics): one update on the parameters' device (numpy batches
    are moved there); ``generator`` draws the dropout. The state is updated
    in place and returned. ``optimizer`` must be the state's (the default
    is ``reference_optimizer()``).

    ``mesh``: a ("data", "model") mesh over processes; every rank calls the
    step with its own rows (the module docstring), the state placed by
    ``place_train_state``, and a generator of its own
    (``parallel.mesh.rank_generator``, the default seeded 0). Anything else
    than a mesh raises TypeError."""
    check_mesh(mesh)
    spec = optimizer or reference_optimizer()
    gens: dict = {}

    def step(state: TrainState, wav_noisy, wav_clean, generator=None):
        if state.spec != spec:
            raise ValueError(f"the state's optimizer {state.spec} is not "
                             f"this step's {spec}")
        if mesh is not None and generator is None:
            dev = state.leaves()[0].device
            generator = gens.setdefault(dev, rank_generator(mesh, 0, dev))
        with tp.use_mesh(mesh), tp.global_batch_stats(mesh):
            _, metrics = forward_backward(state, wav_noisy, wav_clean, cfg,
                                          generator)
        if axis_size(mesh, "data") > 1:
            group = axis_group(mesh, "data")
            all_reduce_mean([p.grad for p in state.leaves()], group)
            names = sorted(metrics)
            vals = torch.stack([metrics[k] for k in names])
            all_reduce_mean([vals], group)
            metrics = dict(zip(names, vals))
        update(state)
        return state, metrics

    return step


def all_reduce_mean(tensors: list, group, bucket_bytes: int = BUCKET_BYTES):
    """Average each tensor in place over ``group``: one all-reduce per flat
    bucket of about ``bucket_bytes``, not one per tensor."""
    n = dist.get_world_size(group)
    bucket, size = [], 0
    for i, t in enumerate(tensors):
        bucket.append(t)
        size += t.numel() * t.element_size()
        if size >= bucket_bytes or i == len(tensors) - 1:
            flat = torch.cat([b.reshape(-1) for b in bucket])
            dist.all_reduce(flat, group=group)
            flat /= n
            for b, part in zip(bucket, flat.split([b.numel()
                                                   for b in bucket])):
                b.copy_(part.view_as(b))
            bucket, size = [], 0


def place_train_state(state: TrainState, mesh) -> TrainState:
    """The state for ``make_train_step(mesh=mesh)``: this model rank's
    slice of every sharded parameter (``parallel.sharding``) and of its
    Adam moments, as new leaves that require grad, the rest whole; the
    step count and schedule carried over."""
    check_mesh(mesh)
    specs = tree_leaves(param_specs(state.params, axis_size(mesh, "model")))
    params = tree_map(lambda t: t.detach().clone().requires_grad_(),
                      shard_params(state.params, mesh))
    new = tree_leaves(params)
    opt, _ = state.spec.build(new)
    n, r = axis_size(mesh, "model"), axis_rank(mesh, "model")
    for old, leaf, ax in zip(state.leaves(), new, specs):
        if old in state.optimizer.state:
            opt.state[leaf] = {
                k: (v.chunk(n, dim=ax)[r] if ax is not None and k != "step"
                    else v).clone()
                for k, v in state.optimizer.state[old].items()}
    placed = TrainState(params, opt, None, state.spec)
    set_step(placed, state.step)
    return placed


def forward_backward(state: TrainState, wav_noisy, wav_clean,
                     cfg: VoiceFixerConfig, generator=None):
    """The loss and its gradients into the leaves' ``.grad``; returns
    (total, metrics detached). A leaf the loss does not read (the running
    BN statistics) gets a zero gradient, as under ``jax.grad``, so Adam
    moves every leaf's moments alike."""
    dev = state.leaves()[0].device
    wn, wc = (torch.as_tensor(w, dtype=torch.float32, device=dev)
              for w in (wav_noisy, wav_clean))
    state.optimizer.zero_grad(set_to_none=True)
    with tf32_off(), kernels.current_device(dev):
        total, metrics = losses.analysis_loss(state.params, wn, wc, cfg,
                                              generator=generator)
        total.backward()
    for p in state.leaves():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return total.detach(), {k: v.detach() for k, v in metrics.items()}


def update(state: TrainState):
    """One Adam update at the schedule's current lr, then the schedule and
    the step count move on."""
    with tf32_off():
        state.optimizer.step()
    state.scheduler.step()
    state.step += 1
