"""Training checkpoints, as ``voicefixer_tpu/train/checkpoint.py``: a
``TrainState`` to and from one npz file in the format of
``utils.weights.save_pytree_npz`` (the JAX package's), holding the
parameters, Adam's moments and update count per leaf, and the step."""

from __future__ import annotations

import os

import numpy as np
import torch

from voicefixer_tpu_torch.train.step import (OptimizerSpec, TrainState,
                                             init_train_state, set_step)
from voicefixer_tpu_torch.utils import weights as W

_MOMENTS = ("exp_avg", "exp_avg_sq", "step")


def save_train_state(state: TrainState, path: str):
    """Write the state to ``path`` (npz)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    per_leaf = [state.optimizer.state.get(p, {}) for p in state.leaves()]
    if any(not s for s in per_leaf) and any(s for s in per_leaf):
        raise ValueError("Adam holds moments for some leaves and not others")
    payload = {"params": state.params, "step": np.asarray(state.step)}
    if per_leaf and per_leaf[0]:
        payload["adam"] = {k: [torch.as_tensor(s[k]) for s in per_leaf]
                           for k in _MOMENTS}
    W.save_pytree_npz(payload, path)


def load_train_state(path: str, optimizer: OptimizerSpec | None = None,
                     device="cuda") -> TrainState:
    """A state from ``save_train_state``'s file on ``device``, its
    optimizer built from ``optimizer`` (default ``reference_optimizer()``).
    Moments whose count or shapes differ from the parameters' raise."""
    payload = W.load_pytree_npz(path)
    state = init_train_state(payload["params"], optimizer, device)
    params = state.leaves()
    if "adam" in payload:
        adam = payload["adam"]
        for k in _MOMENTS:
            if len(adam[k]) != len(params):
                raise ValueError(
                    f"optimizer state mismatch: checkpoint has "
                    f"{len(adam[k])} {k} leaves, the parameters "
                    f"{len(params)}")
        for i, p in enumerate(params):
            m, v = adam["exp_avg"][i], adam["exp_avg_sq"][i]
            if m.shape != tuple(p.shape) or v.shape != tuple(p.shape):
                raise ValueError(
                    f"optimizer state mismatch: leaf {i} has moments "
                    f"{m.shape} / {v.shape}, the parameter "
                    f"{tuple(p.shape)}")
            state.optimizer.state[p] = {
                "step": torch.tensor(float(adam["step"][i])),
                "exp_avg": torch.as_tensor(m).to(p.device),
                "exp_avg_sq": torch.as_tensor(v).to(p.device)}
    set_step(state, int(payload["step"]))
    return state
