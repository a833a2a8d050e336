"""Multi-layer bidirectional GRU with torch nn.GRU gate math, as
``voicefixer_tpu/ops/gru.py::gru``: the input projection of every time step
is one hoisted matmul, and each layer's recurrence, both directions at
once, goes to the kernel ``kernels.gru.gru_bidir``.
"""

from __future__ import annotations

import math

import torch

from voicefixer_tpu_torch.kernels.gru import gru_bidir
from voicefixer_tpu_torch.ops.precision import matmul_dtype
from voicefixer_tpu_torch.utils.weights import uniform


def _proj(x: torch.Tensor, p: dict) -> torch.Tensor:
    """x @ W_ih^T + b_ih for all time steps: [B, T, In] -> [B, T, 3H]."""
    return x @ p["w_ih"].T + p["b_ih"]


def gru(x: torch.Tensor, params: dict, num_layers: int,
        bidirectional: bool) -> torch.Tensor:
    """torch nn.GRU(batch_first=True) parity. params: {"l{i}": fwd,
    "l{i}_reverse": bwd}, each {w_ih [3H, In], w_hh [3H, H], b_ih, b_hh}.
    Returns [B, T, 2H] from the last layer."""
    if not bidirectional:
        raise NotImplementedError(
            "unidirectional GRU needs kernel K8 (gru_seq), not ported yet: "
            "ROADMAP.md Queue 2")
    out = x
    for layer in range(num_layers):
        pf, pb = params[f"l{layer}"], params[f"l{layer}_reverse"]
        fwd, bwd = gru_bidir(_proj(out, pf), _proj(out, pb),
                             pf["w_hh"].T, pb["w_hh"].T, pf["b_hh"],
                             pb["b_hh"], matmul_dtype=matmul_dtype())
        out = torch.cat([fwd, bwd], dim=-1)
    return out


def init_gru_params(generator: torch.Generator, input_dim: int,
                    hidden_dim: int, num_layers: int, device) -> dict:
    """U(-1/sqrt(H), 1/sqrt(H)) for every weight and bias, like torch's
    nn.GRU and the JAX package's init; bidirectional."""
    bound = 1.0 / math.sqrt(hidden_dim)
    params = {}
    for layer in range(num_layers):
        in_dim = input_dim if layer == 0 else 2 * hidden_dim
        for suffix in ("", "_reverse"):
            params[f"l{layer}{suffix}"] = {
                "w_ih": uniform((3 * hidden_dim, in_dim), bound, generator,
                                device),
                "w_hh": uniform((3 * hidden_dim, hidden_dim), bound,
                                generator, device),
                "b_ih": uniform((3 * hidden_dim,), bound, generator, device),
                "b_hh": uniform((3 * hidden_dim,), bound, generator, device),
            }
    return params
