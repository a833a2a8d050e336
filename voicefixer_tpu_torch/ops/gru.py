"""Multi-layer GRU with torch nn.GRU gate math, as
``voicefixer_tpu/ops/gru.py``: the input projection of every time step is
one hoisted matmul; a bidirectional layer's recurrence, both directions at
once, goes to the kernel ``kernels.gru.gru_bidir``, a unidirectional
layer's to ``kernels.gru.gru_seq``.
"""

from __future__ import annotations

import math

import torch

from voicefixer_tpu_torch.kernels.gru import gru_bidir, gru_seq
from voicefixer_tpu_torch.ops.precision import matmul_dtype
from voicefixer_tpu_torch.utils.weights import uniform


def _proj(x: torch.Tensor, p: dict) -> torch.Tensor:
    """x @ W_ih^T + b_ih for all time steps: [B, T, In] -> [B, T, 3H]."""
    return x @ p["w_ih"].T + p["b_ih"]


def gru_single_direction(x: torch.Tensor, params: dict,
                         reverse: bool = False) -> torch.Tensor:
    """One direction of one layer, always in float32 (the kernel takes no
    product type, as in the JAX package). x: [B, T, In]; params: w_ih
    [3H, In], w_hh [3H, H], b_ih, b_hh [3H]. Returns [B, T, H]."""
    return gru_seq(_proj(x, params), params["w_hh"].T, params["b_hh"],
                   reverse=reverse)


def gru(x: torch.Tensor, params: dict, num_layers: int,
        bidirectional: bool) -> torch.Tensor:
    """torch nn.GRU(batch_first=True) parity. params: {"l{i}": fwd,
    "l{i}_reverse": bwd}, each {w_ih [3H, In], w_hh [3H, H], b_ih, b_hh}.
    Returns [B, T, H * directions] from the last layer."""
    out = x
    for layer in range(num_layers):
        if not bidirectional:
            out = gru_single_direction(out, params[f"l{layer}"])
            continue
        pf, pb = params[f"l{layer}"], params[f"l{layer}_reverse"]
        fwd, bwd = gru_bidir(_proj(out, pf), _proj(out, pb),
                             pf["w_hh"].T, pb["w_hh"].T, pf["b_hh"],
                             pb["b_hh"], matmul_dtype=matmul_dtype())
        out = torch.cat([fwd, bwd], dim=-1)
    return out


def init_gru_params(generator: torch.Generator, input_dim: int,
                    hidden_dim: int, num_layers: int, device,
                    bidirectional: bool = True) -> dict:
    """U(-1/sqrt(H), 1/sqrt(H)) for every weight and bias, like torch's
    nn.GRU and the JAX package's init."""
    bound = 1.0 / math.sqrt(hidden_dim)
    num_dir = 2 if bidirectional else 1
    params = {}
    for layer in range(num_layers):
        in_dim = input_dim if layer == 0 else num_dir * hidden_dim
        for suffix in ("", "_reverse")[:num_dir]:
            params[f"l{layer}{suffix}"] = {
                "w_ih": uniform((3 * hidden_dim, in_dim), bound, generator,
                                device),
                "w_hh": uniform((3 * hidden_dim, hidden_dim), bound,
                                generator, device),
                "b_ih": uniform((3 * hidden_dim,), bound, generator, device),
                "b_hh": uniform((3 * hidden_dim,), bound, generator, device),
            }
    return params
