"""Matmul and convolution precision policy of the port.

Parity mode (the default) keeps every activation, weight and product in
float32. On a CUDA card that also needs TF32 off for both matrix products
and cuDNN convolutions (cuDNN convolutions default to TF32); ``tf32_off``
does that around the pipeline's entry points.

Production mode stores the ResUNet and vocoder activations and weights in
bfloat16 and accumulates in float32, and the GRU recurrence multiplies
bfloat16 operands: the same split as ``activation_dtype`` and
``kernels.matmul_dtype`` in the JAX package.
"""

from __future__ import annotations

import contextlib

import torch

PARITY = "parity"
PRODUCTION = "production"

_current = PARITY


def set_precision(p: str):
    global _current
    if p not in (PARITY, PRODUCTION):
        raise ValueError(f"unknown precision {p!r}; '{PARITY}' or "
                         f"'{PRODUCTION}'")
    _current = p


def get_precision() -> str:
    return _current


def activation_dtype() -> torch.dtype:
    """Storage type of the ResUNet and vocoder activations."""
    return torch.bfloat16 if _current == PRODUCTION else torch.float32


def matmul_dtype() -> torch.dtype:
    """Operand type of the kernels' products (accumulation is float32)."""
    return torch.bfloat16 if _current == PRODUCTION else torch.float32


@contextlib.contextmanager
def precision(p: str):
    global _current
    prev = _current
    set_precision(p)
    try:
        yield
    finally:
        _current = prev


_conv_block_kernel = False


def use_conv_block_kernel() -> bool:
    """Whether the ResUNet routes eligible blocks to the fused ConvBlockRes
    kernel (``kernels.convblock``). Off unless ``conv_block_kernel`` is
    entered: the default path keeps the library convolutions."""
    return _conv_block_kernel


@contextlib.contextmanager
def conv_block_kernel(on: bool = True):
    """Opt in to the fused ConvBlockRes kernel for the blocks it takes."""
    global _conv_block_kernel
    prev = _conv_block_kernel
    _conv_block_kernel = bool(on)
    try:
        yield
    finally:
        _conv_block_kernel = prev


@contextlib.contextmanager
def tf32_off():
    """Run float32 products and convolutions in full float32 on the card."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
