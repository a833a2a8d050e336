"""Hand-written CUDA kernels for Hopper (sm_90a), one per TPU kernel of the
JAX package:

- kernels.stft      -- framing, windowed FFT, magnitude and mel in one pass
                       (voicefixer_tpu/kernels/stft.py::stft_mel)
- kernels.gru       -- both directions of a bidirectional GRU layer, or one
                       (voicefixer_tpu/kernels/gru.py::gru_seq_bidir,
                       ::gru_seq)
- kernels.upsample  -- x + sin(x) and the polyphase transposed conv as one
                       GEMM (wgmma on TMA-fed tiles in bfloat16)
                       (voicefixer_tpu/kernels/upsample.py::upsample)
- kernels.resstack  -- ResStack blocks: chains of small dilations with the
                       intermediates in shared memory, single blocks with
                       shifted taps, and the dispatcher over a stage
                       (voicefixer_tpu/kernels/resstack.py::res_chain,
                       ::res_shift_single)
- kernels.resstream -- a whole ResStack behind one entry point, with the
                       stage's upsample in front or on a time shard with a
                       signal window
                       (voicefixer_tpu/kernels/resstream.py::up_res_stream,
                       ::res_stream)
- kernels.convblock -- a ResUNet ConvBlockRes: two folded-BN, LeakyReLU,
                       3x3-conv steps and the shortcut in one kernel
                       (voicefixer_tpu/kernels/convblock.py::conv_block_res)
- kernels.snake_aa  -- BigVGAN's anti-aliased SnakeBeta activation: 2x
                       upsample, SnakeBeta and 2x low-pass downsample in one
                       pass (no TPU kernel: the JAX package has no BigVGAN)
- kernels.amp_conv  -- BigVGAN's dilated AMP convolutions in bfloat16: the
                       tap product on wgmma, the block's residual in its
                       epilogue (no TPU kernel: upstream's convs are plain
                       Conv1d)

Every wrapper takes its plain PyTorch version for a tensor on the CPU, and
for a CUDA tensor launches its kernel or raises; there is no switch that
reroutes. Each launch adds one to ``launches[name]``.

A kernel writes into a tensor that autograd knows nothing of, so a
gradient through it would be lost without a word. Every launch therefore
goes through ``check_no_grad``, which raises where autograd would want a
gradient of the output. The bidirectional GRU is differentiable: its
wrapper ``gru.gru_bidir_cat`` runs the kernel inside a
``torch.autograd.Function`` whose backward is the recurrence's exact
backpropagation through time, on the card a kernel of its own
(``gru_bidir_backward`` in ``launches``).
"""

from __future__ import annotations

import contextlib

import torch

launches = {"stft_mel": 0, "gru_bidir": 0, "upsample": 0, "res_chain": 0,
            "res_shift_single": 0, "up_res_stream": 0, "res_stream": 0,
            "gru_seq": 0, "conv_block_res": 0, "gru_bidir_backward": 0,
            "snake_aa": 0, "amp_conv": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


def current_device(device):
    """Context in which ``device`` is the current CUDA device. A kernel
    launches on the current device whatever device its tensors lie on, so
    code that works on a card other than the current one (a time shard of
    ``parallel.sp``, a pipeline on "cuda:1") runs its launches inside this.
    Nothing to do for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def check_no_grad(name: str, *tensors):
    """Raise RuntimeError when grad mode is on and any of ``tensors`` (or of
    the tensors in a list or dict among them) requires grad: the launch of
    kernel ``name`` would drop that gradient."""
    if not torch.is_grad_enabled():
        return
    stack = list(tensors)
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
        elif isinstance(t, torch.Tensor) and t.requires_grad:
            raise RuntimeError(
                f"{name}: the CUDA kernel has no backward, and an input "
                "requires grad; run it under torch.no_grad() or "
                "torch.inference_mode(), or differentiate on the CPU")


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (take the plain version), False
    when every one lies on a CUDA device (launch the kernel); raises
    otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"kernel inputs on devices {sorted(kinds)}: all must be "
                     "on the CPU or all on one CUDA device")
