"""Hand-written CUDA kernels for Hopper (sm_90a), one per TPU kernel of the
mode-0 path:

- kernels.stft     -- framing, windowed DFT, magnitude and mel in one pass
                      (voicefixer_tpu/kernels/stft.py::stft_mel)
- kernels.gru      -- both directions of a bidirectional GRU layer
                      (voicefixer_tpu/kernels/gru.py::gru_seq_bidir)
- kernels.upsample -- x + sin(x) and the polyphase transposed conv
                      (voicefixer_tpu/kernels/upsample.py::upsample)

Every wrapper takes its plain PyTorch version for a tensor on the CPU, and
for a CUDA tensor launches its kernel or raises; there is no switch that
reroutes. Each launch adds one to ``launches[name]``.
"""

from __future__ import annotations

launches = {"stft_mel": 0, "gru_bidir": 0, "upsample": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


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
