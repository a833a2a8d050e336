"""Parameter counts and model size, as ``voicefixer_tpu/utils/params.py``
over the port's trees. Upstream's sizes: ResUNet 65,153,189; vocoder
generator 33,883,330 (condnet 3,354,624); denoiser 5,223,820.
"""

from __future__ import annotations

import numpy as np

from voicefixer_tpu_torch.utils.weights import tree_leaves


def count_parameters(params) -> int:
    """Scalars in a tree of tensors or arrays."""
    return sum(int(np.prod(tuple(x.shape))) for x in tree_leaves(params))


def parameter_summary(params, max_depth: int = 1) -> dict:
    """{subtree path: parameter count} down to ``max_depth``."""
    out: dict = {}

    def walk(node, path, depth):
        if depth >= max_depth or not isinstance(node, (dict, list, tuple)):
            out[path or "/"] = count_parameters(node)
            return
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for k, v in items:
            walk(v, f"{path}/{k}", depth + 1)

    walk(params, "", 0)
    return out


def count_flops(fn, *example_args) -> int | None:
    """FLOPs of one call of ``fn(*example_args)`` as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them (matrix
    products and convolutions; a kernel launched by ctypes is invisible to
    it); None where it counts nothing."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*example_args)
    return int(counter.get_total_flops()) or None
