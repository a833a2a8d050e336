"""Random upstream-layout weights, drawn on the card from the seed.

The keys, shapes and distributions are the frozen drawer's
(``frozen/ref_state_dict.py``): ``_Recorder`` walks its
``analysis_state_dict`` and ``vocoder_state_dict`` and notes what each key
would be drawn from instead of drawing it with numpy on the host. ``draw``
then fills one flat float32 buffer on the device in a few large calls
(uniforms, normals, the weight-norm gains) and gives every key a view of
it. The same seed gives the same tensors, so the reference can draw them
again after the program has been freed.

One departure from the drawer: the vocoder's biases are drawn from
U(-0.001, 0.001) (``VOCODER_BIAS``), not U(-0.05, 0.05). Drawn as the
drawer draws them, in each of its 75 convolutions, they drive a pattern
that repeats every hop and swamps what the input adds: at upstream's
widths two different 30 s inputs gave waves 0.3-1.0 % apart, less than
production precision's own rounding (0.25-1.8 %), so no comparison could
tell one request's answer from another's. At 0.001 two inputs' waves
differ by 20-27 %, a dropped post-conv bias moves the wave by 32-91 % and
an upsampling stage's by 2-3 %, against bf16's 1.1-1.7 %.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from bench_cuda.frozen import ref_state_dict

VOCODER_BIAS = 1e-3  # the bound of the vocoder's uniform biases


@dataclass
class Slot:
    """One tensor to draw: ``kind`` uniform (U(-bound, bound)), normal
    (``scale`` * |N| + ``shift`` if ``absolute`` else ``scale`` * N +
    ``shift``) or gain (weight norm's g: ||v|| over all but dim 0 times
    U(0.9, 1.1), ``of`` the key of v)."""
    kind: str
    shape: tuple
    bound: float = 0.0
    scale: float = 1.0
    shift: float = 0.0
    absolute: bool = False
    of: str = ""


class _Recorder(ref_state_dict._Drawer):
    """``_Drawer`` with the draws replaced by Slots; every method that
    builds keys from them is the frozen one."""

    def uniform(self, shape, bound):
        return Slot("uniform", tuple(int(s) for s in shape), float(bound))

    def weight(self, prefix, w):
        if self.weight_norm is None:
            self.sd[f"{prefix}.weight"] = w
            return
        if self.weight_norm == "weight_g":
            g_key, v_key = f"{prefix}.weight_g", f"{prefix}.weight_v"
        else:
            g_key = f"{prefix}.parametrizations.weight.original0"
            v_key = f"{prefix}.parametrizations.weight.original1"
        self.sd[g_key] = Slot("gain", (w.shape[0],) + (1,) * (len(w.shape)
                                                               - 1), of=v_key)
        self.sd[v_key] = w

    def bn(self, prefix, c):
        self.sd[f"{prefix}.weight"] = Slot("normal", (c,), scale=0.1,
                                           shift=1.0, absolute=True)
        self.sd[f"{prefix}.bias"] = Slot("normal", (c,), scale=0.1)
        self.sd[f"{prefix}.running_mean"] = Slot("normal", (c,), scale=0.1)
        self.sd[f"{prefix}.running_var"] = Slot("normal", (c,), scale=0.1,
                                                shift=1.0, absolute=True)
        self.sd[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)


@contextlib.contextmanager
def _recording():
    drawer = ref_state_dict._Drawer
    ref_state_dict._Drawer = _Recorder
    try:
        yield
    finally:
        ref_state_dict._Drawer = drawer


def layout(cfg) -> tuple:
    """(analysis, vocoder): {key: Slot or numpy scalar} in the frozen
    drawer's key order."""
    with _recording():
        analysis = ref_state_dict.analysis_state_dict(cfg, 0)
        vocoder = ref_state_dict.vocoder_state_dict(cfg, 0)
    for k, s in vocoder.items():
        if k.endswith(".bias"):
            s.bound = VOCODER_BIAS
    return analysis, vocoder


def _numel(shape) -> int:
    return int(np.prod(shape, dtype=np.int64))


def draw(cfg, seed: int, device) -> tuple:
    """(analysis, vocoder) upstream-layout state dicts of float32 views of
    one buffer on ``device``, drawn from ``seed``; the BN counters stay
    numpy scalars."""
    dicts = layout(cfg)
    slots = [(d, k, s) for d in dicts for k, s in d.items()
             if isinstance(s, Slot)]
    kinds = {kind: [(d, k, s) for d, k, s in slots if s.kind == kind]
             for kind in ("uniform", "normal", "gain")}
    sizes = {kind: sum(_numel(s.shape) for _, _, s in v)
             for kind, v in kinds.items()}
    flat = torch.empty(sum(sizes.values()), dtype=torch.float32,
                       device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    regions, off = {}, 0
    for kind in ("uniform", "normal", "gain"):
        regions[kind] = flat[off: off + sizes[kind]]
        off += sizes[kind]
    torch.rand(sizes["uniform"], generator=gen, device=device,
               out=regions["uniform"])
    torch.randn(sizes["normal"], generator=gen, device=device,
                out=regions["normal"])
    torch.rand(sizes["gain"], generator=gen, device=device,
               out=regions["gain"])

    def per_element(kind, value):
        counts = torch.tensor([_numel(s.shape) for _, _, s in kinds[kind]],
                              device=device)
        vals = torch.tensor([value(s) for _, _, s in kinds[kind]],
                            dtype=torch.float32, device=device)
        return torch.repeat_interleave(vals, counts)

    u = regions["uniform"]
    bound = per_element("uniform", lambda s: s.bound)
    u.mul_(2 * bound).sub_(bound)
    n = regions["normal"]
    absolute = per_element("normal", lambda s: float(s.absolute))
    n.copy_(torch.where(absolute > 0, n.abs(), n))
    n.mul_(per_element("normal", lambda s: s.scale)).add_(
        per_element("normal", lambda s: s.shift))
    regions["gain"].mul_(0.2).add_(0.9)

    out = [dict(d) for d in dicts]
    index = {id(d): i for i, d in enumerate(dicts)}
    for kind in ("uniform", "normal", "gain"):
        off = 0
        for d, k, s in kinds[kind]:
            m = _numel(s.shape)
            out[index[id(d)]][k] = regions[kind][off: off + m].view(s.shape)
            off += m
    for d, k, s in kinds["gain"]:
        sd = out[index[id(d)]]
        v = sd[s.of].double()
        norm = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.ndim)),
                                    keepdim=True))
        sd[k].copy_((norm * sd[k].double()).float())
    return tuple(out)


def to_host(dicts: tuple) -> tuple:
    """The state dicts as numpy arrays, as a checkpoint file would give
    them, in one copy of the buffer from the device."""
    tensors = [t for d in dicts for t in d.values()
               if isinstance(t, torch.Tensor)]
    base = tensors[0]._base if tensors[0]._base is not None else tensors[0]
    host = base.cpu().numpy()
    start = base.data_ptr()
    out = []
    for d in dicts:
        h = {}
        for k, t in d.items():
            if isinstance(t, torch.Tensor):
                off = (t.data_ptr() - start) // 4
                h[k] = host[off: off + t.numel()].reshape(t.shape)
            else:
                h[k] = t
        out.append(h)
    return tuple(out)
