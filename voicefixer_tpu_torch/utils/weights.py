"""Parameter trees of the port: the bridge from the JAX package's trees,
random init, and the npz format of ``voicefixer_tpu/utils/weights.py``.

The port's trees have the JAX package's structure and shapes, leaf for leaf:
nested dicts and lists of tensors, conv weights [K, Cin, Cout] and
[Kh, Kw, Cin, Cout] (transposed-conv weights in torch tap order, not
flipped), Linear weights [In, Out], GRU weights in torch's [3H, In] with gate
order (r, z, n).
"""

from __future__ import annotations

import re

import numpy as np
import torch


def tree_map(fn, tree):
    """fn applied to every leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def uniform(shape, bound: float, generator: torch.Generator,
            device) -> torch.Tensor:
    """U(-bound, bound) float32, drawn on the CPU from ``generator`` so that
    a seed gives the same weights on every device. On the meta device
    nothing is drawn (shapes only)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, device="meta")
    return torch.empty(shape).uniform_(-bound, bound,
                                       generator=generator).to(device)


# ------------------------------------------------------------ the bridge

_BN = ("gamma", "beta", "mean", "var")
_BN_FOLDED = ("scale", "shift")


class _Bridge:
    """Walks a JAX parameter tree against the structure the port knows,
    converts every leaf to a float32 tensor on ``device`` and counts them.
    A key it does not know, or a missing one, raises KeyError."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.leaves = 0

    def leaf(self, v, path):
        a = np.asarray(v)
        if a.dtype.kind != "f":
            raise TypeError(f"{path}: expected a float array, got {a.dtype}")
        self.leaves += 1
        return torch.tensor(a, dtype=torch.float32, device=self.device)

    def node(self, node, path, required, optional=(), patterns=()):
        """dict node: every key is required, optional, or matches one of
        ``patterns`` (regex, subtree fn); returns {key: converted}."""
        if not isinstance(node, dict):
            raise KeyError(f"{path}: expected a dict, got {type(node).__name__}")
        missing = [k for k in required if k not in node]
        if missing:
            raise KeyError(f"{path}: missing keys {missing}")
        out = {}
        for k, v in node.items():
            sub = f"{path}/{k}"
            if k in required:
                out[k] = required[k](v, sub)
            elif k in optional:
                out[k] = optional[k](v, sub)
            else:
                for pat, fn in patterns:
                    if re.fullmatch(pat, k):
                        out[k] = fn(v, sub)
                        break
                else:
                    raise KeyError(f"{sub}: unknown key")
        return out

    def seq(self, node, path, fn):
        if not isinstance(node, (list, tuple)):
            raise KeyError(f"{path}: expected a list, got {type(node).__name__}")
        return [fn(v, f"{path}/{i}") for i, v in enumerate(node)]

    # -- shapes of the trees

    def bn(self, node, path):
        return self.node(node, path, {k: self.leaf for k in _BN},
                         optional={k: self.leaf for k in _BN_FOLDED})

    def conv(self, node, path):
        return self.node(node, path, {"w": self.leaf, "b": self.leaf})

    def conv_nobias(self, node, path):
        return self.node(node, path, {"w": self.leaf})

    def gru(self, node, path):
        cell = lambda v, p: self.node(v, p, {k: self.leaf for k in  # noqa: E731
                                             ("w_ih", "w_hh", "b_ih", "b_hh")})
        return self.node(node, path, {}, patterns=[(r"l\d+(_reverse)?", cell)])

    def denoiser(self, node, path):
        gru_block = lambda v, p: self.node(v, p, {"bn": self.bn,  # noqa: E731
                                                  "gru": self.gru})
        return self.node(node, path, {
            "bn0": self.bn, "fc1": self.conv, "bn3": self.bn,
            "fc4": self.conv, "gru7": gru_block, "gru8": gru_block,
            "bn9": self.bn, "fc11": self.conv, "bn13": self.bn,
            "fc15": self.conv})

    def conv_block(self, node, path):
        return self.node(node, path, {
            "bn1": self.bn, "conv1": self.conv_nobias, "bn2": self.bn,
            "conv2": self.conv_nobias}, optional={"shortcut": self.conv})

    def resunet(self, node, path):
        blocks = [(r"block\d+", self.conv_block)]
        enc = lambda v, p: self.node(v, p, {}, patterns=blocks)  # noqa: E731
        dec = lambda v, p: self.node(  # noqa: E731
            v, p, {"bn1": self.bn, "conv1": self.conv_nobias}, patterns=blocks)
        return self.node(node, path, {
            "center": self.conv_block, "after1": self.conv_block,
            "after2": self.conv}, patterns=[(r"enc\d+", enc), (r"dec\d+", dec)])

    def analysis(self, node, path):
        return self.node(node, path, {"denoiser": self.denoiser,
                                      "unet": self.resunet})

    def vocoder(self, node, path):
        res = lambda v, p: self.seq(v, p, lambda u, q: self.node(  # noqa: E731
            u, q, {"c1": self.conv, "c2": self.conv}))
        stage = lambda v, p: self.node(v, p, {"up": self.conv,  # noqa: E731
                                              "res": res})
        return self.node(node, path, {
            "condnet": lambda v, p: self.seq(v, p, self.conv),
            "pre": self.conv, "post": self.conv,
            "stages": lambda v, p: self.seq(v, p, stage)})


def count_leaves(tree) -> int:
    n = 0

    def one(_):
        nonlocal n
        n += 1
    tree_map(one, tree)
    return n


def from_jax_params(analysis_tree: dict, vocoder_tree: dict, device="cpu"):
    """The JAX package's parameter trees (numpy leaves, as ``analysis.init``,
    ``vocoder.init`` and ``load_pytree_npz`` give them) -> the port's trees
    (float32 tensors on ``device``), leaf for leaf. Every leaf is consumed;
    an unknown or missing key raises KeyError."""
    br = _Bridge(device)
    a = br.analysis(analysis_tree, "analysis")
    v = br.vocoder(vocoder_tree, "vocoder")
    total = count_leaves(analysis_tree) + count_leaves(vocoder_tree)
    if br.leaves != total:
        raise KeyError(f"converted {br.leaves} of {total} leaves")
    return a, v


def load_pytree_npz(path: str) -> dict:
    """A tree written by ``save_pytree_npz`` (keys joined by '/'; numeric
    path components become lists), as numpy arrays. Reserved '__' keys are
    skipped."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files if not k.startswith("__")}
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)
