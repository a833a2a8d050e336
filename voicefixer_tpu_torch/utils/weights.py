"""Parameter trees of the port: the bridge from the JAX package's trees,
random init, the npz format of ``voicefixer_tpu/utils/weights.py``, and the
conversion of the upstream torch checkpoints into that JAX-layout tree.

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

# ------------------------------------------------ torch checkpoint -> tree
#
# An own copy of ``voicefixer_tpu/utils/weights.py``'s converters, numpy
# only apart from ``torch.load``. Both upstream checkpoints convert to the
# JAX package's tree (numpy leaves), which ``from_jax_params`` turns into
# the port's; so one checkpoint gives both packages the same numbers.
# - ``vf.ckpt``: the analysis module's flat state dict, subtrees
#   ``generator.denoiser.*`` and ``generator.unet.*``;
# - ``model.ckpt-1490000_trimed.pt``: {"generator": state_dict} with weight
#   norm, folded to plain kernels here.
# Layouts: Conv1d [Cout, Cin, K] -> [K, Cin, Cout]; Conv2d [Cout, Cin, Kh,
# Kw] -> [Kh, Kw, Cin, Cout]; ConvTranspose1d [Cin, Cout, K] -> [K, Cin,
# Cout] (torch tap order kept); ConvTranspose2d [Cin, Cout, Kh, Kw] -> [Kh,
# Kw, Cin, Cout]; Linear [Out, In] -> [In, Out].


def load_torch_state_dict(path: str) -> dict:
    """A torch checkpoint -> {key: np.ndarray}, no modules built. A
    {"generator": state_dict} checkpoint gives the generator's dict."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "generator" in obj and all(
            not k.startswith("generator.") for k in obj):
        obj = obj["generator"]
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return {k: v.detach().cpu().numpy() if hasattr(v, "detach") else
            np.asarray(v) for k, v in obj.items()}


def resolve_weight(sd: dict, prefix: str) -> np.ndarray:
    """The effective ``weight`` at ``prefix``. Weight norm, stored as
    (weight_g, weight_v) or parametrizations.weight.original{0,1}, is folded
    in float64: W = g * v / ||v||, the norm over every dim but dim 0."""
    if f"{prefix}.weight" in sd:
        return sd[f"{prefix}.weight"]
    for g_key, v_key in (
            (f"{prefix}.weight_g", f"{prefix}.weight_v"),
            (f"{prefix}.parametrizations.weight.original0",
             f"{prefix}.parametrizations.weight.original1")):
        if g_key in sd and v_key in sd:
            g, v = sd[g_key], sd[v_key]
            axes = tuple(range(1, v.ndim))
            norm = np.sqrt(np.sum(v.astype(np.float64) ** 2, axis=axes,
                                  keepdims=True))
            return (g.astype(np.float64) * v.astype(np.float64) / norm
                    ).astype(v.dtype)
    raise KeyError(f"no weight found for {prefix}")


def _conv1d(sd, prefix):
    return {"w": resolve_weight(sd, prefix).transpose(2, 1, 0),
            "b": sd[f"{prefix}.bias"]}


def _conv2d(sd, prefix, bias=True):
    p = {"w": resolve_weight(sd, prefix).transpose(2, 3, 1, 0)}
    if bias:
        p["b"] = sd[f"{prefix}.bias"]
    return p


def _convT1d(sd, prefix):
    return {"w": resolve_weight(sd, prefix).transpose(2, 0, 1),
            "b": sd[f"{prefix}.bias"]}


def _convT2d_nobias(sd, prefix):
    return {"w": resolve_weight(sd, prefix).transpose(2, 3, 0, 1)}


def _linear(sd, prefix):
    return {"w": sd[f"{prefix}.weight"].T, "b": sd[f"{prefix}.bias"]}


def _bn(sd, prefix):
    return {"gamma": sd[f"{prefix}.weight"], "beta": sd[f"{prefix}.bias"],
            "mean": sd[f"{prefix}.running_mean"],
            "var": sd[f"{prefix}.running_var"]}


def _gru(sd, prefix, num_layers, bidirectional):
    params = {}
    for layer in range(num_layers):
        for suffix in ([""] + (["_reverse"] if bidirectional else [])):
            params[f"l{layer}{suffix}"] = {
                "w_ih": sd[f"{prefix}.weight_ih_l{layer}{suffix}"],
                "w_hh": sd[f"{prefix}.weight_hh_l{layer}{suffix}"],
                "b_ih": sd[f"{prefix}.bias_ih_l{layer}{suffix}"],
                "b_hh": sd[f"{prefix}.bias_hh_l{layer}{suffix}"],
            }
    return params


def convert_denoiser(sd: dict, prefix: str = "") -> dict:
    """The denoiser's Sequential indices (upstream restorer/model.py)."""
    p = prefix
    return {
        "bn0": _bn(sd, f"{p}0"),
        "fc1": _linear(sd, f"{p}1"),
        "bn3": _bn(sd, f"{p}3"),
        "fc4": _linear(sd, f"{p}4"),
        "gru7": {"bn": _bn(sd, f"{p}7.bn"),
                 "gru": _gru(sd, f"{p}7.gru", 2, True)},
        "gru8": {"bn": _bn(sd, f"{p}8.bn"),
                 "gru": _gru(sd, f"{p}8.gru", 2, True)},
        "bn9": _bn(sd, f"{p}9"),
        "fc11": _linear(sd, f"{p}11"),
        "bn13": _bn(sd, f"{p}13"),
        "fc15": _linear(sd, f"{p}15"),
    }


def _conv_block(sd, prefix):
    p = {"bn1": _bn(sd, f"{prefix}.bn1"),
         "conv1": _conv2d(sd, f"{prefix}.conv1", bias=False),
         "bn2": _bn(sd, f"{prefix}.bn2"),
         "conv2": _conv2d(sd, f"{prefix}.conv2", bias=False)}
    if f"{prefix}.shortcut.weight" in sd:
        p["shortcut"] = _conv2d(sd, f"{prefix}.shortcut")
    return p


def convert_resunet(sd: dict, prefix: str = "") -> dict:
    """The ResUNet's module names (upstream model_kqq_bn.py): 6 encoder
    levels of 4 blocks, the centre block, 6 decoder levels."""
    p = prefix
    params = {}
    for i in range(1, 7):
        params[f"enc{i}"] = {
            f"block{j}": _conv_block(sd, f"{p}encoder_block{i}.conv_block{j}")
            for j in range(1, 5)}
    params["center"] = _conv_block(sd, f"{p}conv_block7")
    for i in range(1, 7):
        d = {"bn1": _bn(sd, f"{p}decoder_block{i}.bn1"),
             "conv1": _convT2d_nobias(sd, f"{p}decoder_block{i}.conv1")}
        for j in range(2, 6):
            d[f"block{j}"] = _conv_block(
                sd, f"{p}decoder_block{i}.conv_block{j}")
        params[f"dec{i}"] = d
    params["after1"] = _conv_block(sd, f"{p}after_conv_block1")
    params["after2"] = _conv2d(sd, f"{p}after_conv2")
    return params


def convert_analysis(sd: dict) -> dict:
    """vf.ckpt's state dict -> the analysis tree (denoiser + unet). The
    frozen STFT convs (f_helper.*) and the mel fbank (mel.fb) are computed,
    not loaded."""
    return {"denoiser": convert_denoiser(sd, "generator.denoiser."),
            "unet": convert_resunet(sd, "generator.unet.")}


def convert_vocoder(sd: dict, prefix: str = "") -> dict:
    """The vocoder generator's state dict -> the vocoder tree. Sequential
    indices (upstream generator.py): condnet.{0,2,4,6,8}, generator.1 (pre
    conv), the stages' upsamples at generator.{3,6,9,12}.layer and their
    ResStacks at generator.{4,7,10,13}.layers.{i}.{1,3}, generator.16 (post
    conv). The unused UpsampleNet.skip_conv is dropped."""
    p = prefix
    params = {
        "condnet": [_conv1d(sd, f"{p}condnet.{i}") for i in (0, 2, 4, 6, 8)],
        "pre": _conv1d(sd, f"{p}generator.1"),
        "post": _conv1d(sd, f"{p}generator.16"),
        "stages": [],
    }
    for up_idx, res_idx in ((3, 4), (6, 7), (9, 10), (12, 13)):
        res = [{"c1": _conv1d(sd, f"{p}generator.{res_idx}.layers.{i}.1"),
                "c2": _conv1d(sd, f"{p}generator.{res_idx}.layers.{i}.3")}
               for i in range(8)]
        params["stages"].append(
            {"up": _convT1d(sd, f"{p}generator.{up_idx}.layer"), "res": res})
    return params


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


# ------------------------------------- layouts the ResStack kernels read

def res_bank(params: list):
    """A list of ResStack blocks {"c1": {"w", "b"}, "c2": {"w", "b"}} ->
    (w1s [n, 3, C, C], b1s [n, C], w2s, b2s), block-major. Contiguous, so
    w1s.reshape(n, 3*C, C) is the [tap*in, out] matrix of each block that
    the kernels multiply by."""
    return (torch.stack([p["c1"]["w"] for p in params]),
            torch.stack([p["c1"]["b"] for p in params]),
            torch.stack([p["c2"]["w"] for p in params]),
            torch.stack([p["c2"]["b"] for p in params]))


# ------------------------------- layouts the ConvBlockRes kernel reads

def _pad_rows8(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[.., Ci, Co] cast to dtype; in bfloat16 Ci is padded with zero rows
    to a multiple of 8 (the tensor-core product stages 8 channels at once)."""
    w = w.to(dtype)
    pad = -w.shape[-2] % 8 if dtype == torch.bfloat16 else 0
    return torch.nn.functional.pad(w, (0, 0, 0, pad)) if pad else w


def pack_conv3x3(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[3, 3, Ci, Co] -> [9*Ci_p, Co], tap-major (dt, df), then channel."""
    w = _pad_rows8(w, dtype)
    return w.reshape(9 * w.shape[2], w.shape[3]).contiguous()


def pack_bn(bn: dict):
    """A folded batch norm -> (scale, shift), float32 and contiguous."""
    return bn["scale"].float().contiguous(), bn["shift"].float().contiguous()


def pack_shortcut(sc: dict, dtype: torch.dtype) -> torch.Tensor:
    """{"w": [1, 1, Ci, Co], "b": [Co]} -> [Ci_p + 1, Co]: the 1x1 weights,
    then the bias as the last row."""
    w = _pad_rows8(sc["w"][0, 0], dtype)
    return torch.cat([w, sc["b"].to(dtype)[None]]).contiguous()


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


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, lists and tuples, in its order."""
    out = []
    tree_map(out.append, tree)
    return out


def count_leaves(tree) -> int:
    return len(tree_leaves(tree))


def convert_tree(tree: dict, which: str, device="cpu"):
    """One JAX package tree, ``which`` "analysis" or "vocoder" (numpy
    leaves, as ``analysis.init``, ``vocoder.init`` and ``load_pytree_npz``
    give them) -> the port's tree (float32 tensors on ``device``), leaf for
    leaf. Every leaf is consumed; an unknown or missing key raises
    KeyError."""
    br = _Bridge(device)
    out = getattr(br, which)(tree, which)
    if br.leaves != count_leaves(tree):
        raise KeyError(f"{which}: converted {br.leaves} of "
                       f"{count_leaves(tree)} leaves")
    return out


def from_jax_params(analysis_tree: dict, vocoder_tree: dict, device="cpu"):
    """Both JAX package trees -> the port's (``convert_tree``)."""
    return (convert_tree(analysis_tree, "analysis", device),
            convert_tree(vocoder_tree, "vocoder", device))


def _jax_unflatten(tree, flat):
    """The leaves ``flat`` (an iterator, in the JAX package's flatten order:
    dict keys sorted, lists in order) placed in ``tree``'s structure, its
    key order kept."""
    if isinstance(tree, dict):
        vals = {k: _jax_unflatten(tree[k], flat) for k in sorted(tree)}
        return {k: vals[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return [_jax_unflatten(v, flat) for v in tree]
    return next(flat)


def from_jax_train_state(params_tree: dict, opt_state_leaves, step: int,
                         optimizer=None, device="cuda"):
    """A JAX package train state -> the port's ``train.step.TrainState`` on
    ``device``. params_tree: the analysis tree (numpy leaves);
    opt_state_leaves: the leaves of the JAX state's ``opt_state``, flattened
    as ``jax.tree.leaves`` does for ``reference_optimizer``'s chain:
    ScaleByAdamState(count, mu, nu), then ScaleByScheduleState(count).
    The moments are elementwise, so ``convert_tree``'s mapping carries them
    leaf for leaf into Adam's exp_avg and exp_avg_sq; Adam's update count
    is the first count, the schedule's step the second. ``optimizer``: the
    port's ``OptimizerSpec`` of the same recipe (default
    ``reference_optimizer()``)."""
    from voicefixer_tpu_torch.train.step import init_train_state, set_step
    n = count_leaves(params_tree)
    flat = [np.asarray(v) for v in opt_state_leaves]
    if len(flat) != 2 * n + 2:
        raise ValueError(f"optimizer state of {len(flat)} leaves; Adam and "
                         f"its schedule over {n} parameters have {2 * n + 2}")
    state = init_train_state(convert_tree(params_tree, "analysis"),
                             optimizer, device)
    moments = [tree_leaves(convert_tree(
        _jax_unflatten(params_tree, iter(m)), "analysis",
        state.leaves()[0].device))
               for m in (flat[1:1 + n], flat[1 + n:1 + 2 * n])]
    for p, m, v in zip(state.leaves(), *moments):
        state.optimizer.state[p] = {"step": torch.tensor(float(flat[0])),
                                    "exp_avg": m, "exp_avg_sq": v}
    set_step(state, int(flat[-1]))
    state.step = int(step)
    return state


def save_pytree_npz(params, path: str, provenance: str | None = None):
    """A tree of arrays -> an npz file, keys joined by '/'. ``provenance``
    goes under the reserved key "__provenance__" (``npz_provenance`` reads
    it; loaders skip "__" keys). The JAX package reads and writes the same
    format."""
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}/{i}")
        else:
            if isinstance(node, torch.Tensor):
                node = node.detach().cpu().numpy()
            flat[prefix] = np.asarray(node)

    walk(params, "")
    if provenance is not None:
        flat["__provenance__"] = np.asarray(provenance)
    np.savez(path, **flat)


def npz_provenance(path: str) -> str | None:
    """The provenance label of a tree's npz, if it has one."""
    with np.load(path) as z:
        if "__provenance__" in z.files:
            return str(z["__provenance__"])
    return None


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
