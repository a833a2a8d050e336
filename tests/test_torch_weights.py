"""The weights bridge, the port's init, and the port's independence from the
JAX package.

``jax_param_trees`` is also the parameter source of the other
test_torch_* files: the JAX package's tree structure and shapes (from
``jax.eval_shape`` of its inits, so nothing is drawn by JAX) filled from a
numpy generator with the JAX inits' distributions, plus random biases and BN
statistics so that every leaf matters.
"""

import functools
import math
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from voicefixer_tpu.config import DEFAULT_CONFIG as JAX_DEFAULT
from voicefixer_tpu.config import tiny_test_config as jax_tiny
from voicefixer_tpu.models import analysis as jax_analysis
from voicefixer_tpu.models import vocoder as jax_vocoder

from voicefixer_tpu_torch.config import DEFAULT_CONFIG
from voicefixer_tpu_torch.models import analysis, vocoder
from voicefixer_tpu_torch.utils.weights import (count_leaves,
                                               from_jax_params,
                                               load_pytree_npz)


def _fill(tree, rng, name=""):
    if isinstance(tree, dict):
        return {k: _fill(v, rng, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_fill(v, rng, name) for v in tree]
    shape = tuple(tree.shape)

    def u(bound):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    if name in ("gamma", "var"):
        return (1 + 0.1 * np.abs(rng.standard_normal(shape))).astype(np.float32)
    if name in ("beta", "mean"):
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)
    if name in ("w_ih", "w_hh", "b_ih", "b_hh"):
        return u(1 / math.sqrt(shape[0] // 3))
    if name == "b":
        return u(0.05)
    if len(shape) == 4:   # [Kh, Kw, Cin, Cout]
        return u(math.sqrt(6 / ((shape[2] + shape[3]) * shape[0] * shape[1])))
    if len(shape) == 3:   # [K, Cin, Cout]
        return u(math.sqrt(1 / (shape[0] * shape[1])))
    return u(math.sqrt(6 / (shape[0] + shape[1])))  # Linear [In, Out]


def jax_shapes(cfg):
    key = jax.random.PRNGKey(0)
    return (jax.eval_shape(functools.partial(jax_analysis.init, cfg=cfg), key),
            jax.eval_shape(functools.partial(jax_vocoder.init,
                                             cfg=cfg.vocoder), key))


def jax_param_trees(seed=0, cfg=None):
    """(analysis, vocoder) JAX-structured trees of numpy arrays."""
    a, v = jax_shapes(jax_tiny() if cfg is None else cfg)
    rng = np.random.default_rng(seed)
    return _fill(a, rng), _fill(v, rng)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: tuple(tree.shape)}


def test_from_jax_params_consumes_every_leaf():
    ja, jv = jax_param_trees()
    pa, pv = from_jax_params(ja, jv, "cpu")
    assert _flat(pa) == _flat(ja) and _flat(pv) == _flat(jv)
    assert count_leaves(pa) + count_leaves(pv) == (count_leaves(ja)
                                                   + count_leaves(jv))
    np.testing.assert_array_equal(pv["stages"][1]["up"]["w"].numpy(),
                                  jv["stages"][1]["up"]["w"])


@pytest.mark.parametrize("where", ["denoiser", "unet_block", "vocoder_stage",
                                   "top"])
def test_from_jax_params_rejects_unknown_keys(where):
    ja, jv = jax_param_trees()
    bad = np.zeros(3, np.float32)
    if where == "denoiser":
        ja["denoiser"]["fc99"] = {"w": bad, "b": bad}
    elif where == "unet_block":
        ja["unet"]["enc1"]["block1"]["conv3"] = {"w": bad}
    elif where == "vocoder_stage":
        jv["stages"][0]["skip"] = {"w": bad, "b": bad}
    else:
        jv["extra"] = bad
    with pytest.raises(KeyError):
        from_jax_params(ja, jv, "cpu")


def test_from_jax_params_rejects_missing_keys():
    ja, jv = jax_param_trees()
    del ja["unet"]["after2"]["b"]
    with pytest.raises(KeyError):
        from_jax_params(ja, jv, "cpu")


def test_npz_round_trip(tmp_path):
    """The port reads the JAX package's npz format with its own loader."""
    from voicefixer_tpu.utils.weights import save_pytree_npz
    ja, jv = jax_param_trees()
    save_pytree_npz(jv, str(tmp_path / "v.npz"), provenance="test")
    back = load_pytree_npz(str(tmp_path / "v.npz"))
    assert _flat(back) == _flat(jv)
    np.testing.assert_array_equal(back["post"]["w"], jv["post"]["w"])


def test_init_matches_jax_tree_at_default_config():
    """Same tree and shapes as the JAX inits at full width; the port draws
    nothing on the meta device, JAX nothing under eval_shape."""
    ja, jv = jax_shapes(JAX_DEFAULT)
    gen = torch.Generator().manual_seed(0)
    pa = analysis.init(DEFAULT_CONFIG, gen, "meta")
    pv = vocoder.init(DEFAULT_CONFIG.vocoder, gen, "meta")
    assert _flat(pa) == _flat(ja)
    assert _flat(pv) == _flat(jv)


def test_init_distribution_matches_jax():
    """Uniform bounds of the vocoder init: +-sqrt(1/(ci*k)), zero biases."""
    gen = torch.Generator().manual_seed(0)
    pv = vocoder.init(jax_tiny().vocoder, gen, "cpu")
    w = pv["stages"][0]["up"]["w"]
    k, ci = w.shape[:2]
    bound = math.sqrt(1 / (ci * k))
    assert float(w.abs().max()) <= bound
    assert float(w.abs().max()) > 0.9 * bound
    assert float(pv["stages"][0]["up"]["b"].abs().max()) == 0.0


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import voicefixer_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "       or k == 'voicefixer_tpu' or k.startswith('voicefixer_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    from voicefixer_tpu_torch.pipeline.restore import VoiceFixer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VoiceFixer.random(0)
