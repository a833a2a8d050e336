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
import pathlib
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
                                               load_pytree_npz, pack_bn,
                                               pack_conv3x3, pack_shortcut,
                                               res_bank)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread while a module's tests run. The suite runs
    in several processes at once, and torch's default of a thread per core
    in each of them oversubscribes the CPU many times over: the port's
    tests took about four times as long. The other test_torch_* files
    import this fixture, which applies it to them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def test_res_bank_matches_jax_stack_w():
    """The [n, 3*C, C] banks the ResStack kernels multiply by are the JAX
    kernels' ``_stack_w`` of the same blocks."""
    import jax.numpy as jnp
    from voicefixer_tpu.kernels.resstack import _stack_w
    _, jv = jax_param_trees()
    _, pv = from_jax_params(*jax_param_trees(), "cpu")
    blocks, jblocks = pv["stages"][1]["res"][2:5], jv["stages"][1]["res"][2:5]
    w1s, b1s, w2s, b2s = res_bank(blocks)
    n, _, ch, _ = w1s.shape
    for key, ws, bs in (("c1", w1s, b1s), ("c2", w2s, b2s)):
        ref = _stack_w(jnp.stack([jnp.asarray(b[key]["w"]) for b in jblocks]),
                       jnp.float32)
        assert ws.is_contiguous()
        np.testing.assert_array_equal(ws.reshape(n, 3 * ch, ch).numpy(),
                                      np.asarray(ref))
        np.testing.assert_array_equal(
            bs.numpy(), np.stack([b[key]["b"] for b in jblocks]))


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import voicefixer_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "for m in ('parallel.sp', 'kernels.convblock', 'pipeline.checkpoints',\n"
        "          'utils.audio_io', 'utils.flac', 'utils.flac_enc',\n"
        "          '__main__', 'train', 'train.step', 'train.losses',\n"
        "          'train.data', 'train.augment', 'train.checkpoint',\n"
        "          'utils.params'):\n"
        "    assert 'voicefixer_tpu_torch.' + m in sys.modules, m\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in\n"
        "       ('jax', 'optax', 'voicefixer_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    # chip_smoke.py and the shared checkpoint writer, every import in them
    # (inside functions too)
    import ast
    root = pathlib.Path(__file__).resolve().parent.parent
    for rel in ("chip_smoke.py", "tools/torch_ref_state_dict.py"):
        names = []
        for node in ast.walk(ast.parse((root / rel).read_text())):
            if isinstance(node, ast.Import):
                names += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names.append(node.module or "")
        assert "voicefixer_tpu_torch" in " ".join(names) or rel != \
            "chip_smoke.py"
        bad = [n for n in names if n.split(".")[0] in ("jax",
                                                       "voicefixer_tpu")]
        assert not bad, (rel, bad)


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    from voicefixer_tpu_torch.pipeline.restore import VoiceFixer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VoiceFixer.random(0)


@pytest.mark.parametrize("dtype,ci,ci_p", [(torch.float32, 2, 2),
                                           (torch.bfloat16, 2, 8),
                                           (torch.bfloat16, 16, 16)])
def test_conv_block_packing(dtype, ci, ci_p):
    """The layouts csrc/convblock.cu reads: [9*Ci_p, Co] tap-major with zero
    rows up to a multiple of 8 in bfloat16, the shortcut's bias as its last
    row, float32 (scale, shift)."""
    co = 8
    g = torch.Generator().manual_seed(0)
    w = torch.randn((3, 3, ci, co), generator=g)
    packed = pack_conv3x3(w, dtype)
    assert packed.shape == (9 * ci_p, co) and packed.dtype == dtype
    assert packed.is_contiguous()
    view = packed.reshape(3, 3, ci_p, co)
    assert torch.equal(view[:, :, :ci], w.to(dtype))
    assert float(view[:, :, ci:].float().abs().sum()) == 0.0
    sc = {"w": torch.randn((1, 1, ci, co), generator=g),
          "b": torch.randn((co,), generator=g)}
    ps = pack_shortcut(sc, dtype)
    assert ps.shape == (ci_p + 1, co) and ps.dtype == dtype
    assert torch.equal(ps[:ci], sc["w"][0, 0].to(dtype))
    assert torch.equal(ps[-1], sc["b"].to(dtype))
    assert float(ps[ci:-1].float().abs().sum()) == 0.0
    scale, shift = pack_bn({"scale": torch.ones(ci, dtype=dtype),
                            "shift": torch.zeros(ci, dtype=dtype)})
    assert scale.dtype == shift.dtype == torch.float32
