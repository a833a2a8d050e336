"""Checkpoint conversion and loading of the port against the JAX package:
both packages' converters on one upstream-layout state dict
(``tools/torch_ref_state_dict.py``), the integrity checks of
``pipeline.checkpoints`` on files the tests write, the resolution order
with every cache path in ``tmp_path``, and ``VoiceFixer(ckpt=...)``.

The converters hard-code upstream's structure (6 encoder levels of 4
blocks, 4 vocoder stages of 8 blocks), which ``tiny_test_config`` does not
have, so the state dicts here take that structure at narrow widths
(``NARROW``).
"""

import dataclasses
import json
import os
import zipfile

import numpy as np
import pytest
import torch

from voicefixer_tpu.config import tiny_test_config as jax_tiny
from voicefixer_tpu.pipeline import checkpoints as JC
from voicefixer_tpu.utils import weights as JW

from voicefixer_tpu_torch.config import tiny_test_config
from voicefixer_tpu_torch.pipeline import checkpoints as C
from voicefixer_tpu_torch.pipeline.restore import VoiceFixer
from voicefixer_tpu_torch.utils import weights as W
from tests.test_torch_weights import (jax_param_trees, jax_shapes,
                                      one_torch_thread)  # noqa: F401
from tools.torch_ref_state_dict import (analysis_state_dict,
                                        vocoder_state_dict, write_checkpoints)


def _narrow(cfg):
    return dataclasses.replace(
        cfg,
        denoiser=dataclasses.replace(cfg.denoiser, base_width=8),
        unet=dataclasses.replace(cfg.unet, encoder_channels=(2, 4, 4, 8, 8, 8),
                                 blocks_per_stage=4, center_channels=8))


NARROW, JAX_NARROW = _narrow(tiny_test_config()), _narrow(jax_tiny())


def _equal_trees(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _equal_trees(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_trees(x, y, f"{path}/{i}")
    else:
        if isinstance(a, torch.Tensor):
            a, b = a.numpy(), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


# --------------------------------------------------------------- converters

@pytest.fixture(scope="module")
def analysis_sd():
    return analysis_state_dict(NARROW, 3)


def test_convert_analysis_matches_jax(analysis_sd):
    """Both converters give one tree, of the shapes the JAX package's init
    gives at the same widths, and the port's bridge takes every leaf."""
    ref = JW.convert_analysis(analysis_sd)
    got = W.convert_analysis(analysis_sd)
    _equal_trees(got, ref)
    assert _shapes(got) == _shapes(jax_shapes(JAX_NARROW)[0])
    W.convert_tree(got, "analysis")


@pytest.mark.parametrize("weight_norm", ["weight_g", "parametrizations",
                                         None])
def test_convert_vocoder_matches_jax(weight_norm):
    """Weight norm stored either way (or none), folded in float64 by both
    packages alike, W = g v / ||v||."""
    sd = vocoder_state_dict(NARROW, 4, weight_norm)
    ref = JW.convert_vocoder(sd)
    got = W.convert_vocoder(sd)
    _equal_trees(got, ref)
    assert _shapes(got) == _shapes(jax_shapes(JAX_NARROW)[1])
    W.convert_tree(got, "vocoder")
    if weight_norm is not None:
        key = ("generator.4.layers.2.1.weight_v" if weight_norm == "weight_g"
               else "generator.4.layers.2.1.parametrizations.weight.original1")
        v = sd[key]
        g = sd[key[:-1] + ("g" if weight_norm == "weight_g" else "0")]
        w = g * v / np.sqrt((v.astype(np.float64) ** 2).sum((1, 2),
                                                           keepdims=True))
        np.testing.assert_allclose(got["stages"][0]["res"][2]["c1"]["w"],
                                   w.transpose(2, 1, 0), rtol=1e-6)


@pytest.mark.parametrize("which,old,new", [
    ("analysis", "generator.unet.conv_block7.bn1.running_var",
     "generator.unet.conv_block7.bn1.running_variance"),
    ("analysis", "generator.denoiser.7.gru.weight_hh_l1_reverse",
     "generator.denoiser.7.gru.weight_hh_l1_rev"),
    ("vocoder", "generator.10.layers.5.3.weight_g",
     "generator.10.layers.5.3.weight_gain"),
])
def test_renamed_key_raises_in_both(analysis_sd, which, old, new):
    sd = dict(analysis_sd) if which == "analysis" \
        else vocoder_state_dict(NARROW, 4)
    sd[new] = sd.pop(old)
    for mod in (JW, W):
        convert = getattr(mod, f"convert_{which}")
        with pytest.raises(KeyError):
            convert(sd)


def test_load_torch_state_dict_matches_jax(tmp_path):
    """Both files as upstream stores them, read back by both packages."""
    a, v = str(tmp_path / "vf.ckpt"), str(tmp_path / "model.pt")
    write_checkpoints(NARROW, 5, a, v)
    for path in (a, v):
        got, ref = W.load_torch_state_dict(path), JW.load_torch_state_dict(path)
        assert got.keys() == ref.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], ref[k])
    assert "condnet.0.weight_g" in got


# ---------------------------------------------------------- integrity checks

def _valid_ckpt(path, size=C._MIN_CKPT_BYTES + 1024):
    """Passes the structural checks: zip magic and the size floor."""
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("data.bin", b"\x00" * size)


def test_html_error_page_rejected(tmp_path):
    bad = tmp_path / "vf.ckpt"
    bad.write_text("<html><body>503 Service Unavailable</body></html>")
    with pytest.raises(RuntimeError, match="truncated download"):
        C.verify_checkpoint(str(bad), "analysis")


def test_bad_magic_rejected(tmp_path):
    bad = tmp_path / "vf.ckpt"
    bad.write_bytes(b"\x00" * (C._MIN_CKPT_BYTES + 1))
    with pytest.raises(RuntimeError, match="does not look like a torch"):
        C.verify_checkpoint(str(bad), "analysis")


def test_sidecar_written_and_rechecked(tmp_path):
    """The sidecar the port writes is the JAX package's, and each package
    accepts the other's."""
    ck = tmp_path / "vf.ckpt"
    _valid_ckpt(str(ck))
    digest = C.verify_checkpoint(str(ck), "analysis")
    sidecar = str(ck) + ".integrity.json"
    rec = json.load(open(sidecar))
    assert rec == {"size": os.path.getsize(ck), "sha256": digest}
    assert len(digest) == 64
    assert C.verify_checkpoint(str(ck), "analysis") == digest
    assert JC.verify_checkpoint(str(ck), "analysis") == digest


def test_size_change_detected(tmp_path):
    ck = tmp_path / "vf.ckpt"
    _valid_ckpt(str(ck))
    C.verify_checkpoint(str(ck), "analysis")
    with open(ck, "ab") as f:
        f.write(b"junk")
    with pytest.raises(RuntimeError, match="changed size"):
        C.verify_checkpoint(str(ck), "analysis")


def test_silent_corruption_detected_by_digest(tmp_path):
    ck = tmp_path / "vf.ckpt"
    _valid_ckpt(str(ck))
    C.verify_checkpoint(str(ck), "analysis")
    with open(ck, "r+b") as f:  # flip bytes, keep the size
        f.seek(os.path.getsize(ck) // 2)
        f.write(b"\xff\xff\xff\xff")
    C.verify_checkpoint(str(ck), "analysis", deep=False)
    with pytest.raises(RuntimeError, match="sha256 mismatch"):
        C.verify_checkpoint(str(ck), "analysis", deep=True)


def test_env_pin(tmp_path, monkeypatch):
    ck = tmp_path / "model.pt"
    _valid_ckpt(str(ck))
    monkeypatch.setenv("VOICEFIXER_TPU_VOCODER_SHA256", "0" * 64)
    with pytest.raises(RuntimeError, match="pinned digest"):
        C.verify_checkpoint(str(ck), "vocoder")
    digest = C.verify_checkpoint(str(ck), "analysis")  # the other pin
    monkeypatch.setenv("VOICEFIXER_TPU_VOCODER_SHA256", digest.upper())
    assert C.verify_checkpoint(str(ck), "vocoder") == digest


def test_npz_provenance_roundtrip(tmp_path):
    """The npz format is the JAX package's: written by either package, read
    by the other, the reserved key kept out of the tree."""
    path, bare = str(tmp_path / "p.npz"), str(tmp_path / "bare.npz")
    tree = {"a": np.ones((2,), np.float32),
            "b": [np.zeros((1,), np.float32), torch.ones(3)]}
    W.save_pytree_npz(tree, path, provenance="random-init seed=0")
    assert W.npz_provenance(path) == JW.npz_provenance(path) \
        == "random-init seed=0"
    loaded = JW.load_pytree_npz(path)
    assert set(loaded) == {"a", "b"}
    np.testing.assert_array_equal(loaded["b"][1], np.ones(3, np.float32))
    W.save_pytree_npz(tree, bare)
    assert W.npz_provenance(bare) is None
    ja, jv = jax_param_trees(6)
    JW.save_pytree_npz(jv, bare)
    _equal_trees(W.load_pytree_npz(bare), JW.load_pytree_npz(bare))


# -------------------------------------------------------- resolution order

@pytest.fixture
def caches(tmp_path, monkeypatch):
    """Every cache path of both packages in tmp_path: the torch
    checkpoints under ref/, the npz cache under npz/."""
    paths = {"TORCH_ANALYSIS_CKPT": tmp_path / "ref" / "vf.ckpt",
             "TORCH_VOCODER_CKPT": tmp_path / "ref" / "model.pt",
             "CACHE_DIR": tmp_path / "npz",
             "ANALYSIS_NPZ": tmp_path / "npz" / "analysis.npz",
             "VOCODER_NPZ": tmp_path / "npz" / "vocoder.npz"}
    for mod in (C, JC):
        for k, v in paths.items():
            monkeypatch.setattr(mod, k, str(v))
    (tmp_path / "ref").mkdir()
    return {k: str(v) for k, v in paths.items()}


@pytest.mark.parametrize("download", [True, False])
def test_no_local_file_raises(caches, download):
    """Nothing local: a RuntimeError naming both paths and the Zenodo
    record, whatever ``download`` says."""
    for load, url, where in (
            (C.load_analysis_params, C.ZENODO_ANALYSIS_URL, "ANALYSIS"),
            (C.load_vocoder_params, C.ZENODO_VOCODER_URL, "VOCODER")):
        with pytest.raises(RuntimeError) as e:
            load(download=download)
        msg = str(e.value)
        assert url in msg and "does not download" in msg
        assert caches[f"{where}_NPZ"] in msg
        assert caches[f"TORCH_{where}_CKPT"] in msg
    assert not os.path.exists(caches["CACHE_DIR"])


def test_converted_npz_carries_torch_provenance(caches, monkeypatch):
    """The reference's torch cache is verified, converted, and written to
    the npz cache with its source and digest; the next load reads the npz
    (the torch file may go), and the JAX package reads the same cache to
    the same tree."""
    monkeypatch.setattr(C, "_MIN_CKPT_BYTES", 1024)
    write_checkpoints(NARROW, 7, caches["TORCH_ANALYSIS_CKPT"],
                      caches["TORCH_VOCODER_CKPT"], "parametrizations")
    got = C.load_vocoder_params(download=False)
    prov = W.npz_provenance(caches["VOCODER_NPZ"])
    digest = json.load(open(caches["TORCH_VOCODER_CKPT"]
                            + ".integrity.json"))["sha256"]
    assert prov == (f"converted-from-torch source="
                    f"{caches['TORCH_VOCODER_CKPT']} sha256={digest}")
    _equal_trees(got, JW.convert_vocoder(JW.load_torch_state_dict(
        caches["TORCH_VOCODER_CKPT"])))
    os.remove(caches["TORCH_VOCODER_CKPT"])
    _equal_trees(C.load_vocoder_params(), got)
    _equal_trees(JC.load_vocoder_params(download=False), got)
    a = C.load_analysis_params()
    _equal_trees(JC.load_analysis_params(download=False), a)


def test_explicit_path_wins(caches, tmp_path):
    """An explicit path, npz or torch, is read before any cache."""
    _, jv = jax_param_trees(8)
    os.makedirs(caches["CACHE_DIR"])
    JW.save_pytree_npz(jax_param_trees(9)[1], caches["VOCODER_NPZ"])
    npz = str(tmp_path / "voc.npz")
    JW.save_pytree_npz(jv, npz)
    _equal_trees(C.load_vocoder_params(npz), JW.load_pytree_npz(npz))
    v = str(tmp_path / "model.pt")
    write_checkpoints(NARROW, 10, str(tmp_path / "vf.ckpt"), v, None)
    _equal_trees(C.load_vocoder_params(v), JC.load_vocoder_params(v))
    _equal_trees(C.load_vocoder_params(), JW.load_pytree_npz(
        caches["VOCODER_NPZ"]))


def test_voicefixer_from_npz_checkpoints(tmp_path):
    """``VoiceFixer(ckpt=npz, vocoder_ckpt=npz)`` holds the trees that
    ``from_jax_params`` makes of the JAX-loaded ones, and restores the
    same."""
    ja, jv = jax_param_trees(11)
    a, v = str(tmp_path / "a.npz"), str(tmp_path / "v.npz")
    JW.save_pytree_npz(ja, a)
    JW.save_pytree_npz(jv, v)
    cfg = tiny_test_config()
    vf = VoiceFixer(ckpt=a, vocoder_ckpt=v, config=cfg, device="cpu")
    pa, pv = W.from_jax_params(JW.load_pytree_npz(a), JW.load_pytree_npz(v))
    ref = VoiceFixer(pa, pv, config=cfg, device="cpu")
    _equal_trees(vf.params, ref.params)
    _equal_trees(vf.vocoder_params, ref.vocoder_params)
    wav = (0.1 * np.random.default_rng(12).standard_normal(
        cfg.pipeline.seg_length)).astype(np.float32)
    np.testing.assert_array_equal(vf.restore_inmem(wav),
                                  ref.restore_inmem(wav))
    # one tree given, the other loaded
    half = VoiceFixer(pa, None, config=cfg, device="cpu", vocoder_ckpt=v)
    _equal_trees(half.vocoder_params, ref.vocoder_params)


def test_voicefixer_from_torch_checkpoints_matches_jax(tmp_path):
    """One pair of upstream-layout torch checkpoints, loaded by both
    packages' ``VoiceFixer(ckpt=..., vocoder_ckpt=...)``, restores the same
    audio within the pipeline's 1e-5."""
    from voicefixer_tpu.pipeline import restore as jax_restore
    a, v = str(tmp_path / "vf.ckpt"), str(tmp_path / "model.pt")
    write_checkpoints(NARROW, 13, a, v)
    wav = (0.1 * np.random.default_rng(14).standard_normal(30000)
           ).astype(np.float32)
    ref = jax_restore.VoiceFixer(ckpt=a, vocoder_ckpt=v, config=JAX_NARROW,
                                 download=False).restore_inmem(wav)
    got = VoiceFixer(ckpt=a, vocoder_ckpt=v, config=NARROW, download=False,
                     device="cpu").restore_inmem(wav)
    assert got.shape == ref.shape == wav.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
