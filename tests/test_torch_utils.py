"""The port's ``utils.flops``, ``utils.io``, ``utils.plotting`` and
``utils.profiling`` against the JAX package's: the FLOP counts integer-equal,
the files the same; ``profiling.trace`` names an annotated range."""

import json
import os

import numpy as np
import pytest
import torch

from voicefixer_tpu.config import DEFAULT_CONFIG as JAX_DEFAULT
from voicefixer_tpu.config import tiny_test_config as jax_tiny
from voicefixer_tpu.utils import flops as jax_flops
from voicefixer_tpu.utils import io as jax_io
from voicefixer_tpu.utils import plotting as jax_plotting

from voicefixer_tpu_torch.config import DEFAULT_CONFIG, tiny_test_config
from voicefixer_tpu_torch.utils import flops, io, plotting, profiling
from tests.test_torch_weights import one_torch_thread  # noqa: F401

CONFIGS = {"default": (DEFAULT_CONFIG, JAX_DEFAULT),
           "tiny": (tiny_test_config(), jax_tiny())}


@pytest.mark.parametrize("seconds", [30.0, 1.0, 0.25, 45.5])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_flops_equal_jax(config, seconds):
    cfg, jcfg = CONFIGS[config]
    n = int(cfg.pipeline.sample_rate * seconds)
    t = n // cfg.stft.hop_length + 1
    pairs = [(flops.pipeline_flops(cfg, seconds),
              jax_flops.pipeline_flops(jcfg, seconds)),
             (flops.stft_flops(cfg, n), jax_flops.stft_flops(jcfg, n)),
             (flops.vocoder_flops(cfg.vocoder, t),
              jax_flops.vocoder_flops(jcfg.vocoder, t)),
             (flops.resunet_flops(cfg.unet, t),
              jax_flops.resunet_flops(jcfg.unet, t)),
             (flops.resunet_flops(cfg.unet, t, n_freq=64),
              jax_flops.resunet_flops(jcfg.unet, t, n_freq=64)),
             (flops.denoiser_flops(cfg.denoiser, t),
              jax_flops.denoiser_flops(jcfg.denoiser, t))]
    for ours, theirs in pairs:
        assert type(ours) is int and int(theirs) == theirs
        assert ours == int(theirs)
    stft, vocoder, resunet, _, denoiser = (p[0] for p in pairs[1:])
    assert pairs[0][0] == stft + vocoder + resunet + denoiser


def test_flops_default_chunk():
    """About 3.40 TFLOP a 30 s chunk at full width."""
    f = flops.pipeline_flops(DEFAULT_CONFIG, 30.0)
    assert 3.3e12 < f < 3.5e12


def test_io_round_trips(tmp_path):
    data = {"a": [1, 2.5, None], "b": {"c": "d"}}
    d = io.find_and_build(str(tmp_path / "x" / "y"))
    assert os.path.isdir(d) and d == str(tmp_path / "x" / "y")
    assert io.find_and_build(d) == d  # exists already
    ours, theirs = os.path.join(d, "a.json"), os.path.join(d, "b.json")
    io.write_json(data, ours)
    jax_io.write_json(data, theirs)
    assert open(ours).read() == open(theirs).read()
    assert io.load_json(ours) == data == jax_io.load_json(ours)
    obj = {"arr": np.arange(5), "t": (1, "x")}
    io.save_pickle(obj, os.path.join(d, "o.pkl"))
    back = io.load_pickle(os.path.join(d, "o.pkl"))
    np.testing.assert_array_equal(back["arr"], obj["arr"])
    assert back["t"] == obj["t"]
    jax_back = jax_io.load_pickle(os.path.join(d, "o.pkl"))
    np.testing.assert_array_equal(jax_back["arr"], obj["arr"])


@pytest.mark.parametrize("as_tensor", [False, True])
def test_clip_matches_jax(as_tensor):
    rng = np.random.default_rng(0)
    mels = [rng.standard_normal((3, 7)).astype(np.float32) for _ in range(3)]
    ins = [torch.from_numpy(m).requires_grad_() for m in mels] \
        if as_tensor else mels
    assert plotting.clip(*ins) == jax_plotting.clip(*mels)
    assert plotting.clip(ins[0]) == jax_plotting.clip(mels[0])


def test_draw_and_save_writes_png(tmp_path):
    pytest.importorskip("matplotlib")
    mel = torch.from_numpy(np.abs(np.random.default_rng(0).standard_normal(
        (1, 1, 64, 128))).astype(np.float32))
    out = tmp_path / "mel.png"
    plotting.draw_and_save(mel, str(out))
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert out.stat().st_size > 1000


def test_draw_and_save_rejects_negative_under_log(tmp_path):
    pytest.importorskip("matplotlib")
    mel = np.full((4, 4), -1.0, dtype=np.float32)
    with pytest.raises(AssertionError):
        plotting.draw_and_save(mel, str(tmp_path / "bad.png"))
    assert not (tmp_path / "bad.png").exists()
    plotting.draw_and_save(mel, str(tmp_path / "ok.png"), needlog=False)
    assert (tmp_path / "ok.png").exists()


def test_trace_names_annotated_region(tmp_path):
    with profiling.trace(str(tmp_path), device="cpu") as d:
        with profiling.annotate("vf.test_region"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert d == str(tmp_path)
    events = json.load(open(tmp_path / profiling.TRACE_FILE))["traceEvents"]
    names = {e.get("name") for e in events}
    assert "vf.test_region" in names and "aten::mm" in names


def test_trace_needs_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with profiling.trace(str(tmp_path)):
            pass
