"""The port's time-sharded vocoder (``parallel/sp.py``) on ("cpu",) * n
against the port's unsharded ``vocoder.apply`` and against the JAX package's
``vocoder.apply`` on the same numpy-filled parameters, with the JAX tests'
own cases (tests/test_sp.py): frame counts that do and do not divide the
shard count (the divisibility pad and the signal window) and a stack whose
reach exceeds one shard (halo rows from several neighbours).

Tolerance: rtol = atol = 2e-5, the JAX tests' (a float32 waveform bounded by
tanh, summed in another order by another library).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicefixer_tpu.config import tiny_test_config as jax_tiny
from voicefixer_tpu.models import vocoder as jax_vocoder
from voicefixer_tpu.pipeline import vocoder_facade as jax_facade

from voicefixer_tpu_torch.config import tiny_test_config
from voicefixer_tpu_torch.models import vocoder
from voicefixer_tpu_torch.parallel.sp import (apply_sp, exchange_halo,
                                              synthesize_sp)
from voicefixer_tpu_torch.pipeline import vocoder_facade
from voicefixer_tpu_torch.utils.weights import from_jax_params
from tests.test_torch_weights import (jax_param_trees,  # noqa: F401
                                      one_torch_thread)

TOL = 2e-5


def _small(depth):
    """(port vocoder config, JAX vocoder config): 32 channels, ``depth``
    blocks a stage, as tests/test_sp.py::small_vcfg."""
    kw = dict(channels=32, cond_channels=16, resstack_depth=(depth,) * 4)
    return (dataclasses.replace(tiny_test_config().vocoder, **kw),
            dataclasses.replace(jax_tiny().vocoder, **kw))


@functools.lru_cache(maxsize=None)
def _setup(depth, t_mel, batch):
    """(cfg, port params, mel, port unsharded wav, JAX wav) of one case."""
    cfg, jcfg = _small(depth)
    _, jv = jax_param_trees(40 + depth, dataclasses.replace(jax_tiny(),
                                                            vocoder=jcfg))
    ja, _ = jax_param_trees(0)
    _, pv = from_jax_params(ja, jv, "cpu")
    mel = (0.5 * np.random.default_rng(t_mel).standard_normal(
        (batch, t_mel, cfg.in_channels))).astype(np.float32)
    ref_jax = np.asarray(jax.jit(functools.partial(
        jax_vocoder.apply, cfg=jcfg))(jv, jnp.asarray(mel)))
    ref_port = vocoder.apply(pv, torch.from_numpy(mel), cfg).numpy()
    return cfg, pv, mel, ref_port, ref_jax


@pytest.mark.parametrize("n,t_mel", [(2, 48), (4, 48), (2, 50), (4, 50),
                                     (8, 50)])  # 50 divides neither 4 nor 8
def test_apply_sp_matches_unsharded(n, t_mel):
    cfg, pv, mel, ref_port, ref_jax = _setup(4, t_mel, 2)
    got = apply_sp(pv, torch.from_numpy(mel), cfg, ("cpu",) * n).numpy()
    assert got.shape == ref_port.shape == ref_jax.shape
    np.testing.assert_allclose(got, ref_port, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, ref_jax, rtol=TOL, atol=TOL)


def test_apply_sp_multi_hop_halo():
    """Depth 6: a reach of 370 rows against stage-0 shards of 14 rows, so
    the halo comes from several neighbours a side."""
    cfg, pv, mel, ref_port, ref_jax = _setup(6, 16, 1)
    got = apply_sp(pv, torch.from_numpy(mel), cfg, ("cpu",) * 8).numpy()
    np.testing.assert_allclose(got, ref_port, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, ref_jax, rtol=TOL, atol=TOL)


def test_apply_sp_takes_per_device_params():
    """A list of per-device parameter copies, as ``VoiceFixer`` holds them,
    gives what one tree gives."""
    cfg, pv, mel, ref_port, _ = _setup(4, 48, 2)
    got = apply_sp([pv, pv], torch.from_numpy(mel), cfg, ("cpu", "cpu"))
    np.testing.assert_allclose(got.numpy(), ref_port, rtol=TOL, atol=TOL)


def test_synthesize_sp_matches_facade():
    cfg, jcfg = _small(4)
    _, jv = jax_param_trees(44, dataclasses.replace(jax_tiny(),
                                                    vocoder=jcfg))
    ja, _ = jax_param_trees(0)
    _, pv = from_jax_params(ja, jv, "cpu")
    mel = np.abs(np.random.default_rng(5).standard_normal(
        (1, 41, cfg.in_channels))).astype(np.float32)
    ref_jax = jax.jit(functools.partial(jax_facade.synthesize, cfg=jcfg))(
        jv, jnp.asarray(mel))
    ref = vocoder_facade.synthesize(pv, torch.from_numpy(mel), cfg)
    got = synthesize_sp(pv, torch.from_numpy(mel), cfg, ("cpu",) * 4)
    assert tuple(got.shape) == tuple(ref.shape) == ref_jax.shape
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_jax), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("h", [1, 3, 8, 12, 17])
def test_exchange_halo(h):
    """Four shards of 8 rows: each gets h rows a side from as many
    neighbours as that takes (12 and 17 exceed a shard), zeros at the two
    ends; the case of tests/test_sp.py is h = 12."""
    x = torch.arange(4 * 8 * 4, dtype=torch.float32).reshape(1, 32, 4)
    got = exchange_halo([x[:, i * 8:(i + 1) * 8] for i in range(4)], h)
    xp = torch.nn.functional.pad(x, (0, 0, h, h))
    for d in range(4):
        assert torch.equal(got[d], xp[:, d * 8: d * 8 + 8 + 2 * h])


def test_apply_sp_window_matters():
    """The divisibility pad is not silence to the generator: without the
    signal window the last shard's tail leaks into the signal's end."""
    from voicefixer_tpu_torch.models import vocoder as vmod
    cfg, pv, mel, ref_port, _ = _setup(4, 50, 2)
    real = vmod._res_stack

    def no_window(params, x, kernel, slope, final_slope=None,
                  mask_bounds=None):
        return real(params, x, kernel, slope, final_slope, None)

    vmod._res_stack = no_window
    try:
        got = apply_sp(pv, torch.from_numpy(mel), cfg, ("cpu",) * 4).numpy()
    finally:
        vmod._res_stack = real
    assert np.abs(got - ref_port).max() > 100 * TOL
