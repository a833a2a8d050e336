"""The plain reference agrees with the program's CPU path, and the weights
drawn on the device follow the frozen drawer's layout."""

import numpy as np
import pytest
import torch

from bench_cuda import model_config, program, spec, weights
from bench_cuda.check import rel
from bench_cuda.frozen import ref_state_dict
from bench_cuda.reference.model import Reference
from bench_cuda.tests.narrow import narrow_config

SEED = 2 ** 31 + 11


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(2)
    wav = (0.3 * np.random.default_rng(0).standard_normal(
        int(44100 * 2.5))).astype(np.float32)
    out = {}
    for name in ("voicefixer-44k-fp32", "voicefixer-44k-bf16"):
        cfg = narrow_config(spec.config(name))
        ns = model_config.namespace(cfg)
        sd = weights.draw(ns, SEED, "cpu")
        prog = program.Program(cfg, *weights.to_host(sd), "cpu")
        got = prog.serve(spec.entry("restore_inmem"), [wav], {"mode": 0})
        out[cfg["precision"]] = (ns, sd, got[0])
        prog.close()
    return wav, out


def test_reference_matches_the_program_in_parity(setup):
    wav, out = setup
    ns, sd, got = out["parity"]
    want = Reference(*sd, ns).restore(wav)
    assert got.shape == want.shape == wav.shape
    assert rel(got, want) < 1e-6


def test_production_error_is_that_of_its_own_precision(setup):
    wav, out = setup
    ns, sd, got = out["production"]
    want = Reference(*sd, ns).restore(wav)
    own = Reference(*sd, ns, "bf16").restore(wav)
    ratio = rel(got, want) / rel(own, want)
    assert 0.5 < ratio < 2.0, ratio


def test_device_weights_follow_the_frozen_layout():
    ns = model_config.namespace(narrow_config(spec.config(
        "voicefixer-44k-fp32")))
    drawn = weights.draw(ns, SEED, "cpu")
    again = weights.draw(ns, SEED, "cpu")
    frozen = (ref_state_dict.analysis_state_dict(ns, 0),
              ref_state_dict.vocoder_state_dict(ns, 0))
    for got, want, same in zip(drawn, frozen, again):
        assert list(got) == list(want)
        for k, v in want.items():
            if v.dtype.kind != "f":
                continue
            assert tuple(got[k].shape) == v.shape, k
            assert torch.equal(got[k], same[k]), k
    for k, v in drawn[1].items():
        if k.endswith(".weight_g"):
            assert bool((v > 0).all()), k
        if k.endswith(".bias"):
            assert float(v.abs().max()) <= weights.VOCODER_BIAS, k
    biases = torch.cat([v for k, v in drawn[1].items()
                        if k.endswith(".bias")])
    assert float(biases.abs().max()) > weights.VOCODER_BIAS / 2
    bound = np.sqrt(6 / (8 + 16))  # fc4: Linear(8, 16)
    w = drawn[0]["generator.denoiser.4.weight"]
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > bound / 2
