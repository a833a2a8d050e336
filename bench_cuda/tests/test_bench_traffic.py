"""The traffic generator: deterministic in its seed, the stated lengths,
the same work for every seed; requests take the next recordings of the
order."""

import json
import math
from statistics import NormalDist

import numpy as np
import pytest

from bench_cuda import generator, spec

MIXES = sorted(p.stem for p in (spec.HERE / "traffic").glob("*.json"))
SR = 44100


@pytest.mark.parametrize("name", MIXES)
def test_lengths_are_the_distributions_quantiles(name):
    mix = spec.traffic(name)
    generator.validate(mix)
    d = mix["seconds"]
    lens = np.array(generator.lengths(mix, SR)) / SR
    assert len(lens) == mix["pool"]
    assert np.all(np.diff(lens) > 0)
    assert d["min"] <= lens.min() and lens.max() <= d["max"]
    q = (np.arange(mix["pool"]) + 0.5) / mix["pool"]
    want = {"uniform": d["min"] + q * (d["max"] - d["min"]),
            "log_uniform": d["min"] * (d["max"] / d["min"]) ** q}.get(
        d["dist"])
    if want is None:
        want = [d["median"] * math.exp(d["sigma"] * NormalDist().inv_cdf(x))
                for x in q]
    assert np.allclose(lens, np.clip(want, d["min"], d["max"]), atol=1e-4)


def test_a_lognormal_is_cut_to_its_range():
    mix = _mix(pool=8)
    mix["seconds"] = {"dist": "lognormal", "median": 1.0, "sigma": 3.0,
                      "min": 0.5, "max": 2.0}
    lens = np.array(generator.lengths(mix, SR)) / SR
    assert lens.min() == pytest.approx(0.5) and lens.max() == \
        pytest.approx(2.0)


def test_the_mixes_cite_their_source():
    for name in MIXES:
        about = spec.traffic(name)["about"]
        assert "(" in about and any(str(y) in about for y in range(1990,
                                                                   2030))


def _mix(**kw):
    mix = spec.traffic("interactive") | {"pool": 3}
    mix["seconds"] = {"dist": "uniform", "min": 0.2, "max": 0.4}
    return mix | kw


def test_recordings_are_deterministic_in_the_seed():
    mix = _mix()
    a = generator.recordings(mix, 2 ** 31 + 3, SR, "cpu")
    b = generator.recordings(mix, 2 ** 31 + 3, SR, "cpu")
    c = generator.recordings(mix, 2 ** 31 + 4, SR, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert [x.shape for x in a] == [x.shape for x in c]
    assert not any(np.array_equal(x, y) for x, y in zip(a, c))
    assert np.array_equal(generator.order(mix, 5), generator.order(mix, 5))
    assert sorted(generator.order(mix, 6)) == list(range(3))
    for x in a:
        assert x.dtype == np.float32 and np.all(np.isfinite(x))
        assert np.max(np.abs(x)) == pytest.approx(0.9, rel=1e-5)


@pytest.mark.parametrize("per,want", [(1, [[2], [0], [1], [2]]),
                                      (2, [[2, 0], [1, 2], [0, 1], [2, 0]])])
def test_a_request_takes_the_next_recordings_of_the_order(per, want):
    mix = _mix(per_request=per)
    order = np.array([2, 0, 1])
    assert [generator.request(mix, order, k) for k in range(4)] == want


@pytest.mark.parametrize("bad", [{"loop": "open"}, {"clients": 4},
                                 {"per_request": 4},
                                 {"seconds": {"dist": "normal", "min": 1,
                                              "max": 2}},
                                 {"seconds": {"dist": "lognormal", "min": 1,
                                              "max": 2, "median": 1,
                                              "sigma": 0}}])
def test_validate_refuses_what_the_generator_cannot_make(bad):
    with pytest.raises(ValueError):
        generator.validate(_mix(**bad))


def test_every_mix_is_json_the_generator_reads():
    for name in MIXES:
        mix = json.loads((spec.HERE / "traffic" / f"{name}.json")
                         .read_text())
        generator.validate(mix)
        spec.entry(mix["entry"]).validate(mix.get("kwargs", {}))
