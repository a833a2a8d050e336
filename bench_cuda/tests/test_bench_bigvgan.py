"""The ``bigvgan`` family on the CPU at narrow widths (``narrow``: 128
channels down to 2, the convs' gains kept): its cell runs through the
unchanged harness and is correct, the readers take its fractional
segments (audio seconds), its control and each planted fault are not
correct, the weight draw is the seed's and the program's loader takes it
whole, and the frozen copies equal their origins."""

import importlib

import pytest
import torch

from bench_cuda import control, spec
from bench_cuda.frozen import work
from bench_cuda.tests import narrow
from bench_cuda.tests.test_bench_frozen import _segments
from bench_cuda.weights import to_host

CELL = "bigvgan-bf16-tts"


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    torch.set_num_threads(2)
    return narrow.make_base(tmp_path_factory.mktemp("bigvgan"))


def test_the_narrow_cell_runs_through_the_harness(base):
    r = narrow.run(base, CELL, seconds=0.5, traced=True)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert r["checks"]["err_ratio"]["value"] < 1.5
    assert r["readings"]["clamped_share"] < 0.01
    family = spec.family("bigvgan", base)
    ns = family.namespace(spec.config("bigvgan-v2-44k-bf16", base))
    rate = r["metrics"]["mfu.latency"]["value"] * work.PEAK_BF16 / 100
    assert rate > 0 and family.flops_per_segment(ns) > 0
    # the CPU's trace has no device events: the device readers say None
    assert not {"aa_act_device_ms.latency", "aa_act_roofline.latency",
                "kernels_roofline.latency"} & set(r["metrics"])


@pytest.mark.parametrize("stand_in", ["control", "no_antialias",
                                      "beta_ignored", "branch_dropped"])
def test_the_control_and_each_fault_are_not_correct(base, stand_in):
    family = spec.family("bigvgan", base)
    make = (control.ControlProgram if stand_in == "control"
            else control.faulty(stand_in, family))
    r = narrow.run(base, CELL, seconds=0.3, make_program=make)
    assert not r["correct"], r["checks"]
    assert r["checks"]["err_ratio"]["value"] > 8.0


def test_the_draw_is_the_seeds_and_the_loader_takes_it(base):
    from voicefixer_tpu_torch.utils.weights import convert_bigvgan
    family = spec.family("bigvgan", base)
    ns = family.namespace(spec.config("bigvgan-v2-44k-bf16", base))
    (a,), (b,) = family.draw(ns, 7, "cpu"), family.draw(ns, 7, "cpu")
    (c,) = family.draw(ns, 8, "cpu")
    assert set(a) == set(b) == set(c)
    w = "resblocks.4.convs1.2.weight_v"
    assert torch.equal(a[w], b[w]) and not torch.equal(a[w], c[w])
    assert a["activation_post.act.beta"].std() > 0.1  # beta is not 1
    # through the harness's one copy to the host: every key consumed, the
    # filters checked
    tree = convert_bigvgan(to_host((a,))[0])
    assert len(tree["resblocks"]) == 18


@pytest.mark.parametrize("module", ["bigvgan_flops", "bigvgan_work"])
def test_frozen_copy_equals_origin(module):
    mod = importlib.import_module(f"bench_cuda.frozen.{module}")
    origin = _segments(spec.ROOT / mod.ORIGIN, mod.FROZEN)
    copy = _segments(spec.HERE / "frozen" / f"{module}.py", mod.FROZEN)
    assert set(copy) == set(origin) == set(mod.FROZEN)
    for name in mod.FROZEN:
        assert copy[name] == origin[name], f"{module}.{name} drifted"
