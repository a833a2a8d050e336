"""``correct`` rejects the control (the reference one step below the
configuration's precision, put in the program's place) and the program
with its timed path broken underneath; it accepts the program."""

import json

import pytest
import torch

from bench_cuda import control, spec
from bench_cuda.tests import narrow

FAMILY = spec.family("voicefixer")


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    torch.set_num_threads(2)
    return narrow.make_base(tmp_path_factory.mktemp("narrow"))


@pytest.mark.parametrize("cell", ["fp32-interactive", "bf16-interactive",
                                  "bf16-longform"])
def test_the_control_is_not_correct(base, cell):
    r = narrow.run(base, cell, seconds=0.5,
                   make_program=control.ControlProgram)
    assert not r["correct"], r["checks"]


# each fault a cell can have: half of a call's rows left out needs calls of
# several rows (the long recordings); an answer altered and the post-conv's
# bias dropped, every cell; the pre-conv's bias dropped, in parity
@pytest.mark.parametrize("cell,fault", [
    ("bf16-longform", "half_batch"), ("bf16-longform", "altered"),
    ("bf16-interactive", "altered"), ("fp32-interactive", "altered"),
    ("bf16-longform", "post_bias_dropped"),
    ("bf16-interactive", "post_bias_dropped"),
    ("fp32-interactive", "post_bias_dropped"),
    ("fp32-interactive", "pre_bias_dropped")])
def test_a_broken_timed_path_is_not_correct(base, cell, fault):
    r = narrow.run(base, cell, make_program=control.faulty(fault, FAMILY))
    assert not r["correct"], r["checks"]


def test_an_unknown_fault_is_refused():
    with pytest.raises(KeyError):
        control.faulty("slow", FAMILY)


@pytest.mark.parametrize("cell", ["bf16-longform", "fp32-interactive"])
def test_the_program_is_correct(base, cell):
    r = narrow.run(base, cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0


def test_a_cell_of_new_files_alone_runs_and_is_correct(base):
    """A later cell added as data alone: a new mix through another entry
    point (``restore_wavs``, two recordings a request) and a new
    configuration that passes ``VoiceFixer`` another keyword argument."""
    mix = json.loads((base / "traffic" / "interactive.json").read_text())
    mix |= {"entry": "restore_wavs", "kwargs": {"max_batch": 2},
            "per_request": 2, "warmup": 1}
    (base / "traffic" / "dataset.json").write_text(json.dumps(mix))
    cfg = json.loads((base / "configs" / "voicefixer-44k-fp32.json")
                     .read_text())
    cfg["program"] = {"conv_block_kernel": True}
    (base / "configs" / "fp32-convblock.json").write_text(json.dumps(cfg))
    bench = spec.benchmark()
    bench["workloads"].append({"name": "fp32-dataset", "chips": 1,
                               "config": "fp32-convblock",
                               "traffic": "dataset", "why": "x"})
    bench["end_to_end"][0]["workloads"].append("fp32-dataset")
    made = []

    def make(family, *a):
        prog = family.program(*a)
        made.append(prog.vf.conv_block_kernel)
        return prog
    r = narrow.run(base, "fp32-dataset", bench=bench, make_program=make)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and "audio_s_per_s" in r["metrics"]
    assert made == [True]


def test_an_entry_refuses_what_the_reference_cannot_judge():
    with pytest.raises(ValueError):
        spec.entry("restore_inmem").validate({"mode": 1})
    with pytest.raises(ValueError):
        spec.entry("restore_wavs").validate({"mode": 1})
    spec.entry("restore_wavs").validate({"mode": 0, "max_batch": 8})


def test_an_entry_brings_its_own_expected_answer(base):
    """An entry point whose answer is not ``restore_inmem``'s (here every
    answer negated) brings ``expected``: the program through it is
    correct, the control follows it, and without it the answers fail."""
    (base / "entries" / "negated.py").write_text(
        "def validate(kwargs):\n    pass\n\n\n"
        "def call(vf, waves, kwargs):\n"
        "    return [-vf.restore_inmem(w) for w in waves]\n\n\n"
        "def expected(ref, wave, kwargs):\n"
        "    return -ref.restore(wave)\n")
    mix = json.loads((base / "traffic" / "interactive.json").read_text())
    (base / "traffic" / "negated.json").write_text(json.dumps(
        mix | {"entry": "negated", "kwargs": {}}))
    bench = spec.benchmark()
    bench["workloads"].append({"name": "fp32-negated", "chips": 1,
                               "config": "voicefixer-44k-fp32",
                               "traffic": "negated", "why": "x"})
    r = narrow.run(base, "fp32-negated", bench=bench)
    assert r["correct"], r["checks"]
    r = narrow.run(base, "fp32-negated", bench=bench,
                   make_program=control.ControlProgram)
    assert not r["correct"] and r["checks"]["rel_err"]["value"] < 1e-1
    (base / "entries" / "negated.py").write_text(
        "def validate(kwargs):\n    pass\n\n\n"
        "def call(vf, waves, kwargs):\n"
        "    return [-vf.restore_inmem(w) for w in waves]\n")
    r = narrow.run(base, "fp32-negated", bench=bench)
    assert not r["correct"]
