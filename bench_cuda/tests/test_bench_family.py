"""A second model family enters the benchmark as new files alone: a toy
mel-to-wave vocoder, its configuration, mix, entry point and a reader,
written into a copy of the benchmark's files, passes through
``narrow.make_base`` and runs through the harness unchanged, is correct,
reports its metrics from the family's numbers, and its planted fault and
its control are not correct. A limit that names a number the family does
not give, or a precision its ``OWN`` does not state, fails the run."""

import json
import shutil
import tempfile
from pathlib import Path

import pytest
import torch

from bench_cuda import control, spec
from bench_cuda.frozen import work
from bench_cuda.tests import narrow

TOY = '''"""A toy vocoder: each frame's bands through one transposed
convolution of stride ``hop`` and a tanh. Its reference overlap-adds the
same frames in float64 (with float16 weights for the control)."""

from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from bench_cuda import check, generator

OWN = {"parity": None}
CONTROL = {"parity": "fp16"}
SYMBOLS = ()


def namespace(cfg):
    return SimpleNamespace(precision=cfg["precision"], **cfg["sizes"])


def draw(ns, seed, device):
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n = ns.bands * 2 * ns.hop
    flat = torch.randn(n + 1, generator=gen, device=device).mul_(0.3)
    return ({"w": flat[:n].view(ns.bands, 1, 2 * ns.hop), "b": flat[n:]},)


def inputs(mix, seed, ns, device):
    """The mix's speech as log band energies, [frames, bands]."""
    out = []
    for wave in generator.recordings(mix, seed, ns.sample_rate, device):
        t = wave.shape[0] // ns.hop
        bands = wave[: t * ns.hop].reshape(t, ns.bands, -1)
        out.append(np.log(1e-4 + (bands ** 2).mean(-1)).astype(np.float32))
    return out


def units(ns, mel):
    t = mel.shape[0]
    return t * ns.hop / ns.sample_rate, -(-t // ns.segment_frames)


def flops_per_segment(ns):
    return 2 * ns.bands * 2 * ns.hop * ns.segment_frames


def functions(ns):
    return []


class Program:
    def __init__(self, state, device, scale=1.0):
        self.w = torch.as_tensor(state[0]["w"], device=device)
        self.b = torch.as_tensor(state[0]["b"], device=device)
        self.device, self.scale = device, scale

    def vocode(self, mel):
        hop = self.w.shape[-1] // 2
        x = torch.as_tensor(mel, device=self.device).T[None]
        y = F.conv_transpose1d(x, self.w, self.b, stride=hop)
        return self.scale * torch.tanh(
            y[0, 0, : mel.shape[0] * hop]).cpu().numpy()

    def serve(self, entry, mels, kwargs):
        return entry.call(self, mels, kwargs)

    def close(self):
        self.w = self.b = None


def program(cfg, state, device):
    return Program(state, device)


FAULTS = {"scaled": lambda cfg, state, device: Program(state, device, 1.01)}


class Reference:
    def __init__(self, state, numerics):
        w = state[0]["w"].cpu().numpy()[:, 0]
        if numerics == "fp16":
            w = w.astype(np.float16)
        self.w = w.astype(np.float64)
        self.b = float(state[0]["b"][0])
        self.hop = w.shape[1] // 2

    def restore(self, mel):
        t, hop = mel.shape[0], self.hop
        out = np.full((t + 1) * hop, self.b)
        for i, row in enumerate(mel.astype(np.float64)):
            out[i * hop: (i + 2) * hop] += row @ self.w
        return np.tanh(out[: t * hop])


def reference(state, ns, numerics="fp32"):
    return Reference(state, numerics)


def compare(ref, own, kept, rng, per):
    done, wrong = check.pairs(kept)
    err, nonfinite = 0.0, 0
    for mel, out in done:
        want = ref.restore(mel)
        if out.shape != want.shape:
            wrong += 1
            continue
        nonfinite += int(np.count_nonzero(~np.isfinite(out)))
        err = max(err, check.rel(out, want))
    return check.as_readings(err, None, wrong, nonfinite)
'''

ENTRY = '''def validate(kwargs):
    if kwargs:
        raise ValueError(f"vocode takes no keyword arguments: {kwargs}")


def call(system, mels, kwargs):
    return [system.vocode(m) for m in mels]
'''

# segments a wall second of the window, to hold mfu against
READER = '''def read(run):
    segments = sum(r.segments for r in run.window if r.ok)
    return segments / (run.window_end - run.window_start)
'''

CONFIG = {"family": "toy", "precision": "parity",
          "sizes": {"sample_rate": 8000, "hop": 80, "bands": 8,
                    "segment_frames": 40},
          "limits": {"rel_err": 1e-5}}
TOY_CONFIGS = {
    "toy-vocoder": CONFIG,
    # a limit on a number the toy's compare does not give
    "toy-vocoder-ratio": CONFIG | {"limits": {"rel_err": 1e-5,
                                              "err_ratio": 4.0}},
    # a precision the toy's OWN does not name
    "toy-vocoder-bf16": CONFIG | {"precision": "production"}}


def _files() -> dict:
    """Every file of the benchmark outside the bytecode caches, with its
    time of change and size."""
    paths = [p for p in spec.HERE.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts]
    paths.append(spec.ROOT / "BENCHMARK.json")
    return {str(p): (p.stat().st_mtime_ns, p.stat().st_size) for p in paths}


def _toy_source(tmp) -> Path:
    """A copy of the benchmark's files under ``tmp`` with the toy's files
    added, shaped as ``bench_cuda/`` is."""
    src = tmp / "src"
    for d in ("configs", "traffic", "families", "entries", "metrics"):
        shutil.copytree(spec.HERE / d, src / d)
    (src / "families" / "toy.py").write_text(TOY)
    (src / "entries" / "vocode.py").write_text(ENTRY)
    (src / "metrics" / "toy_segments_per_s.py").write_text(READER)
    for name, cfg in TOY_CONFIGS.items():
        (src / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    mix = json.loads((src / "traffic" / "interactive.json").read_text())
    mix |= {"entry": "vocode", "kwargs": {},
            "check": {"requests": 3, "segments": 1}}
    (src / "traffic" / "toy-clips.json").write_text(json.dumps(mix))
    return src


def _toy_bench() -> dict:
    """A copy of the benchmark with a cell of each toy configuration."""
    bench = spec.benchmark()
    for name in TOY_CONFIGS:
        bench["workloads"].append({"name": name, "config": name,
                                   "traffic": "toy-clips", "chips": 1,
                                   "why": "x"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("audio_s_per_s", "latency_p50_ms", "mfu.rate"):
            m["workloads"] += list(TOY_CONFIGS)
    bench["per_layer"].append({"name": "toy_segments_per_s", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "model step",
                               "moves": "audio_s_per_s",
                               "workloads": list(TOY_CONFIGS)})
    return bench


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """(the narrow base made from a source that holds the toy's files,
    the benchmark with its cells); no file outside ``tmp_path`` changes."""
    torch.set_num_threads(2)
    (tmp_path / "tmp").mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    before = _files()
    base = narrow.make_base(tmp_path, _toy_source(tmp_path))
    yield base, _toy_bench()
    assert _files() == before


def test_a_second_family_from_new_files_alone(toy):
    base, bench = toy
    assert json.loads((base / "configs" / "toy-vocoder.json").read_text()) \
        == CONFIG
    vf = json.loads((base / "configs" / "voicefixer-44k-bf16.json")
                    .read_text())
    assert vf["vocoder"]["channels"] == 32

    r = narrow.run(base, "toy-vocoder", seconds=0.3, bench=bench)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["checks"]["rel_err"]["value"] < 1e-6
    assert set(r["metrics"]) == {"audio_s_per_s", "latency_p50_ms",
                                 "setup_s"}

    t = narrow.run(base, "toy-vocoder", seconds=0.3, traced=True,
                   bench=bench)
    assert t["correct"], t["checks"]
    family = spec.family("toy", base)
    per = family.flops_per_segment(family.namespace(CONFIG))
    rate = t["metrics"]["toy_segments_per_s"]["value"]
    assert t["metrics"]["mfu.rate"]["value"] == pytest.approx(
        100 * rate * per / work.PEAK_FP32, rel=1e-12)

    for make in (control.faulty("scaled", family), control.ControlProgram):
        r = narrow.run(base, "toy-vocoder", seconds=0.3, bench=bench,
                       make_program=make)
        assert not r["correct"], r["checks"]
        assert r["checks"]["rel_err"]["value"] < 0.1


def test_a_limit_with_no_reading_is_not_correct(toy):
    base, bench = toy
    r = narrow.run(base, "toy-vocoder-ratio", seconds=0.3, bench=bench)
    assert r["checks"]["rel_err"]["value"] < 1e-6
    assert r["checks"]["err_ratio"] == {"value": None, "limit": 4.0}
    assert not r["correct"]


def test_a_precision_the_family_does_not_state_is_refused(toy):
    base, bench = toy
    with pytest.raises(KeyError, match="production"):
        narrow.run(base, "toy-vocoder-bf16", seconds=0.3, bench=bench)
