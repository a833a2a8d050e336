"""BENCHMARK.json keeps to the benchmark's contract, and the harness finds
every piece of a cell by name from files alone, so a later change adds a
configuration, a model family, a mix, a metric or a cell with new files
and entries."""

import dataclasses
import json
import re

import pytest

from bench_cuda import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_json_keeps_to_the_contract():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "bench_cuda/run.py"]
    assert b["paths"] == ["bench_cuda"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names), names
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in b[k]}) == len(b[k])
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"bench_cuda/configs/{c['name']}.json"
        assert (spec.ROOT / c["file"]).is_file() and c["reduced"] == []
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200
        spec.family(spec.config(w["config"])["family"])
        spec.traffic(w["traffic"])
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        spec.reader(m["name"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    layers = {}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_metric_and_a_layer(cell):
    e2e = [m["name"] for m in spec.metrics_of(BENCH, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics_of(BENCH, cell, True)


@pytest.mark.parametrize("name", ["voicefixer-44k-bf16",
                                  "voicefixer-44k-fp32"])
def test_configs_hold_upstreams_widths_as_the_program_runs_them(name):
    from bench_cuda.program import program_config
    from voicefixer_tpu_torch.config import DEFAULT_CONFIG
    cfg = spec.config(name)
    assert program_config(cfg) == DEFAULT_CONFIG
    assert cfg["family"] == "voicefixer"
    assert cfg["precision"] == ("production" if "bf16" in name
                                else "parity")
    assert cfg["limits"]
    import inspect
    from voicefixer_tpu_torch.pipeline.restore import VoiceFixer
    assert set(cfg["program"]) <= set(
        inspect.signature(VoiceFixer).parameters)


def test_a_new_config_mix_metric_and_cell_are_found_by_name(tmp_path):
    base = tmp_path / "bench"
    for d in ("configs", "traffic", "metrics", "entries", "families"):
        (base / d).mkdir(parents=True)
    (base / "configs" / "new-model.json").write_text(
        json.dumps({"precision": "parity"}))
    (base / "traffic" / "bursty.json").write_text(json.dumps({"pool": 2}))
    (base / "metrics" / "queue_ms.py").write_text(
        "def read(run):\n    return 7.0\n")
    (base / "metrics" / "depth.only.py").write_text(
        "def read(run):\n    return 3.0\n")
    (base / "entries" / "stream.py").write_text(
        "def validate(kwargs):\n    pass\n\n\n"
        "def call(vf, waves, kwargs):\n    return waves\n")
    assert spec.config("new-model", base)["precision"] == "parity"
    assert spec.traffic("bursty", base)["pool"] == 2
    assert spec.reader("queue_ms.rate", base).read(None) == 7.0
    assert spec.reader("depth.only", base).read(None) == 3.0
    with pytest.raises(FileNotFoundError):
        spec.reader("absent.rate", base)
    assert spec.entry("stream", base).call(None, [1], {}) == [1]
    with pytest.raises(FileNotFoundError):
        spec.entry("absent", base)
    (base / "families" / "tiny.py").write_text("SYMBOLS = ('tiny_kernel',)\n")
    assert spec.family("tiny", base).SYMBOLS == ("tiny_kernel",)
    with pytest.raises(FileNotFoundError):
        spec.family("absent", base)
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "new-cell", "config": "new-model",
                               "traffic": "bursty", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "queue_ms.rate", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "pipeline", "moves": "setup_s",
                               "workloads": ["new-cell"]})
    assert spec.cell(bench, "new-cell")["traffic"] == "bursty"
    assert [m["name"] for m in spec.metrics_of(bench, "new-cell", False)] \
        == ["setup_s"]
    assert [m["name"] for m in spec.metrics_of(bench, "new-cell", True)] \
        == ["queue_ms.rate"]


def test_program_config_refuses_a_file_that_misses_a_field():
    from bench_cuda.program import program_config
    cfg = spec.config("voicefixer-44k-fp32")
    del cfg["vocoder"]["hop_length"]
    with pytest.raises(KeyError):
        program_config(cfg)
    assert dataclasses.is_dataclass(program_config(
        spec.config("voicefixer-44k-fp32")))
