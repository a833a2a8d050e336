"""The benchmark at narrow widths for the CPU tests: a copy of the
benchmark's files in a temporary directory in which every configuration
keeps upstream's structure (6 U-Net levels of 4 blocks, 4 vocoder stages
of 8 blocks, which the program's loader needs) at small widths and 1 s
segments, and every mix asks for short recordings."""

from __future__ import annotations

import copy
import json
import shutil
import time
from pathlib import Path

from bench_cuda import harness, spec

SHORT = {"longform": {"dist": "uniform", "min": 3.2, "max": 3.6},
         "interactive": {"dist": "log_uniform", "min": 0.2, "max": 1.0}}


def narrow_config(cfg: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    cfg["denoiser"]["base_width"] = 8
    cfg["unet"].update(encoder_channels=[2, 4, 4, 8, 8, 8],
                       blocks_per_stage=4, center_channels=8)
    cfg["vocoder"].update(cond_channels=16, channels=32)
    cfg["pipeline"]["seg_length_seconds"] = 1
    return cfg


def make_base(tmp: Path) -> Path:
    """The narrow copy of ``bench_cuda``'s configs, traffic, entries and
    metrics under ``tmp``."""
    base = tmp / "bench"
    for d in ("metrics", "entries"):
        shutil.copytree(spec.HERE / d, base / d)
    (base / "configs").mkdir()
    (base / "traffic").mkdir()
    for path in (spec.HERE / "configs").glob("*.json"):
        cfg = narrow_config(json.loads(path.read_text()))
        (base / "configs" / path.name).write_text(json.dumps(cfg))
    for path in (spec.HERE / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix["seconds"] = SHORT.get(path.stem, SHORT["interactive"])
        mix["pool"] = min(mix["pool"], 4)
        mix["trace_requests"] = 2
        mix["warmup"] = min(mix["warmup"], 2)
        (base / "traffic" / path.name).write_text(json.dumps(mix))
    return base


def run(base: Path, cell: str, seed: int = 2 ** 31 + 5, seconds=1.0,
        traced=False, make_program=None, bench: dict | None = None) -> dict:
    """One run of ``cell`` on the CPU at narrow widths."""
    return harness.run_cell(bench or spec.benchmark(), cell, seed, seconds,
                            traced, "cpu", time.perf_counter(),
                            make_program=make_program, base=base)
