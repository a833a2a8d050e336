"""The benchmark at narrow widths for the CPU tests: a copy of the
benchmark's files in a temporary directory in which every configuration
goes through its family's ``narrow`` (VoiceFixer's keeps upstream's
structure at small widths and 1 s segments; a family without ``narrow``
keeps its file as it is), and every mix asks for short recordings."""

from __future__ import annotations

import copy
import json
import shutil
import time
from pathlib import Path

from bench_cuda import harness, spec

SHORT = {"longform": {"dist": "uniform", "min": 3.2, "max": 3.6},
         "interactive": {"dist": "log_uniform", "min": 0.2, "max": 1.0}}


def narrow_config(cfg: dict, base: Path = spec.HERE) -> dict:
    """``cfg`` through the ``narrow`` of its family under ``base``, or a
    copy of it where the family has none."""
    hook = getattr(spec.family(cfg["family"], base), "narrow", None)
    return hook(cfg) if hook else copy.deepcopy(cfg)


def make_base(tmp: Path, src: Path = spec.HERE) -> Path:
    """The narrow copy of ``src``'s configs, traffic, families, entries and
    metrics under ``tmp``."""
    base = tmp / "bench"
    for d in ("metrics", "entries", "families"):
        shutil.copytree(src / d, base / d)
    (base / "configs").mkdir()
    (base / "traffic").mkdir()
    for path in (src / "configs").glob("*.json"):
        cfg = narrow_config(json.loads(path.read_text()), base)
        (base / "configs" / path.name).write_text(json.dumps(cfg))
    for path in (src / "traffic").glob("*.json"):
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
