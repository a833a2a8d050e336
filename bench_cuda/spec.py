"""Every piece of a cell, found by name from files alone.

- a cell: one entry of ``workloads`` in ``BENCHMARK.json``;
- a configuration: ``configs/<config>.json``;
- the model family a configuration names (its ``family`` key): a module
  ``families/<family>.py`` with everything specific to one architecture;
- a traffic mix: ``traffic/<traffic>.json``;
- the program's entry point a mix names: ``entries/<entry>.py``;
- a metric's reader: ``metrics/<name>.py``, else ``metrics/<base>.py``
  where ``<base>`` is the name before its first dot, so that
  ``mfu.rate`` and ``mfu.latency`` share ``metrics/mfu.py``.

A later change adds a cell, a configuration, a model family, a mix or a
metric by adding files and entries; no file here needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(path: Path | None = None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                   f"{[w['name'] for w in bench['workloads']]}")


def _json(kind: str, name: str, base: Path) -> dict:
    path = base / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} file {path}")
    with open(path) as f:
        return json.load(f)


def config(name: str, base: Path = HERE) -> dict:
    return _json("configs", name, base)


def traffic(name: str, base: Path = HERE) -> dict:
    return _json("traffic", name, base)


def _module(kind: str, stem: str, base: Path):
    path = base / kind / f"{stem}.py"
    if not path.is_file():
        return None
    mod_spec = importlib.util.spec_from_file_location(
        f"bench_cuda_{kind}_{stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(metric: str, base: Path = HERE):
    """The module of ``metric``'s reader; it defines ``read(run)``, which
    returns a number or None where the run has nothing to read."""
    for stem in (metric, metric.split(".")[0]):
        mod = _module("metrics", stem, base)
        if mod is not None:
            return mod
    raise FileNotFoundError(f"no reader for metric {metric!r} under "
                            f"{base / 'metrics'}")


def family(name: str, base: Path = HERE):
    """The module of the model family ``name``: the hooks that
    ``families/voicefixer.py`` documents, through which the harness, the
    check, the control and the readers reach everything specific to one
    architecture."""
    mod = _module("families", name, base)
    if mod is None:
        raise FileNotFoundError(f"no family {name!r} under "
                                f"{base / 'families'}")
    return mod


def entry(name: str, base: Path = HERE):
    """The module of the entry point ``name``; it defines
    ``validate(kwargs)`` and ``call(system, inputs, kwargs) -> [answer]``,
    ``system`` being what the family's program serves."""
    mod = _module("entries", name, base)
    if mod is None:
        raise FileNotFoundError(f"no entry {name!r} under "
                                f"{base / 'entries'}")
    return mod


def metrics_of(bench: dict, cell_name: str, trace: bool) -> list:
    """The metrics that ``cell_name`` reports: with ``trace`` its per-layer
    metrics, else its end-to-end ones. A metric with a ``workloads`` list
    is reported in the cells it names; one without it, in every cell (a
    per-layer one: every cell that reports the end-to-end metric it
    moves)."""
    e2e = [m for m in bench["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]
