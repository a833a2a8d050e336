"""One run of one cell: set-up, the measured window, the traced sample,
the comparison that decides ``correct``, the result line.

Everything specific to one architecture comes from the family that the
cell's configuration names (``families/<family>.py``, whose docstring
lists the hooks): the configuration's sizes, the weights, the program,
the inputs, what a request counts, the reference and the comparison.

Set-up (``setup_s``, from the process's start to the first timed
request): the program's import, the inputs and the weights drawn on the
device from the seed, the family's program, and ``warmup`` requests of
the cell's own traffic, which build the kernels on a checkout's first run
and warm every shape the window uses.

A request goes through the entry point the mix names
(``entries/<entry>.py``) with the mix's ``kwargs``.

The window is a closed loop of one client that sends requests until
``seconds`` have passed; it ends at the end of the last request that
started in it, so no request is cut or counted in part. A traced run
then sends ``trace_requests`` more under the profiler: the per-layer
metrics are read from those, except ``mfu`` and ``peak_alloc_gib``, which
are read from the (unprofiled) window.
"""

from __future__ import annotations

import bisect
import functools
import gc
import sys
import time
import traceback
from dataclasses import dataclass

import numpy as np
import torch

from bench_cuda import check, generator, spec, trace
from bench_cuda.frozen import work
from bench_cuda.weights import to_host

LOOK_BACK = 64  # events searched back for the one around a time


@dataclass
class Request:
    items: list                 # pool indices
    start: float
    end: float
    audio_s: float
    segments: int
    ok: bool


@dataclass
class Run:
    """What the metric readers read: the family, the configuration, the
    cell and its mix, the window's requests (host clock), the traced
    sample's record and the window's peak of allocated memory."""
    family: object              # the module families/<family>.py
    cfg: object                 # family.namespace
    cell: dict
    mix: dict
    setup_s: float
    window: list                # [Request]
    window_start: float
    window_end: float
    peak_window_bytes: int
    record: trace.Record | None = None


class Entry:
    """The cell's entry point over the pool: ``__call__(items)`` sends the
    inputs ``items`` as one request and returns the answers."""

    def __init__(self, mix: dict, pool: list, prog, base):
        self.pool, self.prog = pool, prog
        self.module = spec.entry(mix["entry"], base)
        self.kwargs = dict(mix.get("kwargs", {}))
        self.module.validate(self.kwargs)

    def __call__(self, items: list) -> list:
        return self.prog.serve(self.module, [self.pool[i] for i in items],
                               self.kwargs)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def closed_loop(entry: Entry, mix: dict, order, seconds: float,
                reservoir, units):
    """Requests back to back, cycling through ``order``, until ``seconds``
    have passed; ``units(input) -> (audio_s, segments)``. Returns
    ([Request], start, end)."""
    out, told = [], False
    t0 = time.perf_counter()
    while not out or out[-1].end - t0 < seconds:
        items = generator.request(mix, order, len(out))
        counts = [units(entry.pool[i]) for i in items]
        start = time.perf_counter()
        try:
            answers = entry(items)
            ok = True
        except Exception:  # a failed request is counted and reported
            if not told:
                traceback.print_exc()
                told = True
            answers, ok = None, False
        end = time.perf_counter()
        out.append(Request(items, start, end, sum(a for a, _ in counts),
                           sum(n for _, n in counts), ok))
        if ok and reservoir is not None:
            reservoir.offer(lambda: ([entry.pool[i] for i in items],
                                     answers))
    return out, t0, out[-1].end


def traced_sample(entry: Entry, mix: dict, order, first: int, n: int,
                  units, cuda: bool):
    """n requests after the window under the profiler, each inside a
    "bench.request" range -> trace.Record."""
    reqs = [generator.request(mix, order, first + k) for k in range(n)]

    def sample():
        for items in reqs:
            with torch.profiler.record_function("bench.request"):
                entry(items)
    _, events = trace.capture(sample, cuda=cuda)
    counts = [[units(entry.pool[i]) for i in items] for items in reqs]
    return trace.Record(events, [sum(n for _, n in c) for c in counts],
                        [sum(a for a, _ in c) for c in counts])


class _HostIndex:
    """What the host was doing at a time: the innermost range and the
    innermost operator or runtime call around it."""

    def __init__(self, record: trace.Record):
        self.kinds = {}
        for kinds in (("range",), ("op", "runtime")):
            evs = [e for e in record.events if e.kind in kinds]
            self.kinds[kinds] = (evs, [e.start for e in evs])

    def _innermost(self, kinds, t):
        evs, starts = self.kinds[kinds]
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - LOOK_BACK, -1), -1):
            if evs[j].end >= t:
                return evs[j].name
        return None

    def label(self, t: float) -> str:
        return (f"{self._innermost(('range',), t) or 'no range'} | "
                f"{self._innermost(('op', 'runtime'), t) or 'python'}")


def breakdown(record: trace.Record) -> dict:
    """The device operations that took most time, by kernel group, and
    the longest idle gaps, by what the host was doing; 10 of each."""
    ops: dict = {}
    for e in record.device:
        g = work._kernel_group(e.name)
        ops[g] = ops.get(g, 0.0) + (e.end - e.start) / 1e6
    gaps: dict = {}
    host = _HostIndex(record)
    busy = trace.union((e.start, e.end) for e in record.device)
    for s, e in trace.minus(record.request_spans(), busy):
        label = host.label(s)
        gaps[label] = gaps.get(label, 0.0) + (e - s) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(),  # noqa: E731
                                                key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float,
             traced: bool, device, t_start: float, make_program=None,
             base=spec.HERE) -> dict:
    """One run; returns the result line as a dict. ``make_program(family,
    cfg, state, device)``, where given, stands in for the family's
    program (the control, a fault)."""
    cell = spec.cell(bench, cell_name)
    cfg_json = spec.config(cell["config"], base)
    family = spec.family(cfg_json["family"], base)
    mix = spec.traffic(cell["traffic"], base)
    generator.validate(mix)
    cfg = family.namespace(cfg_json)
    cuda = torch.device(device).type == "cuda"

    units = functools.partial(family.units, cfg)
    pool = family.inputs(mix, seed, cfg, device)
    order = generator.order(mix, seed)
    host = to_host(family.draw(cfg, seed, device))
    prog = (family.program(cfg_json, host, device) if make_program is None
            else make_program(family, cfg_json, host, device))
    del host
    rng = np.random.default_rng([int(seed), 11])
    entry = Entry(mix, pool, prog, base)
    for k in range(mix["warmup"]):
        entry(generator.request(mix, order, k))
    _sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    keep = check.Reservoir(mix["check"]["requests"], rng)
    window, w0, w1 = closed_loop(entry, mix, order, seconds, keep, units)
    peak_window = torch.cuda.max_memory_allocated(device) if cuda else 0
    record = None
    if traced:
        record = traced_sample(entry, mix, order, len(window),
                               mix["trace_requests"], units, cuda)
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    prog.close()
    del prog, entry
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    state = family.draw(cfg, seed, device)
    ref = family.reference(state, cfg)
    numerics = family.OWN[cfg_json["precision"]]
    own = family.reference(state, cfg, numerics) if numerics else None
    judge = getattr(spec.entry(mix["entry"], base), "expected", None)
    kwargs = mix.get("kwargs", {})
    if judge is None:
        readings = family.compare(ref, own, keep.items, rng,
                                  mix["check"]["segments"])
    else:
        readings = check.whole_answers(
            ref, keep.items, lambda r, x: judge(r, x, kwargs), own)
    failed = sum(not r.ok for r in window)
    correct, checks, others = check.judge(readings, failed,
                                          cfg_json["limits"])

    run = Run(family, cfg, cell, mix, setup_s, window, w0, w1, peak_window,
              record)
    metrics = {}
    for m in spec.metrics_of(bench, cell_name, traced):
        value = spec.reader(m["name"], base).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": len(window),
              "failed": failed, "metrics": metrics, "device": dev}
    if traced:
        spans = record.request_spans()
        dev["busy_s"] = trace.length(record.device_busy()) / 1e6
        dev["window_s"] = (spans[-1][1] - spans[0][0]) / 1e6
        result["breakdown"] = breakdown(record)
    result["readings"] = others
    result["checks"] = checks
    return result


def print_checks(result: dict):
    """The readings not compared, then each compared number beside its
    limit, as the last lines on standard error."""
    for name, value in result["readings"].items():
        print(f"reading {name}: {value!r}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
