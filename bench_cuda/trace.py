"""The traced run's record: what ``torch.profiler`` saw of a bounded
sample of requests, as plain events the metric readers read.

``capture`` profiles the host and the card around a function, writes the
Chrome trace to a temporary file under ``TMPDIR``, reads it back into
``Event``s and removes the file. An event is one of:

- "device": an operation on the card (a kernel, a copy or a memset), with
  the correlation id of the host call that launched it;
- "runtime": a CUDA runtime or driver call on the host, with its
  correlation id;
- "range": a named host range (``record_function``): the program's
  ``vf.*`` stage spans and the benchmark's own ``bench.*`` spans;
- "op": a host operator (``aten::...``), kept to label idle gaps.

Times are in microseconds on the trace's one clock.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass

DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "memcpy",
               "gpu_memset": "memset"}
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Event:
    kind: str          # device, runtime, range or op
    name: str
    start: float       # us
    end: float         # us
    corr: int | None = None


def from_chrome(events: list) -> list:
    """Chrome trace events -> the Events above, in start order."""
    out = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        start = float(e["ts"])
        end = start + float(e["dur"])
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            out.append(Event("device", e["name"], start, end, corr))
        elif cat in RUNTIME_CATS:
            out.append(Event("runtime", e["name"], start, end, corr))
        elif cat == "user_annotation":
            out.append(Event("range", e["name"], start, end))
        elif cat == "cpu_op":
            out.append(Event("op", e["name"], start, end))
    out.sort(key=lambda ev: ev.start)
    return out


def capture(fn, cuda: bool = True) -> tuple:
    """(fn's result, [Event]) of one call of fn under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        result = fn()
        if cuda:
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return result, from_chrome(events)


# ------------------------------------------------------------- intervals

def union(intervals) -> list:
    """Merged, sorted [(start, end)] of the given intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def clip(intervals, lo: float, hi: float) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def minus(a, b) -> list:
    """The parts of the merged intervals a outside the merged intervals
    b."""
    out = []
    for s, e in a:
        cur = s
        for bs, be in b:
            if be <= cur or bs >= e:
                continue
            if bs > cur:
                out.append((cur, bs))
            cur = max(cur, be)
        if cur < e:
            out.append((cur, e))
    return out


class Record:
    """The events of a traced sample, indexed for the readers. ``requests``:
    [(start, end, segments, audio_s)] of the sampled requests, on the
    trace's clock (their "bench.request" ranges)."""

    def __init__(self, events: list, segments: list, audio_s: list):
        self.events = events
        spans = [e for e in events if e.kind == "range"
                 and e.name == "bench.request"]
        if len(spans) != len(segments):
            raise ValueError(f"{len(spans)} request spans for "
                             f"{len(segments)} requests")
        self.requests = [(e.start, e.end, n, a)
                         for e, n, a in zip(spans, segments, audio_s)]
        self.device = [e for e in events if e.kind == "device"]
        self.ranges = [e for e in events if e.kind == "range"]
        self._launch = {e.corr: e.start for e in events
                        if e.kind == "runtime" and e.corr is not None}

    @property
    def segments(self) -> int:
        return sum(r[2] for r in self.requests)

    @property
    def audio_s(self) -> float:
        return sum(r[3] for r in self.requests)

    def request_spans(self) -> list:
        return union((s, e) for s, e, _, _ in self.requests)

    def named(self, names) -> list:
        """Merged host intervals of the ranges called one of ``names``."""
        return union((e.start, e.end) for e in self.ranges
                     if e.name in names)

    def device_busy(self) -> list:
        """Merged intervals in which an operation ran on the card, within
        the sampled requests."""
        busy = union((e.start, e.end) for e in self.device)
        return [iv for s, e in self.request_spans()
                for iv in clip(busy, s, e)]

    def launched_in(self, names) -> list:
        """The device events whose launching host call lies inside a range
        called one of ``names`` (by correlation id)."""
        spans = self.named(names)
        starts = [s for s, _ in spans]
        out = []
        for e in self.device:
            t = self._launch.get(e.corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                out.append(e)
        return out
