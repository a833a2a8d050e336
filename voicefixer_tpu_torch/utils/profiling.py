"""Tracing and timing, as ``voicefixer_tpu/utils/profiling.py`` on
``torch.profiler``:

- ``trace(log_dir)``: a profiler over the enclosed block, the host and,
  on a card, the device's kernels; on exit it writes a Chrome / Perfetto
  trace, ``log_dir/trace.json`` (chrome://tracing or ui.perfetto.dev).
- ``annotate(name)``: a named range in that trace, and an NVTX range where
  there is a card.
- ``Timer``: accumulated wall-clock time per named block.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str | None = None, device=None):
    """Profile the enclosed block and write ``log_dir/trace.json``.

    device: None means the card, and raises without one; "cpu" traces the
    host alone. Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile
    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "voicefixer_tpu_torch_trace")
    dev = torch.device("cuda" if device is None else device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "trace the host alone")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str):
    """A named range inside profiler traces (and NVTX on a card)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class Timer:
    """Accumulating wall-clock timer: ``with timer.block("x", device):``
    around device work waits for ``device`` on exit, so the time covers
    the work the block queued."""

    def __init__(self):
        self.totals: dict = {}
        self.counts: dict = {}

    @contextlib.contextmanager
    def block(self, name: str, device=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if device is not None and torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        lines = [f"{name}: {self.totals[name] * 1000:.1f} ms over "
                 f"{self.counts[name]} calls"
                 for name in sorted(self.totals, key=self.totals.get,
                                    reverse=True)]
        return "\n".join(lines)
