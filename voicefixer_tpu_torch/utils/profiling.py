"""Tracing, as ``voicefixer_tpu/utils/profiling.py`` on ``torch.profiler``:

- ``trace(log_dir)``: a profiler over the enclosed block, the host and,
  on a card, the device's kernels; on exit it writes a Chrome / Perfetto
  trace, ``log_dir/trace.json`` (chrome://tracing or ui.perfetto.dev).
- ``annotate(name)``: a named range in that trace, on the clock of the
  device's events, and an NVTX range where there is a card.

The port's spans, outermost first (a request's spans share its
``vf.request``):

- ``vf.request``: a whole call of ``VoiceFixer.restore_inmem`` or
  ``parallel.inference.restore_wavs``;
- ``vf.plan``: segmenting, padding, grouping by length, stacking rows,
  ``rows_per_call`` and the split into calls;
- ``vf.upload``: a call's rows copied to the device, one a call;
- ``vf.stft_mel``, ``vf.denoiser``, ``vf.resunet``, ``vf.vocoder``: the
  stages of ``pipeline.restore.restore_batch``, with ``vf.cast`` inside
  the ResUNet's and the vocoder's where a call casts their weights to the
  activation type;
- ``vf.download``: a call's outputs copied to the host, after the host
  has waited for the call's device work;
- ``vf.stitch``: the trims and concatenations that make the answer.
"""

from __future__ import annotations

import contextlib
import functools
import os
import tempfile

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


@functools.cache
def _nvtx() -> bool:
    """Whether there is a card, asked once: a request enters about fifteen
    spans, and ``torch.cuda.is_available`` is no free call."""
    return torch.cuda.is_available()


@contextlib.contextmanager
def annotate(name: str):
    """A named range inside profiler traces (and NVTX on a card). Without
    a running profiler no ``record_function`` is entered: it would record
    nothing, and it costs 9–14 µs a span on an H100's host."""
    nvtx = _nvtx()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        if torch.autograd.profiler._is_profiler_enabled:
            with torch.profiler.record_function(name):
                yield
        else:
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
