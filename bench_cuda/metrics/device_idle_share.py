"""device_idle_share (one H100), in %: 100 * (1 - device busy time over
wall time, per 30 s segment). Busy is the union of the intervals in which
an operation (kernel, copy, memset) ran on the card, from the traced
sample; wall is the window's, which the profiler does not slow: the
profiler's host overhead stretches a traced request of a host-bound cell
while its device work stays the same (the result line's busy_s and
window_s give the traced sample's own share)."""

from bench_cuda import trace


def read(run):
    rec = run.record
    segments = sum(r.segments for r in run.window if r.ok)
    if rec is None or not rec.segments or not segments:
        return None
    busy = trace.length(rec.device_busy()) / 1e6 / rec.segments
    wall = sum(r.end - r.start for r in run.window if r.ok) / segments
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / wall)
