"""plan_stitch_ms (pipeline: ``pipeline/restore.py``,
``parallel/inference.py``): host milliseconds per 30 s segment in the
union of the program's vf.plan and vf.stitch spans, within the benchmark's
request spans. vf.plan holds the segmenting, the padding, the grouping by
length, the stacking of rows, ``rows_per_call`` and the split into calls;
vf.stitch the concatenation of a group's calls, the centre trims, the
padded tails cut and the answer's concatenation. Part of what
``pipeline_host_ms`` reads. Traced sample; None where the program enters
no vf.request span."""

from bench_cuda import trace

NAMES = {"vf.plan", "vf.stitch"}


def read(run):
    rec = run.record
    if rec is None or not rec.segments or not rec.named({"vf.request"}):
        return None
    inside = [iv for s, e in rec.request_spans()
              for iv in trace.clip(rec.named(NAMES), s, e)]
    return trace.length(inside) / 1e3 / rec.segments
