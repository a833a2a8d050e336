"""weight_cast_ms (weights: ``models/resunet.py::apply``,
``models/vocoder.py::apply``): host milliseconds per 30 s segment in the
program's vf.cast spans, within the benchmark's request spans: a call
casting the ResUNet's and the vocoder's weight trees to the activation
type (production precision), inside vf.resunet and vf.vocoder, whose
device time counts the casts' kernels. Host time under the profiler:
it includes the profiler's own cost on each of the casts' many small
operators (a tree of hundreds of tensors); ``tools/torch_span_cost.py``
times the casts without it. 0 where the program enters
vf.request spans and no vf.cast span; None where it enters no vf.request
span. Traced sample."""

from bench_cuda import trace


def read(run):
    rec = run.record
    if rec is None or not rec.segments or not rec.named({"vf.request"}):
        return None
    inside = [iv for s, e in rec.request_spans()
              for iv in trace.clip(rec.named({"vf.cast"}), s, e)]
    return trace.length(inside) / 1e3 / rec.segments
