"""pipeline_host_ms (pipeline: ``pipeline/restore.py`` and
``parallel/inference.py::rows_per_call``): host milliseconds per 30 s
segment inside the benchmark's request spans and outside the program's
four stage ranges (vf.stft_mel, vf.denoiser, vf.resunet, vf.vocoder)
and the CUDA runtime calls that copy or wait for the card (their time
follows the device, not the host). What is left is the
pipeline's own host work: segmenting, padding, stacking, the trim and
the concatenation, and the launches between the stages. Traced sample."""

from bench_cuda import trace

STAGES = {"vf.stft_mel", "vf.denoiser", "vf.resunet", "vf.vocoder"}
WAITS = ("Memcpy", "Synchronize", "Memset")


def read(run):
    rec = run.record
    if rec is None or not rec.segments:
        return None
    waits = [(e.start, e.end) for e in rec.events
             if e.kind == "runtime" and any(w in e.name for w in WAITS)]
    away = trace.union(rec.named(STAGES) + waits)
    host = trace.minus(rec.request_spans(), away)
    return trace.length(host) / 1e3 / rec.segments
