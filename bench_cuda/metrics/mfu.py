"""mfu (model step: the whole request), in %: the window's segments times
the FLOPs of one segment (the family's ``flops_per_segment``; VoiceFixer's
is the frozen analytic count of ``frozen/flops.py``, the JAX package's
formulation) over the window's wall time, as a share of one H100's peak
for the configuration's precision (989 TFLOP/s dense bf16 for production,
67 TFLOP/s float32 for parity; ``frozen/work.py``). Read from the window,
which the profiler does not record."""

from bench_cuda.frozen import work


def read(run):
    segments = sum(r.segments for r in run.window if r.ok)
    if not segments:
        return None
    peak = (work.PEAK_BF16 if run.cfg.precision == "production"
            else work.PEAK_FP32)
    per_segment = run.family.flops_per_segment(run.cfg)
    rate = segments * per_segment / (run.window_end - run.window_start)
    return 100.0 * rate / peak
