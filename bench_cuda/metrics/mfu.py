"""mfu (model step: the whole restore), in %: the window's segments times
the frozen analytic FLOPs of one segment (``frozen/flops.py``, the JAX
package's formulation) over the window's wall time, as a share of one
H100's peak for the configuration's precision (989 TFLOP/s dense bf16
for production, 67 TFLOP/s float32 for parity; ``frozen/work.py``). Read
from the window, which the profiler does not record."""

from bench_cuda.frozen import flops, work


def read(run):
    segments = sum(r.segments for r in run.window if r.ok)
    if not segments:
        return None
    peak = (work.PEAK_BF16 if run.cfg.precision == "production"
            else work.PEAK_FP32)
    per_segment = flops.pipeline_flops(run.cfg,
                                       run.cfg.pipeline.seg_length_seconds)
    rate = segments * per_segment / (run.window_end - run.window_start)
    return 100.0 * rate / peak
