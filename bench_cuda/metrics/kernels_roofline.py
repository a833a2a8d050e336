"""kernels_roofline (kernels: ``kernels/*.py`` -> ``csrc/*.cu``), in %: the
least time the main path's hand-written kernels' functions need, over the
device time of the port's hand-written kernel launches, in the traced
sample.

The least time of a function is the larger of its FLOPs over the peak of
its type and its bytes over 3.35 TB/s (``frozen/work.py``); every input
is read once and every output written once, and the weights once a
request. The functions of one segment and the names of the kernels that
compute them are the family's (``functions`` and ``SYMBOLS``;
VoiceFixer's: K5, the four K6 layers and the four fused vocoder stages,
from the frozen work counts at the configuration's shapes). A launch is
the port's if its name holds one of ``SYMBOLS``.
"""

from bench_cuda.frozen import work


def least_ms(family, cfg, segments_per_request) -> float:
    total = 0.0
    for fn, peak in family.functions(cfg):
        flops, nbytes = fn(1)
        weights = fn(0)[1]
        for n in segments_per_request:
            total += work.bound_ms(n * (nbytes - weights) + weights,
                                   n * flops, peak)[0]
    return total


def read(run):
    rec = run.record
    if rec is None:
        return None
    symbols = run.family.SYMBOLS
    ms = sum(e.end - e.start for e in rec.device
             if any(s in e.name for s in symbols)) / 1e3
    if ms <= 0:
        return None
    return 100.0 * least_ms(run.family, run.cfg,
                            [r[2] for r in rec.requests]) / ms
