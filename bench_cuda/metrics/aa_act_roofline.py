"""aa_act_roofline (kernels: K10, ``csrc/snake_aa.cu``), in %: the least
time of the traced sample's anti-aliased activations over the device time
of its ``snake_aa_kernel`` launches. The least time of one activation is
the larger of its FLOPs over the float32 peak (the arithmetic is not on
the tensor cores) and its bytes over 3.35 TB/s (``frozen/work.py``): x
read once, y written once, the two parameters once. The functions of one
segment are the family's ``aa_act_functions`` (``families/bigvgan.py``:
109 activations at the stages' shapes, from the frozen
``frozen/bigvgan_work.py``), scaled to each request's segments. None
where the family has no such functions or no launch ran."""

from bench_cuda.frozen import work

KERNEL = "snake_aa_kernel"


def read(run):
    rec = run.record
    fns = getattr(run.family, "aa_act_functions", None)
    if rec is None or fns is None:
        return None
    ms = sum(e.end - e.start for e in rec.device if KERNEL in e.name) / 1e3
    if ms <= 0:
        return None
    least = 0.0
    for fn, peak in fns(run.cfg):
        flops, nbytes = fn(1)
        weights = fn(0)[1]
        for n in (r[2] for r in rec.requests):
            least += work.bound_ms(n * (nbytes - weights) + weights,
                                   n * flops, peak)[0]
    return 100.0 * least / ms
