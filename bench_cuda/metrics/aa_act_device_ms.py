"""aa_act_device_ms (kernels: ``kernels/snake_aa.py`` ->
``csrc/snake_aa.cu``, K10): device milliseconds per segment (in the
``bigvgan`` family an audio second) of the launches of
``snake_aa_kernel``, BigVGAN's anti-aliased SnakeBeta, in the traced
sample. None where none ran."""

KERNEL = "snake_aa_kernel"


def read(run):
    rec = run.record
    if rec is None or not rec.segments:
        return None
    ms = sum(e.end - e.start for e in rec.device if KERNEL in e.name) / 1e3
    return ms / rec.segments if ms > 0 else None
