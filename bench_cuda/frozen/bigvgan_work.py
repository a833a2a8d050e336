"""The least work of K10, BigVGAN's anti-aliased SnakeBeta: a frozen copy
of ``chip_smoke.py``'s ``snake_aa_work`` as the ``bigvgan`` family first
read it. ``aa_act_roofline`` and ``kernels_roofline`` divide the least
time it gives by K10's device time, so it stays as it is when the program
changes; ``bench_cuda/tests/test_bench_bigvgan.py`` holds it equal to its
origin, so drift there shows."""

from __future__ import annotations

ORIGIN = "chip_smoke.py"
FROZEN = (
    'snake_aa_work',
)


def snake_aa_work(t: int, c: int, size: int):
    """BigVGAN's anti-aliased SnakeBeta on [t, c]: per output element two
    6-tap polyphase sums (24 FLOP), SnakeBeta on the two upsampled samples
    (5 FLOP each: alpha u, sin, square, 1 / beta, + u) and a 12-tap sum
    (24 FLOP), in float32; x read once, y written once, log alpha and
    log beta read once."""
    return 58 * t * c, size * (2 * t * c + 2 * c)
