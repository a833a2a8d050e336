#!/usr/bin/env python3
"""The float32 upsample kernel as the first kernel launch of a new process,
straight after a cold build, on one CUDA card:

    python3 tools/torch_first_launch.py [BUILD_DIR]
    python3 tools/torch_first_launch.py --loop N

A first launch of this case once returned wrong numbers in 6 % of its
outputs and no later one did; this is the record of the hunt. With
BUILD_DIR the kernel libraries are built there (a new directory gives a
cold build) instead of in the package's own build directory. The kernel's
result and the plain version's result on the card are each held to the
plain version on the CPU, so that a fault names its side. Prints one line,
``first launch: kernel bad K, card plain bad P of N``, and exits 1 when
either count is not zero.

``--loop N`` runs that N times, each in a new process with a new build
directory, prints every line and exits 1 if any process did. Run one
process under ``compute-sanitizer --tool racecheck`` (or ``initcheck``,
``memcheck``) where that tool can attach.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CASE = dict(scale=7, cin=64, cout=32, t=100, b=2)
RTOL = ATOL = 1e-5


def one(build_dir: str | None) -> int:
    import torch

    sys.path.insert(0, str(ROOT))
    from voicefixer_tpu_torch.kernels import build
    from voicefixer_tpu_torch.kernels.upsample import (upsample,
                                                       upsample_reference)
    from voicefixer_tpu_torch.ops.precision import tf32_off

    if build_dir:
        build.BUILD = Path(build_dir)
    gen = torch.Generator().manual_seed(0)
    s, cin, cout, t, b = (CASE[k] for k in ("scale", "cin", "cout", "t", "b"))
    x = torch.randn((b, t, cin), generator=gen)
    w = 0.05 * torch.randn((2 * s, cin, cout), generator=gen)
    bias = 0.05 * torch.randn((cout,), generator=gen)
    ref = upsample_reference(x, w, bias, s)
    with tf32_off():
        on_card = [v.cuda() for v in (x, w, bias)]
        got = upsample(*on_card, s).cpu()
        plain = upsample_reference(*on_card, s).cpu()

    def bad(v):
        return int((~torch.isclose(v, ref, rtol=RTOL, atol=ATOL)).sum())

    k, p = bad(got), bad(plain)
    print(f"first launch: kernel bad {k}, card plain bad {p} of "
          f"{ref.numel()}", flush=True)
    return int(k != 0 or p != 0)


def loop(n: int) -> int:
    failed = 0
    for _ in range(n):
        with tempfile.TemporaryDirectory() as d:
            rc = subprocess.run([sys.executable, __file__,
                                 os.path.join(d, "build")]).returncode
        failed += rc != 0
    print(f"{n} first launches, {failed} failed", flush=True)
    return int(failed != 0)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--loop"]:
        sys.exit(loop(int(sys.argv[2])))
    sys.exit(one(sys.argv[1] if len(sys.argv) > 1 else None))
