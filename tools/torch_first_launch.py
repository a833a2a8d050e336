#!/usr/bin/env python3
"""A kernel as the first kernel launch of a new process, straight after a
cold build, on one CUDA card:

    python3 tools/torch_first_launch.py [--case NAME] [BUILD_DIR]
    python3 tools/torch_first_launch.py [--case NAME] --loop N

Cases: ``upsample`` (the default), the float32 upsample, whose first launch
once returned wrong numbers in 6 % of its outputs and no later one did: this
is the record of the hunt; ``res_chain``, the bfloat16 wgmma chain at the
width of vocoder stage 0. With BUILD_DIR the kernel libraries are built
there (a new directory gives a cold build) instead of in the package's own
build directory. The kernel's result
and the plain version's result on the card are each held to the plain
version on the CPU, so that a fault names its side. Prints one line,
``first launch: kernel bad K, card plain bad P of N``, and exits 1 when
either count is not zero.

``--loop N`` runs that N times, each in a new process with a new build
directory, prints every line and exits 1 if any process did. Run one
process under ``compute-sanitizer --tool racecheck`` (or ``initcheck``,
``memcheck``) where that tool can attach.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
UPSAMPLE = dict(scale=7, cin=64, cout=32, t=100, b=2)
CHAIN = dict(ch=512, t=300, b=1, dils=(1, 3))


def _upsample(torch):
    """(kernel, card plain, CPU plain) outputs; tolerance 1e-5 (float32
    sums in another order)."""
    from voicefixer_tpu_torch.kernels.upsample import (upsample,
                                                       upsample_reference)
    gen = torch.Generator().manual_seed(0)
    s, cin, cout, t, b = (UPSAMPLE[k]
                          for k in ("scale", "cin", "cout", "t", "b"))
    x = torch.randn((b, t, cin), generator=gen)
    w = 0.05 * torch.randn((2 * s, cin, cout), generator=gen)
    bias = 0.05 * torch.randn((cout,), generator=gen)
    ref = upsample_reference(x, w, bias, s)
    on_card = [v.cuda() for v in (x, w, bias)]
    return (upsample(*on_card, s).cpu(),
            upsample_reference(*on_card, s).cpu(), ref, 1e-5, 1e-5)


def _res_chain(torch):
    """(kernel, card plain, CPU plain) outputs, bfloat16; tolerance one
    bfloat16 ulp of the largest intermediate through the chained blocks
    (2^-7 * max|ref| + 2^-7 * |ref|)."""
    from voicefixer_tpu_torch.kernels.resstack import (res_chain,
                                                       res_chain_reference)
    gen = torch.Generator().manual_seed(0)
    ch, t, b, dils = (CHAIN[k] for k in ("ch", "t", "b", "dils"))
    n = len(dils)
    sc = 0.5 / (3 * ch) ** 0.5
    bank = [(sc * torch.randn((n, 3, ch, ch), generator=gen)),
            0.05 * torch.randn((n, ch), generator=gen),
            (sc * torch.randn((n, 3, ch, ch), generator=gen)),
            0.05 * torch.randn((n, ch), generator=gen)]
    bank = [v.to(torch.bfloat16) for v in bank]
    x = torch.randn((b, t, ch), generator=gen).to(torch.bfloat16)
    ref = res_chain_reference(x, *bank, dils, 0.2, 0.3).float()
    on_card = [v.cuda() for v in (x, *bank)]
    got = res_chain(*on_card, dils, 0.2, 0.3)
    plain = res_chain_reference(*on_card, dils, 0.2, 0.3)
    return (got.float().cpu(), plain.float().cpu(), ref, 2 ** -7,
            2 ** -7 * float(ref.abs().max()))


CASES = {"upsample": _upsample, "res_chain": _res_chain}


def one(case: str, build_dir: str | None) -> int:
    import torch

    sys.path.insert(0, str(ROOT))
    from voicefixer_tpu_torch.kernels import build
    from voicefixer_tpu_torch.ops.precision import tf32_off

    if build_dir:
        build.BUILD = Path(build_dir)
    with tf32_off():
        got, plain, ref, rtol, atol = CASES[case](torch)

    def bad(v):
        return int((~torch.isclose(v, ref, rtol=rtol, atol=atol)).sum())

    k, p = bad(got), bad(plain)
    print(f"first launch ({case}): kernel bad {k}, card plain bad {p} of "
          f"{ref.numel()}", flush=True)
    return int(k != 0 or p != 0)


def loop(case: str, n: int) -> int:
    failed = 0
    for _ in range(n):
        with tempfile.TemporaryDirectory() as d:
            rc = subprocess.run([sys.executable, __file__, "--case", case,
                                 os.path.join(d, "build")]).returncode
        failed += rc != 0
    print(f"{n} first launches ({case}), {failed} failed", flush=True)
    return int(failed != 0)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", choices=sorted(CASES), default="upsample")
    ap.add_argument("--loop", type=int, default=0)
    ap.add_argument("build_dir", nargs="?")
    a = ap.parse_args()
    sys.exit(loop(a.case, a.loop) if a.loop else one(a.case, a.build_dir))
