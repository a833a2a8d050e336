#!/usr/bin/env python3
"""A kernel as the first kernel launch of a new process, straight after a
cold build, on one CUDA card:

    python3 tools/torch_first_launch.py [--case NAME] [BUILD_DIR]
    python3 tools/torch_first_launch.py [--case NAME] --loop N

Cases: ``upsample`` (the default), the float32 upsample, whose first launch
once returned wrong numbers in 6 % of its outputs and no later one did: this
is the record of the hunt; ``res_chain``, the bfloat16 wgmma chain at the
width of vocoder stage 0; ``res_chain_f32`` and ``res_shift_single_f32``,
the float32 chain and single block of csrc/resstack_f32.cu, which stage
their operands through a ``cp.async`` ring as the float32 upsample does,
at the widths of vocoder stages 1 and 0; ``conv_block_res_f32`` and
``conv_block_res_bf16``, the ConvBlockRes kernel of csrc/convblock.cu
(cp.async in float32, TMA and mbarriers in bfloat16) at the ResUNet's
first level with its shortcut, batch 2; ``up_res_stream_f32`` and
``up_res_stream_bf16``, the whole fused stage 2 (256 -> 128, x3) on a
short signal, batch 2, whose first group takes the upsample's operands by
cp.async (float32) or its weights by TMA and mbarriers (bfloat16) and
whose later groups run the single-block kernels. With BUILD_DIR the kernel
libraries are built
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
CHAIN_F32 = dict(ch=256, t=300, b=2, dils=(1, 3))
SHIFT_F32 = dict(ch=512, t=300, b=2, d=81)
CONV_BLOCK = dict(t=200, f=127, ci=64, co=32, b=2)
UP_RES = dict(cin=256, cout=128, scale=3, t=200, b=2)


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


def _f32_bank(torch, gen, n, ch):
    sc = 1 / (3 * ch) ** 0.5
    return [sc * torch.randn((n, 3, ch, ch), generator=gen),
            0.05 * torch.randn((n, ch), generator=gen),
            sc * torch.randn((n, 3, ch, ch), generator=gen),
            0.05 * torch.randn((n, ch), generator=gen)]


def _res_chain_f32(torch):
    """(kernel, card plain, CPU plain) outputs, float32; tolerance 1e-4
    (float32 sums in another order)."""
    from voicefixer_tpu_torch.kernels.resstack import (res_chain,
                                                       res_chain_reference)
    gen = torch.Generator().manual_seed(0)
    ch, t, b, dils = (CHAIN_F32[k] for k in ("ch", "t", "b", "dils"))
    bank = _f32_bank(torch, gen, len(dils), ch)
    x = torch.randn((b, t, ch), generator=gen)
    ref = res_chain_reference(x, *bank, dils, 0.2, 0.3)
    on_card = [v.cuda() for v in (x, *bank)]
    return (res_chain(*on_card, dils, 0.2, 0.3).cpu(),
            res_chain_reference(*on_card, dils, 0.2, 0.3).cpu(), ref, 1e-4,
            1e-4)


def _res_shift_single_f32(torch):
    """(kernel, card plain, CPU plain) outputs, float32; tolerance 1e-4."""
    from voicefixer_tpu_torch.kernels.resstack import (
        res_shift_single, res_shift_single_reference)
    gen = torch.Generator().manual_seed(0)
    ch, t, b, d = (SHIFT_F32[k] for k in ("ch", "t", "b", "d"))
    one = [v[0] for v in _f32_bank(torch, gen, 1, ch)]
    x = torch.randn((b, t, ch), generator=gen)
    ref = res_shift_single_reference(x, *one, d, 0.2, 0.3)
    on_card = [v.cuda() for v in (x, *one)]
    return (res_shift_single(*on_card, d, 0.2, 0.3).cpu(),
            res_shift_single_reference(*on_card, d, 0.2, 0.3).cpu(), ref,
            1e-4, 1e-4)


def _conv_block_res(torch, dtype, rtol, atol):
    """(kernel, card plain, CPU plain) outputs of one ConvBlockRes with the
    1x1 shortcut."""
    from voicefixer_tpu_torch.kernels.convblock import (
        conv_block_res, conv_block_res_reference)
    from voicefixer_tpu_torch.ops.conv import fold_bn_eval
    gen = torch.Generator().manual_seed(0)
    t, f, ci, co, b = (CONV_BLOCK[k] for k in ("t", "f", "ci", "co", "b"))

    def bn(c):
        return {"gamma": 1 + 0.1 * torch.randn((c,), generator=gen),
                "beta": 0.1 * torch.randn((c,), generator=gen),
                "mean": 0.05 * torch.randn((c,), generator=gen),
                "var": 1 + 0.1 * torch.rand((c,), generator=gen)}
    p = fold_bn_eval({
        "bn1": bn(ci), "bn2": bn(co),
        "conv1": {"w": torch.randn((3, 3, ci, co), generator=gen)
                  / (9 * ci) ** 0.5},
        "conv2": {"w": torch.randn((3, 3, co, co), generator=gen)
                  / (9 * co) ** 0.5},
        "shortcut": {"w": torch.randn((1, 1, ci, co), generator=gen)
                     / ci ** 0.5,
                     "b": 0.1 * torch.randn((co,), generator=gen)}})

    def cast(tree, device):
        return {k: cast(v, device) if isinstance(v, dict)
                else v.to(device, dtype) for k, v in tree.items()}
    x = torch.randn((b, t, f, ci), generator=gen).to(dtype)
    ref = conv_block_res_reference(x, cast(p, "cpu"), 0.01).float()
    pc, xc = cast(p, "cuda"), x.cuda()
    return (conv_block_res(xc, pc, 0.01).float().cpu(),
            conv_block_res_reference(xc, pc, 0.01).float().cpu(), ref, rtol,
            atol)


def _up_res_stream(torch, dtype):
    """(kernel, card plain, CPU plain) outputs of up_res_stream. float32:
    1e-4 (sums in another order); bfloat16: one ulp of the largest
    intermediate through the eight chained blocks (2^-7 * max|ref| +
    2^-7 * |ref|)."""
    from voicefixer_tpu_torch.kernels.resstream import (
        up_res_stream, up_res_stream_reference)
    gen = torch.Generator().manual_seed(0)
    cin, cout, s, t, b = (UP_RES[k]
                          for k in ("cin", "cout", "scale", "t", "b"))
    dils = tuple(3 ** i for i in range(8))
    x = torch.randn((b, t, cin), generator=gen)
    w = 0.7 / (2 * cin) ** 0.5 * torch.randn((2 * s, cin, cout),
                                             generator=gen)
    bias = 0.05 * torch.randn((cout,), generator=gen)
    sc = 0.5 / (3 * cout) ** 0.5
    bank = [sc * torch.randn((8, 3, cout, cout), generator=gen),
            0.05 * torch.randn((8, cout), generator=gen),
            sc * torch.randn((8, 3, cout, cout), generator=gen),
            0.05 * torch.randn((8, cout), generator=gen)]
    args = [v.to(dtype) for v in (x, w, bias, *bank)]
    ref = up_res_stream_reference(*args, dils, s, 0.01, 0.2).float()
    on_card = [v.cuda() for v in args]
    got = up_res_stream(*on_card, dils, s, 0.01, 0.2)
    plain = up_res_stream_reference(*on_card, dils, s, 0.01, 0.2)
    if dtype == torch.float32:
        rtol, atol = 1e-4, 1e-4
    else:
        rtol, atol = 2 ** -7, 2 ** -7 * float(ref.abs().max())
    return (got.float().cpu(), plain.float().cpu(), ref, rtol, atol)


CASES = {"upsample": _upsample, "res_chain": _res_chain,
         "res_chain_f32": _res_chain_f32,
         "res_shift_single_f32": _res_shift_single_f32,
         # float32 sums in another order; bfloat16: an ulp of a2 through
         # conv2 (chip_smoke.py's tolerances)
         "conv_block_res_f32": lambda torch: _conv_block_res(
             torch, torch.float32, 1e-4, 1e-4),
         "conv_block_res_bf16": lambda torch: _conv_block_res(
             torch, torch.bfloat16, 2 ** -7, 2 ** -6),
         "up_res_stream_f32": lambda torch: _up_res_stream(torch,
                                                           torch.float32),
         "up_res_stream_bf16": lambda torch: _up_res_stream(torch,
                                                            torch.bfloat16)}


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
