#!/usr/bin/env python3
"""Where the bfloat16 wgmma chain kernel's time goes, on one CUDA card:
builds copies of csrc/resstack_wgmma.cu that each leave one cost out, or
force one ring-stage depth, and times them at the shapes of a 30 s chunk by
CUDA events: K2's chains at vocoder stages 0 and 1 (vf_res_chain_wgmma, N =
256) and K4's first groups at stages 2 and 3 (vf_up_chain_wgmma: the
upsample and the chain, N = 128 and 64, with its x + sin(x) pre-pass).

    python3 tools/torch_chain_variants.py [VARIANT ...]

Variants (all by default):
  base             the kernel as it is
  no_epilogue      no epilogue: products are computed and dropped
  no_weight_loads  the producer hands each stage over without its TMA loads
  no_a_loads       A from constant registers instead of ldmatrix
  no_prologue      the slab (or the upsample's source rows) is not loaded
  mma_only         all four left out: the barriers and wgmmas alone
  depth_16/32/64   every stage that deep (16, 32 or 64 K rows), where two
                   such stages fit shared memory
The copies that compute what the kernel computes (base, depth_*) are held
to the plain version. Prints one line per (variant, shape) with the time
and its ratio to base. The copies are built under
voicefixer_tpu_torch/build/variants/.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SRC = ROOT / "voicefixer_tpu_torch" / "csrc" / "resstack_wgmma.cu"
EPILOGUES = ("          const int r0 = m * ROWS + wq * 16 + lane / 4;",
             "          const int q0 = m * ROWS + wq * 16 + lane / 4;")
TMA = ("hopper::mbar_arrive_expect_tx(&full[s], stage_bytes);",
       "for (int b = 0; b < boxes; ++b)")
LDM = ("hopper::ldmatrix_x4(cur[kk], col + r * ld + kc + 16 * kk);",
       "hopper::ldmatrix_x4(cur[kk], col + r * ldi + kc + 16 * kk);")
PRO = ("      for (int e = tid; e < slab_rows * vecs; e += 128 * CONSUMERS) {",
       "        for (int e = tid; e < src_rows * vecs; e += 128 * CONSUMERS) {")
DEPTH = ("    if (p.chunks == 1 && fits(Stage<4, N>::CHUNK_BYTES))\n"
         "      return launch<4, N>(p, w1b, w2b, wub, batch, fixed, s);\n"
         "    return launch<2, N>(p, w1b, w2b, wub, batch, fixed, s);")

CUTS = {
    "no_epilogue": [(epi, f"          if ({d}[0] == 1.f && {d}[N / 2 - 1] == "
                     f"2.f) hbuf[0] = __float2bfloat16({d}[1]);\n"
                     "          continue;\n" + epi)
                    for epi, d in zip(EPILOGUES, ("acc", "u_acc"))],
    "no_weight_loads": [(TMA[0], "hopper::mbar_arrive(&full[s]);"),
                        (TMA[1], "for (int b = 0; b < 0; ++b)")],
    "no_a_loads": [(ldm, "cur[kk][0] = r; cur[kk][1] = kc; cur[kk][2] = "
                    "r ^ kc; cur[kk][3] = kk;") for ldm in LDM],
    "no_prologue": [(pro, pro.replace("vecs;", "0;", 1).replace(
        "* vecs;", "* 0;")) for pro in PRO],
}
CUTS["mma_only"] = [c for k in ("no_epilogue", "no_weight_loads",
                                "no_a_loads", "no_prologue") for c in CUTS[k]]
for depth, ks in (("depth_16", 1), ("depth_32", 2), ("depth_64", 4)):
    CUTS[depth] = [(DEPTH, f"    if (!fits(Stage<{ks}, N>::CHUNK_BYTES)) "
                           "return cudaErrorInvalidValue;\n"
                           f"    return launch<{ks}, N>(p, w1b, w2b, wub, "
                           "batch, fixed, s);")]
VARIANTS = ("base", *CUTS)
EXACT = ("base", "depth_16", "depth_32", "depth_64")
# (C, T, dilations, tm): stage 0's chain, stage 1's, and stage 1's first
# two blocks at the tile that makes h two 64-row tiles
SHAPES = ((512, 21042, (1, 3), 54), (256, 147294, (1, 3, 9), 98),
          (256, 147294, (1, 3), 118))
# (Cin, Cout, T) of up_res_stream's first group at stages 2 and 3, scale 3,
# at the plan's blocks and tile
UP_SHAPES = ((256, 128, 147294), (128, 64, 441882))


def build(names):
    from voicefixer_tpu_torch.kernels import build as kb
    out = kb.BUILD / "variants"
    out.mkdir(parents=True, exist_ok=True)
    src = SRC.read_text()
    procs = {}
    for name in names:
        text = src
        for old, new in CUTS.get(name, []):
            if old not in text:
                raise RuntimeError(f"{name}: the kernel source no longer has "
                                   f"{old.strip()!r}")
            text = text.replace(old, new)
        cu = out / f"{name}.cu"
        cu.write_text(text)
        cmd = [kb.nvcc(), *kb.FLAGS, "-I", str(SRC.parent), "-o",
               str(out / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT)
    for name, p in procs.items():
        log = p.communicate()[0].decode(errors="replace")
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill stores" in line \
                    or "C75" in line:
                print(f"  {name}: {line.strip()[:160]}", flush=True)
    return {name: out / f"{name}.so" for name in names}


def main() -> int:
    import torch

    from voicefixer_tpu_torch.kernels import resstack, resstream
    from voicefixer_tpu_torch.ops.precision import tf32_off

    names = sys.argv[1:] or list(VARIANTS)
    if "base" not in names:
        names = ["base", *names]
    if not torch.cuda.is_available():
        print("torch_chain_variants: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    libs = build(names)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(cs.SEED)
    data = []
    for ch, t, dils, tm in SHAPES:
        x = torch.randn((1, t, ch), generator=gen).to(dev, torch.bfloat16)
        bank = [v[:len(dils)].contiguous()
                for v in cs._bank(gen, 8, ch, dev, torch.bfloat16)]
        data.append((ch, t, dils, tm, x, bank))
    up_data = []
    for cin, cout, t in UP_SHAPES:
        groups = resstream.up_plan(cin, cout, 3, resstack.stack_dilations(8),
                                   2)
        i1, tm = groups[0][1], groups[0][2]
        dils = resstack.stack_dilations(8)[:i1]
        x = torch.randn((1, t, cin), generator=gen).to(dev, torch.bfloat16)
        # chip_smoke.py's weights of the transposed convolution
        w = ((torch.rand((6, cin, cout), generator=gen) * 2 - 1)
             * (1 / (cin * 6)) ** 0.5).to(dev, torch.bfloat16)
        b = (0.01 * torch.randn((cout,), generator=gen)).to(dev,
                                                           torch.bfloat16)
        bank = [v[:i1].contiguous()
                for v in cs._bank(gen, 8, cout, dev, torch.bfloat16)]
        up_data.append((cin, cout, t, dils, tm, x, w, b, bank))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    base = {}
    with tf32_off(), torch.inference_mode():
        for name in names:
            lib = ctypes.CDLL(str(libs[name]))
            fn = lib.vf_res_chain_wgmma
            fn.argtypes = [p, p, p, p, p, p, i, i, i, i,
                           ctypes.POINTER(ctypes.c_int), i, f, f, i, i, i, p]
            up_fn = lib.vf_up_chain_wgmma
            up_fn.argtypes = resstack.UP_CHAIN_ARGS
            cases = []
            for ch, t, dils, tm, x, bank in data:
                y = torch.empty_like(x)
                args = (x.data_ptr(), *(v.data_ptr() for v in bank),
                        y.data_ptr(), 1, t, ch, len(dils),
                        resstack.int_array(dils), tm, cs.SLOPE_RES, 0.0, 0,
                        0, t)
                cases.append((f"C={ch} dilations {dils} tm {tm}", fn, args,
                              y, lambda x=x, bank=bank, dils=dils:
                              resstack.res_chain_reference(
                                  x, *bank, dils, cs.SLOPE_RES), len(dils)))
            for cin, cout, t, dils, tm, x, w, b, bank in up_data:
                y = torch.empty((1, 3 * t, cout), device=dev,
                                dtype=torch.bfloat16)
                a = torch.empty_like(x)
                args = (x.data_ptr(), a.data_ptr(), w.data_ptr(),
                        b.data_ptr(), *(v.data_ptr() for v in bank),
                        y.data_ptr(), 1, t, cin, cout, 3, len(dils),
                        resstack.int_array(dils), tm, cs.SLOPE_RES, 0.0, 0)
                cases.append((f"upsample {cin}->{cout} + dilations {dils} "
                              f"tm {tm}", up_fn, args, y,
                              lambda x=x, w=w, b=b, bank=bank, dils=dils:
                              resstream.up_res_stream_reference(
                                  x, w, b, *bank, dils, 3, cs.SLOPE_RES),
                              len(dils)))
            for shape, fn_, args, y, ref, n in cases:
                def go(fn=fn_, args=args):
                    return fn(*args, torch.cuda.current_stream().cuda_stream)

                if go() != 0:
                    print(f"  {name:16s} {shape}: not launched (the ring "
                          "does not fit)", flush=True)
                    continue
                if name in EXACT:
                    cs.compare(f"{name} {shape}", y, ref(), 2 ** -7, 1e-3,
                               chained=n)
                ms = cs.cuda_ms(go, 10, warmup=2)
                base.setdefault(shape, ms)
                print(f"  {name:16s} {shape}: {ms:.3f} ms, "
                      f"{ms / base[shape]:.2f} of base", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
