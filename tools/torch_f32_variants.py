#!/usr/bin/env python3
"""The float32 ResStack kernels (csrc/resstack_f32.cu: K2 res_chain, K3
res_shift_single and K4 up_res_stream's kernels) under other choices, on
one CUDA card: builds copies of the source with one choice changed and
times them at the shapes of the parity main path (a 30 s chunk) by CUDA
events: K2 and K3 at stages 0 and 1, K4 (the whole call, planned for the
copy's tile) at stages 2 and 3.

    python3 tools/torch_f32_variants.py [VARIANT ...]

Variants (all by default):
  base            the kernel as it is
  stages_2/4      a cp.async ring of 2 or 4 K steps instead of 3
  lrelu_at_read   conv1's LeakyReLU applied to each A vector as a thread
                  reads it into its fragment, not once per staged element
  rows_4          4 rows a thread below 256 columns: 64-row tiles at
                  C = 128 (the kernel: 8, 128 rows), 128 at C = 64
  rows_8          8 rows a thread at every width: 256-row tiles at C = 64
                  (the kernel: 4, 128 rows)
  rows_2          2 rows a thread at 64 columns: 64-row tiles at C = 64
Every copy computes what the kernel computes and is held to the plain
version (rtol 1e-4, atol 1e-4). Prints one line per (variant, shape) with
the time and its ratio to base. The copies are built under
voicefixer_tpu_torch/build/variants_f32/.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SRC = ROOT / "voicefixer_tpu_torch" / "csrc" / "resstack_f32.cu"
STAGES = "constexpr int STAGES = 3;"
READ = ("          av[i] = *reinterpret_cast<const float4*>(pa + a_off[i] + "
        "k4);")
TILES = "  return bn == 64 ? 4 : 8;"
CUTS = {
    "stages_2": [(STAGES, STAGES.replace("3", "2"))],
    "stages_4": [(STAGES, STAGES.replace("3", "4"))],
    "lrelu_at_read": [
        ("        *da = lrelu4(*da, slope);\n", ""),
        ("        *da = lrelu4(v, slope);", "        *da = v;"),
        (READ, "{\n" + READ + "\n          if constexpr (MODE != A_DIRECT) "
               "av[i] = lrelu4(av[i], slope);\n        }")],
    "rows_4": [(TILES, "  return bn == 256 ? 8 : 4;")],
    "rows_8": [(TILES, "  return 8;")],
    "rows_2": [(TILES, "  return bn == 64 ? 2 : 8;")],
}
# the planner's table (kernels/resstack.py::F32_TILES) for a copy's tiles
PLAN_TILES = {"rows_4": {256: 8, 128: 4, 64: 4},
              "rows_8": {256: 8, 128: 8, 64: 8},
              "rows_2": {256: 8, 128: 8, 64: 2}}
VARIANTS = ("base", *CUTS)
# (C, T, dilations, tm): a stage-0 single block, a stage-1 single block,
# stage 1's chain (tm None: a single block)
SHAPES = ((512, 21042, (81,), None), (256, 147294, (27,), None),
          (256, 147294, (1, 3), 54))
# (Cin, Cout, T) of up_res_stream at stages 2 and 3, scale 3
K4_SHAPES = ((256, 128, 147294), (128, 64, 441882))


def build(names):
    from voicefixer_tpu_torch.kernels import build as kb
    out = kb.BUILD / "variants_f32"
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
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    return {name: out / f"{name}.so" for name in names}


def main() -> int:
    import torch

    from voicefixer_tpu_torch.kernels import resstack, resstream
    from voicefixer_tpu_torch.ops.precision import tf32_off

    names = sys.argv[1:] or list(VARIANTS)
    if "base" not in names:
        names = ["base", *names]
    if not torch.cuda.is_available():
        print("torch_f32_variants: no CUDA device", file=sys.stderr)
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
        x = torch.randn((1, t, ch), generator=gen).to(dev)
        bank = [v[:len(dils)].contiguous()
                for v in cs._bank(gen, 8, ch, dev, torch.float32)]
        data.append((ch, t, dils, tm, x, bank))
    k4_data = []
    for cin, cout, t in K4_SHAPES:
        x = torch.randn((1, t, cin), generator=gen).to(dev)
        w = 0.7 / (2 * cin) ** 0.5 * torch.randn((6, cin, cout),
                                                 generator=gen).to(dev)
        b = 0.05 * torch.randn((cout,), generator=gen).to(dev)
        k4_data.append((x, w, b, *cs._bank(gen, 8, cout, dev,
                                           torch.float32)))
    default_tiles = dict(resstack.F32_TILES)
    base = {}
    with tf32_off(), torch.inference_mode():
        for name in names:
            lib = ctypes.CDLL(str(libs[name]))
            lib.vf_res_chain_f32.argtypes = resstack.CHAIN_ARGS
            lib.vf_res_shift_single_f32.argtypes = resstack.SHIFT_ARGS
            lib.vf_up_chain_f32.argtypes = resstack.UP_CHAIN_ARGS
            for ch, t, dils, tm, x, bank in data:
                y = torch.empty_like(x)
                common = (x.data_ptr(), *(v.data_ptr() for v in bank),
                          y.data_ptr(), 1, t, ch)
                if tm is None:
                    fn = lib.vf_res_shift_single_f32
                    args = (*common, dils[0], cs.SLOPE_RES, 0.0, 0, 0, t)
                    ref = resstack.res_shift_single_reference(
                        x, *(v[0] for v in bank), dils[0], cs.SLOPE_RES)
                else:
                    fn = lib.vf_res_chain_f32
                    args = (*common, len(dils), resstack.int_array(dils), tm,
                            cs.SLOPE_RES, 0.0, 0, 0, t)
                    ref = resstack.res_chain_reference(x, *bank, dils,
                                                       cs.SLOPE_RES)

                def go(fn=fn, args=args):
                    return fn(*args, torch.cuda.current_stream().cuda_stream)

                shape = f"C={ch} dilations {dils} tm {tm}"
                if go() != 0:
                    print(f"  {name:14s} {shape}: not launched (the ring "
                          "does not fit)", flush=True)
                    continue
                cs.compare(f"{name} {shape}", y, ref, 1e-4, 1e-4)
                del ref
                ms = cs.cuda_ms(go, 5, warmup=1)
                flops = cs.res_executed_flops(ch, t, dils, tm, 4)
                base.setdefault(shape, ms)
                print(f"  {name:14s} {shape}: {ms:.3f} ms, "
                      f"{flops / ms / 1e9:.1f} TFLOP/s executed, "
                      f"{ms / base[shape]:.2f} of base", flush=True)
            # K4: the whole call through this copy, planned for its tiles
            resstack.F32_TILES.update(PLAN_TILES.get(name, default_tiles))
            resstack.plan_stack.cache_clear()
            resstack._f32_lib = lambda lib=lib: lib
            for args in k4_data:
                x, cin, cout = args[0], args[0].shape[2], args[1].shape[2]
                t = x.shape[1]
                groups = resstream.up_plan(cin, cout, 3, resstack.
                                           stack_dilations(8), 4)
                call = (*args, resstack.stack_dilations(8), 3, cs.SLOPE_RES,
                        cs.SLOPE_ACT)
                cs.compare(f"{name} up_res_stream {cin}->{cout}",
                           resstream.up_res_stream(*call),
                           resstream.up_res_stream_reference(*call),
                           1e-4, 1e-4)
                go = lambda call=call: resstream.up_res_stream(*call)  # noqa: E731
                ms = cs.cuda_ms(go, 3, warmup=1)
                flops = cs.up_res_executed_flops(cin, cout, 3, t, 4)
                shape = f"up_res_stream {cin}->{cout} groups {groups}"
                base.setdefault(f"K4 {cin}", ms)
                print(f"  {name:14s} {shape}: {ms:.3f} ms, "
                      f"{flops / ms / 1e9:.1f} TFLOP/s executed, "
                      f"{ms / base[f'K4 {cin}']:.2f} of base", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
