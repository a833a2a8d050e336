#!/usr/bin/env python3
"""The ConvBlockRes kernel (csrc/convblock.cu, K9 conv_block_res) under
other plans and in copies with one choice changed, on one CUDA card: times
it at the shapes of the ResUNet's blocks in a 30 s chunk (device time of
its kernel, torch.profiler), each variant that computes K9 held to the
plain version first.

    python3 tools/torch_convblock_variants.py [VARIANT ...]

Variants (all by default):
  base            the planner's plan (kernels.convblock.plan_stream)
  one_step        runs of one step: conv1's halo again every step, as the
                  tile-with-halo kernel that came before it did
  runs_1/2/4      1, 2 or 4 runs an SM (132, 264 or 528 runs a batch row)
  stages_4/8      bfloat16: a weight ring of 4 or 8 stages where they fit
                  (the planner takes up to 8)
  step_half       half the planner's step (bfloat16; float32 where the
                  thread tile allows it)
  resident        bfloat16: a copy that holds every weight stage of both
                  matrices in shared memory, loaded once a run and never
                  handed back, where that fits (Co <= 64)
  depth_3/4       bfloat16: a copy of the source with 3 or 4 weight stages'
                  wgmmas in flight instead of 2 (DEPTH)
  sc_tile         float32, blocks with the 1x1 shortcut: a copy that
                  computes the shortcut first as a product of its own into a
                  float32 tile in shared memory (BM x (np + 4)), which
                  conv2's epilogue adds, in place of conv2's last K steps,
                  at the planner's step or half of it, where the tile fits
                  (compare with step_half where the step is halved)
  no_*            bfloat16: copies with one cost left out, which compute
                  something else and are timed only: no_a_loads (A
                  fragments not loaded), no_tap_math (every tap reads the
                  first tap's rows), no_wgmma, no_epilogue (no a2 or
                  output stores), no_a1 (no a1 rows copied); f32_no_epilogue
                  and f32_no_a1 the same in float32
The copies are built under voicefixer_tpu_torch/build/variants_convblock/;
their text hooks must match the kernel source, and the tool says which
does not.
Prints one line per (variant, type, shape) with the time, the executed
TFLOP/s and the ratio to base, and the card's name and power limit first.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SRC = ROOT / "voicefixer_tpu_torch" / "csrc" / "convblock.cu"
DEPTH = "constexpr int DEPTH = 2;"
WGMMA = """            hopper::wgmma_m64k16_bf16_rs_kmajor<NP>(
                acc, frag[d][kk], hopper::desc_advance(db, kk * 32),
                stg > 0 || kk > 0);"""
CUTS = {
    "depth_3": [(DEPTH, DEPTH.replace("2", "3"))],
    "depth_4": [(DEPTH, DEPTH.replace("2", "4"))],
    "no_a_loads": [("          hopper::ldmatrix_x4(r, col + a_row + a_c0);",
                    "          r[0] = r[1] = r[2] = r[3] = a_row + a_c0;")],
    "no_tap_math": [("          if (++a_tap < 9) a_row = tap_row(a_tap);",
                     "          ++a_tap;")],
    "no_wgmma": [(WGMMA, "            acc[0] += __uint_as_float("
                         "frag[d][kk][0] ^ frag[d][kk][3]);")],
    "no_epilogue": [("      epi(t0, acc);",
                     "      if (acc[0] == 1.2345e-30f) epi(t0, acc);")],
    "no_a1": [("    a1_rows(a1_end, q0 + rows + hb - a1_end);", "")],
}
F32_CONV2 = """    product<NP, TR>(
        wring, w2, steps2, kc2, a2, ld2, p.ring2, origin2, o0, p, st, xb,
        [] {},
        [&](int m, int n, float (&v)[4]) {
          const int q = o0 + m;
          if (q >= s1 || n >= co || !st.inside(q)) return;
          const long long pix = st.pixel(q);
          float r[4];
          if (bsc) load4(bsc + n, co - n, vec_y, r);"""
CUTS["sc_tile"] = [
    ("  float* a2 = a1 + p.ring1 * ld1;                // [ring2][ld2]\n",
     "  float* a2 = a1 + p.ring1 * ld1;                // [ring2][ld2]\n"
     "  float* sct = a2 + p.ring2 * ld2;  // [BM][NP + 4]\n"),
    (F32_CONV2, """    if (bsc)
      product<NP, TR>(
          wring, w2 + static_cast<long long>(9 * p.cp2) * NP, kc1, 0, a2,
          ld2, p.ring2, origin2, o0, p, st, xb, [] {},
          [&](int m, int n, float (&v)[4]) {
#pragma unroll
            for (int u = 0; u < 4; ++u)
              sct[m * (NP + 4) + n + u] =
                  v[u] + (n + u < co ? bsc[n + u] : 0.f);
          });
    product<NP, TR>(
        wring, w2, 9 * kc2, kc2, a2, ld2, p.ring2, origin2, o0, p, st, xb,
        [] {},
        [&](int m, int n, float (&v)[4]) {
          const int q = o0 + m;
          if (q >= s1 || n >= co || !st.inside(q)) return;
          const long long pix = st.pixel(q);
          float r[4];
          if (bsc) load4(sct + m * (NP + 4) + n, co - n, vec_y, r);"""),
    (" * ld_of(p.cp2));\n}",
     " * ld_of(p.cp2) +\n          static_cast<size_t>(p.bm) * (np + 4));\n}"),
]
CUTS["f32_no_epilogue"] = [
    ("      epi(ty + NY * i, 4 * tx + g * 4 * NX, v);",
     "      if (v[0] == 1.2345e-30f)\n"
     "        epi(ty + NY * i, 4 * tx + g * 4 * NX, v);")]
CUTS["f32_no_a1"] = [("    a1_rows(fresh, cnt, false);\n", ""),
                     ("        [&] { a1_rows(fresh, cnt, true); },",
                      "        [] {},")]
CUTS["resident"] = [
    ('''      walk(s0, s1, hb, origin2, bm, ROWS,
           [&](int, int rows) { feed(&map_w1, n_st1, rows); },
           [&](int, int rows) { feed(&map_w2, n_st2, rows); });''',
     '''      feed(&map_w1, n_st1, ROWS);  // stage k of w1 in slot k, of w2
      feed(&map_w2, n_st2, ROWS);  // in slot n_st1 + k'''),
    ("    if (lane == 0) hopper::mbar_arrive(&empty[stage]);",
     "    (void)stage;"),
    ("    for (int ps = 0; ps < passes(rows); ++ps) {\n",
     "    for (int ps = 0; ps < passes(rows); ++ps) {\n"
     "      s = ring == a1 ? 0 : n_st1, phase = 0;\n"),
]
CHECKED = ("depth_3", "depth_4", "sc_tile", "resident")  # compute K9
VARIANTS = ("base", "one_step", "runs_1", "runs_2", "runs_4", "stages_4",
            "stages_8", "step_half", *CUTS)


def build(names):
    """{name: loaded library} of the source copies among ``names``, built
    in parallel."""
    import ctypes

    from voicefixer_tpu_torch.kernels import build as kb
    from voicefixer_tpu_torch.kernels import convblock
    out = kb.BUILD / "variants_convblock"
    out.mkdir(parents=True, exist_ok=True)
    src = SRC.read_text()
    procs = {}
    for name in names:
        if name not in CUTS:
            continue
        text = src
        for old, new in CUTS[name]:
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
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0].decode(errors="replace")
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        for line in log.splitlines():
            if "C7515" in line or "registers" in line:
                print(f"  {name}: {line.strip()}", flush=True)
        libs[name] = convblock.bind(ctypes.CDLL(str(out / f"{name}.so")))
    return libs


def plan_of(name: str, t: int, f: int, ci: int, co: int, itemsize: int):
    """The plan of a variant, or None where it does not apply or fit."""
    from voicefixer_tpu_torch.kernels import convblock as cb
    base = cb.plan_stream(t, f, ci, co, itemsize)
    rows = t * (f + 1)
    if name == "base":
        return base
    if name == "one_step":
        return cb.plan_stream(t, f, ci, co, itemsize, run=base.bm,
                              bm=base.bm)
    if name.startswith("runs_"):
        per_row = cb.SMS * int(name[5:])
        return cb.plan_stream(t, f, ci, co, itemsize,
                              run=-(-rows // per_row), bm=base.bm)
    if name == "sc_tile":  # the planner's step, else half of it, if fits
        if itemsize != 4 or ci == co:
            return None
        for bm in (base.bm, base.bm // 2):
            q = cb.plan_stream(t, f, ci, co, itemsize, bm=bm)
            if q is not None and q.bm == bm and (
                    q.smem + 4 * bm * (q.np + 4) <= cb.SMEM_LIMIT):
                return q
        return None
    if name.startswith("f32_"):
        return base if itemsize == 4 else None
    if name == "resident":  # a ring of every stage of w1 and w2
        if itemsize != 2:
            return None
        k2 = 9 * base.cp2 + (base.cp1 if ci != co else 0)
        stages = -(-9 * base.cp1 // cb.WG_BK) + -(-k2 // cb.WG_BK)
        bm = base.bm
        while True:
            smem = cb.wgmma_smem_bytes(base.np, bm, base.cp1, base.cp2, f,
                                       stages)
            if smem <= cb.SMEM_LIMIT or bm <= cb.WG_G:
                break
            bm -= cb.WG_G
        if smem > cb.SMEM_LIMIT:
            return None
        p = cb.plan_stream(t, f, ci, co, itemsize, run=base.run, bm=bm)
        if p is None:  # the step fits only with the resident ring
            return None
        return dataclasses.replace(p, stages=stages, smem=smem)
    if name in CUTS:
        return base if itemsize == 2 else None
    if name.startswith("stages_"):
        stages = int(name[7:])
        if itemsize != 2 or stages == base.stages:
            return None
        smem = cb.wgmma_smem_bytes(base.np, base.bm, base.cp1, base.cp2, f,
                                   stages)
        if smem > cb.SMEM_LIMIT:
            return None
        return dataclasses.replace(base, stages=stages, smem=smem)
    if name == "step_half":
        half = base.bm // 2
        if itemsize == 2 and half % cb.WG_G:
            return None
        p = cb.plan_stream(t, f, ci, co, itemsize, bm=half)
        return p if p is not None and p.bm == half else None
    raise ValueError(name)


def main() -> int:
    import torch

    from voicefixer_tpu_torch.kernels import convblock
    from voicefixer_tpu_torch.ops.precision import tf32_off

    names = sys.argv[1:] or list(VARIANTS)
    if "base" not in names:
        names = ["base", *names]
    if not torch.cuda.is_available():
        print("torch_convblock_variants: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    libs = build(names)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(cs.SEED)
    cases = []
    for dtype in ("float32", "bfloat16"):
        for (t, f, ci, co), k in cs.conv_block_shapes().items():
            c = cs._conv_block_case(gen, dev, dtype, t, f, ci, co, k)
            cases.append((dtype, t, f, ci, co, k, c))
    totals: dict = {}
    with tf32_off(), torch.inference_mode():
        for dtype, t, f, ci, co, k, c in cases:
            x, p, slope = c["args"]
            ref = c["plain"]()
            base_ms = None
            for name in names:
                plan = plan_of(name, t, f, ci, co, x.element_size())
                shape = f"{dtype} [{t}, {f}] {ci}->{co}"
                if plan is None:
                    print(f"  {name:10s} {shape}: does not apply or fit",
                          flush=True)
                    continue
                go = lambda plan=plan, lib=libs.get(name): (  # noqa: E731
                    convblock.launch(x, p, slope, plan, lib))
                try:
                    got = go()
                except RuntimeError as e:  # a copy's rings do not fit
                    print(f"  {name:10s} {shape}: not launched ({e})",
                          flush=True)
                    continue
                if name not in CUTS or name in CHECKED:
                    cs.compare(f"{name} {shape}", got, ref, c["rtol"],
                               c["atol"])
                del got
                ms = cs.device_ms(go, 5, cs.K9_GROUP)
                base_ms = base_ms or ms
                totals[name, dtype] = totals.get((name, dtype), 0.0) + k * ms
                flops = plan.executed_flops(t * (f + 1), ci != co)
                print(f"  {name:10s} {shape}: {ms:.3f} ms (run {plan.run}, "
                      f"step {plan.bm}, stages {plan.stages}), "
                      f"{flops / ms / 1e9:.1f} TFLOP/s executed, "
                      f"{ms / base_ms:.2f} of base", flush=True)
            del ref
    for (name, dtype), ms in sorted(totals.items()):
        print(f"  {name:10s} {dtype}: {ms:.3f} ms over the 24 blocks "
              "(shapes where it does not apply are missing)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
