#!/usr/bin/env python3
"""The GRU recurrence (csrc/gru_bidir.cu: K6 vf_gru_bidir in both types, K8
vf_gru_seq) under other choices, on one CUDA card: builds copies of the
source with one choice changed and times them at the main path's shapes
(H = 256, T = 3001 steps, batch 1) by CUDA events and by the profiler's
device time.

    python3 tools/torch_gru_variants.py [--root DIR] [VARIANT ...]

Variants (all by default):
  base             the kernel as it is
  cluster_4/8      4 or 8 blocks a cluster where the kernel takes 16 (a
                   non-portable size) when the card runs every cluster of
                   the launch at once
  chains_1/2/8     accumulators per column in each lane's product
  xring_16/64      steps of x projections copied ahead (32 in the kernel)
  hbuf_3           three h buffers in the exchange ring instead of two
  cluster_barrier  the exchange this design replaced: plain stores into the
                   peers' shared memory and a cluster-wide barrier every
                   step, in place of st.async completing on mbarriers
  cta_wait         the wait on h with CTA-scope acquire, not cluster-scope
  test_wait        the wait on h spinning on test_wait, not try_wait
  accurate_gates   the gates on expf and tanhf, not __expf and __fdividef
  floor            the step floor: the same loop with the product and the
                   gates left out (h is read, reduced, mixed with x and
                   pushed): what a step costs before any arithmetic
  floor_local      the floor with every push into the pushing block itself
                   (the same stores and transaction bytes, none remote)
  floor_noshfl     the floor without the shuffles (reduction and gather)
  floor_nox        the floor without the x ring's reads
  floor_1msg       the floor with one push a block and peer (warp 0's)
                   instead of one a warp and peer
--root DIR adds ``parent``: DIR's csrc/gru_bidir.cu (for example a ``git
archive`` of an earlier commit, unpacked into a directory that .gitignore
lists), built the same way; parent and base are then timed in turns A, B,
B, A. Every copy but the floors is held to the plain version first (float32
1e-4, bfloat16 2e-2: chip_smoke.py's tolerances); one that disagrees is
reported and not timed. Prints the card's name
and power limit, then one line per (variant, case): ms by events and by
device time, microseconds a step, and the ratio to base. The copies are
built under voicefixer_tpu_torch/build/variants_gru/.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SRC = ROOT / "voicefixer_tpu_torch" / "csrc" / "gru_bidir.cu"
H, T = 256, cs.GRU_FRAMES


def _const(name, value):
    return f"constexpr int {name} = {value};"


AWAIT = "  hopper::mbar_wait_cluster(full + s % HBUF, ((s - 1) / HBUF) & 1);\n"
REARM = "      if (tid == 0) rearm(full, s, n_steps, bytes);\n"
PUSH = """  hopper::st_async_v4_f32(dst + nb * MAX_HIDDEN * 4, q[0], q[1], q[2], q[3],
                          bar + nb * 8);
"""
PRODUCT = "      product<W>(ws, hbuf[s % HBUF], ks, p);\n"
REDUCE = """#pragma unroll
      for (int g = 0; g < 3; ++g) {
        p[g] += __shfl_xor_sync(0xffffffffu, p[g], 1);
        p[g] += __shfl_xor_sync(0xffffffffu, p[g], 2);
        p[g] += __shfl_xor_sync(0xffffffffu, p[g], 4);
      }
"""
GATHER = "          qs[c] = __shfl_sync(0xffffffffu, q, 8 * c);\n"
GATES = """        const float r = sigmoid(xr + (p[0] + br));
        const float z = sigmoid(xz + (p[1] + bz));
        const float n = tanh_fast(xn + r * (p[2] + bn));
        h = (1.f - z) * n + z * h;
"""
XREAD = """        hopper::cp_async_wait_group<XRING - 1>();
        xr = xs[0];
        xz = xs[L::MAX_U];
        xn = xs[2 * L::MAX_U];
"""
PEER = "  const uint32_t peer = pusher ? lane : 0;\n"
FLOOR = [(PRODUCT, "      p[0] = p[1] = p[2] = hbuf[s % HBUF][4 * ks];\n"),
         (GATES, "        h = 0.5f * (xr + xz + xn) + 1e-3f * p[0];\n")]
CUTS = {
    "cluster_4": [(_const("CLUSTER_WIDE", 16), _const("CLUSTER_WIDE", 4))],
    "cluster_8": [(_const("CLUSTER_WIDE", 16), _const("CLUSTER_WIDE", 8))],
    "chains_1": [(_const("CHAINS", 4), _const("CHAINS", 1))],
    "chains_2": [(_const("CHAINS", 4), _const("CHAINS", 2))],
    "chains_8": [(_const("CHAINS", 4), _const("CHAINS", 8))],
    "xring_16": [(_const("XRING", 32), _const("XRING", 16))],
    "xring_64": [(_const("XRING", 32), _const("XRING", 64))],
    "hbuf_3": [(_const("HBUF", 2), _const("HBUF", 3))],
    # every warp of every block holds units at H = 256, so all take part
    "cluster_barrier": [
        (AWAIT, "  cg::this_cluster().sync();  // orders last step's pushes\n"),
        (REARM, ""),
        (PUSH, '  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, '
               '%4};" :: "r"(dst + nb * MAX_HIDDEN * 4), "f"(q[0]), '
               '"f"(q[1]), "f"(q[2]), "f"(q[3]) : "memory");\n')],
    # the wait on h: CTA-scope acquire (hopper::mbar_wait); a spin on the
    # non-suspending test_wait instead of try_wait
    "cta_wait": [(AWAIT, AWAIT.replace("mbar_wait_cluster", "mbar_wait"))],
    "test_wait": [(AWAIT, """  uint32_t done;
  do {
    asm volatile(
        "{\\n.reg .pred p;\\n"
        "mbarrier.test_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\\nselp.u32 %0, 1, 0, p;\\n}\\n"
        : "=r"(done) : "r"(hopper::smem_u32(full + s % HBUF)),
          "r"(((s - 1) / HBUF) & 1) : "memory");
  } while (!done);
""")],
    # the gates on CUDA's accurate expf and tanhf
    "accurate_gates": [
        ("  return __fdividef(1.f, 1.f + __expf(-v));",
         "  return 1.f / (1.f + expf(-v));"),
        ("  return 2.f * sigmoid(2.f * v) - 1.f;", "  return tanhf(v);")],
    "floor": FLOOR,
    # the floor with one more piece left out: every push into the pushing
    # block itself (the same stores and transaction bytes, none remote);
    # no shuffles (no reduction, no gather); x off the step
    "floor_local": FLOOR + [(PEER, "  const uint32_t peer = rank;\n")],
    "floor_noshfl": FLOOR + [(REDUCE, ""), (GATHER, "          qs[c] = q;\n")],
    "floor_nox": FLOOR + [(XREAD, "        xr = xz = xn = 0.5f;\n")],
    # the floor with one message a block and peer (warp 0's) instead of one
    # a warp and peer: 16 arrivals on a barrier a step instead of 64
    "floor_1msg": FLOOR + [
        ("  const uint32_t bytes = (H + UPW - 1) / UPW * UPW * 4;",
         "  const uint32_t bytes = 16 * CL;"),
        ("        if (pusher) push_h(", "        if (pusher && warp == 0) push_h(")],
}
VARIANTS = ("base", *CUTS)


def build(names, parent_src):
    from voicefixer_tpu_torch.kernels import build as kb
    out = kb.BUILD / "variants_gru"
    out.mkdir(parents=True, exist_ok=True)
    src = SRC.read_text()
    procs = {}
    for name in names:
        if name == "parent":
            cu, inc = parent_src, parent_src.parent
        else:
            text = src
            for old, new in CUTS.get(name, []):
                if old not in text:
                    raise RuntimeError(f"{name}: the kernel source no longer "
                                       f"has {old.strip()!r}")
                text = text.replace(old, new)
            cu, inc = out / f"{name}.cu", SRC.parent
            cu.write_text(text)
        cmd = [kb.nvcc(), *kb.FLAGS, "-I", str(inc), "-o",
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


def caller(lib, two_outputs, case, args):
    """A function that launches the library's kernel for one case and
    returns its output: (fwd, bwd) for the bidirectional cases."""
    import torch
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vf_gru_bidir.restype = lib.vf_gru_seq.restype = i
    lib.vf_gru_bidir.argtypes = ([p] * (8 if two_outputs else 7)
                                 + [i, i, i, i, p])
    lib.vf_gru_seq.argtypes = [p, p, p, p, i, i, i, i, p]
    x, xb, w, wb, b, bb = args
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    if case == "gru_seq":
        out = torch.empty((1, T, H), device=x.device)

        def go():
            rc = lib.vf_gru_seq(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                out.data_ptr(), 1, T, H, 0, stream())
            return out if rc == 0 else rc
        return go
    bf16 = int(case.endswith("bf16"))
    ws = [v.to(torch.bfloat16 if bf16 else torch.float32).contiguous()
          for v in (w, wb)]
    out = torch.empty((1, T, 2 * H), device=x.device)
    outs = ([torch.empty((1, T, H), device=x.device) for _ in range(2)]
            if two_outputs else [out])

    def go():
        rc = lib.vf_gru_bidir(x.data_ptr(), xb.data_ptr(), ws[0].data_ptr(),
                              ws[1].data_ptr(), b.data_ptr(), bb.data_ptr(),
                              *(o.data_ptr() for o in outs), 1, T, H, bf16,
                              stream())
        if rc:
            return rc
        return tuple(outs) if two_outputs else (out[..., :H], out[..., H:])
    return go


def main() -> int:
    import torch

    from voicefixer_tpu_torch.kernels import gru
    from voicefixer_tpu_torch.ops.precision import tf32_off

    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path)
    ap.add_argument("variants", nargs="*")
    a = ap.parse_args()
    names = list(a.variants or VARIANTS)
    if "base" not in names:
        names = ["base", *names]
    parent_src = None
    if a.root:
        parent_src = a.root.resolve() / "voicefixer_tpu_torch" / "csrc" / \
            "gru_bidir.cu"
        names.append("parent")
    if not torch.cuda.is_available():
        print("torch_gru_variants: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; H {H}, T {T}, batch 1", flush=True)
    libs = build(names, parent_src)
    wide = ctypes.CDLL(str(libs["base"])).vf_gru_wide_clusters()
    print(f"clusters of 16 the card runs at once: {wide} (a launch of more "
          "takes clusters of 8)", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(cs.SEED)
    u = lambda *s: ((2 * torch.rand(s, generator=gen) - 1)  # noqa: E731
                    / H ** 0.5).to(dev)
    args = (torch.randn((1, T, 3 * H), generator=gen).to(dev),
            torch.randn((1, T, 3 * H), generator=gen).to(dev),
            u(H, 3 * H), u(H, 3 * H), u(3 * H), u(3 * H))
    x, xb, w, wb, b, bb = args
    cases = {"gru_bidir_f32": (torch.float32, 1e-4),
             "gru_bidir_bf16": (torch.bfloat16, 2e-2),
             "gru_seq": (torch.float32, 1e-4)}
    group = {"gru_seq": "K8 gru_seq"}
    with tf32_off(), torch.inference_mode():
        refs = {c: (gru.gru_seq_reference(x, w, b) if c == "gru_seq" else
                    gru.gru_bidir_reference(x, xb, w, wb, b, bb, dt))
                for c, (dt, _) in cases.items()}
        go = {}
        for name in names:
            lib = ctypes.CDLL(str(libs[name]))
            for case, (_, tol) in cases.items():
                fn = caller(lib, name == "parent", case, args)
                got = fn()
                if isinstance(got, int):
                    print(f"  {name:16s} {case}: not launched (CUDA error "
                          f"{got})", flush=True)
                    continue
                torch.cuda.synchronize()
                if not name.startswith("floor"):
                    ref = refs[case]
                    pairs = (zip(got, ref) if isinstance(got, tuple)
                             else [(got, ref)])
                    try:
                        for g_, r_ in pairs:
                            cs.compare(f"{name} {case}", g_, r_, tol, tol)
                    except AssertionError as e:  # reported, not timed
                        print(f"  {name:16s} {case}: {e}", flush=True)
                        continue
                go[name, case] = fn
        order = [n for n in names if n != "parent"]
        if "parent" in names:  # turns A, B, B, A
            order = ["parent", "base", "base", "parent"] + order[1:]
        times = {}
        for name in order:
            for case in cases:
                if (name, case) not in go:
                    continue
                fn = go[name, case]
                ms = cs.cuda_ms(fn, 3)
                dev_ms = cs.device_ms(fn, 3, group.get(case, "K6 gru_bidir"),
                                      per_call=1)
                times.setdefault((name, case), []).append(dev_ms)
                print(f"  {name:16s} {case}: {ms:.3f} ms by events, "
                      f"{dev_ms:.3f} ms device, {dev_ms / T * 1e3:.4f} us a "
                      "step", flush=True)
    print("device time against base (mean of its turns):", flush=True)
    for (name, case), ts in times.items():
        base = times[("base", case)]
        print(f"  {name:16s} {case}: "
              f"{sum(ts) / len(ts) / (sum(base) / len(base)):.3f}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
