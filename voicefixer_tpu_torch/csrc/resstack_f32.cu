// The vocoder's ResStack in float32, on Hopper's FMA units: K2 res_chain
// (vf_res_chain_f32), K3 res_shift_single (vf_res_shift_single_f32) and the
// fused front of K4 up_res_stream (vf_up_chain_f32).
//
// Replace voicefixer_tpu/kernels/resstack.py::res_chain (:293) and
// ::res_shift_single (:464), and the first group of
// voicefixer_tpu/kernels/resstream.py::up_res_stream (:552) (Pallas, TPU),
// for float32:
//   shift: h = lrelu(sum_j lrelu(x[t + (j-1)d]) @ W1[j] + b1), 0 outside
//          the window [lo, hi), over the tile's rows and one a side; then
//          y = sum_j h[t + j - 1] @ W2[j] + b2 + x, 0 outside the window,
//          with the optional final LeakyReLU. h never leaves shared memory.
//   chain: n such blocks on a time tile plus a halo of E[0] = sum(d_i + 1)
//          rows a side (the slab), kept in shared memory with the widest
//          block's h: block i is computed over the tile widened by E[i+1]
//          rows a side (halo recompute) and written over the slab in place;
//          the last block writes only the tile.
//   up:    the chain whose slab is not loaded but produced in shared memory
//          by the stage's polyphase upsample of a = x + sin(x) (a pre-pass
//          at the slow rate): slab row n = u[n] = z[n + p] with
//          z[q*s + rho] = a[q] @ Wup[rho] + a[q-1] @ Wup[rho + s] + b_up,
//          p = s//2 + s%2, zero outside [0, T*s). The upsampled signal never
//          reaches global memory. (K4's later groups are this file's chain
//          and shift kernels.)
//
// Bound: operations (12*C^2 FLOP per row per block against 8*C bytes). Parity
// mode is true float32: FMA units, no TF32. Design, for an SM's 128 FMA lanes:
//   - one tap product (product()) of a BM x BN tile (Tile<BN>): 256 threads,
//     TR x 8 outputs a thread (rows ty + TY*i, columns 4tx + j and
//     BN/2 + 4tx + j), 16-byte shared reads of both operands; a warp's A
//     reads (four rows, on other banks) and B reads (128 contiguous bytes)
//     take one wavefront each. BN is the least of 64, 128 and 256 that
//     covers the width (N = C at the fused stages' C = 128 and 64, so no
//     column of a product is wasted); C = 512 takes two column passes. TR
//     is 8 (64-row tiles at BN = 256, 128 at 128) but 4 at BN = 64 (128
//     rows, not 256: the halo's and the single blocks' discarded rows),
//     as tools/torch_f32_variants.py measured on an H100
//     (kernels/resstack.py::F32_TILES holds the same table).
//   - K runs over (tap, 16 channels), so a K step never straddles a tap and
//     its A rows sit at one row offset. The weights, and for the rows in
//     global memory (shift's x, the upsample's a) the A tile, come by
//     cp.async into a ring of STAGES steps; rows outside the signal or the
//     window and channels past the width arrive as zeros (src-size 0).
//   - A rows already in shared memory (h; a chain's slab) are not copied
//     from global memory. h is read in place at its tap offset. conv1's
//     LeakyReLU is applied once per staged element: to x by the thread that
//     copied it, after its own copy landed and before the barrier that
//     publishes the step; to the slab as its rows are copied into the step.
//     The upsample's rows take slope 1: the identity.
//   - h and the slab are rows of the width rounded up to 16 plus 4 floats
//     (padding columns of h zero); widths that are no multiple of 4 take
//     4-byte copies and scalar epilogues.
//   - one thread block an SM (h of 64 rows at C = 512 is 129 KB; a chain's
//     slab and h fill most of the rest), so registers are not capped for a
//     second.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BK = 16;       // K of a step: 16 channels of one tap
constexpr int STAGES = 3;    // steps in flight in the cp.async ring
constexpr int LDA = BK + 4;  // staged A rows 80 bytes apart: a warp's four
                             // rows on other banks
constexpr int MAX_BLOCKS = 8;
constexpr int SMEM_LIMIT = 232448;

// rows a thread holds in a product of BN columns (F32_TILES)
__host__ __device__ constexpr int tile_rows(int bn) {
  return bn == 64 ? 4 : 8;
}

// The product's tile: 256 threads, BN / 8 of them across the columns (WN
// warps of 8), TY = 2048 / BN down the rows, TR rows each.
template <int BN_>
struct Tile {
  static constexpr int BN = BN_;
  static constexpr int TR = tile_rows(BN);
  static constexpr int WN = BN / 64;
  static constexpr int TY = 2048 / BN;
  static constexpr int BM = TR * TY;
  static constexpr int A_FLOATS = BM * LDA;
  static constexpr int B_FLOATS = BK * BN;
  static constexpr int RING_FLOATS = STAGES * (A_FLOATS + B_FLOATS);
  static_assert(BN == 64 || BN == 128 || BN == 256, "64, 128 or 256 columns");
  static_assert(BM % 64 == 0, "whole A vectors a thread");
};

// the product width for `ch` channels
int tile_cols(int ch) { return ch <= 64 ? 64 : ch <= 128 ? 128 : 256; }

// floats between rows of h and of the slab: the width rounded up to a K
// step plus 4, so that a warp's four consecutive rows fall on other banks
__host__ __device__ constexpr int row_ld(int ch) {
  return (ch + BK - 1) / BK * BK + 4;
}

__device__ __forceinline__ float lrelu(float v, float s) {
  return v > 0.f ? v : s * v;
}

__device__ __forceinline__ float4 lrelu4(float4 v, float s) {
  return make_float4(lrelu(v.x, s), lrelu(v.y, s), lrelu(v.z, s),
                     lrelu(v.w, s));
}

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b < 0) ? q - 1 : q;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `BYTES` (4 or 16) from global to shared memory, zeros when !valid
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// the first `cnt` (at least 1) of four consecutive floats; VEC: all four,
// 16-byte aligned
template <bool VEC>
__device__ __forceinline__ void load4(const float* p, int cnt,
                                      float (&v)[4]) {
  if constexpr (VEC) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = j < cnt ? p[j] : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(float* p, int cnt,
                                       const float (&v)[4]) {
  if constexpr (VEC) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < cnt) p[j] = v[j];
  }
}

// Where a tap product's A rows come from. Tile row r of tap j is source row
// row0 + r + j * step, `ld` floats apart.
//   A_GLOBAL  rows in global memory (x, or the upsample's a); rows outside
//             [lo, hi) read as zero; LeakyReLU'd as staged
//   A_SLAB    a chain's slab in shared memory; rows outside [lo, hi) read
//             as zero; LeakyReLU'd as staged
//   A_DIRECT  h in shared memory, read in place, its padding columns zero;
//             rows past hi (read only for tile rows that are not outputs)
//             read row hi - 1
enum AMode { A_GLOBAL, A_SLAB, A_DIRECT };

struct ASrc {
  const float* base;
  int ld;
  int row0, step;
  int lo, hi;
};

// The weights of a product: tap j's K rows start at tap[j], `ld` floats
// apart (a block's [3*C, C], one phase's two taps of the upsample's
// [2s, Cin, C]).
struct BSrc {
  const float* tap[3];
  int ld;
};

__device__ __forceinline__ BSrc conv_taps(const float* w, int ch) {
  const long long m = static_cast<long long>(ch) * ch;
  return BSrc{{w, w + m, w + 2 * m}, ch};
}

__device__ __forceinline__ void zero_pad_columns(float* buf, int rows,
                                                 int ch) {
  const int ld = row_ld(ch), pad = ld - 4 - ch;
  for (int e = threadIdx.x; e < rows * pad; e += THREADS)
    buf[(e / pad) * ld + ch + e % pad] = 0.f;
}

// out[r, n] = sum_j sum_k A_j[r, k] * B_j[k, n] over ntaps taps of K rows
// for the BM x BN tile at columns n0, then epi(r, n, v, cnt) with v the
// results of row r at columns n .. n + 3, of which the first cnt are below
// ncols. Starts with a barrier: what the previous product's epilogue wrote
// is visible, and nobody reads the ring any more.
template <class Tl, int MODE, bool VEC, typename Epi>
__device__ __forceinline__ void product(float* ring, const ASrc a,
                                        const BSrc b, int K, int ntaps,
                                        int n0, int ncols, float slope,
                                        Epi epi) {
  constexpr int BM = Tl::BM, BN = Tl::BN, TR = Tl::TR, TY = Tl::TY;
  constexpr int A_FLOATS = Tl::A_FLOATS, B_FLOATS = Tl::B_FLOATS;
  constexpr int AV = BM / 64;                 // A vectors a thread stages
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ty = (warp / Tl::WN) * 4 + lane / 8;  // rows ty + TY*i
  const int tx = (warp % Tl::WN) * 8 + lane % 8;  // columns 4tx, BN/2 + 4tx
  const int kc = (K + BK - 1) / BK;           // K steps of a tap
  const int steps = ntaps * kc;
  float* s_a = ring;                          // [STAGES][BM][LDA]
  float* s_b = ring + STAGES * A_FLOATS;      // [STAGES][BK][BN]
  // the A vectors this thread stages: rows ar + 64u, channels ac .. ac + 3
  const int ar = tid / 4, ac = (tid % 4) * 4;

  auto load = [&](int it) {
    const int s = it % STAGES, tap = it / kc, c0 = (it - tap * kc) * BK;
    // a select, not an index: b stays in registers
    const float* wt = tap == 0 ? b.tap[0] : tap == 1 ? b.tap[1] : b.tap[2];
    float* db = s_b + s * B_FLOATS;
    if constexpr (VEC) {
#pragma unroll
      for (int u = 0; u < B_FLOATS / 4 / THREADS; ++u) {
        const int e = tid + u * THREADS;
        const int k = e / (BN / 4), c = (e % (BN / 4)) * 4;
        const bool ok = c0 + k < K && n0 + c < ncols;
        cp_async<16>(db + k * BN + c,
                     ok ? wt + static_cast<long long>(c0 + k) * b.ld + n0 + c
                        : wt,
                     ok);
      }
    } else {
#pragma unroll 4
      for (int u = 0; u < B_FLOATS / THREADS; ++u) {
        const int e = tid + u * THREADS;
        const int k = e / BN, c = e % BN;
        const bool ok = c0 + k < K && n0 + c < ncols;
        cp_async<4>(db + k * BN + c,
                    ok ? wt + static_cast<long long>(c0 + k) * b.ld + n0 + c
                       : wt,
                    ok);
      }
    }
    if constexpr (MODE == A_GLOBAL) {
#pragma unroll
      for (int u = 0; u < AV; ++u) {
        const int r = ar + 64 * u;
        const int p = a.row0 + r + tap * a.step;
        const bool row_ok = p >= a.lo && p < a.hi;
        const long long at = static_cast<long long>(row_ok ? p : 0) * a.ld +
                             c0 + ac;
        float* da = s_a + s * A_FLOATS + r * LDA + ac;
        if constexpr (VEC) {
          const bool ok = row_ok && c0 + ac < K;
          cp_async<16>(da, ok ? a.base + at : a.base, ok);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool ok = row_ok && c0 + ac + j < K;
            cp_async<4>(da + j, ok ? a.base + at + j : a.base, ok);
          }
        }
      }
    }
  };

  float acc[TR][8];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  __syncthreads();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s);
    cp_commit();
  }
  for (int tap = 0, it = 0; tap < ntaps; ++tap) {
    // where this thread's TR A rows of the tap start
    int a_off[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      if constexpr (MODE == A_DIRECT) {
        const int row = a.row0 + ty + TY * i + tap * a.step;
        a_off[i] = (row < a.hi ? row : a.hi - 1) * a.ld;
      } else {
        a_off[i] = (ty + TY * i) * LDA;
      }
    }
    for (int c0 = 0; c0 < kc * BK; c0 += BK, ++it) {
      const int s = it % STAGES;
      // this thread's copies of step it have landed; the stage it
      // overwrites below was last read in step it - STAGES, before the
      // barrier of step it - STAGES + 1
      cp_wait<STAGES - 2>();
#pragma unroll
      for (int u = 0; u < AV; ++u) {
        const int r = ar + 64 * u;
        float4* da =
            reinterpret_cast<float4*>(s_a + s * A_FLOATS + r * LDA + ac);
        if constexpr (MODE == A_GLOBAL) {
          *da = lrelu4(*da, slope);
        } else if constexpr (MODE == A_SLAB) {
          const int p = a.row0 + r + tap * a.step;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (p >= a.lo && p < a.hi && c0 + ac < K) {
            v = *reinterpret_cast<const float4*>(a.base + p * a.ld + c0 +
                                                 ac);
            if constexpr (!VEC) {
              if (c0 + ac + 1 >= K) v.y = 0.f;
              if (c0 + ac + 2 >= K) v.z = 0.f;
              if (c0 + ac + 3 >= K) v.w = 0.f;
            }
          }
          *da = lrelu4(v, slope);
        }
      }
      __syncthreads();
      if (it + STAGES - 1 < steps) load(it + STAGES - 1);
      cp_commit();

      const float* pa = MODE == A_DIRECT ? a.base + c0 : s_a + s * A_FLOATS;
      const float* pb = s_b + s * B_FLOATS + 4 * tx;
#pragma unroll
      for (int k4 = 0; k4 < BK; k4 += 4) {
        float4 av[TR];
#pragma unroll
        for (int i = 0; i < TR; ++i)
          av[i] = *reinterpret_cast<const float4*>(pa + a_off[i] + k4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 q0 =
              *reinterpret_cast<const float4*>(pb + (k4 + kk) * BN);
          const float4 q1 =
              *reinterpret_cast<const float4*>(pb + (k4 + kk) * BN + BN / 2);
          const float bv[8] = {q0.x, q0.y, q0.z, q0.w,
                               q1.x, q1.y, q1.z, q1.w};
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            const float xv = kk == 0 ? av[i].x
                             : kk == 1 ? av[i].y
                             : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(xv, bv[j], acc[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int n = n0 + g * (BN / 2) + 4 * tx;
      if (n < ncols) {
        float v[4] = {acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                      acc[i][4 * g + 3]};
        epi(ty + TY * i, n, v, ncols - n);
      }
    }
}

// ---------------------------------------------------------------- shift

// One block at any dilation. Thread block (bx, b) computes output rows
// [t0, t0 + BM - 2) of batch row b from h rows [t0 - 1, t0 + BM - 1).
template <int BN, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
shift_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ w2,
                 const float* __restrict__ b2, float* __restrict__ y,
                 int t_len, int ch, int d, float slope, float final_slope,
                 int has_final, int lo, int hi) {
  using Tl = Tile<BN>;
  constexpr int BM = Tl::BM;
  extern __shared__ __align__(16) float smem[];
  const int ld = row_ld(ch);
  float* hbuf = smem + Tl::RING_FLOATS;  // [BM][ld]
  const int t0 = blockIdx.x * (BM - 2);
  const long long boff = static_cast<long long>(blockIdx.y) * t_len * ch;
  const float* xb = x + boff;
  float* yb = y + boff;
  zero_pad_columns(hbuf, BM, ch);

  const ASrc taps{xb, ch, t0 - 1 - d, d, lo, hi};
  for (int n0 = 0; n0 < ch; n0 += BN)
    product<Tl, A_GLOBAL, VEC>(
        smem, taps, conv_taps(w1, ch), ch, 3, n0, ch, slope,
        [&](int r, int n, float (&v)[4], int cnt) {
          const int pos = t0 - 1 + r;
          const bool inside = pos >= lo && pos < hi;
          float b[4];
          load4<VEC>(b1 + n, cnt, b);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            v[u] = inside ? lrelu(v[u] + b[u], slope) : 0.f;
          store4<VEC>(hbuf + r * ld + n, cnt, v);
        });
  const ASrc hrows{hbuf, ld, 0, 1, 0, BM};
  for (int n0 = 0; n0 < ch; n0 += BN)
    product<Tl, A_DIRECT, VEC>(
        smem, hrows, conv_taps(w2, ch), ch, 3, n0, ch, slope,
        [&](int r, int n, float (&v)[4], int cnt) {
          const int pos = t0 + r;
          if (r >= BM - 2 || pos >= t_len) return;
          const long long at = static_cast<long long>(pos) * ch + n;
          float b[4], res[4];
          load4<VEC>(b2 + n, cnt, b);
          load4<VEC>(xb + at, cnt, res);
          const bool inside = pos >= lo && pos < hi;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            v[u] = inside ? v[u] + b[u] + res[u] : 0.f;
            if (has_final) v[u] = lrelu(v[u], final_slope);
          }
          store4<VEC>(yb + at, cnt, v);
        });
}

// ---------------------------------------------------------------- chain

struct ChainArgs {
  const float* x;   // [batch, t_len, ch]; with UP a = x + sin(x),
                    // [batch, t_in, cin]
  const float* w1;  // [n, 3*ch, ch]
  const float* b1;  // [n, ch]
  const float* w2;
  const float* b2;
  float* y;         // [batch, t_len, ch]
  int t_len, ch, n;
  int dils[MAX_BLOCKS];
  int ext[MAX_BLOCKS + 1];  // ext[i] = sum over k >= i of (dils[k] + 1)
  int tm;                   // output rows per thread block
  float slope, final_slope;
  int has_final;
  int lo, hi;               // the signal window, clamped to [0, t_len]
  // UP only: the transposed convolution's weights [2*scale, cin, ch] in
  // torch tap order, read in place, and its bias [ch]
  const float* w_up;
  const float* b_up;
  int t_in, cin, scale;
};

template <int BN, bool VEC, bool UP>
__global__ void __launch_bounds__(THREADS, 1)
chain_f32_kernel(const ChainArgs p) {
  using Tl = Tile<BN>;
  constexpr int BM = Tl::BM;
  extern __shared__ __align__(16) float smem[];
  const int ch = p.ch, tm = p.tm, t_len = p.t_len, lo = p.lo, hi = p.hi;
  const int ld = row_ld(ch);
  const int e0 = p.ext[0];
  const int slab_rows = tm + 2 * e0;
  float* xs = smem + Tl::RING_FLOATS;   // [slab_rows][ld]
  float* hbuf = xs + slab_rows * ld;    // [tm + 2 * ext[1] + 2][ld]
  const int t0 = blockIdx.x * tm;
  const int slab0 = t0 - e0;            // signal row of slab row 0
  float* yb = p.y + static_cast<long long>(blockIdx.y) * t_len * ch;

  if constexpr (UP) {
    // slab row srow, at pos = slab0 + srow = q*s + rho - pad, is
    // a[q] @ Wup[rho] + a[q-1] @ Wup[rho + s] + b_up: per phase rho a
    // two-tap product over the rows q of a, A rows straight from global
    // memory at offsets 0 and -1 (slope 1: no LeakyReLU)
    const int s = p.scale, cin = p.cin, pad = s / 2 + s % 2;
    const int q_lo = floor_div(slab0 + pad, s);
    const int nq = floor_div(slab0 + slab_rows - 1 + pad, s) - q_lo + 1;
    const float* ab = p.x + static_cast<long long>(blockIdx.y) * p.t_in * cin;
    const long long m = static_cast<long long>(cin) * ch;
    for (int m0 = 0; m0 < nq; m0 += BM) {
      const ASrc src{ab, cin, q_lo + m0, -1, 0, p.t_in};
      for (int rho = 0; rho < s; ++rho) {
        const BSrc wb{{p.w_up + rho * m, p.w_up + (rho + s) * m, p.w_up},
                      ch};
        for (int n0 = 0; n0 < ch; n0 += BN)
          product<Tl, A_GLOBAL, VEC>(
              smem, src, wb, cin, 2, n0, ch, 1.f,
              [&](int r, int n, float (&v)[4], int cnt) {
                const int pos = (q_lo + m0 + r) * s + rho - pad;
                const int srow = pos - slab0;
                if (m0 + r >= nq || srow < 0 || srow >= slab_rows) return;
                const bool inside = pos >= lo && pos < hi;
                float b[4];
                load4<VEC>(p.b_up + n, cnt, b);
#pragma unroll
                for (int u = 0; u < 4; ++u) v[u] = inside ? v[u] + b[u] : 0.f;
                store4<VEC>(xs + srow * ld + n, cnt, v);
              });
      }
    }
  } else {
    const float* xb = p.x + static_cast<long long>(blockIdx.y) * t_len * ch;
    const int vecs = VEC ? ch / 4 : ch;
    for (int e = threadIdx.x; e < slab_rows * vecs; e += THREADS) {
      const int r = e / vecs, pos = slab0 + r;
      const bool ok = pos >= lo && pos < hi;
      if constexpr (VEC) {
        const int c = (e - r * vecs) * 4;
        *reinterpret_cast<float4*>(xs + r * ld + c) =
            ok ? *reinterpret_cast<const float4*>(
                     xb + static_cast<long long>(pos) * ch + c)
               : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        const int c = e - r * vecs;
        xs[r * ld + c] = ok ? xb[static_cast<long long>(pos) * ch + c] : 0.f;
      }
    }
  }
  zero_pad_columns(hbuf, tm + 2 * p.ext[1] + 2, ch);

  for (int i = 0; i < p.n; ++i) {
    const int d = p.dils[i], eo = p.ext[i + 1];
    const long long wo = static_cast<long long>(i) * 3 * ch * ch;
    const float* b1 = p.b1 + i * ch;
    const float* b2 = p.b2 + i * ch;
    const float slope = p.slope;
    // h over signal rows [t0 - eo - 1, t0 + tm + eo + 1)
    const int h_rows = tm + 2 * eo + 2;
    const int h_pos0 = t0 - eo - 1;
    for (int m0 = 0; m0 < h_rows; m0 += BM) {
      const ASrc taps{xs, ld, e0 - eo - 1 + m0 - d, d, 0, slab_rows};
      for (int n0 = 0; n0 < ch; n0 += BN)
        product<Tl, A_SLAB, VEC>(
            smem, taps, conv_taps(p.w1 + wo, ch), ch, 3, n0, ch, slope,
            [&](int r, int n, float (&v)[4], int cnt) {
              const int hr = m0 + r;
              if (hr >= h_rows) return;
              const int pos = h_pos0 + hr;
              const bool inside = pos >= lo && pos < hi;
              float b[4];
              load4<VEC>(b1 + n, cnt, b);
#pragma unroll
              for (int u = 0; u < 4; ++u)
                v[u] = inside ? lrelu(v[u] + b[u], slope) : 0.f;
              store4<VEC>(hbuf + hr * ld + n, cnt, v);
            });
    }
    // y over signal rows [t0 - eo, t0 + tm + eo): h row yr + 1 is its centre
    const int y_rows = tm + 2 * eo;
    const bool last = i + 1 == p.n;
    for (int m0 = 0; m0 < y_rows; m0 += BM) {
      const ASrc hrows{hbuf, ld, m0, 1, 0, h_rows};
      for (int n0 = 0; n0 < ch; n0 += BN)
        product<Tl, A_DIRECT, VEC>(
            smem, hrows, conv_taps(p.w2 + wo, ch), ch, 3, n0, ch, slope,
            [&](int r, int n, float (&v)[4], int cnt) {
              const int yr = m0 + r;
              if (yr >= y_rows) return;
              const int pos = t0 - eo + yr;
              float* xrow = xs + (e0 - eo + yr) * ld + n;
              float b[4], res[4];
              load4<VEC>(b2 + n, cnt, b);
              load4<VEC>(xrow, cnt, res);
              const bool inside = pos >= lo && pos < hi;
              // the next block pads its input with zeros too, and rows of
              // the array outside the window are written as zeros
#pragma unroll
              for (int u = 0; u < 4; ++u)
                v[u] = inside ? v[u] + b[u] + res[u] : 0.f;
              if (!last) {
                store4<VEC>(xrow, cnt, v);
              } else if (pos >= 0 && pos < t_len) {
                if (p.has_final) {
#pragma unroll
                  for (int u = 0; u < 4; ++u)
                    v[u] = lrelu(v[u], p.final_slope);
                }
                store4<VEC>(yb + static_cast<long long>(pos) * ch + n, cnt,
                            v);
              }
            });
    }
  }
}

bool aligned16(const void* q) {
  return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
}

template <typename K, typename... Args>
cudaError_t launch(K kernel, dim3 grid, size_t smem, cudaStream_t stream,
                   Args... args) {
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

// Fills the chain's arguments; false for arguments it does not take.
bool chain_args(ChainArgs& p, const void* x, const void* w1, const void* b1,
                const void* w2, const void* b2, void* y, int batch, int t_len,
                int ch, int n, const int* dils, int tm, float slope,
                float final_slope, int has_final, int lo, int hi) {
  if (batch < 1 || t_len < 1 || ch < 1 || n < 1 || n > MAX_BLOCKS || tm < 1)
    return false;
  p.x = static_cast<const float*>(x);
  p.w1 = static_cast<const float*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const float*>(w2);
  p.b2 = static_cast<const float*>(b2);
  p.y = static_cast<float*>(y);
  p.t_len = t_len;
  p.ch = ch;
  p.n = n;
  p.ext[n] = 0;
  for (int i = n - 1; i >= 0; --i) {
    if (dils[i] < 1) return false;
    p.dils[i] = dils[i];
    p.ext[i] = p.ext[i + 1] + dils[i] + 1;
  }
  p.tm = tm;
  p.slope = slope;
  p.final_slope = final_slope;
  p.has_final = has_final;
  p.lo = lo < 0 ? 0 : lo;
  p.hi = hi > t_len ? t_len : hi;
  return true;
}

// Launches chain_f32_kernel at the product width of p.ch. `vec`: every
// width a multiple of 4 and every pointer 16-byte aligned.
template <bool UP>
cudaError_t launch_chain(const ChainArgs& p, int batch, bool vec,
                         cudaStream_t s) {
  const int bn = tile_cols(p.ch);
  const int ring = bn == 64    ? Tile<64>::RING_FLOATS
                   : bn == 128 ? Tile<128>::RING_FLOATS
                               : Tile<256>::RING_FLOATS;
  const long long rows =
      2LL * p.tm + 2LL * p.ext[0] + 2LL * p.ext[1] + 2;
  const size_t smem = sizeof(float) * (ring + rows * row_ld(p.ch));
  const dim3 grid((p.t_len + p.tm - 1) / p.tm, batch);
  auto go = [&](auto kernel) { return launch(kernel, grid, smem, s, p); };
  if (bn == 64)
    return vec ? go(chain_f32_kernel<64, true, UP>)
               : go(chain_f32_kernel<64, false, UP>);
  if (bn == 128)
    return vec ? go(chain_f32_kernel<128, true, UP>)
               : go(chain_f32_kernel<128, false, UP>);
  if constexpr (UP) {
    return cudaErrorInvalidValue;  // the fused stages are at most 128 wide
  } else {
    return vec ? go(chain_f32_kernel<256, true, false>)
               : go(chain_f32_kernel<256, false, false>);
  }
}

}  // namespace

// x, y: [batch, t_len, ch] float32; w1, w2: [n, 3*ch, ch] (block, tap*in,
// out); b1, b2: [n, ch]; dils: n host ints; tm: output rows per thread
// block. y must not alias x. [lo, hi) is the signal window in rows (0, t_len
// for the whole array): rows outside it are zero padding at every block, and
// are written as zeros. Returns cudaErrorInvalidValue for arguments it does
// not take, a tile whose slab and h do not fit shared memory included.
extern "C" int vf_res_chain_f32(const void* x, const void* w1,
                                const void* b1, const void* w2,
                                const void* b2, void* y, int batch,
                                int t_len, int ch, int n, const int* dils,
                                int tm, float slope, float final_slope,
                                int has_final, int lo, int hi,
                                void* stream) {
  ChainArgs p{};
  if (!chain_args(p, x, w1, b1, w2, b2, y, batch, t_len, ch, n, dils, tm,
                  slope, final_slope, has_final, lo, hi))
    return cudaErrorInvalidValue;
  const bool vec = ch % 4 == 0 && aligned16(x) && aligned16(w1) &&
                   aligned16(b1) && aligned16(w2) && aligned16(b2) &&
                   aligned16(y);
  return launch_chain<false>(p, batch, vec,
                             static_cast<cudaStream_t>(stream));
}

// The first group of up_res_stream: a = x + sin(x) (x_src [batch, t_in,
// cin] into the scratch a of the same shape), then the chain of n blocks
// on the upsampled signal, produced tile by tile in shared memory. w_up:
// [2*scale, cin, ch] in torch tap order; b_up: [ch]; y: [batch,
// t_in*scale, ch]; the rest as for vf_res_chain_f32, with no window.
// ch <= 128.
extern "C" int vf_up_chain_f32(const void* x_src, void* a, const void* w_up,
                               const void* b_up, const void* w1,
                               const void* b1, const void* w2, const void* b2,
                               void* y, int batch, int t_in, int cin, int ch,
                               int scale, int n, const int* dils, int tm,
                               float slope, float final_slope, int has_final,
                               void* stream) {
  if (t_in < 1 || cin < 1 || scale < 1 || ch > 128)
    return cudaErrorInvalidValue;
  const long long t_len = static_cast<long long>(t_in) * scale;
  if (t_len * ch >= 0x7fffffffLL) return cudaErrorInvalidValue;
  ChainArgs p{};
  if (!chain_args(p, a, w1, b1, w2, b2, y, batch, static_cast<int>(t_len),
                  ch, n, dils, tm, slope, final_slope, has_final, 0,
                  static_cast<int>(t_len)))
    return cudaErrorInvalidValue;
  p.w_up = static_cast<const float*>(w_up);
  p.b_up = static_cast<const float*>(b_up);
  p.t_in = t_in;
  p.cin = cin;
  p.scale = scale;
  auto s = static_cast<cudaStream_t>(stream);
  vf::launch_sin_residual(static_cast<const float*>(x_src),
                          static_cast<float*>(a),
                          static_cast<long long>(batch) * t_in * cin, s);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const bool vec = ch % 4 == 0 && cin % 4 == 0 && aligned16(a) &&
                   aligned16(w_up) && aligned16(b_up) && aligned16(w1) &&
                   aligned16(b1) && aligned16(w2) && aligned16(b2) &&
                   aligned16(y);
  return launch_chain<true>(p, batch, vec, s);
}

// One block at dilation d. x, y: [batch, t_len, ch] float32; w1, w2:
// [3*ch, ch]; b1, b2: [ch]. y must not alias x. [lo, hi) as for
// vf_res_chain_f32.
extern "C" int vf_res_shift_single_f32(const void* x, const void* w1,
                                       const void* b1, const void* w2,
                                       const void* b2, void* y, int batch,
                                       int t_len, int ch, int d, float slope,
                                       float final_slope, int has_final,
                                       int lo, int hi, void* stream) {
  if (batch < 1 || t_len < 1 || ch < 1 || d < 1) return cudaErrorInvalidValue;
  lo = lo < 0 ? 0 : lo;
  hi = hi > t_len ? t_len : hi;
  const bool vec = ch % 4 == 0 && aligned16(x) && aligned16(w1) &&
                   aligned16(b1) && aligned16(w2) && aligned16(b2) &&
                   aligned16(y);
  const float* xf = static_cast<const float*>(x);
  const float* w1f = static_cast<const float*>(w1);
  const float* b1f = static_cast<const float*>(b1);
  const float* w2f = static_cast<const float*>(w2);
  const float* b2f = static_cast<const float*>(b2);
  float* yf = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kernel, auto tile) {
    using Tl = decltype(tile);
    const dim3 grid((t_len + Tl::BM - 3) / (Tl::BM - 2), batch);
    const size_t smem = sizeof(float) *
        (Tl::RING_FLOATS + static_cast<size_t>(Tl::BM) * row_ld(ch));
    return launch(kernel, grid, smem, s, xf, w1f, b1f, w2f, b2f, yf, t_len,
                  ch, d, slope, final_slope, has_final, lo, hi);
  };
  switch (tile_cols(ch)) {
    case 64:
      return vec ? go(shift_f32_kernel<64, true>, Tile<64>{})
                 : go(shift_f32_kernel<64, false>, Tile<64>{});
    case 128:
      return vec ? go(shift_f32_kernel<128, true>, Tile<128>{})
                 : go(shift_f32_kernel<128, false>, Tile<128>{});
    default:
      return vec ? go(shift_f32_kernel<256, true>, Tile<256>{})
                 : go(shift_f32_kernel<256, false>, Tile<256>{});
  }
}
