// K2 res_chain and K3 res_shift_single in float32, on Hopper's FMA units:
// vf_res_chain_f32 and vf_res_shift_single_f32.
//
// Replace voicefixer_tpu/kernels/resstack.py::res_chain (:293) and
// ::res_shift_single (:464) (Pallas, TPU) for float32. They compute what
// chain_kernel<float, BN, false> and shift_kernel<float, BN> of resblock.cuh
// compute (the fused stages, resstream.cu, keep those):
//   shift: h = lrelu(sum_j lrelu(x[t + (j-1)d]) @ W1[j] + b1), 0 outside
//          the window [lo, hi), over the tile's rows and one a side; then
//          y = sum_j h[t + j - 1] @ W2[j] + b2 + x, 0 outside the window,
//          with the optional final LeakyReLU. h never leaves shared memory.
//   chain: n such blocks on a time tile plus a halo of E[0] = sum(d_i + 1)
//          rows a side (the slab), kept in shared memory with the widest
//          block's h: block i is computed over the tile widened by E[i+1]
//          rows a side (halo recompute) and written over the slab in place;
//          the last block writes only the tile.
//
// Bound: operations (12*C^2 FLOP per row per block against 8*C bytes). Parity
// mode is true float32: FMA units, no TF32. Design, for an SM's 128 FMA lanes:
//   - one tap product (product()) of a 64 x 256 tile: 256 threads, 8 x 8
//     outputs a thread (rows ty + 8i, columns 4tx + j and 128 + 4tx + j),
//     16-byte shared reads of both operands, 16 reads per 256 FMAs; a warp's
//     A reads (four rows, on other banks) and B reads (128 contiguous bytes)
//     take one wavefront each. C = 256 is one column pass, C = 512 two.
//   - K runs over (tap, 16 channels), so a K step never straddles a tap and
//     its A rows sit at one row offset. The weights, and for shift's conv1
//     the rows of x at their tap offsets, come by cp.async into a ring of
//     STAGES steps; rows outside the signal or the window and channels past
//     C arrive as zeros (src-size 0).
//   - A rows already in shared memory (h; a chain's slab) are not copied
//     from global memory. h is read in place at its tap offset. conv1's
//     LeakyReLU is applied once per staged element: to x by the thread that
//     copied it, after its own copy landed and before the barrier that
//     publishes the step; to the slab as its rows are copied into the step.
//   - h and the slab are rows of the width rounded up to 16 plus 4 floats
//     (padding columns of h zero); C that is no multiple of 4 takes 4-byte
//     copies and scalar epilogues.
//   - one thread block an SM (h of 64 rows at C = 512 is 129 KB; the chain's
//     slab and h at C = 256 132 KB), so registers are not capped for a second.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BM = 64;       // rows of a product tile
constexpr int BN = 256;      // columns of a product tile: one column pass
constexpr int BK = 16;       // K of a step: 16 channels of one tap
constexpr int STAGES = 3;    // steps in flight in the cp.async ring
constexpr int LDA = BK + 4;  // staged A rows 80 bytes apart: a warp's four
                             // rows on other banks
constexpr int A_FLOATS = BM * LDA;
constexpr int B_FLOATS = BK * BN;
constexpr int RING_FLOATS = STAGES * (A_FLOATS + B_FLOATS);
constexpr int MAX_BLOCKS = 8;
constexpr int SMEM_LIMIT = 232448;

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

// Where a tap product's A rows come from. Tile row r of tap j (0, 1, 2) is
// source row row0 + r + (j - 1) * step, `ld` floats apart.
//   A_GLOBAL  x in global memory; rows outside [lo, hi) read as zero;
//             LeakyReLU'd as staged
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

__device__ __forceinline__ void zero_pad_columns(float* buf, int rows,
                                                 int ch) {
  const int ld = row_ld(ch), pad = ld - 4 - ch;
  for (int e = threadIdx.x; e < rows * pad; e += THREADS)
    buf[(e / pad) * ld + ch + e % pad] = 0.f;
}

// out[r, n] = sum_j sum_c A_j[r, c] * w[j*ch + c, n] for the 64 x 256 tile
// at columns n0, then epi(r, n, v, cnt) with v the results of row r at
// columns n .. n + 3, of which the first cnt are columns of the output.
// w: [3*ch, ch]. Starts with a barrier: what the previous product's
// epilogue wrote is visible, and nobody reads the ring any more.
template <int MODE, bool VEC, typename Epi>
__device__ __forceinline__ void product(float* ring, const ASrc a,
                                        const float* __restrict__ w, int ch,
                                        int n0, float slope, Epi epi) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ty = (warp / 4) * 4 + lane / 8;   // rows ty + 8i
  const int tx = (warp % 4) * 8 + lane % 8;   // columns 4tx, 128 + 4tx
  const int kc = (ch + BK - 1) / BK;          // K steps of a tap
  const int steps = 3 * kc;
  float* s_a = ring;                          // [STAGES][BM][LDA]
  float* s_b = ring + STAGES * A_FLOATS;      // [STAGES][BK][BN]
  // the A vector this thread stages: row ar, channels ac .. ac + 3
  const int ar = tid / 4, ac = (tid % 4) * 4;

  auto load = [&](int it) {
    const int s = it % STAGES, tap = it / kc, c0 = (it - tap * kc) * BK;
    const float* wt = w + static_cast<long long>(tap) * ch * ch;
    float* db = s_b + s * B_FLOATS;
    if constexpr (VEC) {
#pragma unroll
      for (int u = 0; u < B_FLOATS / 4 / THREADS; ++u) {
        const int e = tid + u * THREADS;
        const int k = e / (BN / 4), c = (e % (BN / 4)) * 4;
        const bool ok = c0 + k < ch && n0 + c < ch;
        cp_async<16>(db + k * BN + c,
                     ok ? wt + static_cast<long long>(c0 + k) * ch + n0 + c
                        : w,
                     ok);
      }
    } else {
#pragma unroll 4
      for (int u = 0; u < B_FLOATS / THREADS; ++u) {
        const int e = tid + u * THREADS;
        const int k = e / BN, c = e % BN;
        const bool ok = c0 + k < ch && n0 + c < ch;
        cp_async<4>(db + k * BN + c,
                    ok ? wt + static_cast<long long>(c0 + k) * ch + n0 + c
                       : w,
                    ok);
      }
    }
    if constexpr (MODE == A_GLOBAL) {
      const int p = a.row0 + ar + (tap - 1) * a.step;
      const bool row_ok = p >= a.lo && p < a.hi;
      const long long at = static_cast<long long>(row_ok ? p : 0) * a.ld +
                           c0 + ac;
      float* da = s_a + s * A_FLOATS + ar * LDA + ac;
      if constexpr (VEC) {
        const bool ok = row_ok && c0 + ac < ch;
        cp_async<16>(da, ok ? a.base + at : a.base, ok);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = row_ok && c0 + ac + j < ch;
          cp_async<4>(da + j, ok ? a.base + at + j : a.base, ok);
        }
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  __syncthreads();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s);
    cp_commit();
  }
  for (int tap = 0, it = 0; tap < 3; ++tap) {
    // where this thread's eight A rows of the tap start
    int a_off[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if constexpr (MODE == A_DIRECT) {
        const int row = a.row0 + ty + 8 * i + (tap - 1) * a.step;
        a_off[i] = (row < a.hi ? row : a.hi - 1) * a.ld;
      } else {
        a_off[i] = (ty + 8 * i) * LDA;
      }
    }
    for (int c0 = 0; c0 < kc * BK; c0 += BK, ++it) {
      const int s = it % STAGES;
      // this thread's copies of step it have landed; the stage it
      // overwrites below was last read in step it - STAGES, before the
      // barrier of step it - STAGES + 1
      cp_wait<STAGES - 2>();
      float4* da =
          reinterpret_cast<float4*>(s_a + s * A_FLOATS + ar * LDA + ac);
      if constexpr (MODE == A_GLOBAL) {
        *da = lrelu4(*da, slope);
      } else if constexpr (MODE == A_SLAB) {
        const int p = a.row0 + ar + (tap - 1) * a.step;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (p >= a.lo && p < a.hi && c0 + ac < ch) {
          v = *reinterpret_cast<const float4*>(a.base + p * a.ld + c0 + ac);
          if constexpr (!VEC) {
            if (c0 + ac + 1 >= ch) v.y = 0.f;
            if (c0 + ac + 2 >= ch) v.z = 0.f;
            if (c0 + ac + 3 >= ch) v.w = 0.f;
          }
        }
        *da = lrelu4(v, slope);
      }
      __syncthreads();
      if (it + STAGES - 1 < steps) load(it + STAGES - 1);
      cp_commit();

      const float* pa = MODE == A_DIRECT ? a.base + c0 : s_a + s * A_FLOATS;
      const float* pb = s_b + s * B_FLOATS + 4 * tx;
#pragma unroll
      for (int k4 = 0; k4 < BK; k4 += 4) {
        float4 av[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
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
          for (int i = 0; i < 8; ++i) {
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
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int n = n0 + g * (BN / 2) + 4 * tx;
      if (n < ch) {
        float v[4] = {acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                      acc[i][4 * g + 3]};
        epi(ty + 8 * i, n, v, ch - n);
      }
    }
}

// ---------------------------------------------------------------- shift

// One block at any dilation. Thread block (bx, b) computes output rows
// [t0, t0 + BM - 2) of batch row b from h rows [t0 - 1, t0 + BM - 1).
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
shift_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ w2,
                 const float* __restrict__ b2, float* __restrict__ y,
                 int t_len, int ch, int d, float slope, float final_slope,
                 int has_final, int lo, int hi) {
  extern __shared__ __align__(16) float smem[];
  const int ld = row_ld(ch);
  float* hbuf = smem + RING_FLOATS;  // [BM][ld]
  const int t0 = blockIdx.x * (BM - 2);
  const long long boff = static_cast<long long>(blockIdx.y) * t_len * ch;
  const float* xb = x + boff;
  float* yb = y + boff;
  zero_pad_columns(hbuf, BM, ch);

  const ASrc taps{xb, ch, t0 - 1, d, lo, hi};
  for (int n0 = 0; n0 < ch; n0 += BN)
    product<A_GLOBAL, VEC>(
        smem, taps, w1, ch, n0, slope,
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
  const ASrc hrows{hbuf, ld, 1, 1, 0, BM};
  for (int n0 = 0; n0 < ch; n0 += BN)
    product<A_DIRECT, VEC>(
        smem, hrows, w2, ch, n0, slope,
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
  const float* x;   // [batch, t_len, ch]
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
};

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
chain_f32_kernel(const ChainArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int ch = p.ch, tm = p.tm, t_len = p.t_len, lo = p.lo, hi = p.hi;
  const int ld = row_ld(ch);
  const int e0 = p.ext[0];
  const int slab_rows = tm + 2 * e0;
  float* xs = smem + RING_FLOATS;       // [slab_rows][ld]
  float* hbuf = xs + slab_rows * ld;    // [tm + 2 * ext[1] + 2][ld]
  const int t0 = blockIdx.x * tm;
  const int slab0 = t0 - e0;            // signal row of slab row 0
  const long long boff = static_cast<long long>(blockIdx.y) * t_len * ch;
  const float* xb = p.x + boff;
  float* yb = p.y + boff;

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
  zero_pad_columns(hbuf, tm + 2 * p.ext[1] + 2, ch);

  for (int i = 0; i < p.n; ++i) {
    const int d = p.dils[i], eo = p.ext[i + 1];
    const float* w1 = p.w1 + static_cast<long long>(i) * 3 * ch * ch;
    const float* w2 = p.w2 + static_cast<long long>(i) * 3 * ch * ch;
    const float* b1 = p.b1 + i * ch;
    const float* b2 = p.b2 + i * ch;
    const float slope = p.slope;
    // h over signal rows [t0 - eo - 1, t0 + tm + eo + 1)
    const int h_rows = tm + 2 * eo + 2;
    const int h_pos0 = t0 - eo - 1;
    for (int m0 = 0; m0 < h_rows; m0 += BM) {
      const ASrc taps{xs, ld, e0 - eo - 1 + m0, d, 0, slab_rows};
      for (int n0 = 0; n0 < ch; n0 += BN)
        product<A_SLAB, VEC>(
            smem, taps, w1, ch, n0, slope,
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
      const ASrc hrows{hbuf, ld, m0 + 1, 1, 0, h_rows};
      for (int n0 = 0; n0 < ch; n0 += BN)
        product<A_DIRECT, VEC>(
            smem, hrows, w2, ch, n0, slope,
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
  if (batch < 1 || t_len < 1 || ch < 1 || n < 1 || n > MAX_BLOCKS || tm < 1)
    return cudaErrorInvalidValue;
  ChainArgs p{};
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
    if (dils[i] < 1) return cudaErrorInvalidValue;
    p.dils[i] = dils[i];
    p.ext[i] = p.ext[i + 1] + dils[i] + 1;
  }
  p.tm = tm;
  p.slope = slope;
  p.final_slope = final_slope;
  p.has_final = has_final;
  p.lo = lo < 0 ? 0 : lo;
  p.hi = hi > t_len ? t_len : hi;
  const long long rows = 2LL * tm + 2LL * p.ext[0] + 2LL * p.ext[1] + 2;
  const size_t smem = sizeof(float) * (RING_FLOATS + rows * row_ld(ch));
  const dim3 grid((t_len + tm - 1) / tm, batch);
  const bool vec = ch % 4 == 0 && aligned16(x) && aligned16(w1) &&
                   aligned16(b1) && aligned16(w2) && aligned16(b2) &&
                   aligned16(y);
  auto s = static_cast<cudaStream_t>(stream);
  return vec ? launch(chain_f32_kernel<true>, grid, smem, s, p)
             : launch(chain_f32_kernel<false>, grid, smem, s, p);
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
  const dim3 grid((t_len + BM - 3) / (BM - 2), batch);
  const size_t smem =
      sizeof(float) * (RING_FLOATS + static_cast<size_t>(BM) * row_ld(ch));
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
  auto go = [&](auto kernel) {
    return launch(kernel, grid, smem, s, xf, w1f, b1f, w2f, b2f, yf, t_len,
                  ch, d, slope, final_slope, has_final, lo, hi);
  };
  return vec ? go(shift_f32_kernel<true>) : go(shift_f32_kernel<false>);
}
