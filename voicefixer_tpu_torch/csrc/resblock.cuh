// The vocoder's ResStack block as the first port wrote it, shared by
// csrc/resstack.cu (K3's bfloat16 single block, also K4's bfloat16 single
// blocks) and csrc/resstream.cu (K7 res_stream):
//
//   a  = lrelu(x, slope)                          float32, cast to T
//   h  = sum_j a[t + (j-1)*d] @ W1[j] + b1        j = 0..2, float32 sums
//   hb = lrelu(h, slope), 0 outside [0, T), cast to T
//   y  = sum_j hb[t + j - 1] @ W2[j] + b2 + x     float32, then cast to T
//
// with zero 'same' padding of both convolutions' inputs. A caller may narrow
// the signal to a window [lo, hi) of the rows (a time shard's own samples
// inside its halo): x reads as zero outside it, and so do hb and every
// block's y, as if the array ended there. T is float (FMA
// units, true float32) or __nv_bfloat16 (tensor cores through WMMA
// 16x16x16 fragments, float32 accumulation).
//
// Everything is one tap product (Gemm<T, BN>::run): a 64-row tile of
//   out[r, n] = sum_tap sum_c A[row0 + r + off(tap), c] * W[tap*cin + c, n]
// whose A rows come from global memory or from a slab in shared memory
// through one descriptor (RowSrc), with the LeakyReLU applied as the rows
// are staged, and whose results leave through an epilogue functor. The
// dilated conv and the undilated conv are the same routine with other
// offsets.
//
// Two kernels are built from it:
//   shift_kernel  one block; the +-d taps are read at row offsets straight
//                 from global memory (through L2), so no d-sized halo is
//                 loaded; h stays in shared memory.
//   chain_kernel  n consecutive blocks on a time tile plus a halo of
//                 E[0] = sum(d_i + 1) rows a side, kept in shared memory:
//                 block i is computed over the tile widened by E[i+1] rows
//                 a side (halo recompute), its output overwrites the slab
//                 in place, and only the tile is written.
#pragma once

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace vf {
namespace res {

constexpr int BM = 64;             // rows of a product tile
constexpr int THREADS = 256;
constexpr int STAGE_BYTES = 32768;  // staging tiles of Gemm::run
constexpr int MAX_BLOCKS = 8;       // blocks of one chain

// rows of the slab and of h are padded by 16 bytes
template <typename T>
__host__ __device__ constexpr int row_pad() {
  return 16 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v > 0.f ? v : slope * v;
}

// The A rows of a tap product: tile row r of tap j is source row
// row0 + r + off0 + j*step; rows outside [lo, rows) read as zero. Gemm::run
// takes any source with these load members (csrc/convblock.cu has two more).
template <typename T>
struct RowSrc {
  const T* base;
  long long ld;
  int rows;
  int row0;
  int off0, step;
  float slope;
  bool act;    // LeakyReLU in float32 as the row is staged
  int lo = 0;  // first row that is not zero padding

  __device__ __forceinline__ bool row_of(int r, int tap, int& p) const {
    p = row0 + r + off0 + tap * step;
    return p >= lo && p < rows;
  }

  // float32: one value
  __device__ __forceinline__ float load1(int r, int tap, int c) const {
    int p;
    if (!row_of(r, tap, p)) return 0.f;
    const float v = base[p * ld + c];
    return act ? lrelu(v, slope) : v;
  }

  // float32: four consecutive channels (16 bytes)
  __device__ __forceinline__ float4 load4(int r, int tap, int c) const {
    int p;
    if (!row_of(r, tap, p)) return make_float4(0.f, 0.f, 0.f, 0.f);
    float4 v = *reinterpret_cast<const float4*>(base + p * ld + c);
    if (act) {
      v.x = lrelu(v.x, slope);
      v.y = lrelu(v.y, slope);
      v.z = lrelu(v.z, slope);
      v.w = lrelu(v.w, slope);
    }
    return v;
  }

  // bfloat16: eight consecutive channels (16 bytes)
  __device__ __forceinline__ uint4 load8(int r, int tap, int c) const {
    int p;
    if (!row_of(r, tap, p)) return make_uint4(0, 0, 0, 0);
    uint4 v = *reinterpret_cast<const uint4*>(base + p * ld + c);
    if (act) {
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float2 f = __bfloat1622float2(h[i]);
        f.x = lrelu(f.x, slope);
        f.y = lrelu(f.y, slope);
        h[i] = __floats2bfloat162_rn(f.x, f.y);
      }
    }
    return v;
  }
};

// W values of neighbouring columns, as the epilogues take them: W = 8 for
// bfloat16 and 4 for float32 (one 16-byte vector), 1 for float32 at widths
// that are no multiple of 4.
template <typename T, int W>
__device__ __forceinline__ void load_vals(const T* p, float (&v)[W]) {
  if constexpr (W == 1) {
    v[0] = to_float(*p);
  } else if constexpr (sizeof(T) == 4) {
    static_assert(W == 4, "float32 vectors hold 4 values");
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    static_assert(W == 8, "bfloat16 vectors hold 8 values");
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  }
}

template <typename T, int W>
__device__ __forceinline__ void store_vals(T* p, const float (&v)[W]) {
  if constexpr (W == 1) {
    *p = from_float<T>(v[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
}

template <typename T, int BN>
struct Gemm;

// Both products run the same loop: the A and B vectors of the next K step
// are loaded into registers while the current step multiplies out of
// shared memory, so a step does not wait for its global loads. The tap and
// channel of a thread's A vector are stepped from one K step to the next,
// not divided out. An epilogue is called as epi(r, n, v) with v the W
// results of tile row r at columns n .. n + W - 1.

// float32 on the FMA units: a 64 x BN tile (BN = 64 or 128), K steps of 16.
// Thread (ty, tx) of 16 x 16 owns rows ty + 16*i, i < 4, and columns
// 64*g + 4*tx .. + 3, g < BN/64. Staging and epilogue take 16-byte vectors
// where the widths are multiples of 4 (vec), single floats elsewhere.
template <int BN>
struct Gemm<float, BN> {
  static constexpr int kBN = BN;
  static constexpr int BK = 16;
  static constexpr int NG = BN / 64;  // column groups of a thread
  static constexpr int LDA = BM + 2;  // conflict-free transposed stores
  static_assert(BK * LDA * 4 + BK * BN * 4 <= STAGE_BYTES,
                "staging tiles exceed STAGE_BYTES");

  // w: [ntaps*cin, ldw]; columns [n0, n0 + BN) below ncols. vec: cin, ldw,
  // ncols and the epilogue's row strides are multiples of 4.
  template <typename Src, typename Epi>
  static __device__ __forceinline__ void run(unsigned char* stage,
                                             const Src& src,
                                             const float* __restrict__ w,
                                             int ntaps, int cin, int ldw,
                                             int n0, int ncols, bool vec,
                                             Epi epi) {
    float (*s_a)[LDA] = reinterpret_cast<float (*)[LDA]>(stage);
    float (*s_b)[BN] = reinterpret_cast<float (*)[BN]>(
        stage + sizeof(float) * BK * LDA);
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const int k_total = ntaps * cin;
    // staging: this thread's four A values (row ar, K offsets ak .. ak+3)
    // and NG B vectors (K offset e / (BN/4), columns 4*(e % (BN/4)) ..)
    const int ak = (tid % 4) * 4, ar = tid / 4;
    int a_tap = ak / cin, a_c = ak % cin;  // of K index k0 + ak (vec only)
    float a_reg[4];
    float4 b_reg[NG];

    auto load_regs = [&](int k0) {
      if (vec) {
        const float4 v = a_tap < ntaps ? src.load4(ar, a_tap, a_c)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
        a_reg[0] = v.x, a_reg[1] = v.y, a_reg[2] = v.z, a_reg[3] = v.w;
        a_c += BK;
        while (a_c >= cin) a_c -= cin, ++a_tap;
      } else {
        const int k = k0 + ak;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a_reg[i] = k + i < k_total
                         ? src.load1(ar, (k + i) / cin, (k + i) % cin)
                         : 0.f;
      }
#pragma unroll
      for (int u = 0; u < NG; ++u) {
        const int e = tid + THREADS * u;
        const int kb = k0 + e / (BN / 4), n = n0 + (e % (BN / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kb < k_total) {
          const float* wr = w + static_cast<long long>(kb) * ldw;
          if (vec) {
            if (n < ncols) v = *reinterpret_cast<const float4*>(wr + n);
          } else {
            if (n < ncols) v.x = wr[n];
            if (n + 1 < ncols) v.y = wr[n + 1];
            if (n + 2 < ncols) v.z = wr[n + 2];
            if (n + 3 < ncols) v.w = wr[n + 3];
          }
        }
        b_reg[u] = v;
      }
    };

    float acc[4][NG][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][g][j] = 0.f;

    load_regs(0);
    for (int k0 = 0; k0 < k_total; k0 += BK) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s_a[ak + i][ar] = a_reg[i];
#pragma unroll
      for (int u = 0; u < NG; ++u) {
        const int e = tid + THREADS * u;
        *reinterpret_cast<float4*>(&s_b[e / (BN / 4)][(e % (BN / 4)) * 4]) =
            b_reg[u];
      }
      __syncthreads();
      if (k0 + BK < k_total) load_regs(k0 + BK);
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = s_a[kk][ty + 16 * i];
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 q =
              *reinterpret_cast<const float4*>(&s_b[kk][64 * g + 4 * tx]);
          const float b[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][g][j] = fmaf(a[i], b[j], acc[i][g][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int n = n0 + 64 * g + 4 * tx;
        if (vec) {
          if (n < ncols) epi(ty + 16 * i, n, acc[i][g]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float one[1] = {acc[i][g][j]};
            if (n + j < ncols) epi(ty + 16 * i, n + j, one);
          }
        }
      }
  }
};

// bfloat16 on the tensor cores: a 64 x BN tile (BN = 64, 128 or 256), K
// steps of 32, eight warps, each a 16 x 32, 32 x 32 or
// 64 x 32 part of it in WMMA fragments. cin, ldw and ncols are multiples
// of 8, so a 16-byte vector never straddles a tap or the end of a row.
template <int BN>
struct Gemm<__nv_bfloat16, BN> {
  using T = __nv_bfloat16;
  static constexpr int kBN = BN;
  static constexpr int BK = 32;
  static constexpr int WARPS_N = BN / 32;
  static constexpr int WARPS_M = (THREADS / 32) / WARPS_N;
  static constexpr int FM = BM / WARPS_M / 16;  // fragments down a warp
  static constexpr int NB = BN / 64;            // B vectors a thread stages
  static_assert(BM * BK / 8 == THREADS, "one A vector a thread");
  static constexpr int LDA = BK + 8, LDB = BN + 8, LDC = 20;
  static_assert(BM * LDA * 2 + BK * LDB * 2 + (THREADS / 32) * 16 * LDC * 4
                    <= STAGE_BYTES, "staging tiles exceed STAGE_BYTES");

  template <typename Src, typename Epi>
  static __device__ __forceinline__ void run(unsigned char* stage,
                                             const Src& src,
                                             const T* __restrict__ w,
                                             int ntaps, int cin, int ldw,
                                             int n0, int ncols, bool /*vec*/,
                                             Epi epi) {
    namespace wmma = nvcuda::wmma;
    T (*s_a)[LDA] = reinterpret_cast<T (*)[LDA]>(stage);
    T (*s_b)[LDB] = reinterpret_cast<T (*)[LDB]>(stage + BM * LDA * 2);
    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    float (*s_c)[LDC] = reinterpret_cast<float (*)[LDC]>(
        stage + BM * LDA * 2 + BK * LDB * 2 + warp * 16 * LDC * 4);
    const int wm = (warp / WARPS_N) * (16 * FM), wn = (warp % WARPS_N) * 32;
    const int k_total = ntaps * cin;
    const uint4 zero = make_uint4(0, 0, 0, 0);
    // staging: one A vector (row ar, K offset ak) and NB B vectors
    const int ak = (tid % (BK / 8)) * 8, ar = tid / (BK / 8);
    int a_tap = ak / cin, a_c = ak % cin;  // of K index k0 + ak
    uint4 a_reg, b_reg[NB];

    auto load_regs = [&](int k0) {
      a_reg = a_tap < ntaps ? src.load8(ar, a_tap, a_c) : zero;
      a_c += BK;
      while (a_c >= cin) a_c -= cin, ++a_tap;
#pragma unroll
      for (int u = 0; u < NB; ++u) {
        const int e = tid + THREADS * u;
        const int kb = k0 + e / (BN / 8), n = n0 + (e % (BN / 8)) * 8;
        b_reg[u] = (kb < k_total && n < ncols)
                       ? *reinterpret_cast<const uint4*>(
                             w + static_cast<long long>(kb) * ldw + n)
                       : zero;
      }
    };

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][2];
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    load_regs(0);
    for (int k0 = 0; k0 < k_total; k0 += BK) {
      *reinterpret_cast<uint4*>(&s_a[ar][ak]) = a_reg;
#pragma unroll
      for (int u = 0; u < NB; ++u) {
        const int e = tid + THREADS * u;
        *reinterpret_cast<uint4*>(&s_b[e / (BN / 8)][(e % (BN / 8)) * 8]) =
            b_reg[u];
      }
      __syncthreads();
      if (k0 + BK < k_total) load_regs(k0 + BK);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[FM];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < FM; ++i)
          wmma::load_matrix_sync(fa[i], &s_a[wm + 16 * i][kk], LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], &s_b[kk][wn + 16 * j], LDB);
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
    // each warp passes its fragments through its own 16 x 16 float tile so
    // that the epilogue knows every value's row and column; a lane takes
    // half a row of it
    const int er = lane / 2, ec = (lane % 2) * 8;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(&s_c[0][0], acc[i][j], LDC,
                                wmma::mem_row_major);
        __syncwarp();
        const int n = n0 + wn + 16 * j + ec;
        if (n < ncols) {
          const float4 q0 = *reinterpret_cast<const float4*>(&s_c[er][ec]);
          const float4 q1 =
              *reinterpret_cast<const float4*>(&s_c[er][ec + 4]);
          float v[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
          epi(wm + 16 * i + er, n, v);
        }
        __syncwarp();
      }
  }
};

// ---------------------------------------------------------------- shift

// One block at any dilation. Block (bx, b) computes output rows
// [t0, t0 + BM - 2) of batch row b from h rows [t0 - 1, t0 + BM - 1). Its
// shared memory lets two thread blocks share an SM at every width it runs
// (bfloat16 up to C = 512: 97 KB; float32 up to C = 128, K7's stacks:
// 65 KB; float32 at wider C runs resstack_f32.cu instead, one thread block
// an SM), so the registers are capped for two as well: they hide each
// other's waits at the barriers, which gains more than the few spills cost.
template <typename T, int BN>
__global__ void __launch_bounds__(THREADS, 2)
shift_kernel(const T* __restrict__ x, const T* __restrict__ w1,
             const T* __restrict__ b1, const T* __restrict__ w2,
             const T* __restrict__ b2, T* __restrict__ y, int t_len, int ch,
             int d, float slope, float final_slope, int has_final, int lo,
             int hi) {
  using G = Gemm<T, BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = ch + row_pad<T>();
  const bool vec = ch % 4 == 0;
  T* hbuf = reinterpret_cast<T*>(smem + STAGE_BYTES);  // [BM][ld]
  const int t0 = blockIdx.x * (BM - 2);
  const long long boff = static_cast<long long>(blockIdx.y) * t_len * ch;
  const T* xb = x + boff;
  T* yb = y + boff;

  const RowSrc<T> taps{xb, ch, hi, t0 - 1, -d, d, slope, true, lo};
  for (int n0 = 0; n0 < ch; n0 += G::kBN)
    G::run(smem, taps, w1, 3, ch, ch, n0, ch, vec,
           [=](int r, int n, auto& v) {
             constexpr int W = sizeof(v) / sizeof(float);
             const int pos = t0 - 1 + r;
             const bool inside = pos >= lo && pos < hi;
             float b[W];
             load_vals<T, W>(b1 + n, b);
#pragma unroll
             for (int u = 0; u < W; ++u)
               v[u] = inside ? lrelu(v[u] + b[u], slope) : 0.f;
             store_vals<T, W>(hbuf + r * ld + n, v);
           });
  __syncthreads();
  const RowSrc<T> hrows{hbuf, ld, BM, 1, -1, 1, 0.f, false};
  for (int n0 = 0; n0 < ch; n0 += G::kBN)
    G::run(smem, hrows, w2, 3, ch, ch, n0, ch, vec,
           [=](int r, int n, auto& v) {
             constexpr int W = sizeof(v) / sizeof(float);
             const int pos = t0 + r;
             if (r >= BM - 2 || pos >= t_len) return;
             const long long at = static_cast<long long>(pos) * ch + n;
             float b[W], res[W];
             load_vals<T, W>(b2 + n, b);
             load_vals<T, W>(xb + at, res);
             const bool inside = pos >= lo && pos < hi;
#pragma unroll
             for (int u = 0; u < W; ++u) {
               v[u] = inside ? v[u] + b[u] + res[u] : 0.f;
               if (has_final) v[u] = lrelu(v[u], final_slope);
             }
             store_vals<T, W>(yb + at, v);
           });
}

template <typename T>
size_t shift_smem(int ch) {
  return STAGE_BYTES +
         static_cast<size_t>(BM) * (ch + row_pad<T>()) * sizeof(T);
}

template <typename K, typename... Args>
cudaError_t launch_with_smem(K kernel, dim3 grid, size_t smem,
                             cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_shift(const T* x, const T* w1, const T* b1, const T* w2,
                         const T* b2, T* y, int batch, int t_len, int ch,
                         int d, float slope, float final_slope, int has_final,
                         int lo, int hi, cudaStream_t stream) {
  if (batch < 1 || t_len < 1 || ch < 1 || d < 1) return cudaErrorInvalidValue;
  lo = lo < 0 ? 0 : lo;
  hi = hi > t_len ? t_len : hi;
  const dim3 grid((t_len + BM - 3) / (BM - 2), batch);
  const size_t smem = shift_smem<T>(ch);
  auto go = [&](auto kernel) {
    return launch_with_smem(kernel, grid, smem, stream, x, w1, b1, w2, b2, y,
                            t_len, ch, d, slope, final_slope, has_final, lo,
                            hi);
  };
  if constexpr (std::is_same<T, float>::value) {
    return ch > 64 ? go(shift_kernel<T, 128>) : go(shift_kernel<T, 64>);
  } else {
    if (ch % 8) return cudaErrorInvalidValue;
    if (ch % 256 == 0) return go(shift_kernel<T, 256>);
    if (ch % 128 == 0) return go(shift_kernel<T, 128>);
    return go(shift_kernel<T, 64>);
  }
}

// ---------------------------------------------------------------- chain

template <typename T>
struct ChainArgs {
  const T* x;   // [batch, t_len, ch]
  const T* w1;  // [n, 3*ch, ch]
  const T* b1;  // [n, ch]
  const T* w2;
  const T* b2;
  T* y;         // [batch, t_len, ch]
  int t_len, ch, n;
  int dils[MAX_BLOCKS];
  int ext[MAX_BLOCKS + 1];  // ext[i] = sum over k >= i of (dils[k] + 1)
  int tm;                   // output rows per thread block
  float slope, final_slope;
  int has_final;
  int lo, hi;               // the signal window, clamped to [0, t_len]
};

template <typename T>
size_t chain_smem(int ch, int tm, int e0, int e1) {
  const size_t rows = static_cast<size_t>(tm + 2 * e0) + (tm + 2 * e1 + 2);
  return STAGE_BYTES + rows * (ch + row_pad<T>()) * sizeof(T);
}

template <typename T, int BN>
__global__ void __launch_bounds__(THREADS) chain_kernel(ChainArgs<T> p) {
  using G = Gemm<T, BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ch = p.ch, t_len = p.t_len, tm = p.tm;
  const int lo = p.lo, hi = p.hi;
  const int ld = ch + row_pad<T>();
  const bool vec = ch % 4 == 0;
  const int e0 = p.ext[0];
  const int slab_rows = tm + 2 * e0;
  T* xs = reinterpret_cast<T*>(smem + STAGE_BYTES);  // [slab_rows][ld]
  T* hbuf = xs + static_cast<size_t>(slab_rows) * ld;  // [tm + 2*ext[1] + 2][ld]
  const int t0 = blockIdx.x * tm;
  const int slab0 = t0 - e0;  // signal row of slab row 0
  const int tid = threadIdx.x;
  T* yb = p.y + static_cast<long long>(blockIdx.y) * t_len * ch;

  const T* xb = p.x + static_cast<long long>(blockIdx.y) * t_len * ch;
  if constexpr (sizeof(T) == 2) {
    const int nvec = ch / 8;
    for (int e = tid; e < slab_rows * nvec; e += THREADS) {
      const int r = e / nvec, c = (e % nvec) * 8;
      const int pos = slab0 + r;
      *reinterpret_cast<uint4*>(xs + r * ld + c) =
          (pos >= lo && pos < hi)
              ? *reinterpret_cast<const uint4*>(
                    xb + static_cast<long long>(pos) * ch + c)
              : make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int e = tid; e < slab_rows * ch; e += THREADS) {
      const int r = e / ch, c = e % ch;
      const int pos = slab0 + r;
      xs[r * ld + c] = (pos >= lo && pos < hi)
                           ? xb[static_cast<long long>(pos) * ch + c]
                           : from_float<T>(0.f);
    }
  }
  __syncthreads();

  for (int i = 0; i < p.n; ++i) {
    const int d = p.dils[i], eo = p.ext[i + 1];
    const T* w1 = p.w1 + static_cast<long long>(i) * 3 * ch * ch;
    const T* w2 = p.w2 + static_cast<long long>(i) * 3 * ch * ch;
    const T* b1 = p.b1 + i * ch;
    const T* b2 = p.b2 + i * ch;
    const float slope = p.slope;
    // h over signal rows [t0 - eo - 1, t0 + tm + eo + 1)
    const int h_rows = tm + 2 * eo + 2;
    const int h_pos0 = t0 - eo - 1;
    for (int m0 = 0; m0 < h_rows; m0 += BM) {
      const RowSrc<T> taps{xs, ld, slab_rows, e0 - eo - 1 + m0, -d, d, slope,
                           true};
      for (int n0 = 0; n0 < ch; n0 += G::kBN)
        G::run(smem, taps, w1, 3, ch, ch, n0, ch, vec,
               [=](int r, int n, auto& v) {
                 constexpr int W = sizeof(v) / sizeof(float);
                 const int hr = m0 + r;
                 if (hr >= h_rows) return;
                 const int pos = h_pos0 + hr;
                 const bool inside = pos >= lo && pos < hi;
                 float b[W];
                 load_vals<T, W>(b1 + n, b);
#pragma unroll
                 for (int u = 0; u < W; ++u)
                   v[u] = inside ? lrelu(v[u] + b[u], slope) : 0.f;
                 store_vals<T, W>(hbuf + hr * ld + n, v);
               });
    }
    __syncthreads();
    // y over signal rows [t0 - eo, t0 + tm + eo): h row yr + 1 is its centre
    const int y_rows = tm + 2 * eo;
    const bool last = i + 1 == p.n;
    const int has_final = p.has_final;
    const float final_slope = p.final_slope;
    for (int m0 = 0; m0 < y_rows; m0 += BM) {
      const RowSrc<T> hrows{hbuf, ld, h_rows, m0 + 1, -1, 1, 0.f, false};
      for (int n0 = 0; n0 < ch; n0 += G::kBN)
        G::run(smem, hrows, w2, 3, ch, ch, n0, ch, vec,
               [=](int r, int n, auto& v) {
                 constexpr int W = sizeof(v) / sizeof(float);
                 const int yr = m0 + r;
                 if (yr >= y_rows) return;
                 const int pos = t0 - eo + yr;
                 T* xrow = xs + (e0 - eo + yr) * ld + n;
                 float b[W], res[W];
                 load_vals<T, W>(b2 + n, b);
                 load_vals<T, W>(xrow, res);
                 const bool inside = pos >= lo && pos < hi;
                 // the next block pads its input with zeros too, and rows
                 // of the array outside the window are written as zeros
#pragma unroll
                 for (int u = 0; u < W; ++u)
                   v[u] = inside ? v[u] + b[u] + res[u] : 0.f;
                 if (!last) {
                   store_vals<T, W>(xrow, v);
                 } else if (pos >= 0 && pos < t_len) {
                   if (has_final) {
#pragma unroll
                     for (int u = 0; u < W; ++u)
                       v[u] = lrelu(v[u], final_slope);
                   }
                   store_vals<T, W>(
                       yb + static_cast<long long>(pos) * ch + n, v);
                 }
               });
    }
    __syncthreads();
  }
}

// Fills ext from dils and launches. Returns cudaErrorInvalidValue for a
// group that does not fit shared memory (the launch would be refused).
template <typename T>
cudaError_t launch_chain(ChainArgs<T> p, int batch, cudaStream_t stream) {
  if (batch < 1 || p.t_len < 1 || p.ch < 1 || p.n < 1 || p.n > MAX_BLOCKS ||
      p.tm < 1)
    return cudaErrorInvalidValue;
  p.lo = p.lo < 0 ? 0 : p.lo;
  p.hi = p.hi > p.t_len ? p.t_len : p.hi;
  p.ext[p.n] = 0;
  for (int i = p.n - 1; i >= 0; --i) {
    if (p.dils[i] < 1) return cudaErrorInvalidValue;
    p.ext[i] = p.ext[i + 1] + p.dils[i] + 1;
  }
  const size_t smem = chain_smem<T>(p.ch, p.tm, p.ext[0], p.ext[1]);
  const dim3 grid((p.t_len + p.tm - 1) / p.tm, batch);
  if constexpr (std::is_same<T, float>::value) {
    if (p.ch > 64)
      return launch_with_smem(chain_kernel<T, 128>, grid, smem, stream, p);
    return launch_with_smem(chain_kernel<T, 64>, grid, smem, stream, p);
  } else {
    if (p.ch % 8) return cudaErrorInvalidValue;
    if (p.ch % 256 == 0)
      return launch_with_smem(chain_kernel<T, 256>, grid, smem, stream, p);
    if (p.ch % 128 == 0)
      return launch_with_smem(chain_kernel<T, 128>, grid, smem, stream, p);
    return launch_with_smem(chain_kernel<T, 64>, grid, smem, stream, p);
  }
}

}  // namespace res
}  // namespace vf
