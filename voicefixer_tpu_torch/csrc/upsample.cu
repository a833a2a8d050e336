// One vocoder upsample stage: y = ConvTranspose1d(x + sin(x)), kernel 2s,
// stride s, padding p = s//2 + s%2, output padding s%2.
//
// Replaces voicefixer_tpu/kernels/upsample.py::upsample (Pallas, TPU).
// With kernel 2s every output sample is the sum of two polyphase taps:
//   z[q*s + rho] = a[q] @ W[rho] + a[q-1] @ W[rho+s],  a = x + sin(x)
//   y[j] = z[p + j] + bias,  j in [0, T*s)
// with a[-1] = a[T] = 0. For one phase rho that is a GEMM with K = 2*Cin:
// rows q, columns Cout, A = [a[q] | a[q-1]], B = [W[rho]; W[rho+s]].
//
// Bound: operations at the main path's shapes (2*T*s*2Cin*Cout FLOP, about
// 220 GFLOP per 30 s chunk over the four stages, against a few hundred MB
// moved). Design: a pre-pass computes a = x + sin(x) in float32, rounded to
// the storage type (bfloat16 in production) as the TPU kernel does, once
// into a scratch buffer the size of x: every block of the product reads each
// a row once per phase and column block, and computing sin there instead
// cost more than the product itself. Then a tiled product, one block per
// (64 rows of q, 64 output channels, batch row x phase); products
// accumulate in float32; each output sample is written exactly once, in the
// storage type. float32 runs on the FMA units (true float32, no TF32);
// bfloat16 runs on the tensor cores through WMMA 16x16x16 fragments, each
// warp a 32x32 quarter of the tile, its tiles filled with 16-byte loads.
// The TPU kernel's 128-lane padding of Cout = 64, its VMEM plan and its
// output-channel blocking are gone. wgmma and TMA tiles are later work.

#include <mma.h>

#include "common.cuh"

namespace {

constexpr int BM = 64;   // polyphase groups q per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 16;   // reduction step
constexpr int THREADS = 256;

// thread (ty, tx) in 16 x 16 owns rows ty + 16*i and columns tx + 16*j,
// i, j < 4

__global__ void __launch_bounds__(THREADS)
upsample_kernel(const float* __restrict__ a, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ y,
                int n_in, int cin, int cout, int scale, int pad) {
  __shared__ float s_a[BK][BM + 1];  // +1: conflict-free stores
  __shared__ float s_b[BK][BN];

  const int q0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * BN;
  const int b = blockIdx.z / scale;
  const int rho = blockIdx.z % scale;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k_total = 2 * cin;
  const float* ab = a + static_cast<long long>(b) * n_in * cin;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k_total; k0 += BK) {
    // A tile: k < cin reads a[q], k >= cin reads a[q-1]
    for (int e = tid; e < BK * BM; e += THREADS) {
      const int kk = e % BK, r = e / BK;
      const int k = k0 + kk;
      const int row = q0 + r - (k >= cin ? 1 : 0);
      const int ch = k >= cin ? k - cin : k;
      s_a[kk][r] = (k < k_total && row >= 0 && row < n_in)
                       ? ab[static_cast<long long>(row) * cin + ch] : 0.f;
    }
    // B tile: tap rho for k < cin, tap rho + s for k >= cin
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int c = e % BN, kk = e / BN;
      const int k = k0 + kk;
      const int co = c0 + c;
      float v = 0.f;
      if (k < k_total && co < cout) {
        const int tap = k >= cin ? rho + scale : rho;
        const int ch = k >= cin ? k - cin : k;
        v = w[(static_cast<long long>(tap) * cin + ch) * cout + co];
      }
      s_b[kk][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_a[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = s_b[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const long long n_out = static_cast<long long>(n_in) * scale;
  float* yb = y + static_cast<long long>(b) * n_out * cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long q = q0 + ty + 16 * i;
    const long long jo = q * scale + rho - pad;
    if (q > n_in || jo < 0 || jo >= n_out) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = c0 + tx + 16 * j;
      if (co < cout) yb[jo * cout + co] = acc[i][j] + bias[co];
    }
  }
}

constexpr int TC_BK = 32;       // reduction step of the tensor-core path
constexpr int TC_THREADS = 128;  // 4 warps, 2 x 2 over the 64 x 64 tile

// The same product for bfloat16 on the tensor cores. The tiles are padded by
// 8 elements per row (WMMA needs a multiple of 8) so that the fragment loads
// spread over the shared-memory banks. Tiles are filled 8 elements (16
// bytes) at a time: cin and cout are multiples of 8, so a vector never
// straddles the a[q] | a[q-1] boundary, a tap, or the end of a row.
__global__ void __launch_bounds__(TC_THREADS)
upsample_wmma_kernel(const __nv_bfloat16* __restrict__ a,
                     const __nv_bfloat16* __restrict__ w,
                     const __nv_bfloat16* __restrict__ bias,
                     __nv_bfloat16* __restrict__ y, int n_in, int cin,
                     int cout, int scale, int pad) {
  namespace wmma = nvcuda::wmma;
  __shared__ __align__(32) __nv_bfloat16 s_a[BM][TC_BK + 8];
  __shared__ __align__(32) __nv_bfloat16 s_b[TC_BK][BN + 8];
  __shared__ __align__(32) float s_c[BM][BN + 4];

  const int q0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * BN;
  const int b = blockIdx.z / scale;
  const int rho = blockIdx.z % scale;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int k_total = 2 * cin;
  const __nv_bfloat16* ab = a + static_cast<long long>(b) * n_in * cin;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < k_total; k0 += TC_BK) {
    // A tile: k < cin reads a[q], k >= cin reads a[q-1]
    for (int e = tid; e < BM * TC_BK / 8; e += TC_THREADS) {
      const int kk = (e % (TC_BK / 8)) * 8, r = e / (TC_BK / 8);
      const int k = k0 + kk;
      const int row = q0 + r - (k >= cin ? 1 : 0);
      const int ch = k >= cin ? k - cin : k;
      *reinterpret_cast<uint4*>(&s_a[r][kk]) =
          (k < k_total && row >= 0 && row < n_in)
              ? *reinterpret_cast<const uint4*>(
                    ab + static_cast<long long>(row) * cin + ch)
              : zero;
    }
    // B tile: tap rho for k < cin, tap rho + s for k >= cin
    for (int e = tid; e < TC_BK * BN / 8; e += TC_THREADS) {
      const int c = (e % (BN / 8)) * 8, kk = e / (BN / 8);
      const int k = k0 + kk;
      const int co = c0 + c;
      const int tap = k >= cin ? rho + scale : rho;
      const int ch = k >= cin ? k - cin : k;
      *reinterpret_cast<uint4*>(&s_b[kk][c]) =
          (k < k_total && co < cout)
              ? *reinterpret_cast<const uint4*>(
                    w + (static_cast<long long>(tap) * cin + ch) * cout + co)
              : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &s_a[wm + 16 * i][kk], TC_BK + 8);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &s_b[kk][wn + 16 * j], BN + 8);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&s_c[wm + 16 * i][wn + 16 * j], acc[i][j],
                              BN + 4, wmma::mem_row_major);
  __syncthreads();

  const long long n_out = static_cast<long long>(n_in) * scale;
  __nv_bfloat16* yb = y + static_cast<long long>(b) * n_out * cout;
  for (int e = tid; e < BM * BN; e += TC_THREADS) {
    const int r = e / BN, c = e % BN;
    const long long q = q0 + r;
    const long long jo = q * scale + rho - pad;
    const int co = c0 + c;
    if (q > n_in || jo < 0 || jo >= n_out || co >= cout) continue;
    yb[jo * cout + co] =
        __float2bfloat16(s_c[r][c] + __bfloat162float(bias[co]));
  }
}

int launch(const void* x, const void* w, const void* bias, void* a, void* y,
           int batch, int n_in, int cin, int cout, int scale, bool bf16,
           cudaStream_t stream) {
  const int pad = scale / 2 + scale % 2;
  const long long n_x = static_cast<long long>(batch) * n_in * cin;
  // groups q = 0 .. n_in: the p-shift makes the last outputs reach q = n_in
  dim3 grid((n_in + 1 + BM - 1) / BM, (cout + BN - 1) / BN, batch * scale);
  if (bf16) {
    using T = __nv_bfloat16;
    if (cin % 8 || cout % 8) return cudaErrorInvalidValue;
    vf::launch_sin_residual(static_cast<const T*>(x), static_cast<T*>(a), n_x,
                            stream);
    upsample_wmma_kernel<<<grid, TC_THREADS, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(w),
        static_cast<const T*>(bias), static_cast<T*>(y), n_in, cin, cout,
        scale, pad);
  } else {
    vf::launch_sin_residual(static_cast<const float*>(x),
                            static_cast<float*>(a), n_x, stream);
    upsample_kernel<<<grid, THREADS, 0, stream>>>(
        static_cast<const float*>(a), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(y), n_in, cin,
        cout, scale, pad);
  }
  return cudaGetLastError();
}

}  // namespace

// x: [batch, n_in, cin]; w: [2*scale, cin, cout] in torch tap order;
// bias: [cout]; a: scratch shaped like x; y: [batch, n_in*scale, cout]; all
// float32 (bf16 = 0) or all bfloat16 (bf16 = 1, cin and cout multiples of 8).
extern "C" int vf_upsample(const void* x, const void* w, const void* bias,
                           void* a, void* y, int batch, int n_in, int cin,
                           int cout, int scale, int bf16, void* stream) {
  return launch(x, w, bias, a, y, batch, n_in, cin, cout, scale, bf16 != 0,
                static_cast<cudaStream_t>(stream));
}
