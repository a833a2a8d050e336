// K10: BigVGAN's anti-aliased SnakeBeta activation (Activation1d) on a
// channel-last signal x [B, T, C], in one pass:
//   u = 2x upsample of x: replicate pad 5, transposed conv of stride 2 with
//       the 12-tap Kaiser-windowed sinc f (times 2), crop 15 a side: 2T;
//   a = u + sin^2(alpha u) / (beta + 1e-9), alpha = exp(log_alpha[c]),
//       beta = exp(log_beta[c]);
//   y = 2x downsample of a: replicate pad (5, 6) of the activated 2T
//       signal, conv of stride 2 with the same f: T samples.
//
// Replaces no TPU kernel: the JAX package has no BigVGAN. It was added for
// models/bigvgan.py, which runs it 109 times a pass (18 a stage, one before
// conv_post). Unfused in torch each activation is a pad, a transposed conv,
// a crop, five elementwise passes at 2T and a strided conv: the 2T signal
// goes through device memory about ten times.
//
// Bound: bytes by the least work: x read once and y written once, 4 bytes
// an element in bfloat16, against 58 FLOP an element in float32 (two 6-tap
// polyphase sums, two SnakeBeta, one 12-tap sum). The two sinf an element
// cost more instructions than that count says. Design: one thread a
// channel and a run of TT outputs in time, so that a warp reads 32
// neighbouring channels of a row; the 2T signal never leaves registers.
// Per output time t the polyphase form is
//   u[2j]   = 2 sum_{d=-3..2} x~[j+d] f[5-2d]
//   u[2j+1] = 2 sum_{d=-2..3} x~[j+d] f[6-2d]
//   y[t]    = sum_{k<12} f[k] a[clamp(2t+k-5, 0, 2T-1)]
// with x~ the input's replicate pad, a clamp of the row index at load. The
// thread streams a over local index l = m - (2 t0 - 5), m in
// [2 t0 - 5, 2 t0 + 2 TT + 4], keeping the 12 it still needs: fully
// unrolled, every index is a constant and the window lives in registers.
// The downsample's pad of the activated signal: at the first tile a[l < 5]
// (m < 0) is a[5] (m = 0); past the end a[l > l_last] is a[l_last]
// (m = 2T - 1), both selects on values already in registers.
// Float32 throughout; the output is rounded once to the storage type.

#include "common.cuh"

namespace {

constexpr int TAPS = 12;
constexpr int TT = 32;           // outputs a thread walks in time
constexpr int NX = TT + 10;      // x~ rows t0 - 5 .. t0 + TT + 4
constexpr int NA = 2 * TT + 10;  // a at m = 2 t0 - 5 .. 2 t0 + 2 TT + 4
constexpr int THREADS = 256;

struct Filter {
  float f[TAPS];
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
snake_aa_kernel(const T* __restrict__ x, const T* __restrict__ log_alpha,
                const T* __restrict__ log_beta, T* __restrict__ y, int n_t,
                int ch, int n_tiles, long long n_threads, Filter flt) {
  const long long gid =
      static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (gid >= n_threads) return;
  const int c = static_cast<int>(gid % ch);
  const long long rest = gid / ch;
  const int t0 = static_cast<int>(rest % n_tiles) * TT;
  const long long row0 = (rest / n_tiles) * n_t;
  const T* xb = x + row0 * ch + c;
  T* yb = y + row0 * ch + c;

  const float alpha = expf(vf::to_float(log_alpha[c]));
  const float inv_beta = 1.f / (expf(vf::to_float(log_beta[c])) + 1e-9f);
  // the upsample's taps carry its factor 2
  float up[TAPS];
#pragma unroll
  for (int k = 0; k < TAPS; ++k) up[k] = 2.f * flt.f[k];

  float xv[NX];
#pragma unroll
  for (int r = 0; r < NX; ++r) {
    const int tt = min(max(t0 - 5 + r, 0), n_t - 1);
    xv[r] = vf::to_float(xb[static_cast<long long>(tt) * ch]);
  }

  // a[l] is at m = 2 t0 - 5 + l; m = 2T - 1 is l_last
  const int l_last = 2 * (n_t - t0) + 4;
  float a[NA];
  float a_last = 0.f;
#pragma unroll
  for (int l = 0; l < NA; ++l) {
    float u = 0.f;
    if (l & 1) {  // m = 2j even, xv index (l + 5) / 2 + d
#pragma unroll
      for (int d = -3; d <= 2; ++d)
        u = fmaf(xv[(l + 5) / 2 + d], up[5 - 2 * d], u);
    } else {      // m = 2j + 1 odd, xv index l / 2 + 2 + d
#pragma unroll
      for (int d = -2; d <= 3; ++d)
        u = fmaf(xv[l / 2 + 2 + d], up[6 - 2 * d], u);
    }
    const float s = sinf(alpha * u);
    float v = fmaf(inv_beta * s, s, u);
    if (l == l_last) a_last = v;
    if (l > l_last) v = a_last;
    a[l] = v;
    if (l == 11 && t0 == 0) {
#pragma unroll
      for (int q = 0; q < 5; ++q) a[q] = a[5];
    }
    // y[t0 + i] takes a[2i .. 2i + 11]: it is complete at l = 2i + 11
    if (l >= 11 && (l & 1)) {
      const int i = (l - 11) / 2;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < TAPS; ++k) acc = fmaf(flt.f[k], a[2 * i + k], acc);
      if (t0 + i < n_t)
        yb[static_cast<long long>(t0 + i) * ch] = vf::from_float<T>(acc);
    }
  }
}

template <typename T>
int launch(const T* x, const T* log_alpha, const T* log_beta, T* y, int batch,
           int n_t, int ch, const Filter& flt, cudaStream_t stream) {
  const int n_tiles = (n_t + TT - 1) / TT;
  const long long n_threads = static_cast<long long>(batch) * n_tiles * ch;
  const long long blocks = (n_threads + THREADS - 1) / THREADS;
  snake_aa_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      x, log_alpha, log_beta, y, n_t, ch, n_tiles, n_threads, flt);
  return cudaGetLastError();
}

}  // namespace

// x, y: [batch, n_t, ch]; log_alpha, log_beta: [ch]; all float32 (bf16 = 0)
// or all bfloat16 (bf16 = 1); taps: 12 floats on the host, the low-pass
// filter of both resamplings.
extern "C" int vf_snake_aa(const void* x, const void* log_alpha,
                           const void* log_beta, void* y, int batch, int n_t,
                           int ch, const float* taps, int bf16,
                           void* stream_ptr) {
  if (batch < 1 || n_t < 1 || ch < 1) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Filter flt;
  for (int k = 0; k < TAPS; ++k) flt.f[k] = taps[k];
  if (bf16) {
    using T = __nv_bfloat16;
    return launch(static_cast<const T*>(x), static_cast<const T*>(log_alpha),
                  static_cast<const T*>(log_beta), static_cast<T*>(y), batch,
                  n_t, ch, flt, stream);
  }
  return launch(static_cast<const float*>(x),
                static_cast<const float*>(log_alpha),
                static_cast<const float*>(log_beta), static_cast<float*>(y),
                batch, n_t, ch, flt, stream);
}
