// Fused framing -> windowed FFT -> magnitude -> mel projection.
//
// Replaces voicefixer_tpu/kernels/stft.py::stft_mel (Pallas, TPU).
// out[b, t, m] = sum_f sqrt(max(re^2 + im^2, eps)) * fb[f, m], where
// re + i*im [b, t, f] = sum_n wav_p[b, t*hop + n] * win[n] * exp(-2 pi i n f
// / n_fft) and wav_p is the centre-padded wave. Only [B, T, n_mels] reaches
// device memory. True float32 throughout.
//
// Bound: 0.97 GFLOP and 7.4 MB a 30 s chunk, microseconds either way; what
// costs time is latency, so the design keeps barriers few and blocks many.
// The TPU kernel multiplies the frames by dense windowed-DFT matrices: 25x
// the arithmetic, and 2 x 8.4 MB of matrices to stream. Here:
//
// - A block owns 2P consecutive frames (P = 2 at n_fft 2048: 751 blocks for
//   132 SMs). It copies the stretch of padded wave they cover into shared
//   memory once, coalesced (hop 441 leaves frame starts unaligned), zeros
//   beyond the wave's end.
// - Two real frames go through one complex FFT of n_fft points, z = x1 +
//   i*x2, and are split afterwards: X1[k] = (Z[k] + conj Z[N-k]) / 2,
//   X2[k] = (Z[k] - conj Z[N-k]) / 2i, with Z[N] = Z[0]. Against one frame
//   through a half-size FFT with a split twiddle this is the same
//   arithmetic a frame, needs no twiddle in the split, and an odd last
//   frame is simply a zero imaginary part.
// - The FFT is Stockham's self-sorting form (no bit-reversal pass) in
//   radix-8 passes and a last pass of radix 2 or 4 (2048 = 8*8*8*4), each
//   thread a butterfly in registers, the passes ping-ponging between two
//   shared-memory buffers with one barrier a pass. The first pass reads the
//   frames from the wave, applying the window. Real and imaginary parts lie
//   in separate arrays, and index i is stored at i + i/32: the passes write
//   at power-of-two strides, which would otherwise put a warp on one bank.
// - Twiddles exp(-2 pi i k / n_fft) come from a table made in float64 on the
//   host, never from __sinf/__cosf. A thread's twiddles serve all P FFTs of
//   the block.
// - The magnitudes of frames 2p and 2p+1 overwrite Z[k] of pair p in place
//   (thread k reads Z[k] and Z[N-k] and writes slot k; no other thread reads
//   slot k <= N/2). mag_eps clamps before the square root.
// - The mel product runs over each column's band only. A pre-pass kernel
//   finds, for every mel column, the first and last row where fb is
//   non-zero; a thread owns one mel column for P of the block's frames and
//   sums mag[f] * fb[f, m] over [lo_m, hi_m]. A triangular filterbank has
//   2 * 1025 non-zero entries of 131 200; a dense fb gets full bands and is
//   still right.
//
// Shared memory at n_fft 2048, hop 441, P = 2: the span (3*441 + 2048) * 4
// = 13.5 KB, two buffers of P * 2 * (2048 + 64) * 4 = 33.8 KB each; 81 KB,
// so two blocks an SM. P is the largest of 4, 2, 1 that leaves room for two
// blocks an SM, else the largest that fits at all (n_fft 4096: P = 1).

#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_MELS = 128;
constexpr int SMEM_LIMIT = 227 * 1024;

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

struct cpx {
  float re, im;
};
__device__ __forceinline__ cpx operator+(cpx a, cpx b) {
  return {a.re + b.re, a.im + b.im};
}
__device__ __forceinline__ cpx operator-(cpx a, cpx b) {
  return {a.re - b.re, a.im - b.im};
}
__device__ __forceinline__ cpx mul(cpx a, cpx b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
__device__ __forceinline__ cpx mul_neg_i(cpx a) { return {a.im, -a.re}; }

// forward DFTs of 2, 4 and 8 points in place; the outputs come in
// bit-reversed order: v[i] holds X[rev(i)]
__device__ __forceinline__ void fft2(cpx& a, cpx& b) {
  const cpx t = a;
  a = t + b;
  b = t - b;
}
__device__ __forceinline__ void fft4(cpx& v0, cpx& v1, cpx& v2, cpx& v3) {
  fft2(v0, v2);
  fft2(v1, v3);
  v3 = mul_neg_i(v3);
  fft2(v0, v1);
  fft2(v2, v3);
}
__device__ __forceinline__ void fft8(cpx* v) {
  const float h = 0.70710678118654752440f;
  fft2(v[0], v[4]);
  fft2(v[1], v[5]);
  fft2(v[2], v[6]);
  fft2(v[3], v[7]);
  v[5] = mul(v[5], {h, -h});
  v[6] = mul_neg_i(v[6]);
  v[7] = mul(v[7], {-h, -h});
  fft4(v[0], v[1], v[2], v[3]);
  fft4(v[4], v[5], v[6], v[7]);
}

template <int R>
__device__ __forceinline__ int rev(int i) {
  if constexpr (R == 2) return i;
  if constexpr (R == 4) return ((i & 1) << 1) | (i >> 1);
  return ((i & 1) << 2) | (i & 2) | (i >> 2);
}

template <int R>
__device__ __forceinline__ void butterfly(cpx* v) {
  if constexpr (R == 2) fft2(v[0], v[1]);
  if constexpr (R == 4) fft4(v[0], v[1], v[2], v[3]);
  if constexpr (R == 8) fft8(v);
}

// One Stockham pass of radix R over P transforms of n points: butterfly j
// reads points j + r*n/R, multiplies point r by exp(-2 pi i (j % ns) r /
// (ns R)), and writes X[r] at (j / ns) * ns * R + j % ns + r * ns. ns is the
// product of the earlier passes' radices. A buffer holds, for transform p,
// its real parts at [2p * np] and its imaginary parts at [(2p + 1) * np].
template <int R, int P>
__device__ __forceinline__ void fft_pass(const float* __restrict__ src,
                                         float* __restrict__ dst, int n,
                                         int np, int ns,
                                         const float2* __restrict__ tw) {
  const int stride = n / R;
  const int tw_step = n / (ns * R);
  for (int j = threadIdx.x; j < stride; j += THREADS) {
    const int k = j % ns;
    const int j0 = (j / ns) * ns * R + k;
    cpx wr[R];
#pragma unroll
    for (int r = 1; r < R; ++r) {
      const float2 t = __ldg(tw + k * r * tw_step);
      wr[r] = {t.x, t.y};
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float* re = src + 2 * p * np;
      const float* im = re + np;
      cpx v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = padded(j + r * stride);
        v[r] = {re[i], im[i]};
        if (r > 0) v[r] = mul(v[r], wr[r]);
      }
      butterfly<R>(v);
      float* ore = dst + 2 * p * np;
      float* oim = ore + np;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int o = padded(j0 + rev<R>(r) * ns);
        ore[o] = v[r].re;
        oim[o] = v[r].im;
      }
    }
  }
}

template <int P>
__global__ void __launch_bounds__(THREADS)
stft_mel_kernel(const float* __restrict__ wav, int n_pad, int n_frames,
                int n_fft, int hop, int span, const float* __restrict__ win,
                const float2* __restrict__ tw, const float* __restrict__ fb,
                int n_mels, const int* __restrict__ band_lo,
                const int* __restrict__ band_hi, float mag_eps,
                float* __restrict__ out) {
  extern __shared__ float smem[];
  const int np = n_fft + (n_fft >> 5);
  float* s_wav = smem;                    // [span]
  float* buf0 = s_wav + span;             // [P][2][np]
  float* buf1 = buf0 + 2 * P * np;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * 2 * P;
  const int tid = threadIdx.x;

  const long long base = static_cast<long long>(t0) * hop;
  const float* x = wav + static_cast<long long>(b) * n_pad + base;
  const long long avail = n_pad - base;
  for (int i = tid; i < span; i += THREADS) s_wav[i] = i < avail ? x[i] : 0.f;
  __syncthreads();

  // first pass (ns = 1, no twiddles): frames 2p and 2p+1 from the wave,
  // windowed, as the real and imaginary part
  {
    const int stride = n_fft / 8;
    for (int j = tid; j < stride; j += THREADS) {
      float wn[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) wn[r] = __ldg(win + j + r * stride);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float* f1 = s_wav + 2 * p * hop;
        // a frame beyond the last one (an odd count) is zero
        const float live = t0 + 2 * p + 1 < n_frames ? 1.f : 0.f;
        cpx v[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int n = j + r * stride;
          v[r] = {wn[r] * f1[n], live * wn[r] * f1[hop + n]};
        }
        fft8(v);
        float* ore = buf0 + 2 * p * np;
        float* oim = ore + np;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int o = padded(j * 8 + rev<8>(r));
          ore[o] = v[r].re;
          oim[o] = v[r].im;
        }
      }
    }
  }
  __syncthreads();

  float* src = buf0;
  float* dst = buf1;
  int ns = 8;
  while (n_fft / ns >= 8) {
    fft_pass<8, P>(src, dst, n_fft, np, ns, tw);
    __syncthreads();
    float* t = src; src = dst; dst = t;
    ns *= 8;
  }
  if (n_fft / ns == 4) {
    fft_pass<4, P>(src, dst, n_fft, np, ns, tw);
    __syncthreads();
    src = dst;
  } else if (n_fft / ns == 2) {
    fft_pass<2, P>(src, dst, n_fft, np, ns, tw);
    __syncthreads();
    src = dst;
  }

  // split the pair and take the magnitudes, in place: slot k of the real
  // array gets frame 2p's, of the imaginary array frame 2p+1's
  const int n_freqs = n_fft / 2 + 1;
  for (int e = tid; e < P * n_freqs; e += THREADS) {
    const int p = e / n_freqs, k = e % n_freqs;
    float* re = src + 2 * p * np;
    float* im = re + np;
    const int i0 = padded(k), i1 = padded((n_fft - k) & (n_fft - 1));
    const float zr = re[i0], zi = im[i0], cr = re[i1], ci = im[i1];
    const float r1 = 0.5f * (zr + cr), m1 = 0.5f * (zi - ci);
    const float r2 = 0.5f * (zi + ci), m2 = 0.5f * (cr - zr);
    re[i0] = sqrtf(fmaxf(r1 * r1 + m1 * m1, mag_eps));
    im[i0] = sqrtf(fmaxf(r2 * r2 + m2 * m2, mag_eps));
  }
  __syncthreads();

  // mel: thread (g, m) sums column m's band for frames g, g + G, ...
  constexpr int G = THREADS / MAX_MELS;
  const int m = tid % MAX_MELS, g = tid / MAX_MELS;
  if (m < n_mels) {
    constexpr int FR = (2 * P + G - 1) / G;  // frames a thread
    float acc[FR];
#pragma unroll
    for (int i = 0; i < FR; ++i) acc[i] = 0.f;
    const int lo = band_lo[m], hi = band_hi[m];
    for (int f = lo; f <= hi; ++f) {
      const float wgt = __ldg(fb + static_cast<long long>(f) * n_mels + m);
      const int i = padded(f);
#pragma unroll
      for (int c = 0; c < FR; ++c) {
        const int fr = g + c * G;  // frame 2p + (0: real, 1: imaginary)
        if (fr < 2 * P) acc[c] = fmaf(src[fr * np + i], wgt, acc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < FR; ++c) {
      const int fr = g + c * G;
      if (fr < 2 * P && t0 + fr < n_frames)
        out[(static_cast<long long>(b) * n_frames + t0 + fr) * n_mels + m] =
            acc[c];
    }
  }
}

// band_lo[m], band_hi[m]: the first and last row f with fb[f, m] != 0
// (lo = 0, hi = -1 for a column of zeros). One block a column.
__global__ void __launch_bounds__(THREADS)
mel_bands_kernel(const float* __restrict__ fb, int n_freqs, int n_mels,
                 int* __restrict__ band_lo, int* __restrict__ band_hi) {
  __shared__ int s_lo, s_hi;
  const int m = blockIdx.x;
  if (threadIdx.x == 0) {
    s_lo = n_freqs;
    s_hi = -1;
  }
  __syncthreads();
  int lo = n_freqs, hi = -1;
  for (int f = threadIdx.x; f < n_freqs; f += THREADS) {
    if (fb[static_cast<long long>(f) * n_mels + m] != 0.f) {
      lo = min(lo, f);
      hi = max(hi, f);
    }
  }
  if (hi >= 0) {
    atomicMin(&s_lo, lo);
    atomicMax(&s_hi, hi);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    band_lo[m] = s_hi < 0 ? 0 : s_lo;
    band_hi[m] = s_hi;
  }
}

size_t smem_bytes(int pairs, int n_fft, int hop) {
  const int span = ((2 * pairs - 1) * hop + n_fft + 3) / 4 * 4;
  return sizeof(float) * (span + 2 * 2 * pairs * (n_fft + (n_fft >> 5)));
}

template <int P>
int launch(const float* wav_p, int n_pad, int batch, int n_frames, int n_fft,
           int hop, const float* win, const float2* tw, const float* fb,
           int n_mels, const int* band_lo, const int* band_hi, float mag_eps,
           float* out, cudaStream_t stream) {
  const size_t smem = smem_bytes(P, n_fft, hop);
  cudaError_t err = cudaFuncSetAttribute(
      stft_mel_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int span = ((2 * P - 1) * hop + n_fft + 3) / 4 * 4;
  dim3 grid((n_frames + 2 * P - 1) / (2 * P), batch);
  stft_mel_kernel<P><<<grid, THREADS, smem, stream>>>(
      wav_p, n_pad, n_frames, n_fft, hop, span, win, tw, fb, n_mels, band_lo,
      band_hi, mag_eps, out);
  return cudaGetLastError();
}

}  // namespace

// wav_p: [batch, n_pad] centre-padded wave; win: [n_fft] the window, zero
// padded to n_fft; tw: [n_fft] (cos, -sin)(2 pi k / n_fft); fb: [n_fft/2 + 1,
// n_mels]; bands: scratch of 2 * n_mels ints; out: [batch, n_frames, n_mels].
// n_fft a power of two in [64, 4096], hop <= n_fft, n_mels <= 128,
// n_frames >= 1; frames may reach beyond n_pad (they read zeros there).
extern "C" int vf_stft_mel(const float* wav_p, int n_pad, int batch,
                           int n_frames, int n_fft, int hop, const float* win,
                           const void* tw, const float* fb, int n_mels,
                           float mag_eps, int* bands, float* out,
                           void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_fft < 64 || n_fft > 4096 || (n_fft & (n_fft - 1)) || hop < 1 ||
      hop > n_fft || n_mels < 1 || n_mels > MAX_MELS || n_frames < 1)
    return cudaErrorInvalidValue;
  int* band_lo = bands;
  int* band_hi = bands + n_mels;
  mel_bands_kernel<<<n_mels, THREADS, 0, stream>>>(fb, n_fft / 2 + 1, n_mels,
                                                   band_lo, band_hi);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int pairs = 0;
  for (int p : {4, 2, 1})
    if (!pairs && 2 * smem_bytes(p, n_fft, hop) + 2048 <= SMEM_LIMIT)
      pairs = p;
  for (int p : {4, 2, 1})
    if (!pairs && smem_bytes(p, n_fft, hop) <= SMEM_LIMIT) pairs = p;
  if (!pairs) return cudaErrorInvalidValue;
  const float2* t2 = static_cast<const float2*>(tw);
  auto fn = pairs == 4 ? launch<4> : pairs == 2 ? launch<2> : launch<1>;
  return fn(wav_p, n_pad, batch, n_frames, n_fft, hop, win, t2, fb, n_mels,
            band_lo, band_hi, mag_eps, out, stream);
}
