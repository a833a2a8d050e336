// Fused framing -> windowed DFT -> magnitude -> mel projection.
//
// Replaces voicefixer_tpu/kernels/stft.py::stft_mel (Pallas, TPU).
// out[b, t, m] = sum_f sqrt(max(re^2 + im^2, eps)) * fb[f, m], where
// re/im[b, t, f] = sum_n wav_p[b, t*hop + n] * W_{cos,sin}[n, f] and wav_p is
// the centre reflect-padded wave. Only [B, T, n_mels] reaches device memory.
//
// Bound: ~26 GFLOP of float32 FMA per 30 s chunk against a few MB of input,
// so operations bound it (67 TFLOP/s float32 outside the tensor cores; the
// products must stay true float32, no TF32). Design: one block owns BM
// consecutive frames. It copies the stretch of padded wave those frames cover
// into shared memory once and reads its frames straight from it (the TPU
// kernel had to materialise the [T, n_fft] frames because Mosaic could not
// frame at hop 441). It walks the frequency axis BN bins at a time: a tiled
// float32 product over n_fft in BK steps for re and im, the magnitude into
// shared memory, then the BN x n_mels slice of the filterbank is multiplied
// into a per-thread mel accumulator held in registers across the walk.
// The TPU's 1025 -> 1152 frequency padding is gone; the ragged last block
// is masked.

#include "common.cuh"

namespace {

constexpr int BM = 32;       // frames per block
constexpr int BN = 64;       // frequency bins per step
constexpr int BK = 32;       // DFT taps per step
constexpr int MELS = 128;    // mel bins a block holds
constexpr int THREADS = 256;

// thread (ty, tx) in 16 x 16 owns frames 2*ty + {0, 1}; DFT columns
// tx + 16*j (j < 4); mel columns tx + 16*j (j < 8)

__global__ void __launch_bounds__(THREADS)
stft_mel_kernel(const float* __restrict__ wav, int n_pad, int n_frames,
                int n_fft, int hop, int span,
                const float* __restrict__ wcos, const float* __restrict__ wsin,
                int n_freqs, const float* __restrict__ fb, int n_mels,
                float mag_eps, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_wav = smem;                   // [span]
  float* s_cos = s_wav + span;           // [BK][BN]
  float* s_sin = s_cos + BK * BN;        // [BK][BN]
  float* s_mag = s_sin + BK * BN;        // [BM][BN]
  float* s_fb = s_mag + BM * BN;         // [BN][MELS]

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  const long long base = static_cast<long long>(t0) * hop;
  const float* x = wav + static_cast<long long>(b) * n_pad + base;
  const long long avail = n_pad - base;
  for (int i = tid; i < span; i += THREADS) s_wav[i] = i < avail ? x[i] : 0.f;

  const float* a0p = s_wav + (2 * ty) * hop;
  const float* a1p = a0p + hop;

  float mel[2][8];
#pragma unroll
  for (int j = 0; j < 8; ++j) mel[0][j] = mel[1][j] = 0.f;

  for (int f0 = 0; f0 < n_freqs; f0 += BN) {
    float re[2][4], im[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) re[0][j] = re[1][j] = im[0][j] = im[1][j] = 0.f;

    for (int k0 = 0; k0 < n_fft; k0 += BK) {
      __syncthreads();  // readers of the previous tiles are done
      for (int i = tid; i < BK * BN; i += THREADS) {
        const int kk = i / BN, c = i % BN;
        const int f = f0 + c;
        const long long src = static_cast<long long>(k0 + kk) * n_freqs + f;
        s_cos[i] = f < n_freqs ? wcos[src] : 0.f;
        s_sin[i] = f < n_freqs ? wsin[src] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        const float a0 = a0p[k0 + kk];
        const float a1 = a1p[k0 + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float c = s_cos[kk * BN + tx + 16 * j];
          const float s = s_sin[kk * BN + tx + 16 * j];
          re[0][j] = fmaf(a0, c, re[0][j]);
          im[0][j] = fmaf(a0, s, im[0][j]);
          re[1][j] = fmaf(a1, c, re[1][j]);
          im[1][j] = fmaf(a1, s, im[1][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = re[i][j] * re[i][j] + im[i][j] * im[i][j];
        s_mag[(2 * ty + i) * BN + c] =
            f0 + c < n_freqs ? sqrtf(fmaxf(p, mag_eps)) : 0.f;
      }
    }
    for (int i = tid; i < BN * MELS; i += THREADS) {
      const int r = i / MELS, c = i % MELS;
      const int f = f0 + r;
      s_fb[i] = (f < n_freqs && c < n_mels)
                    ? fb[static_cast<long long>(f) * n_mels + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BN; ++kk) {
      const float m0 = s_mag[(2 * ty) * BN + kk];
      const float m1 = s_mag[(2 * ty + 1) * BN + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float w = s_fb[kk * MELS + tx + 16 * j];
        mel[0][j] = fmaf(m0, w, mel[0][j]);
        mel[1][j] = fmaf(m1, w, mel[1][j]);
      }
    }
    // the next step's first __syncthreads() orders these reads of s_mag and
    // s_fb before their next writes
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t0 + 2 * ty + i;
    if (t >= n_frames) continue;
    float* o = out + (static_cast<long long>(b) * n_frames + t) * n_mels;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tx + 16 * j;
      if (c < n_mels) o[c] = mel[i][j];
    }
  }
}

}  // namespace

// wav_p: [batch, n_pad] centre-padded wave; wcos/wsin: [n_fft, n_freqs];
// fb: [n_freqs, n_mels]; out: [batch, n_frames, n_mels]. n_fft % 32 == 0,
// n_mels <= 128, (n_frames - 1) * hop + n_fft <= n_pad.
extern "C" int vf_stft_mel(const float* wav_p, int n_pad, int batch,
                           int n_frames, int n_fft, int hop,
                           const float* wcos, const float* wsin, int n_freqs,
                           const float* fb, int n_mels, float mag_eps,
                           float* out, void* stream) {
  int span = (BM - 1) * hop + n_fft;
  span = (span + 3) / 4 * 4;
  const size_t smem =
      sizeof(float) * (span + 2 * BK * BN + BM * BN + BN * MELS);
  cudaError_t err = cudaFuncSetAttribute(
      stft_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((n_frames + BM - 1) / BM, batch);
  stft_mel_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      wav_p, n_pad, n_frames, n_fft, hop, span, wcos, wsin, n_freqs, fb,
      n_mels, mag_eps, out);
  return cudaGetLastError();
}
