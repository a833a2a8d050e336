// The GRU recurrence over hoisted input projections: both directions of one
// bidirectional layer in one launch (vf_gru_bidir), or one direction, forward
// or reverse (vf_gru_seq).
//
// Replace voicefixer_tpu/kernels/gru.py::gru_seq_bidir and ::gru_seq (Pallas,
// TPU).
// Torch gate math, gate order (r, z, n), b_hh inside the n gate:
//   hp = h @ W_hh^T + b_hh
//   r = sigmoid(x_r + hp_r), z = sigmoid(x_z + hp_z)
//   n = tanh(x_n + r * hp_n), h' = (1 - z) * n + z * h
// The forward direction walks t = 0 .. T-1, the backward T-1 .. 0, each
// exactly T steps (the TPU kernel's padded-step masking existed only for its
// time tiles).
//
// Bound: the step latency. T steps are sequential and each needs the whole
// [H, 3H] recurrent matrix (768 KB in float32 at H=256), more than one SM's
// 227 KB of shared memory. Design: one cluster of CLUSTER blocks per (batch
// row, direction). Block c owns the hidden units [c*U, (c+1)*U) and their
// three gate columns, and holds that [H, 3U] slice of W in registers for the
// whole sequence (64 K-values per thread at H=256), so W is read from memory
// once. Each step a block multiplies its slice by h (4 threads per column,
// each a strided quarter of K, summed by warp shuffles), updates its own
// units, keeps their float32 state locally, and writes them, rounded to W's
// type as the TPU kernel casts h before its product, into the next-step h
// buffer of every block of the cluster (distributed shared memory). One
// cluster barrier per step orders those writes before the next step's reads;
// the h buffer is double-buffered so that no block overwrites what another
// still reads. vf_gru_bidir launches two clusters per batch row, one per
// direction (blockIdx.z); vf_gru_seq launches one, and is float32 only, as
// the TPU kernel is.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;      // blocks per (batch row, direction)
constexpr int SLICES = 4;       // threads per gate column (K split)
constexpr int MAX_HIDDEN = 256;
constexpr int KPT = MAX_HIDDEN / SLICES;          // K values per thread
constexpr int MAX_U = MAX_HIDDEN / CLUSTER;       // units per block
constexpr int THREADS = 3 * MAX_U * SLICES;       // 384

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// One direction of one batch row, run by the CLUSTER blocks of a cluster.
// x: [n_steps, 3H]; w: [H, 3H]; bias: [3H]; out: [n_steps, H].
template <typename W>
__device__ __forceinline__ void gru_direction(
    const float* __restrict__ x, const W* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ out, int n_steps,
    int hidden, bool fwd) {
  // h as the product sees it (rounded to W's type), two step buffers; the
  // tail past `hidden` stays zero
  __shared__ float hq[2][MAX_HIDDEN + SLICES];
  __shared__ float hp[3 * MAX_U];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int H = hidden, G = 3 * hidden;
  const int U = (H + CLUSTER - 1) / CLUSTER;
  const int u0 = rank * U;

  const int tid = threadIdx.x;
  const int slice = tid % SLICES;
  const int c = tid / SLICES;            // local column: gate c / U, unit c % U
  const int cu = c % U;
  const bool col_ok = c < 3 * U && u0 + cu < H;
  const int gcol = (c / U) * H + u0 + cu;

  float wr[KPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int k = i * SLICES + slice;
    wr[i] = (col_ok && k < H)
                ? vf::to_float(w[static_cast<long long>(k) * G + gcol]) : 0.f;
  }
  const float bcol = col_ok ? bias[gcol] : 0.f;

  for (int i = tid; i < 2 * (MAX_HIDDEN + SLICES); i += blockDim.x)
    (&hq[0][0])[i] = 0.f;

  const bool unit = tid < U && u0 + tid < H;  // threads that update a unit
  const int u = u0 + tid;
  float h = 0.f;                              // float32 state of unit u
  float xr = 0.f, xz = 0.f, xn = 0.f;
  if (unit) {
    const float* xt = x + static_cast<long long>(fwd ? 0 : n_steps - 1) * G;
    xr = xt[u];
    xz = xt[H + u];
    xn = xt[2 * H + u];
  }
  cluster.sync();  // every block's h buffers are zero before any remote write

  for (int s = 0; s < n_steps; ++s) {
    const int t = fwd ? s : n_steps - 1 - s;
    const float* hcur = hq[s & 1];
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < KPT; ++i) acc = fmaf(hcur[i * SLICES + slice], wr[i], acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (slice == 0 && c < 3 * U) hp[c] = acc + bcol;
    __syncthreads();

    if (unit) {
      // the next step's projections, loaded before this step's math
      float nr = 0.f, nz = 0.f, nn = 0.f;
      if (s + 1 < n_steps) {
        const float* xt =
            x + static_cast<long long>(fwd ? t + 1 : t - 1) * G;
        nr = xt[u];
        nz = xt[H + u];
        nn = xt[2 * H + u];
      }
      const float r = sigmoid(xr + hp[tid]);
      const float z = sigmoid(xz + hp[U + tid]);
      const float n = tanhf(xn + r * hp[2 * U + tid]);
      h = (1.f - z) * n + z * h;
      out[static_cast<long long>(t) * H + u] = h;
      const float q = vf::round_to<W>(h);
#pragma unroll
      for (int r_ = 0; r_ < CLUSTER; ++r_)
        cluster.map_shared_rank(&hq[(s + 1) & 1][0], r_)[u] = q;
      xr = nr;
      xz = nz;
      xn = nn;
    }
    // orders this step's remote writes before the next step's reads, and
    // this step's reads of hq[s & 1] and hp before their next writes
    cluster.sync();
  }
}

template <typename W>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
gru_bidir_kernel(const float* __restrict__ xf, const float* __restrict__ xb,
                 const W* __restrict__ wf, const W* __restrict__ wb,
                 const float* __restrict__ bf, const float* __restrict__ bb,
                 float* __restrict__ outf, float* __restrict__ outb,
                 int n_steps, int hidden) {
  const bool fwd = blockIdx.z == 0;
  const long long row = static_cast<long long>(blockIdx.y) * n_steps;
  gru_direction<W>((fwd ? xf : xb) + row * 3 * hidden, fwd ? wf : wb,
                   fwd ? bf : bb, (fwd ? outf : outb) + row * hidden, n_steps,
                   hidden, fwd);
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
gru_seq_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ out,
               int n_steps, int hidden, int reverse) {
  const long long row = static_cast<long long>(blockIdx.y) * n_steps;
  gru_direction<float>(x + row * 3 * hidden, w, bias, out + row * hidden,
                       n_steps, hidden, reverse == 0);
}

template <typename W>
int launch(const float* xf, const float* xb, const void* wf, const void* wb,
           const float* bf, const float* bb, float* outf, float* outb,
           int batch, int n_steps, int hidden, cudaStream_t stream) {
  dim3 grid(CLUSTER, batch, 2);
  gru_bidir_kernel<W><<<grid, THREADS, 0, stream>>>(
      xf, xb, static_cast<const W*>(wf), static_cast<const W*>(wb), bf, bb,
      outf, outb, n_steps, hidden);
  return cudaGetLastError();
}

}  // namespace

// xf, xb: [batch, n_steps, 3H] float32; wf, wb: [H, 3H] (W_hh^T) in float32
// (w_bf16 = 0) or bfloat16 (w_bf16 = 1); bf, bb: [3H] float32;
// outf, outb: [batch, n_steps, H] float32. H <= 256.
extern "C" int vf_gru_bidir(const float* xf, const float* xb, const void* wf,
                            const void* wb, const float* bf, const float* bb,
                            float* outf, float* outb, int batch, int n_steps,
                            int hidden, int w_bf16, void* stream) {
  if (hidden < 1 || hidden > MAX_HIDDEN) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bf16)
    return launch<__nv_bfloat16>(xf, xb, wf, wb, bf, bb, outf, outb, batch,
                                 n_steps, hidden, s);
  return launch<float>(xf, xb, wf, wb, bf, bb, outf, outb, batch, n_steps,
                       hidden, s);
}

// x: [batch, n_steps, 3H] float32; w: [H, 3H] (W_hh^T) float32; bias: [3H];
// out: [batch, n_steps, H]. reverse walks t from n_steps - 1 down to 0.
// H <= 256.
extern "C" int vf_gru_seq(const float* x, const float* w, const float* bias,
                          float* out, int batch, int n_steps, int hidden,
                          int reverse, void* stream) {
  if (hidden < 1 || hidden > MAX_HIDDEN || batch < 1 || n_steps < 1)
    return cudaErrorInvalidValue;
  dim3 grid(CLUSTER, batch, 1);
  gru_seq_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, bias, out, n_steps, hidden, reverse);
  return cudaGetLastError();
}
