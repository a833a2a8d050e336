// One ResUNet ConvBlockRes in one kernel: vf_conv_block_res.
//
//   a1  = lrelu(x*s1 + t1), 0 outside the signal, cast to T
//   h1  = conv3x3(a1, W1)                          float32 sums
//   a2  = lrelu(h1*s2 + t2), 0 outside the signal, cast to T
//   out = conv3x3(a2, W2) + (x @ Wsc + bsc  or  x), float32, cast to T once
//
// on x [B, T, F, Ci] (channels last), zero 'same' padding in T and F, with
// (s, t) the folded eval-mode batch norms. T is float (FMA units, true
// float32) or __nv_bfloat16 (tensor cores, float32 accumulation). h1 is
// never rounded to T and never leaves the thread block.
//
// Replaces voicefixer_tpu/kernels/convblock.py::conv_block_res (Pallas,
// TPU), which the JAX package routes to only on request and only for blocks
// of at most 128 channels.
//
// Bound: operations (18*Co*(Ci + Co) FLOP against Ci + Co elements moved
// per pixel). Design: the TPU kernel's one idea carries over. (T, F) is read
// as one row axis of T*Fp rows with Fp = F + 1: the one absent column per
// time step makes tap (dt, df) the plain row offset dt*Fp + df, and a tap
// that crosses an F edge lands on the absent column, which reads as zero. So
// a 3x3 conv is the ResStack's tap product (resblock.cuh, Gemm::run) with
// nine offsets instead of three. A thread block owns tm consecutive rows:
// conv1 is computed over the tile and Fp + 1 rows a side, straight from
// global memory with the batch norm and LeakyReLU applied as rows are
// staged; its epilogue applies the second batch norm and LeakyReLU and
// keeps a2 in shared memory; the 1x1 shortcut product goes to a float32
// tile in shared memory; conv2 reads a2 at row offsets and its epilogue adds
// the shortcut (or x) and writes. The absent column exists only in the row
// arithmetic: x and out keep their dense [T, F, C] layout. The TPU kernel's
// padding of every width to 128 lanes, its im2col slab and its VMEM budget
// are gone; Ci below 8 (the first block has 2) is padded with zero weight
// rows for the bfloat16 product only.

#include "resblock.cuh"

namespace {

using namespace vf::res;
using vf::to_float;

template <int W>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[W]) {
#pragma unroll
  for (int u = 0; u < W; ++u) v[u] = p[u];
}

// Tap j of a 3x3 conv: dt = j/3 - 1, df = j%3 - 1.

// Rows of the stream read from the dense activation [t_len, f, c_real] in
// global memory: flat row p is pixel (p / fp, p % fp), zero when the pixel
// lies outside the signal. With scale set, a row is staged as
// lrelu(v*scale[c] + shift[c]); channels from c_real up read as zero.
template <typename T>
struct GridSrc {
  const T* base;
  int c_real;
  int fp, f, rows;
  int row0;
  int off0;  // -(fp + 1) for the nine taps, 0 for a single tap
  const float* scale;
  const float* shift;
  float slope;

  __device__ __forceinline__ bool pixel(int r, int tap, long long& at) const {
    const int p = row0 + r + off0 + (tap / 3) * fp + tap % 3;
    if (p < 0 || p >= rows) return false;
    const int t = p / fp, col = p - t * fp;
    if (col >= f) return false;
    at = (static_cast<long long>(t) * f + col) * c_real;
    return true;
  }

  // multiply, then add, each rounded: the plain version's arithmetic
  __device__ __forceinline__ float act(float v, int c) const {
    if (scale == nullptr) return v;
    return lrelu(__fadd_rn(__fmul_rn(v, scale[c]), shift[c]), slope);
  }

  __device__ __forceinline__ float load1(int r, int tap, int c) const {
    long long at;
    if (c >= c_real || !pixel(r, tap, at)) return 0.f;
    return act(to_float(base[at + c]), c);
  }

  __device__ __forceinline__ float4 load4(int r, int tap, int c) const {
    long long at;
    if (!pixel(r, tap, at)) return make_float4(0.f, 0.f, 0.f, 0.f);
    float4 v = *reinterpret_cast<const float4*>(base + at + c);
    v.x = act(v.x, c);
    v.y = act(v.y, c + 1);
    v.z = act(v.z, c + 2);
    v.w = act(v.w, c + 3);
    return v;
  }

  __device__ __forceinline__ uint4 load8(int r, int tap, int c) const {
    long long at;
    if (!pixel(r, tap, at)) return make_uint4(0, 0, 0, 0);
    float v[8];
    if (c_real % 8 == 0) {
      load_vals<T, 8>(base + at + c, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = act(v[i], c + i);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = c + i < c_real ? act(to_float(base[at + c + i]), c + i) : 0.f;
    }
    uint4 q;
    store_vals<T, 8>(reinterpret_cast<T*>(&q), v);
    return q;
  }
};

// Rows of a2 in shared memory, at the nine tap offsets.
template <typename T>
struct SlabSrc {
  const T* base;
  int ld, rows, row0, fp;

  __device__ __forceinline__ bool row_of(int r, int tap, int& p) const {
    p = row0 + r + (tap / 3 - 1) * fp + tap % 3 - 1;
    return p >= 0 && p < rows;
  }
  __device__ __forceinline__ float load1(int r, int tap, int c) const {
    int p;
    return row_of(r, tap, p) ? to_float(base[p * ld + c]) : 0.f;
  }
  __device__ __forceinline__ float4 load4(int r, int tap, int c) const {
    int p;
    return row_of(r, tap, p)
               ? *reinterpret_cast<const float4*>(base + p * ld + c)
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ uint4 load8(int r, int tap, int c) const {
    int p;
    return row_of(r, tap, p)
               ? *reinterpret_cast<const uint4*>(base + p * ld + c)
               : make_uint4(0, 0, 0, 0);
  }
};

template <typename T>
struct BlockArgs {
  const T* x;    // [batch, t_len, f, ci]
  T* y;          // [batch, t_len, f, co]
  const T* w1;   // [9*ci_p, co]
  const T* w2;   // [9*co, co]
  const T* wsc;  // [ci_p + 1, co], the last row the bias; null: identity
  const float* s1;  // [ci]
  const float* t1;
  const float* s2;  // [co]
  const float* t2;
  int t_len, f, ci, ci_p, co, tm;
  float slope;
};

constexpr int RES_PAD = 4;  // floats a row of the shortcut tile is padded by

template <typename T, int BN>
__global__ void __launch_bounds__(THREADS) conv_block_kernel(BlockArgs<T> p) {
  using G = Gemm<T, BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int co = p.co, ci = p.ci, f = p.f, tm = p.tm;
  const int fp = f + 1, hb = fp + 1;
  const int rows = p.t_len * fp;
  const int ld = co + row_pad<T>();
  const int ldr = co + RES_PAD;
  const int h_rows = tm + 2 * hb;
  T* a2 = reinterpret_cast<T*>(smem + STAGE_BYTES);  // [h_rows][ld]
  float* res = reinterpret_cast<float*>(a2 + static_cast<size_t>(h_rows) * ld);
  const int t0 = blockIdx.x * tm;
  const long long pixels = static_cast<long long>(p.t_len) * f;
  const T* xb = p.x + blockIdx.y * pixels * ci;
  T* yb = p.y + blockIdx.y * pixels * co;
  const bool vec_out = co % 4 == 0;
  const bool vec_in = vec_out && ci % 4 == 0;
  const float slope = p.slope;
  const float* s2 = p.s2;
  const float* t2 = p.t2;

  // a2 over flat rows [t0 - hb, t0 + tm + hb)
  for (int m0 = 0; m0 < h_rows; m0 += BM) {
    const GridSrc<T> src{xb, ci, fp, f, rows, t0 - hb + m0, -hb,
                         p.s1, p.t1, slope};
    for (int n0 = 0; n0 < co; n0 += G::kBN)
      G::run(smem, src, p.w1, 9, p.ci_p, co, n0, co, vec_in,
             [=](int r, int n, auto& v) {
               constexpr int W = sizeof(v) / sizeof(float);
               const int hr = m0 + r;
               if (hr >= h_rows) return;
               const int pos = t0 - hb + hr;
               const bool inside = pos >= 0 && pos < rows && pos % fp < f;
               float s[W], t[W];
               load_f32<W>(s2 + n, s);
               load_f32<W>(t2 + n, t);
#pragma unroll
               for (int u = 0; u < W; ++u)
                 v[u] = inside ? lrelu(__fadd_rn(__fmul_rn(v[u], s[u]), t[u]),
                                       slope)
                               : 0.f;
               store_vals<T, W>(a2 + hr * ld + n, v);
             });
  }
  __syncthreads();

  const T* wsc = p.wsc;
  if (wsc != nullptr) {
    const T* bsc = wsc + static_cast<long long>(p.ci_p) * co;
    for (int m0 = 0; m0 < tm; m0 += BM) {
      const GridSrc<T> src{xb, ci, fp, f, rows, t0 + m0, 0,
                           nullptr, nullptr, 0.f};
      for (int n0 = 0; n0 < co; n0 += G::kBN)
        G::run(smem, src, wsc, 1, p.ci_p, co, n0, co, vec_in,
               [=](int r, int n, auto& v) {
                 constexpr int W = sizeof(v) / sizeof(float);
                 const int yr = m0 + r;
                 if (yr >= tm) return;
                 float b[W];
                 load_vals<T, W>(bsc + n, b);
#pragma unroll
                 for (int u = 0; u < W; ++u)
                   res[yr * ldr + n + u] = v[u] + b[u];
               });
    }
    __syncthreads();
  }

  for (int m0 = 0; m0 < tm; m0 += BM) {
    const SlabSrc<T> src{a2, ld, h_rows, m0 + hb, fp};
    for (int n0 = 0; n0 < co; n0 += G::kBN)
      G::run(smem, src, p.w2, 9, co, co, n0, co, vec_out,
             [=](int r, int n, auto& v) {
               constexpr int W = sizeof(v) / sizeof(float);
               const int yr = m0 + r;
               const int pos = t0 + yr;
               if (yr >= tm || pos >= rows) return;
               const int t = pos / fp, col = pos - t * fp;
               if (col >= f) return;
               const long long cell = static_cast<long long>(t) * f + col;
               if (wsc != nullptr) {
#pragma unroll
                 for (int u = 0; u < W; ++u) v[u] += res[yr * ldr + n + u];
               } else {
                 float o[W];
                 load_vals<T, W>(xb + cell * ci + n, o);  // ci == co
#pragma unroll
                 for (int u = 0; u < W; ++u) v[u] += o[u];
               }
               store_vals<T, W>(yb + cell * co + n, v);
             });
  }
}

template <typename T>
int launch(BlockArgs<T> p, int batch, cudaStream_t stream) {
  if (batch < 1 || p.t_len < 1 || p.f < 1 || p.ci < 1 || p.co < 1 ||
      p.tm < 1 || p.ci_p < p.ci || (p.wsc == nullptr && p.ci != p.co))
    return cudaErrorInvalidValue;
  const long long rows = static_cast<long long>(p.t_len) * (p.f + 1);
  if (rows > 0x7fffffffLL - 65536) return cudaErrorInvalidValue;
  const size_t h_rows = static_cast<size_t>(p.tm) + 2 * (p.f + 2);
  const size_t smem =
      STAGE_BYTES + h_rows * (p.co + row_pad<T>()) * sizeof(T) +
      (p.wsc ? static_cast<size_t>(p.tm) * (p.co + RES_PAD) * 4 : 0);
  const dim3 grid(static_cast<unsigned>((rows + p.tm - 1) / p.tm), batch);
  if constexpr (std::is_same<T, float>::value) {
    if (p.ci_p != p.ci) return cudaErrorInvalidValue;
    if (p.co > 64)
      return launch_with_smem(conv_block_kernel<T, 128>, grid, smem, stream,
                              p);
    return launch_with_smem(conv_block_kernel<T, 64>, grid, smem, stream, p);
  } else {
    if (p.co % 8 || p.ci_p % 8) return cudaErrorInvalidValue;
    if (p.co % 128 == 0)
      return launch_with_smem(conv_block_kernel<T, 128>, grid, smem, stream,
                              p);
    return launch_with_smem(conv_block_kernel<T, 64>, grid, smem, stream, p);
  }
}

template <typename T>
int block(const void* x, void* y, const void* w1, const void* w2,
          const void* wsc, const float* s1, const float* t1, const float* s2,
          const float* t2, int batch, int t_len, int f, int ci, int ci_p,
          int co, int tm, float slope, cudaStream_t stream) {
  BlockArgs<T> p{static_cast<const T*>(x),  static_cast<T*>(y),
                 static_cast<const T*>(w1), static_cast<const T*>(w2),
                 static_cast<const T*>(wsc), s1, t1, s2, t2,
                 t_len, f, ci, ci_p, co, tm, slope};
  return launch<T>(p, batch, stream);
}

}  // namespace

// x: [batch, t_len, f, ci]; y: [batch, t_len, f, co]; w1: [9*ci_p, co]
// (tap-major, then input channel, rows from ci up to ci_p zero); w2:
// [9*co, co]; wsc: [ci_p + 1, co], the 1x1 shortcut and its bias in the last
// row, or null for the identity (ci == co); s1, t1: [ci] and s2, t2: [co]
// float32 folded batch norms; tm: rows of the (t_len * (f + 1))-row stream
// per thread block. All of x, y, w1, w2, wsc float32 (bf16 = 0, ci_p = ci)
// or bfloat16 (bf16 = 1, co and ci_p multiples of 8). y must not alias x.
extern "C" int vf_conv_block_res(const void* x, void* y, const void* w1,
                                 const void* w2, const void* wsc,
                                 const float* s1, const float* t1,
                                 const float* s2, const float* t2, int batch,
                                 int t_len, int f, int ci, int ci_p, int co,
                                 int tm, float slope, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? block<__nv_bfloat16>(x, y, w1, w2, wsc, s1, t1, s2, t2, batch,
                                     t_len, f, ci, ci_p, co, tm, slope, s)
              : block<float>(x, y, w1, w2, wsc, s1, t1, s2, t2, batch, t_len,
                             f, ci, ci_p, co, tm, slope, s);
}
