// K9 conv_block_res: one ResUNet ConvBlockRes in one kernel,
// vf_conv_block_res.
//
//   a1  = lrelu(x*s1 + t1), 0 outside the signal, rounded to T
//   h1  = conv3x3(a1, W1)                          float32 sums
//   a2  = lrelu(h1*s2 + t2), 0 outside the signal, rounded to T
//   out = conv3x3(a2, W2) + (x @ Wsc + bsc  or  x), float32, rounded to T once
//
// on x [B, T, F, Ci] (channels last), zero 'same' padding in T and F, with
// (s, t) the folded eval-mode batch norms. T is float (FMA units, true
// float32, no TF32) or __nv_bfloat16 (wgmma, float32 accumulation). h1 is
// never rounded to T, and neither h1 nor a2 leaves the thread block.
//
// Replaces voicefixer_tpu/kernels/convblock.py::conv_block_res (:132,
// _block_kernel :52; Pallas, TPU), which the JAX package routes to only on
// request and only for blocks of at most 128 channels.
//
// Bound: operations (18*Co*(Ci + Co) FLOP against Ci + Co elements moved
// per pixel). The TPU kernel's one idea carries over: (T, F) is read as one
// stream of T*Fp rows, Fp = F + 1, so that tap (dt, df) is the row offset
// dt*Fp + df and a tap across an F edge lands on the absent column, which
// holds zero. Its padding to 128 lanes, im2col slab and VMEM planner do not.
// Design:
//   - Each thread block (one an SM) owns a run of `run` consecutive rows of
//     one batch row's stream and walks it (walk()) over two rings of rows in
//     shared memory: the a1 ring (x read from global memory once,
//     batch-normed, LeakyReLU'd and rounded once; BM + 2*hb rows, hb = Fp +
//     1 the reach of a tap) and the a2 ring (conv1's output after the second
//     batch norm and LeakyReLU; BM + 2*hb rows and the halo's rounding).
//     Both hold zeros at the absent column and outside the stream. Stream
//     row q sits in ring row (q - origin) mod ring, so a tap is an address
//     and a wrap one more compare.
//   - conv1 first covers the run's halo, then each step of at most BM rows
//     copies the a1 rows that conv1 reads, computes the a2 rows that its
//     outputs read (conv1) and the outputs (conv2). Both products read A in
//     place at the tap's row offset: nothing is staged per tap, and conv1's
//     halo is paid once a run, not once a tile.
//   - The column tile is the output width rounded up to the product's
//     granule (NP = 32, 64 or 128), its padding columns zero weights; K runs
//     over (tap, 16 channels) with Ci and Co rounded up to 16 in the packed
//     weights, so a K step never straddles a tap. The 1x1 shortcut is
//     conv2's last K steps, with A read from x in global memory; the identity
//     residual reads x in the epilogue.
//   - float32: the FMA product of resstack_f32.cu, TR x 8 outputs a thread
//     (256 threads: BM = TR * 2048 / NP rows), 16-byte shared reads of both
//     operands, the weights by cp.async into a ring of three K steps. The
//     a1 copies are cp.async too; each thread activates what it copied once
//     they landed, before the barrier that publishes the first K step.
//   - bfloat16: register-A wgmma m64nNPk16 as in resstack_wgmma.cu: A by
//     ldmatrix.x4 from the ring at the tap's row offset; the weights by TMA,
//     K-major (one 128-byte swizzled layout for every NP), into a ring of
//     64-deep stages that one producer thread keeps full against full/empty
//     mbarriers; two consumer warpgroups take a 64-row tile each (128 rows
//     a pass) and share every stage. mbar_wait traps after two seconds,
//     so a pipeline out of step fails the launch instead of hanging.
// x and out keep their dense [T, F, C] layout: the absent column exists only
// in the row arithmetic.

#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using vf::to_float;

constexpr int SMEM_LIMIT = 232448;

struct Args {
  const void* x;    // [batch, t_len, f, ci]
  void* y;          // [batch, t_len, f, co]
  const void* w1;   // float32: [9*cp1][np]; bfloat16: [np][9*cp1]
  const void* w2;   // float32: [9*cp2 (+ cp1)][np]; bfloat16: transposed
  const void* bsc;  // [co] in x's type, the shortcut's bias; null: identity
  const float* s1;  // [ci]
  const float* t1;
  const float* s2;  // [co]
  const float* t2;
  int t_len, f, ci, co;
  int cp1, cp2;     // ci, co rounded up to 16: the K of a tap
  int run;          // output rows of the stream a thread block owns
  int bm;           // rows of a step
  int tile;         // rows of a product's granule (float32: bm; bf16: 64)
  int front;        // a2 rows computed before the halo (see walk())
  int ring1, ring2; // rows of the a1 and a2 rings
  int stages;       // bfloat16: stages of the weight ring
  float slope;
};

__device__ __forceinline__ float lrelu(float v, float s) {
  return v > 0.f ? v : s * v;
}

// the plain version's batch norm: multiply, then add, each rounded
__device__ __forceinline__ float bn_act(float v, float sc, float sh,
                                        float slope) {
  return lrelu(__fadd_rn(__fmul_rn(v, sc), sh), slope);
}

// One batch row's stream: row q is pixel (q / fp, q % fp) of [t_len, f],
// and nothing when it lies at the absent column q % fp == f or outside.
struct Stream {
  int fp, f, rows;
  __device__ __forceinline__ bool inside(int q) const {
    return q >= 0 && q < rows && q % fp < f;
  }
  __device__ __forceinline__ long long pixel(int q) const {
    const int t = q / fp;
    return static_cast<long long>(t) * f + (q - t * fp);
  }
};

// tap j of a 3x3 convolution, (dt, df) = (j / 3 - 1, j % 3 - 1), as a row
// offset of the stream
__device__ __forceinline__ int tap_offset(int j, int fp) {
  return (j / 3 - 1) * fp + j % 3 - 1;
}

__device__ __forceinline__ int wrap(int r, int ring) {
  r %= ring;
  return r < 0 ? r + ring : r;
}

__host__ __device__ __forceinline__ int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// The walk of the run [s0, s1) that the producer and the consumers both
// follow: conv1(q0, rows) computes a2 rows [q0, q0 + rows), conv2(q0,
// rows) output rows; rows are whole tiles, at most bm. conv1 starts at
// origin2 = s0 - hb - front and first covers the halo, up to s0 + hb (the
// float32 front makes that a whole number of tiles: a2 runs hb rows ahead
// of the outputs; bfloat16's last halo tile leads further and saves
// conv1 rows at the run's end). Then each step computes the a2 rows that
// its outputs below s1 read, and the outputs. Rows of a last tile past s1
// are not stored, so what they read may be stale.
template <typename C1, typename C2>
__device__ __forceinline__ void walk(int s0, int s1, int hb, int origin2,
                                     int bm, int tile, C1 conv1, C2 conv2) {
  int a2_end = origin2;
  while (a2_end < s0 + hb) {
    const int c1 = min(bm, round_up(s0 + hb - a2_end, tile));
    conv1(a2_end, c1);
    a2_end += c1;
  }
  for (int y = s0; y < s1;) {
    const int c2 = min(bm, round_up(s1 - y, tile));
    const int need = min(y + c2, s1) + hb;
    if (a2_end < need) {
      const int c1 = min(bm, round_up(need - a2_end, tile));
      conv1(a2_end, c1);
      a2_end += c1;
    }
    conv2(y, c2);
    y += c2;
  }
}

// ------------------------------------------------------------- float32

namespace f32 {

constexpr int THREADS = 256;
constexpr int BK = 16;      // K of a step: 16 channels of one tap
constexpr int STAGES = 3;   // K steps in flight in the cp.async ring

// floats between ring rows: a warp's consecutive rows fall on other banks
__host__ __device__ constexpr int ld_of(int cp) { return cp + 4; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(hopper::smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(hopper::smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The thread tile of a product: TR rows (ty + NY*i) by 8 columns (4tx + j
// and 4tx + 4NX + j). A warp spans WX columns threads, so that its B reads
// take one wavefront and its A reads (32 / WX consecutive rows) one more.
template <int NP, int TR>
struct Tile {
  static constexpr int NX = NP / 8;
  static constexpr int NY = THREADS / NX;
  static constexpr int BM = TR * NY;
  static constexpr int WX = NX < 8 ? NX : 8;
  static constexpr int B_FLOATS = BK * NP;
};

// the first `cnt` (at least 1) of four consecutive floats; VEC: all four,
// 16-byte aligned
__device__ __forceinline__ void load4(const float* p, int cnt, bool vec,
                                      float (&v)[4]) {
  if (vec) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = j < cnt ? p[j] : 0.f;
  }
}

__device__ __forceinline__ void store4(float* p, int cnt, bool vec,
                                       const float (&v)[4]) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < cnt) p[j] = v[j];
  }
}

// channels c .. c + 3 of one row of x (c a multiple of 4), zero past ci
__device__ __forceinline__ float4 x_vec(const float* row, int c, int ci,
                                        bool vec) {
  if (vec)
    return c < ci ? *reinterpret_cast<const float4*>(row + c)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(c < ci ? row[c] : 0.f, c + 1 < ci ? row[c + 1] : 0.f,
                     c + 2 < ci ? row[c + 2] : 0.f,
                     c + 3 < ci ? row[c + 3] : 0.f);
}

__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// One K step: acc[i][j] += sum_k A[row i][k] * B[k][column j], A's four
// channels k4 .. k4 + 3 of row i from a(i, k4), B from pb (this thread's
// first column, rows NP floats apart).
template <int NP, int TR, typename A>
__device__ __forceinline__ void fma_step(float (&acc)[TR][8], const float* pb,
                                         A a) {
  constexpr int NX = Tile<NP, TR>::NX;
#pragma unroll
  for (int k4 = 0; k4 < BK; k4 += 4) {
    float4 av[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) av[i] = a(i, k4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 q0 = *reinterpret_cast<const float4*>(pb + (k4 + kk) * NP);
      const float4 q1 =
          *reinterpret_cast<const float4*>(pb + (k4 + kk) * NP + 4 * NX);
      const float bv[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float xv = lane_of(av[i], kk);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv, bv[j], acc[i][j]);
      }
    }
  }
}

// The product of the BM-row tile whose row 0 is stream row q0 with w
// ([steps*BK][NP]): K step it < 9*kc is tap it / kc, channels
// (it % kc)*BK + [0, BK), its A read in place from `ring` (stream row q in
// ring row (q - origin) mod ring_rows, `ld` floats apart); later steps are the
// 1x1 shortcut, channels of x read from global memory. Then epi(m, n, v)
// for tile row m, columns n .. n + 3. Starts with a barrier: what the
// previous product's epilogue wrote is visible and nobody reads the weight
// ring any more. pre() runs once, after this thread's copies of the first
// step (and any committed before) have landed and before the barrier that
// publishes them.
template <int NP, int TR, typename Pre, typename Epi>
__device__ __forceinline__ void product(
    float* wring, const float* __restrict__ w, int steps, int kc,
    const float* ring, int ld, int ring_rows, int origin, int q0,
    const Args& p, const Stream& st, const float* __restrict__ xb, Pre pre,
    Epi epi) {
  using TL = Tile<NP, TR>;
  constexpr int NX = TL::NX, NY = TL::NY, WX = TL::WX, XW = NX / WX;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = (warp % XW) * WX + lane % WX;
  const int ty = (warp / XW) * (32 / WX) + lane / WX;
  const int ring_steps = 9 * kc;
  const bool vec_x = p.ci % 4 == 0;

  auto load = [&](int it) {
    const float* src = w + static_cast<long long>(it) * TL::B_FLOATS;
    float* dst = wring + (it % STAGES) * TL::B_FLOATS;
#pragma unroll
    for (int e = tid; e < TL::B_FLOATS / 4; e += THREADS)
      cp_async16(dst + 4 * e, src + 4 * e, true);
  };

  float acc[TR][8];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  int a_off[TR];
  long long x_off[TR];

  __syncthreads();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s);
    cp_commit();
  }
  for (int it = 0; it < steps; ++it) {
    // this thread's copies of step it have landed; the stage it overwrites
    // below was last read in step it - 1, before this barrier
    cp_wait<STAGES - 2>();
    if (it == 0) pre();
    __syncthreads();
    if (it + STAGES - 1 < steps) load(it + STAGES - 1);
    cp_commit();
    const float* pb = wring + (it % STAGES) * TL::B_FLOATS + 4 * tx;
    if (it < ring_steps) {
      const int tap = it / kc, c0 = (it - tap * kc) * BK;
      if (c0 == 0) {  // a new tap: where this thread's rows sit in the ring
        const int base = q0 + ty + tap_offset(tap, st.fp) - origin;
#pragma unroll
        for (int i = 0; i < TR; ++i)
          a_off[i] = wrap(base + NY * i, ring_rows) * ld;
      }
      const float* pa = ring + c0;
      fma_step<NP, TR>(acc, pb, [&](int i, int k4) {
        return *reinterpret_cast<const float4*>(pa + a_off[i] + k4);
      });
    } else {
      const int c0 = (it - ring_steps) * BK;
      if (it == ring_steps) {  // rows outside read pixel 0: never stored
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const int q = q0 + ty + NY * i;
          x_off[i] = st.inside(q) ? st.pixel(q) * p.ci : 0;
        }
      }
      fma_step<NP, TR>(acc, pb, [&](int i, int k4) {
        return x_vec(xb + x_off[i], c0 + k4, p.ci, vec_x);
      });
    }
  }
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      float v[4] = {acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                    acc[i][4 * g + 3]};
      epi(ty + NY * i, 4 * tx + g * 4 * NX, v);
    }
}

template <int NP, int TR>
__global__ void __launch_bounds__(THREADS, 1)
conv_block_f32_kernel(const Args p) {
  using TL = Tile<NP, TR>;
  constexpr int BM = TL::BM;
  extern __shared__ __align__(16) float smem[];
  const int ld1 = ld_of(p.cp1), ld2 = ld_of(p.cp2);
  float* wring = smem;                           // [STAGES][BK][NP]
  float* a1 = smem + STAGES * TL::B_FLOATS;      // [ring1][ld1]
  float* a2 = a1 + p.ring1 * ld1;                // [ring2][ld2]
  const Stream st{p.f + 1, p.f, p.t_len * (p.f + 1)};
  const int hb = p.f + 2;
  const int s0 = blockIdx.x * p.run;
  const int s1 = min(s0 + p.run, st.rows);
  const int origin2 = s0 - hb - p.front;  // first a2 row of the run
  const int origin1 = origin2 - hb;       // first a1 row
  const long long pixels = static_cast<long long>(p.t_len) * p.f;
  const float* xb = static_cast<const float*>(p.x) + blockIdx.y * pixels * p.ci;
  float* yb = static_cast<float*>(p.y) + blockIdx.y * pixels * p.co;
  const float* w1 = static_cast<const float*>(p.w1);
  const float* w2 = static_cast<const float*>(p.w2);
  const float* bsc = static_cast<const float*>(p.bsc);
  const int kc1 = p.cp1 / BK, kc2 = p.cp2 / BK;
  const int steps1 = 9 * kc1;
  const int steps2 = 9 * kc2 + (bsc ? kc1 : 0);
  const bool vec_x = p.ci % 4 == 0;
  const bool vec_y = p.co % 4 == 0;
  const int ci = p.ci, co = p.co;
  const float slope = p.slope;

  // a1 rows [q0, q0 + cnt): by cp.async, zeros outside the stream and past
  // ci; then, by the same thread once its copies landed, the batch norm and
  // LeakyReLU (zero where the copy was)
  auto a1_rows = [&](int q0, int cnt, bool activate) {
    const int per = vec_x ? p.cp1 / 4 : p.cp1;
    const int width = vec_x ? 4 : 1;
    for (int e = threadIdx.x; e < cnt * per; e += THREADS) {
      const int r = e / per, c = (e - r * per) * width;
      const int q = q0 + r;
      const bool in = st.inside(q);
      float* dst = a1 + wrap(q - origin1, p.ring1) * ld1 + c;
      if (!activate) {
        const bool ok = in && c < ci;
        const float* src = ok ? xb + st.pixel(q) * ci + c : xb;
        if (vec_x) cp_async16(dst, src, ok);
        else cp_async4(dst, src, ok);
      } else if (vec_x) {
        float4 v = *reinterpret_cast<float4*>(dst);
        const bool ok = in && c < ci;
        v.x = ok ? bn_act(v.x, p.s1[c], p.t1[c], slope) : 0.f;
        v.y = ok ? bn_act(v.y, p.s1[c + 1], p.t1[c + 1], slope) : 0.f;
        v.z = ok ? bn_act(v.z, p.s1[c + 2], p.t1[c + 2], slope) : 0.f;
        v.w = ok ? bn_act(v.w, p.s1[c + 3], p.t1[c + 3], slope) : 0.f;
        *reinterpret_cast<float4*>(dst) = v;
      } else {
        *dst = in && c < ci ? bn_act(*dst, p.s1[c], p.t1[c], slope) : 0.f;
      }
    }
  };

  int a1_end = origin1;  // a1 rows [origin1, a1_end) are in the ring
  // conv1 over a2 rows [q0, q0 + BM): first the a1 rows it reads that the
  // ring lacks, by cp.async (activated by the product's first K step)
  auto conv1 = [&](int q0, int) {
    const int fresh = a1_end, cnt = q0 + BM + hb - a1_end;
    __syncthreads();  // the ring rows about to be overwritten are read no more
    a1_rows(fresh, cnt, false);
    cp_commit();
    a1_end += cnt;
    product<NP, TR>(
        wring, w1, steps1, kc1, a1, ld1, p.ring1, origin1, q0, p, st, xb,
        [&] { a1_rows(fresh, cnt, true); },
        [&](int m, int n, float (&v)[4]) {
          if (n >= p.cp2) return;  // past the a2 ring's columns
          const int q = q0 + m;
          const bool in = st.inside(q);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            v[u] = in && n + u < co
                       ? bn_act(v[u], p.s2[n + u], p.t2[n + u], slope)
                       : 0.f;
          *reinterpret_cast<float4*>(a2 + wrap(q - origin2, p.ring2) * ld2 +
                                     n) = make_float4(v[0], v[1], v[2], v[3]);
        });
  };
  // conv2 (and the shortcut) over output rows [o0, o0 + BM)
  auto conv2 = [&](int o0, int) {
    product<NP, TR>(
        wring, w2, steps2, kc2, a2, ld2, p.ring2, origin2, o0, p, st, xb,
        [] {},
        [&](int m, int n, float (&v)[4]) {
          const int q = o0 + m;
          if (q >= s1 || n >= co || !st.inside(q)) return;
          const long long pix = st.pixel(q);
          float r[4];
          if (bsc) load4(bsc + n, co - n, vec_y, r);
          else load4(xb + pix * ci + n, co - n, vec_y, r);  // ci == co
#pragma unroll
          for (int u = 0; u < 4; ++u) r[u] += v[u];
          store4(yb + pix * co + n, co - n, vec_y, r);
        });
  };
  walk(s0, s1, hb, origin2, BM, BM, conv1, conv2);
}

size_t smem_bytes(const Args& p, int np) {
  return sizeof(float) *
         (static_cast<size_t>(STAGES) * BK * np +
          static_cast<size_t>(p.ring1) * ld_of(p.cp1) +
          static_cast<size_t>(p.ring2) * ld_of(p.cp2));
}

template <int NP, int TR>
int launch(const Args& p, int batch, int runs, cudaStream_t stream) {
  if (p.bm != Tile<NP, TR>::BM || p.tile != p.bm) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(p, NP);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      conv_block_f32_kernel<NP, TR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  conv_block_f32_kernel<NP, TR>
      <<<dim3(runs, batch), THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

int dispatch(const Args& p, int np, int tr, int batch, int runs,
             cudaStream_t s) {
  if (tr == 8) {
    if (np == 32) return launch<32, 8>(p, batch, runs, s);
    if (np == 64) return launch<64, 8>(p, batch, runs, s);
    if (np == 128) return launch<128, 8>(p, batch, runs, s);
  } else if (tr == 4) {
    if (np == 32) return launch<32, 4>(p, batch, runs, s);
    if (np == 64) return launch<64, 4>(p, batch, runs, s);
    if (np == 128) return launch<128, 4>(p, batch, runs, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace f32

// ------------------------------------------------------------ bfloat16

namespace wg {

constexpr int CONSUMERS = 2;                 // warpgroups that multiply
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int ROWS = 64;                     // rows of a warpgroup's tile
constexpr int G = ROWS * CONSUMERS;          // rows of a pass
constexpr int KS = 4;                        // wgmma k-steps of a stage
constexpr int BK = 16 * KS;                  // K rows of a stage
constexpr int DEPTH = 2;                     // stages in flight at once:
                                             // the ring needs as many

// bf16 between ring rows: 16 bytes of padding put ldmatrix's eight rows on
// eight bank groups
__host__ __device__ constexpr int ld_of(int cp) { return cp + 8; }

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(128 * CONSUMERS) : "memory");
}

__device__ __forceinline__ uint32_t bits(bf16 v) {
  return *reinterpret_cast<const uint16_t*>(&v);
}

// channels c, c + 1 of one row of x as a bf16 pair, zero past ci
__device__ __forceinline__ uint32_t x_pair(const bf16* row, int c, int ci) {
  if (ci % 2 == 0)
    return c < ci ? *reinterpret_cast<const uint32_t*>(row + c) : 0u;
  return (c < ci ? bits(row[c]) : 0u) |
         (c + 1 < ci ? bits(row[c + 1]) << 16 : 0u);
}

template <int NP>
__global__ void __launch_bounds__(THREADS, 1)
conv_block_wgmma_kernel(const __grid_constant__ CUtensorMap map_w1,
                        const __grid_constant__ CUtensorMap map_w2,
                        const Args p) {
  constexpr int STAGE_BYTES = BK * NP * 2;  // a [NP][64] box
  extern __shared__ uint8_t smem_raw[];
  uint8_t* wring = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023))
                               & 1023);
  const int stages = p.stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(wring + stages * STAGE_BYTES);
  uint64_t* empty = full + stages;
  const int ld1 = ld_of(p.cp1), ld2 = ld_of(p.cp2);
  bf16* a1 = reinterpret_cast<bf16*>(empty + stages);  // [ring1][ld1]
  bf16* a2 = a1 + p.ring1 * ld1;                       // [ring2][ld2]
  // the folded batch norms, zero past ci and co: [cp1], [cp1], [cp2], [cp2]
  float* bn_s1 = reinterpret_cast<float*>(a2 + p.ring2 * ld2);
  float* bn_t1 = bn_s1 + p.cp1;
  float* bn_s2 = bn_t1 + p.cp1;
  float* bn_t2 = bn_s2 + p.cp2;
  const Stream st{p.f + 1, p.f, p.t_len * (p.f + 1)};
  const int hb = p.f + 2;
  const int s0 = blockIdx.x * p.run;
  const int s1 = min(s0 + p.run, st.rows);
  const int origin2 = s0 - hb - p.front;  // first a2 row of the run
  const int origin1 = origin2 - hb;       // first a1 row
  const int bm = p.bm;
  const int ktot1 = 9 * p.cp1;
  const int ktot2 = 9 * p.cp2 + (p.bsc ? p.cp1 : 0);
  const int n_st1 = (ktot1 + BK - 1) / BK, n_st2 = (ktot2 + BK - 1) / BK;
  // passes over the 64-row tiles of a product of `rows` rows
  auto passes = [](int rows) { return (rows / ROWS + CONSUMERS - 1) / CONSUMERS; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS * 4);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == CONSUMERS) {
    // producer: one thread starts every load, in the consumers' order; the
    // tensor map reads K past ktot as zeros
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 128 * CONSUMERS) {
      int s = 0, it = 0;
      uint32_t phase = 0;
      auto feed = [&](const CUtensorMap* map, int n_st, int rows) {
        for (int ps = passes(rows); ps > 0; --ps)
          for (int k = 0; k < n_st; ++k) {
            if (it >= stages) hopper::mbar_wait(&empty[s], phase ^ 1);
            hopper::mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
            hopper::tma_load_3d(wring + s * STAGE_BYTES, map, &full[s],
                                k * BK, 0, 0);
            if (++s == stages) s = 0, phase ^= 1;
            ++it;
          }
      };
      walk(s0, s1, hb, origin2, bm, ROWS,
           [&](int, int rows) { feed(&map_w1, n_st1, rows); },
           [&](int, int rows) { feed(&map_w2, n_st2, rows); });
    }
    return;
  }

  hopper::setmaxnreg_inc<232>();
  const int tid = threadIdx.x;
  const int lane = tid % 32, wq = (tid % 128) / 32;
  const int ci = p.ci, co = p.co;
  const float slope = p.slope;
  const long long pixels = static_cast<long long>(p.t_len) * p.f;
  const bf16* xb = static_cast<const bf16*>(p.x) + blockIdx.y * pixels * ci;
  bf16* yb = static_cast<bf16*>(p.y) + blockIdx.y * pixels * co;
  const bf16* bsc = static_cast<const bf16*>(p.bsc);

  int s = 0;
  uint32_t phase = 0;
  auto release = [&](int stage) {
    if (lane == 0) hopper::mbar_arrive(&empty[stage]);
  };

  // The 64-row tiles of rows [q0, q0 + rows), two a pass, each pass against
  // every stage of one weight matrix (ktot K rows: 9 taps of cp channels
  // from `ring`, then for conv2 with a shortcut cp1 channels of x); then
  // epi(t0, acc) with t0 this warpgroup's first tile row. The accumulators
  // live in one pass only and are fenced before its first wgmma and after
  // its last wait, so that ptxas keeps the wgmmas pipelined (nothing but a
  // wgmma defines them in between). A warpgroup without a
  // tile in a pass still takes and hands back every stage.
  auto product = [&](int q0, int rows, int n_st, int ktot, int cp,
                     const bf16* ring, int ld, int ring_rows, int origin,
                     auto epi) {
    const int ring_k = 9 * cp;
    const int tiles = rows / ROWS;
    for (int ps = 0; ps < passes(rows); ++ps) {
      const int ti = ps * CONSUMERS + wgi;
      if (ti >= tiles) {
        for (int stg = 0; stg < n_st; ++stg) {
          hopper::mbar_wait(&full[s], phase);
          release(s);
          if (++s == stages) s = 0, phase ^= 1;
        }
        continue;
      }
      const int t0 = q0 + ti * ROWS;
      float acc[NP / 2];
#pragma unroll
      for (int q = 0; q < NP / 2; ++q) {
        acc[q] = 0.f;
        hopper::fence_operand(acc[q]);
      }
      // this lane's ldmatrix row at the centre tap and its column half
      const int cslot = wrap(t0 + 16 * wq + lane % 16 - origin, ring_rows);
      const bf16* col = ring + 8 * (lane / 16);
      // this lane's A fragment rows for the shortcut's K steps
      long long xo[2] = {0, 0};
      if (ktot > ring_k) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = t0 + 16 * wq + lane / 4 + 8 * h;
          xo[h] = st.inside(q) ? st.pixel(q) * ci : 0;  // else never stored
        }
      }
      // The k-steps in order: taps 0..8 of cp channels from the ring, then
      // (tap 9) the shortcut's cp1 channels of x, then zeros against the
      // map's zero fill. The ring row of this lane at the current tap moves
      // once a tap, not once a k-step: no division on the k-step's path.
      auto tap_row = [&](int tap) {
        const int r = cslot + tap_offset(tap, st.fp);
        return (r < 0 ? r + ring_rows : (r >= ring_rows ? r - ring_rows : r))
               * ld;
      };
      int a_tap = 0, a_c0 = 0, a_row = tap_row(0);
      const int sc_width = ktot - ring_k;  // 0 or cp1
      auto load_a = [&](uint32_t (&r)[4]) {
        if (a_tap < 9) {
          hopper::ldmatrix_x4(r, col + a_row + a_c0);
        } else if (a_c0 < sc_width) {
          const int c = a_c0 + 2 * (lane % 4);
          r[0] = x_pair(xb + xo[0], c, ci);
          r[1] = x_pair(xb + xo[1], c, ci);
          r[2] = x_pair(xb + xo[0], c + 8, ci);
          r[3] = x_pair(xb + xo[1], c + 8, ci);
        } else {
          r[0] = r[1] = r[2] = r[3] = 0u;
        }
        a_c0 += 16;
        if (a_tap < 9 && a_c0 == cp) {
          a_c0 = 0;
          if (++a_tap < 9) a_row = tap_row(a_tap);
        }
      };
      // The stages of the pass, DEPTH of them in flight: stage stg loads
      // its A into fragment set stg % DEPTH and issues its KS wgmmas; then
      // the stage issued DEPTH - 1 before it is retired (wait_group) and its
      // slot handed back. Every stage issues all KS wgmmas (a last stage's
      // k-steps past K multiply zeros): no wgmma sits under a branch.
      uint32_t frag[DEPTH][KS][4];
      int slot[DEPTH];
      for (int base = 0; base < n_st; base += DEPTH) {
#pragma unroll
        for (int d = 0; d < DEPTH; ++d) {
          const int stg = base + d;
          if (stg >= n_st) break;
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) load_a(frag[d][kk]);
          hopper::mbar_wait(&full[s], phase);
          hopper::wgmma_fence();
          const uint64_t db =
              hopper::smem_desc_sw128(wring + s * STAGE_BYTES, 16, 1024);
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)
            hopper::wgmma_m64k16_bf16_rs_kmajor<NP>(
                acc, frag[d][kk], hopper::desc_advance(db, kk * 32),
                stg > 0 || kk > 0);
          hopper::wgmma_commit();
          slot[d] = s;
          if (++s == stages) s = 0, phase ^= 1;
          if (stg >= DEPTH - 1) {
            const int old = (d + 1) % DEPTH;  // set of stg - DEPTH + 1
            hopper::wgmma_wait<DEPTH - 1>();
#pragma unroll
            for (int kk = 0; kk < KS; ++kk)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                hopper::fence_operand(frag[old][kk][q]);
            release(slot[old]);
          }
        }
      }
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int q = 0; q < NP / 2; ++q) hopper::fence_operand(acc[q]);
#pragma unroll
      for (int d = 0; d < DEPTH; ++d) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q) hopper::fence_operand(frag[d][kk][q]);
        // the last stage that used set d, if it is not handed back yet
        const int last = n_st - 1 - ((n_st - 1 - d) % DEPTH + DEPTH) % DEPTH;
        if (last >= 0 && last >= n_st - DEPTH + 1) release(slot[d]);
      }
      epi(t0, acc);
    }
  };

  for (int c = tid; c < p.cp1; c += 128 * CONSUMERS) {
    bn_s1[c] = c < ci ? p.s1[c] : 0.f;
    bn_t1[c] = c < ci ? p.t1[c] : 0.f;
  }
  for (int c = tid; c < p.cp2; c += 128 * CONSUMERS) {
    bn_s2[c] = c < co ? p.s2[c] : 0.f;
    bn_t2[c] = c < co ? p.t2[c] : 0.f;
  }

  // a1 rows [q0, q0 + cnt), a row a thread: x, the batch norm and
  // LeakyReLU, rounded once; zeros outside the stream and past ci. Four
  // 16-byte loads are in flight before any is used.
  auto a1_rows = [&](int q0, int cnt) {
    const int per = p.cp1 / 8;
    for (int r = tid; r < cnt; r += 128 * CONSUMERS) {
      const int q = q0 + r;
      const bool in = st.inside(q);
      const bf16* src = xb + (in ? st.pixel(q) * ci : 0);
      bf16* dst = a1 + wrap(q - origin1, p.ring1) * ld1;
      for (int v0 = 0; v0 < per; v0 += 4) {
        uint4 raw[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = (v0 + u) * 8;
          raw[u] = make_uint4(0, 0, 0, 0);
          if (!in || v0 + u >= per || c >= ci) continue;
          if (ci % 8 == 0) {
            raw[u] = *reinterpret_cast<const uint4*>(src + c);
          } else {
            bf16* h = reinterpret_cast<bf16*>(&raw[u]);
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (c + j < ci) h[j] = src[c + j];
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = (v0 + u) * 8;
          if (v0 + u >= per) break;
          const bf16* h = reinterpret_cast<const bf16*>(&raw[u]);
          uint4 out;
          __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 sc =
                *reinterpret_cast<const float2*>(bn_s1 + c + 2 * j);
            const float2 sh =
                *reinterpret_cast<const float2*>(bn_t1 + c + 2 * j);
            o[j] = __floats2bfloat162_rn(
                in ? bn_act(to_float(h[2 * j]), sc.x, sh.x, slope) : 0.f,
                in ? bn_act(to_float(h[2 * j + 1]), sc.y, sh.y, slope)
                   : 0.f);
          }
          *reinterpret_cast<uint4*>(dst + c) = out;
        }
      }
    }
  };

  int a1_end = origin1;  // a1 rows [origin1, a1_end) are in the ring
  // conv1 over a2 rows [q0, q0 + rows): first the a1 rows it reads that the
  // ring lacks
  auto conv1 = [&](int q0, int rows) {
    consumer_sync();  // the ring rows about to be overwritten are read no more
    a1_rows(a1_end, q0 + rows + hb - a1_end);
    a1_end = q0 + rows + hb;
    consumer_sync();
    product(q0, rows, n_st1, ktot1, p.cp1, a1, ld1, p.ring1, origin1,
            [&](int t0, const float(&acc)[NP / 2]) {
              // columns past co: zero weights and a zero batch norm
              const int r0 = t0 + 16 * wq + lane / 4;
              const int slot0 = wrap(r0 - origin2, p.ring2);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int q = r0 + 8 * h;
                const bool in = st.inside(q);
                const int sl = slot0 + 8 * h;
                bf16* row = a2 + (sl >= p.ring2 ? sl - p.ring2 : sl) * ld2;
#pragma unroll
                for (int j = 0; j < NP / 8; ++j) {
                  const int n = 8 * j + 2 * (lane % 4);
                  if (n >= p.cp2) continue;
                  const float2 sc = *reinterpret_cast<const float2*>(bn_s2 + n);
                  const float2 sh = *reinterpret_cast<const float2*>(bn_t2 + n);
                  *reinterpret_cast<__nv_bfloat162*>(row + n) =
                      __floats2bfloat162_rn(
                          in ? bn_act(acc[4 * j + 2 * h], sc.x, sh.x, slope)
                             : 0.f,
                          in ? bn_act(acc[4 * j + 2 * h + 1], sc.y, sh.y,
                                      slope)
                             : 0.f);
                }
              }
            });
  };
  // conv2 (and the shortcut) over output rows [o0, o0 + rows)
  auto conv2 = [&](int o0, int rows) {
    consumer_sync();  // a2 is whole before conv2 reads it
    product(o0, rows, n_st2, ktot2, p.cp2, a2, ld2, p.ring2, origin2,
            [&](int t0, const float(&acc)[NP / 2]) {
      const int r0 = t0 + 16 * wq + lane / 4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = r0 + 8 * h;
        if (q >= s1 || !st.inside(q)) continue;
        const long long pix = st.pixel(q);
        const bf16* res = bsc ? bsc : xb + pix * ci;  // ci == co
        // every residual load of the row in flight before the stores
        __nv_bfloat162 r[NP / 8];
#pragma unroll
        for (int j = 0; j < NP / 8; ++j) {
          const int n = 8 * j + 2 * (lane % 4);
          if (n < co)  // co is even: n + 1 < co too
            r[j] = *reinterpret_cast<const __nv_bfloat162*>(res + n);
        }
#pragma unroll
        for (int j = 0; j < NP / 8; ++j) {
          const int n = 8 * j + 2 * (lane % 4);
          if (n >= co) continue;
          const float2 rf = __bfloat1622float2(r[j]);
          *reinterpret_cast<__nv_bfloat162*>(yb + pix * co + n) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h] + rf.x,
                                    acc[4 * j + 2 * h + 1] + rf.y);
        }
      }
    });
  };
  walk(s0, s1, hb, origin2, bm, ROWS, conv1, conv2);
}

size_t smem_bytes(const Args& p, int np, int stages) {
  return 1024 + static_cast<size_t>(stages) * (BK * np * 2 + 16) +
         2 * (static_cast<size_t>(p.ring1) * ld_of(p.cp1) +
              static_cast<size_t>(p.ring2) * ld_of(p.cp2)) +
         8 * (p.cp1 + p.cp2);
}

template <int NP>
int launch(const Args& p, int batch, int runs, cudaStream_t stream) {
  // w [NP][ktot] (K contiguous) in boxes of 64 K x NP rows; K past ktot
  // reads as zeros
  CUtensorMap m1, m2;
  const int ktot1 = 9 * p.cp1, ktot2 = 9 * p.cp2 + (p.bsc ? p.cp1 : 0);
  int rc = hopper::encode_bf16_3d(&m1, p.w1, ktot1, NP, 1, BK, NP, 1);
  if (rc != cudaSuccess) return rc;
  rc = hopper::encode_bf16_3d(&m2, p.w2, ktot2, NP, 1, BK, NP, 1);
  if (rc != cudaSuccess) return rc;
  const size_t smem = smem_bytes(p, NP, p.stages);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      conv_block_wgmma_kernel<NP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  conv_block_wgmma_kernel<NP>
      <<<dim3(runs, batch), THREADS, smem, stream>>>(m1, m2, p);
  return cudaGetLastError();
}

int dispatch(const Args& p, int np, int batch, int runs, cudaStream_t s) {
  if (p.co % 8 || p.bm % G || p.tile != ROWS || p.stages < DEPTH)
    return cudaErrorInvalidValue;
  if (np == 32) return launch<32>(p, batch, runs, s);
  if (np == 64) return launch<64>(p, batch, runs, s);
  if (np == 128) return launch<128>(p, batch, runs, s);
  return cudaErrorInvalidValue;
}

}  // namespace wg

}  // namespace

// x: [batch, t_len, f, ci]; y: [batch, t_len, f, co], not aliasing x. The
// weights are packed by kernels/convblock.py::pack_weights for the product
// width np (32, 64 or 128, at least co) and K of 16-channel steps: float32
// w1 [9*cp1][np], w2 [9*cp2 (+ cp1 shortcut rows)][np]; bfloat16 the same
// transposed ([np][K], K contiguous); cp1, cp2 = ci, co rounded up to 16,
// rows and columns past ci, co zero. bsc: [co] shortcut bias in x's type, or
// null for the identity (ci == co). s1, t1: [ci], s2, t2: [co] float32
// folded batch norms. run: output rows of the (t_len * (f + 1))-row stream a
// thread block owns; bm: rows of a step (float32: tr * 2048 / np; bfloat16:
// a multiple of 128); tr: float32 rows a thread (8 or 4); stages: bfloat16
// weight ring stages. Returns cudaErrorInvalidValue for arguments it does
// not take, rings that do not fit shared memory included.
extern "C" int vf_conv_block_res(const void* x, void* y, const void* w1,
                                 const void* w2, const void* bsc,
                                 const float* s1, const float* t1,
                                 const float* s2, const float* t2, int batch,
                                 int t_len, int f, int ci, int co, int np,
                                 int run, int bm, int tr, int stages,
                                 float slope, int bf16, void* stream) {
  if (batch < 1 || batch > 65535 || t_len < 1 || f < 1 || ci < 1 ||
      ci > 128 || co < 1 || co > np || run < 1 || bm < 1 ||
      (bsc == nullptr && ci != co))
    return cudaErrorInvalidValue;
  const long long rows = static_cast<long long>(t_len) * (f + 1);
  if (rows + 2LL * bm + 8LL * (f + 2) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  Args p{x, y, w1, w2, bsc, s1, t1, s2, t2, t_len, f, ci, co};
  p.cp1 = (ci + 15) / 16 * 16;
  p.cp2 = (co + 15) / 16 * 16;
  p.run = run;
  p.bm = bm;
  const int hb = f + 2;
  p.tile = bf16 ? wg::ROWS : bm;
  // float32: conv1 starts early enough that the halo is whole tiles
  p.front = bf16 ? 0 : round_up(2 * hb, bm) - 2 * hb;
  p.ring1 = bm + 2 * hb;
  p.ring2 = bm + round_up(2 * hb + p.front, p.tile) - p.front;
  p.stages = stages;
  p.slope = slope;
  const long long runs = (rows + run - 1) / run;
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? wg::dispatch(p, np, batch, static_cast<int>(runs), s)
              : f32::dispatch(p, np, tr, batch, static_cast<int>(runs), s);
}
