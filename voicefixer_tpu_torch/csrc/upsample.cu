// One vocoder upsample stage: y = ConvTranspose1d(x + sin(x)), kernel 2s,
// stride s, padding p = s//2 + s%2, output padding s%2. Without the pre-pass
// (residual = 0) the product reads x itself: BigVGAN's upsamples, kernel 2s
// and padding s/2 at even s, the same geometry with no activation in front.
//
// Replaces voicefixer_tpu/kernels/upsample.py::upsample (Pallas, TPU).
// With kernel 2s every output sample is the sum of two polyphase taps:
//   z[q*s + rho] = a[q] @ W[rho] + a[q-1] @ W[rho+s],  a = x + sin(x)
//   y[j] = z[p + j] + bias,  j in [0, T*s)
// with a[-1] = a[T] = 0. Per batch row that is one GEMM: rows q in [0, T],
// K = 2*Cin with A[q] = [a[q] | a[q-1]], N = s*Cout with
// B = [W[rho]; W[rho+s]] side by side over rho. Two facts shape the design:
//   - A is never built: its second half is `a` one row up, so a K step of
//     the second half loads the same array at row q0 - 1, and rows -1 and T
//     read as zeros;
//   - C is y, shifted: row q of C is the run of s*Cout elements of y that
//     starts at (q*s - p)*Cout, so the epilogue is a row-major store under
//     one mask on the flat index.
//
// Bound: operations at the main path's shapes (2*T*s*2Cin*Cout FLOP, 121
// GFLOP per 30 s chunk over the two stages, against 143 MB in bfloat16).
// A pre-pass computes a = x + sin(x) in float32, rounded to the storage type
// as the TPU kernel does, once into a scratch buffer the size of x (every
// block of the product reads each a row once per phase and column block;
// computing sin there cost more than the product itself).
//
// bfloat16 (production): wgmma m64n128k16 with float32 accumulators on
// tiles that TMA loads (hopper.cuh). A block owns 128 rows of q, 128
// output channels and one phase rho: two consumer warpgroups of 64 rows
// each, 64 accumulator registers a thread, and one producer thread that
// keeps a ring of four (A 128x64, B 64x128) stages, 32 KB each, in flight
// against full/empty mbarriers; setmaxnreg moves the producer warpgroup's
// registers to the consumers. 128 x 128 and not 128 x 256: Cout is 512 or
// 256, one phase a block keeps every store row contiguous, and 128 KB of
// ring plus 64 accumulators leave room for one block an SM either way,
// while the narrower tile gives stage 0 (24 row tiles) 672 blocks for 132
// SMs instead of 336. A comes from a 3-D map over a [B, T, Cin], so that
// row -1 of batch b is out of bounds (zeros) and not batch b-1's last row;
// B from a 3-D map over w [2s, Cin, Cout] as it lies, one box per 64
// columns, multiplied N-major through the descriptor's transpose bit: a
// ragged Cin or Cout never runs into the next tap, and nothing is packed.
// The s * Cout/128 blocks that share an A tile are neighbours in the grid,
// and both operands stay in L2. The epilogue adds the bias in float32,
// rounds once and writes each output sample exactly once.
//
// float32 (parity): true float32 on the FMA units, no tensor-core
// instruction. A 128 x 128 x 16 tile, 8 x 8 outputs a thread in two 4-wide
// groups per axis, every shared-memory read a 16-byte one (A along K, B
// along N), three stages filled by cp.async so that loads overlap the FMAs,
// the same GEMM view and shifted store. Channel counts that are multiples
// of 4 copy 16 bytes at a time; any other count copies element by element.
//
// The TPU kernel's 128-lane padding of Cout = 64, its VMEM plan and its
// output-channel blocking are gone.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------- bfloat16

namespace tc {

constexpr int BM = 128;   // rows q a block
constexpr int BN = 128;   // output channels a block
constexpr int BK = 64;    // K step: one 128-byte swizzled row
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BOX_BYTES = BK * 64 * 2;  // 64 columns of the B tile
constexpr int STAGE_BYTES = A_BYTES + 2 * B_BOX_BYTES;
constexpr int CONSUMER_WARPS = 8;
constexpr int THREADS = 384;  // two consumer warpgroups, one producer
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;

__global__ void __launch_bounds__(THREADS, 1)
upsample_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_w,
                      const bf16* __restrict__ bias, bf16* __restrict__ y,
                      int n_in, int cin, int cout, int scale, int pad) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzle is a function of the address: tiles start on 1024 bytes
  uint8_t* tiles = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023))
                               & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int rho = blockIdx.x % scale;
  const int n0 = (blockIdx.x / scale) * BN;
  const int q0 = blockIdx.y * BM;
  const int b = blockIdx.z;
  const int k_half = (cin + BK - 1) / BK;  // K steps per half of A
  const int n_iter = 2 * k_half;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread starts every load
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES)
          hopper::mbar_wait(&empty[s], (it / STAGES - 1) & 1);
        const int half = it / k_half;
        const int kc = (it % k_half) * BK;
        const int tap = rho + half * scale;
        uint8_t* st = tiles + s * STAGE_BYTES;
        hopper::mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        // k < Cin reads a[q], k >= Cin reads a[q-1]
        hopper::tma_load_3d(st, &map_a, &full[s], kc, q0 - half, b);
        hopper::tma_load_3d(st + A_BYTES, &map_w, &full[s], n0, kc, tap);
        hopper::tma_load_3d(st + A_BYTES + B_BOX_BYTES, &map_w, &full[s],
                            n0 + 64, kc, tap);
      }
    }
  } else {
    hopper::setmaxnreg_inc<232>();
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x % 128) / 32;
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;

    for (int it = 0; it < n_iter; ++it) {
      const int s = it % STAGES;
      hopper::mbar_wait(&full[s], (it / STAGES) & 1);
      const uint8_t* st = tiles + s * STAGE_BYTES;
      // A: K-major, this warpgroup's 64 rows; B: N-major, two 64-column
      // boxes 8192 bytes apart, eight k to a 1024-byte group
      const uint64_t da = hopper::smem_desc_sw128(st + wg * 64 * 128, 16,
                                                  1024);
      const uint64_t db = hopper::smem_desc_sw128(st + A_BYTES, B_BOX_BYTES,
                                                  1024);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        hopper::wgmma_m64n128k16_bf16_tn(
            d, hopper::desc_advance(da, kk * 32),
            hopper::desc_advance(db, kk * 2 * 1024), (it | kk) != 0);
      hopper::wgmma_commit();
      if (it > 0) {
        // the previous stage's products are done: hand its tiles back
        hopper::wgmma_wait<1>();
        if (lane == 0) hopper::mbar_arrive(&empty[(it - 1) % STAGES]);
      }
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) hopper::fence_operand(d[i]);

    // row q of C is y_flat[(q*s + rho - p)*Cout + co]: one mask on the flat
    // index covers q = 0's samples before the output and q = T's after it
    const long long n_flat = static_cast<long long>(n_in) * scale * cout;
    bf16* yb = y + static_cast<long long>(b) * n_flat;
    const int row = q0 + wg * 64 + warp * 16 + lane / 4;
    const int col = n0 + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long base =
          (static_cast<long long>(row + 8 * h) * scale + rho - pad) * cout;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int co = col + 8 * j;
        const long long idx = base + co;
        if (co < cout && idx >= 0 && idx < n_flat) {
          const float2 bv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(bias + co));
          *reinterpret_cast<__nv_bfloat162*>(yb + idx) =
              __floats2bfloat162_rn(d[4 * j + 2 * h] + bv.x,
                                    d[4 * j + 2 * h + 1] + bv.y);
        }
      }
    }
  }
}

int launch(const bf16* a, const bf16* w, const bf16* bias, bf16* y, int batch,
           int n_in, int cin, int cout, int scale, int pad,
           cudaStream_t stream) {
  // `a` and `y` are new allocations on every call: the maps are encoded
  // here each time (host microseconds), not cached on pointers
  CUtensorMap map_a, map_w;
  int rc = hopper::encode_bf16_3d(&map_a, a, cin, n_in, batch, BK, BM, 1);
  if (rc != cudaSuccess) return rc;
  rc = hopper::encode_bf16_3d(&map_w, w, cout, cin, 2 * scale, 64, BK, 1);
  if (rc != cudaSuccess) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      upsample_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return err;
  // groups q = 0 .. n_in: the p-shift makes the last outputs reach q = n_in.
  // x runs over (phase, column block): the blocks that share an A tile are
  // neighbours
  dim3 grid(scale * ((cout + BN - 1) / BN), (n_in + 1 + BM - 1) / BM, batch);
  upsample_wgmma_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      map_a, map_w, bias, y, n_in, cin, cout, scale, pad);
  return cudaGetLastError();
}

}  // namespace tc

// -------------------------------------------------------------- float32

namespace simt {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int STAGES = 3;
constexpr int LDA = BK + 4;  // rows 80 bytes apart: 16-byte aligned, and the
                             // two row groups of a warp on other banks
constexpr int THREADS = 256;
constexpr int A_FLOATS = BM * LDA;
constexpr int B_FLOATS = BK * BN;
constexpr int SMEM_BYTES = STAGES * (A_FLOATS + B_FLOATS) * 4;

// `bytes` (4 or 16) from global to shared memory, zeros when !valid
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(hopper::smem_u32(dst)), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(hopper::smem_u32(dst)), "l"(src), "r"(n) : "memory");
}

// thread (ty, tx) in 16 x 16 owns rows 4*ty + i and 64 + 4*ty + i, columns
// 4*tx + j and 64 + 4*tx + j, i, j < 4. VEC: Cin and Cout are multiples of
// 4, so every 16-byte copy and store is aligned and wholly in or out.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
upsample_f32_kernel(const float* __restrict__ a, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ y,
                    int n_in, int cin, int cout, int scale, int pad) {
  extern __shared__ __align__(16) float smem_f[];
  float* s_a = smem_f;                      // [STAGES][BM][LDA]
  float* s_b = smem_f + STAGES * A_FLOATS;  // [STAGES][BK][BN]

  const int rho = blockIdx.x % scale;
  const int n0 = (blockIdx.x / scale) * BN;
  const int q0 = blockIdx.y * BM;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k_half = (cin + BK - 1) / BK;
  const int n_iter = 2 * k_half;
  const float* ab = a + static_cast<long long>(b) * n_in * cin;

  auto load = [&](int it) {
    const int s = it % STAGES;
    const int half = it / k_half;
    const int kc = (it % k_half) * BK;
    float* da = s_a + s * A_FLOATS;
    float* db = s_b + s * B_FLOATS;
    // k < Cin reads a[q] with tap rho, k >= Cin reads a[q-1] with rho + s
    const float* wt = w + static_cast<long long>(rho + half * scale) * cin
                              * cout;
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < BM * BK / 4 / THREADS; ++i) {
        const int e = tid + i * THREADS;
        const int m = e / (BK / 4), c = (e % (BK / 4)) * 4;
        const int row = q0 + m - half, k = kc + c;
        const bool ok = row >= 0 && row < n_in && k < cin;
        cp_async<16>(da + m * LDA + c,
                     ok ? ab + static_cast<long long>(row) * cin + k : ab,
                     ok);
      }
#pragma unroll
      for (int i = 0; i < BK * BN / 4 / THREADS; ++i) {
        const int e = tid + i * THREADS;
        const int kk = e / (BN / 4), c = (e % (BN / 4)) * 4;
        const int k = kc + kk, co = n0 + c;
        const bool ok = k < cin && co < cout;
        cp_async<16>(db + kk * BN + c,
                     ok ? wt + static_cast<long long>(k) * cout + co : w, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BM * BK / THREADS; ++i) {
        const int e = tid + i * THREADS;
        const int m = e / BK, c = e % BK;
        const int row = q0 + m - half, k = kc + c;
        const bool ok = row >= 0 && row < n_in && k < cin;
        cp_async<4>(da + m * LDA + c,
                    ok ? ab + static_cast<long long>(row) * cin + k : ab, ok);
      }
#pragma unroll
      for (int i = 0; i < BK * BN / THREADS; ++i) {
        const int e = tid + i * THREADS;
        const int kk = e / BN, c = e % BN;
        const int k = kc + kk, co = n0 + c;
        const bool ok = k < cin && co < cout;
        cp_async<4>(db + kk * BN + c,
                    ok ? wt + static_cast<long long>(k) * cout + co : w, ok);
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_iter) load(s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int it = 0; it < n_iter; ++it) {
    // tile `it` has landed; every thread is done with tile it - 1, whose
    // stage the next load overwrites
    asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 2) : "memory");
    __syncthreads();
    if (it + STAGES - 1 < n_iter) load(it + STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    const float* pa = s_a + (it % STAGES) * A_FLOATS + 4 * ty * LDA;
    const float* pb = s_b + (it % STAGES) * B_FLOATS + 4 * tx;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = *reinterpret_cast<const float4*>(
            pa + ((i / 4) * 64 + i % 4) * LDA + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(pb + (k4 + kk) * BN);
        const float4 b1 =
            *reinterpret_cast<const float4*>(pb + (k4 + kk) * BN + 64);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float x = kk == 0 ? av[i].x : kk == 1 ? av[i].y
                          : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x, bv[j], acc[i][j]);
        }
      }
    }
  }

  const long long n_out = static_cast<long long>(n_in) * scale;
  float* yb = y + static_cast<long long>(b) * n_out * cout;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long q = q0 + (i / 4) * 64 + 4 * ty + i % 4;
    const long long jo = q * scale + rho - pad;
    if (jo < 0 || jo >= n_out) continue;  // q = 0 before, q = T after y
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int co = n0 + g * 64 + 4 * tx;
      float* o = yb + jo * cout + co;
      if constexpr (VEC) {
        if (co < cout) {
          const float4 bv = *reinterpret_cast<const float4*>(bias + co);
          *reinterpret_cast<float4*>(o) =
              make_float4(acc[i][4 * g] + bv.x, acc[i][4 * g + 1] + bv.y,
                          acc[i][4 * g + 2] + bv.z, acc[i][4 * g + 3] + bv.w);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (co + j < cout) o[j] = acc[i][4 * g + j] + bias[co + j];
      }
    }
  }
}

template <bool VEC>
int launch_one(const float* a, const float* w, const float* bias, float* y,
               int batch, int n_in, int cin, int cout, int scale, int pad,
               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      upsample_f32_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(scale * ((cout + BN - 1) / BN), (n_in + 1 + BM - 1) / BM, batch);
  upsample_f32_kernel<VEC><<<grid, THREADS, SMEM_BYTES, stream>>>(
      a, w, bias, y, n_in, cin, cout, scale, pad);
  return cudaGetLastError();
}

}  // namespace simt

}  // namespace

// x: [batch, n_in, cin]; w: [2*scale, cin, cout] in torch tap order;
// bias: [cout]; a: scratch shaped like x, x + sin(x) when residual is 1 (else
// unused: the product reads x); y: [batch, n_in*scale, cout]; all float32
// (bf16 = 0) or all bfloat16 (bf16 = 1, cin and cout multiples of 8).
extern "C" int vf_upsample(const void* x, const void* w, const void* bias,
                           void* a, void* y, int batch, int n_in, int cin,
                           int cout, int scale, int bf16, int residual,
                           void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int pad = scale / 2 + scale % 2;
  const long long n_x = static_cast<long long>(batch) * n_in * cin;
  if (bf16) {
    using T = __nv_bfloat16;
    if (cin % 8 || cout % 8) return cudaErrorInvalidValue;
    const T* src = static_cast<const T*>(x);
    if (residual) {
      vf::launch_sin_residual(src, static_cast<T*>(a), n_x, stream);
      src = static_cast<const T*>(a);
    }
    return tc::launch(src, static_cast<const T*>(w),
                      static_cast<const T*>(bias), static_cast<T*>(y), batch,
                      n_in, cin, cout, scale, pad, stream);
  }
  const float* af = static_cast<const float*>(x);
  if (residual) {
    vf::launch_sin_residual(af, static_cast<float*>(a), n_x, stream);
    af = static_cast<const float*>(a);
  }
  auto fn = (cin % 4 == 0 && cout % 4 == 0) ? simt::launch_one<true>
                                            : simt::launch_one<false>;
  return fn(af, static_cast<const float*>(w), static_cast<const float*>(bias),
            static_cast<float*>(y), batch, n_in, cin, cout, scale, pad,
            stream);
}
