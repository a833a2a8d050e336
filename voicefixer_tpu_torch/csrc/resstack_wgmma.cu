// K2 res_chain in bfloat16: n consecutive ResStack blocks on a time tile
// plus a halo of E[0] = sum(d_i + 1) rows a side, with the intermediates in
// shared memory. vf_res_chain_wgmma.
//
// Replaces voicefixer_tpu/kernels/resstack.py::res_chain (_chain_kernel,
// :177 and :293; Pallas, TPU) for bfloat16. It computes what
// chain_kernel<__nv_bfloat16, BN, false> of resblock.cuh computes, rounding
// where it rounds:
//   slab = x over [t0 - E0, t0 + tm + E0), 0 outside the window [lo, hi)
//   per block i (E = E[i+1]):
//     h = lrelu(sum_j lrelu(slab[t + (j-1)d]) @ W1[j] + b1), 0 outside the
//         window, over [t0 - E - 1, t0 + tm + E + 1)
//     y = sum_j h[t + j - 1] @ W2[j] + b2 + slab[t], 0 outside the window,
//         over [t0 - E, t0 + tm + E), written over the slab in place; the
//         last block writes only [t0, t0 + tm), with the optional final
//         LeakyReLU.
//
// Bound: operations (12*C^2 FLOP per row per block against 4*C bytes). The
// WMMA chain_kernel ran 16x16x16 fragments staged through registers and
// streamed all of a block's 6*C^2 bytes of weights from L2 for each 64-row
// product. This kernel:
//   - runs wgmma (m64n256k16, float32 accumulators) with A from registers:
//     each lane loads its A rows with ldmatrix from the padded row-major
//     slab (or h) at any row offset, so a dilated tap is only an address,
//     and the LeakyReLU of conv1's input is applied to the registers. A and
//     the intermediates never pass through the async proxy: no
//     fence.proxy.async;
//   - gets B (the weights) by TMA, N-major straight from w [n*3, C, C]
//     through the descriptor's transpose bit, into a ring of stages that
//     one producer thread keeps full against full/empty mbarriers; a ragged
//     C reads zeros from the tensor map;
//   - reads the weights once per pass for two 64-row tiles (C <= 256) or
//     for both 256-column halves of C = 512: two consumer warpgroups share
//     every stage;
//   - makes a stage 32 or 64 K rows deep (64 where two such stages fit),
//     because a full/empty round trip per 16-deep wgmma, not the L2
//     traffic, set the pace (PERF.md: TMA multicast of each weight
//     box to a cluster of time tiles halved the bytes and lost time).
// A product of `rows` output rows runs in passes: the (64-row tile, column
// chunk) pairs go two at a time to the two consumer warpgroups, each pass
// streams the weights once, and a warpgroup without a pair still takes and
// hands back every stage. One wgmma group is in flight while the previous
// stage is handed back. mbar_wait traps after two seconds, so a pipeline out
// of step fails the launch instead of hanging the card.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_BLOCKS = 8;
constexpr int ROWS = 64;        // rows of a warpgroup's product tile
constexpr int COLS = 256;       // columns of one wgmma: a column chunk
constexpr int CP_ALIGN = 64;    // K of a tap: ch rounded up to a TMA box
constexpr int BOX_COLS = 64;    // one 128-byte swizzled row of a TMA box
constexpr int CONSUMERS = 2;    // warpgroups that multiply
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int MIN_STAGES = 2, MAX_STAGES = 8;

// A ring stage is KS wgmma k-steps deep (16 K rows each) over every column
// chunk: 32 rows, or 64 where two such stages fit shared memory.
template <int KS>
struct Stage {
  static constexpr int BK = 16 * KS;                     // K rows
  static constexpr int BOX_BYTES = BK * BOX_COLS * 2;    // one TMA box
  static constexpr int CHUNK_BYTES = BK * COLS * 2;      // one column chunk
};
constexpr int SMEM_LIMIT = 232448;

struct Params {
  const bf16* x;   // [batch, t_len, ch]
  const bf16* b1;  // [n, ch]
  const bf16* b2;
  bf16* y;         // [batch, t_len, ch]
  int t_len, ch, n;
  int cp;          // ch rounded up to CP_ALIGN: the K of one tap
  int chunks;      // column chunks of COLS
  int dils[MAX_BLOCKS];
  int ext[MAX_BLOCKS + 1];  // ext[i] = sum over k >= i of (dils[k] + 1)
  int tm;                   // output rows of a thread block
  int stages;               // of the ring
  float slope, final_slope;
  int has_final;
  int lo, hi;               // the signal window, clamped to [0, t_len]
};

__host__ __device__ inline int passes_of(int rows, int chunks) {
  return (((rows + ROWS - 1) / ROWS) * chunks + CONSUMERS - 1) / CONSUMERS;
}

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v > 0.f ? v : slope * v;
}

// LeakyReLU of two bf16 in float32, rounded back: what the plain version
// and chain_kernel's staging do to conv1's input
__device__ __forceinline__ uint32_t lrelu2(uint32_t v, float slope) {
  float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
  __nv_bfloat162 o = __floats2bfloat162_rn(lrelu(f.x, slope),
                                           lrelu(f.y, slope));
  return *reinterpret_cast<uint32_t*>(&o);
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(128 * CONSUMERS) : "memory");
}

// Shared memory: the ring (1024-aligned), its full and empty barriers, the
// slab [tm + 2 E0][cp + 8] and h [tm + 2 E1 + 2][cp + 8]; rows padded by 16
// bytes so that ldmatrix's eight rows fall on eight bank groups.
template <int KS>
__global__ void __launch_bounds__(THREADS, 1)
chain_wgmma_kernel(const __grid_constant__ CUtensorMap map_w1,
                   const __grid_constant__ CUtensorMap map_w2,
                   const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023))
                              & 1023);
  const int stages = p.stages;
  constexpr int BK = Stage<KS>::BK;
  constexpr int BOX_BYTES = Stage<KS>::BOX_BYTES;
  constexpr int CHUNK_BYTES = Stage<KS>::CHUNK_BYTES;
  const int stage_bytes = p.chunks * CHUNK_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * stage_bytes);
  uint64_t* empty = full + stages;
  const int ld = p.cp + 8;
  const int e0 = p.ext[0];
  const int slab_rows = p.tm + 2 * e0;
  bf16* slab = reinterpret_cast<bf16*>(empty + stages);
  bf16* hbuf = slab + slab_rows * ld;
  const int t0 = blockIdx.x * p.tm;
  const int ksteps = p.cp / BK;
  const int per_pass = 3 * ksteps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS * 4);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // producer: one thread starts every load, in the consumers' order
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 128 * CONSUMERS) {
      const int boxes = stage_bytes / BOX_BYTES;
      int s = 0, it = 0;
      uint32_t phase = 0;
      for (int i = 0; i < p.n; ++i) {
        const int eo = p.ext[i + 1];
        for (int conv = 0; conv < 2; ++conv) {
          const CUtensorMap* map = conv ? &map_w2 : &map_w1;
          const int rows = p.tm + 2 * eo + (conv ? 0 : 2);
          const int n_st = passes_of(rows, p.chunks) * per_pass;
          for (int st = 0; st < n_st; ++st) {
            const int k = st % per_pass;
            const int tap = k / ksteps, kc = (k % ksteps) * BK;
            // every consumer warp has handed this stage back
            if (it >= stages) hopper::mbar_wait(&empty[s], phase ^ 1);
            hopper::mbar_arrive_expect_tx(&full[s], stage_bytes);
            uint8_t* dst = ring + s * stage_bytes;
            for (int b = 0; b < boxes; ++b)
              hopper::tma_load_3d(dst + b * BOX_BYTES, map, &full[s],
                                  b * BOX_COLS, kc, 3 * i + tap);
            if (++s == stages) s = 0, phase ^= 1;
            ++it;
          }
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<232>();
    const int tid = threadIdx.x;
    const int lane = tid % 32, wq = (tid % 128) / 32;
    const int ch = p.ch;

    // the slab, zero outside the window and in columns [ch, cp), by
    // cp.async (a copy of 0 source bytes writes zeros), all in flight at
    // once; h's columns [ch, cp), which the products read as K
    const bf16* xb = p.x + static_cast<long long>(blockIdx.y) * p.t_len * ch;
    const uint4 zero = make_uint4(0, 0, 0, 0);
    const int vecs = p.cp / 8;
    for (int e = tid; e < slab_rows * vecs; e += 128 * CONSUMERS) {
      const int r = e / vecs, c = (e % vecs) * 8;
      const int pos = t0 - e0 + r;
      const bool ok = c < ch && pos >= p.lo && pos < p.hi;
      hopper::cp_async_16(slab + r * ld + c,
                          ok ? xb + static_cast<long long>(pos) * ch + c : xb,
                          ok);
    }
    hopper::cp_async_wait_all();
    const int pad_vecs = (p.cp - ch) / 8;
    const int h_rows0 = p.tm + 2 * p.ext[1] + 2;
    for (int e = tid; e < h_rows0 * pad_vecs; e += 128 * CONSUMERS)
      *reinterpret_cast<uint4*>(hbuf + (e / pad_vecs) * ld + ch +
                                (e % pad_vecs) * 8) = zero;
    consumer_sync();

    float acc[128];
#pragma unroll
    for (int q = 0; q < 128; ++q) acc[q] = 0.f;
    uint32_t a0[KS][4], a1[KS][4];
    int s = 0, prev_s = 0;
    uint32_t phase = 0;

    auto release = [&](int stage) {
      if (lane == 0) hopper::mbar_arrive(&empty[stage]);
    };

    for (int i = 0; i < p.n; ++i) {
      const int d = p.dils[i], eo = p.ext[i + 1];
      const bool last = i + 1 == p.n;
      for (int conv = 0; conv < 2; ++conv) {
        const int rows = p.tm + 2 * eo + (conv ? 0 : 2);
        const int pairs = ((rows + ROWS - 1) / ROWS) * p.chunks;
        const int passes = (pairs + CONSUMERS - 1) / CONSUMERS;
        // A: conv1 reads the slab (output row 0 is slab row e0 - eo - 1 at
        // the centre tap, taps d apart), conv2 reads h (row 1, taps 1 apart)
        const bf16* src = conv ? hbuf : slab;
        const int src_rows = conv ? rows + 2 : slab_rows;
        const int first = conv ? 1 : e0 - eo - 1;
        const int step = conv ? 1 : d;
        const float slope = p.slope;
        for (int pass = 0; pass < passes; ++pass) {
          const int pair = pass * CONSUMERS + wg;
          if (pair >= pairs) {
            // no tile for this warpgroup in this pass: take and hand back
            for (int st = 0; st < per_pass; ++st) {
              hopper::mbar_wait(&full[s], phase);
              release(s);
              if (++s == stages) s = 0, phase ^= 1;
            }
            continue;
          }
          const int m = pair / p.chunks, nb = pair % p.chunks;
          // this lane's ldmatrix row at the centre tap and its column
          const int row_c = first + m * ROWS + wq * 16 + lane % 16;
          const bf16* col = src + 8 * (lane / 16);

          // one stage: A of (tap, kc) into `cur`, KS wgmmas; then the
          // previous stage's products are retired and that stage handed
          // back. Rows past the source feed only output rows past `rows`:
          // they are clamped to stay inside shared memory.
          auto step_one = [&](int st, uint32_t (&cur)[KS][4],
                              uint32_t (&prev)[KS][4]) {
            const int tap = st / ksteps, kc = (st % ksteps) * BK;
            int r = row_c + (tap - 1) * step;
            r = r < 0 ? 0 : (r >= src_rows ? src_rows - 1 : r);
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) {
              hopper::ldmatrix_x4(cur[kk], col + r * ld + kc + 16 * kk);
              if (conv == 0) {
#pragma unroll
                for (int q = 0; q < 4; ++q)
                  cur[kk][q] = lrelu2(cur[kk][q], slope);
              }
            }
            hopper::mbar_wait(&full[s], phase);
            hopper::wgmma_fence();
            const uint64_t db = hopper::smem_desc_sw128(
                ring + s * stage_bytes + nb * CHUNK_BYTES, BOX_BYTES, 1024);
#pragma unroll
            for (int kk = 0; kk < KS; ++kk)  // 16 k a step: two 8-k groups
              hopper::wgmma_m64n256k16_bf16_rs(
                  acc, cur[kk], hopper::desc_advance(db, kk * 2048),
                  st > 0 || kk > 0);
            hopper::wgmma_commit();
            if (st > 0) {
              hopper::wgmma_wait<1>();
#pragma unroll
              for (int kk = 0; kk < KS; ++kk)
#pragma unroll
                for (int q = 0; q < 4; ++q)
                  hopper::fence_operand(prev[kk][q]);
              release(prev_s);
            }
            prev_s = s;
            if (++s == stages) s = 0, phase ^= 1;
          };
          int st = 0;
          for (; st + 1 < per_pass; st += 2) {
            step_one(st, a0, a1);
            step_one(st + 1, a1, a0);
          }
          if (st < per_pass) step_one(st, a0, a1);  // an odd stage count
          hopper::wgmma_wait<0>();
#pragma unroll
          for (int q = 0; q < 128; ++q) hopper::fence_operand(acc[q]);
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              hopper::fence_operand(a0[kk][q]);
              hopper::fence_operand(a1[kk][q]);
            }
          release(prev_s);

          // epilogue: thread holds rows r0, r0 + 8 and, for j < 32, the
          // column pair c0 + 8j
          const int r0 = m * ROWS + wq * 16 + lane / 4;
          const int c0 = nb * COLS + 2 * (lane % 4);
          if (conv == 0) {
            const bf16* b1 = p.b1 + i * ch;
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const int hr = r0 + 8 * h2;
              if (hr >= rows) continue;
              const int pos = t0 - eo - 1 + hr;
              const bool inside = pos >= p.lo && pos < p.hi;
              bf16* hrow = hbuf + hr * ld;
#pragma unroll
              for (int j = 0; j < 32; ++j) {
                const int n = c0 + 8 * j;
                if (n >= ch) continue;
                const float2 b = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(b1 + n));
                const float v0 = inside
                    ? lrelu(acc[4 * j + 2 * h2] + b.x, slope) : 0.f;
                const float v1 = inside
                    ? lrelu(acc[4 * j + 2 * h2 + 1] + b.y, slope) : 0.f;
                *reinterpret_cast<__nv_bfloat162*>(hrow + n) =
                    __floats2bfloat162_rn(v0, v1);
              }
            }
          } else {
            const bf16* b2 = p.b2 + i * ch;
            bf16* yb = p.y + static_cast<long long>(blockIdx.y) * p.t_len * ch;
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const int yr = r0 + 8 * h2;
              if (yr >= rows) continue;
              const int pos = t0 - eo + yr;
              const bool inside = pos >= p.lo && pos < p.hi;
              // the next block pads its input with zeros too, and rows of
              // the array outside the window are written as zeros
              if (last && (pos < 0 || pos >= p.t_len)) continue;
              bf16* xrow = slab + (e0 - eo + yr) * ld;
#pragma unroll
              for (int j = 0; j < 32; ++j) {
                const int n = c0 + 8 * j;
                if (n >= ch) continue;
                const float2 b = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(b2 + n));
                const float2 res = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(xrow + n));
                float v0 = inside ? acc[4 * j + 2 * h2] + b.x + res.x : 0.f;
                float v1 = inside ? acc[4 * j + 2 * h2 + 1] + b.y + res.y
                                  : 0.f;
                if (!last) {
                  *reinterpret_cast<__nv_bfloat162*>(xrow + n) =
                      __floats2bfloat162_rn(v0, v1);
                } else {
                  if (p.has_final) {
                    v0 = lrelu(v0, p.final_slope);
                    v1 = lrelu(v1, p.final_slope);
                  }
                  *reinterpret_cast<__nv_bfloat162*>(
                      yb + static_cast<long long>(pos) * ch + n) =
                      __floats2bfloat162_rn(v0, v1);
                }
              }
            }
          }
        }
        consumer_sync();  // h (or the slab) is whole before the next product
      }
    }
  }
}

// Fills the ring's stage count from the shared memory left and launches.
template <int KS>
int launch(Params p, const bf16* w1, const bf16* w2, int batch,
           long long fixed, cudaStream_t stream) {
  // w [n, 3, C, C] as [n*3][C (K)][C (N)]: boxes of 64 columns x BK rows of
  // one (block, tap); rows and columns past C read as zeros
  CUtensorMap map_w1, map_w2;
  int rc = hopper::encode_bf16_3d(&map_w1, w1, p.ch, p.ch, 3 * p.n, BOX_COLS,
                                  Stage<KS>::BK, 1);
  if (rc != cudaSuccess) return rc;
  rc = hopper::encode_bf16_3d(&map_w2, w2, p.ch, p.ch, 3 * p.n, BOX_COLS,
                              Stage<KS>::BK, 1);
  if (rc != cudaSuccess) return rc;
  const long long per_stage = p.chunks * Stage<KS>::CHUNK_BYTES + 16;
  const long long room = SMEM_LIMIT - 1024 - fixed;
  p.stages = room / per_stage < MAX_STAGES
                 ? static_cast<int>(room / per_stage) : MAX_STAGES;
  const size_t smem = 1024 + p.stages * per_stage + fixed;
  cudaError_t err = cudaFuncSetAttribute(
      chain_wgmma_kernel<KS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (p.t_len + p.tm - 1) / p.tm;
  const dim3 grid(tiles, batch);
  chain_wgmma_kernel<KS><<<grid, THREADS, smem, stream>>>(map_w1, map_w2, p);
  return cudaGetLastError();
}

}  // namespace

// x, y: [batch, t_len, ch] bfloat16, ch a multiple of 8; w1, w2: [n, 3*ch,
// ch] (block, tap*in, out); b1, b2: [n, ch]; dils: n host ints; tm: output
// rows per thread block. y must not alias x. [lo, hi) is the signal window in
// rows (0, t_len for the whole array): rows outside it are zero padding at
// every block, and are written as zeros. Returns cudaErrorInvalidValue for
// arguments it does not take, a tile that leaves no room for MIN_STAGES
// 32-deep ring stages included. Stages are 64 deep where MIN_STAGES of those
// fit and the width is one column chunk.
extern "C" int vf_res_chain_wgmma(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, void* y, int batch,
                                  int t_len, int ch, int n, const int* dils,
                                  int tm, float slope, float final_slope,
                                  int has_final, int lo, int hi,
                                  void* stream) {
  if (batch < 1 || t_len < 1 || ch < 8 || ch % 8 || n < 1 ||
      n > MAX_BLOCKS || tm < 1)
    return cudaErrorInvalidValue;
  Params p{};
  p.x = static_cast<const bf16*>(x);
  p.b1 = static_cast<const bf16*>(b1);
  p.b2 = static_cast<const bf16*>(b2);
  p.y = static_cast<bf16*>(y);
  p.t_len = t_len;
  p.ch = ch;
  p.n = n;
  p.cp = (ch + CP_ALIGN - 1) / CP_ALIGN * CP_ALIGN;
  p.chunks = (ch + COLS - 1) / COLS;
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
  const long long rows =
      (tm + 2LL * p.ext[0]) + (tm + 2LL * p.ext[1] + 2);
  const long long fixed = rows * (p.cp + 8) * 2;
  const long long room = SMEM_LIMIT - 1024 - fixed;
  auto fits = [&](int chunk_bytes) {
    return room >= MIN_STAGES * (p.chunks * chunk_bytes + 16LL);
  };
  if (!fits(Stage<2>::CHUNK_BYTES)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const bf16* w1b = static_cast<const bf16*>(w1);
  const bf16* w2b = static_cast<const bf16*>(w2);
  if (p.chunks == 1 && fits(Stage<4>::CHUNK_BYTES))
    return launch<4>(p, w1b, w2b, batch, fixed, s);
  return launch<2>(p, w1b, w2b, batch, fixed, s);
}
