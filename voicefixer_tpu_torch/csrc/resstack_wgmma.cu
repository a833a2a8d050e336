// The vocoder's ResStack in bfloat16: K2 res_chain (n consecutive ResStack
// blocks on a time tile plus a halo of E[0] = sum(d_i + 1) rows a side, with
// the intermediates in shared memory; vf_res_chain_wgmma), the fused front
// of K4 up_res_stream (the same chain on the stage's upsampled signal,
// produced in shared memory; vf_up_chain_wgmma) and K3 res_shift_single (one
// block at any dilation, its +-d taps read straight from x;
// vf_res_shift_wgmma), which also runs the single blocks of K4 and of K7
// res_stream.
//
// Replaces voicefixer_tpu/kernels/resstack.py::res_chain (_chain_kernel,
// :177 and :293) and ::res_shift_single (_shift_kernel, :464), and the
// groups of voicefixer_tpu/kernels/resstream.py::up_res_stream (:552) and
// ::res_stream (:416) (Pallas, TPU), for bfloat16. It rounds where the
// plain versions round:
//   slab = x over [t0 - E0, t0 + tm + E0), 0 outside the window [lo, hi);
//          with the upsample (up): slab row n = u[n] = bf16(z[n + p]),
//          z[q*s + rho] = a[q] @ Wup[rho] + a[q-1] @ Wup[rho + s] + b_up in
//          float32, a = x + sin(x) (a pre-pass at the slow rate), p = s//2 +
//          s%2, 0 outside [0, T*s)
//   per block i (E = E[i+1]):
//     h = lrelu(sum_j lrelu(slab[t + (j-1)d]) @ W1[j] + b1), 0 outside the
//         window, over [t0 - E - 1, t0 + tm + E + 1)
//     y = sum_j h[t + j - 1] @ W2[j] + b2 + slab[t], 0 outside the window,
//         over [t0 - E, t0 + tm + E), written over the slab in place; the
//         last block writes only [t0, t0 + tm), with the optional final
//         LeakyReLU.
// The single block is the same block with E = 0 and x in place of the
// slab: conv1's A rows come from x at the three taps, one TMA box per tap
// and k step, so no halo of d rows is loaded.
//
// Bound: operations (12*C^2 FLOP per row per block against 4*C bytes; at
// C = 64 the bytes come close). These kernels:
//   - run wgmma (m64nNk16, float32 accumulators, N = 256 a column chunk
//     above 128 channels, else the width rounded up to 64: N = C at the
//     fused stages) with A from registers: each lane loads its A rows with
//     ldmatrix from the padded row-major slab, h, the upsample's source
//     rows or a swizzled TMA box of x, so a dilated tap is only an address,
//     and the LeakyReLU of conv1's input is applied to the registers. A and
//     the intermediates written by threads never pass through the async
//     proxy: no fence.proxy.async;
//   - get B (the weights) by TMA, N-major straight from w [n*3, C, C] and
//     w_up [2s, Cin, C] through the descriptor's transpose bit (nothing is
//     packed), into a ring of stages that one producer thread keeps full
//     against full/empty mbarriers; a ragged width reads zeros from the
//     tensor map;
//   - read the weights once per pass for two 64-row tiles (one column
//     chunk) or for both 256-column halves of C = 512: two consumer
//     warpgroups share every stage;
//   - make a stage 32 or 64 K rows deep (64 where two such stages fit),
//     because a full/empty round trip per 16-deep wgmma, not the L2
//     traffic, set the pace (PERF.md: TMA multicast of each weight
//     box to a cluster of time tiles halved the bytes and lost time).
// With the upsample, the source rows q of the slab (a[q_lo - 1 .. q_hi])
// are copied by cp.async to where h will be, and the upsample runs as one
// more product before block 0: per phase rho, two taps (rows q and q - 1)
// of Cin rows each, its 64-row tiles of rows q two to a pass; its epilogue
// writes the slab. The upsampled signal never reaches global memory.
// A product of `rows` output rows runs in passes: the (64-row tile, column
// chunk) pairs go two at a time to the two consumer warpgroups, each pass
// streams the weights once, and a warpgroup without a pair still takes and
// hands back every stage. One wgmma group is in flight while the previous
// stage is handed back; accumulators live for one pass. mbar_wait traps
// after two seconds, so a pipeline out of step fails the launch instead of
// hanging the card.

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_BLOCKS = 8;
constexpr int ROWS = 64;        // rows of a warpgroup's product tile
constexpr int CP_ALIGN = 64;    // K of a tap: the width rounded up to a box
constexpr int BOX_COLS = 64;    // one 128-byte swizzled row of a TMA box
constexpr int CONSUMERS = 2;    // warpgroups that multiply
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int MIN_STAGES = 2, MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;

// A ring stage is KS wgmma k-steps deep (16 K rows each) over every column
// chunk of N columns: 32 rows, or 64 where two such stages fit shared
// memory.
template <int KS, int N>
struct Stage {
  static constexpr int BK = 16 * KS;                     // K rows
  static constexpr int BOX_BYTES = BK * BOX_COLS * 2;    // one TMA box
  static constexpr int CHUNK_BYTES = BK * N * 2;         // one column chunk
  static constexpr int A_BYTES = ROWS * BK * 2;          // a single block's
                                                         // A box of x rows
};

struct Params {
  const bf16* x;   // [batch, t_len, ch]; with up unused
  const bf16* b1;  // [n, ch]
  const bf16* b2;
  bf16* y;         // [batch, t_len, ch]
  int t_len, ch, n;
  int cp;          // ch rounded up to CP_ALIGN: the K of one tap
  int chunks;      // column chunks of N
  int dils[MAX_BLOCKS];
  int ext[MAX_BLOCKS + 1];  // ext[i] = sum over k >= i of (dils[k] + 1)
  int tm;                   // output rows of a thread block
  int stages;               // of the ring
  float slope, final_slope;
  int has_final;
  int lo, hi;               // the signal window, clamped to [0, t_len]
  // the upsample in front (up = 1): a = x + sin(x) [batch, t_in, cin], its
  // bias [ch]; cinp: cin rounded up to CP_ALIGN, the K of one tap
  int up;
  const bf16* a;
  const bf16* b_up;
  int t_in, cin, cinp, scale;
};

__host__ __device__ inline int passes_of(int rows, int chunks) {
  return (((rows + ROWS - 1) / ROWS) * chunks + CONSUMERS - 1) / CONSUMERS;
}

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v > 0.f ? v : slope * v;
}

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b < 0) ? q - 1 : q;
}

// The source rows q of a tile's slab: [q_lo, q_lo + nq), the rows whose
// phases cover slab rows [0, slab_rows) at signal rows from slab0.
struct UpRows {
  int q_lo, nq, pad;
  __device__ UpRows(const Params& p, int slab0, int slab_rows) {
    if (!p.up) {
      q_lo = nq = pad = 0;
      return;
    }
    pad = p.scale / 2 + p.scale % 2;
    q_lo = floor_div(slab0 + pad, p.scale);
    nq = floor_div(slab0 + slab_rows - 1 + pad, p.scale) - q_lo + 1;
  }
};

// LeakyReLU of two bf16 in float32, rounded back: what the plain version
// does to conv1's input
__device__ __forceinline__ uint32_t lrelu2(uint32_t v, float slope) {
  float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
  __nv_bfloat162 o = __floats2bfloat162_rn(lrelu(f.x, slope),
                                           lrelu(f.y, slope));
  return *reinterpret_cast<uint32_t*>(&o);
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(128 * CONSUMERS) : "memory");
}

// a convolution (0: conv1, 1: conv2) known only when the kernel runs
struct Which {
  int value;
};

template <int N>
__device__ __forceinline__ void mma(float (&acc)[N / 2],
                                    const uint32_t (&a)[4], uint64_t desc,
                                    int accumulate) {
  if constexpr (N == 256)
    hopper::wgmma_m64n256k16_bf16_rs(acc, a, desc, accumulate);
  else if constexpr (N == 128)
    hopper::wgmma_m64n128k16_bf16_rs_nmajor(acc, a, desc, accumulate);
  else
    hopper::wgmma_m64n64k16_bf16_rs_nmajor(acc, a, desc, accumulate);
}

// Shared memory: the ring (1024-aligned), its full and empty barriers, the
// slab [tm + 2 E0][cp + 8] and h [tm + 2 E1 + 2][cp + 8] (with up, the
// source rows [nq + 1][cinp + 8] first take h's place); rows padded by 16
// bytes so that ldmatrix's eight rows fall on eight bank groups.
template <int KS, int N>
__global__ void __launch_bounds__(THREADS, 1)
chain_wgmma_kernel(const __grid_constant__ CUtensorMap map_w1,
                   const __grid_constant__ CUtensorMap map_w2,
                   const __grid_constant__ CUtensorMap map_up,
                   const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023))
                              & 1023);
  const int stages = p.stages;
  constexpr int BK = Stage<KS, N>::BK;
  constexpr int BOX_BYTES = Stage<KS, N>::BOX_BYTES;
  constexpr int CHUNK_BYTES = Stage<KS, N>::CHUNK_BYTES;
  // the upsample runs at N = C (up to 128 columns) only: at 256 columns it
  // is not compiled, so that K2's registers are what they were
  constexpr bool UP_COLS = N <= 128;
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
  // the upsample: per phase, its passes over the 64-row tiles of rows q
  const UpRows uq(p, t0 - e0, slab_rows);
  const int q_tiles = (uq.nq + ROWS - 1) / ROWS;
  const int up_ppp = (q_tiles + CONSUMERS - 1) / CONSUMERS;
  const int up_ks = p.cinp / BK;

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
      if constexpr (UP_COLS) {
        // the upsample: per phase and pass, two taps of Cin rows of the
        // phase's matrices, w_up[rho] and w_up[rho + s]
        const int n_st = p.up ? p.scale * up_ppp * 2 * up_ks : 0;
        for (int st = 0; st < n_st; ++st) {
          const int k = st % (2 * up_ks);
          const int mat = st / (up_ppp * 2 * up_ks) + (k / up_ks) * p.scale;
          if (it >= stages) hopper::mbar_wait(&empty[s], phase ^ 1);
          hopper::mbar_arrive_expect_tx(&full[s], stage_bytes);
          uint8_t* dst = ring + s * stage_bytes;
          for (int b = 0; b < boxes; ++b)
            hopper::tma_load_3d(dst + b * BOX_BYTES, &map_up, &full[s],
                                b * BOX_COLS, (k % up_ks) * BK, mat);
          if (++s == stages) s = 0, phase ^= 1;
          ++it;
        }
      }
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
    const uint4 zero = make_uint4(0, 0, 0, 0);

    float acc[N / 2];
#pragma unroll
    for (int q = 0; q < N / 2; ++q) acc[q] = 0.f;
    uint32_t a0[KS][4], a1[KS][4];
    int s = 0, prev_s = 0;
    uint32_t phase = 0;

    auto release = [&](int stage) {
      if (lane == 0) hopper::mbar_arrive(&empty[stage]);
    };
    // after a pass's last stage: its products (into d) retired, its A
    // registers (x0, x1) free, the last stage handed back
    auto retire = [&](float (&d)[N / 2], uint32_t (&x0)[KS][4],
                      uint32_t (&x1)[KS][4]) {
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int q = 0; q < N / 2; ++q) hopper::fence_operand(d[q]);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          hopper::fence_operand(x0[kk][q]);
          hopper::fence_operand(x1[kk][q]);
        }
      release(prev_s);
    };
    // a warpgroup without a tile in a pass takes and hands back its stages
    auto idle = [&](int n_st) {
      for (int st = 0; st < n_st; ++st) {
        hopper::mbar_wait(&full[s], phase);
        release(s);
        if (++s == stages) s = 0, phase ^= 1;
      }
    };
    // one stage's KS wgmmas into d on the A registers `cur`, B chunk `nb`
    // of the stage; then the previous stage's products are retired and
    // that stage handed back
    auto multiply = [&](float (&d)[N / 2], int st, int nb,
                        uint32_t (&cur)[KS][4], uint32_t (&prev)[KS][4]) {
      hopper::mbar_wait(&full[s], phase);
      hopper::wgmma_fence();
      const uint64_t db = hopper::smem_desc_sw128(
          ring + s * stage_bytes + nb * CHUNK_BYTES, BOX_BYTES, 1024);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)  // 16 k a step: two 8-k groups
        mma<N>(d, cur[kk], hopper::desc_advance(db, kk * 2048),
               st > 0 || kk > 0);
      hopper::wgmma_commit();
      if (st > 0) {
        hopper::wgmma_wait<1>();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q) hopper::fence_operand(prev[kk][q]);
        release(prev_s);
      }
      prev_s = s;
      if (++s == stages) s = 0, phase ^= 1;
    };

    bool produced = false;  // the slab, by the upsample
    if constexpr (UP_COLS) {
      if (p.up) {
        // source rows q_lo - 1 .. q_lo + nq - 1 where h will be, zero
        // outside [0, t_in) and in the columns [cin, cinp), by cp.async
        const int ldi = p.cinp + 8;
        const int src_rows = uq.nq + 1;
        const bf16* ab =
            p.a + static_cast<long long>(blockIdx.y) * p.t_in * p.cin;
        const int vecs = p.cinp / 8;
        for (int e = tid; e < src_rows * vecs; e += 128 * CONSUMERS) {
          const int r = e / vecs, c = (e % vecs) * 8;
          const int q = uq.q_lo - 1 + r;
          const bool ok = c < p.cin && q >= 0 && q < p.t_in;
          hopper::cp_async_16(
              hbuf + r * ldi + c,
              ok ? ab + static_cast<long long>(q) * p.cin + c : ab, ok);
        }
        hopper::cp_async_wait_all();
        consumer_sync();
        const int slab0 = t0 - e0;
        const int per_up = 2 * up_ks;
        for (int pass = 0; pass < p.scale * up_ppp; ++pass) {
          const int rho = pass / up_ppp;   // the phase
          const int m = (pass % up_ppp) * CONSUMERS + wg;
          if (m >= q_tiles) {
            idle(per_up);
            continue;
          }
          // row q of tile m sits at source row 1 + 64m + (lane's row); tap
          // 1 reads q - 1. Accumulators and A registers of its own, live
          // for the pass (shared with the blocks' products, ptxas
          // serializes the wgmmas: C7515)
          const int row_c = 1 + m * ROWS + wq * 16 + lane % 16;
          const bf16* col = hbuf + 8 * (lane / 16);
          float u_acc[N / 2];
          uint32_t u0[KS][4], u1[KS][4];
          auto step_one = [&](int st, uint32_t (&cur)[KS][4],
                              uint32_t (&prev)[KS][4]) {
            const int tap = st / up_ks, kc = (st % up_ks) * BK;
            int r = row_c - tap;
            r = r >= src_rows ? src_rows - 1 : r;
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) {
              hopper::ldmatrix_x4(cur[kk], col + r * ldi + kc + 16 * kk);
            }
            multiply(u_acc, st, 0, cur, prev);
          };
          int st = 0;
          for (; st + 1 < per_up; st += 2) {
            step_one(st, u0, u1);
            step_one(st + 1, u1, u0);
          }
          if (st < per_up) step_one(st, u0, u1);
          retire(u_acc, u0, u1);

          // epilogue: thread holds rows q0, q0 + 8 and, for j < N/8, the
          // column pair c0 + 8j: every column of the slab, zero past ch
          const int q0 = m * ROWS + wq * 16 + lane / 4;
          const int c0 = 2 * (lane % 4);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int qr = q0 + 8 * h2;
            const int pos = (uq.q_lo + qr) * p.scale + rho - uq.pad;
            const int srow = pos - slab0;
            if (qr >= uq.nq || srow < 0 || srow >= slab_rows) continue;
            const bool inside = pos >= p.lo && pos < p.hi;
            bf16* row = slab + srow * ld;
#pragma unroll
            for (int j = 0; j < N / 8; ++j) {
              const int n = c0 + 8 * j;
              float v0 = 0.f, v1 = 0.f;
              if (inside && n < ch) {
                const float2 b = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(p.b_up + n));
                v0 = u_acc[4 * j + 2 * h2] + b.x;
                v1 = u_acc[4 * j + 2 * h2 + 1] + b.y;
              }
              *reinterpret_cast<__nv_bfloat162*>(row + n) =
                  __floats2bfloat162_rn(v0, v1);
            }
          }
        }
        consumer_sync();  // the slab is whole; the source rows are spent
        produced = true;
      }
    }
    if (!produced) {
      // the slab, zero outside the window and in columns [ch, cp), by
      // cp.async (a copy of 0 source bytes writes zeros), all in flight at
      // once
      const bf16* xb =
          p.x + static_cast<long long>(blockIdx.y) * p.t_len * ch;
      const int vecs = p.cp / 8;
      for (int e = tid; e < slab_rows * vecs; e += 128 * CONSUMERS) {
        const int r = e / vecs, c = (e % vecs) * 8;
        const int pos = t0 - e0 + r;
        const bool ok = c < ch && pos >= p.lo && pos < p.hi;
        hopper::cp_async_16(
            slab + r * ld + c,
            ok ? xb + static_cast<long long>(pos) * ch + c : xb, ok);
      }
      hopper::cp_async_wait_all();
    }
    // h's columns [ch, cp), which the products read as K
    const int pad_vecs = (p.cp - ch) / 8;
    const int h_rows0 = p.tm + 2 * p.ext[1] + 2;
    for (int e = tid; e < h_rows0 * pad_vecs; e += 128 * CONSUMERS)
      *reinterpret_cast<uint4*>(hbuf + (e / pad_vecs) * ld + ch +
                                (e % pad_vecs) * 8) = zero;
    consumer_sync();

    for (int i = 0; i < p.n; ++i) {
      const int d = p.dils[i], eo = p.ext[i + 1];
      const bool last = i + 1 == p.n;
      // one convolution's passes; `which.value` 0 is conv1, 1 conv2
      auto conv_product = [&](auto which) {
        const int conv = which.value;
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
            idle(per_pass);
            continue;
          }
          const int m = pair / p.chunks, nb = pair % p.chunks;
          // this lane's ldmatrix row at the centre tap and its column
          const int row_c = first + m * ROWS + wq * 16 + lane % 16;
          const bf16* col = src + 8 * (lane / 16);

          // one stage: A of (tap, kc) into `cur` (conv1: LeakyReLU'd in
          // registers), then its wgmmas. Rows past the source feed only
          // output rows past `rows`: they are clamped to stay inside shared
          // memory.
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
            multiply(acc, st, nb, cur, prev);
          };
          int st = 0;
          for (; st + 1 < per_pass; st += 2) {
            step_one(st, a0, a1);
            step_one(st + 1, a1, a0);
          }
          if (st < per_pass) step_one(st, a0, a1);  // an odd stage count
          retire(acc, a0, a1);

          // epilogue: thread holds rows r0, r0 + 8 and, for j < N/8, the
          // column pair c0 + 8j
          const int r0 = m * ROWS + wq * 16 + lane / 4;
          const int c0 = nb * N + 2 * (lane % 4);
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
              for (int j = 0; j < N / 8; ++j) {
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
              for (int j = 0; j < N / 8; ++j) {
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
      };
      if constexpr (N == 256) {
        // K2: one loop for both, as it has been (a copy for each
        // convolution leaves its N = 256 wgmmas too few registers: ptxas
        // serializes them, C7512, and stage 1's chain takes 1.47 ms, not
        // 1.23, on an H100)
        for (int c = 0; c < 2; ++c) {
          conv_product(Which{c});
          consumer_sync();  // h (or the slab) is whole for the next product
        }
      } else {
        // at N = C a copy for each convolution, its branches decided when
        // compiled: the chains with the upsample run 6-8 % faster on an
        // H100
        conv_product(std::integral_constant<int, 0>{});
        consumer_sync();  // h is whole before conv2
        conv_product(std::integral_constant<int, 1>{});
        consumer_sync();  // the slab is whole before the next block
      }
    }
  }
}

// Fills the ring's stage count from the shared memory left and launches.
template <int KS, int N>
int launch(Params p, const bf16* w1, const bf16* w2, const bf16* w_up,
           int batch, long long fixed, cudaStream_t stream) {
  // w [n, 3, C, C] as [n*3][C (K)][C (N)], w_up [2s, Cin, C] as
  // [2s][Cin (K)][C (N)]: boxes of 64 columns x BK rows of one matrix; rows
  // and columns past the tensor read as zeros
  constexpr int BK = Stage<KS, N>::BK;
  CUtensorMap map_w1, map_w2, map_up;
  int rc = hopper::encode_bf16_3d(&map_w1, w1, p.ch, p.ch, 3 * p.n, BOX_COLS,
                                  BK, 1);
  if (rc != cudaSuccess) return rc;
  rc = hopper::encode_bf16_3d(&map_w2, w2, p.ch, p.ch, 3 * p.n, BOX_COLS, BK,
                              1);
  if (rc != cudaSuccess) return rc;
  map_up = map_w1;  // unread without the upsample
  if (p.up) {
    rc = hopper::encode_bf16_3d(&map_up, w_up, p.ch, p.cin, 2 * p.scale,
                                BOX_COLS, BK, 1);
    if (rc != cudaSuccess) return rc;
  }
  const long long per_stage = p.chunks * Stage<KS, N>::CHUNK_BYTES + 16;
  const long long room = SMEM_LIMIT - 1024 - fixed;
  p.stages = room / per_stage < MAX_STAGES
                 ? static_cast<int>(room / per_stage) : MAX_STAGES;
  const size_t smem = 1024 + p.stages * per_stage + fixed;
  cudaError_t err = cudaFuncSetAttribute(
      chain_wgmma_kernel<KS, N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (p.t_len + p.tm - 1) / p.tm;
  const dim3 grid(tiles, batch);
  chain_wgmma_kernel<KS, N><<<grid, THREADS, smem, stream>>>(
      map_w1, map_w2, map_up, p);
  return cudaGetLastError();
}

// Fills the chain's arguments; false for arguments it does not take.
bool chain_params(Params& p, const void* b1, const void* b2, void* y,
                  int batch, int t_len, int ch, int n, const int* dils,
                  int tm, float slope, float final_slope, int has_final,
                  int lo, int hi) {
  if (batch < 1 || t_len < 1 || ch < 8 || ch % 8 || n < 1 ||
      n > MAX_BLOCKS || tm < 1)
    return false;
  p.b1 = static_cast<const bf16*>(b1);
  p.b2 = static_cast<const bf16*>(b2);
  p.y = static_cast<bf16*>(y);
  p.t_len = t_len;
  p.ch = ch;
  p.n = n;
  p.cp = (ch + CP_ALIGN - 1) / CP_ALIGN * CP_ALIGN;
  p.ext[n] = 0;
  for (int i = n - 1; i >= 0; --i) {
    if (dils[i] < 1) return false;
    p.dils[i] = dils[i];
    p.ext[i] = p.ext[i + 1] + dils[i] + 1;
  }
  p.tm = tm;
  p.slope = slope;
  p.final_slope = final_slope;
  p.has_final = has_final;
  p.lo = lo < 0 ? 0 : lo;
  p.hi = hi > t_len ? t_len : hi;
  return true;
}

// Picks the product width (N = cp up to 128 channels, 256-column chunks
// above) and the stage depth, checks that MIN_STAGES 32-deep stages fit
// beside the slab and h (or the upsample's source rows, the larger), and
// launches.
int launch_chain(Params p, const void* w1, const void* w2, const void* w_up,
                 int batch, cudaStream_t s) {
  const int n_cols = p.cp <= 128 ? p.cp : 256;
  p.chunks = (p.ch + n_cols - 1) / n_cols;
  const long long ld = p.cp + 8;
  long long h_bytes = (p.tm + 2LL * p.ext[1] + 2) * ld * 2;
  if (p.up) {
    if (n_cols > 128) return cudaErrorInvalidValue;
    const long long slab_rows = p.tm + 2LL * p.ext[0];
    // at most (slab_rows - 1) / s + 2 rows q, and the row above the first
    const long long src = ((slab_rows - 1) / p.scale + 3) * (p.cinp + 8) * 2;
    h_bytes = src > h_bytes ? src : h_bytes;
  }
  const long long fixed = (p.tm + 2LL * p.ext[0]) * ld * 2 + h_bytes;
  const long long room = SMEM_LIMIT - 1024 - fixed;
  auto fits = [&](int chunk_bytes) {
    return room >= MIN_STAGES * (p.chunks * chunk_bytes + 16LL);
  };
  const bf16* w1b = static_cast<const bf16*>(w1);
  const bf16* w2b = static_cast<const bf16*>(w2);
  const bf16* wub = static_cast<const bf16*>(w_up);
  auto go = [&](auto n_tag) -> int {
    constexpr int N = decltype(n_tag)::value;
    if (!fits(Stage<2, N>::CHUNK_BYTES)) return cudaErrorInvalidValue;
    if (p.chunks == 1 && fits(Stage<4, N>::CHUNK_BYTES))
      return launch<4, N>(p, w1b, w2b, wub, batch, fixed, s);
    return launch<2, N>(p, w1b, w2b, wub, batch, fixed, s);
  };
  if (n_cols == 64) return go(std::integral_constant<int, 64>{});
  if (n_cols == 128) return go(std::integral_constant<int, 128>{});
  return go(std::integral_constant<int, 256>{});
}

// ------------------------------------------------------------ one block

struct ShiftParams {
  const bf16* x;   // [batch, t_len, ch]: the residual
  const bf16* b1;  // [ch]
  const bf16* b2;
  bf16* y;         // [batch, t_len, ch]
  int t_len, ch, d;
  int cp;          // ch rounded up to CP_ALIGN: the K of one tap
  int chunks;      // column chunks of N
  int tm;          // output rows of a tile: h rows - 2
  int tiles;       // tiles of a batch row; tile j of row b is job b*tiles+j
  int jobs;        // tiles * batch
  int stages;      // of the ring
  float slope, final_slope;
  int has_final;
  int lo, hi;      // the signal window, clamped to [0, t_len]
};

// One block at dilation d. A persistent thread block walks the tiles
// blockIdx.x, + gridDim.x, ...: tile j of batch row b is output rows [t0,
// t0 + tm), t0 = j * tm, from h rows [t0 - 1, t0 + tm + 1): two 64-row
// tiles at one column chunk, so that one pass keeps both warpgroups busy,
// else one (a pass covers its chunks). The producer runs on into the next
// tile's stages
// while the consumers finish a tile, so that its loads are in flight
// during the epilogues. conv1's A is x itself at the three taps: per
// ring stage the producer loads, beside the weights, one 64-row box of x
// for each warpgroup's tile at row t0 - 1 + 64m + (tap - 1)d, from a tensor
// map over the window's rows, so that rows outside [lo, hi) arrive as
// zeros (no d-sized halo: d goes up to 2187). The box is swizzled (128
// bytes at 64-deep stages, 64 at 32-deep), ldmatrix reads it at swizzled
// addresses and conv1's LeakyReLU is applied to the registers. conv2 reads
// h in shared memory as the chain does; its epilogue reads the residual
// and writes y straight from the accumulators. Shared memory: the ring
// (weights of every chunk, then the two x boxes), its barriers and h
// [tm + 2][cp + 8].
template <int KS, int N>
__global__ void __launch_bounds__(THREADS, 1)
shift_wgmma_kernel(const __grid_constant__ CUtensorMap map_w1,
                   const __grid_constant__ CUtensorMap map_w2,
                   const __grid_constant__ CUtensorMap map_x,
                   const ShiftParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023))
                              & 1023);
  constexpr int BK = Stage<KS, N>::BK;
  constexpr int BOX_BYTES = Stage<KS, N>::BOX_BYTES;
  constexpr int CHUNK_BYTES = Stage<KS, N>::CHUNK_BYTES;
  constexpr int A_BYTES = Stage<KS, N>::A_BYTES;
  const int stages = p.stages;
  const int w_bytes = p.chunks * CHUNK_BYTES;
  const int stage_bytes = w_bytes + CONSUMERS * A_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * stage_bytes);
  uint64_t* empty = full + stages;
  bf16* hbuf = reinterpret_cast<bf16*>(empty + stages);
  const int ld = p.cp + 8;
  const int h_rows = p.tm + 2;
  const int ksteps = p.cp / BK;
  const int per_pass = 3 * ksteps;
  // conv1 (h_rows rows) and conv2 (tm rows) cover the same 64-row tiles
  const int pairs = (h_rows / ROWS) * p.chunks;
  const int passes = (pairs + CONSUMERS - 1) / CONSUMERS;

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
      const int boxes = w_bytes / BOX_BYTES;
      int s = 0, it = 0;
      uint32_t phase = 0;
      for (int job = blockIdx.x; job < p.jobs; job += gridDim.x) {
        const int t0 = (job % p.tiles) * p.tm, bi = job / p.tiles;
        for (int conv = 0; conv < 2; ++conv) {
          const CUtensorMap* map = conv ? &map_w2 : &map_w1;
          for (int pass = 0; pass < passes; ++pass) {
            for (int st = 0; st < per_pass; ++st) {
              const int tap = st / ksteps, kc = (st % ksteps) * BK;
              if (it >= stages) hopper::mbar_wait(&empty[s], phase ^ 1);
              hopper::mbar_arrive_expect_tx(&full[s],
                                            conv ? w_bytes : stage_bytes);
              uint8_t* dst = ring + s * stage_bytes;
              for (int b = 0; b < boxes; ++b)
                hopper::tma_load_3d(dst + b * BOX_BYTES, map, &full[s],
                                    b * BOX_COLS, kc, tap);
              if (conv == 0) {
                // each warpgroup's x rows at this tap (an idle one's are
                // loaded all the same), in the window's coordinates
                for (int c = 0; c < CONSUMERS; ++c) {
                  const int pair = min(pass * CONSUMERS + c, pairs - 1);
                  const int row = t0 - 1 + (pair / p.chunks) * ROWS +
                                  (tap - 1) * p.d - p.lo;
                  hopper::tma_load_3d(dst + w_bytes + c * A_BYTES, &map_x,
                                      &full[s], kc, row, bi);
                }
              }
              if (++s == stages) s = 0, phase ^= 1;
              ++it;
            }
          }
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<232>();
    const int tid = threadIdx.x;
    const int lane = tid % 32, wq = (tid % 128) / 32;
    const int ch = p.ch;
    const float slope = p.slope;

    // h's columns [ch, cp), which conv2 reads as K
    const int pad_vecs = (p.cp - ch) / 8;
    for (int e = tid; e < h_rows * pad_vecs; e += 128 * CONSUMERS)
      *reinterpret_cast<uint4*>(hbuf + (e / pad_vecs) * ld + ch +
                                (e % pad_vecs) * 8) = make_uint4(0, 0, 0, 0);

    uint32_t a0[KS][4], a1[KS][4];
    int s = 0, prev_s = 0;
    uint32_t phase = 0;
    auto release = [&](int stage) {
      if (lane == 0) hopper::mbar_arrive(&empty[stage]);
    };
    // a warpgroup without a tile in a pass takes and hands back its stages
    auto idle = [&](int n_st) {
      for (int st = 0; st < n_st; ++st) {
        hopper::mbar_wait(&full[s], phase);
        release(s);
        if (++s == stages) s = 0, phase ^= 1;
      }
    };
    // this lane's ldmatrix row in a 64-row x box, and its 16-byte column
    // group of a k step: the box's swizzle moves group c of row r to c ^ (r
    // % 8) (128-byte rows) or c ^ (r / 2 % 4) (64-byte rows)
    const int arow = wq * 16 + lane % 16;
    const int swz = BK == 64 ? arow % 8 : arow / 2 % 4;

    // one convolution's passes over tile (t0, bi); `which.value` 0 is
    // conv1, 1 conv2
    auto conv_product = [&](auto which, int t0, int bi) {
      const int conv = which.value;
      for (int pass = 0; pass < passes; ++pass) {
        const int pair = pass * CONSUMERS + wg;
        if (pair >= pairs) {
          idle(per_pass);
          continue;
        }
        const int m = pair / p.chunks, nb = pair % p.chunks;
        // the pass's accumulators: its first wgmma overwrites them
        float acc[N / 2];
        // conv2: this lane's h row at the centre tap (h row 0 is t0 - 1)
        const int row_c = 1 + m * ROWS + arow;

        // one stage: A of (tap, kc) into `cur` once the stage has landed
        // (conv1: the stage's x box, LeakyReLU'd in registers; conv2: h,
        // rows past it, which feed only rows past tm, clamped), then its
        // wgmmas; then the previous stage's products are retired and that
        // stage handed back
        auto step_one = [&](int st, uint32_t (&cur)[KS][4],
                            uint32_t (&prev)[KS][4]) {
          const int tap = st / ksteps, kc = (st % ksteps) * BK;
          uint8_t* stage = ring + s * stage_bytes;
          hopper::mbar_wait(&full[s], phase);
          if (conv == 0) {
            const uint8_t* box = stage + w_bytes + wg * A_BYTES +
                                 arow * (BK * 2);
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) {
              hopper::ldmatrix_x4(cur[kk],
                                  box + (((2 * kk + lane / 16) ^ swz) << 4));
#pragma unroll
              for (int q = 0; q < 4; ++q)
                cur[kk][q] = lrelu2(cur[kk][q], slope);
            }
          } else {
            int r = row_c + tap - 1;
            r = r >= h_rows ? h_rows - 1 : r;
            const bf16* src = hbuf + r * ld + kc + 8 * (lane / 16);
#pragma unroll
            for (int kk = 0; kk < KS; ++kk)
              hopper::ldmatrix_x4(cur[kk], src + 16 * kk);
          }
          hopper::wgmma_fence();
          const uint64_t db = hopper::smem_desc_sw128(
              stage + nb * CHUNK_BYTES, BOX_BYTES, 1024);
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)  // 16 k a step: two 8-k groups
            mma<N>(acc, cur[kk], hopper::desc_advance(db, kk * 2048),
                   st > 0 || kk > 0);
          hopper::wgmma_commit();
          if (st > 0) {
            hopper::wgmma_wait<1>();
#pragma unroll
            for (int kk = 0; kk < KS; ++kk)
#pragma unroll
              for (int q = 0; q < 4; ++q) hopper::fence_operand(prev[kk][q]);
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
        for (int q = 0; q < N / 2; ++q) hopper::fence_operand(acc[q]);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            hopper::fence_operand(a0[kk][q]);
            hopper::fence_operand(a1[kk][q]);
          }
        release(prev_s);

        // epilogue: thread holds rows r0, r0 + 8 and, for j < N/8, the
        // column pair c0 + 8j
        const int r0 = m * ROWS + wq * 16 + lane / 4;
        const int c0 = nb * N + 2 * (lane % 4);
        // the epilogues load G column pairs of bias (and residual) before
        // storing their results: a load after a store that may alias it
        // waits for the store
        constexpr int G = N / 8 < 8 ? N / 8 : 8;
        if (conv == 0) {
#pragma unroll
          for (int j0 = 0; j0 < N / 8; j0 += G) {
            float2 bias[G];
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const int n = c0 + 8 * (j0 + g);
              bias[g] = n < ch ? __bfloat1622float2(
                                     *reinterpret_cast<const __nv_bfloat162*>(
                                         p.b1 + n))
                               : make_float2(0.f, 0.f);
            }
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const int hr = r0 + 8 * h2;
              const int pos = t0 - 1 + hr;
              const bool inside = pos >= p.lo && pos < p.hi;
#pragma unroll
              for (int g = 0; g < G; ++g) {
                const int j = j0 + g, n = c0 + 8 * j;
                if (n >= ch) continue;
                const float v0 = inside
                    ? lrelu(acc[4 * j + 2 * h2] + bias[g].x, slope) : 0.f;
                const float v1 = inside
                    ? lrelu(acc[4 * j + 2 * h2 + 1] + bias[g].y, slope)
                    : 0.f;
                *reinterpret_cast<__nv_bfloat162*>(hbuf + hr * ld + n) =
                    __floats2bfloat162_rn(v0, v1);
              }
            }
          }
        } else {
          const long long boff = static_cast<long long>(bi) * p.t_len * ch;
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int yr = r0 + 8 * h2;
            const int pos = t0 + yr;
            if (yr >= p.tm || pos >= p.t_len) continue;
            // rows of the array outside the window are written as zeros
            const bool inside = pos >= p.lo && pos < p.hi;
            const long long at = boff + static_cast<long long>(pos) * ch;
#pragma unroll
            for (int j0 = 0; j0 < N / 8; j0 += G) {
              __nv_bfloat162 bias[G], res[G];
#pragma unroll
              for (int g = 0; g < G; ++g) {
                const int n = c0 + 8 * (j0 + g);
                bias[g] = res[g] = __floats2bfloat162_rn(0.f, 0.f);
                if (inside && n < ch) {
                  bias[g] =
                      *reinterpret_cast<const __nv_bfloat162*>(p.b2 + n);
                  res[g] = *reinterpret_cast<const __nv_bfloat162*>(
                      p.x + at + n);
                }
              }
#pragma unroll
              for (int g = 0; g < G; ++g) {
                const int j = j0 + g, n = c0 + 8 * j;
                if (n >= ch) continue;
                float v0 = 0.f, v1 = 0.f;
                if (inside) {
                  const float2 b = __bfloat1622float2(bias[g]);
                  const float2 r = __bfloat1622float2(res[g]);
                  v0 = acc[4 * j + 2 * h2] + b.x + r.x;
                  v1 = acc[4 * j + 2 * h2 + 1] + b.y + r.y;
                }
                if (p.has_final) {
                  v0 = lrelu(v0, p.final_slope);
                  v1 = lrelu(v1, p.final_slope);
                }
                *reinterpret_cast<__nv_bfloat162*>(p.y + at + n) =
                    __floats2bfloat162_rn(v0, v1);
              }
            }
          }
        }
      }
    };
    for (int job = blockIdx.x; job < p.jobs; job += gridDim.x) {
      const int t0 = (job % p.tiles) * p.tm, bi = job / p.tiles;
      if constexpr (N == 256) {
        // one loop for both convolutions, as K2's chain (a copy for each
        // leaves its N = 256 wgmmas too few registers)
        for (int c = 0; c < 2; ++c) {
          conv_product(Which{c}, t0, bi);
          // h is whole before conv2, and read before the next tile's conv1
          consumer_sync();
        }
      } else {
        conv_product(std::integral_constant<int, 0>{}, t0, bi);
        consumer_sync();  // h is whole before conv2
        conv_product(std::integral_constant<int, 1>{}, t0, bi);
        consumer_sync();  // h is read before the next tile's conv1
      }
    }
  }
}

// Fills the ring's stage count from the shared memory left beside h and
// launches.
template <int KS, int N>
int launch_shift(ShiftParams p, const bf16* w1, const bf16* w2, int batch,
                 long long fixed, cudaStream_t stream) {
  // w [3, C, C] as [3][C (K)][C (N)] in boxes of 64 columns x BK rows; x's
  // rows [lo, hi) of each batch row as [batch][hi - lo][C] in boxes of BK
  // columns x 64 rows (an empty window: one row that no output reads)
  constexpr int BK = Stage<KS, N>::BK;
  CUtensorMap map_w1, map_w2, map_x;
  int rc = hopper::encode_bf16_3d(&map_w1, w1, p.ch, p.ch, 3, BOX_COLS, BK,
                                  1);
  if (rc != cudaSuccess) return rc;
  rc = hopper::encode_bf16_3d(&map_w2, w2, p.ch, p.ch, 3, BOX_COLS, BK, 1);
  if (rc != cudaSuccess) return rc;
  const bool empty_window = p.hi <= p.lo;
  rc = hopper::encode_bf16_3d(
      &map_x, p.x + (empty_window ? 0 : static_cast<long long>(p.lo) * p.ch),
      p.ch, empty_window ? 1 : p.hi - p.lo, batch, BK, ROWS, 1,
      static_cast<uint64_t>(p.t_len) * p.ch,
      BK == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
  if (rc != cudaSuccess) return rc;
  const long long per_stage = p.chunks * Stage<KS, N>::CHUNK_BYTES +
                              CONSUMERS * Stage<KS, N>::A_BYTES + 16;
  const long long room = SMEM_LIMIT - 1024 - fixed;
  p.stages = room / per_stage < MAX_STAGES
                 ? static_cast<int>(room / per_stage) : MAX_STAGES;
  const size_t smem = 1024 + p.stages * per_stage + fixed;
  cudaError_t err = cudaFuncSetAttribute(
      shift_wgmma_kernel<KS, N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  p.tiles = (p.t_len + p.tm - 1) / p.tm;
  p.jobs = p.tiles * batch;
  shift_wgmma_kernel<KS, N><<<p.jobs < sms ? p.jobs : sms, THREADS, smem,
                              stream>>>(map_w1, map_w2, map_x, p);
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
  Params p{};
  if (!chain_params(p, b1, b2, y, batch, t_len, ch, n, dils, tm, slope,
                    final_slope, has_final, lo, hi))
    return cudaErrorInvalidValue;
  p.x = static_cast<const bf16*>(x);
  return launch_chain(p, w1, w2, nullptr, batch,
                      static_cast<cudaStream_t>(stream));
}

// The first group of up_res_stream in bfloat16: a = x + sin(x) (x_src
// [batch, t_in, cin] into the scratch a of the same shape, cin a multiple
// of 8), then the chain of n blocks on the upsampled signal, produced tile
// by tile in shared memory. w_up: [2*scale, cin, ch] in torch tap order;
// b_up: [ch]; y: [batch, t_in*scale, ch]; the rest as for
// vf_res_chain_wgmma, with no window. ch <= 128.
extern "C" int vf_up_chain_wgmma(const void* x_src, void* a,
                                 const void* w_up, const void* b_up,
                                 const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* y,
                                 int batch, int t_in, int cin, int ch,
                                 int scale, int n, const int* dils, int tm,
                                 float slope, float final_slope,
                                 int has_final, void* stream) {
  if (t_in < 1 || cin < 8 || cin % 8 || scale < 1 || ch > 128)
    return cudaErrorInvalidValue;
  const long long t_len = static_cast<long long>(t_in) * scale;
  if (t_len * ch >= 0x7fffffffLL) return cudaErrorInvalidValue;
  Params p{};
  if (!chain_params(p, b1, b2, y, batch, static_cast<int>(t_len), ch, n,
                    dils, tm, slope, final_slope, has_final, 0,
                    static_cast<int>(t_len)))
    return cudaErrorInvalidValue;
  p.up = 1;
  p.a = static_cast<const bf16*>(a);
  p.b_up = static_cast<const bf16*>(b_up);
  p.t_in = t_in;
  p.cin = cin;
  p.cinp = (cin + CP_ALIGN - 1) / CP_ALIGN * CP_ALIGN;
  p.scale = scale;
  auto s = static_cast<cudaStream_t>(stream);
  vf::launch_sin_residual(static_cast<const bf16*>(x_src),
                          static_cast<bf16*>(a),
                          static_cast<long long>(batch) * t_in * cin, s);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_chain(p, w1, w2, w_up, batch, s);
}

// One block at dilation d (K3 res_shift_single, and the single blocks of K4
// up_res_stream and K7 res_stream). x, y: [batch, t_len, ch] bfloat16, ch a
// multiple of 8; w1, w2: [3*ch, ch] (tap*in, out); b1, b2: [ch]. y must not
// alias x. [lo, hi) is the signal window in rows (0, t_len for the whole
// array): rows outside it are zero padding, and are written as zeros. The
// product width is that of the chains (N = cp up to 128 channels, 256-column
// chunks above); stages are 64 deep where MIN_STAGES of those fit and the
// width is one chunk, else 32.
extern "C" int vf_res_shift_wgmma(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, void* y, int batch,
                                  int t_len, int ch, int d, float slope,
                                  float final_slope, int has_final, int lo,
                                  int hi, void* stream) {
  if (batch < 1 || t_len < 1 || ch < 8 || ch % 8 || d < 1)
    return cudaErrorInvalidValue;
  ShiftParams p{};
  p.x = static_cast<const bf16*>(x);
  p.b1 = static_cast<const bf16*>(b1);
  p.b2 = static_cast<const bf16*>(b2);
  p.y = static_cast<bf16*>(y);
  p.t_len = t_len;
  p.ch = ch;
  p.d = d;
  p.cp = (ch + CP_ALIGN - 1) / CP_ALIGN * CP_ALIGN;
  const int n_cols = p.cp <= 128 ? p.cp : 256;
  p.chunks = (ch + n_cols - 1) / n_cols;
  p.tm = ROWS * (p.chunks == 1 ? 2 : 1) - 2;
  p.slope = slope;
  p.final_slope = final_slope;
  p.has_final = has_final;
  p.lo = lo < 0 ? 0 : (lo > t_len ? t_len : lo);
  p.hi = hi > t_len ? t_len : hi;
  const long long fixed = (p.tm + 2LL) * (p.cp + 8) * 2;  // h
  const long long room = SMEM_LIMIT - 1024 - fixed;
  const bf16* w1b = static_cast<const bf16*>(w1);
  const bf16* w2b = static_cast<const bf16*>(w2);
  auto s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto n_tag) -> int {
    constexpr int N = decltype(n_tag)::value;
    auto fits = [&](int chunk_bytes, int a_bytes) {
      return room >= MIN_STAGES * (p.chunks * chunk_bytes +
                                   CONSUMERS * a_bytes + 16LL);
    };
    if (!fits(Stage<2, N>::CHUNK_BYTES, Stage<2, N>::A_BYTES))
      return cudaErrorInvalidValue;
    if (p.chunks == 1 && fits(Stage<4, N>::CHUNK_BYTES, Stage<4, N>::A_BYTES))
      return launch_shift<4, N>(p, w1b, w2b, batch, fixed, s);
    return launch_shift<2, N>(p, w1b, w2b, batch, fixed, s);
  };
  if (n_cols == 64) return go(std::integral_constant<int, 64>{});
  if (n_cols == 128) return go(std::integral_constant<int, 128>{});
  return go(std::integral_constant<int, 256>{});
}
