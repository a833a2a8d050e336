// K11: BigVGAN's AMP convolution in bfloat16 (models/bigvgan.py::amp_block,
// both convs of every AMPBlock1 step): on x [B, T, C],
//   y[t] = b + sum_j x[t + (j - (k-1)/2) d] @ W[j]  (+ r[t])
// with W [k, C, C] (tap, in, out), zero padding d (k-1)/2 a side, float32
// accumulation and one rounding to bfloat16 at the store. The optional r
// is the block's residual: convs2's launch writes the block's new x, so
// the separate add goes.
//
// Replaces no TPU kernel: upstream's AMP convs are plain Conv1d, and the
// JAX package has no BigVGAN. It was added because cuDNN runs these bf16
// dilated convs off the tensor cores on the channels-last view
// (conv2d_grouped_direct_kernel, 97.5 % of a synthesize's device time).
//
// Bound: operations at C >= 96 (2 k C^2 FLOP a row against 4 or 6 C bytes
// of x, y and r); close to bytes at C = 24, where the widths padded to a
// 64-column box multiply the executed work. Design, after K3's single
// block (csrc/resstack_wgmma.cu):
//   - register-A wgmma m64nNk16 (N = 64, 128 or 256; float32 accumulators),
//     A loaded by ldmatrix from a slab: the tile's rows plus d (k-1)/2 a
//     side, 64 input channels deep, which TMA writes in the 128-byte
//     swizzle. Every tap reads the same slab at a row offset, so a dilated
//     tap is only an address and x is read once a 64-channel step, not
//     once a tap. Rows and columns outside x arrive as zeros: the padding;
//   - B (the weights) by TMA, N-major straight from W (the descriptor's
//     transpose bit), a ring stage per (64-channel step, tap) that one
//     producer thread keeps full against full/empty mbarriers; the slab
//     has a ring of two of its own, so the next step's slab lands while
//     the taps of this one run;
//   - two consumer warpgroups share every weight stage, each on MT 64-row
//     tiles: a job is a time tile of 128 MT rows at one column chunk;
//   - persistent blocks walk the jobs (time tile, column chunk, batch row),
//     so that the producer's loads for the next job overlap this one's
//     epilogue. The wrapper (kernels/amp_conv.py::tile) picks N and MT
//     from the shape: few rows get narrow chunks, so that a short clip's
//     wide stages still spread over the SMs;
//   - the epilogue adds the bias (and r) to the accumulators and stores
//     bf16 pairs straight from registers.
// Widths up to 32 fold the taps into K: K row tap * C + c, so that C = 24
// at k = 11 takes 5 stages of 64 K rows, not 11 (the slab holds every
// channel; ldmatrix finds each 8-channel group's tap by its address).
// Other widths that are no multiple of 64 read zero rows and columns from
// the tensor maps, and C <= 64 runs 64 columns. mbar_wait traps after two
// seconds, so a pipeline out of step fails the launch instead of hanging.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int ROWS = 64;       // rows of a warpgroup's wgmma tile
constexpr int BK = 64;         // input channels of a step: one 128-byte row
constexpr int KH = BK / 32;    // wgmma k-steps half a ring stage
constexpr int BOX_COLS = 64;   // one 128-byte swizzled row of a TMA box
constexpr int BOX_BYTES = BK * BOX_COLS * 2;
constexpr int CONSUMERS = 2;   // warpgroups that multiply
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int SLABS = 2;       // the slab's ring
constexpr int MAX_BOX_ROWS = 256;
constexpr int MAX_HALO = 64;   // d (k-1)/2: BigVGAN's largest is 25
constexpr int MIN_STAGES = 2, MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;

struct TapParams {
  const bf16* b;     // [ch]
  const bf16* r;     // [batch, t_len, ch], or null
  bf16* y;           // [batch, t_len, ch]
  int t_len, ch, taps, d;
  int halo;          // d (taps - 1) / 2: slab rows above the tile
  int ksteps;        // 64-channel steps of the input: slabs a job
  int fold;          // 1: the taps folded into K (ch <= 32, one slab)
  int groups;        // 8-channel groups a tap holds in K: ch / 8 folded,
                     // else the 8 of a step
  int slab_stages;   // weight stages a slab: taps, or folded the 64-row
                     // steps of taps * ch
  int chunks;        // column chunks of N
  int tiles;         // time tiles of a batch row
  int jobs;          // tiles * chunks * batch
  int box_rows;      // rows of one TMA box of the slab (a multiple of 8)
  int boxes;         // boxes a slab
  int stages;        // of the weight ring
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

// FOLD: the taps folded into K (p.fold), known when compiled so that the
// unfolded A addresses take no division. Job j: column chunk j % chunks
// of time tile (j / chunks) % tiles of batch row j / (chunks * tiles); the
// tile is output rows [t0, t0 + 128 MT), its slab input rows
// [t0 - halo, t0 + 128 MT + halo). Shared memory: the two
// slabs [boxes * box_rows][64] (1024-aligned), the weight ring [stages]
// [N / 64 boxes][64 k][64 n], then the barriers.
template <int N, int MT, bool FOLD>
__global__ void __launch_bounds__(THREADS, 1)
amp_tap_kernel(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_w,
               const TapParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* slabs = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023))
                               & 1023);
  constexpr int TM = CONSUMERS * MT * ROWS;
  constexpr int W_BYTES = BK * N * 2;
  const int box_bytes = p.box_rows * BK * 2;
  const int slab_bytes = p.boxes * box_bytes;
  const int stages = p.stages;
  uint8_t* ring = slabs + SLABS * slab_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * W_BYTES);
  uint64_t* empty = full + stages;
  uint64_t* slab_full = empty + stages;
  uint64_t* slab_empty = slab_full + SLABS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS * 4);
    }
    for (int s = 0; s < SLABS; ++s) {
      hopper::mbar_init(&slab_full[s], 1);
      hopper::mbar_init(&slab_empty[s], CONSUMERS * 4);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // producer: one thread starts every load, in the consumers' order
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 128 * CONSUMERS) {
      int s = 0, it = 0, sb = 0, sit = 0;
      uint32_t phase = 0, sphase = 0;
      for (int job = blockIdx.x; job < p.jobs; job += gridDim.x) {
        const int nb = job % p.chunks, rest = job / p.chunks;
        const int t0 = (rest % p.tiles) * TM, bi = rest / p.tiles;
        for (int kc = 0; kc < p.ksteps; ++kc) {
          if (sit >= SLABS) hopper::mbar_wait(&slab_empty[sb], sphase ^ 1);
          hopper::mbar_arrive_expect_tx(&slab_full[sb], slab_bytes);
          for (int bx = 0; bx < p.boxes; ++bx)
            hopper::tma_load_3d(slabs + sb * slab_bytes + bx * box_bytes,
                                &map_x, &slab_full[sb], kc * BK,
                                t0 - p.halo + bx * p.box_rows, bi);
          if (++sb == SLABS) sb = 0, sphase ^= 1;
          ++sit;
          for (int j = 0; j < p.slab_stages; ++j) {
            // K rows [64 j, 64 j + 64) of w as [1][taps * ch][ch] folded,
            // else rows [64 kc, 64 kc + 64) of tap j
            const int wrow = p.fold ? j * BK : kc * BK;
            if (it >= stages) hopper::mbar_wait(&empty[s], phase ^ 1);
            hopper::mbar_arrive_expect_tx(&full[s], W_BYTES);
            for (int b = 0; b < N / BOX_COLS; ++b)
              hopper::tma_load_3d(ring + s * W_BYTES + b * BOX_BYTES, &map_w,
                                  &full[s], nb * N + b * BOX_COLS, wrow,
                                  p.fold ? 0 : j);
            if (++s == stages) s = 0, phase ^= 1;
            ++it;
          }
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<232>();
    const int lane = threadIdx.x % 32, wq = (threadIdx.x % 128) / 32;
    // this lane's ldmatrix row of its warpgroup's first tile, in slab rows
    // at tap 0, and its 16-byte column group of a k-step
    const int arow = wg * MT * ROWS + wq * 16 + lane % 16;
    const int col16 = lane / 16;
    const int n_st = p.ksteps * p.slab_stages;
    int s = 0, sb = 0;
    uint32_t phase = 0, sphase = 0;
    // A of half a stage (KH k-steps of every tile) in a0, of the other half
    // in a1: a half's registers are rewritten only after the wait that
    // retires the products reading them
    uint32_t a0[KH][MT][4], a1[KH][MT][4];
    auto release = [&](uint64_t* bar) {
      if (lane == 0) hopper::mbar_arrive(bar);
    };
    for (int job = blockIdx.x; job < p.jobs; job += gridDim.x) {
      const int nb = job % p.chunks, rest = job / p.chunks;
      const int t0 = (rest % p.tiles) * TM, bi = rest / p.tiles;
      // the job's accumulators: its first wgmma overwrites them
      float acc[MT][N / 2];
      int prev_s = 0, prev_sb = 0;
      for (int st = 0; st < n_st; ++st) {
        // ring stage st is stage j of slab kc: A of every tile once the
        // stage (and at j = 0 the slab) has landed, its products in two
        // halves of KH k-steps, each half's registers free once the
        // previous stage's same half has retired; then that stage is
        // handed back, with its slab where this stage starts a new one.
        // 8-channel group g of K (16 bytes of a slab row) is group
        // g % groups of tap g / groups: unfolded, tap j's 8 of step kc;
        // folded, a k-step may span two taps, and groups past the last
        // tap read tap 0 against the zero rows of w
        const int kc = st / p.slab_stages;
        const int j = st - kc * p.slab_stages;
        if (j == 0) hopper::mbar_wait(&slab_full[sb], sphase);
        hopper::mbar_wait(&full[s], phase);
        const uint8_t* slab = slabs + sb * slab_bytes;
        const uint64_t db =
            hopper::smem_desc_sw128(ring + s * W_BYTES, BOX_BYTES, 1024);
        // folded: this lane's (tap, group) at each k-step of the stage,
        // one division a stage
        int ftap[2 * KH], fgrp[2 * KH];
        if constexpr (FOLD) {
          int g = 8 * j + col16;
          int tp = g / p.groups;
          g -= tp * p.groups;
#pragma unroll
          for (int ks = 0; ks < 2 * KH; ++ks) {
            ftap[ks] = tp < p.taps ? tp : 0;
            fgrp[ks] = g;
            g += 2;  // the next k-step's group: at most two wraps
            if (g >= p.groups) g -= p.groups, ++tp;
            if (g >= p.groups) g -= p.groups, ++tp;
          }
        }
        auto half = [&](uint32_t (&a)[KH][MT][4], int h) {
#pragma unroll
          for (int kk = 0; kk < KH; ++kk) {
            int tap = j, grp = 2 * (h * KH + kk) + col16;
            if constexpr (FOLD) {
              tap = ftap[h * KH + kk];
              grp = fgrp[h * KH + kk];
            }
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              // the box's swizzle moves 16-byte group c of row r to
              // c ^ (r % 8)
              const int row = arow + mt * ROWS + tap * p.d;
              hopper::ldmatrix_x4(a[kk][mt], slab + row * (BK * 2) +
                                                 ((grp ^ (row & 7)) << 4));
            }
          }
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KH; ++kk)  // 16 k a step: two 8-k groups
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma<N>(acc[mt], a[kk][mt],
                     hopper::desc_advance(db, (h * KH + kk) * 2048),
                     st > 0 || h > 0 || kk > 0);
          hopper::wgmma_commit();
        };
        auto retire = [&](uint32_t (&a)[KH][MT][4]) {
          hopper::wgmma_wait<1>();
#pragma unroll
          for (int kk = 0; kk < KH; ++kk)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                hopper::fence_operand(a[kk][mt][q]);
        };
        if (st > 0) retire(a0);  // the previous stage's first half
        half(a0, 0);
        if (st > 0) {
          retire(a1);  // and its second: the stage is free
          release(&empty[prev_s]);
          if (j == 0) release(&slab_empty[prev_sb]);
        }
        half(a1, 1);
        prev_s = s;
        if (++s == stages) s = 0, phase ^= 1;
        if (j == p.slab_stages - 1) {
          prev_sb = sb;
          if (++sb == SLABS) sb = 0, sphase ^= 1;
        }
      }
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int q = 0; q < N / 2; ++q) hopper::fence_operand(acc[mt][q]);
#pragma unroll
      for (int kk = 0; kk < KH; ++kk)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            hopper::fence_operand(a0[kk][mt][q]);
            hopper::fence_operand(a1[kk][mt][q]);
          }
      release(&empty[prev_s]);
      release(&slab_empty[prev_sb]);

      // epilogue: thread holds, per tile mt, rows r0 + 64 mt and 8 below,
      // and for j < N/8 the column pair c0 + 8j. The bias and residual of
      // G column pairs are loaded before their stores.
      const int r0 = wg * MT * ROWS + wq * 16 + lane / 4;
      const int c0 = nb * N + 2 * (lane % 4);
      constexpr int G = N / 8 < 8 ? N / 8 : 8;
      const long long boff = static_cast<long long>(bi) * p.t_len;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int pos = t0 + r0 + mt * ROWS + 8 * h2;
          if (pos >= p.t_len) continue;
          const long long at = (boff + pos) * p.ch;
#pragma unroll
          for (int j0 = 0; j0 < N / 8; j0 += G) {
            float2 bias[G], res[G];
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const int n = c0 + 8 * (j0 + g);
              bias[g] = res[g] = make_float2(0.f, 0.f);
              if (n < p.ch) {
                bias[g] = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(p.b + n));
                if (p.r)
                  res[g] = __bfloat1622float2(
                      *reinterpret_cast<const __nv_bfloat162*>(p.r + at + n));
              }
            }
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const int j = j0 + g, n = c0 + 8 * j;
              if (n >= p.ch) continue;
              const float v0 = acc[mt][4 * j + 2 * h2] + bias[g].x + res[g].x;
              const float v1 =
                  acc[mt][4 * j + 2 * h2 + 1] + bias[g].y + res[g].y;
              *reinterpret_cast<__nv_bfloat162*>(p.y + at + n) =
                  __floats2bfloat162_rn(v0, v1);
            }
          }
        }
      }
    }
  }
}

// Encodes the maps, fills the weight ring's depth from the shared memory
// left beside the slabs and launches one persistent block an SM at most.
template <int N, int MT, bool FOLD = false>
int launch(TapParams p, const bf16* x, const bf16* w, int batch,
           cudaStream_t stream) {
  // x as [batch][t_len][ch] in boxes of 64 channels x box_rows rows; w
  // [taps, ch, ch] as [taps][ch (K)][ch (N)], folded as [1][taps * ch][ch],
  // in boxes of 64 columns x 64 rows; both in the 128-byte swizzle
  CUtensorMap map_x, map_w;
  int rc = hopper::encode_bf16_3d(&map_x, x, p.ch, p.t_len, batch, BOX_COLS,
                                  p.box_rows, 1);
  if (rc != cudaSuccess) return rc;
  rc = p.fold ? hopper::encode_bf16_3d(&map_w, w, p.ch, p.taps * p.ch, 1,
                                       BOX_COLS, BK, 1)
              : hopper::encode_bf16_3d(&map_w, w, p.ch, p.ch, p.taps,
                                       BOX_COLS, BK, 1);
  if (rc != cudaSuccess) return rc;
  constexpr int TM = CONSUMERS * MT * ROWS;
  p.tiles = (p.t_len + TM - 1) / TM;
  p.jobs = p.tiles * p.chunks * batch;
  const long long slabs = SLABS * (static_cast<long long>(p.boxes) *
                                   p.box_rows * BK * 2 + 16);
  const long long per_stage = BK * N * 2 + 16;
  const long long room = SMEM_LIMIT - 1024 - slabs;
  if (room < MIN_STAGES * per_stage) return cudaErrorInvalidValue;
  p.stages = room / per_stage < MAX_STAGES
                 ? static_cast<int>(room / per_stage) : MAX_STAGES;
  const size_t smem = 1024 + slabs + p.stages * per_stage;
  cudaError_t err = cudaFuncSetAttribute(
      amp_tap_kernel<N, MT, FOLD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  amp_tap_kernel<N, MT, FOLD><<<p.jobs < sms ? p.jobs : sms, THREADS, smem,
                                stream>>>(map_x, map_w, p);
  return cudaGetLastError();
}

}  // namespace

// x, y: [batch, t_len, ch] bfloat16, ch a multiple of 8; w: [taps, ch, ch]
// (tap, in, out); b: [ch]; r: [batch, t_len, ch] or null. y must not alias
// x or w. taps odd, d (taps - 1) / 2 at most 64. The tile: n_cols columns a
// chunk (64, 128 or 256, dividing ch rounded up to 64) and m_tiles 64-row
// tiles a warpgroup (1, or 2 at n_cols = 64: 64 accumulators a tile). Returns
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int vf_amp_conv(const void* x, const void* w, const void* b,
                           const void* r, void* y, int batch, int t_len,
                           int ch, int taps, int d, int n_cols, int m_tiles,
                           void* stream) {
  if (batch < 1 || t_len < 1 || ch < 8 || ch % 8 || taps < 1 ||
      taps % 2 == 0 || d < 1)
    return cudaErrorInvalidValue;
  const long long halo = static_cast<long long>(d) * (taps - 1) / 2;
  const int cp = (ch + BK - 1) / BK * BK;
  if (halo > MAX_HALO || (m_tiles != 1 && !(m_tiles == 2 && n_cols == 64)) ||
      (n_cols != 64 && n_cols != 128 && n_cols != 256) || cp % n_cols)
    return cudaErrorInvalidValue;
  TapParams p{};
  p.b = static_cast<const bf16*>(b);
  p.r = static_cast<const bf16*>(r);
  p.y = static_cast<bf16*>(y);
  p.t_len = t_len;
  p.ch = ch;
  p.taps = taps;
  p.d = d;
  p.halo = static_cast<int>(halo);
  p.ksteps = cp / BK;
  // folded where it at least halves the weight stages: C = 24 at k = 11
  // takes 5, not 11 (C = 48, 9 for 11, measured slower: PERF.md)
  p.fold = ch <= BK / 2;
  p.groups = p.fold ? ch / 8 : BK / 8;
  p.slab_stages = p.fold ? (taps * ch + BK - 1) / BK : taps;
  p.chunks = cp / n_cols;
  // the slab's rows in as few boxes of at most 256 rows as hold them
  const int rows = CONSUMERS * m_tiles * ROWS + 2 * p.halo;
  p.boxes = (rows + MAX_BOX_ROWS - 1) / MAX_BOX_ROWS;
  p.box_rows = ((rows + p.boxes - 1) / p.boxes + 7) / 8 * 8;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  auto s = static_cast<cudaStream_t>(stream);
  if (n_cols == 256) return launch<256, 1>(p, xb, wb, batch, s);
  if (n_cols == 128) return launch<128, 1>(p, xb, wb, batch, s);
  if (p.fold)
    return m_tiles == 2 ? launch<64, 2, true>(p, xb, wb, batch, s)
                        : launch<64, 1, true>(p, xb, wb, batch, s);
  return m_tiles == 2 ? launch<64, 2>(p, xb, wb, batch, s)
                      : launch<64, 1>(p, xb, wb, batch, s);
}
