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
// The state h is float32; the product sees h rounded to W's type and sums in
// float32. The forward direction walks t = 0 .. T-1, the backward T-1 .. 0,
// each exactly T steps (the TPU kernel's padded-step masking existed only for
// its time tiles).
//
// Bound: the latency of one step, not bytes or FLOPs. T steps are sequential
// and each needs the whole [H, 3H] recurrent matrix (768 KB in float32 at
// H = 256), more than one SM holds, so a cluster of CL blocks per (batch
// row, direction) shares it, and every step ends in an exchange of h between
// the blocks. Design:
// - CL = 16 (fewer warps a block, a shorter product) where the card runs
//   every cluster of the launch at once, else 8, the portable size.
// - Block c owns U hidden units (U = ceil(H / CL) rounded up to a whole
//   warp's UPW units) and their r, z and n columns. Warp w owns UPW of them;
//   its lanes are UPW groups of 8, one unit a group, and lane ks of a group
//   holds the unit's three columns at the K values 32 i + 4 ks + j (i < KI,
//   j < 4) in registers for the whole sequence (bfloat16 as packed pairs),
//   so W is read from memory once a launch and h is read from shared memory
//   as float4, eight lanes reading 128 contiguous bytes.
// - The product runs CHAINS independent accumulators per column; three
//   shuffle rounds sum a unit's columns over its 8 lanes, and the group's
//   first lane applies the gates (on the fast exponential). No block
//   barrier: the unit's columns never leave the warp.
// - The warp gathers its UPW new values (rounded to W's type) by shuffles,
//   and lane p pushes them to block p of the cluster with one 16-byte
//   st.async into that block's h ring, completing as transaction bytes on
//   the block's mbarrier for that buffer. A block waits only on its own
//   mbarrier, which expects H * 4 bytes a step (H rounded up to UPW): there
//   is no cluster-wide barrier inside the loop.
// - Each unit's three x projections reach shared memory XRING steps ahead by
//   cp.async (4 bytes each, any H), so a step never waits on a global load.
// vf_gru_bidir launches two clusters per batch row, one per direction
// (blockIdx.z), writing both into one [B, T, 2H] output; vf_gru_seq launches
// one, and is float32 only, as the TPU kernel is.
//
// vf_gru_bidir_backward is vf_gru_bidir's gradient, the serial part of
// backpropagation through time (the plain version is kernels/gru.py::
// gru_bidir_backward; the JAX package differentiates its lax.scan,
// voicefixer_tpu/ops/gru.py, and has no kernel for it). Each direction walks
// its forward steps from the last, with hp_t = h_{t-1} W + b from a matrix
// product before the launch and h_{t-1} from the forward's output:
//   c_n = (1 - z)(1 - n^2), c_r = c_n hp_n r (1 - r),
//   c_z = (h_{t-1} - n) z (1 - z),
//   dh_t = grad_t + dh_{t+1} z_{t+1} + dhp_{t+1} W^T   (K = 3H; dh_last = grad)
//   dhp_t = dh_t [c_r, c_z, c_n r],  dx_t = dh_t [c_r, c_z, c_n].
// dx_t and dhp_t go to memory; dW = H_prev^T dHP and db = sum dHP are
// matrix products after the launch. Bound: a step's latency, as the
// forward's, on the same clusters: block c owns U units; the 8 lanes of a
// unit hold its row of W, K = g H + 32 i + 4 ks + j (the forward's slice
// transposed, the same registers); each step every block needs dhp_t of all
// 3H columns, so each warp gathers its UPW units' 3 UPW values and lane p
// pushes them to block p as three 16-byte st.async onto its mbarrier: 3H
// floats a step against the forward's H. Pushing dh_t (H floats) instead
// would have every block read or recompute the coefficients of all H units
// every step, 3H values from memory on the step's path. The gates and
// coefficients of the next step are computed while the exchange is in
// flight, from x, hp, h_{t-1} and grad copied BRING steps ahead by cp.async.

#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

// blocks per (batch row, direction): CLUSTER_WIDE (a non-portable cluster
// size) where the card runs every cluster of the launch at once, else
// CLUSTER_NARROW, the portable limit
constexpr int CLUSTER_WIDE = 16;
constexpr int CLUSTER_NARROW = 8;
constexpr int CHAINS = 4;       // independent accumulators per column
constexpr int HBUF = 2;         // h buffers in the exchange ring
constexpr int XRING = 32;       // steps of x projections copied ahead
constexpr int MAX_HIDDEN = 256;
constexpr int KI = MAX_HIDDEN / 32;   // float4 K chunks per lane and column
constexpr int UPW = 4;                // units per warp, 8 lanes each
constexpr int BRING = 16;       // backward: steps of inputs copied ahead
constexpr int BCHAINS = 8;      // backward: accumulators of the K = 3H sum

// a cluster of CL blocks: at most MAX_U units and THREADS threads a block
template <int CL>
struct Layout {
  static_assert(MAX_HIDDEN % (CL * UPW) == 0 && CL <= 32,
                "whole warps of units, one push lane per peer");
  static constexpr int MAX_U = MAX_HIDDEN / CL;
  static constexpr int THREADS = 32 * MAX_U / UPW;
  // units a block owns (tests/test_torch_kernels.py::_gru_cluster_model
  // replays the layout)
  __host__ __device__ static constexpr int units(int hidden) {
    return ((hidden + CL - 1) / CL + UPW - 1) / UPW * UPW;
  }
};

// sigmoid on the fast exponential (ex2.approx) and reciprocal, and tanh(v)
// = 2 sigmoid(2v) - 1: within about 2e-7 of the accurate functions at the
// |v| < 16 of the gates, where expf and tanhf would lengthen every step
__device__ __forceinline__ float sigmoid(float v) {
  return __fdividef(1.f, 1.f + __expf(-v));
}
__device__ __forceinline__ float tanh_fast(float v) {
  return 2.f * sigmoid(2.f * v) - 1.f;
}

// A lane's slice of W_hh^T: its unit's three columns at K = 32 i + 4 ks + j.
template <typename W>
struct Slice;

template <>
struct Slice<float> {
  float w[3][KI][4];
  __device__ __forceinline__ void load(const float* src, const int col[3],
                                       int ks, int H, bool ok) {
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int i = 0; i < KI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = 32 * i + 4 * ks + j;
          w[g][i][j] = ok && k < H
                           ? src[static_cast<long long>(k) * 3 * H + col[g]]
                           : 0.f;
        }
  }
  // the backward's slice: row u of W at K = g H + 32 i + 4 ks + j
  __device__ __forceinline__ void load_row(const float* src, int u, int ks,
                                           int H, bool ok) {
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int i = 0; i < KI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = 32 * i + 4 * ks + j;
          w[g][i][j] =
              ok && k < H
                  ? src[static_cast<long long>(u) * 3 * H + g * H + k]
                  : 0.f;
        }
  }
  __device__ __forceinline__ float get(int g, int i, int j) const {
    return w[g][i][j];
  }
};

// bfloat16 pairs (K = 4c + 2p, + 1) in one register: half the registers
template <>
struct Slice<__nv_bfloat16> {
  uint32_t w[3][KI][2];
  __device__ __forceinline__ void load(const __nv_bfloat16* src,
                                       const int col[3], int ks, int H,
                                       bool ok) {
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int i = 0; i < KI; ++i)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t v = 0;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 32 * i + 4 * ks + 2 * p + e;
            if (ok && k < H)
              v |= static_cast<uint32_t>(__bfloat16_as_ushort(
                       src[static_cast<long long>(k) * 3 * H + col[g]]))
                   << (16 * e);
          }
          w[g][i][p] = v;
        }
  }
  __device__ __forceinline__ void load_row(const __nv_bfloat16* src, int u,
                                           int ks, int H, bool ok) {
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int i = 0; i < KI; ++i)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t v = 0;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 32 * i + 4 * ks + 2 * p + e;
            if (ok && k < H)
              v |= static_cast<uint32_t>(__bfloat16_as_ushort(
                       src[static_cast<long long>(u) * 3 * H + g * H + k]))
                   << (16 * e);
          }
          w[g][i][p] = v;
        }
  }
  __device__ __forceinline__ float get(int g, int i, int j) const {
    const uint32_t v = w[g][i][j >> 1];
    return __uint_as_float((j & 1) ? (v & 0xffff0000u) : (v << 16));
  }
};

// this lane's partial sums of h . W over its K values, in p[3] (r, z, n)
template <typename W>
__device__ __forceinline__ void product(const Slice<W>& ws,
                                        const float* __restrict__ hb, int ks,
                                        float p[3]) {
  float acc[3][CHAINS];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) acc[g][c] = 0.f;
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const float4 h4 = *reinterpret_cast<const float4*>(hb + 32 * i + 4 * ks);
    const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        float& a = acc[g][(4 * i + j) % CHAINS];
        a = fmaf(hv[j], ws.get(g, i, j), a);
      }
  }
#pragma unroll
  for (int g = 0; g < 3; ++g) {
#pragma unroll
    for (int w = CHAINS / 2; w > 0; w /= 2)
#pragma unroll
      for (int c = 0; c < w; ++c) acc[g][c] += acc[g][c + w];
    p[g] = acc[g][0];
  }
}

// h_s is in buffer s % HBUF once its mbarrier completes the fill (s >= 1;
// h_0 = 0 is there from the start)
__device__ __forceinline__ void await_h(uint64_t* full, int s) {
  if (s == 0) return;
  hopper::mbar_wait_cluster(full + s % HBUF, ((s - 1) / HBUF) & 1);
}

// After the wait for h_s, the leader re-arms that buffer's barrier for its
// next fill, h_{s + HBUF}, if a step reads it. Any time in step s will do:
// the fill cannot complete before this arrival.
__device__ __forceinline__ void rearm(uint64_t* full, int s, int n_steps,
                                      uint32_t bytes) {
  if (s > 0 && s + HBUF < n_steps)
    hopper::mbar_arrive_expect_tx(full + s % HBUF, bytes);
}

// The warp's UPW new values of h into buffer nb of one peer, zeros for
// units past H (they land in the buffer's zero tail): dst and bar are the
// peer's buffer 0 at this warp's units and its barrier 0.
__device__ __forceinline__ void push_h(uint32_t dst, uint32_t bar, int nb,
                                       const float q[UPW]) {
  hopper::st_async_v4_f32(dst + nb * MAX_HIDDEN * 4, q[0], q[1], q[2], q[3],
                          bar + nb * 8);
}

// One direction of one batch row, run by the CL blocks of a cluster.
// x: [n_steps, 3H]; w: [H, 3H]; bias: [3H]; out: row t at out + t * stride.
template <typename W, int CL>
__device__ __forceinline__ void gru_direction(
    const float* __restrict__ x, const W* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ out, int out_stride,
    int n_steps, int hidden, bool fwd) {
  // The h ring. Buffer s % HBUF holds h_s, rounded to W's type; the tail
  // past `hidden` stays zero. Reuse is safe without a barrier: block A
  // writes h_{s+HBUF} into block B's buffer s % HBUF only after it has
  // received all of h_{s+HBUF-1}, and every warp of B sends its part of
  // that only after its own last read of buffer s % HBUF (step s). The
  // mbarrier of a buffer is re-armed after the wait that completes its
  // previous fill, and no byte of the next fill can land before that wait
  // completes, by the same argument. x slot s % XRING is refilled only
  // after the gate lane that copies it has read step s from it.
  __shared__ __align__(16) float hbuf[HBUF][MAX_HIDDEN];
  __shared__ __align__(8) uint64_t full[HBUF];
  // x projections XRING steps ahead: slot s % XRING, gate g, local unit
  using L = Layout<CL>;
  __shared__ float xring[XRING][3][L::MAX_U];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int H = hidden, G = 3 * hidden;
  const int U = L::units(H);
  const int u0 = rank * U;
  const int nu = max(0, min(U, H - u0));  // units this block owns

  // bytes a buffer takes a step: every warp that owns a unit pushes UPW
  const uint32_t bytes = (H + UPW - 1) / UPW * UPW * 4;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int ks = lane % 8;                // K slice of the lane
  const int lu = warp * UPW + lane / 8;   // local unit of the lane's group
  const int cw = max(0, min(UPW, nu - warp * UPW));  // units of this warp
  const bool ok = lane / 8 < cw;
  const int u = u0 + lu;
  const bool gate_lane = ok && ks == 0;

  if (tid == 0) {
    for (int b = 0; b < HBUF; ++b) hopper::mbar_init(&full[b], 1);
    hopper::mbar_init_fence();
    // the first fill of each buffer: h_1 .. h_HBUF
    for (int j = 1; j <= HBUF && j < n_steps; ++j)
      hopper::mbar_arrive_expect_tx(&full[j % HBUF], bytes);
  }
  for (int i = tid; i < HBUF * MAX_HIDDEN; i += blockDim.x)
    (&hbuf[0][0])[i] = 0.f;

  const int col[3] = {u, H + u, 2 * H + u};
  Slice<W> ws;
  ws.load(w, col, ks, H, ok);
  float br = 0.f, bz = 0.f, bn = 0.f;
  if (gate_lane) {
    br = bias[col[0]];
    bz = bias[col[1]];
    bn = bias[col[2]];
    for (int d = 0; d < XRING; ++d) {
      if (d < n_steps) {
        const float* xt =
            x + static_cast<long long>(fwd ? d : n_steps - 1 - d) * G;
#pragma unroll
        for (int g = 0; g < 3; ++g)
          hopper::cp_async_4(&xring[d][g][lu], xt + col[g]);
      }
      hopper::cp_async_commit();
    }
  }
  // lane p pushes to block p; blocks that own no unit take no h
  const bool pusher = lane < CL && H - lane * U > 0;
  const uint32_t peer = pusher ? lane : 0;
  const uint32_t dst = hopper::mapa_shared(&hbuf[0][warp * UPW], peer) +
                       u0 * 4;
  const uint32_t dbar = hopper::mapa_shared(&full[0], peer);
  cluster.sync();  // barriers armed and h buffers zero before any push

  if (cw > 0) {
    float h = 0.f;  // float32 state of unit u (gate lanes)
    float xr = 0.f, xz = 0.f, xn = 0.f;
    for (int s = 0; s < n_steps; ++s) {
      const int t = fwd ? s : n_steps - 1 - s;
      float* xs = &xring[s % XRING][0][lu];
      if (gate_lane) {  // step s's projections, read before h_s arrives
        hopper::cp_async_wait_group<XRING - 1>();
        xr = xs[0];
        xz = xs[L::MAX_U];
        xn = xs[2 * L::MAX_U];
      }
      await_h(full, s);
      float p[3];
      product<W>(ws, hbuf[s % HBUF], ks, p);
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        p[g] += __shfl_xor_sync(0xffffffffu, p[g], 1);
        p[g] += __shfl_xor_sync(0xffffffffu, p[g], 2);
        p[g] += __shfl_xor_sync(0xffffffffu, p[g], 4);
      }
      float q = 0.f;
      if (gate_lane) {
        const float r = sigmoid(xr + (p[0] + br));
        const float z = sigmoid(xz + (p[1] + bz));
        const float n = tanh_fast(xn + r * (p[2] + bn));
        h = (1.f - z) * n + z * h;
        q = vf::round_to<W>(h);
      }
      if (s + 1 < n_steps) {
        float qs[UPW];
#pragma unroll
        for (int c = 0; c < UPW; ++c)
          qs[c] = __shfl_sync(0xffffffffu, q, 8 * c);
        if (pusher) push_h(dst, dbar, (s + 1) % HBUF, qs);
      }
      // off the exchange's path: the output, the x ring, the barrier
      if (gate_lane) {
        out[static_cast<long long>(t) * out_stride + u] = h;
        if (s + XRING < n_steps) {  // the slot read takes step s + XRING
          const float* xt = x + static_cast<long long>(
                                    fwd ? s + XRING : t - XRING) * G;
#pragma unroll
          for (int g = 0; g < 3; ++g)
            hopper::cp_async_4(xs + g * L::MAX_U, xt + col[g]);
        }
        hopper::cp_async_commit();
      }
      if (tid == 0) rearm(full, s, n_steps, bytes);
    }
  }
  cluster.sync();  // no block exits while a peer may still push into it
}

struct Dir {
  const float* x;     // [batch, n_steps, 3H]
  const void* w;      // [H, 3H]
  const float* bias;  // [3H]
  float* out;         // row (b, t) at out + (b * n_steps + t) * out_stride
  int fwd;
};

template <typename W, int CL>
__global__ void __launch_bounds__(Layout<CL>::THREADS, 1)
gru_bidir_kernel(Dir d0, Dir d1, int n_steps, int hidden, int out_stride) {
  const Dir& d = blockIdx.z == 0 ? d0 : d1;
  const long long row = static_cast<long long>(blockIdx.y) * n_steps;
  gru_direction<W, CL>(d.x + row * 3 * hidden, static_cast<const W*>(d.w),
                       d.bias, d.out + row * out_stride, out_stride, n_steps,
                       hidden, d.fwd != 0);
}

template <int CL>
__global__ void __launch_bounds__(Layout<CL>::THREADS, 1)
gru_seq_kernel(Dir d, int n_steps, int hidden) {
  const long long row = static_cast<long long>(blockIdx.y) * n_steps;
  gru_direction<float, CL>(d.x + row * 3 * hidden,
                           static_cast<const float*>(d.w), d.bias,
                           d.out + row * hidden, hidden, n_steps, hidden,
                           d.fwd != 0);
}

// ---------------------------------------------------------------- backward

// this lane's partial sum of dhp . W[u, :] over its K values (the buffer
// holds gate g's columns at g * MAX_HIDDEN)
template <typename W>
__device__ __forceinline__ float product_rows(const Slice<W>& ws,
                                              const float* __restrict__ db,
                                              int ks) {
  float acc[BCHAINS];
#pragma unroll
  for (int c = 0; c < BCHAINS; ++c) acc[c] = 0.f;
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int i = 0; i < KI; ++i) {
      const float4 d4 = *reinterpret_cast<const float4*>(
          db + g * MAX_HIDDEN + 32 * i + 4 * ks);
      const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float& a = acc[(4 * (g * KI + i) + j) % BCHAINS];
        a = fmaf(dv[j], ws.get(g, i, j), a);
      }
    }
#pragma unroll
  for (int w = BCHAINS / 2; w > 0; w /= 2)
#pragma unroll
    for (int c = 0; c < w; ++c) acc[c] += acc[c + w];
  return acc[0];
}

// a unit's coefficients at one step, and the terms of its dh
struct Coef {
  float cr, cz, cnr, cn, z, grad;
};

// One direction of one batch row's gradient, run by the CL blocks of a
// cluster. x, hp, dx, dhp: [n_steps, 3H]; w: [H, 3H]; hs (the forward's
// states) and grad: row t at + t * stride.
template <typename W, int CL>
__device__ __forceinline__ void gru_direction_backward(
    const float* __restrict__ x, const float* __restrict__ hp,
    const W* __restrict__ w, const float* __restrict__ hs,
    const float* __restrict__ grad, float* __restrict__ dx,
    float* __restrict__ dhp, int stride, int n_steps, int hidden, bool fwd) {
  // The dhp ring: buffer i % HBUF takes step i's pushes (step i handles
  // t = T-1-i forward, t = i backward), gate g's columns at [g][...], the
  // tail past `hidden` zero. Reuse and re-arming as the forward's h ring: a
  // block pushes step i + HBUF only after it received all of step
  // i + HBUF - 1, which every warp sends after its read of step i.
  __shared__ __align__(16) float dbuf[HBUF][3][MAX_HIDDEN];
  __shared__ __align__(8) uint64_t full[HBUF];
  using L = Layout<CL>;
  // step i's inputs of each local unit in slot i % BRING: x (3), hp (3),
  // h_{t-1}, grad_t
  __shared__ float ring[BRING][8][L::MAX_U];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int H = hidden, G = 3 * hidden;
  const int U = L::units(H);
  const int u0 = rank * U;
  const int nu = max(0, min(U, H - u0));
  const int n_fill = n_steps - 1;  // every step but the direction's first
  const uint32_t bytes = 3 * ((H + UPW - 1) / UPW * UPW) * 4;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int ks = lane % 8;
  const int lu = warp * UPW + lane / 8;
  const int cw = max(0, min(UPW, nu - warp * UPW));
  const bool ok = lane / 8 < cw;
  const int u = u0 + lu;
  const bool gate_lane = ok && ks == 0;

  if (tid == 0) {
    for (int b = 0; b < HBUF; ++b) hopper::mbar_init(&full[b], 1);
    hopper::mbar_init_fence();
    for (int j = 0; j < HBUF && j < n_fill; ++j)
      hopper::mbar_arrive_expect_tx(&full[j], bytes);
  }
  for (int i = tid; i < HBUF * 3 * MAX_HIDDEN; i += blockDim.x)
    (&dbuf[0][0][0])[i] = 0.f;

  Slice<W> ws;
  ws.load_row(w, u, ks, H, ok);

  // the gate lane's copies of step i's inputs into its slot, one group
  auto fetch = [&](int i) {
    if (i < n_steps) {
      const int t = fwd ? n_steps - 1 - i : i;
      float* slot = &ring[i % BRING][0][lu];
      const long long r = static_cast<long long>(t) * G + u;
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        hopper::cp_async_4(slot + g * L::MAX_U, x + r + g * H);
        hopper::cp_async_4(slot + (3 + g) * L::MAX_U, hp + r + g * H);
      }
      if (i + 1 < n_steps)  // h_{t-1}: the direction's previous state
        hopper::cp_async_4(
            slot + 6 * L::MAX_U,
            hs + static_cast<long long>(fwd ? t - 1 : t + 1) * stride + u);
      hopper::cp_async_4(slot + 7 * L::MAX_U,
                         grad + static_cast<long long>(t) * stride + u);
    }
    hopper::cp_async_commit();
  };
  // step i's gates from its slot (in-flight groups: BRING - 1 at most)
  auto coef = [&](int i) {
    hopper::cp_async_wait_group<BRING - 1>();
    const float* slot = &ring[i % BRING][0][lu];
    const float hr = slot[3 * L::MAX_U], hz = slot[4 * L::MAX_U],
                hn = slot[5 * L::MAX_U];
    const float h_prev = i + 1 < n_steps ? slot[6 * L::MAX_U] : 0.f;
    const float r = 1.f / (1.f + expf(-(slot[0] + hr)));
    const float z = 1.f / (1.f + expf(-(slot[L::MAX_U] + hz)));
    const float n = tanhf(slot[2 * L::MAX_U] + r * hn);
    Coef c;
    c.cn = (1.f - z) * (1.f - n * n);
    c.cr = c.cn * hn * r * (1.f - r);
    c.cz = (h_prev - n) * z * (1.f - z);
    c.cnr = c.cn * r;
    c.z = z;
    c.grad = slot[7 * L::MAX_U];
    return c;
  };

  if (gate_lane)
    for (int d = 0; d < BRING; ++d) fetch(d);
  // lane p pushes to block p; blocks that own no unit take no dhp
  const bool pusher = lane < CL && H - lane * U > 0;
  const uint32_t to = pusher ? lane : 0;
  const uint32_t dst =
      hopper::mapa_shared(&dbuf[0][0][warp * UPW], to) + u0 * 4;
  const uint32_t dbar = hopper::mapa_shared(&full[0], to);
  cluster.sync();  // barriers armed and buffers zero before any push

  if (cw > 0) {
    Coef cur = {};
    if (gate_lane) {
      cur = coef(0);
      fetch(BRING);
    }
    float zdh = 0.f, carry = 0.f;  // dh_{t+1} z_{t+1}, dhp_{t+1} W^T
    for (int i = 0; i < n_steps; ++i) {
      const int t = fwd ? n_steps - 1 - i : i;
      float dh = 0.f, q[3] = {0.f, 0.f, 0.f};
      if (gate_lane) {
        dh = (cur.grad + zdh) + carry;
        q[0] = dh * cur.cr;
        q[1] = dh * cur.cz;
        q[2] = dh * cur.cnr;
      }
      const bool more = i + 1 < n_steps;
      if (more) {
        float qs[3][UPW];
#pragma unroll
        for (int g = 0; g < 3; ++g)
#pragma unroll
          for (int c = 0; c < UPW; ++c)
            qs[g][c] = __shfl_sync(0xffffffffu, q[g], 8 * c);
        if (pusher) {
          const int nb = i % HBUF;
#pragma unroll
          for (int g = 0; g < 3; ++g)
            hopper::st_async_v4_f32(
                dst + (nb * 3 + g) * MAX_HIDDEN * 4, qs[g][0], qs[g][1],
                qs[g][2], qs[g][3], dbar + nb * 8);
        }
      }
      // off the exchange's path: the outputs, the next step's gates
      Coef next = {};
      if (gate_lane) {
        const long long r = static_cast<long long>(t) * G + u;
        dx[r] = q[0];
        dx[r + H] = q[1];
        dx[r + 2 * H] = dh * cur.cn;
        dhp[r] = q[0];
        dhp[r + H] = q[1];
        dhp[r + 2 * H] = q[2];
        if (more) {
          next = coef(i + 1);
          fetch(i + 1 + BRING);
        }
      }
      if (more) {
        hopper::mbar_wait_cluster(full + i % HBUF, (i / HBUF) & 1);
        float p = product_rows<W>(ws, &dbuf[i % HBUF][0][0], ks);
        p += __shfl_xor_sync(0xffffffffu, p, 1);
        p += __shfl_xor_sync(0xffffffffu, p, 2);
        p += __shfl_xor_sync(0xffffffffu, p, 4);
        if (gate_lane) {
          zdh = dh * cur.z;
          carry = p;
        }
        if (tid == 0 && i + HBUF < n_fill)
          hopper::mbar_arrive_expect_tx(full + i % HBUF, bytes);
      }
      cur = next;
    }
  }
  cluster.sync();  // no block exits while a peer may still push into it
}

struct BDir {
  const float* x;     // [batch, n_steps, 3H]
  const float* hp;    // [batch, n_steps, 3H]: h_{t-1} W + b
  const void* w;      // [H, 3H]
  const float* h;     // state (b, t) at h + (b * n_steps + t) * stride
  const float* grad;  // its gradient, the same layout
  float* dx;          // [batch, n_steps, 3H]
  float* dhp;         // [batch, n_steps, 3H]
  int fwd;
};

template <typename W, int CL>
__global__ void __launch_bounds__(Layout<CL>::THREADS, 1)
gru_bidir_backward_kernel(BDir d0, BDir d1, int n_steps, int hidden,
                          int stride) {
  const BDir& d = blockIdx.z == 0 ? d0 : d1;
  const long long row = static_cast<long long>(blockIdx.y) * n_steps;
  const long long rg = row * 3 * hidden;
  gru_direction_backward<W, CL>(d.x + rg, d.hp + rg,
                                static_cast<const W*>(d.w),
                                d.h + row * stride, d.grad + row * stride,
                                d.dx + rg, d.dhp + rg, stride, n_steps,
                                hidden, d.fwd != 0);
}

// clusters of CL blocks along x, clusters_y by clusters_z of them
template <int CL>
cudaLaunchConfig_t config(int clusters_y, int clusters_z, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL, clusters_y, clusters_z);
  cfg.blockDim = dim3(Layout<CL>::THREADS);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of CL blocks of `kernel` the current card runs at once,
// cached per kernel and device; 0 where the size is refused.
template <int CL, typename... Args>
int max_clusters(void (*kernel)(Args...)) {
  struct Entry {
    const void* kernel;
    int device, n;
  };
  static Entry cache[8];
  static int used = 0;
  int device = 0;
  cudaGetDevice(&device);
  for (int i = 0; i < used; ++i)
    if (cache[i].kernel == reinterpret_cast<const void*>(kernel) &&
        cache[i].device == device)
      return cache[i].n;
  int n = 0;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<CL>(1, 1, nullptr, attr);
  if ((CL <= 8 || cudaFuncSetAttribute(
                      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                      1) == cudaSuccess) &&
      cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess)
    n = 0;
  cudaGetLastError();  // a refused size is an answer, not an error
  if (used < 8) cache[used++] = {reinterpret_cast<const void*>(kernel), device, n};
  return n;
}

// Launches `wide` (clusters of CLUSTER_WIDE) where the card runs all of the
// launch's clusters at once, else `narrow`: clusters that wait for free SMs
// would run one after another and lose more than the wide size gains.
template <typename... Args>
int launch(void (*wide)(Args...), void (*narrow)(Args...), int batch,
           int dirs, cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  const bool fits = max_clusters<CLUSTER_WIDE>(wide) >= batch * dirs;
  const cudaLaunchConfig_t cfg =
      fits ? config<CLUSTER_WIDE>(batch, dirs, stream, attr)
           : config<CLUSTER_NARROW>(batch, dirs, stream, attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, fits ? wide : narrow,
                                           args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// xf, xb: [batch, n_steps, 3H] float32; wf, wb: [H, 3H] (W_hh^T) in float32
// (w_bf16 = 0) or bfloat16 (w_bf16 = 1); bf, bb: [3H] float32; out: [batch,
// n_steps, 2H] float32, the forward direction in columns [0, H) and the
// backward one in [H, 2H). H <= 256.
extern "C" int vf_gru_bidir(const float* xf, const float* xb, const void* wf,
                            const void* wb, const float* bf, const float* bb,
                            float* out, int batch, int n_steps, int hidden,
                            int w_bf16, void* stream) {
  if (hidden < 1 || hidden > MAX_HIDDEN || batch < 1 || n_steps < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dir fwd{xf, wf, bf, out, 1}, bwd{xb, wb, bb, out + hidden, 0};
  using B = __nv_bfloat16;
  if (w_bf16)
    return launch(gru_bidir_kernel<B, CLUSTER_WIDE>,
                  gru_bidir_kernel<B, CLUSTER_NARROW>, batch, 2, s, fwd, bwd,
                  n_steps, hidden, 2 * hidden);
  return launch(gru_bidir_kernel<float, CLUSTER_WIDE>,
                gru_bidir_kernel<float, CLUSTER_NARROW>, batch, 2, s, fwd,
                bwd, n_steps, hidden, 2 * hidden);
}

// The gradient of vf_gru_bidir's output, up to the products with W: xf, xb:
// [batch, n_steps, 3H] float32; hp: [2, batch, n_steps, 3H] float32, each
// direction's h_{t-1} W + b (h rounded to W's type, h_{-1} = 0); wf, wb:
// [H, 3H] as vf_gru_bidir's; out: vf_gru_bidir's output [batch, n_steps, 2H];
// grad: its gradient, float32, the same layout. Writes dxf, dxb: [batch,
// n_steps, 3H], the gradients of xf and xb, and dhp: [2, batch, n_steps, 3H],
// the gradient of hp. H <= 256.
extern "C" int vf_gru_bidir_backward(const float* xf, const float* xb,
                                     const float* hp, const void* wf,
                                     const void* wb, const float* out,
                                     const float* grad, float* dxf,
                                     float* dxb, float* dhp, int batch,
                                     int n_steps, int hidden, int w_bf16,
                                     void* stream) {
  if (hidden < 1 || hidden > MAX_HIDDEN || batch < 1 || n_steps < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long plane = static_cast<long long>(batch) * n_steps * 3 * hidden;
  const BDir fwd{xf, hp, wf, out, grad, dxf, dhp, 1},
      bwd{xb, hp + plane, wb, out + hidden, grad + hidden, dxb, dhp + plane,
          0};
  using B = __nv_bfloat16;
  if (w_bf16)
    return launch(gru_bidir_backward_kernel<B, CLUSTER_WIDE>,
                  gru_bidir_backward_kernel<B, CLUSTER_NARROW>, batch, 2, s,
                  fwd, bwd, n_steps, hidden, 2 * hidden);
  return launch(gru_bidir_backward_kernel<float, CLUSTER_WIDE>,
                gru_bidir_backward_kernel<float, CLUSTER_NARROW>, batch, 2, s,
                fwd, bwd, n_steps, hidden, 2 * hidden);
}

// x: [batch, n_steps, 3H] float32; w: [H, 3H] (W_hh^T) float32; bias: [3H];
// out: [batch, n_steps, H]. reverse walks t from n_steps - 1 down to 0.
// H <= 256.
extern "C" int vf_gru_seq(const float* x, const float* w, const float* bias,
                          float* out, int batch, int n_steps, int hidden,
                          int reverse, void* stream) {
  if (hidden < 1 || hidden > MAX_HIDDEN || batch < 1 || n_steps < 1)
    return cudaErrorInvalidValue;
  const Dir d{x, w, bias, out, reverse == 0};
  return launch(gru_seq_kernel<CLUSTER_WIDE>, gru_seq_kernel<CLUSTER_NARROW>,
                batch, 1, static_cast<cudaStream_t>(stream),
                d, n_steps, hidden);
}

// How many clusters of CLUSTER_WIDE blocks of the float32 bidirectional
// kernel the current card runs at once: launches of at most that many
// clusters (2 x batch for vf_gru_bidir, batch for vf_gru_seq) take the wide
// size. A report for tools; the launches ask for themselves.
extern "C" int vf_gru_wide_clusters() {
  return max_clusters<CLUSTER_WIDE>(gru_bidir_kernel<float, CLUSTER_WIDE>);
}

// The same for the float32 backward kernel: launches of at most that many
// clusters (2 x batch) take the wide size.
extern "C" int vf_gru_backward_wide_clusters() {
  return max_clusters<CLUSTER_WIDE>(
      gru_bidir_backward_kernel<float, CLUSTER_WIDE>);
}
