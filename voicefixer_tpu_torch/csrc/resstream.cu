// A whole ResStack behind one entry point, with or without the stage's
// upsample in front: vf_up_res_stream (the polyphase upsample of
// a = x + sin(x), the blocks and the stage LeakyReLU) and vf_res_stream (the
// blocks and the LeakyReLU on a signal that is already at the full rate,
// with an optional signal window).
//
// Replace voicefixer_tpu/kernels/resstream.py::up_res_stream and
// ::res_stream (Pallas, TPU). up_res_stream is used where Cout <= 128 (full
// width: stages 2 and 3, 256 -> 128 at T = 441 882 and 128 -> 64 at
// T = 1 325 646); res_stream by the time-sharded vocoder on the same two
// widths, each shard on [halo | its samples | halo] with the window saying
// which rows are signal.
//
// Bound: operations at C = 128, bytes at C = 64. The TPU kernel is one
// sequential stream per batch row with all eight blocks' history rings
// (1.7 MB) in VMEM; one SM has 227 KB of shared memory and the card has 132
// SMs that a batch-1 stream would leave idle, and the stack's receptive
// field (3288 rows a side) fits no halo tile. So the stage is tiled over
// time across all SMs and cut into groups of blocks:
//   group 0   a pre-pass writes a = x + sin(x) at the slow rate; then one
//             kernel forms the upsampled tile and its halo in shared memory
//             from a (the polyphase product) and runs the small-dilation
//             blocks on it by halo recompute (resblock.cuh, chain_kernel with
//             UP). The un-processed upsampled signal is never written.
//   later     a group of one block reads its +-d taps from global memory
//   groups    through L2 (shift_kernel); a longer one is another chain.
// Each group but the last writes the full-rate signal once, into one of two
// scratch buffers; the last applies the stage LeakyReLU and writes the
// output. Which blocks fall into which group is the caller's plan
// (kernels/resstack.py::plan_stack): as many as fit shared memory at a fair
// recompute ratio. vf_res_stream is the same walk without the pre-pass: its
// first group reads x itself (a chain without UP, or one shifted-tap block),
// and every group takes the window. The TPU kernels' lane padding and lane
// fold of C = 64 (mask_t_total, fold_offset, fold_ch), ring buffers, lag
// tiles, VMEM plans and position-mask ablations are gone.

#include "resblock.cuh"

namespace {

using vf::res::ChainArgs;

// The stack's groups, one launch each. src is what group 0 reads: with up,
// a = x + sin(x) at the slow rate [batch, t_in, cin], else the full-rate
// signal [batch, t_len, ch]. A group with tms[g] == 0 is one shifted-tap
// block; with up, group 0 is always a chain.
template <typename T>
int run_groups(const T* src, bool up, const void* w_up, const void* b_up,
               const void* w1, const void* b1, const void* w2, const void* b2,
               void* out, void* scratch0, void* scratch1, int batch, int t_in,
               int cin, int t_len, int ch, int scale, int n_blocks,
               const int* dils, int n_groups, const int* ends, const int* tms,
               float slope, float final_slope, int has_final, int lo, int hi,
               cudaStream_t st) {
  if (batch < 1 || t_len < 1 || ch < 1 || n_blocks < 1 || n_groups < 1 ||
      ends[n_groups - 1] != n_blocks)
    return cudaErrorInvalidValue;
  const T* w1t = static_cast<const T*>(w1);
  const T* b1t = static_cast<const T*>(b1);
  const T* w2t = static_cast<const T*>(w2);
  const T* b2t = static_cast<const T*>(b2);
  const T* cur = src;
  int start = 0;
  for (int g = 0; g < n_groups; ++g) {
    const int end = ends[g];
    const bool last = g + 1 == n_groups;
    const bool first_up = up && g == 0;
    if (end <= start || end - start > vf::res::MAX_BLOCKS)
      return cudaErrorInvalidValue;
    T* dst = static_cast<T*>(last ? out : (g % 2 ? scratch1 : scratch0));
    if (dst == nullptr) return cudaErrorInvalidValue;
    const long long wo = static_cast<long long>(start) * 3 * ch * ch;
    const int fin = last ? has_final : 0;
    cudaError_t e;
    if (tms[g] == 0) {
      if (first_up || end - start != 1) return cudaErrorInvalidValue;
      e = vf::res::launch_shift<T>(cur, w1t + wo, b1t + start * ch, w2t + wo,
                                   b2t + start * ch, dst, batch, t_len, ch,
                                   dils[start], slope, final_slope, fin, lo,
                                   hi, st);
    } else {
      ChainArgs<T> p{};
      p.x = cur;
      p.w1 = w1t + wo;
      p.b1 = b1t + start * ch;
      p.w2 = w2t + wo;
      p.b2 = b2t + start * ch;
      p.y = dst;
      p.t_len = t_len;
      p.ch = ch;
      p.n = end - start;
      for (int i = start; i < end; ++i) p.dils[i - start] = dils[i];
      p.tm = tms[g];
      p.slope = slope;
      p.final_slope = final_slope;
      p.has_final = fin;
      p.lo = lo;
      p.hi = hi;
      p.w_up = static_cast<const T*>(w_up);
      p.b_up = static_cast<const T*>(b_up);
      p.t_in = t_in;
      p.cin = cin;
      p.scale = scale;
      e = first_up ? vf::res::launch_chain<T, true>(p, batch, st)
                   : vf::res::launch_chain<T, false>(p, batch, st);
    }
    if (e != cudaSuccess) return e;
    cur = dst;
    start = end;
  }
  return cudaSuccess;
}

template <typename T>
int up_stream(const void* x_src, void* a, const void* w_up, const void* b_up,
              const void* w1, const void* b1, const void* w2, const void* b2,
              void* out, void* scratch0, void* scratch1, int batch, int t_in,
              int cin, int ch, int scale, int n_blocks, const int* dils,
              int n_groups, const int* ends, const int* tms, float slope,
              float final_slope, int has_final, cudaStream_t st) {
  if (batch < 1 || t_in < 1 || cin < 1 || scale < 1)
    return cudaErrorInvalidValue;
  const long long t_len_ll = static_cast<long long>(t_in) * scale;
  if (t_len_ll > 0x7fffffffLL - 65536) return cudaErrorInvalidValue;
  const int t_len = static_cast<int>(t_len_ll);
  vf::launch_sin_residual(static_cast<const T*>(x_src), static_cast<T*>(a),
                          static_cast<long long>(batch) * t_in * cin, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return run_groups<T>(static_cast<const T*>(a), true, w_up, b_up, w1, b1, w2,
                       b2, out, scratch0, scratch1, batch, t_in, cin, t_len,
                       ch, scale, n_blocks, dils, n_groups, ends, tms, slope,
                       final_slope, has_final, 0, t_len, st);
}

}  // namespace

// x_src: [batch, t_in, cin]; a: scratch shaped like x_src; w_up: polyphase
// weights [2*cin, scale*ch] (rows: a[q] taps then a[q-1] taps; columns:
// phase-major); b_up: [ch]; w1, w2: [n_blocks, 3*ch, ch]; b1, b2:
// [n_blocks, ch]; out, scratch0, scratch1: [batch, t_in*scale, ch] (scratch0
// may be null with one group, scratch1 with two); dils: n_blocks host ints;
// ends[g]: one past the last block of group g; tms[g]: output rows per
// thread block of a chain group, 0 for one shifted-tap block. All float32
// (bf16 = 0) or all bfloat16 (bf16 = 1, cin and ch multiples of 8).
extern "C" int vf_up_res_stream(const void* x_src, void* a, const void* w_up,
                                const void* b_up, const void* w1,
                                const void* b1, const void* w2, const void* b2,
                                void* out, void* scratch0, void* scratch1,
                                int batch, int t_in, int cin, int ch,
                                int scale, int n_blocks, const int* dils,
                                int n_groups, const int* ends, const int* tms,
                                float slope, float final_slope, int has_final,
                                int bf16, void* st) {
  auto s = static_cast<cudaStream_t>(st);
  return bf16 ? up_stream<__nv_bfloat16>(x_src, a, w_up, b_up, w1, b1, w2, b2,
                                         out, scratch0, scratch1, batch, t_in,
                                         cin, ch, scale, n_blocks, dils,
                                         n_groups, ends, tms, slope,
                                         final_slope, has_final, s)
              : up_stream<float>(x_src, a, w_up, b_up, w1, b1, w2, b2, out,
                                 scratch0, scratch1, batch, t_in, cin, ch,
                                 scale, n_blocks, dils, n_groups, ends, tms,
                                 slope, final_slope, has_final, s);
}

// The stack alone. x, out, scratch0, scratch1: [batch, t_len, ch]; the
// weights, dils, ends and tms as above; [lo, hi) the signal window in rows
// (0, t_len for the whole array). out and the scratch buffers must not
// alias x.
extern "C" int vf_res_stream(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* out,
                             void* scratch0, void* scratch1, int batch,
                             int t_len, int ch, int n_blocks, const int* dils,
                             int n_groups, const int* ends, const int* tms,
                             float slope, float final_slope, int has_final,
                             int lo, int hi, int bf16, void* st) {
  auto s = static_cast<cudaStream_t>(st);
  if (bf16)
    return run_groups<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(x), false, nullptr, nullptr, w1, b1,
        w2, b2, out, scratch0, scratch1, batch, 0, 0, t_len, ch, 1, n_blocks,
        dils, n_groups, ends, tms, slope, final_slope, has_final, lo, hi, s);
  return run_groups<float>(
      static_cast<const float*>(x), false, nullptr, nullptr, w1, b1, w2, b2,
      out, scratch0, scratch1, batch, 0, 0, t_len, ch, 1, n_blocks, dils,
      n_groups, ends, tms, slope, final_slope, has_final, lo, hi, s);
}
