// A whole ResStack behind one entry point, on a signal that is already at
// the full rate, with an optional signal window: vf_res_stream (the blocks
// and the stage LeakyReLU).
//
// Replaces voicefixer_tpu/kernels/resstream.py::res_stream (Pallas, TPU),
// which the time-sharded vocoder runs on the fused widths (full width:
// stages 2 and 3, C = 128 at T = 441 882 and C = 64 at T = 1 325 646), each
// shard on [halo | its samples | halo] with the window saying which rows
// are signal. (The stage with its upsample in front, up_res_stream, is
// walked by kernels/resstream.py over the kernels of resstack_f32.cu,
// resstack_wgmma.cu and resstack.cu.)
//
// Bound: operations at C = 128, bytes at C = 64. The TPU kernel is one
// sequential stream per batch row with all eight blocks' history rings
// (1.7 MB) in VMEM; one SM has 227 KB of shared memory and the card has 132
// SMs that a batch-1 stream would leave idle, and the stack's receptive
// field (3288 rows a side) fits no halo tile. So the stack is tiled over
// time across all SMs and cut into groups of blocks: a group of one block
// reads its +-d taps from global memory through L2 (resblock.cuh,
// shift_kernel); a longer one runs the blocks by halo recompute on a slab
// in shared memory (chain_kernel). Each group but the last writes the
// full-rate signal once, into one of two scratch buffers; the last applies
// the stage LeakyReLU and writes the output. Which blocks fall into which
// group is the caller's plan (kernels/resstack.py::plan_stack): as many as
// fit shared memory at a fair recompute ratio. Every group takes the
// window. The TPU kernels' lane padding and lane fold of C = 64
// (mask_t_total, fold_offset, fold_ch), ring buffers, lag tiles, VMEM plans
// and position-mask ablations are gone.

#include "resblock.cuh"

namespace {

using vf::res::ChainArgs;

// The stack's groups, one launch each, on x [batch, t_len, ch]. A group
// with tms[g] == 0 is one shifted-tap block.
template <typename T>
int run_groups(const T* src, const void* w1, const void* b1, const void* w2,
               const void* b2, void* out, void* scratch0, void* scratch1,
               int batch, int t_len, int ch, int n_blocks, const int* dils,
               int n_groups, const int* ends, const int* tms, float slope,
               float final_slope, int has_final, int lo, int hi,
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
    if (end <= start || end - start > vf::res::MAX_BLOCKS)
      return cudaErrorInvalidValue;
    T* dst = static_cast<T*>(last ? out : (g % 2 ? scratch1 : scratch0));
    if (dst == nullptr) return cudaErrorInvalidValue;
    const long long wo = static_cast<long long>(start) * 3 * ch * ch;
    const int fin = last ? has_final : 0;
    cudaError_t e;
    if (tms[g] == 0) {
      if (end - start != 1) return cudaErrorInvalidValue;
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
      e = vf::res::launch_chain<T>(p, batch, st);
    }
    if (e != cudaSuccess) return e;
    cur = dst;
    start = end;
  }
  return cudaSuccess;
}

}  // namespace

// x, out, scratch0, scratch1: [batch, t_len, ch] (scratch0 may be null
// with one group, scratch1 with two); w1, w2: [n_blocks, 3*ch, ch]; b1, b2:
// [n_blocks, ch]; dils: n_blocks host ints; ends[g]: one past the last
// block of group g; tms[g]: output rows per thread block of a chain group,
// 0 for one shifted-tap block; [lo, hi) the signal window in rows (0, t_len
// for the whole array). All float32 (bf16 = 0) or all bfloat16 (bf16 = 1,
// ch a multiple of 8). out and the scratch buffers must not alias x.
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
        static_cast<const __nv_bfloat16*>(x), w1, b1, w2, b2, out, scratch0,
        scratch1, batch, t_len, ch, n_blocks, dils, n_groups, ends, tms,
        slope, final_slope, has_final, lo, hi, s);
  return run_groups<float>(static_cast<const float*>(x), w1, b1, w2, b2, out,
                           scratch0, scratch1, batch, t_len, ch, n_blocks,
                           dils, n_groups, ends, tms, slope, final_slope,
                           has_final, lo, hi, s);
}
