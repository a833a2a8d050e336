// The vocoder's ResStack kernels of the unfused stages (C = 512 and 256 at
// full width): vf_res_chain (float32; bfloat16 chains are
// resstack_wgmma.cu's) and vf_res_shift_single.
//
// Replace voicefixer_tpu/kernels/resstack.py::res_chain and
// ::res_shift_single (Pallas, TPU). The block's arithmetic, the tap product
// and both kernels are in resblock.cuh.
//
// Bound: operations. A block is 12*C^2 FLOP and 2*C elements moved per row,
// so at C >= 128 the tensor cores, not the memory, are the limit. Design:
// one thread block owns a time tile and all C output columns of it, because
// the second conv needs every channel of h: h lives in shared memory and
// never in global memory. The weights (1.5 MB per conv at C = 512 in
// bfloat16) stream from L2 in 16- or 32-row steps. res_chain keeps n blocks'
// intermediates in a shared-memory slab by halo recompute, which pays while
// the summed dilations stay small beside the tile; res_shift_single reads
// its +-d taps at row offsets, so its cost does not depend on d. The TPU
// kernels' 128-lane padding, 8-row alignment, VMEM plans and double-buffered
// DMA are gone. The bfloat16 chain runs on wgmma with TMA-fed weights
// (resstack_wgmma.cu); wgmma for these two is later work.

#include "resblock.cuh"

namespace {

template <typename T>
int chain(const void* x, const void* w1, const void* b1, const void* w2,
          const void* b2, void* y, int batch, int t_len, int ch, int n,
          const int* dils, int tm, float slope, float final_slope,
          int has_final, int lo, int hi, cudaStream_t stream) {
  if (n < 1 || n > vf::res::MAX_BLOCKS) return cudaErrorInvalidValue;
  vf::res::ChainArgs<T> p{};
  p.x = static_cast<const T*>(x);
  p.w1 = static_cast<const T*>(w1);
  p.b1 = static_cast<const T*>(b1);
  p.w2 = static_cast<const T*>(w2);
  p.b2 = static_cast<const T*>(b2);
  p.y = static_cast<T*>(y);
  p.t_len = t_len;
  p.ch = ch;
  p.n = n;
  for (int i = 0; i < n; ++i) p.dils[i] = dils[i];
  p.tm = tm;
  p.slope = slope;
  p.final_slope = final_slope;
  p.has_final = has_final;
  p.lo = lo;
  p.hi = hi;
  return vf::res::launch_chain<T, false>(p, batch, stream);
}

}  // namespace

// x, y: [batch, t_len, ch] float32; w1, w2: [n, 3*ch, ch] (block,
// tap*in, out); b1, b2: [n, ch]; dils: n host ints; tm: output rows per
// thread block. y must not alias x. [lo, hi) is the signal window in rows
// (0, t_len for the whole array): rows outside it are zero padding at every
// block, and are written as zeros.
extern "C" int vf_res_chain(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* y,
                            int batch, int t_len, int ch, int n,
                            const int* dils, int tm, float slope,
                            float final_slope, int has_final, int lo,
                            int hi, void* stream) {
  return chain<float>(x, w1, b1, w2, b2, y, batch, t_len, ch, n, dils, tm,
                      slope, final_slope, has_final, lo, hi,
                      static_cast<cudaStream_t>(stream));
}

// One block at dilation d. x, y: [batch, t_len, ch]; w1, w2: [3*ch, ch];
// b1, b2: [ch]. y must not alias x. [lo, hi) as for vf_res_chain.
extern "C" int vf_res_shift_single(const void* x, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, void* y, int batch,
                                   int t_len, int ch, int d, float slope,
                                   float final_slope, int has_final, int lo,
                                   int hi, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    return vf::res::launch_shift<T>(
        static_cast<const T*>(x), static_cast<const T*>(w1),
        static_cast<const T*>(b1), static_cast<const T*>(w2),
        static_cast<const T*>(b2), static_cast<T*>(y), batch, t_len, ch, d,
        slope, final_slope, has_final, lo, hi, s);
  }
  return vf::res::launch_shift<float>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(y), batch, t_len, ch,
      d, slope, final_slope, has_final, lo, hi, s);
}
