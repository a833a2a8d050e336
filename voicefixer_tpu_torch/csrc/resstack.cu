// The vocoder's ResStack single block of the unfused stages (C = 512 and 256
// at full width) in bfloat16: vf_res_shift_single. The bfloat16 chain is
// resstack_wgmma.cu's; both float32 kernels are resstack_f32.cu's.
//
// Replaces voicefixer_tpu/kernels/resstack.py::res_shift_single (Pallas,
// TPU) for bfloat16. The block's arithmetic, the tap product and the kernel
// are in resblock.cuh.
//
// Bound: operations. A block is 12*C^2 FLOP and 2*C elements moved per row,
// so at C >= 128 the tensor cores, not the memory, are the limit. Design:
// one thread block owns a time tile and all C output columns of it, because
// the second conv needs every channel of h: h lives in shared memory and
// never in global memory. The weights (1.5 MB per conv at C = 512) stream
// from L2 in 32-row steps. The +-d taps are read at row offsets, so the cost
// does not depend on d. The TPU kernel's 128-lane padding, 8-row alignment,
// VMEM plans and double-buffered DMA are gone. wgmma for this kernel is
// later work.

#include "resblock.cuh"

// One block at dilation d. x, y: [batch, t_len, ch] bfloat16, ch a multiple
// of 8; w1, w2: [3*ch, ch]; b1, b2: [ch]. y must not alias x. [lo, hi) is
// the signal window in rows (0, t_len for the whole array): rows outside it
// are zero padding, and are written as zeros.
extern "C" int vf_res_shift_single(const void* x, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, void* y, int batch,
                                   int t_len, int ch, int d, float slope,
                                   float final_slope, int has_final, int lo,
                                   int hi, void* stream) {
  using T = __nv_bfloat16;
  return vf::res::launch_shift<T>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(y), batch, t_len, ch, d,
      slope, final_slope, has_final, lo, hi,
      static_cast<cudaStream_t>(stream));
}
