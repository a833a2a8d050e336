"""The least work of each hand-written kernel's function and the peaks it
is held to: a frozen copy of ``chip_smoke.py``'s work counts, ``bound_ms``,
peak rates and ``_kernel_group``, taken at commit 005ebc2. A kernel's
roofline share divides the least time these give by its device time, so
they stay as they are when the program changes;
``bench_cuda/tests/test_bench_frozen.py`` shows each name equal to its
origin, so drift there shows."""

from __future__ import annotations

import math

ORIGIN = "chip_smoke.py"
FROZEN = (
    'PEAK_FP32',
    'PEAK_BF16',
    'PEAK_BYTES',
    'bound_ms',
    'stft_work',
    'gru_backward_work',
    'gru_work',
    'upsample_work',
    'res_work',
    'up_res_work',
    'conv_block_work',
    'K9_GROUP',
    '_kernel_group',
)


PEAK_FP32 = 67e12


PEAK_BF16 = 989e12


PEAK_BYTES = 3.35e12


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def stft_work(n: int, t: int, n_fft: int, n_freqs: int, n_mels: int,
              fb_nnz: int):
    """STFT -> magnitude -> mel of an n-sample float32 wave into t frames, as
    an FFT computes it: a real FFT of n_fft points per frame (2.5 n log2 n
    FLOPs), the magnitude of each bin, and the mel product over the fb_nnz
    entries of this run's filterbank that are not zero (a triangular
    filterbank has about two a frequency bin, a dense one n_freqs * n_mels).
    The plain version's dense DFT and dense mel product are far more."""
    flops = (t * 2.5 * n_fft * math.log2(n_fft) + 4 * t * n_freqs
             + 2 * t * fb_nnz)
    return flops, 4 * (n + n_freqs * n_mels + t * n_mels)


def gru_backward_work(t: int, h: int, b: int):
    """The gradient of one bidirectional layer over b rows of t steps: per
    direction three products of 2 b t H 3H (hp recomputed from h, dh Wᵀ,
    dW); x, the output, its gradient, W and b in, dx, dW and db out, all
    float32 (the kernel's gradients are float32 in both types)."""
    g = 3 * h
    flops = 2 * 3 * 2 * b * t * h * g
    return flops, 2 * 4 * (2 * b * t * g + 2 * b * t * h + 2 * h * g + 2 * g)


def gru_work(t: int, h: int, w_size: int, directions: int = 2):
    """One GRU layer over t steps, both directions unless told otherwise:
    float32 projections in, h·W_hh and the gates per step, float32 states
    out."""
    flops = directions * t * (2 * h * 3 * h + 12 * h)
    return flops, directions * (4 * (t * 3 * h + 3 * h + t * h)
                                + h * 3 * h * w_size)


def upsample_work(t: int, s: int, cin: int, cout: int, size: int):
    """x + sin(x), then a ConvTranspose1d of kernel 2s and stride s: two
    taps of Cin x Cout per output sample."""
    return (2 * t * s * 2 * cin * cout,
            size * (t * cin + 2 * s * cin * cout + cout + t * s * cout))


def res_work(ch: int, t: int, n_blocks: int, size: int):
    """n consecutive ResStack blocks (two k=3 convs of C x C each) on
    [t, C]: the signal read once and written once, the weights read once."""
    return (n_blocks * 12 * ch * ch * t,
            size * (2 * t * ch + n_blocks * 2 * (3 * ch * ch + ch)))


def up_res_work(t: int, s: int, cin: int, cout: int, n_blocks: int,
                size: int):
    """The upsample fused with n blocks: the upsampled signal is neither
    written by the one nor read by the other."""
    fl, by = res_work(cout, t * s, n_blocks, size)
    up_fl, up_by = upsample_work(t, s, cin, cout, size)
    return fl + up_fl, by + up_by - 2 * size * t * s * cout


def conv_block_work(t: int, f: int, ci: int, co: int, size: int):
    """One ConvBlockRes on [t, f, ci]: two folded batch norms with
    LeakyReLU, a 3x3 convolution ci -> co and one co -> co, and the 1x1
    shortcut where ci != co; x read once, the output written once."""
    sc = ci != co
    return (t * f * (2 * 9 * co * (ci + co) + (2 * ci * co if sc else 0)
                     + 4 * (ci + co)),
            size * (t * f * (ci + co) + 9 * co * (ci + co)
                    + ((ci + 1) * co if sc else 0)) + 8 * (ci + co))


K9_GROUP = "K9 conv_block_res"


def _kernel_group(name: str) -> str:
    # the ResStack kernels: chains (K2, K4's and K7's) and single blocks
    # (K3, K4's and K7's) of csrc/resstack_wgmma.cu in bfloat16 and of
    # csrc/resstack_f32.cu in float32
    for key, group in (("stft_mel", "K5 stft_mel"),
                       ("gru_bidir_backward", "K6 backward"),
                       ("gru_bidir", "K6 gru_bidir"),
                       ("gru_seq", "K8 gru_seq"),
                       ("conv_block_", K9_GROUP),
                       ("sin_residual", "x+sin(x) pre-pass of K1 and K4"),
                       ("upsample", "K1 upsample"),
                       ("chain_wgmma_kernel",
                        "K2/K4/K7-bf16 chain_wgmma_kernel"),
                       ("shift_wgmma_kernel",
                        "K3/K4/K7-bf16 shift_wgmma_kernel"),
                       ("chain_f32_kernel", "K2/K4/K7-f32 chain_f32_kernel"),
                       ("shift_f32_kernel", "K3/K4/K7-f32 shift_f32_kernel"),
                       ("nchwToNhwc", "layout copies"),
                       ("nhwcToNchw", "layout copies"),
                       ("fprop", "cuDNN conv"), ("implicit", "cuDNN conv"),
                       ("cudnn", "cuDNN conv"), ("conv", "cuDNN conv"),
                       ("gemm", "matrix products"),
                       ("xmma", "matrix products"),
                       ("cutlass", "matrix products")):
        if key in name:
            return group
    return "elementwise and copies"
