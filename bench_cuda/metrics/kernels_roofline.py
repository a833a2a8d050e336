"""kernels_roofline (kernels: ``kernels/*.py`` -> ``csrc/*.cu``), in %: the
least time the main path's hand-written kernels' functions need, over the
device time of the port's hand-written kernel launches, in the traced
sample.

The least time of a function is the larger of its FLOPs over the peak of
its type and its bytes over 3.35 TB/s, from the frozen work counts
(``frozen/work.py``) at the configuration's shapes; every input is read
once and every output written once, and the weights once a request. Per
30 s segment the functions are the STFT and mel (K5, float32), the four
bidirectional GRU layers' recurrence (K6) and the four vocoder stages,
each an upsample fused with its ResStack (K1 to K4; the fused form is the
least whatever kernels run it). A launch is the port's if its name holds
one of ``SYMBOLS``, the ``__global__`` functions of ``csrc/*.cu``.
"""

from bench_cuda.frozen import work
from bench_cuda.reference.model import mel_filterbank

SYMBOLS = ("stft_mel_kernel", "mel_bands_kernel", "gru_bidir_kernel",
           "gru_seq_kernel", "gru_bidir_backward_kernel",
           "upsample_wgmma_kernel", "upsample_f32_kernel", "sin_residual",
           "chain_f32_kernel", "shift_f32_kernel", "chain_wgmma_kernel",
           "shift_wgmma_kernel", "conv_block_f32_kernel",
           "conv_block_wgmma_kernel")


def functions(cfg) -> list:
    """[(work(t_scale) -> (flops, bytes), peak)] of one segment's
    functions: ``work(1)`` is one segment's work, ``work(0)`` its weights'
    bytes alone."""
    production = cfg.precision == "production"
    size = 2 if production else 4
    peak = work.PEAK_BF16 if production else work.PEAK_FP32
    n = cfg.pipeline.seg_length
    t = n // cfg.stft.hop_length + 1
    m = cfg.mel
    nnz = int((mel_filterbank(m.n_stft, m.f_min, m.f_max, m.n_mels,
                              m.sample_rate) != 0).sum())
    out = [(lambda k: work.stft_work(n * k, t * k, cfg.stft.n_fft,
                                     cfg.stft.n_freqs, m.n_mels, nnz),
            work.PEAK_FP32)]
    d = cfg.denoiser
    for _ in range(d.num_gru_blocks * d.gru_layers):
        out.append((lambda k: work.gru_work(t * k, d.base_width, size),
                    peak))
    v = cfg.vocoder
    t_in = t + t % 2 + 4
    for i, s in enumerate(v.upsample_scales):
        cin, cout = v.channels // 2 ** i, v.channels // 2 ** (i + 1)
        out.append((lambda k, t_in=t_in, s=s, cin=cin, cout=cout, i=i:
                    work.up_res_work(t_in * k, s, cin, cout,
                                     v.resstack_depth[i], size), peak))
        t_in *= s
    return out


def least_ms(cfg, segments_per_request) -> float:
    total = 0.0
    for fn, peak in functions(cfg):
        flops, nbytes = fn(1)
        weights = fn(0)[1]
        for n in segments_per_request:
            total += work.bound_ms(n * (nbytes - weights) + weights,
                                   n * flops, peak)[0]
    return total


def read(run):
    rec = run.record
    if rec is None:
        return None
    ms = sum(e.end - e.start for e in rec.device
             if any(s in e.name for s in SYMBOLS)) / 1e3
    if ms <= 0:
        return None
    return 100.0 * least_ms(run.cfg, [r[2] for r in rec.requests]) / ms
