"""The port's kernels, through their plain PyTorch versions (the wrappers take
them for CPU tensors), against the JAX package's Pallas kernels in interpret
mode, on the same numpy-seeded inputs.

Tolerances are the JAX kernel tests' own (tests/test_kernels.py): 1e-5 for
the float32 GRU recurrence, 2e-5 for the upsample, 1e-4 relative for the
STFT->mel (a 2048-tap float32 DFT summed in another order). The bfloat16 GRU
case allows 2e-3: h is rounded to bfloat16 before each product, and a last-
bit difference in the float32 state can flip one rounding.

The ResStack kernels (res_chain, res_shift_single, up_res_stack) take the JAX
tests' rtol 1e-4, atol 2e-5 in float32. Their bfloat16 cases, with bfloat16
inputs, weights and biases on both sides, round at the same places, so one
block's outputs differ by one bfloat16 ulp (2^-8 relative) where float32
sums taken in another order straddle a rounding boundary: 1e-3 + 2^-7*|ref|.
A chain carries such an ulp of an intermediate of magnitude up to max|ref|
through the residual path into later outputs of any magnitude, so a chained
case allows 2^-7*max|ref| + 2^-7*|ref| everywhere, and 1e-3 + 2^-7*|ref| on
all but 0.5 % of the elements per chained block.

gru_seq, res_stream and conv_block_res follow the same rules: 1e-5 for the
float32 recurrence, the ResStack tolerances for res_stream, and the JAX
test's 3e-5 for the float32 ConvBlockRes (bfloat16: an ulp of a2, 2^-8
relative, reaches the output through the second convolution's sum, so
2e-2 + 2^-7*|ref|). Under ``mask_bounds`` the JAX ``res_chain`` does not zero
its input outside the window (its callers hand it one that is), so those
cases feed both sides an x that is zero there; the port's own zeroing of x
is held against the JAX package's plain path (``bounds_mask``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicefixer_tpu_torch.kernels import convblock, resstack
from voicefixer_tpu_torch.kernels.gru import gru_bidir, gru_seq
from voicefixer_tpu_torch.kernels.resstack import (res_chain,
                                                   res_shift_single,
                                                   res_stack, up_res_stack)
from voicefixer_tpu_torch.kernels.resstream import res_stream
from voicefixer_tpu_torch.kernels.stft import stft_mel
from voicefixer_tpu_torch.kernels.upsample import upsample


def _rand(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("t,mm,tol", [(7, "float32", 1e-5),
                                      (300, "float32", 1e-5),
                                      (300, "bfloat16", 2e-3)])
def test_gru_bidir_matches_pallas(t, mm, tol):
    from voicefixer_tpu.kernels.gru import gru_seq_bidir

    b, h = 2, 128
    rng = np.random.default_rng(0)
    xf, xb = _rand(rng, (b, t, 3 * h)), _rand(rng, (b, t, 3 * h))
    wf, wb = _rand(rng, (h, 3 * h), 0.1), _rand(rng, (h, 3 * h), 0.1)
    bf, bb = _rand(rng, (3 * h,), 0.1), _rand(rng, (3 * h,), 0.1)

    ref_f, ref_b = gru_seq_bidir(*map(jnp.asarray, (xf, xb, wf, wb, bf, bb)),
                                 matmul_dtype=getattr(jnp, mm),
                                 interpret=True)
    got_f, got_b = gru_bidir(*map(torch.from_numpy, (xf, xb, wf, wb, bf, bb)),
                             matmul_dtype=getattr(torch, mm))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(ref_f),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(ref_b),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("scale,cin,cout", [(7, 64, 32), (3, 128, 64)])
def test_upsample_matches_pallas(scale, cin, cout):
    from voicefixer_tpu.kernels.upsample import upsample as jax_upsample

    t = 100
    rng = np.random.default_rng(1)
    w = _rand(rng, (2 * scale, cin, cout), 0.05)
    b = _rand(rng, (cout,), 0.05)
    x = _rand(rng, (2, t, cin))

    ref = jax_upsample(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), scale,
                       t_tile=256, interpret=True)
    got = upsample(torch.from_numpy(x), torch.from_numpy(w),
                   torch.from_numpy(b), scale)
    assert got.shape == ref.shape == (2, t * scale, cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


def test_stft_mel_matches_pallas():
    from voicefixer_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
    from voicefixer_tpu.kernels.stft import stft_mel as jax_stft_mel
    from voicefixer_tpu.ops import mel as jax_mel

    from voicefixer_tpu_torch.config import DEFAULT_CONFIG
    from voicefixer_tpu_torch.models.analysis import mel_fbank

    wav = _rand(np.random.default_rng(2), (2, 20000), 0.3)
    m = JAX_CONFIG.mel
    fb = jax_mel.melscale_fbanks(m.n_stft, m.f_min, m.f_max, m.n_mels,
                                 m.sample_rate, norm=None)
    ref = jax_stft_mel(jnp.asarray(wav), jnp.asarray(fb), JAX_CONFIG.stft,
                       t_tile=128, interpret=True)
    port_fb = mel_fbank(DEFAULT_CONFIG, "cpu")
    np.testing.assert_array_equal(port_fb.numpy(), fb)
    got = stft_mel(torch.from_numpy(wav), port_fb, DEFAULT_CONFIG.stft)
    assert got.shape == ref.shape == (2, 20000 // 441 + 1, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)


def _bf16_exact(a):
    """float32 array rounded to bfloat16 values."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _res_params(rng, ch, depth, bf16=False):
    """Blocks as numpy: [{"c1": {"w", "b"}, "c2": {"w", "b"}}]."""
    fix = _bf16_exact if bf16 else (lambda a: a)
    return [{c: {"w": fix(_rand(rng, (3, ch, ch), 0.05)),
                 "b": fix(_rand(rng, (ch,), 0.05))} for c in ("c1", "c2")}
            for _ in range(depth)]


def _tree(params, conv):
    if isinstance(params, dict):
        return {k: _tree(v, conv) for k, v in params.items()}
    if isinstance(params, list):
        return [_tree(v, conv) for v in params]
    return conv(params)


def _sides(dtype):
    """(to jax, to torch, back to float32 numpy, rtol, atol) for a type."""
    if dtype == "bfloat16":
        return (lambda a: jnp.asarray(a).astype(jnp.bfloat16),
                lambda a: torch.from_numpy(a).bfloat16(), 2 ** -7, 1e-3)
    return jnp.asarray, torch.from_numpy, 1e-4, 2e-5


def _assert_close(got, ref, rtol, atol, chained=0):
    got, ref = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
    if chained and rtol == 2 ** -7:  # bfloat16 through several blocks
        off = np.abs(got - ref) > atol + rtol * np.abs(ref)
        assert off.mean() <= 0.005 * chained, off.mean()
        atol = 2 ** -7 * float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype,final_slope", [("float32", None),
                                               ("float32", 0.3),
                                               ("bfloat16", 0.3)])
def test_res_chain_matches_pallas(dtype, final_slope):
    """Three chained blocks, T not a multiple of the JAX tile: the halo, the
    zero padding between chained blocks and the folded stage activation."""
    from voicefixer_tpu.kernels import resstack as jax_resstack

    ch, t, dils = 128, 700, (1, 3, 9)
    rng = np.random.default_rng(7)
    bf16 = dtype == "bfloat16"
    params = _res_params(rng, ch, len(dils), bf16)
    x = _rand(rng, (1, t, ch))
    to_j, to_t, rtol, atol = _sides(dtype)

    def banks(conv):
        return [conv(np.stack([p[c][k] for p in params]))
                for c, k in (("c1", "w"), ("c1", "b"), ("c2", "w"),
                             ("c2", "b"))]

    ref = jax_resstack.res_chain(
        to_j(x), *banks(to_j), dils=dils, slope=0.2, final_slope=final_slope,
        t_tile=256, matmul_dtype=getattr(jnp, dtype), interpret=True)
    got = res_chain(to_t(x), *banks(to_t), dils, 0.2, final_slope)
    assert got.dtype == getattr(torch, dtype)
    _assert_close(got, ref, rtol, atol, chained=3)


@pytest.mark.parametrize("dtype,dil,t", [("float32", 729, 2000),
                                         ("float32", 729, 500),
                                         ("bfloat16", 729, 2000)])
def test_res_shift_single_matches_pallas(dtype, dil, t):
    """One block at dilation 729, on a signal longer than the dilation and on
    one shorter (every outer tap falls outside the signal: the bias-only
    result)."""
    from voicefixer_tpu.kernels.resstack import (
        res_shift_single as jax_shift)

    ch = 128
    rng = np.random.default_rng(11)
    p = _res_params(rng, ch, 1, dtype == "bfloat16")[0]
    x = _rand(rng, (2, t, ch))
    to_j, to_t, rtol, atol = _sides(dtype)
    args = (p["c1"]["w"], p["c1"]["b"], p["c2"]["w"], p["c2"]["b"])
    ref = jax_shift(to_j(x), *map(to_j, args), dil=dil, slope=0.2,
                    final_slope=0.3, t_tile=512,
                    matmul_dtype=getattr(jnp, dtype), interpret=True)
    got = res_shift_single(to_t(x), *map(to_t, args), dil, 0.2, 0.3)
    _assert_close(got, ref, rtol, atol)


@pytest.mark.parametrize("dtype,cout,depth,t_in", [
    ("float32", 128, 3, 70),     # the JAX kernel's plain layout
    ("float32", 64, 2, 160),     # its two-halves lane fold: the port has none
    ("bfloat16", 128, 3, 70),
])
def test_up_res_stack_matches_pallas(dtype, cout, depth, t_in):
    """Upsample x3, ResStack and stage LeakyReLU fused, against the JAX
    package's fused streaming kernel."""
    from voicefixer_tpu.kernels.resstack import up_res_stack as jax_up

    cin, scale = 128, 3
    rng = np.random.default_rng(21)
    bf16 = dtype == "bfloat16"
    fix = _bf16_exact if bf16 else (lambda a: a)
    up = {"w": fix(_rand(rng, (2 * scale, cin, cout), 0.05)),
          "b": fix(_rand(rng, (cout,), 0.05))}
    res = _res_params(rng, cout, depth, bf16)
    x = _rand(rng, (2 if cout == 128 else 1, t_in, cin))
    to_j, to_t, rtol, atol = _sides(dtype)

    ref = jax_up(_tree(up, to_j), _tree(res, to_j), to_j(x), scale, 3, 0.2,
                 final_slope=0.3, matmul_dtype=getattr(jnp, dtype),
                 interpret=True)
    assert ref is not None  # the JAX dispatch took its fused kernel
    got = up_res_stack(_tree(up, to_t), _tree(res, to_t), to_t(x), scale, 3,
                       0.2, final_slope=0.3)
    assert tuple(got.shape) == ref.shape == (x.shape[0], t_in * scale, cout)
    _assert_close(got, ref, rtol, atol, chained=depth)


@pytest.mark.parametrize("ch,itemsize", [(512, 4), (512, 2), (256, 4),
                                         (256, 2), (128, 2), (64, 2),
                                         (16, 4), (2, 4)])
def test_plan_stack(ch, itemsize):
    """The planner covers every block once, in order; a chain fits one
    thread block's shared memory at the efficiency it promises; a fused
    stage starts with a chain."""
    dils = resstack.stack_dilations(8)
    for first_chain in (False, True):
        if first_chain and (ch, itemsize) == (512, 4):
            # not even one block's slab and h fit: such a stage cannot fuse
            with pytest.raises(ValueError):
                resstack.plan_stack(ch, dils, itemsize, first_chain)
            continue
        groups = resstack.plan_stack(ch, dils, itemsize, first_chain)
        assert [g[0] for g in groups] == [0] + [g[1] for g in groups[:-1]]
        assert groups[-1][1] == 8
        for i0, i1, tm in groups:
            if tm is None:
                assert i1 == i0 + 1
                continue
            assert resstack.chain_smem_bytes(ch, dils[i0:i1], tm,
                                             itemsize) <= resstack.SMEM_LIMIT
            if i1 - i0 > 1:
                best = resstack.chain_tile(ch, dils[i0:i1], itemsize)
                assert best[1] >= resstack.MIN_EFFICIENCY
        if first_chain:
            assert groups[0][2] is not None


def test_plan_stack_full_width_runs_every_kernel():
    """At the vocoder's full widths both unfused stages together launch
    res_chain and res_shift_single in either precision."""
    dils = resstack.stack_dilations(8)
    for itemsize in (4, 2):
        groups = [g for ch in (512, 256)
                  for g in resstack.plan_stack(ch, dils, itemsize)]
        assert any(g[2] is not None for g in groups)
        assert any(g[2] is None for g in groups)


@pytest.mark.parametrize("fn", ["res_chain", "res_shift_single"])
def test_res_blocks_short_signal_is_bias_only(fn):
    """Dilation beyond the signal: every outer tap falls outside [0, T), so
    h is the centre tap's product plus the bias, never a read out of
    bounds."""
    rng = np.random.default_rng(5)
    ch, t, d = 8, 20, 27
    p = _res_params(rng, ch, 1)[0]
    x = torch.from_numpy(_rand(rng, (1, t, ch)))
    w1, b1, w2, b2 = (torch.from_numpy(p[c][k]) for c, k in
                      (("c1", "w"), ("c1", "b"), ("c2", "w"), ("c2", "b")))
    if fn == "res_chain":
        got = res_chain(x, w1[None], b1[None], w2[None], b2[None], (d,), 0.2)
    else:
        got = res_shift_single(x, w1, b1, w2, b2, d, 0.2)
    lrelu = torch.nn.functional.leaky_relu
    hb = torch.nn.functional.pad(lrelu(lrelu(x, 0.2) @ w1[1] + b1, 0.2),
                                 (0, 0, 1, 1))
    want = x + b2 + sum(hb[:, j:j + t] @ w2[j] for j in range(3))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_wrappers_refuse_mixed_devices():
    """A wrapper takes its plain version only when every tensor lies on the
    CPU; tensors on other devices are refused, never rerouted."""
    x = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError):
        upsample(x, torch.zeros(6, 8, 4, device="meta"), torch.zeros(4), 3)


# ------------------------------------------- gru_seq, res_stream, convblock

@pytest.mark.parametrize("t,reverse", [(13, False), (13, True), (301, False),
                                       (301, True)])
def test_gru_seq_matches_pallas(t, reverse):
    """One direction, B = 2, T no multiple of the JAX kernel's 8-row tiles
    (its padded tail steps must not advance the state; the port has none)."""
    from voicefixer_tpu.kernels.gru import gru_seq as jax_gru_seq

    b, h = 2, 128
    rng = np.random.default_rng(30)
    xp, w, bias = (_rand(rng, (b, t, 3 * h)), _rand(rng, (h, 3 * h), 0.1),
                   _rand(rng, (3 * h,), 0.1))
    ref = jax_gru_seq(*map(jnp.asarray, (xp, w, bias)), reverse=reverse,
                      interpret=True)
    got = gru_seq(*map(torch.from_numpy, (xp, w, bias)), reverse=reverse)
    assert tuple(got.shape) == ref.shape == (b, t, h)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def _banks(params, conv):
    return [conv(np.stack([p[c][k] for p in params]))
            for c, k in (("c1", "w"), ("c1", "b"), ("c2", "w"), ("c2", "b"))]


def _zero_outside(x, bounds):
    out = np.zeros_like(x)
    out[:, max(bounds[0], 0):bounds[1]] = x[:, max(bounds[0], 0):bounds[1]]
    return out


@pytest.mark.parametrize("dtype,bounds", [("float32", None),
                                          ("float32", (100, 600)),
                                          ("float32", (-40, 650)),
                                          ("bfloat16", (100, 600))])
def test_res_stream_matches_pallas(dtype, bounds):
    """The whole stack in one call at C = 128, with and without a signal
    window, against the JAX package's streaming kernel."""
    from voicefixer_tpu.kernels.resstream import res_stream as jax_stream

    ch, t, dils = 128, 700, (1, 3, 9)
    rng = np.random.default_rng(31)
    params = _res_params(rng, ch, len(dils), dtype == "bfloat16")
    x = _rand(rng, (2, t, ch))
    to_j, to_t, rtol, atol = _sides(dtype)
    jb = None if bounds is None else jnp.asarray(bounds, jnp.int32)
    ref = jax_stream(to_j(x), *_banks(params, to_j), dils=dils, slope=0.2,
                     final_slope=0.3, matmul_dtype=getattr(jnp, dtype),
                     interpret=True, mask_bounds=jb)
    got = res_stream(to_t(x), *_banks(params, to_t), dils, 0.2, 0.3, bounds)
    assert got.dtype == getattr(torch, dtype)
    _assert_close(got, ref, rtol, atol, chained=3)
    if bounds is not None:
        assert float(got[:, :max(bounds[0], 0)].float().abs().sum()) == 0.0
        assert float(got[:, bounds[1]:].float().abs().sum()) == 0.0


@pytest.mark.parametrize("ch,depth,bounds", [(16, 4, (37, 500)),
                                             (16, 6, (-10, 90)),
                                             (256, 4, (37, 500))])
def test_res_stack_with_bounds_matches_jax_plain_path(ch, depth, bounds):
    """``res_stack`` under a window against the JAX package's plain ResStack
    with ``bounds_mask``: narrow stacks go to res_stream, wide ones through
    the planner to res_chain and res_shift_single with the window; the
    input is not zero outside the window, and some dilations exceed it."""
    from voicefixer_tpu.models.vocoder import _res_stack as jax_res_stack
    from voicefixer_tpu.ops.conv import leaky_relu as jax_lrelu

    t = 600
    rng = np.random.default_rng(32)
    params = _res_params(rng, ch, depth)
    x = _rand(rng, (2, t, ch))
    ref, activated = jax_res_stack(_tree(params, jnp.asarray),
                                   jnp.asarray(x), 3, 0.2,
                                   mask_bounds=jnp.asarray(bounds, jnp.int32))
    assert not activated  # the JAX package's plain path on the CPU
    ref = jax_lrelu(ref, 0.3)
    got = res_stack(_tree(params, torch.from_numpy), torch.from_numpy(x), 3,
                    0.2, final_slope=0.3, mask_bounds=bounds)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=2e-5)
    if ch > resstack.FUSE_MAX_CHANNELS:
        groups = resstack.plan_stack(ch, resstack.stack_dilations(depth), 4)
        assert any(g[2] is None for g in groups)   # a shifted-tap block
        assert any(g[2] is not None for g in groups)


@pytest.mark.parametrize("dtype,bounds", [("float32", (100, 600)),
                                          ("float32", (-5, 10 ** 6)),
                                          ("bfloat16", (100, 600))])
def test_res_chain_with_bounds_matches_pallas(dtype, bounds):
    from voicefixer_tpu.kernels import resstack as jax_resstack

    ch, t, dils = 128, 700, (1, 3, 9)
    rng = np.random.default_rng(33)
    params = _res_params(rng, ch, len(dils), dtype == "bfloat16")
    x = _zero_outside(_rand(rng, (1, t, ch)), bounds)
    to_j, to_t, rtol, atol = _sides(dtype)
    ref = jax_resstack.res_chain(
        to_j(x), *_banks(params, to_j), dils=dils, slope=0.2, final_slope=0.3,
        t_tile=256, matmul_dtype=getattr(jnp, dtype), interpret=True,
        mask_bounds=jnp.asarray(bounds, jnp.int32))
    got = res_chain(to_t(x), *_banks(params, to_t), dils, 0.2, 0.3,
                    mask_bounds=bounds)
    _assert_close(got, ref, rtol, atol, chained=3)


def test_res_shift_single_with_bounds_zeroes_x():
    """One block under a window equals the block on the cut-out signal,
    placed back: x outside the window does not reach the result."""
    rng = np.random.default_rng(34)
    ch, t, d, (lo, hi) = 8, 120, 27, (30, 95)
    p = _res_params(rng, ch, 1)[0]
    x = torch.from_numpy(_rand(rng, (1, t, ch)))
    args = [torch.from_numpy(p[c][k]) for c, k in
            (("c1", "w"), ("c1", "b"), ("c2", "w"), ("c2", "b"))]
    got = res_shift_single(x, *args, d, 0.2, 0.3, mask_bounds=(lo, hi))
    inner = res_shift_single(x[:, lo:hi], *args, d, 0.2, 0.3)
    np.testing.assert_allclose(got[:, lo:hi].numpy(), inner.numpy(),
                               rtol=1e-6, atol=1e-6)
    assert float(got[:, :lo].abs().sum() + got[:, hi:].abs().sum()) == 0.0


def _conv_block_params(rng, ci, co):
    def bn(c):
        return {"gamma": 1.0 + 0.1 * _rand(rng, (c,)),
                "beta": 0.1 * _rand(rng, (c,)),
                "mean": 0.05 * _rand(rng, (c,)),
                "var": np.abs(1.0 + 0.1 * _rand(rng, (c,)))}
    p = {"bn1": bn(ci), "conv1": {"w": _rand(rng, (3, 3, ci, co), 0.1)},
         "bn2": bn(co), "conv2": {"w": _rand(rng, (3, 3, co, co), 0.1)}}
    if ci != co:
        p["shortcut"] = {"w": _rand(rng, (1, 1, ci, co), 0.1),
                         "b": 0.1 * _rand(rng, (co,))}
    return p


@pytest.mark.parametrize("t,f,ci,co,dtype", [(40, 15, 32, 32, "float32"),
                                             (48, 31, 16, 32, "float32"),
                                             (40, 7, 64, 64, "float32"),
                                             (48, 31, 16, 32, "bfloat16")])
def test_conv_block_res_matches_pallas(t, f, ci, co, dtype):
    """The fused ConvBlockRes against the JAX kernel in interpret mode (the
    shapes of the JAX package's own test), identity and 1x1 shortcut."""
    from voicefixer_tpu.kernels import convblock as jax_convblock
    from voicefixer_tpu.ops.conv import fold_bn_eval as jax_fold

    from voicefixer_tpu_torch.ops.conv import fold_bn_eval

    rng = np.random.default_rng(35)
    params = _conv_block_params(rng, ci, co)
    x = _rand(rng, (1, t, f, ci), 0.5)
    to_j, to_t, _, _ = _sides(dtype)
    jp = _tree(jax_fold(_tree(params, jnp.asarray)), lambda a: to_j(
        np.asarray(a)))
    pp = _tree(fold_bn_eval(_tree(params, torch.from_numpy)),
               lambda a: to_t(a.numpy()))
    ref = jax_convblock.conv_block_res(to_j(x), jp, 0.01,
                                       matmul_dtype=getattr(jnp, dtype),
                                       tm=256, interpret=True)
    assert convblock.eligible(pp, to_t(x))
    got = convblock.conv_block_res(to_t(x), pp, 0.01)
    assert tuple(got.shape) == ref.shape == (1, t, f, co)
    rtol, atol = (3e-5, 3e-5) if dtype == "float32" else (2 ** -7, 2e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("t,f,ci,co", [(40, 15, 32, 32), (48, 31, 16, 32),
                                       (40, 7, 64, 64), (20, 9, 2, 8)])
def test_conv_block_res_matches_jax_model(t, f, ci, co):
    """... and against the JAX model's own ConvBlockRes (XLA convolutions),
    as the JAX package's test holds its kernel."""
    from voicefixer_tpu.models.resunet import (
        _conv_block_res as jax_conv_block_res)
    from voicefixer_tpu.ops.conv import fold_bn_eval as jax_fold

    from voicefixer_tpu_torch.ops.conv import fold_bn_eval

    rng = np.random.default_rng(36)
    params = _conv_block_params(rng, ci, co)
    x = _rand(rng, (2, t, f, ci), 0.5)
    ref = jax_conv_block_res(jax_fold(_tree(params, jnp.asarray)),
                             jnp.asarray(x), 0.01, training=False)
    got = convblock.conv_block_res(
        torch.from_numpy(x), fold_bn_eval(_tree(params, torch.from_numpy)),
        0.01)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=3e-5,
                               atol=3e-5)


FULL_WIDTH_BLOCKS = [(3008, 127, 2, 32), (3008, 127, 32, 32),
                     (3008, 127, 64, 32), (1504, 63, 32, 64),
                     (1504, 63, 64, 64), (1504, 63, 128, 64),
                     (752, 31, 64, 128), (752, 31, 128, 128)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,f,ci,co", FULL_WIDTH_BLOCKS)
def test_conv_block_eligible_takes_the_full_width_blocks(t, f, ci, co, dtype):
    """The port's rule takes every block the JAX kernel takes at full width
    (at most 128 channels in and out), with a tile that fits one thread
    block's shared memory; shapes only, nothing is allocated."""
    dt = getattr(torch, dtype)
    e = lambda *s: torch.empty(s, device="meta", dtype=dt)  # noqa: E731
    p = {"bn1": {"scale": e(ci), "shift": e(ci)}, "conv1": {"w": e(3, 3, ci, co)},
         "bn2": {"scale": e(co), "shift": e(co)}, "conv2": {"w": e(3, 3, co, co)}}
    if ci != co:
        p["shortcut"] = {"w": e(1, 1, ci, co), "b": e(co)}
    assert convblock.eligible(p, e(1, t, f, ci))
    tm = convblock.plan_tile(f, co, dt.itemsize, ci != co)
    assert convblock.tile_smem_bytes(f, co, tm, dt.itemsize,
                                     ci != co) <= resstack.SMEM_LIMIT
    assert (tm + 2 * (f + 2)) % resstack.BM == 0


@pytest.mark.parametrize("why", ["wide", "unfolded", "k1", "ragged_bf16",
                                 "identity_mismatch"])
def test_conv_block_not_eligible(why):
    e = lambda *s, dt=torch.float32: torch.empty(  # noqa: E731
        s, device="meta", dtype=dt)
    ci, co, dt = 32, 32, torch.float32
    if why == "wide":
        ci = co = 256
    if why == "ragged_bf16":
        co, dt = 12, torch.bfloat16
    if why == "identity_mismatch":
        ci = 16
    p = {"bn1": {"scale": e(ci), "shift": e(ci)},
         "conv1": {"w": e(3, 3, ci, co, dt=dt)},
         "bn2": {"scale": e(co), "shift": e(co)},
         "conv2": {"w": e(3, 3, co, co, dt=dt)}}
    if why == "ragged_bf16":
        p["shortcut"] = {"w": e(1, 1, ci, co, dt=dt), "b": e(co, dt=dt)}
    if why == "unfolded":
        p["bn1"] = {"gamma": e(ci), "beta": e(ci), "mean": e(ci), "var": e(ci)}
    if why == "k1":
        p["conv1"]["w"] = e(1, 1, ci, co)
    assert not convblock.eligible(p, e(1, 16, 15, ci, dt=dt))
