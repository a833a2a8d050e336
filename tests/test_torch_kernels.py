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

The FFT ``stft_mel`` kernel, the GEMM-view ``upsample`` kernel and the
bfloat16 wgmma chain run only on a card, so their index arithmetic is
replayed here in plain torch (``_stockham_fft``, ``_stft_mel_model``,
``_upsample_gemm_model``, ``_chain_wgmma_model``; the ConvBlockRes kernel's
streaming walk, ``_conv_block_stream_model``) and held to the plain
versions and the JAX kernels: 1e-4 for the STFT->mel (float32, another
summation order), 2e-5 for the upsample, the chained bfloat16 tolerance
above for the chain. These models run none of the CUDA code.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from voicefixer_tpu_torch.kernels import convblock, resstack
from voicefixer_tpu_torch.kernels.gru import gru_bidir, gru_seq
from voicefixer_tpu_torch.kernels.resstack import (res_chain,
                                                   res_shift_single,
                                                   res_stack, up_res_stack)
from voicefixer_tpu_torch.kernels.resstream import res_stream
from voicefixer_tpu_torch.kernels.stft import stft_mel
from voicefixer_tpu_torch.kernels.upsample import upsample
from tests.test_torch_weights import one_torch_thread  # noqa: F401


def _rand(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("b,h,t,mm,tol", [
    pytest.param(2, 128, 7, "float32", 1e-5, id="7-float32-1e-05"),
    pytest.param(2, 128, 300, "float32", 1e-5, id="300-float32-1e-05"),
    pytest.param(2, 128, 300, "bfloat16", 2e-3, id="300-bfloat16-0.002"),
    # H no multiple of the card's cluster (16 or 8 blocks) or of a warp's
    # 4 units, T shorter than the kernel's x ring and no multiple of it
    (3, 20, 70, "float32", 1e-5), (3, 200, 3, "float32", 1e-5),
    (1, 200, 70, "float32", 1e-5), (3, 20, 70, "bfloat16", 2e-3),
    (3, 200, 3, "bfloat16", 2e-3), (1, 200, 70, "bfloat16", 2e-3)])
def test_gru_bidir_matches_pallas(b, h, t, mm, tol):
    """Both directions, and the [B, T, 2H] form (``gru_bidir_cat``) that a
    bidirectional layer hands the next."""
    from voicefixer_tpu.kernels.gru import gru_seq_bidir

    from voicefixer_tpu_torch.kernels.gru import gru_bidir_cat

    rng = np.random.default_rng(0)
    xf, xb = _rand(rng, (b, t, 3 * h)), _rand(rng, (b, t, 3 * h))
    wf, wb = _rand(rng, (h, 3 * h), 0.1), _rand(rng, (h, 3 * h), 0.1)
    bf, bb = _rand(rng, (3 * h,), 0.1), _rand(rng, (3 * h,), 0.1)

    ref_f, ref_b = gru_seq_bidir(*map(jnp.asarray, (xf, xb, wf, wb, bf, bb)),
                                 matmul_dtype=getattr(jnp, mm),
                                 interpret=True)
    args = [torch.from_numpy(v) for v in (xf, xb, wf, wb, bf, bb)]
    got_f, got_b = gru_bidir(*args, matmul_dtype=getattr(torch, mm))
    assert tuple(got_f.shape) == tuple(got_b.shape) == (b, t, h)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(ref_f),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(ref_b),
                               rtol=tol, atol=tol)
    cat = gru_bidir_cat(*args, matmul_dtype=getattr(torch, mm))
    np.testing.assert_array_equal(cat.numpy(),
                                  torch.cat([got_f, got_b], -1).numpy())


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
            assert resstack.route_smem_bytes(
                itemsize, ch, dils[i0:i1], tm) <= resstack.SMEM_LIMIT
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

@pytest.mark.parametrize("b,h,t,reverse", [
    pytest.param(2, 128, 13, False, id="13-False"),
    pytest.param(2, 128, 13, True, id="13-True"),
    pytest.param(2, 128, 301, False, id="301-False"),
    pytest.param(2, 128, 301, True, id="301-True"),
    # the bidirectional case's ragged shapes, and H = 1 (one block of the
    # card's cluster owns a unit)
    (3, 20, 3, False), (3, 200, 70, True), (3, 1, 5, False)])
def test_gru_seq_matches_pallas(b, h, t, reverse):
    """One direction, T no multiple of the JAX kernel's 8-row tiles (its
    padded tail steps must not advance the state; the port has none)."""
    from voicefixer_tpu.kernels.gru import gru_seq as jax_gru_seq

    rng = np.random.default_rng(30)
    xp, w, bias = (_rand(rng, (b, t, 3 * h)), _rand(rng, (h, 3 * h), 0.1),
                   _rand(rng, (3 * h,), 0.1))
    ref = jax_gru_seq(*map(jnp.asarray, (xp, w, bias)), reverse=reverse,
                      interpret=True)
    got = gru_seq(*map(torch.from_numpy, (xp, w, bias)), reverse=reverse)
    assert tuple(got.shape) == ref.shape == (b, t, h)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def _gru_cu_constants():
    """The layout constants of csrc/gru_bidir.cu, read from its source."""
    import re
    from pathlib import Path

    import voicefixer_tpu_torch
    src = (Path(voicefixer_tpu_torch.__file__).parent / "csrc" /
           "gru_bidir.cu").read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", src)}


def _gru_cluster_model(x, w, bias, reverse, mm, cluster):
    """One direction of csrc/gru_bidir.cu's walk, replayed in plain torch:
    ``cluster`` blocks of ceil(H / cluster) units rounded up to whole warps
    of UPW, lane ks of a unit's 8 lanes summing h at K = 32 i + 4 ks + j,
    the lanes' partial sums combined in the shuffle order (xor 1, 2, 4),
    the x ring's slots and the h ring's buffers, parities and transaction
    bytes. Runs none of the CUDA code; asserts the schedule's invariants as
    it goes."""
    from voicefixer_tpu_torch.kernels import gru as kg

    k = _gru_cu_constants()
    assert cluster in (k["CLUSTER_WIDE"], k["CLUSTER_NARROW"])
    assert k["MAX_HIDDEN"] == kg.MAX_HIDDEN
    kmax, upw, xring, hbuf = k["MAX_HIDDEN"], k["UPW"], k["XRING"], k["HBUF"]
    bsz, t_total, g = x.shape
    h_dim = g // 3
    # Layout<CL>::units: ceil(H / cluster) rounded up to whole warps
    per = -(-h_dim // cluster)
    u_blk = -(-per // upw) * upw
    assert u_blk <= kmax // cluster  # a block's warps and x ring hold them
    # every unit belongs to exactly one (block, warp, lane group); each warp
    # that owns one pushes UPW values, 16-byte aligned, inside the buffer
    owner = torch.zeros(kmax, dtype=torch.int64)
    pushes = []
    for c in range(cluster):
        nu = max(0, min(u_blk, h_dim - c * u_blk))
        for wp in range(-(-u_blk // upw)):
            cw = max(0, min(upw, nu - wp * upw))
            if cw:
                first = c * u_blk + wp * upw
                assert first % 4 == 0 and first + upw <= kmax
                owner[first:first + cw] += 1
                pushes.append(first)
    assert owner[:h_dim].eq(1).all() and owner[h_dim:].eq(0).all()
    fill_bytes = 16 * len(pushes)
    assert fill_bytes == -(-h_dim // upw) * upw * 4
    # lane ks of a unit's 8 lanes holds K = 32 i + 4 ks + j: all K once
    ks_k = [[32 * i + 4 * ks + j for i in range(kmax // 32) for j in range(4)]
            for ks in range(8)]
    assert sorted(sum(ks_k, [])) == list(range(kmax))

    wq = torch.zeros((kmax, g))
    wq[:h_dim] = w.to(mm).float()
    h = x.new_zeros((bsz, h_dim))
    out = x.new_empty((bsz, t_total, h_dim))
    ring = {}                       # x ring slot -> step it holds
    for d in range(min(xring, t_total)):
        ring[d % xring] = d
    fills = [0] * hbuf              # completed fills per h buffer
    for s in range(t_total):
        t = t_total - 1 - s if reverse else s
        if s:                       # await_h: parity of this buffer's fill
            assert fills[s % hbuf] == (s - 1) // hbuf
            fills[s % hbuf] += 1
        hq = torch.zeros((bsz, kmax))
        hq[:, :h_dim] = h.to(mm).float()
        part = [hq[:, idx] @ wq[idx] for idx in ks_k]
        for off in (1, 2, 4):
            part = [part[i] + part[i ^ off] for i in range(8)]
        hp = part[0] + bias
        assert ring[s % xring] == s
        if s + xring < t_total:
            ring[s % xring] = s + xring
        xt = x[:, t]
        r = torch.sigmoid(xt[:, :h_dim] + hp[:, :h_dim])
        z = torch.sigmoid(xt[:, h_dim:2 * h_dim] + hp[:, h_dim:2 * h_dim])
        n = torch.tanh(xt[:, 2 * h_dim:] + r * hp[:, 2 * h_dim:])
        h = (1.0 - z) * n + z * h
        out[:, t] = h
    assert sum(fills) == t_total - 1
    return out


@pytest.mark.parametrize("cluster", [16, 8])
@pytest.mark.parametrize("h,t,reverse,mm", [
    (20, 3, False, "float32"), (200, 70, True, "float32"),
    (1, 5, False, "float32"), (200, 70, False, "bfloat16"),
    (256, 40, True, "bfloat16")])
def test_gru_cluster_model_matches_pallas(h, t, reverse, mm, cluster):
    """The kernel's partition and summation order (``_gru_cluster_model``)
    against the JAX kernel: float32 1e-5; bfloat16 one ulp of h (2^-8 at
    |h| < 1): the other order moves a float32 h across a bfloat16 rounding
    boundary now and then, and the next products carry the flipped bit
    (2.4e-3 measured at H = 256, T = 40, weights of scale 0.1)."""
    from voicefixer_tpu.kernels.gru import gru_seq_bidir

    rng = np.random.default_rng(33)
    x, w = _rand(rng, (3, t, 3 * h)), _rand(rng, (h, 3 * h), 0.1)
    bias = _rand(rng, (3 * h,), 0.1)
    # both directions on the same weights: the model walks the one asked
    ref = gru_seq_bidir(*map(jnp.asarray, (x, x, w, w, bias, bias)),
                        matmul_dtype=getattr(jnp, mm), interpret=True)
    got = _gru_cluster_model(*map(torch.from_numpy, (x, w, bias)), reverse,
                             getattr(torch, mm), cluster)
    tol = 1e-5 if mm == "float32" else 2 ** -8
    np.testing.assert_allclose(got.numpy(), np.asarray(ref[int(reverse)]),
                               rtol=tol, atol=tol)


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
    (at most 128 channels in and out), with rings that fit one thread
    block's shared memory; shapes only, nothing is allocated."""
    dt = getattr(torch, dtype)
    e = lambda *s: torch.empty(s, device="meta", dtype=dt)  # noqa: E731
    p = {"bn1": {"scale": e(ci), "shift": e(ci)}, "conv1": {"w": e(3, 3, ci, co)},
         "bn2": {"scale": e(co), "shift": e(co)}, "conv2": {"w": e(3, 3, co, co)}}
    if ci != co:
        p["shortcut"] = {"w": e(1, 1, ci, co), "b": e(co)}
    assert convblock.eligible(p, e(1, t, f, ci))
    plan = convblock.plan_stream(t, f, ci, co, dt.itemsize)
    assert plan.smem <= resstack.SMEM_LIMIT
    # every product is whole tiles of the kernel's granule, at most a step
    assert all(n % plan.tile == 0 and 0 < n <= plan.bm
               for _, _, n in plan.products(plan.run))


# the widest F whose two rings fit shared memory, per type and widths
RINGS_LIMIT = {"float32": (128, 128, 64), "bfloat16": (32, 32, 621)}


@pytest.mark.parametrize("why", ["wide", "unfolded", "k1", "ragged_bf16",
                                 "identity_mismatch", "rings_float32",
                                 "rings_bfloat16"])
def test_conv_block_not_eligible(why):
    e = lambda *s, dt=torch.float32: torch.empty(  # noqa: E731
        s, device="meta", dtype=dt)
    ci, co, dt, f = 32, 32, torch.float32, 15
    if why == "wide":
        ci = co = 256
    if why.startswith("rings_"):
        dt = getattr(torch, why[6:])
        ci, co, f = RINGS_LIMIT[why[6:]]
        f += 1
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
    assert not convblock.eligible(p, e(1, 16, f, ci, dt=dt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_block_eligible_at_the_rings_limit(dtype):
    """The kernel holds rings of a step and 2(F + 2) rows of a1 and a2, so
    ``eligible`` takes blocks up to an F set by the widths and the type
    (test_conv_block_not_eligible refuses one more): narrower in F than the
    tile-with-halo kernel it replaced took, wider than the ResUNet's F =
    127 at 32 channels, 63 at 64 and 31 at 128."""
    dt = getattr(torch, dtype)
    ci, co, f = RINGS_LIMIT[dtype]
    e = lambda *s: torch.empty(s, device="meta", dtype=dt)  # noqa: E731
    p = {"bn1": {"scale": e(ci), "shift": e(ci)},
         "conv1": {"w": e(3, 3, ci, co)},
         "bn2": {"scale": e(co), "shift": e(co)},
         "conv2": {"w": e(3, 3, co, co)}}
    assert convblock.eligible(p, e(1, 16, f, ci))
    assert convblock.plan_stream(16, f, ci, co, dt.itemsize).smem <= \
        resstack.SMEM_LIMIT


def test_conv_block_plan_follows_the_sm_count():
    """A card with fewer SMs gets runs that still fill one wave."""
    rows = 3008 * 128
    for sms in (132, 114):
        plan = convblock.plan_stream(3008, 127, 2, 32, 4, sms=sms)
        assert plan.runs <= sms and plan.run == -(-rows // sms)
    assert convblock.sm_count(torch.device("cpu")) == convblock.SMS


def test_conv_block_operands_packed_once_by_the_owner():
    """``resunet.pack_conv_blocks`` gives every ConvBlockRes the kernel can
    take its operands, packed once a type from the block as
    ``resunet.apply`` casts it; ``convblock.operands`` returns those and
    packs a block without them anew; apply's cast leaves them as they are,
    and the output is the same."""
    from voicefixer_tpu_torch.config import tiny_test_config
    from voicefixer_tpu_torch.models import resunet
    from voicefixer_tpu_torch.ops.conv import fold_bn_eval
    from voicefixer_tpu_torch.ops.precision import (conv_block_kernel,
                                                    precision)

    cfg = tiny_test_config().unet
    tree = fold_bn_eval(resunet.init(cfg, torch.Generator().manual_seed(0)))
    done = resunet.pack_conv_blocks(tree)
    names = [("enc1", "block1"), ("enc2", "block1"), ("center",),
             ("dec1", "block2"), ("dec2", "block2"), ("after1",)]
    for name in names:
        block, packed = tree, done
        for k in name:
            block, packed = block[k], packed[k]
        for dt, key in convblock.DTYPE_KEYS.items():
            ops = convblock.operands(packed, dt)
            assert ops is packed["packed"][key]
            cast = resunet._cast(block, dt)
            want = convblock.pack_operands(cast, dt)
            fresh = convblock.operands(cast, dt)
            assert ops.keys() == want.keys() == fresh.keys()
            for k in ops:
                assert torch.equal(ops[k], want[k])
                assert torch.equal(fresh[k], want[k])
            # the batch norms as production's cast rounds them, in float32
            assert ops["s1"].dtype == torch.float32
            assert torch.equal(ops["s1"], block["bn1"]["scale"].to(dt).float())
        assert resunet._cast(packed, torch.bfloat16)["packed"] is \
            packed["packed"]
    assert "packed" not in done["dec1"] and "packed" not in done["after2"]
    x = torch.from_numpy(_rand(np.random.default_rng(44), (1, 20, 128, 2)))
    for mode in ("parity", "production"):
        with precision(mode), conv_block_kernel():
            torch.testing.assert_close(resunet.apply(done, x, cfg),
                                       resunet.apply(tree, x, cfg),
                                       rtol=0, atol=0)


def _old_tile_cost(t, f, ci, co, itemsize, batch=1):
    """Product rows an SM executed in series under the tile-with-halo K9
    (before the streaming kernel): tm rows a thread block, conv1 over tm +
    2(F + 2) rows and conv2 over tm rounded up to 64, one or two thread
    blocks an SM by its shared memory (its planner, plan_tile, restated)."""
    budgets, stage, bm = (resstack.SMEM_LIMIT // 2 - 1024,
                          resstack.SMEM_LIMIT), 32768, 64

    def smem(tm):
        return (stage + (tm + 2 * (f + 2)) * (co + 16 // itemsize) * itemsize
                + (tm * (co + 4) * 4 if ci != co else 0))

    best = None
    for budget in budgets:
        k = 1
        while smem(max(k * bm - 2 * (f + 2), 1)) <= budget:
            tm = k * bm - 2 * (f + 2)
            if tm >= 1:
                eff = 2 * tm / (k * bm + -(-tm // bm) * bm)
                if best is None or eff > best[1]:
                    best = (tm, eff)
            k += 1
        if best is not None and best[1] >= 0.65:
            break
    tm = best[0]
    per_sm = 2 if smem(tm) <= budgets[0] else 1
    tiles = batch * -(-t * (f + 1) // tm)
    return (-(-tiles // (convblock.SMS * per_sm)) * per_sm
            * (tm + 2 * (f + 2) + -(-tm // bm) * bm))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,f,ci,co", FULL_WIDTH_BLOCKS)
def test_conv_block_plan_fits_and_never_executes_more_rows(t, f, ci, co,
                                                           dtype):
    """The streaming plan of each full-width block fits a thread block's
    shared memory, and an SM executes no more product rows in series
    (waves x the busiest block's rows) than under the tile-with-halo kernel
    it replaced."""
    itemsize = getattr(torch, dtype).itemsize
    plan = convblock.plan_stream(t, f, ci, co, itemsize)
    np_, cp1, cp2 = plan.np, plan.cp1, plan.cp2
    if dtype == "float32":
        assert plan.smem == convblock.f32_smem_bytes(np_, plan.tr, cp1, cp2,
                                                     f)
    else:
        assert plan.smem == convblock.wgmma_smem_bytes(np_, plan.bm, cp1,
                                                       cp2, f, plan.stages)
        assert plan.stages >= convblock.WG_STAGES[0]
    assert plan.smem <= resstack.SMEM_LIMIT
    rows = t * (f + 1)
    assert plan.runs * plan.run >= rows > (plan.runs - 1) * plan.run
    cost = -(-plan.runs // convblock.SMS) * plan.block_rows(rows)
    assert cost <= _old_tile_cost(t, f, ci, co, itemsize)


def _conv_block_stream_model(x, params, slope, plan):
    """What csrc/convblock.cu does, per (batch row, run): the a1 and a2
    rings (NaN where unwritten, each slot tagged with the stream row it
    holds), the products in ``convblock.walk`` order, the a1 rows copied
    just before the conv1 that reads them, taps read in place at their row
    offsets modulo the ring, the shortcut as conv2's last K rows over x,
    the masks at the absent column and outside the stream, and the stores
    of the run's rows only. Every tap that a stored output reads must find
    its own row in the ring, and every output is written exactly once."""
    bsz, t, f, ci = x.shape
    co = params["conv1"]["w"].shape[3]
    dt = x.dtype
    fp, hb, rows = f + 1, f + 2, t * (f + 1)
    w1, w2, bsc = convblock.pack_weights(params, dt, plan.np)
    if dt == torch.bfloat16:
        w1, w2 = w1.t(), w2.t()
    w1, w2 = w1.float(), w2.float()
    taps = [(j // 3 - 1) * fp + j % 3 - 1 for j in range(9)]
    lrelu = lambda v: torch.where(v > 0, v, slope * v)  # noqa: E731

    def bn_act(v, bn, c):
        v = v[:, :c] * bn["scale"].float() + bn["shift"].float()
        return lrelu(v).to(dt).float()

    def inside(q):
        return (q >= 0) & (q < rows) & (q % fp < f)

    def pixel(q):
        return (q // fp) * f + q % fp

    y = torch.full((bsz, t * f, co), float("nan"), dtype=dt)
    written = torch.zeros((bsz, t * f), dtype=torch.int64)
    for b in range(bsz):
        xf = x[b].reshape(t * f, ci).float()
        for r in range(plan.runs):
            s0 = r * plan.run
            s1 = min(s0 + plan.run, rows)
            origin2 = s0 - hb - plan.front
            origin1 = origin2 - hb
            rings = {1: torch.full((plan.ring1, plan.cp1), float("nan")),
                     2: torch.full((plan.ring2, plan.cp2), float("nan"))}
            tags = {1: torch.full((plan.ring1,), -10 ** 9),
                    2: torch.full((plan.ring2,), -10 ** 9)}
            origin = {1: origin1, 2: origin2}

            def put(k, q, v):
                slot = (q - origin[k]) % len(tags[k])
                assert len(set(slot.tolist())) == len(slot)
                rings[k][slot], tags[k][slot] = v, q

            def taps_of(k, q, needed):
                parts = []
                for off in taps:
                    slot = (q + off - origin[k]) % len(tags[k])
                    assert torch.equal(tags[k][slot][needed],
                                       (q + off)[needed]), "a stale ring row"
                    parts.append(rings[k][slot])
                return torch.cat(parts, 1)

            a1_end = origin1
            for kind, q0, n in convblock.walk(s0, s1, f, plan.bm, plan.tile,
                                              plan.front):
                assert n % plan.tile == 0 and 0 < n <= plan.bm
                q = torch.arange(q0, q0 + n)
                if kind == "conv1":
                    qa = torch.arange(a1_end, q0 + n + hb)
                    ok = inside(qa)
                    v = torch.zeros((len(qa), plan.cp1))
                    v[:, :ci] = torch.where(
                        ok[:, None], bn_act(xf[pixel(qa).clamp(0, t * f - 1)],
                                            params["bn1"], ci), 0.0)
                    put(1, qa, v)
                    a1_end = q0 + n + hb
                    # a2 rows that stored outputs read: below s1 + hb
                    h = taps_of(1, q, q < s1 + hb) @ w1
                    a2 = torch.zeros((n, plan.cp2))
                    a2[:, :co] = torch.where(inside(q)[:, None],
                                             bn_act(h, params["bn2"], co),
                                             0.0)
                    put(2, q, a2)
                else:
                    keep = (q < s1) & inside(q)
                    a = taps_of(2, q, q < s1)
                    pix = torch.where(inside(q), pixel(q), 0)
                    if bsc is not None:
                        xs = F.pad(xf[pix], (0, plan.cp1 - ci))
                        a = torch.cat([a, xs], 1)
                        res = bsc.float()
                    else:
                        res = xf[pix]
                    out = (a @ w2)[:, :co] + res
                    y[b, pixel(q[keep])] = out[keep].to(dt)
                    written[b, pixel(q[keep])] += 1
    assert written.eq(1).all(), "an output is not written exactly once"
    return y.reshape(bsz, t, f, co)


@pytest.mark.parametrize("dtype,t,f,ci,co,b,run,bm", [
    # float32, batch 2, Ci = 2 -> Co = 10 through the shortcut; a run of
    # 555 rows ends inside a time step after three steps (the rings wrap),
    # the stream's last run is 45 rows
    ("float32", 60, 9, 2, 10, 2, 555, 256),
    # the identity at a 128-row step: two runs of two steps each
    ("float32", 50, 7, 64, 64, 1, 205, 128),
    # a run shorter than the halo (hb = 33): conv1 starts two tiles early
    ("float32", 10, 31, 128, 128, 1, 40, 64),
    # bfloat16: 64-row tiles, the halo's last tile leads and the run's last
    # conv1 is shorter; Ci = 2 through the shortcut, batch 2
    ("bfloat16", 60, 9, 2, 8, 2, 255, 128),
    ("bfloat16", 40, 15, 32, 32, 1, 300, 128),
    ("bfloat16", 8, 31, 64, 128, 1, 100, 128),
])
def test_conv_block_stream_schedule(dtype, t, f, ci, co, b, run, bm):
    """The streaming ConvBlockRes kernel's runs, steps, rings, halo, masks
    and shortcut rows, replayed in plain torch against the plain version."""
    from voicefixer_tpu_torch.ops.conv import fold_bn_eval

    rng = np.random.default_rng(41)
    dt = getattr(torch, dtype)
    params = _tree(fold_bn_eval(_tree(_conv_block_params(rng, ci, co),
                                      torch.from_numpy)),
                   lambda a: a.to(dt))
    x = torch.from_numpy(_rand(rng, (b, t, f, ci), 0.5)).to(dt)
    plan = convblock.plan_stream(t, f, ci, co, dt.itemsize, b, run=run,
                                 bm=bm)
    assert plan is not None and plan.run == run and plan.bm == bm
    got = _conv_block_stream_model(x, params, 0.01, plan)
    ref = convblock.conv_block_res_reference(x, params, 0.01)
    tol = (1e-4, 2e-5) if dtype == "float32" else (2 ** -7, 2e-3)
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol[0],
                               atol=tol[1])


# ------------------------- the redesigned kernels' index arithmetic, modelled
#
# The models below are written here, beside the tests, after csrc/stft_mel.cu
# and csrc/upsample.cu: they hold the algorithms' index arithmetic (pass
# plan, twiddle indices, output order, bands, the shifted flat store) to the
# plain versions and to the JAX kernels, and they run none of the port's
# CUDA code. The kernels themselves are held only on a card, by the gpu
# tests (tests/test_torch_gpu.py) and by chip_smoke.py.

def _rev(i, bits):
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


def _fft2(v, a, b):
    v[a], v[b] = v[a] + v[b], v[a] - v[b]


def _fft4(v, i0, i1, i2, i3):
    _fft2(v, i0, i2)
    _fft2(v, i1, i3)
    v[i3] = v[i3] * -1j
    _fft2(v, i0, i1)
    _fft2(v, i2, i3)


def _butterfly(v):
    """csrc/stft_mel.cu's fft2 / fft4 / fft8, step by step: v[i] ends up
    holding X[rev(i)]."""
    if len(v) == 2:
        _fft2(v, 0, 1)
    elif len(v) == 4:
        _fft4(v, 0, 1, 2, 3)
    else:
        h = 0.70710678118654752440
        for i in range(4):
            _fft2(v, i, i + 4)
        v[5] = v[5] * complex(h, -h)
        v[6] = v[6] * -1j
        v[7] = v[7] * complex(-h, -h)
        _fft4(v, 0, 1, 2, 3)
        _fft4(v, 4, 5, 6, 7)


def _stockham_fft(z, tw):
    """The kernel's transform of z [..., n] complex64: radix-8 Stockham
    passes and a last pass of radix 2 or 4, twiddles from the port's table,
    every index as the kernel computes it."""
    n = z.shape[-1]
    ns = 1
    while ns < n:
        radix = 8 if n // ns >= 8 else n // ns
        stride, tw_step = n // radix, n // (ns * radix)
        j = torch.arange(stride)
        k = j % ns
        j0 = (j // ns) * ns * radix + k
        v = [z[..., j + r * stride] * tw[k * r * tw_step]
             for r in range(radix)]
        _butterfly(v)
        out = torch.empty_like(z)
        bits = radix.bit_length() - 1
        for r in range(radix):
            out[..., j0 + _rev(r, bits) * ns] = v[r]
        z, ns = out, ns * radix
    return z


def _mel_bands(fb):
    """First and last non-zero row of every column (0, -1 for none): what
    the kernel's pre-pass finds."""
    nz = fb != 0
    rows = torch.arange(fb.shape[0])[:, None]
    lo = torch.where(nz, rows, fb.shape[0]).min(0).values
    hi = torch.where(nz, rows, -1).max(0).values
    return torch.where(hi < 0, 0, lo), hi


def _band_product(mag, fb):
    lo, hi = _mel_bands(fb)
    return torch.stack([mag[..., l:h + 1] @ fb[l:h + 1, m] for m, (l, h) in
                        enumerate(zip(lo.tolist(), hi.tolist()))], dim=-1)


def _stft_mel_model(wav, fb, cfg):
    """What csrc/stft_mel.cu does, in plain torch: frames in pairs as one
    complex signal, window, Stockham FFT, the split of the pair, magnitude,
    the mel product over each column's band."""
    from voicefixer_tpu_torch.ops import stft as vstft

    win, tw = vstft.fft_tables(cfg.n_fft, cfg.win_length, torch.device("cpu"))
    tw = torch.complex(tw[:, 0], tw[:, 1])
    frames = vstft.frame_signal(wav, cfg)              # [B, T, n]
    t = frames.shape[1]
    if t % 2:  # the last pair's second frame is zero
        frames = torch.cat([frames, torch.zeros_like(frames[:, :1])], 1)
    x1, x2 = frames[:, 0::2] * win, frames[:, 1::2] * win
    z = _stockham_fft(torch.complex(x1, x2), tw)       # [B, T/2, n]
    n = cfg.n_fft
    k = torch.arange(n // 2 + 1)
    zk, zc = z[..., k], z[..., (n - k) % n].conj()
    spec = torch.stack([(zk + zc) / 2, (zk - zc) / 2j], dim=2)
    spec = spec.reshape(wav.shape[0], -1, n // 2 + 1)[:, :t]
    power = spec.real ** 2 + spec.imag ** 2
    return _band_product(torch.sqrt(torch.clamp(power, min=cfg.mag_eps)), fb)


@pytest.mark.parametrize("n_fft", [64, 128, 256, 512, 1024, 2048, 4096])
def test_stockham_fft_model_matches_fft(n_fft):
    """Every transform size the kernel takes: the pass plan, the butterflies'
    output order and the twiddle indices give the DFT."""
    from voicefixer_tpu_torch.ops import stft as vstft

    _, tw = vstft.fft_tables(n_fft, n_fft, torch.device("cpu"))
    rng = np.random.default_rng(40)
    z = torch.complex(torch.from_numpy(_rand(rng, (3, n_fft))),
                      torch.from_numpy(_rand(rng, (3, n_fft))))
    got = _stockham_fft(z, torch.complex(tw[:, 0], tw[:, 1]))
    ref = torch.fft.fft(z.to(torch.complex128)).to(torch.complex64)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_fft,hop,win,n,n_mels", [
    (256, 100, 200, 5000, 40),       # 51 frames: an odd count, short window
    (256, 100, 200, 4999, 40),       # 50 frames
    (2048, 441, 2048, 8820, 128),    # 21 frames, the model's own STFT
    (2048, 441, 1800, 9261, 128),    # 22 frames, short window
])
def test_stft_mel_fft_model(n_fft, hop, win, n, n_mels):
    """The FFT kernel's algorithm against the plain version and the JAX
    kernel in interpret mode; float32 summed in another order."""
    from voicefixer_tpu.config import STFTConfig as JaxSTFT
    from voicefixer_tpu.kernels.stft import stft_mel as jax_stft_mel

    from voicefixer_tpu_torch.config import STFTConfig
    from voicefixer_tpu_torch.kernels.stft import stft_mel_reference
    from voicefixer_tpu_torch.ops.mel import melscale_fbanks

    kw = dict(n_fft=n_fft, hop_length=hop, win_length=win)
    cfg = STFTConfig(**kw)
    wav = _rand(np.random.default_rng(41), (2, n), 0.3)
    fb = melscale_fbanks(n_fft // 2 + 1, 0.0, 22050.0, n_mels, 44100)
    got = _stft_mel_model(torch.from_numpy(wav), torch.from_numpy(fb), cfg)
    assert got.shape == (2, n // hop + 1, n_mels)
    ref = stft_mel_reference(torch.from_numpy(wav), torch.from_numpy(fb), cfg)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)
    jref = jax_stft_mel(jnp.asarray(wav), jnp.asarray(fb), JaxSTFT(**kw),
                        t_tile=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("kind", ["filterbank", "dense", "gaps"])
def test_mel_band_product_matches_dense(kind):
    """The band finder and the per-column band product against mag @ fb: a
    triangular filterbank, an fb without zeros (full bands), and one with a
    column of zeros and zeros inside a band."""
    from voicefixer_tpu_torch.ops.mel import melscale_fbanks

    rng = np.random.default_rng(42)
    if kind == "filterbank":
        fb = torch.from_numpy(melscale_fbanks(1025, 0.0, 22050.0, 128, 44100))
    else:
        fb = torch.from_numpy(_rand(rng, (129, 24), 0.1))
        if kind == "gaps":
            fb[:, 3] = 0.0
            fb[40:50, 5] = 0.0
            fb[:17, 7] = 0.0
    lo, hi = _mel_bands(fb)
    if kind == "filterbank":
        assert int((hi - lo + 1).sum()) < 3 * 1025  # two columns a bin
    if kind == "dense":
        assert lo.tolist() == [0] * 24 and hi.tolist() == [128] * 24
    if kind == "gaps":
        assert (int(lo[3]), int(hi[3])) == (0, -1) and int(lo[7]) == 17
    mag = torch.from_numpy(np.abs(_rand(rng, (2, 5, fb.shape[0]))))
    np.testing.assert_allclose(_band_product(mag, fb).numpy(),
                               (mag @ fb).numpy(), rtol=1e-5, atol=1e-5)


def _upsample_gemm_model(x, w, b, s):
    """What csrc/upsample.cu does, in plain torch: one product per batch row
    with A[q] = [a[q] | a[q-1]] for q in [0, T] and B = [W[rho]; W[rho+s]]
    side by side over rho, then row q of C stored at (q*s - p)*Cout of the
    flat output under one mask on the flat index."""
    bsz, t, cin = x.shape
    cout = w.shape[2]
    p = s // 2 + s % 2
    a = torch.nn.functional.pad(x + torch.sin(x), (0, 0, 1, 1))  # rows -1..T
    a_mat = torch.cat([a[:, 1:], a[:, :-1]], dim=2)     # [B, T+1, 2Cin]
    b_mat = torch.cat([w[:s], w[s:]], dim=1)            # [s, 2Cin, Cout]
    b_mat = b_mat.permute(1, 0, 2).reshape(2 * cin, s * cout)
    c = a_mat @ b_mat                                   # [B, T+1, s*Cout]
    n_flat = t * s * cout
    idx = ((torch.arange(t + 1) * s - p) * cout)[:, None] \
        + torch.arange(s * cout)[None, :]
    keep = (idx >= 0) & (idx < n_flat)
    # every output sample is written exactly once
    assert torch.bincount(idx[keep], minlength=n_flat).tolist() == [1] * n_flat
    y = torch.zeros((bsz, n_flat))
    y[:, idx[keep]] = c[:, keep] + b[idx[keep] % cout]
    return y.reshape(bsz, t * s, cout)


@pytest.mark.parametrize("t", [1, 63, 64, 65])
@pytest.mark.parametrize("scale", [2, 3, 7])
def test_upsample_gemm_view(scale, t):
    """The GEMM view and the shifted flat store against the plain version
    and the JAX kernel in interpret mode, around one 64-row tile."""
    from voicefixer_tpu.kernels.upsample import upsample as jax_upsample

    from voicefixer_tpu_torch.kernels.upsample import upsample_reference

    cin, cout = 24, 16
    rng = np.random.default_rng(43)
    w = _rand(rng, (2 * scale, cin, cout), 0.05)
    b = _rand(rng, (cout,), 0.05)
    x = _rand(rng, (2, t, cin))
    got = _upsample_gemm_model(*map(torch.from_numpy, (x, w, b)), scale)
    ref = upsample_reference(*map(torch.from_numpy, (x, w, b)), scale)
    assert got.shape == ref.shape == (2, t * scale, cout)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-5, atol=2e-5)
    jref = jax_upsample(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), scale,
                        t_tile=256, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), rtol=2e-5,
                               atol=2e-5)


def test_mel_fbank_is_cached_per_config_and_device():
    """A restore uploads the filterbank once: the same tensor comes back."""
    from voicefixer_tpu_torch.config import (DEFAULT_CONFIG, MelConfig,
                                             VoiceFixerConfig)
    from voicefixer_tpu_torch.models.analysis import mel_fbank

    fb = mel_fbank(DEFAULT_CONFIG, "cpu")
    assert mel_fbank(DEFAULT_CONFIG, torch.device("cpu")) is fb
    other = VoiceFixerConfig(mel=MelConfig(n_mels=64))
    assert mel_fbank(other, "cpu") is not fb
    assert mel_fbank(other, "cpu").shape == (1025, 64)


# --------------------------------------------- the bfloat16 chain's schedule

def _up_source(x_src):
    """a = x + sin(x) in float32, rounded to x's type: the pre-pass."""
    xf = x_src.float()
    return (xf + torch.sin(xf)).to(x_src.dtype).float()


def _up_rows(slab0, slab_rows, scale):
    """(q_lo, nq, pad): the rows q whose phases cover a slab."""
    pad = scale // 2 + scale % 2
    q_lo = (slab0 + pad) // scale
    return q_lo, (slab0 + slab_rows - 1 + pad) // scale - q_lo + 1, pad


def _chain_wgmma_model(x, w1s, b1s, w2s, b2s, dils, slope, final_slope, tm,
                       bounds=None, up=None):
    """What csrc/resstack_wgmma.cu does, in plain torch: per (batch row,
    time tile), the slab (zero outside the window and in the columns [C,
    cp)), then per block and product the (64-row tile, column chunk) pairs
    two to a pass, A rows at their tap offsets clamped to the source
    (conv1's LeakyReLU rounded to bfloat16), B as the tensor maps read w
    (zero past C), and the two epilogues with their masks. With ``up`` =
    (x_src, w_up, b_up, scale) the slab is the upsample's instead: the
    source rows q_lo - 1 .. q_hi of a = x + sin(x) (zero outside the
    signal and past Cin), per phase its 64-row tiles of rows q two to a
    pass, two taps at rows q and q - 1, and the epilogue's masks (zero
    outside [0, T*s) and past C). Shared memory the kernel never writes is
    NaN here, so that a read of it shows; every output row must be written
    exactly once."""
    bsz, t, ch = x.shape
    n = len(dils)
    lo, hi = resstack.clamp_bounds(bounds, t)
    ext = resstack.chain_extents(dils)
    cp = -(-ch // resstack.WG_ALIGN) * resstack.WG_ALIGN
    cols = resstack.wg_cols(ch)
    chunks = -(-ch // cols)
    rows_tile = resstack.WG_ROWS
    e0 = ext[0]
    slab_rows = tm + 2 * e0
    tiles = -(-t // tm)
    bf = lambda v: v.to(torch.bfloat16).float()  # noqa: E731
    lrelu = lambda v, a: torch.where(v > 0, v, a * v)  # noqa: E731

    def wmap(w, k, mats):
        """[mats, k rounded up, chunks * cols]: zero past the tensor"""
        m = torch.zeros((mats, -(-k // resstack.WG_ALIGN) * resstack.WG_ALIGN,
                         chunks * cols))
        m[:, :k, :ch] = w.float().reshape(mats, k, ch)
        return m

    wmaps = (wmap(w1s, ch, 3 * n), wmap(w2s, ch, 3 * n))
    bias = (b1s.float(), b2s.float())
    if up is not None:
        x_src, w_up, b_up, scale = up
        a_src = _up_source(x_src)
        t_in, cin = x_src.shape[1:]
        up_map = wmap(w_up, cin, 2 * scale)
        cinp = up_map.shape[1]
    y = torch.full((bsz, t, ch), float("nan"))
    written = torch.zeros((bsz, t), dtype=torch.int64)
    for bi in range(bsz):
        for tile in range(tiles):
            t0 = tile * tm
            if up is None:
                slab = torch.zeros((slab_rows, cp))
                pos = torch.arange(slab_rows) + t0 - e0
                ok = (pos >= lo) & (pos < hi)
                slab[ok, :ch] = x[bi, pos[ok]].float()
            else:
                slab = torch.full((slab_rows, cp), float("nan"))
                q_lo, nq, pad = _up_rows(t0 - e0, slab_rows, scale)
                src = torch.zeros((nq + 1, cinp))
                q = torch.arange(nq + 1) + q_lo - 1
                ok = (q >= 0) & (q < t_in)
                src[ok, :cin] = a_src[bi, q[ok]]
                q_tiles = -(-nq // rows_tile)
                for rho in range(scale):
                    for m in range(q_tiles):   # two to a pass
                        r = 1 + m * rows_tile + torch.arange(rows_tile)
                        acc = sum(src[(r - tap).clamp(0, nq)]
                                  @ up_map[rho + tap * scale]
                                  for tap in range(2))
                        qr = m * rows_tile + torch.arange(rows_tile)
                        pos = (q_lo + qr) * scale + rho - pad
                        srow = pos - (t0 - e0)
                        keep = (qr < nq) & (srow >= 0) & (srow < slab_rows)
                        inside = ((pos >= 0) & (pos < t))[keep][:, None]
                        v = acc[keep][:, :cp]
                        v[:, :ch] = v[:, :ch] + b_up.float()
                        v = torch.where(inside & (torch.arange(cp) < ch),
                                        v, 0.0)
                        slab[srow[keep]] = bf(v)
            h = torch.full((tm + 2 * ext[1] + 2, cp), float("nan"))
            h[:, ch:] = 0.0
            for i, d in enumerate(dils):
                eo, last = ext[i + 1], i == n - 1
                for conv in range(2):
                    rows = tm + 2 * eo + (0 if conv else 2)
                    pairs = -(-rows // rows_tile) * chunks
                    src = h if conv else slab
                    src_rows = rows + 2 if conv else slab_rows
                    first, step = (1, 1) if conv else (e0 - eo - 1, d)
                    for pair in range(-(-pairs // 2) * 2):
                        if pair >= pairs:
                            continue  # an idle warpgroup in the last pass
                        m, nb = divmod(pair, chunks)
                        r = first + m * rows_tile + torch.arange(rows_tile)
                        acc = torch.zeros((rows_tile, cols))
                        for tap in range(3):
                            a = src[(r + (tap - 1) * step).clamp(
                                0, src_rows - 1)]
                            if conv == 0:
                                a = bf(lrelu(a, slope))
                            acc += a @ wmaps[conv][3 * i + tap, :,
                                                   nb * cols:(nb + 1) * cols]
                        out = m * rows_tile + torch.arange(rows_tile)
                        keep = out < rows
                        nc = torch.arange(nb * cols, min((nb + 1) * cols, ch))
                        v = acc[keep][:, nc - nb * cols] + bias[conv][i, nc]
                        out = out[keep]
                        if conv == 0:
                            p = t0 - eo - 1 + out
                            inside = ((p >= lo) & (p < hi))[:, None]
                            h[out[:, None], nc] = bf(torch.where(
                                inside, lrelu(v, slope), 0.0))
                            continue
                        p = t0 - eo + out
                        inside = ((p >= lo) & (p < hi))[:, None]
                        srow = e0 - eo + out
                        v = torch.where(inside, v + slab[srow[:, None], nc],
                                        0.0)
                        if not last:
                            slab[srow[:, None], nc] = bf(v)
                            continue
                        sel = (p >= 0) & (p < t)
                        if final_slope is not None:
                            v = lrelu(v, final_slope)
                        y[bi, p[sel][:, None], nc] = bf(v[sel])
                        if nb == 0:
                            written[bi, p[sel]] += 1
    assert written.eq(1).all(), "an output row is not written exactly once"
    return y.to(torch.bfloat16)


@pytest.mark.parametrize("ch,t,b,dils,tm,bounds", [
    (24, 333, 2, (1, 3), 17, None),         # C ragged against the boxes
    (40, 100, 1, (1, 3, 9), None, (-5, 60)),
    (16, 20, 1, (27, 81), None, None),       # T < d: bias-only taps
    (8, 90, 1, (1, 3, 1, 2, 1, 1, 3, 1), None, (40, 41)),  # n = 8
    (256, 260, 1, (1, 3, 9), 98, None),      # two row tiles a pass
    (264, 130, 1, (1, 3), None, (3, 10 ** 6)),  # a ragged second chunk
    (512, 140, 1, (1, 3), 54, None),         # both chunks in one pass
])
def test_chain_wgmma_schedule(ch, t, b, dils, tm, bounds):
    """The bfloat16 chain kernel's tiles, passes, clamped tap rows and
    epilogue masks against the plain version, bfloat16 values on both
    sides (the chained tolerance of this file's docstring)."""
    from voicefixer_tpu_torch.kernels.resstack import res_chain_reference

    rng = np.random.default_rng(17)
    bank = [torch.from_numpy(_bf16_exact(_rand(rng, shape, sc)))
            for shape, sc in (((len(dils), 3, ch, ch), 0.5 / (3 * ch) ** 0.5),
                              ((len(dils), ch), 0.05),
                              ((len(dils), 3, ch, ch), 0.5 / (3 * ch) ** 0.5),
                              ((len(dils), ch), 0.05))]
    bank = [v.to(torch.bfloat16) for v in bank]
    x = torch.from_numpy(_rand(rng, (b, t, ch))).to(torch.bfloat16)
    if tm is None:
        tm = resstack.chain_tile(ch, dils, 2)[0]
    assert resstack.wgmma_smem_bytes(ch, dils, tm) <= resstack.SMEM_LIMIT
    got = _chain_wgmma_model(x, *bank, dils, 0.2, 0.3, tm, bounds)
    ref = res_chain_reference(x, *bank, dils, 0.2, 0.3, bounds)
    _assert_close(got, jnp.asarray(ref.float().numpy()), 2 ** -7, 1e-3,
                  chained=len(dils))


_SINGLES = lambda i: tuple((j, j + 1, None) for j in range(i, 8))  # noqa: E731


@pytest.mark.parametrize("ch,itemsize,want,cin", [
    pytest.param(64, 2, ((0, 5, 454),) + _SINGLES(5), None, id="64-2-want0"),
    pytest.param(64, 4, ((0, 4, 170),) + _SINGLES(4), None, id="64-4-want1"),
    pytest.param(128, 2, ((0, 4, 234),) + _SINGLES(4), None,
                 id="128-2-want2"),
    pytest.param(128, 4, ((0, 3, 98),) + _SINGLES(3), None,
                 id="128-4-want3"),
    # up_res_stream, planned for its own kernels with the upsample counted
    pytest.param(64, 2, ((0, 4, 554),) + _SINGLES(4), 128, id="up-64-2"),
    pytest.param(64, 4, ((0, 3, 226),) + _SINGLES(3), 128, id="up-64-4"),
    pytest.param(128, 2, ((0, 4, 234),) + _SINGLES(4), 256, id="up-128-2"),
    pytest.param(128, 4, ((0, 1, 126), (1, 3, 106)) + _SINGLES(3), 256,
                 id="up-128-4"),
])
def test_plan_stack_fused_widths_unchanged(ch, itemsize, want, cin):
    """The fused widths' plans. K7 (res_stream, no cin) plans for the wgmma
    or FMA chain at N = C without the upsample, with and without a chain
    first. K4 (up_res_stream, Cin = cin at scale 3) plans for the same
    chains with the upsample's shared memory and work in its first
    group."""
    from voicefixer_tpu_torch.kernels import resstream

    dils = resstack.stack_dilations(8)
    if cin is None:
        assert resstack.plan_stack(ch, dils, itemsize) == want
        assert resstack.plan_stack(ch, dils, itemsize,
                                   first_chain=True) == want
    else:
        assert resstream.up_plan(cin, ch, 3, dils, itemsize) == want


# (Cin, Cout, scale) of every up_res_stream the tests and the full width run
# (bfloat16 takes widths in multiples of 8)
UP_SHAPES = [(256, 128, 3), (128, 64, 3), (128, 128, 3), (32, 24, 3),
             (4, 2, 7), (8, 16, 3), (40, 24, 7), (32, 16, 3), (64, 32, 3)]


@pytest.mark.parametrize("cin,cout,scale,itemsize", [
    (*shape, size) for shape in UP_SHAPES for size in (4, 2)
    if size == 4 or not (shape[0] % 8 or shape[1] % 8)])
def test_up_res_stream_groups_fit(cin, cout, scale, itemsize):
    """Every group of up_res_stream fits one thread block's shared memory
    with the upsample's source rows counted in the first (bfloat16: at
    least WG_MIN_RING 64-deep ring stages beside them), chains reach the
    efficiency promised, and the first group is a chain; the kernels' own
    formulas (csrc/resstack_wgmma.cu's launch_chain, csrc/resstack_f32.cu's
    launch_chain) agree with the planner's."""
    from voicefixer_tpu_torch.kernels import resstream

    dils = resstack.stack_dilations(8)
    groups = resstream.up_plan(cin, cout, scale, dils, itemsize)
    assert groups[0][2] is not None
    assert [g[0] for g in groups] == [0] + [g[1] for g in groups[:-1]]
    for i0, i1, tm in groups:
        if tm is None:
            continue
        up = (cin, scale) if i0 == 0 else None
        sub = dils[i0:i1]
        e = resstack.chain_extents(sub)
        smem = resstack.route_smem_bytes(itemsize, cout, sub, tm, up)
        assert smem <= resstack.SMEM_LIMIT
        if itemsize == 2:
            # the kernel's count: slab, the larger of h and the source
            # rows, 1 KB of alignment, MIN_STAGES 32-deep stages of N
            ld = -(-cout // 64) * 64 + 8
            src = 0 if up is None else (
                ((tm + 2 * e[0] - 1) // scale + 3) * (-(-cin // 64) * 64 + 8)
                * 2)
            fixed = (tm + 2 * e[0]) * ld * 2 + max(
                (tm + 2 * e[1] + 2) * ld * 2, src)
            assert smem == 1024 + 2 * (32 * resstack.wg_cols(cout) * 2
                                       + 16) + fixed
            # a ring of WG_MIN_RING 64-deep stages is left beside them
            assert resstack.wgmma_ring(cout, sub, tm, up) >= (
                64, resstack.WG_MIN_RING)
        else:
            bm, bn = resstack.f32_tile(cout)
            rows = 2 * tm + 2 * e[0] + 2 * e[1] + 2
            assert smem == 4 * (3 * (bm * 20 + 16 * bn)
                                + rows * (-(-cout // 16) * 16 + 4))
        if i1 - i0 > 1:
            tile = resstack.chain_tile(cout, sub, itemsize, up=up)
            assert tile[0] == tm and tile[1] >= resstack.MIN_EFFICIENCY


@pytest.mark.parametrize("ch", [256, 512])
def test_plan_stack_wgmma_groups_fit(ch):
    """Every bfloat16 chain at the unfused widths fits the wgmma kernel's
    shared memory with its least ring, at the efficiency promised, and
    keeps both warpgroups busy in all but its last pass of a product."""
    dils = resstack.stack_dilations(8)
    groups = resstack.plan_stack(ch, dils, 2)
    chains = [g for g in groups if g[2] is not None]
    assert chains
    for i0, i1, tm in chains:
        sub = dils[i0:i1]
        assert resstack.wgmma_smem_bytes(ch, sub, tm) <= resstack.SMEM_LIMIT
        tile = resstack.chain_tile(ch, sub, 2)
        assert tile[0] == tm and tile[1] >= resstack.MIN_EFFICIENCY
        # the planner's tiles make block 0's h whole 64-row tiles
        assert (tm + 2 * resstack.chain_extents(sub)[1] + 2) % 64 == 0


# ------------------------------------------- the float32 kernels' schedule

F32_STAGES, F32_BK = resstack.F32_STAGES, 16
_A_GLOBAL, _A_SLAB, _A_DIRECT = "global", "slab", "direct"


def _f32_product(mode, src, row0, step, lo, hi, w, k, n, n0, slope):
    """One tap product of csrc/resstack_f32.cu, in plain torch: the BM x BN
    tile (``resstack.f32_tile(n)``) at columns n0 of the N = n outputs, K
    steps (tap, 16 channels) over the len(w) taps of k rows (w[j]: [k, n]),
    each staged into ring slot step % F32_STAGES, F32_STAGES - 1 steps
    ahead, the weights and (from global memory) the A rows as the copies
    leave them: zero outside [lo, hi) and past k. Tile row r of tap j is
    source row row0 + r + j * step. conv1's LeakyReLU is applied to a
    staged A tile once, the slab's rows as they are staged; h
    (``_A_DIRECT``) is read in place, rows past hi read row hi - 1. Slots
    never written are NaN."""
    bm, bn = resstack.f32_tile(n)
    kc = -(-k // F32_BK)
    steps = len(w) * kc
    ring_a = torch.full((F32_STAGES, bm, F32_BK), float("nan"))
    ring_b = torch.full((F32_STAGES, F32_BK, bn), float("nan"))
    r = torch.arange(bm)
    lrelu = lambda v: torch.where(v > 0, v, slope * v)  # noqa: E731

    def tile(p, source, c0):
        """A tile: rows p of source (zero outside [lo, hi)), channels c0 ..
        c0 + 15 (zero past k)."""
        ok = ((p >= lo) & (p < hi))[:, None]
        a = source[p.clamp(lo, hi - 1), c0:min(c0 + F32_BK, k)]
        return F.pad(torch.where(ok, a, 0.0), (0, F32_BK - a.shape[1]))

    def load(it):
        s, (tap, ci) = it % F32_STAGES, divmod(it, kc)
        c0 = ci * F32_BK
        b = torch.zeros((F32_BK, bn))
        kk = torch.arange(c0, min(c0 + F32_BK, k))
        nn = torch.arange(n0, min(n0 + bn, n))
        b[:len(kk), :len(nn)] = w[tap][kk][:, nn]
        ring_b[s] = b
        if mode == _A_GLOBAL:
            ring_a[s] = tile(row0 + r + tap * step, src, c0)

    for it in range(min(F32_STAGES - 1, steps)):
        load(it)
    acc = torch.zeros((bm, bn))
    for it in range(steps):
        s, (tap, ci) = it % F32_STAGES, divmod(it, kc)
        c0 = ci * F32_BK
        if mode == _A_GLOBAL:
            ring_a[s] = lrelu(ring_a[s])
        elif mode == _A_SLAB:
            ring_a[s] = lrelu(tile(row0 + r + tap * step, src, c0))
        if it + F32_STAGES - 1 < steps:
            load(it + F32_STAGES - 1)
        if mode == _A_DIRECT:
            rows = (row0 + r + tap * step).clamp(max=hi - 1)
            a = src[rows][:, c0:c0 + F32_BK]
        else:
            a = ring_a[s]
        acc += a @ ring_b[s]
    return acc


def _f32_ld(ch):
    return -(-ch // F32_BK) * F32_BK + 4


def _f32_cols(ch, n0):
    return torch.arange(n0, min(n0 + resstack.f32_tile(ch)[1], ch))


def test_wgmma_shift_tile_fits_every_width():
    """The bfloat16 single-block kernel's tile at every width in multiples
    of 8 up to 512: h is whole 64-row tiles that the pairs of one pass
    cover (two tiles at one column chunk, one at two), and the ring keeps
    at least two stages beside h within SMEM_LIMIT, 64 deep at one chunk
    where two such fit.
    The tile depends on the width only: a signal shorter than the tile or
    than the dilation is one thread block."""
    for ch in range(8, 513, 8):
        tm, depth, stages = resstack.wgmma_shift_tile(ch)
        cols = resstack.wg_cols(ch)
        chunks = -(-ch // cols)
        assert (tm + 2) % 64 == 0
        assert (tm + 2) // 64 * chunks == resstack.WG_CONSUMERS
        assert resstack.WG_MIN_STAGES <= stages <= 8
        fixed = (tm + 2) * (-(-ch // 64) * 64 + 8) * 2

        def stage(depth):
            return chunks * depth * cols * 2 + 2 * 64 * depth * 2 + 16
        deep = chunks == 1 and 1024 + 2 * stage(64) + fixed \
            <= resstack.SMEM_LIMIT
        assert depth == (64 if deep else 32)
        stage = stage(depth)
        assert 1024 + stages * stage + fixed <= resstack.SMEM_LIMIT
        assert stages == 8 or 1024 + (stages + 1) * stage + fixed \
            > resstack.SMEM_LIMIT
        for t in (1, tm - 1, tm, tm + 1):
            # executed FLOPs: both convolutions over tm + 2 rows a block
            blocks = -(-t // tm)
            assert resstack.wgmma_shift_executed_flops(ch, t) == (
                blocks * 2 * (tm + 2) * 6 * (-(-ch // 64) * 64)
                * chunks * cols)
    assert resstack.wgmma_shift_tile(512) == (62, 32, 4)
    assert resstack.wgmma_shift_tile(256) == (126, 64, 3)
    assert resstack.wgmma_shift_tile(64) == (126, 64, 8)


def _shift_wgmma_model(x, w1, b1, w2, b2, d, slope, final_slope, bounds):
    """What csrc/resstack_wgmma.cu's single-block kernel does, per (batch
    row, thread block of ``wgmma_shift_tile``'s tm output rows): per
    convolution, passes of two (64-row tile, column chunk) pairs, one to a
    warpgroup, over ring stages of (tap, K step of the tile's depth);
    conv1's A the 64-row box of x at the tap from a map over the window's
    rows (zero outside them and past C), LeakyReLU'd; conv2's A h rows
    clamped to h; both epilogues with their masks. Float32 throughout,
    rounded where x's type rounds. Every output row is written exactly
    once."""
    bsz, t, ch = x.shape
    tm, depth, _ = resstack.wgmma_shift_tile(ch)
    cols = resstack.wg_cols(ch)
    chunks = -(-ch // cols)
    cp = -(-ch // 64) * 64
    h_rows = tm + 2
    pairs = h_rows // 64 * chunks
    lo, hi = resstack.clamp_bounds(bounds, t)
    rnd = lambda v: v.to(x.dtype).float()  # noqa: E731
    lrelu = lambda v, a: torch.where(v > 0, v, a * v)  # noqa: E731

    def padded(w):  # [3][cp (K)][chunks * cols (N)], zeros past C
        out = torch.zeros((3, cp, chunks * cols))
        out[:, :ch, :ch] = w.float()
        return out
    wp = (padded(w1), padded(w2))
    win = x.float()[:, lo:hi]   # the tensor map's rows
    y = torch.full((bsz, t, ch), float("nan"))
    written = torch.zeros((bsz, t), dtype=torch.int64)
    r = torch.arange(64)
    for bi in range(bsz):
        for t0 in range(0, t, tm):
            h = torch.full((h_rows, cp), float("nan"))
            h[:, ch:] = 0.0
            for conv in (0, 1):
                for pair in range(-(-pairs // 2) * 2):
                    if pair >= pairs:
                        continue   # an idle warpgroup's pass
                    m, nb = divmod(pair, chunks)
                    acc = torch.zeros((64, cols))
                    for tap in range(3):
                        for kc in range(0, cp, depth):
                            if conv == 0:
                                rows = t0 - 1 + m * 64 + (tap - 1) * d - lo + r
                                ok = (rows >= 0) & (rows < hi - lo)
                                a = torch.zeros((64, depth))
                                part = win[bi, rows[ok], kc:kc + depth]
                                a[ok, :part.shape[1]] = part
                                a = rnd(lrelu(a, slope))
                            else:
                                rows = (1 + m * 64 + r + tap - 1).clamp(
                                    max=h_rows - 1)
                                a = h[rows, kc:kc + depth]
                            acc += a @ wp[conv][tap, kc:kc + depth,
                                                nb * cols:(nb + 1) * cols]
                    n = nb * cols + torch.arange(cols)
                    acc, n = acc[:, n < ch], n[n < ch]
                    rr = m * 64 + r
                    if conv == 0:
                        pos = t0 - 1 + rr
                        inside = ((pos >= lo) & (pos < hi))[:, None]
                        h[rr[:, None], n] = rnd(torch.where(
                            inside, lrelu(acc + b1.float()[n], slope), 0.0))
                        continue
                    pos = t0 + rr
                    keep = (rr < tm) & (pos < t)
                    pos = pos[keep]
                    inside = ((pos >= lo) & (pos < hi))[:, None]
                    v = torch.where(inside, acc[keep] + b2.float()[n]
                                    + x.float()[bi, pos][:, n], 0.0)
                    if final_slope is not None:
                        v = lrelu(v, final_slope)
                    y[bi, pos[:, None], n] = rnd(v)
                    if nb == 0:
                        written[bi, pos] += 1
    assert written.eq(1).all(), "an output row is not written exactly once"
    return y


@pytest.mark.parametrize("ch,t,b,d,bounds", [
    (24, 300, 2, 9, None),             # ragged C; batch 2; three blocks
    (40, 50, 1, 27, None),             # T shorter than the tile
    (64, 100, 1, 2187, None),          # T < d: the bias-only result
    (256, 300, 1, 3, (130, 250)),      # a window starting and ending mid-tile
    (512, 130, 1, 81, (20, 100)),      # two column chunks, 62-row tiles
    (136, 70, 1, 27, (-5, 60)),        # one chunk of 256 columns, ragged
])
def test_shift_wgmma_schedule(ch, t, b, d, bounds):
    """The bfloat16 single-block kernel's tiles, passes, tap boxes in the
    window's coordinates, clamped h rows and masks against the plain
    version, in float32."""
    from voicefixer_tpu_torch.kernels.resstack import (
        res_shift_single_reference)

    rng = np.random.default_rng(23)
    w1, b1, w2, b2 = (v[0] for v in _f32_bank(rng, 1, ch))
    x = torch.from_numpy(_rand(rng, (b, t, ch)))
    got = _shift_wgmma_model(x, w1, b1, w2, b2, d, 0.2, 0.3, bounds)
    ref = res_shift_single_reference(x, w1, b1, w2, b2, d, 0.2, 0.3, bounds)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                               atol=2e-5)


def _shift_f32_model(x, w1, b1, w2, b2, d, slope, final_slope, bounds):
    """What csrc/resstack_f32.cu's shift kernel does, per (batch row,
    BM - 2-row tile): h over BM rows (NaN where unwritten, padding columns
    zero), conv1 from x at its tap offsets, conv2 from h in place, both
    epilogues with their masks. Every output row is written exactly once."""
    bsz, t, ch = x.shape
    bm, bn = resstack.f32_tile(ch)
    lo, hi = resstack.clamp_bounds(bounds, t)
    lrelu = lambda v, a: torch.where(v > 0, v, a * v)  # noqa: E731
    y = torch.full((bsz, t, ch), float("nan"))
    written = torch.zeros((bsz, t), dtype=torch.int64)
    r = torch.arange(bm)
    for bi in range(bsz):
        for t0 in range(0, t, bm - 2):
            h = torch.full((bm, _f32_ld(ch)), float("nan"))
            h[:, ch:] = 0.0
            for n0 in range(0, ch, bn):
                acc = _f32_product(_A_GLOBAL, x[bi], t0 - 1 - d, d, lo, hi,
                                   w1, ch, ch, n0, slope)
                nc = _f32_cols(ch, n0)
                pos = t0 - 1 + r
                inside = ((pos >= lo) & (pos < hi))[:, None]
                h[:, nc] = torch.where(
                    inside, lrelu(acc[:, :len(nc)] + b1[nc], slope), 0.0)
            for n0 in range(0, ch, bn):
                acc = _f32_product(_A_DIRECT, h, 0, 1, 0, bm, w2, ch, ch, n0,
                                   slope)
                nc = _f32_cols(ch, n0)
                pos = t0 + r
                keep = (r < bm - 2) & (pos < t)
                pos = pos[keep]
                inside = ((pos >= lo) & (pos < hi))[:, None]
                v = torch.where(inside, acc[keep][:, :len(nc)] + b2[nc]
                                + x[bi, pos][:, nc], 0.0)
                if final_slope is not None:
                    v = lrelu(v, final_slope)
                y[bi, pos[:, None], nc] = v
                if n0 == 0:
                    written[bi, pos] += 1
    assert written.eq(1).all(), "an output row is not written exactly once"
    return y


def _chain_f32_model(x, w1s, b1s, w2s, b2s, dils, slope, final_slope, tm,
                     bounds, up=None):
    """What csrc/resstack_f32.cu's chain kernel does, per (batch row, time
    tile): the slab (zero outside the window; padding columns NaN), then
    per block conv1 from the slab over BM-row tiles and column passes, and
    conv2 from h in place, written over the slab or, for the last block, to
    the tile's output rows. h is NaN where unwritten, its padding columns
    zero. With ``up`` = (x_src, w_up, b_up, scale) the slab is the
    upsample's: per BM-row tile of rows q and phase, a two-tap product from
    a = x + sin(x) in global memory (rows q and q - 1, zero outside the
    signal, slope 1), its epilogue's masks (zero outside [0, T*s))."""
    bsz, t, ch = x.shape
    bm, bn = resstack.f32_tile(ch)
    n = len(dils)
    lo, hi = resstack.clamp_bounds(bounds, t)
    ext = resstack.chain_extents(dils)
    e0 = ext[0]
    slab_rows = tm + 2 * e0
    lrelu = lambda v, a: torch.where(v > 0, v, a * v)  # noqa: E731
    y = torch.full((bsz, t, ch), float("nan"))
    written = torch.zeros((bsz, t), dtype=torch.int64)
    r = torch.arange(bm)
    if up is not None:
        x_src, w_up, b_up, scale = up
        a_src = _up_source(x_src)
        t_in, cin = x_src.shape[1:]
    for bi in range(bsz):
        for t0 in range(0, t, tm):
            slab = torch.full((slab_rows, _f32_ld(ch)), float("nan"))
            if up is None:
                pos = torch.arange(slab_rows) + t0 - e0
                ok = (pos >= lo) & (pos < hi)
                slab[:, :ch] = 0.0
                slab[ok, :ch] = x[bi, pos[ok]]
            else:
                q_lo, nq, pad = _up_rows(t0 - e0, slab_rows, scale)
                for m0 in range(0, nq, bm):
                    for rho in range(scale):
                        for n0 in range(0, ch, bn):
                            acc = _f32_product(
                                _A_GLOBAL, a_src[bi], q_lo + m0, -1, 0, t_in,
                                (w_up[rho], w_up[rho + scale]), cin, ch, n0,
                                1.0)
                            nc = _f32_cols(ch, n0)
                            pos = (q_lo + m0 + r) * scale + rho - pad
                            srow = pos - (t0 - e0)
                            keep = ((m0 + r < nq) & (srow >= 0)
                                    & (srow < slab_rows))
                            inside = ((pos >= lo) & (pos < hi))[keep][:, None]
                            slab[srow[keep][:, None], nc] = torch.where(
                                inside, acc[keep][:, :len(nc)] + b_up[nc],
                                0.0)
            h = torch.full((tm + 2 * ext[1] + 2, _f32_ld(ch)), float("nan"))
            h[:, ch:] = 0.0
            for i, d in enumerate(dils):
                eo = ext[i + 1]
                h_rows, y_rows = tm + 2 * eo + 2, tm + 2 * eo
                for m0 in range(0, h_rows, bm):
                    for n0 in range(0, ch, bn):
                        acc = _f32_product(_A_SLAB, slab,
                                           e0 - eo - 1 + m0 - d, d, 0,
                                           slab_rows, w1s[i], ch, ch, n0,
                                           slope)
                        nc = _f32_cols(ch, n0)
                        hr = m0 + r
                        keep = hr < h_rows
                        p = t0 - eo - 1 + hr[keep]
                        inside = ((p >= lo) & (p < hi))[:, None]
                        h[hr[keep][:, None], nc] = torch.where(
                            inside, lrelu(acc[keep][:, :len(nc)]
                                          + b1s[i][nc], slope), 0.0)
                for m0 in range(0, y_rows, bm):
                    for n0 in range(0, ch, bn):
                        acc = _f32_product(_A_DIRECT, h, m0, 1, 0, h_rows,
                                           w2s[i], ch, ch, n0, slope)
                        nc = _f32_cols(ch, n0)
                        yr = m0 + r
                        yr = yr[yr < y_rows]
                        p = t0 - eo + yr
                        srow = e0 - eo + yr
                        inside = ((p >= lo) & (p < hi))[:, None]
                        v = torch.where(inside, acc[:len(yr), :len(nc)]
                                        + b2s[i][nc]
                                        + slab[srow[:, None], nc], 0.0)
                        if i + 1 < n:
                            slab[srow[:, None], nc] = v
                            continue
                        sel = (p >= 0) & (p < t)
                        if final_slope is not None:
                            v = lrelu(v, final_slope)
                        y[bi, p[sel][:, None], nc] = v[sel]
                        if n0 == 0:
                            written[bi, p[sel]] += 1
    assert written.eq(1).all(), "an output row is not written exactly once"
    return y


def _f32_bank(rng, n, ch):
    sc = 1 / (3 * ch) ** 0.5
    return [torch.from_numpy(_rand(rng, shape, s))
            for shape, s in (((n, 3, ch, ch), sc), ((n, ch), 0.05),
                             ((n, 3, ch, ch), sc), ((n, ch), 0.05))]


@pytest.mark.parametrize("ch,t,b,d,bounds", [
    (2, 70, 2, 3, None),               # C far below a K step; batch 2
    (24, 130, 1, 27, (10, 100)),       # ragged C; a window across tiles
    (16, 20, 1, 27, None),             # T < d: the bias-only result
    (512, 50, 1, 9, (-5, 45)),         # two column passes
])
def test_shift_f32_schedule(ch, t, b, d, bounds):
    """The float32 single-block kernel's tiles, passes, ring order,
    zero-filled rows and window masks against the plain version."""
    from voicefixer_tpu_torch.kernels.resstack import (
        res_shift_single_reference)

    rng = np.random.default_rng(19)
    w1, b1, w2, b2 = (v[0] for v in _f32_bank(rng, 1, ch))
    x = torch.from_numpy(_rand(rng, (b, t, ch)))
    got = _shift_f32_model(x, w1, b1, w2, b2, d, 0.2, 0.3, bounds)
    ref = res_shift_single_reference(x, w1, b1, w2, b2, d, 0.2, 0.3, bounds)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                               atol=2e-5)


@pytest.mark.parametrize("ch,t,b,dils,tm,bounds", [
    (24, 100, 2, (1, 3), 17, None),          # ragged C; batch 2
    (2, 77, 1, (1, 3, 9), None, (5, 60)),    # C = 2 under a window
    (24, 150, 1, (1, 3, 9), 100, (-3, 140)),  # h over three 64-row tiles
    (16, 20, 1, (27, 81), None, None),       # T < d: bias-only taps
    (256, 70, 1, (1, 3), 54, None),          # stage 1's chain
    (512, 2, 1, (1, 3), 1, None),            # two column passes
])
def test_chain_f32_schedule(ch, t, b, dils, tm, bounds):
    """The float32 chain kernel's tiles, passes, ring order, zero-filled
    rows, in-place slab and window masks against the plain version."""
    from voicefixer_tpu_torch.kernels.resstack import res_chain_reference

    rng = np.random.default_rng(23)
    bank = _f32_bank(rng, len(dils), ch)
    x = torch.from_numpy(_rand(rng, (b, t, ch)))
    if tm is None:
        tm = resstack.chain_tile(ch, dils, 4)[0]
    assert resstack.f32_smem_bytes(ch, dils, tm) <= resstack.SMEM_LIMIT
    got = _chain_f32_model(x, *bank, dils, 0.2, 0.3, tm, bounds)
    ref = res_chain_reference(x, *bank, dils, 0.2, 0.3, bounds)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                               atol=2e-5)


def _up_case(rng, b, t_in, cin, cout, scale, n, fix=lambda a: a):
    """x_src, w_up, b_up and a bank of n blocks, numpy-seeded."""
    x = torch.from_numpy(fix(_rand(rng, (b, t_in, cin))))
    w_up = torch.from_numpy(fix(_rand(rng, (2 * scale, cin, cout),
                                      0.7 / (2 * cin) ** 0.5)))
    b_up = torch.from_numpy(fix(_rand(rng, (cout,), 0.05)))
    sc = 1 / (3 * cout) ** 0.5
    bank = [torch.from_numpy(fix(_rand(rng, shape, s)))
            for shape, s in (((n, 3, cout, cout), sc), ((n, cout), 0.05),
                             ((n, 3, cout, cout), sc), ((n, cout), 0.05))]
    return x, w_up, b_up, bank


@pytest.mark.parametrize("cin,cout,scale,t_in,b,dils,tm", [
    (32, 24, 3, 40, 2, (1, 3), None),     # ragged C and Cin; batch 2
    (4, 2, 7, 9, 1, (1, 3, 9), 17),       # C = 2: scalar copies; s = 7
    (16, 64, 3, 30, 1, (1, 3, 9), None),  # C = 64: a 128-row tile
    (24, 128, 2, 20, 1, (1,), 50),        # even scale: pad 1
    (8, 16, 3, 3, 1, (27, 81), None),     # every tap beyond the signal
])
def test_up_chain_f32_schedule(cin, cout, scale, t_in, b, dils, tm):
    """The float32 chain with the upsample in front: its source rows q and
    phases, tiles of rows q, the slab's masks at the signal's ends and the
    first rows of every batch row, against the plain version."""
    from voicefixer_tpu_torch.kernels.resstream import up_res_stream_reference

    rng = np.random.default_rng(29)
    x, w_up, b_up, bank = _up_case(rng, b, t_in, cin, cout, scale, len(dils))
    if tm is None:
        tm = resstack.chain_tile(cout, dils, 4, up=(cin, scale))[0]
    got = _chain_f32_model(torch.zeros((b, t_in * scale, cout)), *bank, dils,
                           0.2, 0.3, tm, None, up=(x, w_up, b_up, scale))
    ref = up_res_stream_reference(x, w_up, b_up, *bank, dils, scale, 0.2,
                                  0.3)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                               atol=2e-5)


@pytest.mark.parametrize("cin,cout,scale,t_in,b,dils,tm", [
    (32, 24, 3, 40, 2, (1, 3), None),     # C pads N to 64; batch 2
    (64, 128, 3, 50, 1, (1, 3, 9), 98),   # N = 128, three tiles of rows q
    (72, 64, 7, 12, 1, (1, 3), 40),       # Cin ragged against the box
    (8, 16, 3, 3, 1, (27, 81), None),     # every tap beyond the signal
])
def test_up_chain_wgmma_schedule(cin, cout, scale, t_in, b, dils, tm):
    """The bfloat16 chain with the upsample in front: its source rows
    (where h will be), phases and passes of rows q, the slab's masks and
    the row above each tile's first, against the plain version (bfloat16
    values on both sides, the chained tolerance)."""
    from voicefixer_tpu_torch.kernels.resstream import up_res_stream_reference

    rng = np.random.default_rng(31)
    x, w_up, b_up, bank = _up_case(rng, b, t_in, cin, cout, scale, len(dils),
                                   _bf16_exact)
    x, w_up, b_up = (v.to(torch.bfloat16) for v in (x, w_up, b_up))
    bank = [v.to(torch.bfloat16) for v in bank]
    if tm is None:
        tm = resstack.chain_tile(cout, dils, 2, up=(cin, scale))[0]
    assert resstack.wgmma_smem_bytes(cout, dils, tm, up=(cin, scale)) \
        <= resstack.SMEM_LIMIT
    got = _chain_wgmma_model(torch.zeros((b, t_in * scale, cout)), *bank,
                             dils, 0.2, 0.3, tm, up=(x, w_up, b_up, scale))
    ref = up_res_stream_reference(x, w_up, b_up, *bank, dils, scale, 0.2,
                                  0.3)
    _assert_close(got, jnp.asarray(ref.float().numpy()), 2 ** -7, 1e-3,
                  chained=len(dils))


# ------------------------------------- gradients: K6's backward, the guard


def _gru_args(rng, b, t, h, dtype=torch.float32):
    """(xf, xb, w_f, w_b, b_f, b_b) leaves that require grad."""
    shapes = [(b, t, 3 * h)] * 2 + [(h, 3 * h)] * 2 + [(3 * h,)] * 2
    scales = [1.0, 1.0, 0.5, 0.5, 0.3, 0.3]
    return [torch.tensor(_rand(rng, s, c), dtype=dtype).requires_grad_()
            for s, c in zip(shapes, scales)]


@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 7])
def test_gru_bidir_backward_matches_autograd(t, mm):
    """The Function's backward (``gru_bidir_backward``, the one the card
    runs) against autograd through the plain loop, both directions; under
    bfloat16 both treat the rounding of h and W as identity. rtol 1e-4,
    atol 1e-6 (float32 sums in another order)."""
    from voicefixer_tpu_torch.kernels.gru import (GruBidir, gru_bidir_cat,
                                                  gru_bidir_reference)
    rng = np.random.default_rng(t)
    args = _gru_args(rng, 2, t, 5)
    dt = getattr(torch, mm)
    out = gru_bidir_cat(*args, matmul_dtype=dt)
    assert out.grad_fn is not None and \
        type(out.grad_fn).__name__ == GruBidir.__name__ + "Backward"
    g = torch.tensor(_rand(rng, tuple(out.shape)))
    got = torch.autograd.grad(out, args, g)
    ref = torch.autograd.grad(
        torch.cat(gru_bidir_reference(*args, matmul_dtype=dt), -1), args, g)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("t,layers", [(1, 1), (7, 1), (7, 2)])
def test_gru_backward_matches_jax_grad(t, layers):
    """``ops.gru.gru`` (bidirectional: projections, then K6's Function) and
    its gradients for the input and every weight against ``jax.grad`` of
    the JAX package's plain ``ops.gru.gru`` (its kernel is off on the
    CPU), rtol 1e-4, atol 1e-6."""
    import jax
    from voicefixer_tpu.ops import gru as jax_gru

    from voicefixer_tpu_torch.ops.gru import gru
    from voicefixer_tpu_torch.utils.weights import tree_map
    rng = np.random.default_rng(10 + t)
    b, cin, h = 2, 4, 5
    x = _rand(rng, (b, t, cin))
    params = {}
    for layer in range(layers):
        for sfx in ("", "_reverse"):
            i = cin if layer == 0 else 2 * h
            params[f"l{layer}{sfx}"] = {
                "w_ih": _rand(rng, (3 * h, i), 0.4),
                "w_hh": _rand(rng, (3 * h, h), 0.4),
                "b_ih": _rand(rng, (3 * h,), 0.2),
                "b_hh": _rand(rng, (3 * h,), 0.2)}
    g = _rand(rng, (b, t, 2 * h))

    def jax_loss(x, p):
        return jnp.sum(jax_gru.gru(x, p, layers, bidirectional=True) * g)

    jgx, jgp = jax.grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(x), tree_map(jnp.asarray, params))
    tx = torch.tensor(x, requires_grad=True)
    tp = tree_map(lambda v: torch.tensor(v, requires_grad=True), params)
    (gru(tx, tp, layers, bidirectional=True) * torch.tensor(g)).sum(
        ).backward()
    pairs = [(tx.grad, jgx)] + [
        (tp[k][n].grad, jgp[k][n]) for k in params for n in params[k]]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-6)


def test_gru_bidir_gradcheck():
    """Finite differences in float64 at a tiny size."""
    from voicefixer_tpu_torch.kernels.gru import gru_bidir_cat
    args = _gru_args(np.random.default_rng(3), 2, 4, 3, torch.float64)
    assert torch.autograd.gradcheck(
        lambda *a: gru_bidir_cat(*a, matmul_dtype=torch.float64), args)


def test_gru_bidir_takes_the_function_only_for_grad():
    """Grad mode on and an input that requires grad: the Function. No
    input that requires grad, or grad mode off: the plain call, no graph;
    the values are the same."""
    from voicefixer_tpu_torch.kernels.gru import gru_bidir_cat
    args = _gru_args(np.random.default_rng(4), 1, 3, 2)
    with_grad = gru_bidir_cat(*args)
    with torch.no_grad():
        without = gru_bidir_cat(*args)
    detached = gru_bidir_cat(*(a.detach() for a in args))
    assert with_grad.grad_fn is not None
    assert without.grad_fn is None and detached.grad_fn is None
    assert torch.equal(with_grad.detach(), without)
    assert torch.equal(without, detached)


class _Launched(Exception):
    """Raised in place of loading a kernel's library."""


def _guard_cases():
    """One call of each ctypes wrapper with small valid shapes."""
    from voicefixer_tpu_torch.config import DEFAULT_CONFIG
    from voicefixer_tpu_torch.kernels import gru as kgru
    from voicefixer_tpu_torch.kernels import resstream
    from voicefixer_tpu_torch.models.analysis import mel_fbank
    r = lambda *s: torch.randn(s)  # noqa: E731
    c = 8
    bn = {"scale": r(c), "shift": r(c), "gamma": r(c), "beta": r(c),
          "mean": r(c), "var": r(c).abs()}
    block = {"bn1": bn, "bn2": bn, "conv1": {"w": r(3, 3, c, c)},
             "conv2": {"w": r(3, 3, c, c)}}
    return {
        "stft_mel": lambda w: stft_mel(w(r(1, 4096)),
                                       mel_fbank(DEFAULT_CONFIG, "cpu"),
                                       DEFAULT_CONFIG.stft),
        "upsample": lambda w: upsample(w(r(1, 4, c)), r(6, c, c), r(c), 3),
        "res_chain": lambda w: res_chain(w(r(1, 16, c)), r(1, 3, c, c),
                                         r(1, c), r(1, 3, c, c), r(1, c),
                                         (1,)),
        "res_shift_single": lambda w: res_shift_single(
            w(r(1, 16, c)), r(3, c, c), r(c), r(3, c, c), r(c), 1),
        "up_res_stream": lambda w: resstream.up_res_stream(
            r(1, 4, c), r(6, c, c), r(c), w(r(1, 3, c, c)), r(1, c),
            r(1, 3, c, c), r(1, c), (1,), 3),
        "res_stream": lambda w: res_stream(w(r(1, 16, c)), r(1, 3, c, c),
                                           r(1, c), r(1, 3, c, c), r(1, c),
                                           (1,)),
        "gru_seq": lambda w: gru_seq(r(1, 3, 6), w(r(2, 6)), r(6)),
        "conv_block_res": lambda w: convblock.conv_block_res(
            r(1, 4, 4, c), {**block, "conv2": {"w": w(r(3, 3, c, c))}},
            0.01),
        "gru_bidir": lambda w: kgru.gru_bidir_cat(
            w(r(1, 3, 6)), r(1, 3, 6), r(2, 6), r(2, 6), r(6), r(6)),
    }


@pytest.mark.parametrize("name", ["stft_mel", "upsample", "res_chain",
                                  "res_shift_single", "up_res_stream",
                                  "res_stream", "gru_seq", "conv_block_res"])
def test_kernel_launch_raises_under_grad(monkeypatch, name):
    """Every ctypes wrapper, taken to its launch (``on_cpu`` patched to
    say CUDA, the library load patched to raise ``_Launched``), raises
    RuntimeError naming the kernel before it launches, where grad mode is
    on and an input requires grad: its output would carry no gradient."""
    from voicefixer_tpu_torch import kernels
    from voicefixer_tpu_torch.kernels import build
    monkeypatch.setattr(kernels, "on_cpu", lambda *a: False)
    monkeypatch.setattr(build, "load", lambda *a: (_ for _ in ()).throw(
        _Launched()))
    call = _guard_cases()[name]
    with pytest.raises(RuntimeError, match=f"^{name}: the CUDA kernel has no "
                       "backward"):
        call(lambda t: t.requires_grad_())
    assert kernels.launches[name] == 0


def test_gru_bidir_launches_inside_its_function(monkeypatch):
    """K6 is the one kernel exempt: under grad its wrapper goes through
    ``GruBidir``, whose forward launches with grad mode off, so the launch
    is reached (``_Launched``) instead of the guard's error."""
    from voicefixer_tpu_torch import kernels
    from voicefixer_tpu_torch.kernels import build
    monkeypatch.setattr(kernels, "on_cpu", lambda *a: False)
    monkeypatch.setattr(build, "load", lambda *a: (_ for _ in ()).throw(
        _Launched()))
    with pytest.raises(_Launched):
        _guard_cases()["gru_bidir"](lambda t: t.requires_grad_())


def test_check_no_grad():
    """The guard itself: nested lists and dicts are searched; no grad mode,
    inference mode or no input that requires grad lets the launch go."""
    from voicefixer_tpu_torch import kernels
    leaf = torch.zeros(2, requires_grad=True)
    plain = torch.zeros(2)
    with pytest.raises(RuntimeError, match="^k: "):
        kernels.check_no_grad("k", plain, {"a": [plain, leaf]})
    kernels.check_no_grad("k", plain, {"a": [plain]})
    with torch.no_grad():
        kernels.check_no_grad("k", leaf)
    with torch.inference_mode():
        kernels.check_no_grad("k", leaf)
