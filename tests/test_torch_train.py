"""The port's training mode and trainer (``train/``, ``utils/params.py``)
against the JAX package at ``tiny_test_config``, on parameters and inputs
drawn from numpy seeds and carried across by ``from_jax_params``.

Tolerances: 1e-5 for the training-mode forward (``test_torch_pipeline``'s
TOL; float32 on both sides, batch statistics summed in another order);
rtol 1e-4, atol 1e-6 for the loss's gradients (a backward pass through two
GRU stacks and the U-Net); 1e-6 for parameters after optimizer updates fed
the same gradients. Dropout is 0 wherever the two packages meet: torch
cannot draw the JAX package's PRNG streams. Dropout itself is held to its
definition.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from voicefixer_tpu.config import DEFAULT_CONFIG as JAX_DEFAULT
from voicefixer_tpu.config import tiny_test_config as jax_tiny
from voicefixer_tpu.models import analysis as jax_analysis
from voicefixer_tpu.models import denoiser as jax_denoiser
from voicefixer_tpu.models import resunet as jax_resunet
from voicefixer_tpu.ops import conv as jax_conv
from voicefixer_tpu.train import augment as jax_augment
from voicefixer_tpu.train import data as jax_data
from voicefixer_tpu.train import losses as jax_losses
from voicefixer_tpu.train import step as jax_step
from voicefixer_tpu.utils import params as jax_params_util

from voicefixer_tpu_torch.config import DEFAULT_CONFIG, tiny_test_config
from voicefixer_tpu_torch.models import analysis, denoiser, resunet
from voicefixer_tpu_torch.ops import conv
from voicefixer_tpu_torch.ops.precision import precision
from voicefixer_tpu_torch.train import augment, data, losses
from voicefixer_tpu_torch.train import step as st
from voicefixer_tpu_torch.train.checkpoint import (load_train_state,
                                                   save_train_state)
from voicefixer_tpu_torch.utils import params as params_util
from voicefixer_tpu_torch.utils.weights import (convert_tree,
                                               from_jax_train_state,
                                               tree_leaves, tree_map)
from tests.test_torch_weights import (jax_param_trees,  # noqa: F401
                                      jax_shapes, one_torch_thread)

TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def _no_dropout(cfg):
    return dataclasses.replace(cfg, denoiser=dataclasses.replace(
        cfg.denoiser, dropout=0.0))


CFG, JCFG = _no_dropout(tiny_test_config()), _no_dropout(jax_tiny())


@pytest.fixture(scope="module")
def trees():
    """(JAX analysis tree of numpy leaves, the port's tree)."""
    ja, _ = jax_param_trees(31)
    return ja, convert_tree(ja, "analysis")


def _wav(shape, seed):
    return (0.1 * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _jit(fn, **static):
    return jax.jit(functools.partial(fn, **static))


def _close(got, want, rtol=TOL, atol=TOL):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), rtol=rtol, atol=atol)


# ------------------------------------------------ the training-mode forward

@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (4, 6), (3, 1, 9)])
def test_batch_norm_training_matches_jax(shape):
    """Batch statistics over every axis but the last, biased variance,
    gamma and beta: the folded (scale, shift) leaves are not read."""
    rng = np.random.default_rng(len(shape))
    c = shape[-1]
    p = {"gamma": 1 + _wav(c, 1), "beta": _wav(c, 2), "mean": _wav(c, 3),
         "var": 1 + np.abs(_wav(c, 4))}
    x = 2 + rng.standard_normal(shape).astype(np.float32)
    want = jax_conv.batch_norm(jnp.asarray(x), tree_map(jnp.asarray, p),
                               training=True)
    tp = conv.fold_bn_eval(tree_map(torch.tensor, p))
    assert {"gamma", "beta", "mean", "var", "scale", "shift"} == set(tp)
    _close(conv.batch_norm(torch.tensor(x), tp, training=True), want)
    # eval still takes the folded leaves
    _close(conv.batch_norm(torch.tensor(x), tp),
           jax_conv.batch_norm(jnp.asarray(x), jax_conv.fold_bn_eval(
               tree_map(jnp.asarray, p))))


def test_denoiser_training_matches_jax(trees):
    ja, pa = trees
    mel = np.abs(_wav((2, 9, 128), 5)) * 10
    want = _jit(jax_denoiser.apply, cfg=JCFG.denoiser, training=True)(
        tree_map(jnp.asarray, ja["denoiser"]), jnp.asarray(mel))
    got = denoiser.apply(pa["denoiser"], torch.tensor(mel), CFG.denoiser,
                         training=True)
    _close(got, want)
    assert not np.allclose(got.numpy(), denoiser.apply(
        pa["denoiser"], torch.tensor(mel), CFG.denoiser), atol=1e-3)


def test_resunet_training_matches_jax(trees):
    """Batch statistics in every BN; production precision changes nothing
    in training (no bfloat16 cast, as in the JAX package)."""
    ja, pa = trees
    x = _wav((2, 11, 128, 2), 6)
    want = _jit(jax_resunet.apply, cfg=JCFG.unet, training=True)(
        tree_map(jnp.asarray, ja["unet"]), jnp.asarray(x))
    got = resunet.apply(pa["unet"], torch.tensor(x), CFG.unet, training=True)
    _close(got, want)
    with precision("production"):
        prod = resunet.apply(pa["unet"], torch.tensor(x), CFG.unet,
                             training=True)
    assert prod.dtype == torch.float32 and torch.equal(prod, got)


def test_analysis_training_matches_jax(trees):
    """The whole stage in training. Batch statistics over the deep levels'
    few rows amplify float32 rounding: on this input the JAX package's
    float32 U-Net output lies 1.8e-5 from the port's float64 evaluation,
    the port's float32 one 5e-6. So the port is held to its own float64
    evaluation at 1e-5, and to the JAX package at 1e-5 of the outputs'
    largest magnitude (log10 mels up to ~8)."""
    ja, pa = trees
    mel = np.abs(_wav((2, 13, 128), 7)) * 10
    want = _jit(jax_analysis.apply, cfg=JCFG, training=True)(
        tree_map(jnp.asarray, ja), jnp.asarray(mel))
    got = analysis.apply(pa, torch.tensor(mel), CFG, training=True)
    f64 = analysis.apply(tree_map(lambda t: t.double(), pa),
                         torch.tensor(mel).double(), CFG, training=True)
    assert set(got) == set(want) == {"mel", "clean", "unet_out"}
    for k in got:
        _close(got[k], f64[k].float())
        w = np.asarray(want[k])
        _close(got[k], w, atol=TOL * float(np.abs(w).max()))


def test_wav_to_sp_mel_matches_jax():
    """The losses' mel: the plain STFT magnitude with its power floor, then
    the mel product; the spectrogram within 1e-4 relative (a 2048-tap
    float32 DFT summed in another order, as ``stft_mel``'s test), the mel
    within that."""
    wav = _wav((2, 5000), 8)
    sp_j, mel_j = jax_analysis.wav_to_sp_mel(jnp.asarray(wav), JCFG)
    sp, mel = analysis.wav_to_sp_mel(torch.tensor(wav), CFG)
    assert sp.shape == sp_j.shape and mel.shape == mel_j.shape
    _close(sp, sp_j, rtol=1e-4, atol=1e-5)
    _close(mel, mel_j, rtol=1e-4, atol=1e-4)
    # the inference path's kernel (its plain version here) gives the same
    _close(analysis.wav_to_mel(torch.tensor(wav), CFG), mel.detach(),
           rtol=1e-5, atol=1e-4)


# ------------------------------------------------------------------ dropout

def _dropout(x, rate, seed):
    return denoiser._dropout(x, rate, True,
                             torch.Generator().manual_seed(seed))


def test_dropout_deterministic_given_seed():
    x = torch.rand((4, 50, 64)) + 0.5
    assert torch.equal(_dropout(x, 0.5, 3), _dropout(x, 0.5, 3))
    assert not torch.equal(_dropout(x, 0.5, 3), _dropout(x, 0.5, 4))
    assert denoiser._dropout(x, 0.5, False, None) is x
    assert denoiser._dropout(x, 0.0, True, None) is x


@pytest.mark.parametrize("rate", [0.2, 0.5, 0.8])
def test_dropout_zeros_and_scale(rate):
    """Every element is 0 or x / (1 - rate), exactly; the kept share is
    within 4 sigma of 1 - rate."""
    x = torch.rand((8, 100, 128)) + 0.5
    y = _dropout(x, rate, 11)
    keep = 1.0 - rate
    kept = y != 0
    assert torch.equal(y[kept], x[kept] / keep)
    n = x.numel()
    share = float(kept.float().mean())
    assert abs(share - keep) <= 4 * (keep * rate / n) ** 0.5


def test_denoiser_training_default_generator(trees):
    """training=True without a generator takes one seeded 0, as the JAX
    package takes PRNGKey(0)."""
    _, pa = trees
    cfg = tiny_test_config()
    mel = torch.tensor(np.abs(_wav((1, 9, 128), 9)) * 10)
    a = denoiser.apply(pa["denoiser"], mel, cfg.denoiser, training=True)
    b = denoiser.apply(pa["denoiser"], mel, cfg.denoiser, training=True,
                       generator=torch.Generator().manual_seed(0))
    c = denoiser.apply(pa["denoiser"], mel, cfg.denoiser, training=True,
                       generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)


# --------------------------------------------------------- loss and grads

@pytest.fixture(scope="module")
def jax_loss_and_grads(trees):
    ja, _ = trees
    wn, wc = _wav((2, 4410), 12), _wav((2, 4410), 13)
    fn = jax.jit(jax.value_and_grad(functools.partial(
        jax_losses.analysis_loss, cfg=JCFG), has_aux=True))
    (total, metrics), grads = fn(tree_map(jnp.asarray, ja), jnp.asarray(wn),
                                 jnp.asarray(wc))
    return wn, wc, total, metrics, grads


def test_analysis_loss_and_grads_match_jax(trees, jax_loss_and_grads):
    """The loss, its two terms and the gradient of every leaf (zero for the
    running BN statistics, which training does not read)."""
    ja, _ = trees
    wn, wc, total, metrics, grads = jax_loss_and_grads
    state = st.init_train_state(ja, device="cpu")
    got_total, got = st.forward_backward(state, wn, wc, CFG)
    _close(got_total, total)
    for k in ("loss", "targ_loss", "mel_loss"):
        _close(got[k], metrics[k])
    want = tree_leaves(convert_tree(tree_map(np.asarray, grads), "analysis"))
    assert len(want) == len(state.leaves())
    for p, g in zip(state.leaves(), want):
        _close(p.grad, g, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    bn = state.params["unet"]["enc1"]["block1"]["bn1"]
    assert not bn["mean"].grad.any() and not bn["var"].grad.any()


def test_analysis_loss_weights(trees, jax_loss_and_grads):
    ja, pa = trees
    wn, wc, _, metrics, _ = jax_loss_and_grads
    total, m = losses.analysis_loss(pa, torch.tensor(wn), torch.tensor(wc),
                                    CFG, targ_weight=0.5, mel_weight=2.0)
    _close(total, 0.5 * metrics["targ_loss"] + 2.0 * metrics["mel_loss"])
    assert torch.equal(m["loss"], total)
    _close(losses.l1(torch.ones(3), torch.zeros(3)), 1.0)


# ---------------------------------------------------------------- optimizer

def _small_tree(rng):
    """Keys in sorted order: the JAX package's trees come back from its
    tree functions in that order, the port's keep theirs."""
    return {"b": {"x": rng.standard_normal(5).astype(np.float32)},
            "w": rng.standard_normal((3, 4)).astype(np.float32)}


def test_optimizer_matches_optax():
    """The same gradients through optax's ``reference_optimizer`` and the
    port's over 5 updates (warm-up 2, a factor 0.5 every 2): the lr-0
    first update, the warm-up and the decay; parameters within 1e-6."""
    rng = np.random.default_rng(14)
    kw = dict(lr=1e-2, warmup_steps=2, decay_every=2, gamma=0.5)
    p0 = _small_tree(rng)
    grads = [_small_tree(rng) for _ in range(5)]
    opt = jax_step.reference_optimizer(**kw)
    jp = tree_map(jnp.asarray, p0)
    js = opt.init(jp)
    spec = st.reference_optimizer(**kw)
    leaves = tree_leaves(tree_map(lambda v: torch.tensor(v).requires_grad_(),
                                p0))
    adam, sched = spec.build(leaves)
    lrs = []
    for g in grads:
        upd, js = opt.update(tree_map(jnp.asarray, g), js, jp)
        jp = jax.tree.map(lambda a, b: a + b, jp, upd)
        lrs.append(adam.param_groups[0]["lr"])
        for p, v in zip(leaves, tree_leaves(g)):
            p.grad = torch.tensor(v)
        adam.step()
        sched.step()
        for p, v in zip(leaves, tree_leaves(tree_map(np.asarray, jp))):
            _close(p, v, rtol=0, atol=1e-6)
        if len(lrs) == 1:
            _close(leaves[1], p0["w"], rtol=0, atol=0)  # lr 0: unchanged
    np.testing.assert_allclose(lrs, [0.0, 5e-3, 5e-3, 5e-3, 2.5e-3],
                               rtol=1e-12)


def test_train_state_carried_from_jax(trees):
    """JAX ``init_train_state`` and one step (lr 0 by the schedule, the
    moments move), carried into the port by ``from_jax_train_state``:
    Adam's count and moments and the schedule's step come over, so the
    next update fed the same gradients is JAX's within 1e-6; and the
    port's own next step reports JAX's second loss within 1e-5 and leaves
    JAX's parameters, within 1e-6 + 1e-4 |p|, wherever the gradient's size
    (Adam's bias-corrected second moment) is above the 1e-6 to which
    ``test_analysis_loss_and_grads_match_jax`` holds gradients. Below it
    (a bias ahead of a batch-statistics BN, zero in exact arithmetic; a
    few weights of tiny gradient) Adam scales what may be float32 noise to
    about lr in both packages, in unrelated directions: those elements,
    at most one in a thousand, must stay within 2 lr of JAX's."""
    ja, _ = trees
    spec = st.reference_optimizer(warmup_steps=1)
    opt = jax_step.reference_optimizer(warmup_steps=1)
    b1 = [_wav((2, 4410), 15), _wav((2, 4410), 16)]
    b2 = [_wav((2, 4410), 17), _wav((2, 4410), 18)]
    jstep = jax_step.make_train_step(JCFG, opt, donate=False)
    s0 = jax_step.init_train_state(tree_map(jnp.asarray, ja), opt)
    s1, _ = jstep(s0, *map(jnp.asarray, b1), jax.random.PRNGKey(0))
    s2, m2 = jstep(s1, *map(jnp.asarray, b2), jax.random.PRNGKey(0))
    leaves1 = jax.tree.leaves(s1.opt_state)

    def carried():
        return from_jax_train_state(tree_map(np.asarray, s1.params), leaves1,
                                    int(s1.step), spec, device="cpu")

    # the carry alone: the same gradients into both optimizers
    state = carried()
    assert state.step == 1 and state.scheduler.last_epoch == 1
    assert state.optimizer.param_groups[0]["lr"] == spec.lr
    rng = np.random.default_rng(19)
    g = jax.tree.map(lambda v: rng.standard_normal(np.shape(v)).astype(
        np.float32), tree_map(np.asarray, s1.params))
    upd, _ = opt.update(tree_map(jnp.asarray, g), s1.opt_state, s1.params)
    want = jax.tree.map(lambda a, b: a + b, s1.params, upd)
    for p, v in zip(state.leaves(), tree_leaves(convert_tree(g, "analysis"))):
        p.grad = v
    st.update(state)
    want_leaves = tree_leaves(convert_tree(tree_map(np.asarray, want),
                                         "analysis"))
    for p, v in zip(state.leaves(), want_leaves):
        _close(p, v, rtol=0, atol=1e-6)

    # the port's own second step
    state = carried()
    state, m = st.make_train_step(CFG, spec)(state, *b2)
    _close(m["loss"], m2["loss"])
    want_leaves = tree_leaves(convert_tree(tree_map(np.asarray, s2.params),
                                         "analysis"))
    nu = tree_leaves(convert_tree(tree_map(np.asarray, s2.opt_state[0].nu),
                                "analysis"))
    noise = total = 0
    for p, v, n in zip(state.leaves(), want_leaves, nu):
        err = (p.detach() - v).abs()
        # bias-corrected second moment after 2 updates: the gradient's size
        quiet = (n / (1 - spec.beta2 ** 2)).sqrt() <= GRAD_ATOL
        assert bool((err[~quiet] <= 1e-6 + 1e-4 * v.abs()[~quiet]).all())
        assert bool((err[quiet] <= 2 * spec.lr).all())
        noise += int(quiet.sum()) - int((n == 0).sum())
        total += n.numel()
    assert noise <= total // 1000


# --------------------------------------------------------------- checkpoint

def test_checkpoint_round_trip(trees, tmp_path):
    """Parameters, Adam's moments and counts, the schedule and the step
    come back; the next update of the reloaded state is the original's."""
    ja, _ = trees
    state = st.init_train_state(ja, st.reference_optimizer(warmup_steps=1),
                                device="cpu")
    step = st.make_train_step(CFG, state.spec)
    for seed in (20, 21):
        state, _ = step(state, _wav((1, 3000), seed), _wav((1, 3000), seed))
    path = str(tmp_path / "ck" / "state.npz")
    save_train_state(state, path)
    back = load_train_state(path, state.spec, device="cpu")
    assert back.step == state.step == 2
    assert back.scheduler.last_epoch == state.scheduler.last_epoch
    assert back.optimizer.param_groups[0]["lr"] == \
        state.optimizer.param_groups[0]["lr"]
    for p, q in zip(state.leaves(), back.leaves()):
        assert torch.equal(p.detach(), q.detach())
        a, b = state.optimizer.state[p], back.optimizer.state[q]
        assert float(a["step"]) == float(b["step"]) == 2
        assert torch.equal(a["exp_avg"], b["exp_avg"])
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
    batch = (_wav((1, 3000), 22), _wav((1, 3000), 23))
    state, _ = step(state, *batch)
    back, _ = step(back, *batch)
    for p, q in zip(state.leaves(), back.leaves()):
        assert torch.equal(p.detach(), q.detach())


@pytest.mark.parametrize("fault", ["count", "shape"])
def test_checkpoint_mismatch_raises(trees, tmp_path, fault):
    from voicefixer_tpu_torch.utils import weights as W
    ja, _ = trees
    state = st.init_train_state(ja, device="cpu")
    state, _ = st.make_train_step(CFG)(state, _wav((1, 3000), 24),
                                       _wav((1, 3000), 25))
    path = str(tmp_path / "s.npz")
    save_train_state(state, path)
    payload = W.load_pytree_npz(path)
    if fault == "count":
        payload["adam"]["exp_avg"].pop()
    else:
        payload["adam"]["exp_avg_sq"][3] = np.zeros((2, 2), np.float32)
    W.save_pytree_npz(payload, path)
    with pytest.raises(ValueError, match="optimizer state mismatch"):
        load_train_state(path, device="cpu")


# -------------------------------------------------------------------- data

@pytest.fixture
def wav_dirs(tmp_path):
    """clean/ and degraded/ with the same names, lengths around the chunk
    (one shorter than it), int16 at 44.1 kHz."""
    rng = np.random.default_rng(26)
    dirs = {k: tmp_path / k for k in ("clean", "degraded")}
    for d in dirs.values():
        d.mkdir()
    for i, n in enumerate((9000, 3000, 14000)):
        for d in dirs.values():
            wavfile.write(str(d / f"u{i}.wav"), 44100, (
                rng.standard_normal(n) * 3000).astype(np.int16))
    (dirs["clean"] / "notes.txt").write_text("x")
    return {k: str(v) for k, v in dirs.items()}


@pytest.mark.parametrize("paired", [True, False])
def test_paired_dataset_matches_jax(wav_dirs, paired):
    """The same seed gives the JAX package's crops: pair by pair, then
    batch by batch through the prefetch thread."""
    deg = wav_dirs["degraded"] if paired else None
    kw = dict(chunk_seconds=0.1, seed=3)
    ours = data.PairedDataset(wav_dirs["clean"], deg, **kw)
    theirs = jax_data.PairedDataset(wav_dirs["clean"], deg, **kw)
    assert ours.clean_files == theirs.clean_files and len(
        ours.clean_files) == 3
    for _ in range(6):
        for a, b in zip(ours.sample_pair(), theirs.sample_pair()):
            assert a.shape == (4410,) and a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    it_o, it_t = ours.batches(2), theirs.batches(2)
    for _ in range(3):
        for a, b in zip(next(it_o), next(it_t)):
            assert a.shape == (2, 4410)
            np.testing.assert_array_equal(a, b)
    it_o.close()
    it_t.close()


def test_paired_dataset_errors(wav_dirs, tmp_path):
    os.remove(os.path.join(wav_dirs["degraded"], "u1.wav"))
    with pytest.raises(ValueError, match="1 clean files missing degraded "
                       "pairs, e.g. u1.wav"):
        data.PairedDataset(wav_dirs["clean"], wav_dirs["degraded"])
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="no audio files"):
        data.PairedDataset(str(tmp_path / "empty"))


def test_random_chunk_matches_jax():
    wav = _wav(1000, 27)
    for n in (300, 1000, 1500):
        a = data.random_chunk(wav, n, np.random.default_rng(5))
        b = jax_data.random_chunk(wav, n, np.random.default_rng(5))
        np.testing.assert_array_equal(a, b)
        assert a.shape == (n,)


# ---------------------------------------------------------------- augment

def test_augment_shapes_and_ranges():
    gen = torch.Generator().manual_seed(28)
    u = augment.uniform(gen, -2.0, 3.0, (10000,))
    assert u.shape == (10000,) and float(u.min()) >= -2 and \
        float(u.max()) < 3 and abs(float(u.mean()) - 0.5) < 0.05
    wav = torch.tensor(_wav((4, 1000), 29))
    g = augment.random_gain(gen, wav)
    ratio = (g / wav)[:, 0]
    assert g.shape == wav.shape
    assert bool(((ratio >= 10 ** (-12 / 20)) & (ratio <= 10 ** (6 / 20))
                 ).all())
    assert torch.allclose(g / wav, ratio[:, None].expand_as(wav))
    noisy, clean = augment.add_noise_and_scale(
        gen, wav, torch.tensor(_wav((4, 1000), 30)))
    assert noisy.shape == clean.shape == wav.shape
    a = augment.add_noise_and_scale(torch.Generator().manual_seed(1), wav,
                                    wav.flip(-1))
    b = augment.add_noise_and_scale(torch.Generator().manual_seed(1), wav,
                                    wav.flip(-1))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_add_noise_and_scale_formula_matches_jax(monkeypatch):
    """On the same draws (each package's ``uniform`` replaced by fixed
    values: an SNR per utterance, then a gain in dB) the mix and the gain
    are the JAX package's, and the SNR is the one drawn."""
    snr, gain_db = np.array([[3.0], [20.0]], np.float32), \
        np.array([[-6.0], [2.0]], np.float32)
    clean, noise = _wav((2, 2000), 31), _wav((2, 2000), 32) * 3

    def fixed(draws):
        it = iter(draws)
        return lambda *a, **k: next(it)

    monkeypatch.setattr(jax_augment, "uniform",
                        fixed([jnp.asarray(snr), jnp.asarray(gain_db)]))
    monkeypatch.setattr(augment, "uniform",
                        fixed([torch.tensor(snr), torch.tensor(gain_db)]))
    want = jax_augment.add_noise_and_scale(jax.random.PRNGKey(0),
                                           jnp.asarray(clean),
                                           jnp.asarray(noise))
    got = augment.add_noise_and_scale(None, torch.tensor(clean),
                                      torch.tensor(noise))
    for g, w in zip(got, want):
        _close(g, w)
    noisy, cl = (t.numpy() for t in got)
    measured = 10 * np.log10((cl ** 2).sum(-1) / ((noisy - cl) ** 2).sum(-1))
    np.testing.assert_allclose(measured, snr[:, 0], atol=1e-3)
    np.testing.assert_allclose(cl / clean, np.broadcast_to(
        10 ** (gain_db / 20), clean.shape), rtol=1e-5)


# ------------------------------------------------------------ utils.params

def test_count_parameters_full_width_matches_jax():
    """At DEFAULT_CONFIG (the port's tree on the meta device, the JAX
    package's from eval_shape; nothing is drawn): every subtree's count is
    the JAX package's, and the ResUNet's and denoiser's are upstream's
    plus their BN running statistics."""
    port = analysis.init(DEFAULT_CONFIG, torch.Generator(), "meta")
    ja, jv = jax_shapes(JAX_DEFAULT)
    assert params_util.count_parameters(port) == \
        jax_params_util.count_parameters(ja)
    for depth in (1, 2, 3):
        assert params_util.parameter_summary(port, depth) == \
            jax_params_util.parameter_summary(ja, depth)
    from voicefixer_tpu_torch.models import vocoder
    pv = vocoder.init(DEFAULT_CONFIG.vocoder, torch.Generator(), "meta")
    assert params_util.count_parameters(pv) == \
        jax_params_util.count_parameters(jv)
    assert params_util.parameter_summary(pv, 2) == \
        jax_params_util.parameter_summary(jv, 2)


def test_count_flops():
    x, w = torch.randn(4, 8), torch.randn(8, 3)
    assert params_util.count_flops(lambda a, b: a @ b, x, w) == 2 * 4 * 8 * 3
    assert params_util.count_flops(lambda a: a + 1, x) is None


# ------------------------------------------------------------ the trainer

def test_train_steps_move_the_parameters(trees):
    """Three steps with dropout: finite losses, the first update at lr 0
    leaves every parameter, the second moves them; a seeded generator
    makes the run repeat exactly."""
    ja, _ = trees
    cfg = tiny_test_config()
    spec = st.reference_optimizer(warmup_steps=1)
    runs = []
    for _ in range(2):
        state = st.init_train_state(ja, spec, device="cpu")
        step = st.make_train_step(cfg, spec)
        gen = torch.Generator().manual_seed(0)
        p0 = [p.detach().clone() for p in state.leaves()]
        losses_ = []
        for i, seed in enumerate((33, 34, 35)):
            state, m = step(state, _wav((2, 3000), seed),
                            _wav((2, 3000), seed + 10), gen)
            losses_.append(float(m["loss"]))
            same = all(torch.equal(p, q) for p, q in zip(state.leaves(), p0))
            assert same == (i == 0)
        assert state.step == 3 and np.isfinite(losses_).all()
        runs.append((losses_, [p.detach().clone() for p in state.leaves()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_trainer_refusals(trees, monkeypatch):
    ja, _ = trees
    with pytest.raises(TypeError, match="DeviceMesh"):
        st.make_train_step(CFG, mesh=object())
    state = st.init_train_state(ja, device="cpu")
    step = st.make_train_step(CFG, st.reference_optimizer(lr=1e-3))
    with pytest.raises(ValueError, match="optimizer"):
        step(state, _wav((1, 3000), 36), _wav((1, 3000), 37))
    folded = conv.fold_bn_eval(convert_tree(ja, "analysis"))
    with pytest.raises(ValueError, match="/denoiser/bn0/scale: a folded"):
        st.init_train_state(folded, device="cpu")
    packed = {"denoiser": folded["denoiser"], "unet": resunet.
              pack_conv_blocks(folded["unet"])}
    with pytest.raises(ValueError, match="a folded or packed leaf"):
        st.init_train_state(packed, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        st.init_train_state(ja)
