"""The port's ``parallel/`` across processes, on gloo, against the JAX
package's parallel functions on the same numpy-seeded parameters and inputs.

The JAX side runs here, on the 8 virtual CPU devices of tests/conftest.py.
The port runs in 2 or 4 spawned processes (``tools/torch_parallel_cases``),
one torch thread each, that meet by a rendezvous file in ``tmp_path`` (no
port for xdist workers to race for); each test waits for them under its own
timeout, so a hang fails in seconds.

Tolerances, the JAX tests' own: restore_wavs 1e-5 absolute
(tests/test_parallel_inference.py:31), the vocoder 2e-5 (tests/test_sp.py),
tensor-parallel restore rtol 1e-5 and atol 2e-5 (test_parallel_inference.py
:76), the trainer's loss rtol 2e-5 and fc1's weights 2e-5 absolute
(tests/test_parallel_train.py:106-113). Gradients against the port's own
unsharded step: rtol 1e-4, atol 1e-6, the port's gradient tolerance
against jax.grad (tests/test_torch_train.py:53).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicefixer_tpu.config import small_tp_config as jax_small_tp
from voicefixer_tpu.config import tiny_test_config as jax_tiny
from voicefixer_tpu.parallel import sharding as jax_sharding
from voicefixer_tpu.parallel.inference import restore_wavs as jax_restore_wavs
from voicefixer_tpu.parallel.mesh import make_mesh as jax_make_mesh
from voicefixer_tpu.parallel.mesh import shard_batch as jax_shard_batch
from voicefixer_tpu.parallel.sp import synthesize_sp as jax_synthesize_sp
from voicefixer_tpu.pipeline.restore import VoiceFixer as JaxVoiceFixer
from voicefixer_tpu.train import step as jax_step
from voicefixer_tpu.utils import weights as JW

from voicefixer_tpu_torch.config import small_tp_config, tiny_test_config
from voicefixer_tpu_torch.ops.conv import batch_norm
from voicefixer_tpu_torch.models.denoiser import _bn_scalar
from voicefixer_tpu_torch.parallel.inference import restore_wavs
from voicefixer_tpu_torch.parallel.sharding import param_specs
from voicefixer_tpu_torch.parallel.sp import synthesize_sp
from voicefixer_tpu_torch.pipeline.restore import VoiceFixer
from voicefixer_tpu_torch.train import step as st
from voicefixer_tpu_torch.utils.weights import (convert_tree,
                                                from_jax_params, tree_leaves)
from tools.torch_parallel_cases import run_ranks
from tests.test_torch_weights import (jax_param_trees,  # noqa: F401
                                      one_torch_thread)

SEG = 44100  # tiny_test_config's one-second segment


def _save_params(d, ja, jv):
    JW.save_pytree_npz(ja, str(d / "ana.npz"))
    JW.save_pytree_npz(jv, str(d / "voc.npz"))


def _jax_spec_axis(spec):
    return None if spec == jax.sharding.PartitionSpec() else \
        list(spec).index("model")


def test_param_specs_match_jax():
    """The same policy leaf for leaf: small_tp_config over 2 model ranks
    (and 1, where nothing is sharded)."""
    ja, _ = jax_param_trees(0, jax_small_tp())
    pa = convert_tree(ja, "analysis")
    for n in (1, 2):
        want = jax.tree.leaves(jax.tree.map(
            _jax_spec_axis, jax_sharding.param_specs(ja, n),
            is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)),
            is_leaf=lambda s: s is None)
        got = tree_leaves(param_specs(pa, n))
        assert got == want
        assert any(a is not None for a in got) == (n == 2)


@pytest.fixture(scope="module")
def tiny_trees():
    return jax_param_trees(61)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_restore_wavs_across_processes_match_jax(tiny_trees, tmp_path,
                                                 shape):
    """restore_wavs on a (2, 1) mesh, modes 0 and 1, over three files of
    mixed lengths (five chunks, padded to six rows): every rank returns
    every file, equal to the JAX package's restore_wavs and to the port's
    own restore_inmem of each file. On (2, 2), 4 processes, at
    small_tp_config: each data rank's rows restored tensor-parallel over
    its model group, against the JAX package's restore_wavs with a
    VoiceFixer on a (2, 2) mesh."""
    n_data, n_model = shape
    ja, jv = (tiny_trees if n_model == 1
              else jax_param_trees(62, jax_small_tp()))
    cfg = jax_tiny() if n_model == 1 else jax_small_tp()
    _save_params(tmp_path, ja, jv)
    rng = np.random.default_rng(0)
    wavs = [rng.standard_normal(SEG + 4410).astype(np.float32) * 0.1,
            rng.standard_normal(11025).astype(np.float32) * 0.1,
            rng.standard_normal(2 * SEG).astype(np.float32) * 0.1]
    np.savez(tmp_path / "wavs.npz", **{f"w{i}": w for i, w in
                                       enumerate(wavs)})
    outs = run_ranks("restore_wavs", n_data * n_model, str(tmp_path),
                     timeout=120, args=shape)
    jmesh = jax_make_mesh(n_data=n_data, n_model=n_model,
                          devices=jax.devices()[:n_data * n_model])
    jvf = JaxVoiceFixer(params=ja, vocoder_params=jv, config=cfg,
                        mesh=jmesh if n_model > 1 else None)
    for mode in (0, 1):
        ref = jax_restore_wavs(jvf, wavs, mode=mode, mesh=jmesh)
        for i, r in enumerate(ref):
            for out in outs:
                got = out[f"m{mode}_{i}"]
                assert got.shape == np.asarray(r).shape
                np.testing.assert_allclose(got, r, atol=1e-5)
                if n_model == 1:
                    np.testing.assert_allclose(got, out[f"ref{mode}_{i}"],
                                               atol=1e-5)


def test_restore_wavs_rejects_mode2(tiny_trees):
    pa, pv = from_jax_params(*tiny_trees)
    vf = VoiceFixer(pa, pv, tiny_test_config(), device="cpu")
    with pytest.raises(ValueError, match="modes 0/1"):
        restore_wavs(vf, [np.zeros(100, np.float32)], mode=2)


def _small_vocoder(depth):
    kw = dict(channels=32, cond_channels=16, resstack_depth=(depth,) * 4)
    return (dataclasses.replace(tiny_test_config().vocoder, **kw),
            dataclasses.replace(jax_tiny().vocoder, **kw))


@pytest.mark.parametrize("n,depth,t_mel", [(2, 4, 41), (4, 4, 50),
                                           (4, 6, 16)])
def test_synthesize_sp_across_processes(n, depth, t_mel, tmp_path):
    """synthesize_sp on a (1, n) mesh against the JAX package's on a (1, n)
    mesh and the port's one-process form on ("cpu",) * n. Depth 6 at 16
    frames over 4 ranks reaches 370 rows against stage-0 shards of 28: the
    halo crosses several ranks. Also exchange_halo of 8-row shards at h up
    to 17, zeros at the two ends."""
    cfg, jcfg = _small_vocoder(depth)
    _, jv = jax_param_trees(40 + depth, dataclasses.replace(jax_tiny(),
                                                            vocoder=jcfg))
    JW.save_pytree_npz(jv, str(tmp_path / "voc.npz"))
    mel = np.abs(np.random.default_rng(t_mel).standard_normal(
        (1, t_mel, cfg.in_channels))).astype(np.float32)
    np.savez(tmp_path / "mel.npz", mel=mel)
    outs = run_ranks("sp", n, str(tmp_path), timeout=90, args=(depth,))
    jmesh = jax_make_mesh(n_data=1, n_model=n, devices=jax.devices()[:n])
    ref_jax = np.asarray(jax.jit(functools.partial(
        jax_synthesize_sp, cfg=jcfg, mesh=jmesh))(jv, jnp.asarray(mel)))
    pv = convert_tree(jv, "vocoder")
    ref = synthesize_sp(pv, torch.from_numpy(mel), cfg, ("cpu",) * n).numpy()
    ramp = torch.arange(n * 8 * 4, dtype=torch.float32).reshape(1, -1, 4)
    for r, out in enumerate(outs):
        assert out["wav"].shape == ref.shape == ref_jax.shape
        np.testing.assert_allclose(out["wav"], ref_jax, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(out["wav"], ref, rtol=2e-5, atol=2e-5)
        for h in (1, 3, 8, 12, 17):
            want = torch.nn.functional.pad(ramp, (0, 0, h, h))[
                :, r * 8: r * 8 + 8 + 2 * h].numpy()
            np.testing.assert_array_equal(out[f"halo{h}"], want)


def test_tp_restore_two_processes_match_jax(tmp_path):
    """restore_batch on a (1, 2) mesh at small_tp_config: the ResUNet
    channel-sharded (an enc2 weight holds 32 of its 64 output channels on
    each rank), the vocoder whole and time-sharded; against the JAX
    package's tensor-parallel _jit_batch on a (1, 2) mesh."""
    ja, jv = jax_param_trees(3, jax_small_tp())
    _save_params(tmp_path, ja, jv)
    wav = (np.random.default_rng(0).standard_normal((2, 4410))
           * 0.1).astype(np.float32)
    np.savez(tmp_path / "wav.npz", wav=wav)
    outs = run_ranks("tp_restore", 2, str(tmp_path), timeout=90)
    jmesh = jax_make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    jvf = JaxVoiceFixer(params=ja, vocoder_params=jv, config=jax_small_tp(),
                        mesh=jmesh)
    ref, ref_peaks = jvf._jit_batch(jvf.params, jvf.vocoder_params,
                                    jax_shard_batch(jmesh, jnp.asarray(wav)),
                                    training=False, rng=None)
    full = ja["unet"]["enc2"]["block1"]["conv1"]["w"].shape
    for out in outs:
        assert tuple(out["conv_shape"]) == full[:-1] + (full[-1] // 2,)
        assert tuple(out["voc_shape"]) == jv["pre"]["w"].shape
        np.testing.assert_allclose(out["outs"], np.asarray(ref), rtol=1e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(out["peaks"], np.asarray(ref_peaks),
                                   rtol=1e-5, atol=2e-5)


def _dropout0(cfg):
    return dataclasses.replace(cfg, denoiser=dataclasses.replace(
        cfg.denoiser, dropout=0.0))


@pytest.mark.parametrize("cfg_name,port_mesh,jax_mesh", [
    ("tiny", (2, 1), (8, 1)), ("small_tp", (1, 2), (4, 2))])
def test_train_step_across_processes_matches_jax(cfg_name, port_mesh,
                                                 jax_mesh, tmp_path):
    """Three steps (warm-up 1: the first update has lr 0, the second moves
    the parameters, the third step's loss sees it) on one batch of 8 pairs,
    dropout 0. The port on 2 processes, the JAX package on 8 devices: the
    three losses, and denoiser/fc1/w after the first update, as
    tests/test_parallel_train.py holds it. The step-1 gradients, averaged
    over the data group and gathered whole from the model group, against
    the port's unsharded step on the whole batch; on (1, 2) the ResUNet's
    wide convolutions are sharded. A state carried over after one update
    keeps its Adam moments through place_train_state. (After the second
    update Adam's
    normalized step is +-lr wherever a gradient is near 0, so a rounding of
    such a gradient moves a weight by 2 lr: the third loss holds that
    update instead.)"""
    jcfg = _dropout0(jax_small_tp() if cfg_name == "small_tp"
                     else jax_tiny())
    cfg = _dropout0(small_tp_config() if cfg_name == "small_tp"
                    else tiny_test_config())
    ja, _ = jax_param_trees(7, jcfg)
    JW.save_pytree_npz(ja, str(tmp_path / "ana.npz"))
    rng = np.random.default_rng(2)
    clean = (rng.standard_normal((8, 4410)) * 0.1).astype(np.float32)
    noisy = (clean + rng.standard_normal((8, 4410)) * 0.05).astype(
        np.float32)
    np.savez(tmp_path / "batch.npz", noisy=noisy, clean=clean)
    outs = run_ranks("train", 2, str(tmp_path), timeout=120,
                     args=(cfg_name,) + port_mesh)

    jmesh = jax_make_mesh(*jax_mesh)
    jopt = jax_step.reference_optimizer(warmup_steps=1)
    jstate = jax_step.place_train_state(
        jax_step.init_train_state(jax.tree.map(jnp.asarray, ja), jopt),
        jmesh)
    jfn = jax_step.make_train_step(jcfg, jopt, mesh=jmesh, donate=False)
    wn, wc = jax_shard_batch(jmesh, (jnp.asarray(noisy), jnp.asarray(clean)))
    jloss = []
    for i in range(3):
        jstate, m = jfn(jstate, wn, wc, jax.random.PRNGKey(0))
        jloss.append(float(m["loss"]))
        if i == 0:
            jfc1 = np.asarray(jstate.params["denoiser"]["fc1"]["w"])

    spec = st.reference_optimizer(warmup_steps=1)
    ref = st.init_train_state(convert_tree(ja, "analysis"), spec, "cpu")
    st.forward_backward(ref, noisy, clean, cfg)
    grads = [p.grad for p in ref.leaves()]
    fc1 = [i for i, p in enumerate(ref.leaves())
           if p is ref.params["denoiser"]["fc1"]["w"]][0]
    for out in outs:
        for i in range(3):
            np.testing.assert_allclose(out[f"loss{i}"], jloss[i], rtol=2e-5)
        np.testing.assert_allclose(out[f"param{fc1}"], jfc1, atol=2e-5)
        for j, g in enumerate(grads):
            np.testing.assert_allclose(out[f"grad{j}"], g.numpy(),
                                       rtol=1e-4, atol=1e-6)
    if port_mesh[1] > 1:
        whole = [int(p.numel()) for p in ref.leaves()]
        assert sum(outs[0]["local_shapes"]) < sum(whole)
    for out in outs:  # place_train_state carries Adam's moments, sliced
        assert out["carried_err"] == 0 and out["carried_step"] == 1


def test_bn_statistics_span_the_data_axis(tmp_path):
    """A batch whose second half is scaled and shifted, so that each rank's
    own rows have statistics far from the batch's: inside
    global_batch_stats each rank normalizes its rows as batch_norm on the
    whole batch does (channel and scalar BN), with the gradient of the
    whole batch's loss; outside, it does not."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 6, 5, 3)).astype(np.float32)
    x[2:] = x[2:] * 5 + 3
    w = rng.standard_normal(x.shape).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(3)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(3)).astype(np.float32)
    np.savez(tmp_path / "bn.npz", x=x, w=w, gamma=gamma, beta=beta)
    outs = run_ranks("bn_global", 2, str(tmp_path), timeout=60)
    p = {"gamma": torch.from_numpy(gamma), "beta": torch.from_numpy(beta)}
    ps = {"gamma": p["gamma"][:1], "beta": p["beta"][:1]}
    for name, fn in (("ch", lambda v: batch_norm(v, p, training=True)),
                     ("sc", lambda v: _bn_scalar(v, ps, True))):
        xt = torch.from_numpy(x).requires_grad_()
        y = fn(xt)
        (y * torch.from_numpy(w)).sum().backward()
        for r, out in enumerate(outs):
            rows = slice(2 * r, 2 * r + 2)
            np.testing.assert_allclose(out[f"{name}_y"],
                                       y.detach().numpy()[rows],
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(out[f"{name}_grad"],
                                       xt.grad.numpy()[rows],
                                       rtol=1e-4, atol=1e-5)
            assert np.abs(out[f"{name}_local"]
                          - y.detach().numpy()[rows]).max() > 0.1
