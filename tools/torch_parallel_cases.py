"""Multi-process cases of the port's ``parallel/`` package on gloo, one CPU
process a rank, for ``tests/test_torch_parallel.py``.

    python -m tools.torch_parallel_cases CASE --rank K --world N \\
        --init file:///tmp/x/rdzv --dir /tmp/x [--arg V ...]

Each rank reads its inputs from DIR (npz files the test wrote), joins the
group through ``parallel.distributed.initialize(device="cpu")``, runs CASE
and writes ``DIR/out_K.npz``. ``run_ranks`` starts the N processes, waits
for them under one timeout and kills them all when it passes. Imports torch
and the port only, never jax.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(case: str, world: int, workdir: str, timeout: float = 60.0,
              args: tuple = ()) -> list:
    """Run ``case`` in ``world`` processes, rendezvous by a file in
    ``workdir``; returns each rank's outputs (dicts of arrays). A rank that
    fails, or a run that outlasts ``timeout`` seconds, raises
    AssertionError with the ranks' error output; no process is left
    running."""
    init = "file://" + os.path.join(workdir, f"rdzv-{case}-{time.time_ns()}")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tools.torch_parallel_cases", case,
         "--rank", str(r), "--world", str(world), "--init", init,
         "--dir", workdir] + [str(a) for a in args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    errs = []
    try:
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(
                    timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{case}: rank {r} still running after "
                                     f"{timeout} s") from None
            if p.returncode:
                errs.append(f"rank {r} exit {p.returncode}:\n{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if errs:
        raise AssertionError(f"{case}: " + "\n".join(errs))
    out = []
    for r in range(world):
        with np.load(os.path.join(workdir, f"out_{r}.npz")) as z:
            out.append(dict(z))
    return out


def _cfg(name: str, dropout0: bool = False):
    from voicefixer_tpu_torch import config as C
    cfg = C.small_tp_config() if name == "small_tp" else C.tiny_test_config()
    if dropout0:
        cfg = dataclasses.replace(cfg, denoiser=dataclasses.replace(
            cfg.denoiser, dropout=0.0))
    return cfg


def _vf(d: str, cfg_name: str, mesh=None):
    from voicefixer_tpu_torch.pipeline.restore import VoiceFixer
    return VoiceFixer(ckpt=os.path.join(d, "ana.npz"),
                      vocoder_ckpt=os.path.join(d, "voc.npz"),
                      config=_cfg(cfg_name), device="cpu", mesh=mesh)


def case_restore_wavs(d: str, argv: list) -> dict:
    """restore_wavs on an (n_data, n_model) mesh, modes 0 and 1; without a
    model axis also restore_inmem of each file on the same VoiceFixer, with
    one the VoiceFixer is built on the mesh (tensor parallel) at
    small_tp_config."""
    from voicefixer_tpu_torch.parallel.inference import restore_wavs
    from voicefixer_tpu_torch.parallel.mesh import make_mesh
    n_data, n_model = int(argv[0]), int(argv[1])
    mesh = make_mesh(n_data, n_model)
    vf = (_vf(d, "small_tp", mesh) if n_model > 1 else _vf(d, "tiny"))
    with np.load(os.path.join(d, "wavs.npz")) as z:
        wavs = [z[f"w{i}"] for i in range(len(z.files))]
    out = {}
    for mode in (0, 1):
        for i, w in enumerate(restore_wavs(vf, wavs, mode, mesh)):
            out[f"m{mode}_{i}"] = w
            if n_model == 1:
                out[f"ref{mode}_{i}"] = vf.restore_inmem(wavs[i], mode=mode)
    return out


def case_sp(d: str, argv: list) -> dict:
    """synthesize_sp over a (1, world) mesh, and exchange_halo of four-row
    shards of a ramp at several halo widths."""
    import torch
    from voicefixer_tpu_torch.parallel import distributed
    from voicefixer_tpu_torch.parallel.mesh import make_mesh
    from voicefixer_tpu_torch.parallel.sp import exchange_halo, synthesize_sp
    from voicefixer_tpu_torch.utils.weights import convert_tree
    from voicefixer_tpu_torch.utils.weights import load_pytree_npz
    depth = int(argv[0])
    mesh = make_mesh(1, distributed.process_count())
    cfg = dataclasses.replace(_cfg("tiny").vocoder, channels=32,
                              cond_channels=16, resstack_depth=(depth,) * 4)
    pv = convert_tree(load_pytree_npz(os.path.join(d, "voc.npz")), "vocoder")
    with np.load(os.path.join(d, "mel.npz")) as z:
        mel = torch.from_numpy(z["mel"])
    out = {"wav": synthesize_sp(pv, mel, cfg, mesh=mesh).numpy()}
    rank = mesh.get_local_rank("model")
    x = torch.arange(mesh.size(1) * 8 * 4, dtype=torch.float32).reshape(
        1, -1, 4)[:, rank * 8: rank * 8 + 8]
    for h in (1, 3, 8, 12, 17):
        out[f"halo{h}"] = exchange_halo(x, h, mesh).numpy()
    return out


def case_tp_restore(d: str, argv: list) -> dict:
    """restore_batch of two chunks on a (1, world) mesh at small_tp_config;
    the shapes of a sharded analysis leaf and of the vocoder's widest."""
    from voicefixer_tpu_torch.parallel import distributed
    from voicefixer_tpu_torch.parallel.mesh import make_mesh
    vf = _vf(d, "small_tp", make_mesh(1, distributed.process_count()))
    with np.load(os.path.join(d, "wav.npz")) as z:
        outs, peaks = vf._restore_batch(z["wav"])
    return {"outs": outs, "peaks": peaks,
            "conv_shape": np.array(
                vf.params["unet"]["enc2"]["block1"]["conv1"]["w"].shape),
            "voc_shape": np.array(vf.vocoder_params["pre"]["w"].shape)}


def case_train(d: str, argv: list) -> dict:
    """Three steps of make_train_step on an (n_data, n_model) mesh at
    dropout 0, warm-up 1: the losses, and the averaged gradients and the
    parameters after step 1, sharded leaves gathered whole."""
    import torch
    from voicefixer_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from voicefixer_tpu_torch.parallel.sharding import (gather_params,
                                                        param_specs)
    from voicefixer_tpu_torch.train import step as st
    from voicefixer_tpu_torch.utils.weights import (convert_tree,
                                                    load_pytree_npz,
                                                    tree_leaves, tree_map)
    cfg_name, n_data, n_model = argv[0], int(argv[1]), int(argv[2])
    cfg = _cfg(cfg_name, dropout0=True)
    mesh = make_mesh(n_data, n_model)
    params = convert_tree(load_pytree_npz(os.path.join(d, "ana.npz")),
                          "analysis")
    specs = param_specs(params, n_model)
    spec = st.reference_optimizer(warmup_steps=1)
    state = st.place_train_state(st.init_train_state(params, spec, "cpu"),
                                 mesh)
    step = st.make_train_step(cfg, spec, mesh=mesh)
    with np.load(os.path.join(d, "batch.npz")) as z:
        wn, wc = (shard_batch(mesh, torch.from_numpy(z[k]))
                  for k in ("noisy", "clean"))
    out = {}
    for i in range(3):
        state, m = step(state, wn, wc)
        out[f"loss{i}"] = np.array(float(m["loss"]))
        if i == 0:
            for key, fn in (("grad", lambda p: p.grad.detach().clone()),
                            ("param", lambda p: p.detach().clone())):
                whole = gather_params(tree_map(fn, state.params), specs,
                                      mesh)
                out.update({f"{key}{j}": g.numpy()
                            for j, g in enumerate(tree_leaves(whole))})
    out["local_shapes"] = np.array([np.prod(p.shape) for p in
                                    state.leaves()])
    # a state carried over with its Adam moments: one unsharded update on
    # this rank alone, then placed; its moments gathered back are the
    # unsharded state's
    full = st.init_train_state(params, spec, "cpu")
    st.forward_backward(full, wn, wc, cfg)
    st.update(full)
    placed = st.place_train_state(full, mesh)
    err = 0.0
    for key in ("exp_avg", "exp_avg_sq"):
        got = gather_params(tree_map(lambda p: placed.optimizer.state[p][key],
                                     placed.params), specs, mesh)
        want = tree_map(lambda p: full.optimizer.state[p][key], full.params)
        err = max([err] + [float((a - b).abs().max()) for a, b in
                           zip(tree_leaves(got), tree_leaves(want))])
    out["carried_err"] = np.array(err)
    out["carried_step"] = np.array(placed.step)
    return out


def case_bn_global(d: str, argv: list) -> dict:
    """Training-mode batch_norm (channel and scalar) on this rank's rows of
    one batch, inside and outside global_batch_stats, and the gradient of
    a weighted sum through it."""
    import torch
    from voicefixer_tpu_torch.models.denoiser import _bn_scalar
    from voicefixer_tpu_torch.ops.conv import batch_norm
    from voicefixer_tpu_torch.parallel import tp
    from voicefixer_tpu_torch.parallel.mesh import make_mesh, shard_batch
    mesh = make_mesh()
    with np.load(os.path.join(d, "bn.npz")) as z:
        x, wts, gamma, beta = (torch.from_numpy(z[k]) for k in
                               ("x", "w", "gamma", "beta"))
    p = {"gamma": gamma, "beta": beta}
    ps = {"gamma": gamma[:1], "beta": beta[:1]}
    out = {}
    for name, fn in (("ch", lambda v: batch_norm(v, p, training=True)),
                     ("sc", lambda v: _bn_scalar(v, ps, True))):
        xl = shard_batch(mesh, x).clone().requires_grad_()
        with tp.global_batch_stats(mesh):
            y = fn(xl)
        (y * shard_batch(mesh, wts)).sum().backward()
        out[f"{name}_y"] = y.detach().numpy()
        out[f"{name}_grad"] = xl.grad.numpy()
        out[f"{name}_local"] = fn(xl.detach()).numpy()
    return out


CASES = {"restore_wavs": case_restore_wavs, "sp": case_sp,
         "tp_restore": case_tp_restore, "train": case_train,
         "bn_global": case_bn_global}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("case", choices=sorted(CASES))
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--dir", required=True)
    ap.add_argument("rest", nargs="*")
    a = ap.parse_args()
    import torch
    torch.set_num_threads(1)
    from voicefixer_tpu_torch.parallel import distributed
    distributed.initialize(a.init, a.world, a.rank, device="cpu",
                           timeout_s=60)
    try:
        out = CASES[a.case](a.dir, a.rest)
        np.savez(os.path.join(a.dir, f"out_{a.rank}.npz"), **out)
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
