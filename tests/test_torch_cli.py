"""The port's command line (``python -m voicefixer_tpu_torch``) against the
JAX package's: the same files restored by both CLIs from one pair of npz
params at ``tiny_test_config`` (the port with ``--disable-cuda``), its
argument errors, a folder run (batched and file by file), the
multi-process runs on gloo and ``--weight_prepare``."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from voicefixer_tpu import __main__ as jax_cli
from voicefixer_tpu.utils import weights as JW

from voicefixer_tpu_torch import __main__ as cli
from voicefixer_tpu_torch.pipeline import checkpoints as C
from voicefixer_tpu_torch.utils import audio_io
from tests.test_torch_weights import (jax_param_trees,  # noqa: F401
                                      one_torch_thread)


def _make_wav(path, n=66150, seed=0):
    """1.5 tiny segments of int16 noise at 44.1 kHz."""
    x = np.random.default_rng(seed).standard_normal(n) * 0.1
    wavfile.write(str(path), 44100, (x * 32767).astype(np.int16))
    return str(path)


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    d = tmp_path_factory.mktemp("params")
    ja, jv = jax_param_trees(21)
    a, v = str(d / "ana.npz"), str(d / "voc.npz")
    JW.save_pytree_npz(ja, a)
    JW.save_pytree_npz(jv, v)
    return ["--ckpt", a, "--vocoder-ckpt", v, "--config-preset", "tiny",
            "--silent"]


def _int16(path):
    sr, data = audio_io.read_audio(path)
    assert sr == 44100
    return np.round(data[:, 0] * 32768).astype(np.int32)


@pytest.mark.parametrize("extra,ext", [([], "wav"), (["--mode", "1"], "wav"),
                                       (["--chunk-overlap", "0.25"], "flac")])
def test_real_cli_end_to_end_matches_jax(npz, tmp_path, extra, ext):
    """No fakes: both CLIs load the npz params, read the WAV, restore (mode
    0, mode 1, overlap-add) and write int16 WAV or FLAC; the files agree
    within one LSB."""
    inp = _make_wav(tmp_path / "in.wav")
    ours, theirs = str(tmp_path / f"port.{ext}"), str(tmp_path / f"jax.{ext}")
    assert cli.main(["-i", inp, "-o", ours, "--disable-cuda"] + npz
                    + extra) == 0
    assert jax_cli.main(["-i", inp, "-o", theirs] + npz + extra) == 0
    a, b = _int16(ours), _int16(theirs)
    assert a.shape == b.shape
    assert a.shape[0] == (66150 if "1" not in extra else
                          512 * (44100 // 512) + 512 * (22050 // 512))
    assert np.any(a != 0) and np.abs(a - b).max() <= 1


def test_cli_mode2_and_all(npz, tmp_path):
    """``--mode all`` writes <base>-mode{0,1,2}<ext>: modes 0 and 1 agree
    with the JAX CLI's files within one LSB; mode 2 (dropout drawn from
    ``--seed`` by torch, so not the JAX package's stream) is the port's
    ``restore_inmem(mode=2, seed=...)`` of the file, and ``--mode 2`` alone
    writes the same file."""
    from voicefixer_tpu_torch.config import tiny_test_config
    from voicefixer_tpu_torch.pipeline.restore import VoiceFixer
    inp = _make_wav(tmp_path / "in.wav")
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    assert cli.main(["-i", inp, "-o", str(ours / "o.wav"), "--disable-cuda",
                     "--mode", "all", "--seed", "4"] + npz) == 0
    assert jax_cli.main(["-i", inp, "-o", str(theirs / "o.wav"), "--mode",
                         "all"] + npz) == 0
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs)) == [
        "o-mode0.wav", "o-mode1.wav", "o-mode2.wav"]
    for m in (0, 1):
        a, b = (_int16(str(d / f"o-mode{m}.wav")) for d in (ours, theirs))
        assert a.shape == b.shape and np.abs(a - b).max() <= 1
    vf = VoiceFixer(ckpt=npz[1], vocoder_ckpt=npz[3],
                    config=tiny_test_config(), device="cpu")
    want = vf.restore_inmem(audio_io.load_wav(inp, 44100), mode=2, seed=4)
    got = _int16(str(ours / "o-mode2.wav"))
    assert got.shape == want.shape
    np.testing.assert_array_equal(
        got, (want * 2 ** 15).astype(np.int16).astype(np.int32))
    single = str(tmp_path / "m2.wav")
    assert cli.main(["-i", inp, "-o", single, "--disable-cuda", "--mode",
                     "2", "--seed", "4"] + npz) == 0
    assert open(single, "rb").read() == open(ours / "o-mode2.wav",
                                             "rb").read()


class FakeVoiceFixer:
    def __init__(self, **kwargs):
        self.kwargs = kwargs

    def restore(self, input, output, mode=0, seed=0, **kw):
        audio_io.save_wave(audio_io.load_wav(input, 44100), output, 44100)


@pytest.fixture
def fake_vf(monkeypatch):
    import voicefixer_tpu_torch.pipeline.restore as restore_mod
    monkeypatch.setattr(restore_mod, "VoiceFixer", FakeVoiceFixer)


def test_single_file(fake_vf, tmp_path, capsys):
    inp = _make_wav(tmp_path / "in.wav", 4410)
    out = str(tmp_path / "sub" / "out.flac")
    assert cli.main(["-i", inp, "-o", out, "--disable-cuda"]) == 0
    assert os.path.exists(out)
    text = capsys.readouterr().out
    assert "Restoration took" in text and "Done" in text


@pytest.mark.parametrize("argv", [
    [],                                          # no input
    ["-i", "/nonexistent.wav"],
    ["-i", "IN", "-o", "OUT/out.mp3"],           # bad output extension
    ["-i", "IN", "-o", "OUT/out"],               # no output extension
    ["-i", "BAD", "-o", "OUT/o.wav"],            # bad input extension
    ["-ifdr", "/nonexistent_dir"],
])
def test_argument_errors(fake_vf, tmp_path, argv):
    inp = _make_wav(tmp_path / "in.wav", 4410)
    bad = tmp_path / "x.mp3"
    bad.write_bytes(b"\x00")
    argv = [str(a).replace("IN", inp).replace("OUT", str(tmp_path))
            .replace("BAD", str(bad)) for a in argv]
    with pytest.raises(SystemExit):
        cli.main(argv + ["--disable-cuda"])


def _folder(tmp_path):
    """Three files of other lengths (two chunks, one, one) in tmp/in."""
    indir = tmp_path / "in"
    indir.mkdir()
    _make_wav(indir / "a.wav", 50000, 1)
    x = (np.random.default_rng(2).standard_normal(30000) * 3000).astype(
        np.int16)
    audio_io.save_wave(x, str(indir / "b.flac"), 44100)
    _make_wav(indir / "c.wav", 20000, 3)
    return indir


def _cli_ranks(n, argv, tmp_path, env=None, timeout=120):
    """The CLI in n processes on gloo, meeting by a file in tmp_path; each
    one's standard output. A rank that fails or outlasts the timeout
    raises, and no process is left running."""
    init = "file://" + str(tmp_path / "rdzv")
    env = dict(os.environ, OMP_NUM_THREADS="1", **(env or {}))
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "voicefixer_tpu_torch"] + argv
        + ["--disable-cuda", "--coordinator", init, "--num-processes",
           str(n), "--process-id", str(k)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k in range(n)]
    outs = []
    try:
        for k, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank {k}: {err[-3000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _same_within_lsb(a_path, b_path, exact=False):
    a, b = _int16(str(a_path)), _int16(str(b_path))
    assert a.shape == b.shape and np.any(a != 0)
    assert np.abs(a - b).max() <= (0 if exact else 1)


@pytest.mark.parametrize("case", ["folder", "mode_all", "single_file",
                                  "env_coordinator", "no_dp", "bad_flags"])
def test_multi_process_cli(npz, tmp_path, monkeypatch, case):
    """The CLI across processes (gloo, ``--disable-cuda``), against the
    one-process CLI on the same inputs.

    - folder: two processes share three files round-robin (a and c on rank
      0, b on rank 1), each reports and writes only its own, every file is
      written, only rank 0 prints "Done"; the files are the one-process
      folder run's within one LSB (batches of other rows round in other
      places).
    - mode_all: the same with ``--mode all``; mode 2 (file by file, seeded)
      equal to the one-process run's byte for byte.
    - single_file: ``-i``/``-o`` in two processes: rank 0 restores and
      writes it, rank 1 does nothing; the file is the one-process one.
    - env_coordinator: VF_COORDINATOR alone is a world of one on gloo; the
      same files as without it.
    - no_dp: VF_NO_DP takes the per-file path: each file equal to the
      single-file run of it, byte for byte.
    - bad_flags: a process id outside the count, or a count without a
      coordinator, raises before any directory or file is made."""
    base = ["--silent"] if case == "bad_flags" else npz[:-1]
    if case == "bad_flags":
        before = sorted(os.listdir(tmp_path))
        inp = _make_wav(tmp_path / "in.wav", 4410)
        before = sorted(os.listdir(tmp_path))
        for extra in (["--coordinator", "file://" + str(tmp_path / "r"),
                       "--num-processes", "2", "--process-id", "2"],
                      ["--num-processes", "2"], ["--process-id", "0"]):
            with pytest.raises(ValueError):
                cli.main(["-i", inp, "-o", str(tmp_path / "o" / "x.wav"),
                          "--disable-cuda"] + base + extra)
        monkeypatch.setenv("VF_PROCESS_ID", "1")
        with pytest.raises(ValueError):
            cli.main(["-ifdr", str(tmp_path), "-ofdr", str(tmp_path / "o"),
                      "--disable-cuda"] + base)
        assert sorted(os.listdir(tmp_path)) == before
        return
    if case == "single_file":
        inp = _make_wav(tmp_path / "in.wav", 50000)
        outs = _cli_ranks(2, ["-i", inp, "-o", str(tmp_path / "o.wav")]
                          + base, tmp_path)
        assert "Restoration took" in outs[0] and "Done" in outs[0]
        assert outs[1] == ""
        cli.main(["-i", inp, "-o", str(tmp_path / "one.wav"),
                  "--disable-cuda"] + npz)
        _same_within_lsb(tmp_path / "o.wav", tmp_path / "one.wav", True)
        return
    indir = _folder(tmp_path)
    mode = ["--mode", "all"] if case == "mode_all" else []
    one = tmp_path / "one"
    if case == "no_dp":
        monkeypatch.setenv("VF_NO_DP", "1")
    cli.main(["-ifdr", str(indir), "-ofdr", str(one), "--disable-cuda"]
             + npz + mode)
    out = tmp_path / "out"
    argv = ["-ifdr", str(indir), "-ofdr", str(out)] + base + mode
    if case == "env_coordinator":
        monkeypatch.setenv("VF_COORDINATOR", "file://" + str(tmp_path / "r"))
        assert cli.main(argv + ["--disable-cuda", "--silent"]) == 0
        for f in sorted(os.listdir(one)):
            _same_within_lsb(out / f, one / f, exact=True)
        return
    env = {"VF_NO_DP": "1"} if case == "no_dp" else {}
    outs = _cli_ranks(2, argv, tmp_path, env)
    names = sorted(os.listdir(one))
    assert sorted(os.listdir(out)) == names
    assert "Done" in outs[0] and "Done" not in outs[1]
    if case != "no_dp":
        for k, n_files in ((0, 2), (1, 1)):
            reports = [line for line in outs[k].splitlines()
                       if "files, mode" in line]  # the batched modes
            assert reports and all(f"({n_files} files, mode" in line
                                   and f"process {k}/2)" in line
                                   for line in reports)
    for f in names:
        _same_within_lsb(out / f, one / f,
                         exact=case == "no_dp" or "mode2" in f)


def test_card_required_without_disable_cuda(npz, tmp_path, monkeypatch):
    """Without --disable-cuda the CLI takes the card, and raises here where
    there is none: no silent CPU run, no output."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inp = _make_wav(tmp_path / "in.wav", 4410)
    out = str(tmp_path / "out.wav")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["-i", inp, "-o", out] + npz)
    assert not os.path.exists(out)


@pytest.mark.parametrize("batched", [False, True])
def test_folder_run(npz, tmp_path, monkeypatch, batched):
    """A WAV and a FLAC in a folder (and a file that is neither, skipped),
    restored to <name>.wav. File by file (VF_NO_DP) each is what the
    single-file run gives, byte for byte. Batched (``restore_wavs``, the
    default in modes 0 and 1) each agrees with the single-file run and with
    the JAX CLI's batched folder run within one LSB: the chunks of both
    files share a batch, whose rows round in other places."""
    if not batched:
        monkeypatch.setenv("VF_NO_DP", "1")
    indir = tmp_path / "in"
    indir.mkdir()
    _make_wav(indir / "a.wav", 50000, 1)
    x = (np.random.default_rng(2).standard_normal(30000) * 3000).astype(
        np.int16)
    audio_io.save_wave(x, str(indir / "b.flac"), 44100)
    (indir / "ignore.txt").write_text("x")
    outdir = tmp_path / "out"
    assert cli.main(["-ifdr", str(indir), "-ofdr", str(outdir),
                     "--disable-cuda"] + npz) == 0
    assert sorted(os.listdir(outdir)) == ["a.wav", "b.wav"]
    if batched:
        assert jax_cli.main(["-ifdr", str(indir), "-ofdr",
                             str(tmp_path / "jax")] + npz) == 0
    for name in ("a.wav", "b.flac"):
        single = str(tmp_path / f"single-{name}.wav")
        cli.main(["-i", str(indir / name), "-o", single, "--disable-cuda"]
                 + npz)
        if batched:
            _same_within_lsb(outdir / (name[0] + ".wav"), single)
            _same_within_lsb(outdir / (name[0] + ".wav"),
                             tmp_path / "jax" / (name[0] + ".wav"))
        else:
            assert open(single, "rb").read() == open(
                outdir / (name[0] + ".wav"), "rb").read()


def test_weight_prepare(tmp_path, monkeypatch):
    """--weight_prepare converts the reference's torch cache into the npz
    cache (the JAX package's format and paths) and builds the CUDA kernels
    unless VF_SKIP_PREWARM is set; with nothing local it raises."""
    from tests.test_torch_checkpoints import NARROW
    from tools.torch_ref_state_dict import write_checkpoints

    from voicefixer_tpu_torch.kernels import build
    ref, cache = tmp_path / "ref", tmp_path / "npz"
    ref.mkdir()
    for k, v in {"TORCH_ANALYSIS_CKPT": ref / "vf.ckpt",
                 "TORCH_VOCODER_CKPT": ref / "model.pt",
                 "CACHE_DIR": cache, "ANALYSIS_NPZ": cache / "analysis.npz",
                 "VOCODER_NPZ": cache / "vocoder.npz"}.items():
        monkeypatch.setattr(C, k, str(v))
    monkeypatch.setattr(C, "_MIN_CKPT_BYTES", 1024)
    builds = []
    monkeypatch.setattr(build, "build_all", lambda: builds.append(1))
    with pytest.raises(RuntimeError, match="No analysis checkpoint found"):
        cli.main(["--weight_prepare"])
    write_checkpoints(NARROW, 22, str(ref / "vf.ckpt"), str(ref / "model.pt"))
    monkeypatch.setenv("VF_SKIP_PREWARM", "1")
    assert cli.main(["--weight_prepare", "--silent"]) == 0
    assert builds == []
    for name in ("analysis", "vocoder"):
        prov = JW.npz_provenance(str(cache / f"{name}.npz"))
        assert prov.startswith("converted-from-torch")
    monkeypatch.delenv("VF_SKIP_PREWARM")
    assert cli.main(["--weight_prepare", "--silent"]) == 0
    assert builds == [1]


def test_module_entry_point():
    """``python -m voicefixer_tpu_torch`` with no input exits non-zero with
    the CLI's own error, importing neither jax nor the JAX package."""
    code = ("import runpy, sys\n"
            "sys.argv = ['voicefixer_tpu_torch']\n"
            "try:\n"
            "    runpy.run_module('voicefixer_tpu_torch', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "           ('jax', 'voicefixer_tpu')]\n"
            "    print(bad, e.code)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("[] Error: You need to specify an input")
