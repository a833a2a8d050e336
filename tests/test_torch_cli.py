"""The port's command line (``python -m voicefixer_tpu_torch``) against the
JAX package's: the same files restored by both CLIs from one pair of npz
params at ``tiny_test_config`` (the port with ``--disable-cuda``), its
argument errors, what it refuses before writing anything, a folder run and
``--weight_prepare``."""

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


@pytest.mark.parametrize("argv,item", [
    (["--mode", "2", "--coordinator", "localhost:1234"], 8),
    (["--mode", "all", "--num-processes", "2"], 8),
    (["--coordinator", "localhost:1234"], 8), (["--num-processes", "2"], 8),
    (["--process-id", "0"], 8), ([], 8)])
def test_unported_raise_before_writing(fake_vf, tmp_path, monkeypatch, argv,
                                       item):
    """The multi-process flags (or $VF_COORDINATOR), in any mode, raise
    naming their ROADMAP item; no directory or file is made."""
    if not argv:
        monkeypatch.setenv("VF_COORDINATOR", "localhost:1234")
    inp = _make_wav(tmp_path / "in.wav", 4410)
    before = sorted(os.listdir(tmp_path))
    out = str(tmp_path / "sub" / "out.wav")
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.md Queue 1 item {item}$"):
        cli.main(["-i", inp, "-o", out, "--disable-cuda"] + argv)
    with pytest.raises(NotImplementedError):
        cli.main(["-ifdr", str(tmp_path), "-ofdr", str(tmp_path / "o"),
                  "--disable-cuda"] + argv)
    assert sorted(os.listdir(tmp_path)) == before


def test_card_required_without_disable_cuda(npz, tmp_path, monkeypatch):
    """Without --disable-cuda the CLI takes the card, and raises here where
    there is none: no silent CPU run, no output."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inp = _make_wav(tmp_path / "in.wav", 4410)
    out = str(tmp_path / "out.wav")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["-i", inp, "-o", out] + npz)
    assert not os.path.exists(out)


def test_folder_run(npz, tmp_path):
    """A WAV and a FLAC in a folder (and a file that is neither, skipped),
    restored one by one to <name>.wav; each as the single-file run gives
    it."""
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
    for name in ("a.wav", "b.flac"):
        single = str(tmp_path / f"single-{name}.wav")
        cli.main(["-i", str(indir / name), "-o", single, "--disable-cuda"]
                 + npz)
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
