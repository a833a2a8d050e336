"""Audio files in the port against the JAX package, on files the tests
write: both packages decode every container to the same samples, their
FLAC encoders write the same bytes and each decoder reads the other's files
exactly, ``save_wave`` scales and writes the same files, and a lossy
container fails with the same error."""

import warnings

import numpy as np
import pytest
from scipy.io import wavfile

from voicefixer_tpu.utils import audio_io as jax_io
from voicefixer_tpu.utils import flac as jax_flac
from voicefixer_tpu.utils import flac_enc as jax_flac_enc

from voicefixer_tpu_torch.utils import audio_io, flac, flac_enc


def _pcm(n, nch=1, seed=0, scale=0.3):
    x = np.random.default_rng(seed).standard_normal((n, nch)) * scale
    return np.clip(x, -1, 1)


def _write_stdlib(module, path, data, sr):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        mod = __import__(module)
    with mod.open(path, "wb") as f:
        f.setnchannels(data.shape[1])
        f.setsampwidth(2)
        f.setframerate(sr)
        if module == "sunau":
            f.setcomptype("NONE", "not compressed")  # ULAW otherwise
        f.writeframes(data.astype(">i2").tobytes())


def _make(kind, path):
    """One file of each kind, returns its path."""
    if kind == "wav_int16":
        wavfile.write(path, 44100, (_pcm(5000) * 32767).astype(np.int16))
    elif kind == "wav_int32":
        wavfile.write(path, 44100, (_pcm(5000, 1, 1) * (2 ** 31 - 1)).astype(
            np.int32))
    elif kind == "wav_float32":
        wavfile.write(path, 44100, _pcm(5000, 1, 2).astype(np.float32))
    elif kind == "wav_uint8":
        wavfile.write(path, 44100, (_pcm(5000, 1, 3) * 127 + 128).astype(
            np.uint8))
    elif kind == "wav_stereo_22k":
        wavfile.write(path, 22050, (_pcm(6000, 2, 4) * 32767).astype(
            np.int16))
    elif kind == "aiff":
        _write_stdlib("aifc", path, _pcm(4000, 1, 5) * 32767, 22050)
    elif kind == "au":
        _write_stdlib("sunau", path, _pcm(3000, 2, 6) * 32767, 16000)
    elif kind == "flac":
        flac_enc.write_flac((_pcm(9000, 2, 7) * 32767).astype(np.int16),
                            path, 48000)
    return path


KINDS = ("wav_int16", "wav_int32", "wav_float32", "wav_uint8",
         "wav_stereo_22k", "aiff", "au", "flac")


@pytest.mark.parametrize("kind", KINDS)
def test_read_matches_jax(tmp_path, kind):
    """read_audio, read_wave (mono, resampled to 44.1 kHz), load_wav and
    get_duration: the same arrays from both packages."""
    path = _make(kind, str(tmp_path / f"x.{kind.split('_')[0]}"))
    sr, data = audio_io.read_audio(path)
    jsr, jdata = jax_io.read_audio(path)
    assert sr == jsr and data.dtype == jdata.dtype == np.float32
    np.testing.assert_array_equal(data, jdata)
    for kw in ({}, {"sample_rate": 44100, "mono": True}):
        np.testing.assert_array_equal(audio_io.read_wave(path, **kw),
                                      jax_io.read_wave(path, **kw))
    wav = audio_io.load_wav(path, 44100)
    assert wav.ndim == 1 and wav.dtype == np.float32
    np.testing.assert_array_equal(wav, jax_io.load_wav(path, 44100))
    assert audio_io.get_duration(path) == jax_io.get_duration(path)


@pytest.mark.parametrize("n,nch,sr", [(4096 * 2 + 17, 1, 44100),
                                      (5000, 2, 22050), (100, 1, 12345),
                                      (1, 1, 44100)])
def test_flac_bit_exact_across_packages(tmp_path, n, nch, sr):
    """Full and partial blocks, stereo, a rate outside the header's table,
    a constant block: the port's encoder writes the JAX encoder's bytes,
    and each decoder gives the other's integers back exactly."""
    x = (_pcm(n, nch, n) * 32767).astype(np.int16)
    x[:300] = 1234  # a block that starts constant
    ours, theirs = str(tmp_path / "port.flac"), str(tmp_path / "jax.flac")
    flac_enc.write_flac(x, ours, sr)
    jax_flac_enc.write_flac(x, theirs, sr)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    for dec in (flac.read_flac, jax_flac.read_flac):
        got_sr, got = dec(ours)
        assert got_sr == sr and got.shape == (n, nch)
        np.testing.assert_array_equal(np.round(got * 32768).astype(np.int16),
                                      x)
    np.testing.assert_array_equal(flac.read_flac(theirs)[1],
                                  jax_flac.read_flac(ours)[1])


def test_flac_errors():
    with pytest.raises(ValueError, match="int16"):
        flac_enc.write_flac(np.zeros(4, np.float32), "unused.flac")
    assert issubclass(flac.FlacError, ValueError)


@pytest.mark.parametrize("frames", [
    np.array([0.5, -0.5, 1.0 - 2 ** -15, -1.0], np.float32),
    np.array([[0.25, -0.125], [0.5, 0.0]], np.float64),
    np.array([3.0, -2.5, 100.7], np.float32),       # max > 1: not scaled
    np.array([1000, -2000, 32767], np.int16),
    np.linspace(-0.9, 0.9, 10, dtype=np.float32).reshape(10, 1, 1),
])
@pytest.mark.parametrize("ext", ["wav", "flac", "WAV"])
def test_save_wave_matches_jax(tmp_path, frames, ext):
    """Floats with max |x| <= 1 scaled by 2**15 and truncated to int16, the
    container by the extension: the same bytes as the JAX package's."""
    ours, theirs = str(tmp_path / f"port.{ext}"), str(tmp_path / f"jax.{ext}")
    audio_io.save_wave(frames, ours, 22050)
    jax_io.save_wave(frames, theirs, 22050)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    if ext == "wav" and frames.dtype == np.float32 and frames.ndim == 1 \
            and frames.max() <= 1:
        _, data = wavfile.read(ours)
        np.testing.assert_array_equal(
            data, (frames * 2 ** 15).astype(np.int16))


@pytest.mark.parametrize("magic,name", [(b"ID3\x04" + b"\0" * 12, "mp3"),
                                        (b"\xff\xfb\x90\x00" + b"\0" * 12,
                                         "mp3"),
                                        (b"OggS" + b"\0" * 12, "ogg"),
                                        (b"\0\0\0\x20ftypM4A " + b"\0" * 4,
                                         "m4a/mp4"),
                                        (b"\x1aE\xdf\xa3" + b"\0" * 12,
                                         "webm/mkv")])
def test_lossy_container_error_matches_jax(tmp_path, magic, name):
    path = str(tmp_path / "x.bin")
    open(path, "wb").write(magic)
    errors = []
    for mod in (audio_io, jax_io):
        with pytest.raises(ValueError) as e:
            mod.read_audio(path)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and f"a {name} file" in errors[0]


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        audio_io.read_audio(str(tmp_path / "none.wav"))
