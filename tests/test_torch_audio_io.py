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


# ------------------------------------------------ the native FLAC decoder
#
# A test-only writer on flac_enc's bit writer and CRCs: each stream takes
# the subframe kinds, the stereo decorrelation, wasted bits and sample size
# of its case, so that every path of the decoders runs. STREAMINFO's MD5 is
# left zero (no decoder checks it).

_SS_CODES = {8: 1, 16: 4, 24: 6}
_CHAN_CODES = {"independent": None, "left_side": 8, "right_side": 9,
               "mid_side": 10}
# LPC: order 4, 12-bit coefficients, shift 10 (any coefficients are exact:
# the writer computes the residual as the decoder predicts)
_QLP, _QLP_PRECISION, _QLP_SHIFT = (1700, -700, 90, -40), 12, 10


def _write_residual(bw, res, blocksize, order, porder, escape):
    """Rice partitions of order ``porder``; with ``escape`` the first
    partition is written verbatim (parameter 15, then a 5-bit width)."""
    bw.write(0, 2)       # 4-bit Rice parameters
    bw.write(porder, 4)
    plen = blocksize >> porder
    start = 0
    for part in range(1 << porder):
        n = plen - order if part == 0 else plen
        r = np.asarray(res[start:start + n], np.int64)
        start += n
        if escape and part == 0:
            bits = max(int(np.abs(r).max()).bit_length() + 1, 1) if n else 0
            bw.write(15, 4)
            bw.write(bits, 5)
            for v in r.tolist():
                bw.write(v, bits)
            continue
        u = (r << 1) ^ (r >> 63)
        k = 0
        while u.size and (1 << (k + 1)) < float(u.mean()) + 1 and k < 14:
            k += 1
        bw.write(k, 4)
        for v in u.tolist():
            bw.write((1 << k) | (v & ((1 << k) - 1)), (v >> k) + 1 + k)
    assert start == len(res)


def _write_subframe(bw, x, bps, kind, wasted, porder=0, escape=False):
    x = np.asarray(x, np.int64)
    bw.write(0, 1)
    if kind == "constant":
        code = 0
    elif kind == "verbatim":
        code = 1
    elif kind.startswith("fixed"):
        order = int(kind[5:])
        code = 8 | order
    else:
        order = len(_QLP)
        code = 32 + order - 1
    bw.write(code, 6)
    if wasted:
        assert not np.any(x & ((1 << wasted) - 1))
        bw.write(1, 1)
        bw.write(1, wasted)  # unary wasted - 1: zeros, then a one
        x, bps = x >> wasted, bps - wasted
    else:
        bw.write(0, 1)
    if kind == "constant":
        assert np.all(x == x[0])
        bw.write(int(x[0]), bps)
        return
    if kind == "verbatim":
        for v in x.tolist():
            bw.write(v, bps)
        return
    for v in x[:order].tolist():
        bw.write(v, bps)
    if kind.startswith("fixed"):
        res = np.diff(x, n=order) if order else x
    else:
        bw.write(_QLP_PRECISION - 1, 4)
        bw.write(_QLP_SHIFT, 5)
        for q in _QLP:
            bw.write(q, _QLP_PRECISION)
        res = [int(x[i]) - (sum(q * int(x[i - 1 - j])
                                for j, q in enumerate(_QLP)) >> _QLP_SHIFT)
               for i in range(order, len(x))]
    _write_residual(bw, res, len(x), order, porder, escape)


def _write_test_flac(path, pcm, sr, bps, kinds, stereo="independent",
                     wasted=0, block=1024, total=None, porder=0,
                     escape=False):
    """pcm: int [n, channels]. Frame i uses kinds[i % len(kinds)] for
    every subframe; ``total`` overrides STREAMINFO's sample count."""
    n, nch = pcm.shape
    out = bytearray(b"fLaC")
    si = flac_enc._BitWriter()
    si.write(block, 16)
    si.write(block, 16)
    si.write(0, 24)
    si.write(0, 24)
    si.write(sr, 20)
    si.write(nch - 1, 3)
    si.write(bps - 1, 5)
    si.write(n if total is None else total, 36)
    body = si.bytes() + bytes(16)
    out += bytes([0x80]) + len(body).to_bytes(3, "big") + body
    for fi, start in enumerate(range(0, n, block)):
        chunk = pcm[start:start + block].astype(np.int64)
        bs = len(chunk)
        kind = kinds[fi % len(kinds)]
        bw = flac_enc._BitWriter()
        bw.write(0x3FFE, 14)
        bw.write(0, 2)
        bw.write(0b0111, 4)      # 16-bit blocksize - 1 after the number
        bw.write(0, 4)           # sample rate from STREAMINFO
        code = _CHAN_CODES[stereo]
        bw.write(nch - 1 if code is None else code, 4)
        bw.write(_SS_CODES[bps], 3)
        bw.write(0, 1)
        for b in flac_enc._utf8_number(fi):
            bw.write(b, 8)
        bw.write(bs - 1, 16)
        bw.write(flac_enc._crc8(bytes(bw.buf)), 8)
        po = porder if bs % (1 << porder) == 0 and bs >> porder > 4 else 0

        def sub(x, b):
            _write_subframe(bw, x, b, kind, wasted, po, escape)

        left, right = chunk[:, 0], chunk[:, -1]
        if code is None:
            for c in range(nch):
                sub(chunk[:, c], bps)
        elif stereo == "left_side":
            sub(left, bps)
            sub(left - right, bps + 1)
        elif stereo == "right_side":
            sub(left - right, bps + 1)
            sub(right, bps)
        else:
            sub((left + right) >> 1, bps)
            sub(left - right, bps + 1)
        bw.align()
        frame = bw.bytes()
        out += frame + flac_enc._crc16(frame).to_bytes(2, "big")
    with open(path, "wb") as f:
        f.write(out)


def _test_pcm(n, nch, bps, seed, constant=False, wasted=0):
    """A random walk in [-2^(bps-1), 2^(bps-1)), or one value a channel."""
    rng = np.random.default_rng(seed)
    top = 1 << (bps - 1)
    if constant:
        x = np.broadcast_to(rng.integers(-top, top, (1, nch)), (n, nch))
    else:
        step = max(top >> 6, 1)
        x = np.cumsum(rng.integers(-step, step + 1, (n, nch)), axis=0)
        x = np.clip(x + rng.integers(-top // 2, top // 2, (1, nch)),
                    -top, top - 1)
    x = np.asarray(x, np.int64)
    return (x >> wasted) << wasted


# name: (bps, channels, kinds, stereo, wasted, porder, escape)
FLAC_CASES = {
    "verbatim": (16, 1, ["verbatim"], "independent", 0, 0, False),
    "constant": (16, 2, ["constant"], "independent", 0, 0, False),
    **{f"fixed{o}": (16, 1, [f"fixed{o}"], "independent", 0, 2, False)
       for o in range(5)},
    "lpc": (16, 1, ["lpc"], "independent", 0, 1, False),
    "escape_partition": (16, 1, ["fixed2"], "independent", 0, 2, True),
    "left_side": (16, 2, ["fixed1", "lpc"], "left_side", 0, 0, False),
    "right_side": (16, 2, ["fixed2", "verbatim"], "right_side", 0, 0, False),
    "mid_side": (16, 2, ["fixed3", "lpc"], "mid_side", 0, 1, False),
    "wasted_bits": (16, 2, ["fixed2", "verbatim", "lpc"], "independent", 3,
                    0, False),
    "8_bit": (8, 1, ["fixed1", "verbatim", "lpc"], "independent", 0, 0,
              False),
    "24_bit": (24, 2, ["fixed2", "lpc", "verbatim"], "mid_side", 0, 1,
               False),
}


def _decoded_ints(data, bps):
    return np.round(data.astype(np.float64) * (1 << (bps - 1))).astype(
        np.int64)


@pytest.mark.parametrize("case", sorted(FLAC_CASES))
def test_native_flac_bit_exact(tmp_path, case):
    """The native decoder against the port's and the JAX package's Python
    decoders on every stream kind, with a partial last block: the same
    float32 arrays bit for bit, and the integers written."""
    from voicefixer_tpu_torch.utils import flac_native
    bps, nch, kinds, stereo, wasted, porder, escape = FLAC_CASES[case]
    pcm = _test_pcm(3 * 1024 + 301, nch, bps, len(case),
                    constant=case == "constant", wasted=wasted)
    path = str(tmp_path / f"{case}.flac")
    _write_test_flac(path, pcm, 32000, bps, kinds, stereo, wasted,
                     porder=porder, escape=escape)
    sr, native = flac_native.read_flac(path)
    for dec in (flac.read_flac, jax_flac.read_flac):
        got_sr, got = dec(path)
        assert got_sr == sr == 32000
        assert got.dtype == native.dtype == np.float32
        np.testing.assert_array_equal(native, got)
    np.testing.assert_array_equal(_decoded_ints(native, bps), pcm)
    before = dict(audio_io.flac_decodes)
    np.testing.assert_array_equal(audio_io.read_audio(path)[1], native)
    assert audio_io.flac_decodes["native"] == before["native"] + 1
    assert audio_io.flac_decodes["python"] == before["python"]


def test_unknown_length_stream_goes_to_python(tmp_path):
    """total_samples == 0: the native decoder declines it, read_audio
    decodes it in Python and counts it so."""
    from voicefixer_tpu_torch.utils import flac_native
    pcm = _test_pcm(2500, 2, 16, 5)
    path = str(tmp_path / "stream.flac")
    _write_test_flac(path, pcm, 44100, 16, ["fixed2", "lpc"], "left_side",
                     total=0)
    assert flac_native.read_flac(path) is None
    before = dict(audio_io.flac_decodes)
    sr, data = audio_io.read_audio(path)
    assert audio_io.flac_decodes["python"] == before["python"] + 1
    assert audio_io.flac_decodes["native"] == before["native"]
    np.testing.assert_array_equal(data, jax_io.read_audio(path)[1])
    np.testing.assert_array_equal(_decoded_ints(data, 16), pcm)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("n,nch", [(4096 * 2 + 17, 1), (5000, 2), (1, 1)])
def test_native_flac_reads_both_writers(tmp_path, writer, n, nch):
    from voicefixer_tpu_torch.utils import flac_native
    x = (_pcm(n, nch, n) * 32767).astype(np.int16)
    path = str(tmp_path / "x.flac")
    (flac_enc if writer == "port" else jax_flac_enc).write_flac(x, path,
                                                                44100)
    sr, native = flac_native.read_flac(path)
    np.testing.assert_array_equal(native, flac.read_flac(path)[1])
    np.testing.assert_array_equal(native, jax_flac.read_flac(path)[1])
    np.testing.assert_array_equal(_decoded_ints(native, 16), x)


def test_native_flac_truncated_raises(tmp_path):
    from voicefixer_tpu_torch.utils import flac_native
    path = str(tmp_path / "x.flac")
    flac_enc.write_flac((_pcm(5000, 1) * 32767).astype(np.int16), path)
    data = open(path, "rb").read()
    open(path, "wb").write(data[:len(data) // 2])
    with pytest.raises(flac.FlacError, match="truncated"):
        flac_native.read_flac(path)


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """The build directory in tmp_path and nothing loaded, so that the next
    read builds the decoder again."""
    from voicefixer_tpu_torch.kernels import build
    from voicefixer_tpu_torch.utils import flac_native
    monkeypatch.setattr(build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(flac_native, "_lib", None)
    path = str(tmp_path / "x.flac")
    flac_enc.write_flac((_pcm(100, 1) * 32767).astype(np.int16), path)
    return build, path


def test_native_flac_missing_compiler_raises(fresh_build, monkeypatch):
    build, path = fresh_build
    monkeypatch.setenv("CXX", "/nonexistent/g++")
    before = dict(audio_io.flac_decodes)
    with pytest.raises(RuntimeError, match="not found"):
        audio_io.read_audio(path)
    assert audio_io.flac_decodes == before
    assert not list(build.BUILD.glob("*.so"))


def test_native_flac_compile_error_raises(fresh_build, monkeypatch, tmp_path):
    build, path = fresh_build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "flacdec.cpp").write_text("int vf_flac_probe( {\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    with pytest.raises(RuntimeError, match="flacdec: exit") as e:
        audio_io.read_audio(path)
    assert "error" in str(e.value)  # the compiler's own message
    assert not list(build.BUILD.glob("*.so"))


def test_native_flac_builds_into_the_package():
    """Built from csrc/flacdec.cpp into voicefixer_tpu_torch/build/, named
    after its hash."""
    from voicefixer_tpu_torch.kernels import build
    from voicefixer_tpu_torch.utils import flac_native
    flac_native.load()
    path = build.library_path("flacdec")
    assert path.exists() and path.parent == build.PKG / "build"
    assert path.name.startswith("libflacdec-")
