"""Audio files without librosa or soundfile, an own copy of
``voicefixer_tpu/utils/audio_io.py`` (numpy, scipy and the standard
library).

WAV is read and written by scipy.io.wavfile; resampling to the pipeline's
rate is scipy.signal.resample_poly. The container is chosen by the file's
magic, not its extension: FLAC ('fLaC') by ``utils.flac``, AIFF/AIFC
('FORM..AIFF/AIFC') and Sun AU ('.snd') by the standard library's readers.
A lossy container (mp3, ogg, m4a, webm) is read by soundfile where that is
installed, and raises a clear error where it is not. ``save_wave`` writes
int16 WAV, or FLAC (``utils.flac_enc``) by the extension.
"""

from __future__ import annotations

import math
import os

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def _to_float(data: np.ndarray) -> np.ndarray:
    if data.dtype == np.int16:
        return data.astype(np.float32) / 32768.0
    if data.dtype == np.int32:
        return data.astype(np.float32) / 2147483648.0
    if data.dtype == np.uint8:
        return (data.astype(np.float32) - 128.0) / 128.0
    return data.astype(np.float32)


def _resample(wav: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    if sr_in == sr_out:
        return wav
    g = math.gcd(sr_in, sr_out)
    return resample_poly(wav, sr_out // g, sr_in // g, axis=0).astype(
        np.float32)


def _pcm_bytes_to_float(raw: bytes, sampwidth: int, nch: int,
                        big_endian: bool) -> np.ndarray:
    """Interleaved PCM bytes -> float32 [samples, channels] in [-1, 1]."""
    order = ">" if big_endian else "<"
    if sampwidth == 1:
        data = np.frombuffer(raw, np.int8).astype(np.float32) / 128.0
    elif sampwidth == 2:
        data = np.frombuffer(raw, f"{order}i2").astype(np.float32) / 32768.0
    elif sampwidth == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        if big_endian:
            v = ((b[:, 0].astype(np.int32) << 16)
                 | (b[:, 1].astype(np.int32) << 8) | b[:, 2])
        else:
            v = ((b[:, 2].astype(np.int32) << 16)
                 | (b[:, 1].astype(np.int32) << 8) | b[:, 0])
        v = np.where(v >= 1 << 23, v - (1 << 24), v)
        data = v.astype(np.float32) / float(1 << 23)
    elif sampwidth == 4:
        data = np.frombuffer(raw, f"{order}i4").astype(np.float32) \
            / 2147483648.0
    else:
        raise ValueError(f"unsupported PCM sample width {sampwidth}")
    return data.reshape(-1, nch)


def _read_aiff(fname: str):
    """AIFF/AIFC via the stdlib reader (big-endian PCM; compressed AIFC
    variants are decoded by aifc itself where it supports them)."""
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import aifc
    with aifc.open(fname, "rb") as f:
        raw = f.readframes(f.getnframes())
        sr = int(f.getframerate())
        data = _pcm_bytes_to_float(raw, f.getsampwidth(),
                                   f.getnchannels(), big_endian=True)
    return sr, data


def _read_au(fname: str):
    """Sun AU/SND via the stdlib reader (readframes returns linear PCM —
    sunau converts u-law itself)."""
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import sunau
    with sunau.open(fname, "rb") as f:
        raw = f.readframes(f.getnframes())
        sr = int(f.getframerate())
        data = _pcm_bytes_to_float(raw, f.getsampwidth(),
                                   f.getnchannels(), big_endian=True)
    return sr, data


def _lossy_container(magic: bytes) -> str | None:
    """Name the lossy/compressed container a magic prefix identifies, or
    None when it isn't one we recognize."""
    if magic[:3] == b"ID3" or (len(magic) >= 2 and magic[0] == 0xFF
                               and (magic[1] & 0xE0) == 0xE0):
        return "mp3"
    if magic[:4] == b"OggS":
        return "ogg"
    if magic[4:8] == b"ftyp":
        return "m4a/mp4"
    if magic[:4] == b"\x1aE\xdf\xa3":
        return "webm/mkv"
    return None


def _read_via_soundfile(fname: str, container: str):
    """Containers the bundled decoders do not cover, through soundfile
    where it is installed; a clear error where it is not."""
    try:
        import soundfile  # noqa: F401 — optional, not in the base image
    except ImportError:
        raise ValueError(
            f"{fname!r} looks like a {container} file. The bundled decoders "
            "cover WAV/FLAC/AIFF/AU; for lossy containers install the "
            "optional 'soundfile' package (pip install soundfile) or "
            "convert the file to WAV/FLAC first.") from None
    data, sr = soundfile.read(fname, dtype="float32", always_2d=True)
    return int(sr), data


def read_audio(fname: str):
    """Read wav/flac/aiff/au (bundled decoders; mp3/ogg via optional
    soundfile) -> (native_sr, float32 [samples, channels] in [-1, 1]).
    Dispatch is by file magic."""
    if not os.path.exists(fname):
        raise FileNotFoundError(fname)
    with open(fname, "rb") as f:
        magic = f.read(12)
    if magic[:4] == b"fLaC":
        from voicefixer_tpu_torch.utils.flac import read_flac
        sr, data = read_flac(fname)
    elif magic[:4] == b"FORM" and magic[8:12] in (b"AIFF", b"AIFC"):
        sr, data = _read_aiff(fname)
    elif magic[:4] == b".snd":
        sr, data = _read_au(fname)
    elif _lossy_container(magic) is not None:
        sr, data = _read_via_soundfile(fname, _lossy_container(magic))
    else:
        sr, data = wavfile.read(fname)
        data = _to_float(np.asarray(data))
    if data.ndim == 1:
        data = data[:, None]
    return sr, data


def read_wave(fname: str, sample_rate: int | None = None,
              mono: bool = False) -> np.ndarray:
    """Read a wav/flac file -> float32 [samples, channels] in [-1, 1],
    resampled to `sample_rate` if given. mono=True averages channels
    (librosa.load semantics)."""
    sr, data = read_audio(fname)
    if mono and data.shape[1] > 1:
        data = data.mean(axis=1, keepdims=True)
    if sample_rate is not None and sr != sample_rate:
        data = _resample(data, sr, sample_rate)
    return data


def load_wav(path: str, sample_rate: int) -> np.ndarray:
    """librosa.load(path, sr): mono float32 [samples]."""
    return read_wave(path, sample_rate=sample_rate, mono=True)[:, 0]


def save_wave(frames: np.ndarray, fname: str, sample_rate: int = 44100):
    """Upstream's save_wave: floats with max |x| <= 1 are scaled by 2**15,
    cast to int16, and written as FLAC (``utils.flac_enc``) where the name
    ends in .flac, as RIFF/WAV otherwise."""
    frames = np.asarray(frames)
    if frames.ndim == 1:
        frames = frames[:, None]
    if frames.ndim >= 3:
        frames = frames.reshape(frames.shape[0], -1) if frames.shape[0] > 1 \
            else frames.reshape(-1, frames.shape[-1])
    if np.issubdtype(frames.dtype, np.floating) and np.max(np.abs(frames)) <= 1:
        frames = frames * (2 ** 15)
    frames = frames.astype(np.int16)
    if fname.lower().endswith(".flac"):
        from voicefixer_tpu_torch.utils.flac_enc import write_flac
        write_flac(frames, fname, sample_rate)
        return
    wavfile.write(fname, sample_rate, frames)


def get_duration(fname: str) -> float:
    sr, data = read_audio(fname)
    return data.shape[0] / sr
