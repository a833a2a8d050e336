"""The native FLAC decoder (``csrc/flacdec.cpp``) through ctypes: the
decode logic of ``utils/flac.py`` in C++, built with the host compiler at
first use by ``kernels.build`` into ``voicefixer_tpu_torch/build/``.

A build or load failure raises with the compiler's output: nothing falls
back to the Python decoder without a word. The one stream it declines is
one whose STREAMINFO leaves the sample count unknown (``total_samples ==
0``): ``read_flac`` returns None, and ``utils.audio_io.read_audio`` decodes
that one in Python, as the JAX package does.
"""

from __future__ import annotations

import ctypes

import numpy as np

from voicefixer_tpu_torch.utils.flac import FlacError

_ERRORS = {1: "truncated stream", 2: "not a FLAC stream",
           3: "malformed frame", 4: "reserved code", 5: "missing STREAMINFO",
           6: "more samples than STREAMINFO declares",
           7: "channel count changed mid-stream"}
_lib = None


def load() -> ctypes.CDLL:
    """The decoder's library with its C signatures, built first if
    needed."""
    global _lib
    if _lib is None:
        from voicefixer_tpu_torch.kernels import build
        lib = build.load("flacdec")
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.vf_flac_probe.restype = ctypes.c_int
        lib.vf_flac_probe.argtypes = [ctypes.c_char_p, ctypes.c_int64, i32p,
                                      i32p, i32p,
                                      ctypes.POINTER(ctypes.c_int64)]
        lib.vf_flac_decode.restype = ctypes.c_int
        lib.vf_flac_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, i32p,
                                       ctypes.c_int64,
                                       ctypes.POINTER(ctypes.c_int64)]
        _lib = lib
    return _lib


def _check(rc: int, fname: str):
    if rc != 0:
        raise FlacError(f"{fname}: {_ERRORS.get(-rc, f'error {rc}')}")


def read_flac(fname: str):
    """(sample_rate, float32 [samples, channels] in [-1, 1)), the integers
    scaled by 2^(bps-1) as ``utils.flac.read_flac`` scales them; None for a
    stream of unknown length. A malformed stream raises ``FlacError``."""
    lib = load()
    with open(fname, "rb") as f:
        data = f.read()
    sr, ch, bps = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    total = ctypes.c_int64()
    _check(lib.vf_flac_probe(data, len(data), ctypes.byref(sr),
                             ctypes.byref(ch), ctypes.byref(bps),
                             ctypes.byref(total)), fname)
    if total.value == 0:
        return None
    out = np.empty((total.value, ch.value), dtype=np.int32)
    decoded = ctypes.c_int64()
    _check(lib.vf_flac_decode(
        data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        total.value, ctypes.byref(decoded)), fname)
    out = out[:decoded.value]
    scale = float(1 << (bps.value - 1))
    return int(sr.value), (out / scale).astype(np.float32)
