"""A FLAC encoder with no native dependency, an own copy of
``voicefixer_tpu/utils/flac_enc.py``: byte for byte the same files.

- fixed 4096-sample blocks (the last frame uses the 16-bit blocksize-1
  header escape);
- per channel, per frame: a CONSTANT subframe when all samples are equal,
  otherwise the FIXED predictor (order 0-4) with the least summed absolute
  residual, one Rice partition whose parameter is fitted to the residual's
  mean;
- independent channels (no stereo decorrelation);
- STREAMINFO carries the MD5 of the little-endian samples.
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np

_BLOCK = 4096
_SR_CODES = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5, 22050: 6,
             24000: 7, 32000: 8, 44100: 9, 48000: 10, 96000: 11}
_FIXED_COEFFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, nbits: int):
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.nbits += nbits
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def align(self):
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def bytes(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.buf)


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1)
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 \
                else (crc << 1) & 0xFFFF
    return crc


def _utf8_number(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    out = []
    nbytes = 2
    while n >= (1 << (6 * (nbytes - 1) + (7 - nbytes))):
        nbytes += 1
    lead_bits = 7 - nbytes
    shift = 6 * (nbytes - 1)
    lead = (0xFF << (lead_bits + 1)) & 0xFF | (n >> shift)
    out.append(lead)
    for i in range(nbytes - 1):
        shift -= 6
        out.append(0x80 | ((n >> shift) & 0x3F))
    return bytes(out)


def _write_residual(bw: _BitWriter, res: np.ndarray):
    """Single-partition Rice coding (method 00, partition order 0)."""
    u = (res.astype(np.int64) << 1) ^ (res.astype(np.int64) >> 63)  # zigzag
    mean = float(u.mean()) if u.size else 0.0
    k = 0
    while (1 << (k + 1)) < mean + 1 and k < 14:
        k += 1
    bw.write(0, 2)   # coding method: 4-bit Rice
    bw.write(0, 4)   # partition order 0
    bw.write(k, 4)
    term = 1 << k    # q zeros, the 1 terminator, then k remainder bits
    for v in u.tolist():
        q, rem = v >> k, v & (term - 1)
        bw.write(term | rem, q + 1 + k)


def _encode_subframe(bw: _BitWriter, x: np.ndarray, bps: int):
    bw.write(0, 1)  # zero padding
    if np.all(x == x[0]):
        bw.write(0b000000, 6)       # CONSTANT
        bw.write(0, 1)              # no wasted bits
        bw.write(int(x[0]), bps)
        return
    best_order, best_res, best_cost = 0, x.astype(np.int64), None
    res = x.astype(np.int64)
    for order in range(5):
        cost = float(np.abs(res).sum())
        if best_cost is None or cost < best_cost:
            best_order, best_res, best_cost = order, res, cost
        if order < 4 and len(x) > order + 1:
            res = np.diff(res)  # order-(o+1) residual = diff of order-o
        else:
            break
    o = best_order
    bw.write(8 | o, 6)  # FIXED, order o
    bw.write(0, 1)      # no wasted bits
    for w in x[:o].tolist():
        bw.write(int(w), bps)
    _write_residual(bw, best_res)


def write_flac(frames: np.ndarray, fname: str, sample_rate: int = 44100):
    """frames: int16 [N] or [N, C] -> FLAC file at `fname`."""
    frames = np.asarray(frames)
    if frames.ndim == 1:
        frames = frames[:, None]
    if frames.dtype != np.int16:
        raise ValueError("write_flac expects int16 samples")
    n, nch = frames.shape
    if not 1 <= nch <= 8:
        raise ValueError(f"unsupported channel count {nch}")
    bps = 16
    md5 = hashlib.md5(frames.astype("<i2").tobytes()).digest()

    out = bytearray(b"fLaC")
    # STREAMINFO (last metadata block), 34 bytes
    si = _BitWriter()
    si.write(_BLOCK, 16)            # min blocksize
    si.write(_BLOCK, 16)            # max blocksize
    si.write(0, 24)                 # min framesize (unknown)
    si.write(0, 24)                 # max framesize (unknown)
    si.write(sample_rate, 20)
    si.write(nch - 1, 3)
    si.write(bps - 1, 5)
    si.write(n, 36)
    body = si.bytes() + md5
    # metadata block header: last-block flag | type STREAMINFO, 24-bit len
    out += bytes([0x80]) + len(body).to_bytes(3, "big") + body

    # sample-rate code 0 = "get from STREAMINFO" for rates not in the table
    sr_code = _SR_CODES.get(sample_rate, 0)
    for fi, start in enumerate(range(0, max(n, 1), _BLOCK)):
        chunk = frames[start: start + _BLOCK]
        bs = len(chunk)
        bw = _BitWriter()
        bw.write(0x3FFE, 14)        # sync
        bw.write(0, 1)              # reserved
        bw.write(0, 1)              # fixed-blocksize stream
        full = bs == _BLOCK
        bw.write(0b1100 if full else 0b0111, 4)   # 4096 or 16-bit escape
        bw.write(sr_code, 4)
        bw.write(nch - 1, 4)        # independent channels
        bw.write(0b100, 3)          # 16 bits per sample
        bw.write(0, 1)              # reserved
        for b in _utf8_number(fi):
            bw.write(b, 8)
        if not full:
            bw.write(bs - 1, 16)
        header = bytes(bw.buf)
        bw.write(_crc8(header), 8)
        for c in range(nch):
            _encode_subframe(bw, chunk[:, c].astype(np.int64), bps)
        bw.align()
        frame = bw.bytes()
        out += frame + struct.pack(">H", _crc16(frame))

    with open(fname, "wb") as f:
        f.write(out)
