"""A pure-Python FLAC decoder, an own copy of ``voicefixer_tpu/utils/flac.py``.

Enough of the format to decode common files losslessly: CONSTANT,
VERBATIM, FIXED and LPC subframes, Rice residuals (with escapes), wasted
bits, and the three stereo decorrelations. ``read_flac`` gives the PCM
integers scaled by 2^(bps-1), the convention soundfile and librosa use.
"""

from __future__ import annotations

import numpy as np

__all__ = ["read_flac", "FlacError"]


class FlacError(ValueError):
    pass


class _BitReader:
    """MSB-first bit reader over a bytes object with an int accumulator."""

    __slots__ = ("data", "pos", "acc", "nbits")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self.acc = 0
        self.nbits = 0

    def _fill(self, need: int):
        while self.nbits < need:
            chunk = self.data[self.pos:self.pos + 8]
            if not chunk:
                raise FlacError("unexpected end of stream")
            self.acc = (self.acc << (8 * len(chunk))) | int.from_bytes(
                chunk, "big")
            self.nbits += 8 * len(chunk)
            self.pos += len(chunk)

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        if self.nbits < n:
            self._fill(n)
        self.nbits -= n
        val = self.acc >> self.nbits
        self.acc &= (1 << self.nbits) - 1
        return val

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if n and (v >> (n - 1)) else v

    def read_unary(self) -> int:
        count = 0
        while True:
            if self.nbits == 0:
                self._fill(1)
            if self.acc == 0:
                count += self.nbits
                self.nbits = 0
                continue
            top = self.acc.bit_length()
            count += self.nbits - top
            self.nbits = top - 1
            self.acc &= (1 << self.nbits) - 1
            return count

    def align_byte(self):
        self.read(self.nbits % 8)

    def byte_pos(self) -> int:
        return self.pos - self.nbits // 8


def _read_utf8_number(br: _BitReader) -> int:
    """Frame/sample number: UTF-8-style coding extended to 36 bits."""
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    n = 0
    mask = 0x40
    while b0 & mask:
        n += 1
        mask >>= 1
    if n == 0:
        raise FlacError("invalid UTF-8 coded number")
    val = b0 & (mask - 1)
    for _ in range(n):
        cont = br.read(8)
        if cont >> 6 != 0b10:
            raise FlacError("invalid UTF-8 continuation")
        val = (val << 6) | (cont & 0x3F)
    return val


_BLOCKSIZE_CODES = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                    13: 8192, 14: 16384, 15: 32768}
_SAMPLE_SIZE_CODES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}
_FIXED_COEFFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _decode_residual(br: _BitReader, blocksize: int, order: int) -> list:
    method = br.read(2)
    if method > 1:
        raise FlacError(f"reserved residual method {method}")
    pbits = 4 + method
    escape = (1 << pbits) - 1
    porder = br.read(4)
    nparts = 1 << porder
    if blocksize % nparts or blocksize >> porder <= order:
        raise FlacError("invalid partition order")
    plen = blocksize >> porder
    out = []
    read, read_signed, read_unary = br.read, br.read_signed, br.read_unary
    for part in range(nparts):
        n = plen - order if part == 0 else plen
        param = read(pbits)
        if param == escape:
            rbits = read(5)
            if rbits == 0:
                out.extend([0] * n)
            else:
                out.extend(read_signed(rbits) for _ in range(n))
        else:
            for _ in range(n):
                v = (read_unary() << param) | read(param)
                out.append((v >> 1) ^ -(v & 1))
    return out


def _decode_subframe(br: _BitReader, blocksize: int, bps: int) -> list:
    if br.read(1):
        raise FlacError("subframe padding bit set")
    sf_type = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = br.read_unary() + 1
        bps -= wasted

    if sf_type == 0:  # CONSTANT
        samples = [br.read_signed(bps)] * blocksize
    elif sf_type == 1:  # VERBATIM
        samples = [br.read_signed(bps) for _ in range(blocksize)]
    elif 8 <= sf_type <= 12:  # FIXED, order 0-4
        order = sf_type - 8
        samples = [br.read_signed(bps) for _ in range(order)]
        res = _decode_residual(br, blocksize, order)
        coef = _FIXED_COEFFS[order]
        for r in res:
            pred = 0
            for j, c in enumerate(coef):
                pred += c * samples[-1 - j]
            samples.append(r + pred)
    elif sf_type >= 32:  # LPC, order 1-32
        order = sf_type - 31
        samples = [br.read_signed(bps) for _ in range(order)]
        precision = br.read(4) + 1
        if precision == 16:
            raise FlacError("invalid LPC precision")
        shift = br.read_signed(5)
        if shift < 0:
            raise FlacError("negative LPC shift")
        qlp = [br.read_signed(precision) for _ in range(order)]
        res = _decode_residual(br, blocksize, order)
        for r in res:
            pred = 0
            for j in range(order):
                pred += qlp[j] * samples[-1 - j]
            samples.append(r + (pred >> shift))
    else:
        raise FlacError(f"reserved subframe type {sf_type}")

    if wasted:
        samples = [s << wasted for s in samples]
    return samples


def _decode_frame(br: _BitReader, info: dict):
    sync = br.read(14)
    if sync != 0x3FFE:
        raise FlacError(f"bad frame sync 0x{sync:04x}")
    if br.read(1):
        raise FlacError("reserved bit set in frame header")
    br.read(1)  # blocking strategy
    bs_code = br.read(4)
    sr_code = br.read(4)
    chan_code = br.read(4)
    ss_code = br.read(3)
    if br.read(1):
        raise FlacError("reserved bit set in frame header")
    _read_utf8_number(br)
    if bs_code == 0:
        raise FlacError("reserved blocksize code 0")
    elif bs_code == 6:
        blocksize = br.read(8) + 1
    elif bs_code == 7:
        blocksize = br.read(16) + 1
    else:
        blocksize = _BLOCKSIZE_CODES[bs_code]
    if sr_code == 12:
        br.read(8)
    elif sr_code in (13, 14):
        br.read(16)
    bps = info["bps"] if ss_code == 0 else _SAMPLE_SIZE_CODES[ss_code]
    br.read(8)  # header CRC-8

    if chan_code < 8:
        nchan = chan_code + 1
        chans = [_decode_subframe(br, blocksize, bps) for _ in range(nchan)]
    elif chan_code == 8:  # left/side
        left = _decode_subframe(br, blocksize, bps)
        side = _decode_subframe(br, blocksize, bps + 1)
        chans = [left, [l - s for l, s in zip(left, side)]]
    elif chan_code == 9:  # right/side
        side = _decode_subframe(br, blocksize, bps + 1)
        right = _decode_subframe(br, blocksize, bps)
        chans = [[r + s for r, s in zip(right, side)], right]
    elif chan_code == 10:  # mid/side
        mid = _decode_subframe(br, blocksize, bps)
        side = _decode_subframe(br, blocksize, bps + 1)
        left, right = [], []
        for m, s in zip(mid, side):
            m = (m << 1) | (s & 1)
            left.append((m + s) >> 1)
            right.append((m - s) >> 1)
        chans = [left, right]
    else:
        raise FlacError(f"reserved channel assignment {chan_code}")

    br.align_byte()
    br.read(16)  # frame CRC-16
    return chans


def read_flac(fname: str):
    """Decode a FLAC file -> (sample_rate, float32 [samples, channels] in
    [-1, 1)). Scaling matches int PCM -> float via /2^(bps-1) (the same
    convention soundfile/librosa use for 16-bit PCM)."""
    with open(fname, "rb") as f:
        data = f.read()
    if data[:4] != b"fLaC":
        raise FlacError("not a FLAC stream")

    pos = 4
    info = None
    while True:
        header = data[pos]
        btype = header & 0x7F
        length = int.from_bytes(data[pos + 1:pos + 4], "big")
        body = data[pos + 4:pos + 4 + length]
        pos += 4 + length
        if btype == 0:  # STREAMINFO
            br = _BitReader(body)
            br.read(16)  # min blocksize
            br.read(16)  # max blocksize
            br.read(24)  # min framesize
            br.read(24)  # max framesize
            info = {
                "sample_rate": br.read(20),
                "channels": br.read(3) + 1,
                "bps": br.read(5) + 1,
                "total_samples": br.read(36),
            }
        if header & 0x80:  # last-metadata-block flag
            break
    if info is None:
        raise FlacError("missing STREAMINFO")

    br = _BitReader(data, pos)
    total = info["total_samples"]
    nchan = info["channels"]
    out = [[] for _ in range(nchan)]
    while (total == 0 or len(out[0]) < total) and br.byte_pos() < len(data):
        chans = _decode_frame(br, info)
        if len(chans) != nchan:
            raise FlacError("channel count changed mid-stream")
        for c, samples in zip(out, chans):
            c.extend(samples)
    if total and len(out[0]) < total:
        raise FlacError("truncated stream")

    arr = np.array(out, dtype=np.int64).T
    if total:
        arr = arr[:total]
    scale = float(1 << (info["bps"] - 1))
    return info["sample_rate"], (arr / scale).astype(np.float32)
