// Native FLAC decoder of the port's audio I/O: the decode logic of the
// pure-Python decoder (voicefixer_tpu_torch/utils/flac.py) in C++, loaded
// with ctypes by voicefixer_tpu_torch/utils/flac_native.py and built at
// first use by voicefixer_tpu_torch/kernels/build.py
// (g++ -O3 -fPIC -shared -std=c++17).
//
// C ABI:
//   vf_flac_probe(data, len, &sr, &channels, &bps, &total)  -> 0 / -errcode
//   vf_flac_decode(data, len, out_int32, capacity_frames,
//                  &decoded_frames)                          -> 0 / -errcode
// out_int32 is interleaved [frame][channel], raw integer PCM (the caller
// scales by 2^(bps-1)).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int ERR_TRUNCATED = 1;
constexpr int ERR_BAD_MAGIC = 2;
constexpr int ERR_BAD_FRAME = 3;
constexpr int ERR_RESERVED = 4;
constexpr int ERR_NO_STREAMINFO = 5;
constexpr int ERR_CAPACITY = 6;
constexpr int ERR_CHANNELS = 7;

struct BitReader {
  const uint8_t* data;
  size_t len;
  size_t pos;        // next byte
  uint64_t acc = 0;  // MSB-first accumulator
  int nbits = 0;
  bool overrun = false;

  BitReader(const uint8_t* d, size_t l, size_t p = 0)
      : data(d), len(l), pos(p) {}

  inline void fill() {
    while (nbits <= 56 && pos < len) {
      acc = (acc << 8) | data[pos++];
      nbits += 8;
    }
  }

  inline uint64_t read(int n) {
    if (n == 0) return 0;
    if (nbits < n) {
      fill();
      if (nbits < n) {
        overrun = true;
        return 0;
      }
    }
    nbits -= n;
    uint64_t v = acc >> nbits;
    acc &= (nbits == 64) ? ~0ULL : ((1ULL << nbits) - 1);
    return v;
  }

  inline int64_t read_signed(int n) {
    uint64_t v = read(n);
    if (n && (v >> (n - 1))) return (int64_t)v - (1LL << n);
    return (int64_t)v;
  }

  inline int read_unary() {
    int count = 0;
    for (;;) {
      if (nbits == 0) {
        fill();
        if (nbits == 0) {
          overrun = true;
          return 0;
        }
      }
      if (acc == 0) {
        count += nbits;
        nbits = 0;
        continue;
      }
      int top = 64 - __builtin_clzll(acc);
      count += nbits - top;
      nbits = top - 1;
      acc &= (nbits == 64) ? ~0ULL : ((1ULL << nbits) - 1);
      return count;
    }
  }

  inline void align_byte() { read(nbits % 8); }
  inline size_t byte_pos() const { return pos - nbits / 8; }
};

int read_utf8_number(BitReader& br, uint64_t* out) {
  uint64_t b0 = br.read(8);
  if (b0 < 0x80) {
    *out = b0;
    return 0;
  }
  int n = 0;
  uint64_t mask = 0x40;
  while (b0 & mask) {
    n += 1;
    mask >>= 1;
  }
  if (n == 0) return -ERR_BAD_FRAME;
  uint64_t val = b0 & (mask - 1);
  for (int i = 0; i < n; i++) {
    uint64_t cont = br.read(8);
    if ((cont >> 6) != 0b10) return -ERR_BAD_FRAME;
    val = (val << 6) | (cont & 0x3F);
  }
  *out = val;
  return 0;
}

const int kBlocksizeCodes[16] = {0,   192,  576,  1152, 2304, 4608, -1, -2,
                                 256, 512,  1024, 2048, 4096, 8192,
                                 16384, 32768};
const int kSampleSizeCodes[8] = {0, 8, 12, 0, 16, 20, 24, 32};
const int kFixedCoeffs[5][4] = {
    {}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};

struct StreamInfo {
  int sample_rate = 0;
  int channels = 0;
  int bps = 0;
  uint64_t total_samples = 0;
};

int decode_residual(BitReader& br, int blocksize, int order,
                    std::vector<int64_t>& out) {
  int method = (int)br.read(2);
  if (method > 1) return -ERR_RESERVED;
  int pbits = 4 + method;
  uint64_t escape = (1ULL << pbits) - 1;
  int porder = (int)br.read(4);
  int nparts = 1 << porder;
  if (blocksize % nparts || (blocksize >> porder) <= order)
    return -ERR_BAD_FRAME;
  int plen = blocksize >> porder;
  for (int part = 0; part < nparts; part++) {
    int n = (part == 0) ? plen - order : plen;
    uint64_t param = br.read(pbits);
    if (param == escape) {
      int rbits = (int)br.read(5);
      if (rbits == 0) {
        for (int i = 0; i < n; i++) out.push_back(0);
      } else {
        for (int i = 0; i < n; i++) out.push_back(br.read_signed(rbits));
      }
    } else {
      for (int i = 0; i < n; i++) {
        uint64_t v = ((uint64_t)br.read_unary() << param) | br.read(param);
        out.push_back((int64_t)(v >> 1) ^ -(int64_t)(v & 1));
      }
    }
    if (br.overrun) return -ERR_TRUNCATED;
  }
  return 0;
}

int decode_subframe(BitReader& br, int blocksize, int bps,
                    std::vector<int64_t>& samples) {
  samples.clear();
  samples.reserve(blocksize);
  if (br.read(1)) return -ERR_BAD_FRAME;
  int sf_type = (int)br.read(6);
  int wasted = 0;
  if (br.read(1)) {
    wasted = br.read_unary() + 1;
    bps -= wasted;
  }

  if (sf_type == 0) {  // CONSTANT
    int64_t v = br.read_signed(bps);
    samples.assign(blocksize, v);
  } else if (sf_type == 1) {  // VERBATIM
    for (int i = 0; i < blocksize; i++)
      samples.push_back(br.read_signed(bps));
  } else if (sf_type >= 8 && sf_type <= 12) {  // FIXED order 0-4
    int order = sf_type - 8;
    for (int i = 0; i < order; i++) samples.push_back(br.read_signed(bps));
    std::vector<int64_t> res;
    int rc = decode_residual(br, blocksize, order, res);
    if (rc) return rc;
    const int* coef = kFixedCoeffs[order];
    for (int64_t r : res) {
      int64_t pred = 0;
      size_t sz = samples.size();
      for (int j = 0; j < order; j++) pred += coef[j] * samples[sz - 1 - j];
      samples.push_back(r + pred);
    }
  } else if (sf_type >= 32) {  // LPC order 1-32
    int order = sf_type - 31;
    for (int i = 0; i < order; i++) samples.push_back(br.read_signed(bps));
    int precision = (int)br.read(4) + 1;
    if (precision == 16) return -ERR_BAD_FRAME;  // code 15 is invalid
    int shift = (int)br.read_signed(5);
    if (shift < 0) return -ERR_BAD_FRAME;
    int64_t qlp[32];
    for (int i = 0; i < order; i++) qlp[i] = br.read_signed(precision);
    std::vector<int64_t> res;
    int rc = decode_residual(br, blocksize, order, res);
    if (rc) return rc;
    for (int64_t r : res) {
      int64_t pred = 0;
      size_t sz = samples.size();
      for (int j = 0; j < order; j++) pred += qlp[j] * samples[sz - 1 - j];
      samples.push_back(r + (pred >> shift));
    }
  } else {
    return -ERR_RESERVED;
  }

  if (wasted)
    for (auto& s : samples) s <<= wasted;
  if (br.overrun) return -ERR_TRUNCATED;
  return 0;
}

int decode_frame(BitReader& br, const StreamInfo& info,
                 std::vector<std::vector<int64_t>>& chans) {
  uint64_t sync = br.read(14);
  if (sync != 0x3FFE) return -ERR_BAD_FRAME;
  if (br.read(1)) return -ERR_BAD_FRAME;
  br.read(1);  // blocking strategy
  int bs_code = (int)br.read(4);
  int sr_code = (int)br.read(4);
  int chan_code = (int)br.read(4);
  int ss_code = (int)br.read(3);
  if (br.read(1)) return -ERR_BAD_FRAME;
  uint64_t ignored;
  int rc = read_utf8_number(br, &ignored);
  if (rc) return rc;
  int blocksize;
  if (bs_code == 0) return -ERR_RESERVED;
  else if (bs_code == 6) blocksize = (int)br.read(8) + 1;
  else if (bs_code == 7) blocksize = (int)br.read(16) + 1;
  else blocksize = kBlocksizeCodes[bs_code];
  if (sr_code == 12) br.read(8);
  else if (sr_code == 13 || sr_code == 14) br.read(16);
  int bps = (ss_code == 0) ? info.bps : kSampleSizeCodes[ss_code];
  if (bps == 0) return -ERR_RESERVED;
  br.read(8);  // header CRC-8

  chans.clear();
  if (chan_code < 8) {
    int nchan = chan_code + 1;
    chans.resize(nchan);
    for (int c = 0; c < nchan; c++) {
      rc = decode_subframe(br, blocksize, bps, chans[c]);
      if (rc) return rc;
    }
  } else if (chan_code == 8) {  // left/side
    chans.resize(2);
    std::vector<int64_t> side;
    rc = decode_subframe(br, blocksize, bps, chans[0]);
    if (rc) return rc;
    rc = decode_subframe(br, blocksize, bps + 1, side);
    if (rc) return rc;
    chans[1].resize(blocksize);
    for (int i = 0; i < blocksize; i++) chans[1][i] = chans[0][i] - side[i];
  } else if (chan_code == 9) {  // right/side
    chans.resize(2);
    std::vector<int64_t> side;
    rc = decode_subframe(br, blocksize, bps + 1, side);
    if (rc) return rc;
    rc = decode_subframe(br, blocksize, bps, chans[1]);
    if (rc) return rc;
    chans[0].resize(blocksize);
    for (int i = 0; i < blocksize; i++) chans[0][i] = chans[1][i] + side[i];
  } else if (chan_code == 10) {  // mid/side
    chans.resize(2);
    std::vector<int64_t> mid, side;
    rc = decode_subframe(br, blocksize, bps, mid);
    if (rc) return rc;
    rc = decode_subframe(br, blocksize, bps + 1, side);
    if (rc) return rc;
    chans[0].resize(blocksize);
    chans[1].resize(blocksize);
    for (int i = 0; i < blocksize; i++) {
      int64_t m = (mid[i] << 1) | (side[i] & 1);
      chans[0][i] = (m + side[i]) >> 1;
      chans[1][i] = (m - side[i]) >> 1;
    }
  } else {
    return -ERR_RESERVED;
  }

  br.align_byte();
  br.read(16);  // frame CRC-16
  if (br.overrun) return -ERR_TRUNCATED;
  return 0;
}

int parse_streaminfo(const uint8_t* data, size_t len, StreamInfo* info,
                     size_t* frames_start) {
  if (len < 4 || memcmp(data, "fLaC", 4) != 0) return -ERR_BAD_MAGIC;
  size_t pos = 4;
  bool have_info = false;
  for (;;) {
    if (pos + 4 > len) return -ERR_TRUNCATED;
    uint8_t header = data[pos];
    int btype = header & 0x7F;
    size_t length = ((size_t)data[pos + 1] << 16) |
                    ((size_t)data[pos + 2] << 8) | data[pos + 3];
    if (pos + 4 + length > len) return -ERR_TRUNCATED;
    if (btype == 0) {
      BitReader br(data + pos + 4, length);
      br.read(16); br.read(16); br.read(24); br.read(24);
      info->sample_rate = (int)br.read(20);
      info->channels = (int)br.read(3) + 1;
      info->bps = (int)br.read(5) + 1;
      info->total_samples = br.read(36);
      have_info = true;
    }
    pos += 4 + length;
    if (header & 0x80) break;
  }
  if (!have_info) return -ERR_NO_STREAMINFO;
  *frames_start = pos;
  return 0;
}

}  // namespace

extern "C" {

int vf_flac_probe(const uint8_t* data, int64_t len, int32_t* sample_rate,
                  int32_t* channels, int32_t* bps, int64_t* total_samples) {
  StreamInfo info;
  size_t start;
  int rc = parse_streaminfo(data, (size_t)len, &info, &start);
  if (rc) return rc;
  *sample_rate = info.sample_rate;
  *channels = info.channels;
  *bps = info.bps;
  *total_samples = (int64_t)info.total_samples;
  return 0;
}

// out: interleaved int32 [frame][channel], capacity in frames.
int vf_flac_decode(const uint8_t* data, int64_t len, int32_t* out,
                   int64_t capacity_frames, int64_t* decoded_frames) {
  StreamInfo info;
  size_t start;
  int rc = parse_streaminfo(data, (size_t)len, &info, &start);
  if (rc) return rc;

  BitReader br(data, (size_t)len, start);
  std::vector<std::vector<int64_t>> chans;
  int64_t written = 0;
  uint64_t total = info.total_samples;
  while ((total == 0 || (uint64_t)written < total) &&
         br.byte_pos() < (size_t)len) {
    rc = decode_frame(br, info, chans);
    if (rc) return rc;
    if ((int)chans.size() != info.channels) return -ERR_CHANNELS;
    int64_t bs = (int64_t)chans[0].size();
    if (total && (uint64_t)(written + bs) > total) bs = total - written;
    if (written + bs > capacity_frames) return -ERR_CAPACITY;
    for (int64_t i = 0; i < bs; i++)
      for (int c = 0; c < info.channels; c++)
        out[(written + i) * info.channels + c] = (int32_t)chans[c][i];
    written += bs;
  }
  if (total && (uint64_t)written < total) return -ERR_TRUNCATED;
  *decoded_frames = written;
  return 0;
}

}  // extern "C"
