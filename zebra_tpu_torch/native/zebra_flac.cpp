// Native FLAC decoder for the audio embedding path (the torch port's own copy
// of zebra_tpu/native/zebra_flac.cpp; the code below is unchanged).
//
// The reference decodes compressed audio via the symphonia crate
// (src/model/audio.rs:35-75); this is this repository's equivalent for FLAC —
// a from-scratch implementation of the FLAC bitstream (per the public
// format spec, RFC 9639): STREAMINFO, frame headers with all block-size /
// sample-rate / sample-size codes, UTF-8-coded frame numbers, CONSTANT /
// VERBATIM / FIXED(0-4) / LPC(1-32) subframes, Rice + Rice2 partitioned
// residuals with raw-bits escapes, wasted bits, and the four channel
// assignments (independent, left/side, right/side, mid/side). Frame CRC-8
// and CRC-16 are verified; a failed CRC aborts the decode (the Python
// caller falls back to `soundfile` when importable).
//
// Exposed as a tiny C ABI consumed via ctypes (native/flac.py):
//   zf_decode(data, len, &out, &nsamples, &channels, &rate, &bps) -> rc
//   zf_free(out)
// Output is interleaved int32, one entry per (frame, channel), scaled to
// the stream's bits-per-sample (the caller divides by 2^(bps-1)).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct BitReader {
  const uint8_t* d;
  size_t len;
  size_t byte = 0;
  int bit = 0;  // 0..7, MSB-first
  bool err = false;

  explicit BitReader(const uint8_t* data, size_t n) : d(data), len(n) {}

  bool eof() const { return byte >= len; }

  uint32_t read_bit() {
    if (byte >= len) {
      err = true;
      return 0;
    }
    uint32_t v = (d[byte] >> (7 - bit)) & 1u;
    if (++bit == 8) {
      bit = 0;
      ++byte;
    }
    return v;
  }

  uint64_t read_bits(int n) {  // n <= 64
    uint64_t v = 0;
    // byte-at-a-time fast path when aligned
    while (n >= 8 && bit == 0) {
      if (byte >= len) {
        err = true;
        return 0;
      }
      v = (v << 8) | d[byte++];
      n -= 8;
    }
    for (int i = 0; i < n; ++i) v = (v << 1) | read_bit();
    return v;
  }

  int64_t read_signed(int n) {
    if (n == 0) return 0;
    uint64_t v = read_bits(n);
    uint64_t sign = 1ull << (n - 1);
    return (v & sign) ? (int64_t)(v | ~((sign << 1) - 1)) : (int64_t)v;
  }

  uint32_t read_unary() {  // count of 0 bits before the terminating 1
    uint32_t q = 0;
    for (;;) {
      if (err || byte >= len) {
        err = true;
        return q;
      }
      // fast path: scan whole bytes of zeros
      if (bit == 0 && d[byte] == 0) {
        q += 8;
        ++byte;
        continue;
      }
      if (read_bit()) return q;
      ++q;
      if (q > 1u << 24) {  // corrupt stream guard
        err = true;
        return q;
      }
    }
  }

  void align() {
    if (bit) {
      bit = 0;
      ++byte;
    }
  }
};

uint8_t crc8(const uint8_t* d, size_t n) {  // poly x^8+x^2+x+1 (0x07)
  uint8_t c = 0;
  for (size_t i = 0; i < n; ++i) {
    c ^= d[i];
    for (int b = 0; b < 8; ++b) c = (c & 0x80) ? (uint8_t)((c << 1) ^ 0x07) : (uint8_t)(c << 1);
  }
  return c;
}

uint16_t crc16(const uint8_t* d, size_t n) {  // poly 0x8005, init 0
  uint16_t c = 0;
  for (size_t i = 0; i < n; ++i) {
    c ^= (uint16_t)d[i] << 8;
    for (int b = 0; b < 8; ++b)
      c = (c & 0x8000) ? (uint16_t)((c << 1) ^ 0x8005) : (uint16_t)(c << 1);
  }
  return c;
}

struct StreamInfo {
  uint32_t sample_rate = 0;
  uint32_t channels = 0;
  uint32_t bps = 0;
  uint64_t total_samples = 0;  // 0 = unknown
};

// Decodes one subframe into out[0..blocksize) at effective bit depth `sbps`.
bool decode_subframe(BitReader& br, uint32_t blocksize, int sbps,
                     std::vector<int64_t>& out) {
  if (br.read_bit() != 0) return false;  // mandatory zero pad bit
  uint32_t type = (uint32_t)br.read_bits(6);
  int wasted = 0;
  if (br.read_bit()) wasted = (int)br.read_unary() + 1;
  if (br.err || wasted >= sbps) return false;
  int ebps = sbps - wasted;

  out.resize(blocksize);

  int order = -1;
  bool is_lpc = false;
  if (type == 0) {  // CONSTANT
    int64_t v = br.read_signed(ebps);
    for (uint32_t i = 0; i < blocksize; ++i) out[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (uint32_t i = 0; i < blocksize; ++i) out[i] = br.read_signed(ebps);
  } else if ((type & 0x38u) == 0x08u) {  // FIXED: 001xxx
    order = (int)(type & 0x07u);
    if (order > 4) return false;
  } else if (type & 0x20u) {  // LPC: 1xxxxx
    order = (int)(type & 0x1Fu) + 1;
    is_lpc = true;
  } else {
    return false;  // reserved
  }

  if (order >= 0) {
    if ((uint32_t)order > blocksize) return false;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(ebps);

    int shift = 0, precision = 0;
    std::vector<int64_t> coefs;
    if (is_lpc) {
      precision = (int)br.read_bits(4) + 1;
      if (precision == 16) return false;  // 1111 is invalid
      shift = (int)br.read_signed(5);
      if (shift < 0) return false;  // negative shifts are unused/invalid
      coefs.resize(order);
      for (int i = 0; i < order; ++i) coefs[i] = br.read_signed(precision);
    }

    // partitioned residual
    uint32_t method = (uint32_t)br.read_bits(2);
    if (method > 1) return false;
    int pbits = method == 0 ? 4 : 5;
    uint32_t escape = method == 0 ? 0xFu : 0x1Fu;
    uint32_t po = (uint32_t)br.read_bits(4);
    uint32_t nparts = 1u << po;
    if ((blocksize >> po) << po != blocksize) return false;
    if (blocksize >> po <= (uint32_t)order) return false;
    uint32_t idx = order;
    for (uint32_t p = 0; p < nparts; ++p) {
      uint32_t count = (blocksize >> po) - (p == 0 ? (uint32_t)order : 0);
      uint32_t param = (uint32_t)br.read_bits(pbits);
      if (param == escape) {
        int raw = (int)br.read_bits(5);
        for (uint32_t i = 0; i < count; ++i) out[idx++] = br.read_signed(raw);
      } else {
        for (uint32_t i = 0; i < count; ++i) {
          uint32_t q = br.read_unary();
          uint64_t lo = br.read_bits((int)param);
          uint64_t u = ((uint64_t)q << param) | lo;
          out[idx++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);  // unzigzag
        }
      }
      if (br.err) return false;
    }

    // predictor reconstruction (residual currently in out[order..))
    if (is_lpc) {
      for (uint32_t i = order; i < blocksize; ++i) {
        int64_t acc = 0;
        for (int j = 0; j < order; ++j) acc += coefs[j] * out[i - 1 - j];
        out[i] += acc >> shift;
      }
    } else {
      switch (order) {
        case 0:
          break;
        case 1:
          for (uint32_t i = 1; i < blocksize; ++i) out[i] += out[i - 1];
          break;
        case 2:
          for (uint32_t i = 2; i < blocksize; ++i)
            out[i] += 2 * out[i - 1] - out[i - 2];
          break;
        case 3:
          for (uint32_t i = 3; i < blocksize; ++i)
            out[i] += 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3];
          break;
        case 4:
          for (uint32_t i = 4; i < blocksize; ++i)
            out[i] += 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3] - out[i - 4];
          break;
      }
    }
  }

  if (wasted)
    for (uint32_t i = 0; i < blocksize; ++i) out[i] <<= wasted;
  return !br.err;
}

// UTF-8-style coded number, extended to 36 bits (7 bytes).
bool read_utf8_num(BitReader& br, uint64_t* out) {
  uint32_t b0 = (uint32_t)br.read_bits(8);
  if (br.err) return false;
  int extra;
  uint64_t v;
  if ((b0 & 0x80u) == 0) {
    *out = b0;
    return true;
  } else if ((b0 & 0xE0u) == 0xC0u) {
    extra = 1;
    v = b0 & 0x1Fu;
  } else if ((b0 & 0xF0u) == 0xE0u) {
    extra = 2;
    v = b0 & 0x0Fu;
  } else if ((b0 & 0xF8u) == 0xF0u) {
    extra = 3;
    v = b0 & 0x07u;
  } else if ((b0 & 0xFCu) == 0xF8u) {
    extra = 4;
    v = b0 & 0x03u;
  } else if ((b0 & 0xFEu) == 0xFCu) {
    extra = 5;
    v = b0 & 0x01u;
  } else if (b0 == 0xFEu) {
    extra = 6;
    v = 0;
  } else {
    return false;
  }
  for (int i = 0; i < extra; ++i) {
    uint32_t b = (uint32_t)br.read_bits(8);
    if (br.err || (b & 0xC0u) != 0x80u) return false;
    v = (v << 6) | (b & 0x3Fu);
  }
  *out = v;
  return true;
}

const uint32_t kRates[12] = {0,     88200, 176400, 192000, 8000,  16000,
                             22050, 24000, 32000,  44100,  48000, 96000};

}  // namespace

extern "C" {

// rc: 0 ok; -1 not flac; -2 corrupt/unsupported; -3 alloc failure
int zf_decode(const uint8_t* data, uint64_t len, int32_t** out_samples,
              uint64_t* out_nsamples, uint32_t* out_channels,
              uint32_t* out_rate, uint32_t* out_bps) {
  *out_samples = nullptr;
  *out_nsamples = 0;
  if (len < 42 || memcmp(data, "fLaC", 4) != 0) return -1;

  size_t pos = 4;
  StreamInfo si;
  bool have_si = false;
  for (;;) {  // metadata blocks
    if (pos + 4 > len) return -2;
    bool last = (data[pos] & 0x80u) != 0;
    uint32_t btype = data[pos] & 0x7Fu;
    uint32_t blen =
        ((uint32_t)data[pos + 1] << 16) | ((uint32_t)data[pos + 2] << 8) | data[pos + 3];
    pos += 4;
    if (pos + blen > len) return -2;
    if (btype == 0) {  // STREAMINFO
      if (blen < 34) return -2;
      const uint8_t* b = data + pos;
      si.sample_rate = ((uint32_t)b[10] << 12) | ((uint32_t)b[11] << 4) | (b[12] >> 4);
      si.channels = ((b[12] >> 1) & 0x7u) + 1;
      si.bps = (((b[12] & 1u) << 4) | (b[13] >> 4)) + 1;
      si.total_samples = ((uint64_t)(b[13] & 0x0Fu) << 32) | ((uint64_t)b[14] << 24) |
                         ((uint64_t)b[15] << 16) | ((uint64_t)b[16] << 8) | b[17];
      have_si = true;
    }
    pos += blen;
    if (last) break;
  }
  if (!have_si || si.sample_rate == 0 || si.channels == 0 || si.channels > 8 ||
      si.bps < 4 || si.bps > 32)
    return -2;

  std::vector<int32_t> pcm;
  if (si.total_samples) {
    if (si.total_samples * si.channels > (1ull << 31)) return -2;  // >8GB guard
    pcm.reserve((size_t)(si.total_samples * si.channels));
  }

  BitReader br(data, len);
  br.byte = pos;
  std::vector<std::vector<int64_t>> ch(si.channels);

  while (br.byte < len) {
    size_t frame_start = br.byte;
    uint32_t sync = (uint32_t)br.read_bits(14);
    if (br.err) break;
    if (sync != 0x3FFEu) return -2;       // 0b11111111111110
    if (br.read_bits(1) != 0) return -2;  // reserved bit
    uint32_t blocking = (uint32_t)br.read_bits(1);
    (void)blocking;
    uint32_t bs_code = (uint32_t)br.read_bits(4);
    uint32_t sr_code = (uint32_t)br.read_bits(4);
    uint32_t ch_code = (uint32_t)br.read_bits(4);
    uint32_t ss_code = (uint32_t)br.read_bits(3);
    if (br.read_bits(1) != 0) return -2;  // reserved bit
    uint64_t frame_num;
    if (!read_utf8_num(br, &frame_num)) return -2;

    uint32_t blocksize;
    if (bs_code == 0)
      return -2;
    else if (bs_code == 1)
      blocksize = 192;
    else if (bs_code <= 5)
      blocksize = 576u << (bs_code - 2);
    else if (bs_code == 6)
      blocksize = (uint32_t)br.read_bits(8) + 1;
    else if (bs_code == 7)
      blocksize = (uint32_t)br.read_bits(16) + 1;
    else
      blocksize = 256u << (bs_code - 8);

    uint32_t rate = si.sample_rate;
    if (sr_code < 12) {
      if (sr_code) rate = kRates[sr_code];
    } else if (sr_code == 12)
      rate = (uint32_t)br.read_bits(8) * 1000;
    else if (sr_code == 13)
      rate = (uint32_t)br.read_bits(16);
    else if (sr_code == 14)
      rate = (uint32_t)br.read_bits(16) * 10;
    else
      return -2;
    (void)rate;

    uint32_t nch;
    int side = -1;  // which channel carries the +1-bit side signal
    if (ch_code < 8) {
      nch = ch_code + 1;
    } else if (ch_code == 8) {  // left/side
      nch = 2;
      side = 1;
    } else if (ch_code == 9) {  // right/side
      nch = 2;
      side = 0;
    } else if (ch_code == 10) {  // mid/side
      nch = 2;
      side = 1;
    } else {
      return -2;
    }
    if (nch != si.channels) return -2;

    int bps;
    switch (ss_code) {
      case 0: bps = (int)si.bps; break;
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      case 7: bps = 32; break;
      default: return -2;
    }

    // header CRC-8 covers everything up to (not including) the CRC byte
    size_t hdr_end = br.byte;  // bit must be 0 here (header is byte-aligned)
    if (br.bit != 0) return -2;
    uint8_t want8 = (uint8_t)br.read_bits(8);
    if (crc8(data + frame_start, hdr_end - frame_start) != want8) return -2;

    for (uint32_t c = 0; c < nch; ++c) {
      int sbps = bps + ((int)c == side ? 1 : 0);
      if (!decode_subframe(br, blocksize, sbps, ch[c])) return -2;
    }
    br.align();
    size_t body_end = br.byte;
    uint16_t want16 = (uint16_t)br.read_bits(16);
    if (br.err) return -2;
    if (crc16(data + frame_start, body_end - frame_start) != want16) return -2;

    // undo inter-channel decorrelation
    if (ch_code == 8) {  // left/side: side = left - right
      for (uint32_t i = 0; i < blocksize; ++i) ch[1][i] = ch[0][i] - ch[1][i];
    } else if (ch_code == 9) {  // right/side: side = left - right (ch0=side)
      for (uint32_t i = 0; i < blocksize; ++i) {
        int64_t s = ch[0][i], r = ch[1][i];
        ch[0][i] = r + s;
      }
    } else if (ch_code == 10) {  // mid/side
      for (uint32_t i = 0; i < blocksize; ++i) {
        int64_t mid = ch[0][i], s = ch[1][i];
        int64_t sum = (mid << 1) | (s & 1);
        ch[0][i] = (sum + s) >> 1;
        ch[1][i] = (sum - s) >> 1;
      }
    }

    size_t base = pcm.size();
    pcm.resize(base + (size_t)blocksize * nch);
    for (uint32_t i = 0; i < blocksize; ++i)
      for (uint32_t c = 0; c < nch; ++c)
        pcm[base + (size_t)i * nch + c] = (int32_t)ch[c][i];

    if (si.total_samples && pcm.size() >= si.total_samples * si.channels) break;
  }

  if (pcm.empty()) return -2;
  if (si.total_samples && pcm.size() > si.total_samples * si.channels)
    pcm.resize((size_t)(si.total_samples * si.channels));  // trim final padding

  int32_t* buf = (int32_t*)malloc(pcm.size() * sizeof(int32_t));
  if (!buf) return -3;
  memcpy(buf, pcm.data(), pcm.size() * sizeof(int32_t));
  *out_samples = buf;
  *out_nsamples = pcm.size() / si.channels;
  *out_channels = si.channels;
  *out_rate = si.sample_rate;
  *out_bps = si.bps;
  return 0;
}

void zf_free(int32_t* p) { free(p); }

}  // extern "C"
