// JPEG decoder with a plain C interface, equal pixel for pixel to
// libjpeg-turbo 3.x's default decompression (the library cv2 bundles):
// the islow integer IDCT with its range-limit table, libjpeg's "fancy"
// triangle upsamplers (h2v1, h2v2, h1v2) and plain replication elsewhere,
// and the fixed-point YCbCr -> RGB and RGB -> gray tables.
//
// Takes Huffman-coded 8-bit frames: SOF0 / SOF1 (sequential, interleaved or
// not) and SOF2 (progressive: spectral selection, successive approximation,
// EOB runs); 1 or 3 components, sampling factors 1-4; restart intervals;
// DHT / DQT between scans (each component keeps the quantisation table it
// had at its first scan, as libjpeg latches it); the standard Huffman
// tables where a scan names one never defined; JFIF and Adobe APP14
// (transform 0: RGB stored as is).
//
// Refused, with an error naming the marker: arithmetic coding (SOF9-SOF11,
// SOF13-SOF15, DAC), lossless (SOF3) and hierarchical (SOF5-SOF7, DHP, EXP)
// frames, precision other than 8 bits, 2 or 4 components, and a stream
// that is truncated or corrupt (libjpeg warns there and fills the missing
// blocks). A progressive file whose scans leave bits of the first nine AC
// coefficients missing is refused too: libjpeg block-smooths such a file,
// and a complete file decodes unsmoothed, as here.
//
// Interface (Python binds it with ctypes, spinnerf_tpu_torch/data/jpeg.py):
//   jd_header(buf, len, hwc[3], err, errlen)  -> 0, or -1 with a message
//   jd_decode(buf, len, channels, out, outlen, err, errlen) -> 0 / -1
// `channels` 3 gives RGB [H, W, 3] (cv2's colour read, channel order RGB),
// 1 gives gray [H, W] (cv2's grayscale read: the Y component of a YCbCr
// file, libjpeg's luma of an RGB one).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct JpegError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError{msg}; }

// zigzag position -> natural position; 16 extra entries catch a run that
// overshoots the block in corrupt data, as libjpeg's table does
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

std::string hex2(int m) {
  char b[8];
  std::snprintf(b, sizeof b, "0x%02X", m & 0xFF);
  return b;
}

std::string marker_name(int m) {
  static const char* sof[16] = {"SOF0", "SOF1", "SOF2", "SOF3", "DHT",
                                "SOF5", "SOF6", "SOF7", "JPG",  "SOF9",
                                "SOF10", "SOF11", "DAC", "SOF13", "SOF14",
                                "SOF15"};
  if (m >= 0xC0 && m <= 0xCF) return sof[m - 0xC0];
  if (m >= 0xD0 && m <= 0xD7) return "RST" + std::to_string(m - 0xD0);
  if (m >= 0xE0 && m <= 0xEF) return "APP" + std::to_string(m - 0xE0);
  switch (m) {
    case 0xD8: return "SOI";
    case 0xD9: return "EOI";
    case 0xDA: return "SOS";
    case 0xDB: return "DQT";
    case 0xDC: return "DNL";
    case 0xDD: return "DRI";
    case 0xDE: return "DHP";
    case 0xDF: return "EXP";
    case 0xFE: return "COM";
    default: return "marker " + hex2(m);
  }
}

// Annex K.3's tables, which libjpeg takes for a scan's table 0 or 1 when
// the file defines none (Motion-JPEG frames omit them)
const uint8_t kStdDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1,
                                   1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kStdDcChrBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1,
                                   1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3,
                                   5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kStdAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kStdAcChrBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4,
                                   7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kStdAcChrVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffSpec {  // a table as DHT defines it
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
};

struct Huff {  // jdhuff.c's derived table
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t look[512];  // 9-bit lookahead: (length << 8) | symbol, 0 = miss

  // jpeg_make_d_derived_tbl, with its validation
  void build(const HuffSpec& s, bool dc) {
    int huffsize[257];
    uint32_t huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++) {
      int n = s.bits[l];
      if (p + n > 256) fail("bad Huffman table (DHT)");
      while (n--) huffsize[p++] = l;
    }
    huffsize[p] = 0;
    int nsym = p;
    uint32_t code = 0;
    int si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1u << si)) fail("bad Huffman table (DHT)");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (s.bits[l]) {
        valoffset[l] = p - static_cast<int32_t>(huffcode[p]);
        p += s.bits[l];
        maxcode[l] = static_cast<int32_t>(huffcode[p - 1]);
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    std::memcpy(vals, s.vals, 256);
    std::memset(look, 0, sizeof look);
    p = 0;
    for (int l = 1; l <= 9; l++) {
      for (int i = 1; i <= s.bits[l]; i++, p++) {
        int lookbits = static_cast<int>(huffcode[p]) << (9 - l);
        for (int c = 0; c < (1 << (9 - l)); c++)
          look[lookbits + c] = static_cast<uint16_t>((l << 8) | s.vals[p]);
      }
    }
    if (dc) {
      for (int i = 0; i < nsym; i++)
        if (s.vals[i] > 15) fail("bad Huffman table (DHT): DC symbol > 15");
    }
  }
};

// The entropy-coded bytes of a scan, read MSB first with FF00 unstuffed.
// At a marker (or the end of the file) no further bytes enter the buffer;
// a decode that needs bits past them is a truncated or corrupt stream.
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;  // real bits at the top
  int n = 0;
  bool stop = false;  // reached a marker or the end

  void fill() {
    while (n <= 56 && !stop) {
      if (p >= end) {
        stop = true;
        break;
      }
      unsigned c = *p;
      if (c == 0xFF) {
        const uint8_t* q = p + 1;
        while (q < end && *q == 0xFF) q++;
        if (q < end && *q == 0) {
          p = q + 1;
        } else {  // a marker: leave p on its last FF
          p = q - 1;
          stop = true;
          break;
        }
      } else {
        p++;
      }
      acc |= static_cast<uint64_t>(c) << (56 - n);
      n += 8;
    }
  }
  [[noreturn]] void starve() const {
    if (p >= end) fail("truncated: the data ends inside a scan");
    fail("corrupt data: a scan's data ends before its last block (" +
         marker_name(p + 1 < end ? p[1] : 0) + " follows)");
  }
  void consume(int k) {
    if (k > n) starve();
    acc <<= k;
    n -= k;
  }
  int get(int k) {  // k in 1..16
    if (n < k) fill();
    int v = static_cast<int>(acc >> (64 - k));
    consume(k);
    return v;
  }
  int bit() { return get(1); }
  int decode(const Huff& h) {
    if (n < 16) fill();
    unsigned peek = static_cast<unsigned>(acc >> 48);
    unsigned e = h.look[peek >> 7];
    if (e) {
      consume(static_cast<int>(e >> 8));
      return static_cast<int>(e & 0xFF);
    }
    for (int l = 10; l <= 16; l++) {
      int32_t code = static_cast<int32_t>(peek >> (16 - l));
      if (code <= h.maxcode[l]) {
        consume(l);
        return h.vals[(code + h.valoffset[l]) & 0xFF];
      }
    }
    if (n < 16 && stop) starve();
    fail("corrupt data: a Huffman code matches no table entry");
  }
  // discard the buffered bits; leave p on the next marker's code byte
  int next_marker() {
    acc = 0;
    n = 0;
    stop = false;
    while (p < end && *p != 0xFF) p++;  // extraneous bytes: libjpeg warns
    while (p < end && *p == 0xFF) p++;
    if (p >= end) fail("truncated: the file ends without EOI");
    return *p++;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v + static_cast<int>((~0u << s) + 1) : v;
}

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;    // blocks that hold image samples
  int bwp = 0, bhp = 0;  // blocks allocated: whole interleaved MCUs
  int dw = 0, dh = 0;    // samples (libjpeg's downsampled width / height)
  std::vector<int16_t> coef;
  int16_t q[64] = {};  // latched at the component's first scan
  bool latched = false;
  bool coded = false;
  int coef_bits[64];
  int pred = 0;
  int dc_tbl = 0, ac_tbl = 0;
};

enum class Space { kGray, kYCbCr, kRGB };

struct Decoder {
  const uint8_t* buf;
  size_t len;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0;
  bool progressive = false;
  bool have_sof = false, seen_sos = false;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  Space space = Space::kYCbCr;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  HuffSpec dc_spec[4], ac_spec[4];
  std::vector<Comp> comps;

  Decoder(const uint8_t* b, size_t n) : buf(b), len(n) {}

  int byte() {
    if (pos >= len) fail("truncated: the file ends inside a marker segment");
    return buf[pos++];
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }
  int next_marker() {
    while (pos < len && buf[pos] != 0xFF) pos++;
    for (;;) {
      while (pos < len && buf[pos] == 0xFF) pos++;
      if (pos >= len) fail("truncated: the file ends without EOI");
      int c = buf[pos++];
      if (c != 0) return c;
      while (pos < len && buf[pos] != 0xFF) pos++;  // FF00 outside a scan
    }
  }
  size_t segment(int m) {  // returns the segment's end; pos after length
    int l = word();
    if (l < 2) fail("bad length in " + marker_name(m));
    size_t e = pos + static_cast<size_t>(l) - 2;
    if (e > len) fail("truncated: the file ends inside " + marker_name(m));
    return e;
  }

  // Reads markers until the first SOS (header_only) or until EOI,
  // decoding every scan on the way.
  void run(bool header_only) {
    if (len < 2 || buf[0] != 0xFF || buf[1] != 0xD8)
      fail("not a JPEG file (no SOI)");
    pos = 2;
    for (;;) {
      int m = next_marker();
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2:
          sof(m);
          break;
        case 0xC3: fail("SOF3 (lossless JPEG) is not supported");
        case 0xC5: case 0xC6: case 0xC7:
          fail(marker_name(m) + " (hierarchical JPEG) is not supported");
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          fail(marker_name(m) + " (arithmetic coding) is not supported");
        case 0xCC: fail("DAC (arithmetic coding) is not supported");
        case 0xDE: case 0xDF:
          fail(marker_name(m) + " (hierarchical JPEG) is not supported");
        case 0xC4: dht(); break;
        case 0xDB: dqt(); break;
        case 0xDD: {
          size_t e = segment(m);
          if (e - pos != 2) fail("bad length in DRI");
          restart_interval = word();
          break;
        }
        case 0xDA:
          if (!have_sof) fail("SOS before SOF");
          if (header_only) return;
          sos();
          break;
        case 0xD9:
          if (!seen_sos) fail("truncated: EOI before the first scan");
          return;
        case 0xD8: fail("a second SOI");
        case 0x01: case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4:
        case 0xD5: case 0xD6: case 0xD7:
          break;  // parameterless, ignored as libjpeg does
        default:
          if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xDC) {
            size_t e = segment(m);
            if (m == 0xE0 && e - pos >= 14 && !seen_sos &&
                std::memcmp(buf + pos, "JFIF\0", 5) == 0)
              jfif = true;
            if (m == 0xEE && e - pos >= 12 && !seen_sos &&
                std::memcmp(buf + pos, "Adobe", 5) == 0) {
              adobe = true;
              adobe_transform = buf[pos + 11];
            }
            pos = e;
          } else {
            fail("unsupported " + marker_name(m));
          }
      }
    }
  }

  void sof(int m) {
    if (have_sof) fail("a second SOF");
    size_t e = segment(m);
    int precision = byte();
    height = word();
    width = word();
    ncomp = byte();
    if (precision != 8)
      fail(std::to_string(precision) + "-bit precision (" + marker_name(m) +
           ") is not supported");
    if (height == 0)
      fail("height 0 (" + marker_name(m) + "; a DNL height) is not supported");
    if (width == 0) fail("width 0 in " + marker_name(m));
    if (ncomp != 1 && ncomp != 3)
      fail(std::to_string(ncomp) + " components (" + marker_name(m) +
           (ncomp == 4 ? "; CMYK / YCCK" : "") + ") are not supported");
    if (e - pos != static_cast<size_t>(3 * ncomp))
      fail("bad length in " + marker_name(m));
    comps.resize(ncomp);
    for (int i = 0; i < ncomp; i++) {
      Comp& c = comps[i];
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        fail("bad sampling factors in " + marker_name(m));
      if (c.tq > 3) fail("bad quantisation table index in " + marker_name(m));
      for (int j = 0; j < i; j++)
        if (comps[j].id == c.id)
          fail("two components share an id in " + marker_name(m));
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    progressive = m == 0xC2;
    mcux = (width + hmax * 8 - 1) / (hmax * 8);
    mcuy = (height + vmax * 8 - 1) / (vmax * 8);
    for (Comp& c : comps) {
      c.dw = static_cast<int>((static_cast<int64_t>(width) * c.h + hmax - 1) /
                              hmax);
      c.dh = static_cast<int>((static_cast<int64_t>(height) * c.v + vmax - 1) /
                              vmax);
      c.bw = (c.dw + 7) / 8;
      c.bh = (c.dh + 7) / 8;
      c.bwp = mcux * c.h;
      c.bhp = mcuy * c.v;
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
    }
    have_sof = true;
  }

  void dht() {
    size_t e = segment(0xC4);
    int64_t length = static_cast<int64_t>(e - pos);
    while (length > 16) {
      int index = byte();
      uint8_t bits[17] = {};
      int count = 0;
      for (int i = 1; i <= 16; i++) {
        bits[i] = static_cast<uint8_t>(byte());
        count += bits[i];
      }
      length -= 17;
      if (count > 256 || count > length) fail("bad Huffman table (DHT)");
      HuffSpec s;
      s.defined = true;
      std::memcpy(s.bits, bits, 17);
      for (int i = 0; i < count; i++) s.vals[i] = static_cast<uint8_t>(byte());
      length -= count;
      bool ac = index & 0x10;
      if (ac) index -= 0x10;
      if (index < 0 || index > 3)
        fail("bad Huffman table index in DHT: " + std::to_string(index));
      (ac ? ac_spec : dc_spec)[index] = s;
    }
    if (length != 0) fail("bad length in DHT");
  }

  void dqt() {
    size_t e = segment(0xDB);
    int64_t length = static_cast<int64_t>(e - pos);
    while (length > 0) {
      int n = byte();
      int prec = n >> 4;
      n &= 15;
      if (n > 3) fail("bad quantisation table index in DQT");
      length -= 1 + 64 * (prec ? 2 : 1);
      if (length < 0) fail("bad length in DQT");
      for (int i = 0; i < 64; i++)
        qt[n][kNatural[i]] = static_cast<uint16_t>(prec ? word() : byte());
      qt_defined[n] = true;
    }
  }

  void decide_space() {
    if (ncomp == 1) {
      space = Space::kGray;
    } else if (jfif) {
      space = Space::kYCbCr;
    } else if (adobe) {
      space = adobe_transform == 0 ? Space::kRGB : Space::kYCbCr;
    } else if (comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66) {
      space = Space::kRGB;  // 'R', 'G', 'B'
    } else {
      space = Space::kYCbCr;
    }
  }

  void sos() {
    size_t e = segment(0xDA);
    int ns = byte();
    if (ns < 1 || ns > 4 || e - pos != static_cast<size_t>(2 * ns + 3))
      fail("bad SOS header");
    std::vector<int> sc;
    for (int i = 0; i < ns; i++) {
      int id = byte(), t = byte();
      int ci = -1;
      for (int j = 0; j < ncomp; j++)
        if (comps[j].id == id) ci = j;
      if (ci < 0) fail("SOS names an unknown component");
      for (int j : sc)
        if (j == ci) fail("SOS names a component twice");
      comps[ci].dc_tbl = t >> 4;
      comps[ci].ac_tbl = t & 15;
      if (comps[ci].dc_tbl > 3 || comps[ci].ac_tbl > 3)
        fail("bad Huffman table index in SOS");
      sc.push_back(ci);
    }
    int ss = byte(), se = byte(), a = byte();
    int ah = a >> 4, al = a & 15;
    if (!seen_sos) decide_space();
    seen_sos = true;
    if (ns > 1) {
      int blocks = 0;
      for (int ci : sc) blocks += comps[ci].h * comps[ci].v;
      if (blocks > 10) fail("an MCU of more than 10 blocks");
    }
    for (int ci : sc) {  // latch_quant_tables
      Comp& c = comps[ci];
      if (!c.latched) {
        if (!qt_defined[c.tq]) fail("a scan uses an undefined DQT table");
        for (int k = 0; k < 64; k++) c.q[k] = static_cast<int16_t>(qt[c.tq][k]);
        c.latched = true;
      }
      if (c.coef.empty())
        c.coef.assign(static_cast<size_t>(c.bwp) * c.bhp * 64, 0);
    }
    if (progressive) {
      check_progression(sc, ss, se, ah, al);
    } else {
      if (ss != 0 || se != 63 || ah != 0 || al != 0)
        fail("corrupt data: a sequential scan with progressive parameters");
      for (int ci : sc) {
        if (comps[ci].coded) fail("corrupt data: a component in two scans");
        comps[ci].coded = true;
      }
    }
    decode_scan(sc, ss, se, ah, al);
  }

  void check_progression(const std::vector<int>& sc, int ss, int se, int ah,
                         int al) {
    bool bad = false;
    if (ss == 0) {
      if (se != 0) bad = true;
    } else {
      if (ss > se || se > 63) bad = true;
      if (sc.size() != 1) bad = true;
    }
    if (ah != 0 && al != ah - 1) bad = true;
    if (al > 13) bad = true;
    if (bad) fail("corrupt data: bad progressive scan parameters");
    for (int ci : sc) {
      Comp& c = comps[ci];
      if (ss > 0 && c.coef_bits[0] < 0)
        fail("corrupt data: an AC scan before the component's DC scan");
      for (int k = ss; k <= se; k++) {
        int expected = c.coef_bits[k] < 0 ? 0 : c.coef_bits[k];
        if (ah != expected)
          fail("corrupt data: scans out of progression order");
        c.coef_bits[k] = al;
      }
      c.coded = true;
    }
  }

  Huff table(bool dc, int i) {
    HuffSpec& s = (dc ? dc_spec : ac_spec)[i];
    Huff h;
    if (s.defined) {
      h.build(s, dc);
      return h;
    }
    if (i > 1) fail("a scan uses an undefined DHT table");
    HuffSpec std_spec;
    if (dc) {
      std::memcpy(std_spec.bits, i ? kStdDcChrBits : kStdDcLumBits, 17);
      std::memcpy(std_spec.vals, kStdDcVals, 12);
    } else {
      std::memcpy(std_spec.bits, i ? kStdAcChrBits : kStdAcLumBits, 17);
      std::memcpy(std_spec.vals, i ? kStdAcChrVals : kStdAcLumVals, 162);
    }
    h.build(std_spec, dc);
    return h;
  }

  void decode_scan(const std::vector<int>& sc, int ss, int se, int ah,
                   int al) {
    enum { kSeq, kDcFirst, kDcRefine, kAcFirst, kAcRefine } mode;
    if (!progressive)
      mode = kSeq;
    else if (ss == 0)
      mode = ah ? kDcRefine : kDcFirst;
    else
      mode = ah ? kAcRefine : kAcFirst;
    int nsc = static_cast<int>(sc.size());
    std::vector<Huff> dct(nsc), act(nsc);
    for (int i = 0; i < nsc; i++) {
      const Comp& c = comps[sc[i]];
      if (mode == kSeq || mode == kDcFirst) dct[i] = table(true, c.dc_tbl);
      if (mode == kSeq || mode == kAcFirst || mode == kAcRefine)
        act[i] = table(false, c.ac_tbl);
    }
    for (int ci : sc) comps[ci].pred = 0;
    int nx, ny;
    if (nsc > 1) {
      nx = mcux;
      ny = mcuy;
    } else {
      nx = comps[sc[0]].bw;
      ny = comps[sc[0]].bh;
    }
    Bits br{buf + pos, buf + len};
    int eobrun = 0, next_rst = 0;
    const int p1 = 1 << al, m1 = -(1 << al);
    int64_t total = static_cast<int64_t>(nx) * ny;

    auto block = [&](int i, int16_t* b) {
      Comp& c = comps[sc[i]];
      switch (mode) {
        case kSeq: {
          int s = br.decode(dct[i]);
          if (s) s = extend(br.get(s), s);
          c.pred += s;
          b[0] = static_cast<int16_t>(c.pred);
          for (int k = 1; k < 64; k++) {
            int rs = br.decode(act[i]);
            int r = rs >> 4;
            s = rs & 15;
            if (s) {
              k += r;
              b[kNatural[k]] = static_cast<int16_t>(extend(br.get(s), s));
            } else {
              if (r != 15) break;
              k += 15;
            }
          }
          break;
        }
        case kDcFirst: {
          int s = br.decode(dct[i]);
          if (s) s = extend(br.get(s), s);
          c.pred += s;
          b[0] = static_cast<int16_t>(static_cast<uint32_t>(c.pred) << al);
          break;
        }
        case kDcRefine:
          if (br.bit()) b[0] = static_cast<int16_t>(b[0] | p1);
          break;
        case kAcFirst:
          if (eobrun > 0) {
            eobrun--;
            break;
          }
          for (int k = ss; k <= se; k++) {
            int rs = br.decode(act[i]);
            int r = rs >> 4, s = rs & 15;
            if (s) {
              k += r;
              int val = extend(br.get(s), s);
              b[kNatural[k]] =
                  static_cast<int16_t>(static_cast<uint32_t>(val) << al);
            } else if (r == 15) {
              k += 15;
            } else {
              eobrun = 1 << r;
              if (r) eobrun += br.get(r);
              eobrun--;
              break;
            }
          }
          break;
        case kAcRefine: {
          int k = ss;
          if (eobrun == 0) {
            for (; k <= se; k++) {
              int rs = br.decode(act[i]);
              int r = rs >> 4, s = rs & 15;
              if (s) {
                if (s != 1) fail("corrupt data: bad refinement symbol");
                s = br.bit() ? p1 : m1;
              } else if (r != 15) {
                eobrun = 1 << r;
                if (r) eobrun += br.get(r);
                break;
              }
              do {
                int16_t* t = b + kNatural[k];
                if (*t != 0) {
                  if (br.bit() && (*t & p1) == 0)
                    *t = static_cast<int16_t>(*t >= 0 ? *t + p1 : *t + m1);
                } else if (--r < 0) {
                  break;
                }
                k++;
              } while (k <= se);
              if (s) b[kNatural[k]] = static_cast<int16_t>(s);
            }
          }
          if (eobrun > 0) {
            for (; k <= se; k++) {
              int16_t* t = b + kNatural[k];
              if (*t != 0 && br.bit() && (*t & p1) == 0)
                *t = static_cast<int16_t>(*t >= 0 ? *t + p1 : *t + m1);
            }
            eobrun--;
          }
          break;
        }
      }
    };

    for (int64_t m = 0; m < total; m++) {
      if (restart_interval && m > 0 && m % restart_interval == 0) {
        int rm = br.next_marker();
        if (rm != 0xD0 + next_rst)
          fail("corrupt data: " + marker_name(rm) + " where RST" +
               std::to_string(next_rst) + " was due");
        next_rst = (next_rst + 1) & 7;
        eobrun = 0;
        for (int ci : sc) comps[ci].pred = 0;
      }
      int mx = static_cast<int>(m % nx), my = static_cast<int>(m / nx);
      if (nsc == 1) {
        Comp& c = comps[sc[0]];
        block(0, &c.coef[(static_cast<size_t>(my) * c.bwp + mx) * 64]);
        continue;
      }
      for (int i = 0; i < nsc; i++) {
        Comp& c = comps[sc[i]];
        for (int y = 0; y < c.v; y++)
          for (int x = 0; x < c.h; x++)
            block(i, &c.coef[(static_cast<size_t>(my * c.v + y) * c.bwp +
                              mx * c.h + x) * 64]);
      }
    }
    pos = static_cast<size_t>(br.p - buf);
  }

  void finish() {
    for (const Comp& c : comps) {
      if (!c.coded) fail("truncated: a component has no scan");
      if (progressive)  // libjpeg's smoothing_ok: coefficients 1-9
        for (int k = 1; k < 10; k++)
          if (c.coef_bits[k] != 0)
            fail("truncated: progressive scans leave AC coefficient bits "
                 "missing (libjpeg would block-smooth the image)");
    }
  }
};

// --- output -------------------------------------------------------------

uint8_t g_idct_limit[1024];
uint8_t g_limit[1024];  // sample_range_limit, index + 256
int g_cr_r[256], g_cb_b[256];
int64_t g_cr_g[256], g_cb_g[256];
int64_t g_rgb_y[3][256];

constexpr int kScale = 16;
constexpr int64_t kHalf = int64_t{1} << (kScale - 1);
inline int64_t fix(double x) {
  return static_cast<int64_t>(x * (int64_t{1} << kScale) + 0.5);
}

struct Tables {
  Tables() {
    // jdmaster.c prepare_range_limit_table, seen through IDCT_range_limit
    for (int v = 0; v < 1024; v++) {
      int o;
      if (v < 128) o = v + 128;
      else if (v < 512) o = 255;
      else if (v < 896) o = 0;
      else o = v - 896;
      g_idct_limit[v] = static_cast<uint8_t>(o);
    }
    for (int i = 0; i < 1024; i++) {
      int x = i - 256;
      g_limit[i] = static_cast<uint8_t>(x < 0 ? 0 : x > 255 ? 255 : x);
    }
    for (int i = 0, x = -128; i < 256; i++, x++) {  // build_ycc_rgb_table
      g_cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
      g_cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
      g_cr_g[i] = -fix(0.71414) * x;
      g_cb_g[i] = -fix(0.34414) * x + kHalf;
    }
    for (int i = 0; i < 256; i++) {  // rgb_gray_convert's table
      g_rgb_y[0][i] = fix(0.29900) * i;
      g_rgb_y[1][i] = fix(0.58700) * i;
      g_rgb_y[2][i] = fix(0.11400) * i + kHalf;
    }
  }
};
const Tables g_tables;

// jidctint.c jpeg_idct_islow
constexpr int kConst = 13, kPass1 = 2;
inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t{1} << (n - 1))) >> n;
}

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const int16_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
        ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      int dc = (ip[0] * qp[0]) * (1 << kPass1);
      for (int r = 0; r < 8; r++) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * 4433;
    int64_t tmp2 = z1 + z3 * -15137;
    int64_t tmp3 = z1 + z2 * 6270;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConst);
    int64_t tmp1 = (z2 - z3) * (1 << kConst);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * 9633;
    tmp0 *= 2446;
    tmp1 *= 16819;
    tmp2 *= 25172;
    tmp3 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 *= -16069;
    z4 *= -3196;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConst - kPass1;
    wp[0] = static_cast<int>(descale(tmp10 + tmp3, sh));
    wp[56] = static_cast<int>(descale(tmp10 - tmp3, sh));
    wp[8] = static_cast<int>(descale(tmp11 + tmp2, sh));
    wp[48] = static_cast<int>(descale(tmp11 - tmp2, sh));
    wp[16] = static_cast<int>(descale(tmp12 + tmp1, sh));
    wp[40] = static_cast<int>(descale(tmp12 - tmp1, sh));
    wp[24] = static_cast<int>(descale(tmp13 + tmp0, sh));
    wp[32] = static_cast<int>(descale(tmp13 - tmp0, sh));
  }
  const int sh = kConst + kPass1 + 3;
  for (int r = 0; r < 8; r++) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + static_cast<size_t>(r) * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 &&
        wp[6] == 0 && wp[7] == 0) {
      uint8_t dc = g_idct_limit[descale(wp[0], kPass1 + 3) & 1023];
      std::memset(op, dc, 8);
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * 4433;
    int64_t tmp2 = z1 + z3 * -15137;
    int64_t tmp3 = z1 + z2 * 6270;
    int64_t tmp0 = (static_cast<int64_t>(wp[0]) + wp[4]) * (1 << kConst);
    int64_t tmp1 = (static_cast<int64_t>(wp[0]) - wp[4]) * (1 << kConst);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * 9633;
    tmp0 *= 2446;
    tmp1 *= 16819;
    tmp2 *= 25172;
    tmp3 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 *= -16069;
    z4 *= -3196;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = g_idct_limit[descale(tmp10 + tmp3, sh) & 1023];
    op[7] = g_idct_limit[descale(tmp10 - tmp3, sh) & 1023];
    op[1] = g_idct_limit[descale(tmp11 + tmp2, sh) & 1023];
    op[6] = g_idct_limit[descale(tmp11 - tmp2, sh) & 1023];
    op[2] = g_idct_limit[descale(tmp12 + tmp1, sh) & 1023];
    op[5] = g_idct_limit[descale(tmp12 - tmp1, sh) & 1023];
    op[3] = g_idct_limit[descale(tmp13 + tmp0, sh) & 1023];
    op[4] = g_idct_limit[descale(tmp13 - tmp0, sh) & 1023];
  }
}

// A component's samples [bh*8, bw*8] (rows past dh / columns past dw are
// never read).
std::vector<uint8_t> samples(const Comp& c) {
  int stride = c.bw * 8;
  std::vector<uint8_t> pl(static_cast<size_t>(stride) * c.bh * 8);
  for (int by = 0; by < c.bh; by++)
    for (int bx = 0; bx < c.bw; bx++)
      idct_islow(&c.coef[(static_cast<size_t>(by) * c.bwp + bx) * 64], c.q,
                 &pl[(static_cast<size_t>(by) * 8) * stride + bx * 8], stride);
  return pl;
}

// jdsample.c: the component upsampled to [height, width], with the method
// libjpeg-turbo's jinit_upsampler picks (fancy upsampling on, no scaling).
// Edges repeat the last real sample, as libjpeg's context rows and end
// columns do.
std::vector<uint8_t> upsample(const Comp& c, const std::vector<uint8_t>& pl,
                              int hmax, int vmax, int W, int H) {
  const int stride = c.bw * 8, dw = c.dw, dh = c.dh;
  std::vector<uint8_t> out(static_cast<size_t>(W) * H);
  auto in = [&](int y, int x) -> int {
    return pl[static_cast<size_t>(y) * stride + x];
  };
  if (c.h == hmax && c.v == vmax) {  // fullsize
    for (int y = 0; y < H; y++)
      std::memcpy(&out[static_cast<size_t>(y) * W], &pl[y * stride], W);
  } else if (c.h * 2 == hmax && c.v == vmax && dw > 2) {  // h2v1 fancy
    for (int y = 0; y < H; y++) {
      uint8_t* o = &out[static_cast<size_t>(y) * W];
      for (int x = 0; x < W; x++) {
        int i = x >> 1;
        o[x] = static_cast<uint8_t>(
            x & 1 ? (3 * in(y, i) + in(y, std::min(i + 1, dw - 1)) + 2) >> 2
                  : (3 * in(y, i) + in(y, std::max(i - 1, 0)) + 1) >> 2);
      }
    }
  } else if (c.h == hmax && c.v * 2 == vmax) {  // h1v2 fancy
    for (int y = 0; y < H; y++) {
      int i = y >> 1;
      int nb = y & 1 ? std::min(i + 1, dh - 1) : std::max(i - 1, 0);
      int bias = y & 1 ? 2 : 1;
      uint8_t* o = &out[static_cast<size_t>(y) * W];
      for (int x = 0; x < W; x++)
        o[x] = static_cast<uint8_t>((3 * in(i, x) + in(nb, x) + bias) >> 2);
    }
  } else if (c.h * 2 == hmax && c.v * 2 == vmax && dw > 2) {  // h2v2 fancy
    std::vector<int> cs(dw);
    for (int y = 0; y < H; y++) {
      int i = y >> 1;
      int nb = y & 1 ? std::min(i + 1, dh - 1) : std::max(i - 1, 0);
      for (int j = 0; j < dw; j++) cs[j] = 3 * in(i, j) + in(nb, j);
      uint8_t* o = &out[static_cast<size_t>(y) * W];
      for (int x = 0; x < W; x++) {
        int j = x >> 1;
        o[x] = static_cast<uint8_t>(
            x & 1 ? (3 * cs[j] + cs[std::min(j + 1, dw - 1)] + 7) >> 4
                  : (3 * cs[j] + cs[std::max(j - 1, 0)] + 8) >> 4);
      }
    }
  } else if (hmax % c.h == 0 && vmax % c.v == 0) {  // replication
    int hf = hmax / c.h, vf = vmax / c.v;
    for (int y = 0; y < H; y++)
      for (int x = 0; x < W; x++)
        out[static_cast<size_t>(y) * W + x] =
            static_cast<uint8_t>(in(y / vf, x / hf));
  } else {
    fail("fractional sampling factors are not supported");
  }
  return out;
}

void render(Decoder& d, int channels, uint8_t* out) {
  const int W = d.width, H = d.height;
  const size_t np = static_cast<size_t>(W) * H;
  bool only_y = channels == 1 && d.space != Space::kRGB;
  std::vector<std::vector<uint8_t>> up(d.ncomp);
  for (int ci = 0; ci < (only_y ? 1 : d.ncomp); ci++)
    up[ci] = upsample(d.comps[ci], samples(d.comps[ci]), d.hmax, d.vmax, W, H);
  if (d.space == Space::kGray || only_y) {
    const uint8_t* y = up[0].data();
    if (channels == 1) {
      std::memcpy(out, y, np);
    } else {
      for (size_t i = 0; i < np; i++)
        out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
    }
    return;
  }
  const uint8_t *a = up[0].data(), *b = up[1].data(), *c = up[2].data();
  if (d.space == Space::kRGB) {
    for (size_t i = 0; i < np; i++) {
      if (channels == 1) {
        out[i] = static_cast<uint8_t>(
            (g_rgb_y[0][a[i]] + g_rgb_y[1][b[i]] + g_rgb_y[2][c[i]]) >> kScale);
      } else {
        out[3 * i] = a[i];
        out[3 * i + 1] = b[i];
        out[3 * i + 2] = c[i];
      }
    }
    return;
  }
  for (size_t i = 0; i < np; i++) {  // ycc_rgb_convert
    int y = a[i], cb = b[i], cr = c[i];
    out[3 * i] = g_limit[256 + y + g_cr_r[cr]];
    out[3 * i + 1] = g_limit[256 + y + static_cast<int>(
                                          (g_cb_g[cb] + g_cr_g[cr]) >> kScale)];
    out[3 * i + 2] = g_limit[256 + y + g_cb_b[cb]];
  }
}

void set_error(char* err, int64_t errlen, const std::string& msg) {
  if (err && errlen > 0) {
    size_t n = std::min(msg.size(), static_cast<size_t>(errlen - 1));
    std::memcpy(err, msg.data(), n);
    err[n] = 0;
  }
}

}  // namespace

extern "C" {

int jd_header(const uint8_t* buf, int64_t len, int32_t* hwc, char* err,
              int64_t errlen) {
  try {
    Decoder d(buf, static_cast<size_t>(len));
    d.run(true);
    hwc[0] = d.height;
    hwc[1] = d.width;
    hwc[2] = d.ncomp;
    return 0;
  } catch (const JpegError& e) {
    set_error(err, errlen, e.msg);
    return -1;
  }
}

int jd_decode(const uint8_t* buf, int64_t len, int32_t channels, uint8_t* out,
              int64_t outlen, char* err, int64_t errlen) {
  try {
    if (channels != 1 && channels != 3) fail("channels must be 1 or 3");
    Decoder d(buf, static_cast<size_t>(len));
    d.run(false);
    d.finish();
    if (outlen != static_cast<int64_t>(d.width) * d.height * channels)
      fail("output buffer of the wrong size");
    render(d, channels, out);
    return 0;
  } catch (const JpegError& e) {
    set_error(err, errlen, e.msg);
    return -1;
  }
}

}  // extern "C"
