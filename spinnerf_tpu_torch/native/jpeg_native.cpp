// JPEG decoder with a plain C interface, equal pixel for pixel to what cv2 5
// gets from the libjpeg-turbo 3.1 it bundles (a SIMD build), on valid and on
// damaged streams alike.
//
// Takes 8-bit DCT frames, Huffman-coded or arithmetic-coded: SOF0 / SOF1 /
// SOF9 (sequential, interleaved or not) and SOF2 / SOF10 (progressive:
// spectral selection, successive approximation, EOB runs); 1, 3 or 4
// components (gray; YCbCr or RGB; CMYK or YCCK, chosen by jdapimin.c's
// rules on JFIF and Adobe APP14 markers and component ids), sampling
// factors 1-4; restart intervals; DHT / DQT between scans (each component
// keeps the quantisation table it had at its first scan, as libjpeg
// latches it); the standard Huffman tables where a scan names a table 0
// or 1 never defined. Arithmetic decoding is jdarith.c's: T.81 Annex D's
// QM decoder, its statistics areas per table (0-15) reset at each scan
// and restart, DAC conditioning (L, U, Kx), and on a bad code
// (JWRN_ARITH_BAD_CODE) the rest of the scan skipped.
// And lossless frames (SOF3, Huffman): predictors 1-7, a point transform,
// precisions 2-8, restarts in whole MCU rows, samples undifferenced as
// jdlossls.c / jddiffct.c do (the first-row predictor after each restart
// taking effect at its iMCU row); libjpeg-turbo converts no colour there,
// so gray, RGB (ids 1 2 3 or unknown mean RGB) and CMYK frames read only
// where no conversion is asked, subsampled components replicated.
//
// Damage is read as libjpeg reads it where cv2 only warns:
//  - a scan's data ends at a marker (or where the input ends); the bits
//    after its last byte are zeros, and once a block has needed them the
//    rest of the restart interval is left as it is (zero coefficients in a
//    sequential scan: grey blocks);
//  - a Huffman code that matches no table entry decodes as symbol 0;
//  - a restart marker missing or misnumbered: jpeg_resync_to_restart;
//  - bytes before a marker are skipped; scans out of progression order, an
//    AC scan before its DC scan, a sequential scan with progressive
//    parameters and a component without a scan are decoded on;
//  - a progressive image whose first nine AC coefficients are incomplete is
//    block-smoothed (jdcoefct.c decompress_smooth_data: the 5 x 5 DC window
//    of libjpeg-turbo 2.1 and later).
// Parameters and tables are checked where libjpeg checks them, and refused
// where it calls ERREXIT.
//
// Two sources, as cv2's two reads feed libjpeg. A file read (cv2.imread,
// jdatasrc.c's stdio source) finds a fake EOI (FF D9) wherever the data
// runs out. A buffer read (cv2.imdecode, OpenCV's memory source) suspends
// there, and cv2 gives None; except after the scan of a single-scan image,
// where only jpeg_finish_decompress reads on and cv2 keeps the image.
//
// The IDCT is libjpeg-turbo's islow as its SSE2 / AVX2 code computes it
// (16-bit products and sums, saturating packs), the upsamplers its fancy
// ones, colour its fixed-point tables, and 4-component images OpenCV's CMYK
// -> BGR and CMYK -> gray conversions (icvCvt_CMYK2BGR_8u_C4C3R,
// icvCvt_CMYK2Gray_8u_C4C1R).
//
// Refused, with an error naming the marker, where cv2 5.0 gives None:
// lossless arithmetic coding (SOF11), hierarchical and differential frames
// (SOF5-SOF7, SOF13-SOF15, DHP, EXP), 12-bit DCT and 9-16-bit lossless
// frames (OpenCV reads through the 8-bit API), 2 components, lossless
// YCbCr / YCCK or a colour read of a gray frame, and every stream libjpeg
// refuses.
//
// Interface (Python binds it with ctypes, spinnerf_tpu_torch/data/jpeg.py):
//   jd_header(buf, len, flags, hwc[3], err, errlen) -> 0, or -1 with a
//                                                      message
//   jd_decode(buf, len, flags, channels, out, outlen, err, errlen) -> 0 / -1
// `flags` bit 0 set is a file read, clear a buffer read. `channels` 3 gives
// RGB [H, W, 3] (cv2's colour read, channel order RGB), 1 gives gray
// [H, W] (cv2's grayscale read: the Y component of a YCbCr file, libjpeg's
// luma of an RGB one, OpenCV's of a CMYK one).

#include <algorithm>
#include <array>
#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct JpegError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError{msg}; }

const char kSuspended[] =
    "truncated: the data ends before the image does (a buffer read stops "
    "here, as cv2.imdecode does; a file read would find libjpeg's fake EOI)";

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

// jdhuff.c's derived table, with its 8-bit lookahead
struct Huff {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t look[256];  // (length << 8) | symbol; length 9: a longer code

  // jpeg_make_d_derived_tbl, with its validation
  void build(const HuffSpec& s, bool dc, int max_dc = 15) {
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
    maxcode[17] = 0xFFFFF;  // ends the bit-by-bit search at 17 bits
    std::memcpy(vals, s.vals, 256);
    for (uint16_t& e : look) e = 9 << 8;
    p = 0;
    for (int l = 1; l <= 8; l++) {
      for (int i = 1; i <= s.bits[l]; i++, p++) {
        int lookbits = static_cast<int>(huffcode[p]) << (8 - l);
        for (int c = 0; c < (1 << (8 - l)); c++)
          look[lookbits + c] = static_cast<uint16_t>((l << 8) | s.vals[p]);
      }
    }
    if (dc) {
      for (int i = 0; i < nsym; i++)
        if (s.vals[i] > max_dc)
          fail("bad Huffman table (DHT): DC symbol > " +
               std::to_string(max_dc));
    }
  }
};

// T.81 Table D.2 as jaricom.c packs it: Qe << 16 | Next_Index_MPS << 8 |
// Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed 0.5 estimate
#define V(qe, nl, nm, sw) ((int64_t{qe} << 16) | ((nm) << 8) | ((sw) << 7) | (nl))
const int64_t kAritab[114] = {
    V(0x5a1d, 1, 1, 1),     V(0x2586, 14, 2, 0),    V(0x1114, 16, 3, 0),
    V(0x080b, 18, 4, 0),    V(0x03d8, 20, 5, 0),    V(0x01da, 23, 6, 0),
    V(0x00e5, 25, 7, 0),    V(0x006f, 28, 8, 0),    V(0x0036, 30, 9, 0),
    V(0x001a, 33, 10, 0),   V(0x000d, 35, 11, 0),   V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0),   V(0x0001, 12, 13, 0),   V(0x5a7f, 15, 15, 1),
    V(0x3f25, 36, 16, 0),   V(0x2cf2, 38, 17, 0),   V(0x207c, 39, 18, 0),
    V(0x17b9, 40, 19, 0),   V(0x1182, 42, 20, 0),   V(0x0cef, 43, 21, 0),
    V(0x09a1, 45, 22, 0),   V(0x072f, 46, 23, 0),   V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0),   V(0x0303, 51, 26, 0),   V(0x0240, 52, 27, 0),
    V(0x01b1, 54, 28, 0),   V(0x0144, 56, 29, 0),   V(0x00f5, 57, 30, 0),
    V(0x00b7, 59, 31, 0),   V(0x008a, 60, 32, 0),   V(0x0068, 62, 33, 0),
    V(0x004e, 63, 34, 0),   V(0x003b, 32, 35, 0),   V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1),   V(0x484c, 64, 38, 0),   V(0x3a0d, 65, 39, 0),
    V(0x2ef1, 67, 40, 0),   V(0x261f, 68, 41, 0),   V(0x1f33, 69, 42, 0),
    V(0x19a8, 70, 43, 0),   V(0x1518, 72, 44, 0),   V(0x1177, 73, 45, 0),
    V(0x0e74, 74, 46, 0),   V(0x0bfb, 75, 47, 0),   V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0),   V(0x0706, 79, 50, 0),   V(0x05cd, 48, 51, 0),
    V(0x04de, 50, 52, 0),   V(0x040f, 50, 53, 0),   V(0x0363, 51, 54, 0),
    V(0x02d4, 52, 55, 0),   V(0x025c, 53, 56, 0),   V(0x01f8, 54, 57, 0),
    V(0x01a4, 55, 58, 0),   V(0x0160, 56, 59, 0),   V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0),   V(0x00cb, 59, 62, 0),   V(0x00ab, 61, 63, 0),
    V(0x008f, 61, 32, 0),   V(0x5b12, 65, 65, 1),   V(0x4d04, 80, 66, 0),
    V(0x412c, 81, 67, 0),   V(0x37d8, 82, 68, 0),   V(0x2fe8, 83, 69, 0),
    V(0x293c, 84, 70, 0),   V(0x2379, 86, 71, 0),   V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0),   V(0x174e, 72, 74, 0),   V(0x1424, 72, 75, 0),
    V(0x119c, 74, 76, 0),   V(0x0f6b, 74, 77, 0),   V(0x0d51, 75, 78, 0),
    V(0x0bb6, 77, 79, 0),   V(0x0a40, 77, 48, 0),   V(0x5832, 80, 81, 1),
    V(0x4d1c, 88, 82, 0),   V(0x438e, 89, 83, 0),   V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0),   V(0x2eae, 92, 86, 0),   V(0x299a, 93, 87, 0),
    V(0x2516, 86, 71, 0),   V(0x5570, 88, 89, 1),   V(0x4ca9, 95, 90, 0),
    V(0x44d9, 96, 91, 0),   V(0x3e22, 97, 92, 0),   V(0x3824, 99, 93, 0),
    V(0x32b4, 99, 94, 0),   V(0x2e17, 93, 86, 0),   V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0),  V(0x47e5, 102, 98, 0),  V(0x41cf, 103, 99, 0),
    V(0x3c3d, 104, 100, 0), V(0x375e, 99, 93, 0),   V(0x5231, 105, 102, 0),
    V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0), V(0x415e, 103, 99, 0),
    V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1),
    V(0x5522, 112, 109, 0), V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0)};
#undef V

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v + static_cast<int>((~0u << s) + 1) : v;
}

inline int16_t lo16(int64_t x) {
  return static_cast<int16_t>(static_cast<uint16_t>(x));
}

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;    // blocks that hold image samples
  int bwp = 0, bhp = 0;  // blocks allocated: whole interleaved MCUs
  int dw = 0, dh = 0;    // samples (libjpeg's downsampled width / height)
  std::vector<int16_t> coef;
  uint16_t q[64] = {};  // latched at the component's first scan
  bool latched = false;
  int coef_bits[64];       // jdphuff.c's progression state
  int prev_coef_bits[64];  // ... as it stood before the component's last scan
  int dc_tbl = 0, ac_tbl = 0;
  std::vector<int32_t> diff, smp;  // lossless: differences, samples
  int al = 0;                      // lossless: its scan's point transform
};

enum class Space { kGray, kYCbCr, kRGB, kCMYK, kYCCK };
enum class Mode { kSeq, kDcFirst, kDcRefine, kAcFirst, kAcRefine };

struct Decoder {
  const uint8_t* buf;
  size_t len;
  bool file;         // a file read: fake EOIs past the data
  size_t pos = 0;    // libjpeg's next_input_byte
  int unread_marker = 0;

  // frame
  bool saw_soi = false, saw_sof = false, progressive = false;
  bool arith = false, lossless = false;
  int sof_marker = 0, precision = 8;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
  Space space = Space::kYCbCr;
  int restart_interval = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  HuffSpec dc_spec[4], ac_spec[4];
  std::vector<Comp> comps;
  bool multi_scan = false;
  int input_scan_number = 0;
  int last_good_imcu = 0;  // the last iMCU row decoded before data ran out

  // scan
  std::vector<int> sc;  // component indices, in scan order
  int ss = 0, se = 0, ah = 0, al = 0;
  Mode mode = Mode::kSeq;
  int next_restart_num = 0, restarts_to_go = 0;
  Huff dct[4], act[4];
  int pred[4] = {0, 0, 0, 0};
  unsigned eobrun = 0;
  int nblk = 0;  // blocks per MCU
  int blk_comp[10];
  int16_t* blk[10];

  // bit reader: `left` valid bits at the bottom of acc (jdhuff.h)
  uint64_t acc = 0;
  int left = 0;
  bool insufficient = false;

  // arithmetic decoding (jdarith.c): the C and A registers, the bit
  // counter (-1 after JWRN_ARITH_BAD_CODE: the rest of the scan is
  // skipped), statistics areas, conditioning (DAC)
  int64_t ar_c = 0, ar_a = 0;
  int ar_ct = 0;
  uint8_t dc_stats[16][64], ac_stats[16][256], fixed_bin = 113;
  int dc_context[4] = {0, 0, 0, 0};
  uint8_t dc_L[16], dc_U[16], ac_K[16];

  Decoder(const uint8_t* b, size_t n, bool f) : buf(b), len(n), file(f) {
    for (int t = 0; t < 16; t++) {
      dc_L[t] = 0;
      dc_U[t] = 1;
      ac_K[t] = 5;
    }
  }

  // --- input: jdatasrc.c's stdio source (file) or OpenCV's (buffer) ---

  int past_end(size_t i) const {
    if (!file) fail(kSuspended);
    return (i - len) & 1 ? 0xD9 : 0xFF;
  }
  int byte() { return pos < len ? buf[pos++] : past_end(pos++); }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }
  void skip(int64_t n) {
    if (n > 0) pos += static_cast<size_t>(n);
  }

  // --- markers: jdmarker.c ---

  void next_marker() {
    for (;;) {
      int c = byte();
      while (c != 0xFF) c = byte();  // extraneous bytes: libjpeg warns
      do c = byte(); while (c == 0xFF);
      if (c != 0) {
        unread_marker = c;
        return;
      }
    }
  }

  // read_markers: true at an SOS (its header read), false at EOI
  bool read_markers() {
    for (;;) {
      if (unread_marker == 0) {
        if (!saw_soi) {
          int c = byte(), c2 = byte();
          if (c != 0xFF || c2 != 0xD8) fail("not a JPEG file (no SOI)");
          unread_marker = c2;
        } else {
          next_marker();
        }
      }
      int m = unread_marker;
      switch (m) {
        case 0xD8:
          if (saw_soi) fail("a second SOI");
          saw_soi = true;
          break;
        case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC9: case 0xCA:
          get_sof(m);
          break;
        case 0xCB:
          fail("SOF11 (lossless arithmetic coding) is not supported: "
               "libjpeg-turbo refuses it and cv2 gives None");
        case 0xC5: case 0xC6: case 0xC7: case 0xDE: case 0xDF:
          fail(marker_name(m) + " (hierarchical JPEG) is not supported: "
               "libjpeg-turbo refuses it and cv2 gives None");
        case 0xCD: case 0xCE: case 0xCF:
          fail(marker_name(m) + " (differential arithmetic coding) is not "
               "supported: libjpeg-turbo refuses it and cv2 gives None");
        case 0xCC: get_dac(); break;
        case 0xDA:
          get_sos();
          unread_marker = 0;
          return true;
        case 0xD9:
          unread_marker = 0;
          return false;
        case 0xC4: get_dht(); break;
        case 0xDB: get_dqt(); break;
        case 0xDD: {
          if (word() != 4) fail("bad length in DRI");
          restart_interval = word();
          break;
        }
        case 0x01: case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4:
        case 0xD5: case 0xD6: case 0xD7:
          break;  // parameterless, ignored as libjpeg does
        default:
          if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xDC)
            get_appn(m);
          else
            fail("unsupported " + marker_name(m));
      }
      unread_marker = 0;
    }
  }

  // APPn, COM and DNL: examine APP0 (JFIF) and APP14 (Adobe), skip the rest
  // (a length below 2 skips nothing, as skip_variable does)
  void get_appn(int m) {
    int64_t length = word() - 2;
    uint8_t b[14];
    int n = 0;
    if (m == 0xE0 || m == 0xEE) {
      n = length >= 14 ? 14 : length > 0 ? static_cast<int>(length) : 0;
      for (int i = 0; i < n; i++) b[i] = static_cast<uint8_t>(byte());
      length -= n;
    }
    if (m == 0xE0 && n >= 14 && std::memcmp(b, "JFIF\0", 5) == 0) jfif = true;
    if (m == 0xEE && n >= 12 && std::memcmp(b, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = b[11];
    }
    skip(length);
  }

  void get_sof(int m) {
    int length = word();
    precision = byte();
    int h = word(), w = word(), n = byte();
    length -= 8;
    if (saw_sof) fail("a second SOF (" + marker_name(m) + ")");
    if (h == 0)
      fail("height 0 (" + marker_name(m) + "; a DNL height) is not supported");
    if (w == 0 || n == 0) fail("an empty image in " + marker_name(m));
    if (length != 3 * n) fail("bad length in " + marker_name(m));
    const bool ll = m == 0xC3;
    if (ll ? precision < 2 || precision > 16 : precision != 8 && precision != 12)
      fail("bad precision " + std::to_string(precision) + " in " +
           marker_name(m));
    if (precision > 8)  // OpenCV reads through the 8-bit API
      fail(std::to_string(precision) + "-bit precision (" + marker_name(m) +
           ") is not supported: cv2 gives None");
    if (n != 1 && n != 3 && n != 4)
      fail(std::to_string(n) + " components (" + marker_name(m) +
           ") are not supported: cv2 gives None");
    height = h;
    width = w;
    ncomp = n;
    comps.resize(n);
    for (Comp& c : comps) {
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
      for (int k = 0; k < 64; k++) c.prev_coef_bits[k] = 0;
    }
    saw_sof = true;
    sof_marker = m;
    progressive = m == 0xC2 || m == 0xCA;
    arith = m == 0xC9 || m == 0xCA;
    lossless = m == 0xC3;
  }

  // get_dac: arithmetic conditioning, L and U of a DC table, Kx of an AC
  void get_dac() {
    int64_t length = word() - 2;
    while (length > 0) {
      int index = byte(), val = byte();
      length -= 2;
      if (index >= 32) fail("bad DAC table index " + std::to_string(index));
      if (index >= 16) {
        ac_K[index - 16] = static_cast<uint8_t>(val);
      } else {
        dc_L[index] = static_cast<uint8_t>(val & 15);
        dc_U[index] = static_cast<uint8_t>(val >> 4);
        if (dc_L[index] > dc_U[index])
          fail("bad DAC value " + std::to_string(val));
      }
    }
    if (length != 0) fail("bad length in DAC");
  }

  void get_dht() {
    int64_t length = word() - 2;
    while (length > 16) {
      int index = byte();
      HuffSpec s;
      int count = 0;
      for (int i = 1; i <= 16; i++) {
        s.bits[i] = static_cast<uint8_t>(byte());
        count += s.bits[i];
      }
      length -= 17;
      if (count > 256 || count > length) fail("bad Huffman table (DHT)");
      for (int i = 0; i < count; i++) s.vals[i] = static_cast<uint8_t>(byte());
      length -= count;
      bool ac = index & 0x10;
      if (ac) index -= 0x10;
      if (index < 0 || index > 3)
        fail("bad Huffman table index in DHT: " + std::to_string(index));
      s.defined = true;
      (ac ? ac_spec : dc_spec)[index] = s;
    }
    if (length != 0) fail("bad length in DHT");
  }

  void get_dqt() {
    int64_t length = word() - 2;
    while (length > 0) {
      int n = byte();
      int prec = n >> 4;
      n &= 15;
      if (n > 3) fail("bad quantisation table index in DQT");
      qt_defined[n] = true;
      for (int i = 0; i < 64; i++)
        qt[n][kNatural[i]] = static_cast<uint16_t>(prec ? word() : byte());
      length -= prec ? 129 : 65;
    }
    if (length != 0) fail("bad length in DQT");
  }

  void get_sos() {
    if (!saw_sof) fail("SOS before SOF");
    int length = word();
    int n = byte();
    if (length != 2 * n + 6 || n < 1 || n > 4) fail("bad SOS header");
    sc.clear();
    for (int i = 0; i < n; i++) {
      int id = byte(), t = byte();
      // libjpeg-turbo's lookup: the first component with this id whose
      // index is not below the scan position
      int ci = -1;
      for (int j = i; j < std::min(ncomp, 4) && ci < 0; j++)
        if (comps[j].id == id) ci = j;
      if (ci < 0) fail("SOS names an unknown component");
      for (int j : sc)
        if (j == ci) fail("SOS names a component twice");
      comps[ci].dc_tbl = t >> 4;
      comps[ci].ac_tbl = t & 15;
      sc.push_back(ci);
    }
    ss = byte();
    se = byte();
    int a = byte();
    ah = a >> 4;
    al = a & 15;
    next_restart_num = 0;
    input_scan_number++;
  }

  // --- jpeg_read_header: markers through the first SOS, initial_setup ---

  void read_header() {
    // OpenCV picks its JPEG decoder by the signature FF D8 FF
    if (len < 3 || buf[0] != 0xFF || buf[1] != 0xD8 || buf[2] != 0xFF)
      fail("not a JPEG file (no SOI)");
    if (!read_markers())
      fail(saw_sof ? "truncated: EOI before the first scan"
                   : "no image: EOI before SOF");
    if (width > 65500 || height > 65500) fail("image too big");
    for (const Comp& c : comps) {
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        fail("bad sampling factors in " + marker_name(sof_marker));
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    const int du = lossless ? 1 : 8;  // a sample, or an 8 x 8 block
    mcux = (width + hmax * du - 1) / (hmax * du);
    mcuy = (height + vmax * du - 1) / (vmax * du);
    for (Comp& c : comps) {
      c.dw = static_cast<int>((static_cast<int64_t>(width) * c.h + hmax - 1) /
                              hmax);
      c.dh = static_cast<int>((static_cast<int64_t>(height) * c.v + vmax - 1) /
                              vmax);
      c.bw = (c.dw + du - 1) / du;
      c.bh = (c.dh + du - 1) / du;
      c.bwp = mcux * c.h;
      c.bhp = mcuy * c.v;
    }
    multi_scan = static_cast<int>(sc.size()) < ncomp || progressive;
    // default_decompress_parms
    if (ncomp == 1) {
      space = Space::kGray;
    } else if (ncomp == 3) {
      if (jfif)
        space = Space::kYCbCr;
      else if (adobe)
        space = adobe_transform == 0 ? Space::kRGB : Space::kYCbCr;
      else if (comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66)
        space = Space::kRGB;  // 'R', 'G', 'B'
      else
        space = lossless ? Space::kRGB : Space::kYCbCr;
    } else {
      space = adobe && adobe_transform == 0 ? Space::kCMYK
              : adobe                       ? Space::kYCCK
                                            : Space::kCMYK;
    }
  }

  // --- jpeg_start_decompress and the scans ---

  void decode_image() {
    if (lossless) {
      decode_lossless();
      return;
    }
    for (Comp& c : comps) c.coef.assign(size_t(c.bwp) * c.bhp * 64, 0);
    standard_tables();
    start_scan();
    decode_scan();
    if (!multi_scan) return;  // jpeg_finish_decompress: cv2 ignores it
    while (read_markers()) {
      start_scan();
      decode_scan();
    }
  }

  Huff table(bool dc, int i, int max_dc = 15) {
    const HuffSpec& s = (dc ? dc_spec : ac_spec)[i];
    if (i > 3 || !s.defined) fail("a scan uses an undefined DHT table");
    Huff h;
    h.build(s, dc, max_dc);
    return h;
  }

  // The standard tables (Annex K.3) where the file defines none: OpenCV
  // loads all four when no table 0 or 1 came before the first SOS
  // (Motion-JPEG frames), libjpeg's sequential decoder each one undefined
  // when decoding starts (std_huff_tables); its progressive one none. A
  // lossless frame gets none at all (cv2 gives None without its DHT).
  void standard_tables() {
    if (lossless) return;
    bool none = true;
    for (int i = 0; i < 2; i++)
      none = none && !dc_spec[i].defined && !ac_spec[i].defined;
    if (!none && progressive) return;
    for (int i = 0; i < 2; i++) {
      if (!dc_spec[i].defined) {
        dc_spec[i].defined = true;
        std::memcpy(dc_spec[i].bits, i ? kStdDcChrBits : kStdDcLumBits, 17);
        std::memcpy(dc_spec[i].vals, kStdDcVals, 12);
      }
      if (!ac_spec[i].defined) {
        ac_spec[i].defined = true;
        std::memcpy(ac_spec[i].bits, i ? kStdAcChrBits : kStdAcLumBits, 17);
        std::memcpy(ac_spec[i].vals, i ? kStdAcChrVals : kStdAcLumVals, 162);
      }
    }
  }

  // jdinput.c start_input_pass: per_scan_setup, latch_quant_tables, and the
  // entropy decoder's start_pass
  void start_scan() {
    const int nsc = static_cast<int>(sc.size());
    nblk = 0;
    for (int i = 0; i < nsc; i++) {
      const Comp& c = comps[sc[i]];
      int n = nsc == 1 ? 1 : c.h * c.v;
      if (nblk + n > 10) fail("an MCU of more than 10 blocks");
      while (n--) blk_comp[nblk++] = i;
    }
    for (int ci : sc) {
      Comp& c = comps[ci];
      if (c.latched) continue;
      if (c.tq > 3 || !qt_defined[c.tq])
        fail("a scan uses an undefined DQT table");
      std::memcpy(c.q, qt[c.tq], sizeof c.q);
      c.latched = true;
    }
    if (progressive) {
      start_progressive_scan();
    } else {
      mode = Mode::kSeq;  // progressive parameters only warn
      for (int i = 0; i < nsc && !arith; i++) {
        dct[i] = table(true, comps[sc[i]].dc_tbl);
        act[i] = table(false, comps[sc[i]].ac_tbl);
      }
    }
    if (arith) arith_reset(true);
    for (int& p : pred) p = 0;
    acc = 0;
    left = 0;
    insufficient = false;
    eobrun = 0;
    restarts_to_go = restart_interval;
  }

  // jdphuff.c start_pass_phuff_decoder
  void start_progressive_scan() {
    const int nsc = static_cast<int>(sc.size());
    bool dc_band = ss == 0, bad = false;
    if (dc_band) {
      if (se != 0) bad = true;
    } else {
      if (ss > se || se > 63) bad = true;
      if (nsc != 1) bad = true;
    }
    if (ah != 0 && al != ah - 1) bad = true;
    if (al > 13) bad = true;
    if (bad)
      fail("corrupt data: bad progressive scan parameters in " +
           marker_name(sof_marker) + " (Ss " + std::to_string(ss) + ", Se " +
           std::to_string(se) + ", Ah " + std::to_string(ah) + ", Al " +
           std::to_string(al) + ")");
    for (int ci : sc) {  // scans out of order only warn
      Comp& c = comps[ci];
      for (int k = std::min(ss, 1); k <= std::max(se, 9); k++)
        c.prev_coef_bits[k] = input_scan_number > 1 ? c.coef_bits[k] : 0;
      for (int k = ss; k <= se; k++) c.coef_bits[k] = al;
    }
    mode = dc_band ? (ah ? Mode::kDcRefine : Mode::kDcFirst)
                   : (ah ? Mode::kAcRefine : Mode::kAcFirst);
    for (int i = 0; i < nsc && !arith; i++) {
      const Comp& c = comps[sc[i]];
      if (mode == Mode::kDcFirst) dct[i] = table(true, c.dc_tbl);
      if (!dc_band) act[i] = table(false, c.ac_tbl);
    }
  }

  void decode_scan() {
    if (sc.size() == 1) {
      Comp& c = comps[sc[0]];
      for (int by = 0; by < c.bh; by++)
        for (int bx = 0; bx < c.bw; bx++) {
          if (!insufficient) last_good_imcu = by / c.v;
          blk[0] = &c.coef[(size_t(by) * c.bwp + bx) * 64];
          decode_mcu();
        }
      return;
    }
    for (int my = 0; my < mcuy; my++)
      for (int mx = 0; mx < mcux; mx++) {
        if (!insufficient) last_good_imcu = my;
        int b = 0;
        for (int ci : sc) {
          Comp& c = comps[ci];
          for (int y = 0; y < c.v; y++)
            for (int x = 0; x < c.h; x++)
              blk[b++] = &c.coef[(size_t(my * c.v + y) * c.bwp + mx * c.h + x) *
                                 64];
        }
        decode_mcu();
      }
  }

  // --- bit reading: jdhuff.h's macros, jpeg_fill_bit_buffer ---

  // Loads the buffer to 57 bits, stopping at a marker; past a marker a
  // request for more bits than are left gets zeros and marks the segment
  // out of data.
  void fill(int nbits) {
    while (unread_marker == 0 && left < 57) {
      int c = pos < len ? buf[pos++] : past_end(pos++);
      if (c == 0xFF) {
        do c = pos < len ? buf[pos++] : past_end(pos++); while (c == 0xFF);
        if (c != 0) {
          unread_marker = c;
          break;
        }
        c = 0xFF;
      }
      acc = (acc << 8) | static_cast<unsigned>(c);
      left += 8;
    }
    if (unread_marker != 0 && nbits > left) {
      insufficient = true;
      acc <<= 57 - left;
      left = 57;
    }
  }
  void check(int n) {
    if (left < n) fill(n);
  }
  int get(int n) {
    left -= n;
    return static_cast<int>((acc >> left) & ((1u << n) - 1));
  }
  int peek8() const { return static_cast<int>((acc >> (left - 8)) & 0xFF); }

  // HUFF_DECODE and jpeg_huff_decode: a code matching no entry is symbol 0
  int decode(const Huff& h) {
    int l;
    if (left < 8) {
      fill(0);
      if (left < 8) {
        l = 1;
        goto slow;
      }
    }
    {
      int e = h.look[peek8()];
      l = e >> 8;
      if (l <= 8) {
        left -= l;
        return e & 0xFF;
      }
    }
  slow:
    check(l);
    int32_t code = get(l);
    while (code > h.maxcode[l]) {
      code <<= 1;
      check(1);
      code |= get(1);
      l++;
    }
    return l > 16 ? 0 : h.vals[(code + h.valoffset[l]) & 0xFF];
  }

  // FILL_BIT_BUFFER_FAST and HUFF_DECODE_FAST, on bytes known to be there
  void fill_fast(const uint8_t*& q) {
    if (left > 16) return;
    for (int i = 0; i < 6; i++) {
      int c0 = *q++, c1 = *q;
      acc = (acc << 8) | static_cast<unsigned>(c0);
      left += 8;
      if (c0 == 0xFF) {
        q++;
        if (c1 != 0) {  // a marker: zeros instead, and the MCU is redone
          unread_marker = c1;
          q -= 2;
          acc &= ~uint64_t{0xFF};
        }
      }
    }
  }
  int decode_fast(const Huff& h, const uint8_t*& q) {
    fill_fast(q);
    int s = h.look[peek8()];
    int l = s >> 8;
    left -= l;
    if (l <= 8) return s & 0xFF;
    s = static_cast<int>((acc >> left) & ((1u << l) - 1));
    while (s > h.maxcode[l]) {
      s = (s << 1) | get(1);
      l++;
    }
    return l > 16 ? 0 : h.vals[(s + h.valoffset[l]) & 0xFF];
  }

  // --- restarts: process_restart, read_restart_marker, resync ---

  void process_restart() {
    left = 0;
    if (unread_marker == 0) next_marker();
    if (unread_marker == 0xD0 + next_restart_num)
      unread_marker = 0;
    else
      resync_to_restart(next_restart_num);
    next_restart_num = (next_restart_num + 1) & 7;
    for (int& p : pred) p = 0;
    eobrun = 0;
    restarts_to_go = restart_interval;
    if (unread_marker == 0) insufficient = false;
  }

  // jpeg_resync_to_restart: 1 discards the marker and decodes on, 2 scans
  // to the next marker and decides again, 3 leaves the marker (the segment
  // decodes as empty)
  void resync_to_restart(int desired) {
    for (;;) {
      int m = unread_marker, action;
      if (m < 0xC0)
        action = 2;
      else if (m < 0xD0 || m > 0xD7)
        action = 3;
      else if (m == 0xD0 + ((desired + 1) & 7) ||
               m == 0xD0 + ((desired + 2) & 7))
        action = 3;
      else if (m == 0xD0 + ((desired - 1) & 7) ||
               m == 0xD0 + ((desired - 2) & 7))
        action = 2;
      else
        action = 1;
      if (action == 1) unread_marker = 0;
      if (action != 2) return;
      next_marker();
    }
  }

  // --- MCU decoders: jdhuff.c decode_mcu, jdphuff.c decode_mcu_* ---

  void decode_mcu() {
    if (arith) {
      arith_decode_mcu();
      return;
    }
    bool usefast = mode == Mode::kSeq;
    if (restart_interval) {
      if (restarts_to_go == 0) process_restart();
      usefast = false;
    }
    if (mode == Mode::kDcRefine) {
      dc_refine();
    } else if (!insufficient) {
      switch (mode) {
        case Mode::kSeq:
          if (pos >= len || len - pos < size_t(512) * nblk || unread_marker)
            usefast = false;
          if (!usefast || !seq_fast()) seq_slow();
          break;
        case Mode::kDcFirst: dc_first(); break;
        case Mode::kAcFirst: ac_first(); break;
        default: ac_refine(); break;
      }
    }
    if (restart_interval) restarts_to_go--;
  }

  void seq_slow() {
    for (int b = 0; b < nblk; b++) {
      const int i = blk_comp[b];
      int16_t* block = blk[b];
      int s = decode(dct[i]);
      if (s) {
        check(s);
        s = extend(get(s), s);
      }
      pred[i] = static_cast<int>(static_cast<unsigned>(pred[i]) + s);
      block[0] = lo16(pred[i]);
      for (int k = 1; k < 64; k++) {
        int rs = decode(act[i]);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          check(s);
          block[kNatural[k]] = lo16(extend(get(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
  }

  // decode_mcu_fast: false (state as before) where it met a marker; the
  // slow decoder then redoes the MCU over whatever it wrote
  bool seq_fast() {
    const uint64_t acc0 = acc;
    const int left0 = left;
    int pred0[4];
    std::memcpy(pred0, pred, sizeof pred);
    const uint8_t* q = buf + pos;
    for (int b = 0; b < nblk; b++) {
      const int i = blk_comp[b];
      int16_t* block = blk[b];
      int s = decode_fast(dct[i], q);
      if (s) {
        fill_fast(q);
        s = extend(get(s), s);
      }
      pred[i] = static_cast<int>(static_cast<unsigned>(pred[i]) + s);
      block[0] = lo16(pred[i]);
      for (int k = 1; k < 64; k++) {
        int rs = decode_fast(act[i], q);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          fill_fast(q);
          block[kNatural[k]] = lo16(extend(get(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
    if (unread_marker) {
      unread_marker = 0;
      acc = acc0;
      left = left0;
      std::memcpy(pred, pred0, sizeof pred);
      return false;
    }
    pos = static_cast<size_t>(q - buf);
    return true;
  }

  void dc_first() {
    for (int b = 0; b < nblk; b++) {
      const int i = blk_comp[b];
      int s = decode(dct[i]);
      if (s) {
        check(s);
        s = extend(get(s), s);
      }
      if ((pred[i] >= 0 && s > INT_MAX - pred[i]) ||
          (pred[i] < 0 && s < INT_MIN - pred[i]))
        fail("corrupt data: a DC coefficient overflows");
      pred[i] += s;
      blk[b][0] = lo16(static_cast<int64_t>(
          static_cast<uint64_t>(static_cast<int64_t>(pred[i])) << al));
    }
  }

  void dc_refine() {  // no out-of-data test: zero bits change nothing
    const int p1 = 1 << al;
    for (int b = 0; b < nblk; b++) {
      check(1);
      if (get(1)) blk[b][0] = static_cast<int16_t>(blk[b][0] | p1);
    }
  }

  void ac_first() {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    int16_t* block = blk[0];
    const Huff& h = act[0];
    for (int k = ss; k <= se; k++) {
      int rs = decode(h);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        check(s);
        int v = extend(get(s), s);
        block[kNatural[k]] = lo16(static_cast<int64_t>(
            static_cast<uint64_t>(static_cast<int64_t>(v)) << al));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1u << r;
        if (r) {
          check(r);
          eobrun += get(r);
        }
        eobrun--;
        break;
      }
    }
  }

  void ac_refine() {
    const int p1 = 1 << al, m1 = -(1 << al);
    int16_t* block = blk[0];
    const Huff& h = act[0];
    auto correct = [&](int16_t* t) {  // a correction bit for a nonzero coef
      check(1);
      if (get(1) && (*t & p1) == 0)
        *t = lo16(*t >= 0 ? *t + p1 : *t + m1);
    };
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int rs = decode(h);
        int r = rs >> 4, s = rs & 15;
        if (s) {  // a size other than 1 only warns
          check(1);
          s = get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1u << r;
          if (r) {
            check(r);
            eobrun += get(r);
          }
          break;
        }
        do {
          int16_t* t = block + kNatural[k];
          if (*t != 0)
            correct(t);
          else if (--r < 0)
            break;
          k++;
        } while (k <= se);
        if (s) block[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* t = block + kNatural[k];
        if (*t != 0) correct(t);
      }
      eobrun--;
    }
  }

  // --- arithmetic decoding: jdarith.c ---

  // start_pass (`scan`) and process_restart: the statistics areas of the
  // scan's tables zeroed, DC predictions and contexts reset, C and A
  // emptied so that the next decision reads two bytes
  void arith_reset(bool scan) {
    if (!scan) {
      if (unread_marker == 0) next_marker();
      if (unread_marker == 0xD0 + next_restart_num)
        unread_marker = 0;
      else
        resync_to_restart(next_restart_num);
      next_restart_num = (next_restart_num + 1) & 7;
    }
    for (size_t i = 0; i < sc.size(); i++) {
      const Comp& c = comps[sc[i]];
      if (!progressive || (ss == 0 && ah == 0)) {
        std::memset(dc_stats[c.dc_tbl], 0, 64);
        pred[i] = 0;
        dc_context[i] = 0;
      }
      if (!progressive || ss) std::memset(ac_stats[c.ac_tbl], 0, 256);
    }
    ar_c = 0;
    ar_a = 0;
    ar_ct = -16;
    restarts_to_go = restart_interval;
  }

  // arith_decode: one binary decision (D.2.4 - D.2.6); at a marker the
  // data are zeros from there on; past the input a file read finds
  // libjpeg's fake EOI and a buffer read fails (no suspension here)
  int arith_decode(uint8_t* st) {
    while (ar_a < 0x8000) {
      if (--ar_ct < 0) {
        int data = 0;
        if (unread_marker == 0) {
          data = byte();
          if (data == 0xFF) {
            do data = byte(); while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              unread_marker = data;
              data = 0;
            }
          }
        }
        ar_c = (ar_c << 8) | data;
        if ((ar_ct += 8) < 0)
          if (++ar_ct == 0) ar_a = 0x8000;  // two bytes in: A = 0x10000
      }
      ar_a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    const int nl = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    const int nm = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    int64_t temp = ar_a - qe;
    ar_a = temp;
    temp <<= ar_ct;
    if (ar_c >= temp) {
      ar_c -= temp;
      if (ar_a < qe) {
        ar_a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        ar_a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (ar_a < 0x8000) {
      if (ar_a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // F.1.4.4.1 / F.2.4.1: a DC difference into pred[i]; false on a bad
  // code (JWRN_ARITH_BAD_CODE: the scan's remaining MCUs are skipped)
  bool arith_dc(int i, int tbl) {
    uint8_t* st = dc_stats[tbl] + dc_context[i];
    if (arith_decode(st) == 0) {
      dc_context[i] = 0;
      return true;
    }
    const int sign = arith_decode(st + 1);
    st += 2 + sign;
    int m = arith_decode(st);
    if (m != 0) {
      st = dc_stats[tbl] + 20;
      while (arith_decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        st += 1;
      }
    }
    if (m < ((1 << dc_L[tbl]) >> 1))
      dc_context[i] = 0;
    else if (m > ((1 << dc_U[tbl]) >> 1))
      dc_context[i] = 12 + sign * 4;
    else
      dc_context[i] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (arith_decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    pred[i] = (pred[i] + v) & 0xFFFF;
    return true;
  }

  // F.2.4.2 / G.1.3.2: the AC coefficients ss..se of a block (scaled by
  // << al); false on a bad code
  bool arith_ac(int16_t* block, int tbl, int from, int to, int shift) {
    for (int k = from; k <= to; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (arith_decode(st)) break;  // EOB
      while (arith_decode(st + 1) == 0) {
        st += 3;
        if (++k > to) return false;  // spectral overflow
      }
      const int sign = arith_decode(&fixed_bin);
      st += 2;
      int m = arith_decode(st);
      if (m != 0 && arith_decode(st)) {
        m <<= 1;
        st = ac_stats[tbl] + (k <= ac_K[tbl] ? 189 : 217);
        while (arith_decode(st)) {
          if ((m <<= 1) == 0x8000) return false;
          st += 1;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (arith_decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      block[kNatural[k]] = lo16(static_cast<int64_t>(
          static_cast<uint64_t>(static_cast<uint32_t>(v)) << shift));
    }
    return true;
  }

  // G.1.3.3: a refinement scan's bits and newly nonzero coefficients
  bool arith_ac_refine(int16_t* block, int tbl) {
    const int p1 = 1 << al, m1 = -(1 << al);
    int kex = se;
    for (; kex > 0; kex--)
      if (block[kNatural[kex]]) break;
    for (int k = ss; k <= se; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (k > kex && arith_decode(st)) break;  // EOB
      for (;;) {
        int16_t* t = block + kNatural[k];
        if (*t) {
          if (arith_decode(st + 2)) *t = lo16(*t < 0 ? *t + m1 : *t + p1);
          break;
        }
        if (arith_decode(st + 1)) {
          *t = static_cast<int16_t>(arith_decode(&fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) return false;
      }
    }
    return true;
  }

  void arith_decode_mcu() {
    if (restart_interval) {
      if (restarts_to_go == 0) arith_reset(false);
      restarts_to_go--;
    }
    if (mode == Mode::kDcRefine) {  // no bad-code test: every bit is good
      for (int b = 0; b < nblk; b++)
        if (arith_decode(&fixed_bin)) blk[b][0] |= static_cast<int16_t>(1 << al);
      return;
    }
    if (ar_ct == -1) return;
    bool ok = true;
    switch (mode) {
      case Mode::kSeq:
        for (int b = 0; b < nblk && ok; b++) {
          const int i = blk_comp[b];
          const Comp& c = comps[sc[i]];
          ok = arith_dc(i, c.dc_tbl);
          if (!ok) break;
          blk[b][0] = lo16(pred[i]);
          ok = arith_ac(blk[b], c.ac_tbl, 1, 63, 0);
        }
        break;
      case Mode::kDcFirst:
        for (int b = 0; b < nblk && ok; b++) {
          const int i = blk_comp[b];
          ok = arith_dc(i, comps[sc[i]].dc_tbl);
          if (ok)
            blk[b][0] = lo16(static_cast<int64_t>(
                static_cast<uint64_t>(static_cast<uint32_t>(pred[i])) << al));
        }
        break;
      case Mode::kAcFirst:
        ok = arith_ac(blk[0], comps[sc[0]].ac_tbl, ss, se, al);
        break;
      default:
        ok = arith_ac_refine(blk[0], comps[sc[0]].ac_tbl);
    }
    if (!ok) ar_ct = -1;  // JWRN_ARITH_BAD_CODE
  }

  // --- lossless: jdlossls.c, jddiffct.c, jdlhuff.c ---

  // Every scan's differences decoded and undifferenced into each
  // component's samples (before the point transform)
  void decode_lossless() {
    standard_tables();
    for (Comp& c : comps) {
      c.diff.assign(static_cast<size_t>(c.bwp) * c.bhp, 0);
      c.smp.assign(static_cast<size_t>(c.bwp) * c.bhp, 0);
    }
    for (;;) {
      lossless_scan();
      if (!multi_scan || !read_markers()) break;
    }
  }

  void lossless_scan() {
    const int nsc = static_cast<int>(sc.size());
    if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= precision)
      fail("corrupt data: bad lossless scan parameters in SOF3 (Ss " +
           std::to_string(ss) + ", Se " + std::to_string(se) + ", Ah " +
           std::to_string(ah) + ", Al " + std::to_string(al) + ")");
    nblk = 0;
    for (int i = 0; i < nsc; i++) {
      const Comp& c = comps[sc[i]];
      int n = nsc == 1 ? 1 : c.h * c.v;
      if (nblk + n > 10) fail("an MCU of more than 10 samples");
      while (n--) blk_comp[nblk++] = i;
      dct[i] = table(true, c.dc_tbl, 16);
    }
    for (int ci : sc) comps[ci].al = al;
    const Comp& c0 = comps[sc[0]];
    const int per_row = nsc == 1 ? c0.bw : mcux;
    const int mcu_rows = nsc == 1 ? c0.bh : mcuy;
    if (restart_interval % per_row)
      fail("bad restart interval " + std::to_string(restart_interval) +
           ": not a multiple of the " + std::to_string(per_row) +
           " MCUs in an MCU row");
    acc = 0;
    left = 0;
    insufficient = false;
    int rows_to_go = restart_interval / per_row;
    bool first[4] = {true, true, true, true};  // the first-row predictor
    // an iMCU row: v MCU rows of a non-interleaved scan, one otherwise
    const int per_imcu = nsc == 1 ? c0.v : 1;
    for (int r0 = 0; r0 < mcu_rows; r0 += per_imcu) {
      for (int r = r0; r < std::min(r0 + per_imcu, mcu_rows); r++) {
        if (restart_interval) {
          if (rows_to_go == 0) {
            process_restart();
            for (bool& f : first) f = true;
            rows_to_go = restart_interval / per_row;
          }
          rows_to_go--;
        }
        if (insufficient) {  // out of data: zeros, the predictor reset
          for (bool& f : first) f = true;
          for (int mx = 0; mx < per_row; mx++) lossless_mcu(r, mx, true);
        } else {
          for (int mx = 0; mx < per_row; mx++) lossless_mcu(r, mx, false);
        }
      }
      for (int i = 0; i < nsc; i++) {
        Comp& c = comps[sc[i]];
        const int y0 = (nsc == 1 ? r0 : r0 * c.v);
        const int y1 = std::min(y0 + c.v, c.bh);
        for (int y = y0; y < y1; y++) {
          undifference(c, y, first[i]);
          first[i] = false;
        }
      }
    }
  }

  void lossless_mcu(int r, int mx, bool zero) {
    int b = 0;
    for (int ci : sc) {
      Comp& c = comps[ci];
      const int hh = sc.size() == 1 ? 1 : c.h, vv = sc.size() == 1 ? 1 : c.v;
      for (int y = 0; y < vv; y++)
        for (int x = 0; x < hh; x++, b++) {
          int s = 0;
          if (!zero) {
            s = decode(dct[blk_comp[b]]);
            if (s == 16) {
              s = 32768;
            } else if (s) {
              check(s);
              s = extend(get(s), s);
            }
          }
          c.diff[static_cast<size_t>(r * vv + y) * c.bwp + mx * hh + x] = s;
        }
    }
  }

  // jpeg_undifference_first_row and jpeg_undifference1-7 on row y
  void undifference(Comp& c, int y, bool first) {
    const int32_t* d = &c.diff[static_cast<size_t>(y) * c.bwp];
    int32_t* o = &c.smp[static_cast<size_t>(y) * c.bwp];
    const int w = c.bw;
    if (first) {
      int ra = (d[0] + (1 << (precision - c.al - 1))) & 0xFFFF;
      o[0] = ra;
      for (int x = 1; x < w; x++) o[x] = ra = (d[x] + ra) & 0xFFFF;
      return;
    }
    const int32_t* p = o - c.bwp;
    int rb = p[0], ra = (d[0] + rb) & 0xFFFF, rc;
    o[0] = ra;
    for (int x = 1; x < w; x++) {
      rc = rb;
      rb = p[x];
      int pr;
      switch (ss) {
        case 1: pr = ra; break;
        case 2: pr = rb; break;
        case 3: pr = rc; break;
        case 4: pr = ra + rb - rc; break;
        case 5: pr = ra + ((rb - rc) >> 1); break;
        case 6: pr = rb + ((ra - rc) >> 1); break;
        default: pr = (ra + rb) >> 1;
      }
      o[x] = ra = (d[x] + pr) & 0xFFFF;
    }
  }
};

// --- output -------------------------------------------------------------

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

inline int16_t sat16(int32_t x) {
  return static_cast<int16_t>(x < -32768 ? -32768 : x > 32767 ? 32767 : x);
}

// One pass of jidctint-sse2.asm / jidctint-avx2.asm (the islow IDCT as
// libjpeg-turbo's SIMD code computes it): 16-bit inputs, the sums
// in0 +- in4, in7 + in3 and in5 + in1 wrapped to 16 bits, products and the
// rest in 32 bits; each output descaled by `sh`.
inline void idct_pass(const int16_t* in, int sh, int32_t* o) {
  const int32_t i0 = in[0], i1 = in[1], i2 = in[2], i3 = in[3], i4 = in[4],
                i5 = in[5], i6 = in[6], i7 = in[7];
  const int32_t tmp3 = i2 * 10703 + i6 * 4433;  // FIX(0.541 + 0.765), ...
  const int32_t tmp2 = i2 * 4433 + i6 * -10704;
  const int32_t tmp0 = int32_t{lo16(i0 + i4)} * 8192;
  const int32_t tmp1 = int32_t{lo16(i0 - i4)} * 8192;
  const int32_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
  const int32_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
  const int32_t z3 = lo16(i7 + i3), z4 = lo16(i5 + i1);
  const int32_t z3p = z3 * -6436 + z4 * 9633;  // FIX(1.175 - 1.961), ...
  const int32_t z4p = z3 * 9633 + z4 * 6437;
  const int32_t o0 = i7 * -4927 + i1 * -7373 + z3p;
  const int32_t o3 = i7 * -7373 + i1 * 4926 + z4p;
  const int32_t o1 = i5 * -4176 + i3 * -20995 + z4p;
  const int32_t o2 = i5 * -20995 + i3 * 4177 + z3p;
  const int32_t r = 1 << (sh - 1);
  o[0] = (t10 + o3 + r) >> sh;
  o[7] = (t10 - o3 + r) >> sh;
  o[1] = (t11 + o2 + r) >> sh;
  o[6] = (t11 - o2 + r) >> sh;
  o[2] = (t12 + o1 + r) >> sh;
  o[5] = (t12 - o1 + r) >> sh;
  o[3] = (t13 + o0 + r) >> sh;
  o[4] = (t13 - o0 + r) >> sh;
}

// jsimd_idct_islow: dequantisation is a 16-bit product; a block whose rows
// 1-7 are all zero takes the DC-only first pass (wrapped << 2), other
// columns the full one (saturated to 16 bits); the rows' outputs saturate
// to [-128, 127] before + 128.
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
  int16_t ws[64];
  bool rows_zero = true;
  for (int k = 8; k < 64 && rows_zero; k++) rows_zero = in[k] == 0;
  if (rows_zero) {
    for (int c = 0; c < 8; c++) {
      int16_t dc = lo16(int64_t{lo16(int64_t{in[c]} * q[c])} * 4);
      for (int r = 0; r < 8; r++) ws[8 * r + c] = dc;
    }
  } else {
    for (int c = 0; c < 8; c++) {
      int16_t col[8];
      bool ac = false;
      for (int r = 0; r < 8; r++) {
        col[r] = lo16(int64_t{in[8 * r + c]} * q[8 * r + c]);
        ac |= r > 0 && col[r] != 0;
      }
      if (!ac) {  // the full pass's result, without its arithmetic
        int16_t dc = sat16(int32_t{col[0]} * 4);
        for (int r = 0; r < 8; r++) ws[8 * r + c] = dc;
        continue;
      }
      int32_t o[8];
      idct_pass(col, 11, o);
      for (int r = 0; r < 8; r++) ws[8 * r + c] = sat16(o[r]);
    }
  }
  for (int r = 0; r < 8; r++) {
    const int16_t* w = ws + 8 * r;
    uint8_t* op = out + static_cast<size_t>(r) * stride;
    if (!(w[1] | w[2] | w[3] | w[4] | w[5] | w[6] | w[7])) {
      int32_t v = (int32_t{w[0]} + 16) >> 5;
      std::memset(op, std::clamp(v, -128, 127) + 128, 8);
      continue;
    }
    int32_t o[8];
    idct_pass(w, 18, o);
    for (int c = 0; c < 8; c++)
      op[c] = static_cast<uint8_t>(std::clamp(o[c], -128, 127) + 128);
  }
}

// jdcoefct.c smoothing_ok: the coef_bits of coefficients 0-9 latched for
// each component (now, and before the component's last scan); false where
// no component needs smoothing or one cannot have it
struct Smoothing {
  std::vector<std::array<int, 10>> now, before;
};

bool smoothing_ok(const Decoder& d, Smoothing& sm) {
  if (!d.progressive) return false;
  bool useful = false;
  sm.now.assign(d.ncomp, {});
  sm.before.assign(d.ncomp, {});
  for (int ci = 0; ci < d.ncomp; ci++) {
    const Comp& c = d.comps[ci];
    if (!c.latched) return false;
    for (int k : {0, 1, 8, 16, 9, 2, 3, 10, 17, 24})
      if (c.q[k] == 0) return false;
    if (c.coef_bits[0] < 0) return false;
    sm.now[ci][0] = c.coef_bits[0];
    for (int k = 1; k < 10; k++) {
      sm.before[ci][k] = d.input_scan_number > 1 ? c.prev_coef_bits[k] : -1;
      sm.now[ci][k] = c.coef_bits[k];
      if (c.coef_bits[k] != 0) useful = true;
    }
  }
  return useful;
}

// decompress_smooth_data for one block: the first nine AC coefficients that
// are zero and not known exactly are estimated from the DC values of the
// 5 x 5 blocks around (DC interpolation too where no AC data came at all)
void smooth_block(const Comp& c, const int* bits, const int dcv[25],
                  int16_t* ws) {
  const int64_t q00 = c.q[0];
  auto dc = [&](int n) -> int64_t { return dcv[n - 1]; };  // DC01..DC25
  const bool change_dc = bits[1] == -1 && bits[2] == -1 && bits[3] == -1 &&
                         bits[4] == -1 && bits[5] == -1 && bits[6] == -1 &&
                         bits[7] == -1 && bits[8] == -1 && bits[9] == -1;
  auto predict = [&](int al, int64_t qk, int64_t num) {
    int64_t pred;
    if (num >= 0) {
      pred = ((qk << 7) + num) / (qk << 8);
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    } else {
      pred = ((qk << 7) - num) / (qk << 8);
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      pred = -pred;
    }
    return lo16(pred);
  };
  struct Term {
    int bit, pos;
    int64_t change, keep;  // the estimates with and without DC interpolation
  };
  const Term terms[9] = {
      {1, 1,
       -dc(1) - dc(2) + dc(4) + dc(5) - 3 * dc(6) + 13 * dc(7) -
           13 * dc(9) + 3 * dc(10) - 3 * dc(11) + 38 * dc(12) -
           38 * dc(14) + 3 * dc(15) - 3 * dc(16) + 13 * dc(17) -
           13 * dc(19) + 3 * dc(20) - dc(21) - dc(22) + dc(24) + dc(25),
       -7 * dc(11) + 50 * dc(12) - 50 * dc(14) + 7 * dc(15)},
      {2, 8,
       -dc(1) - 3 * dc(2) - 3 * dc(3) - 3 * dc(4) - dc(5) - dc(6) +
           13 * dc(7) + 38 * dc(8) + 13 * dc(9) - dc(10) + dc(16) -
           13 * dc(17) - 38 * dc(18) - 13 * dc(19) + dc(20) + dc(21) +
           3 * dc(22) + 3 * dc(23) + 3 * dc(24) + dc(25),
       -7 * dc(3) + 50 * dc(8) - 50 * dc(18) + 7 * dc(23)},
      {3, 16,
       dc(3) + 2 * dc(7) + 7 * dc(8) + 2 * dc(9) - 5 * dc(12) - 14 * dc(13) -
           5 * dc(14) + 2 * dc(17) + 7 * dc(18) + 2 * dc(19) + dc(23),
       -dc(3) + 13 * dc(8) - 24 * dc(13) + 13 * dc(18) - dc(23)},
      {4, 9,
       -dc(1) + dc(5) + 9 * dc(7) - 9 * dc(9) - 9 * dc(17) + 9 * dc(19) +
           dc(21) - dc(25),
       dc(10) + dc(16) - 10 * dc(17) + 10 * dc(19) - dc(2) - dc(20) +
           dc(22) - dc(24) + dc(4) - dc(6) + 10 * dc(7) - 10 * dc(9)},
      {5, 2,
       2 * dc(7) - 5 * dc(8) + 2 * dc(9) + dc(11) + 7 * dc(12) -
           14 * dc(13) + 7 * dc(14) + dc(15) + 2 * dc(17) - 5 * dc(18) +
           2 * dc(19),
       -dc(11) + 13 * dc(12) - 24 * dc(13) + 13 * dc(14) - dc(15)},
      {6, 3, dc(7) - dc(9) + 2 * dc(12) - 2 * dc(14) + dc(17) - dc(19), 0},
      {7, 10, dc(7) - 3 * dc(8) + dc(9) - dc(17) + 3 * dc(18) - dc(19), 0},
      {8, 17, dc(7) - dc(9) - 3 * dc(12) + 3 * dc(14) + dc(17) - dc(19), 0},
      {9, 24, dc(7) + 2 * dc(8) + dc(9) - dc(17) - 2 * dc(18) - dc(19), 0}};
  for (int t = 0; t < (change_dc ? 9 : 5); t++) {
    const Term& e = terms[t];
    const int al = bits[e.bit];
    if (al != 0 && ws[e.pos] == 0)
      ws[e.pos] = predict(al, c.q[e.pos],
                          q00 * (change_dc ? e.change : e.keep));
  }
  if (change_dc) {
    const int64_t num =
        q00 * (-2 * dc(1) - 6 * dc(2) - 8 * dc(3) - 6 * dc(4) - 2 * dc(5) -
               6 * dc(6) + 6 * dc(7) + 42 * dc(8) + 6 * dc(9) - 6 * dc(10) -
               8 * dc(11) + 42 * dc(12) + 152 * dc(13) + 42 * dc(14) -
               8 * dc(15) - 6 * dc(16) + 6 * dc(17) + 42 * dc(18) +
               6 * dc(19) - 6 * dc(20) - 2 * dc(21) - 6 * dc(22) -
               8 * dc(23) - 6 * dc(24) - 2 * dc(25));
    ws[0] = predict(0, q00, num);
  }
}

// A component's samples [bh*8, bw*8] (rows past dh / columns past dw are
// never read), block-smoothed where `sm` is given.
std::vector<uint8_t> samples(const Decoder& d, int ci, const Smoothing* sm) {
  const Comp& c = d.comps[ci];
  const int stride = c.bw * 8;
  std::vector<uint8_t> pl(static_cast<size_t>(stride) * c.bh * 8);
  auto block = [&](int by, int bx) {
    return &c.coef[(static_cast<size_t>(by) * c.bwp + bx) * 64];
  };
  for (int by = 0; by < c.bh; by++) {
    // the rows two above to two below as jdcoefct.c finds them: it counts
    // the rows of an iMCU row's height (v, or the last row's remainder)
    // over all iMCU rows, so the row before a short last iMCU row reaches
    // into the padding rows below the image
    const int imcu = by / c.v, total = d.mcuy;
    const int rows = imcu == total - 1 && c.bh % c.v ? c.bh % c.v : c.v;
    const int ib = imcu * rows + by % c.v, ibs = rows * total;
    int r[5];
    r[2] = by;
    r[1] = ib > 0 ? by - 1 : by;
    r[0] = ib > 1 ? by - 2 : r[1];
    r[3] = ib < ibs - 1 ? by + 1 : by;
    r[4] = ib < ibs - 2 ? by + 2 : r[3];
    const int* bits = nullptr;
    if (sm)
      bits = (imcu > d.last_good_imcu ? sm->before[ci] : sm->now[ci]).data();
    for (int bx = 0; bx < c.bw; bx++) {
      uint8_t* out = &pl[(static_cast<size_t>(by) * 8) * stride + bx * 8];
      if (!sm) {
        idct_islow(block(by, bx), c.q, out, stride);
        continue;
      }
      int dcv[25];
      for (int i = 0; i < 5; i++)
        for (int j = 0; j < 5; j++)
          dcv[5 * i + j] = block(r[i], std::clamp(bx + j - 2, 0, c.bw - 1))[0];
      int16_t ws[64];
      std::memcpy(ws, block(by, bx), sizeof ws);
      smooth_block(c, bits, dcv, ws);
      idct_islow(ws, c.q, out, stride);
    }
  }
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

// A lossless frame: each sample shifted left by its scan's point transform
// and kept to 8 bits, components replicated to full size (libjpeg-turbo
// upsamples lossless frames by replication and converts no colour: gray,
// RGB and CMYK only, each in the reads that need no conversion)
void render_lossless(const Decoder& d, int channels, uint8_t* out) {
  const int W = d.width, H = d.height;
  const size_t np = static_cast<size_t>(W) * H;
  if (d.space == Space::kYCbCr || d.space == Space::kYCCK)
    fail("a lossless YCbCr or YCCK frame: libjpeg-turbo converts no colour "
         "in lossless mode and cv2 gives None");
  if ((d.space == Space::kGray && channels != 1) ||
      (d.space == Space::kRGB && channels != 3))
    fail(std::string("a ") + (channels == 1 ? "gray" : "colour") +
         " read of a lossless " + (channels == 1 ? "RGB" : "gray") +
         " frame: libjpeg-turbo converts no colour in lossless mode and cv2 "
         "gives None");
  std::vector<std::vector<uint8_t>> up(d.ncomp);
  for (int ci = 0; ci < d.ncomp; ci++) {
    const Comp& c = d.comps[ci];
    if (d.hmax % c.h || d.vmax % c.v)
      fail("fractional sampling factors are not supported");
    const int hf = d.hmax / c.h, vf = d.vmax / c.v;
    up[ci].resize(np);
    for (int y = 0; y < H; y++)
      for (int x = 0; x < W; x++)
        up[ci][static_cast<size_t>(y) * W + x] = static_cast<uint8_t>(
            c.smp[static_cast<size_t>(y / vf) * c.bwp + x / hf] << c.al);
  }
  if (d.space == Space::kGray) {
    std::memcpy(out, up[0].data(), np);
    return;
  }
  for (size_t i = 0; i < np; i++) {
    int cc = up[0][i], mm = up[1][i], yy = up[2][i];
    if (d.space == Space::kCMYK) {  // OpenCV's CMYK -> BGR (here RGB), gray
      const int kk = up[3][i];
      cc = kk - ((255 - cc) * kk >> 8);
      mm = kk - ((255 - mm) * kk >> 8);
      yy = kk - ((255 - yy) * kk >> 8);
      if (channels == 1) {
        out[i] = static_cast<uint8_t>((yy * 1868 + mm * 9617 + cc * 4899 +
                                       (1 << 13)) >> 14);
        continue;
      }
    }
    out[3 * i] = static_cast<uint8_t>(cc);
    out[3 * i + 1] = static_cast<uint8_t>(mm);
    out[3 * i + 2] = static_cast<uint8_t>(yy);
  }
}

void render(const Decoder& d, int channels, uint8_t* out) {
  if (d.lossless) {
    render_lossless(d, channels, out);
    return;
  }
  const int W = d.width, H = d.height;
  const size_t np = static_cast<size_t>(W) * H;
  Smoothing sm;
  const Smoothing* smp = smoothing_ok(d, sm) ? &sm : nullptr;
  const bool four = d.space == Space::kCMYK || d.space == Space::kYCCK;
  // a gray read of a gray or YCbCr image needs the Y component alone
  const bool only_y = channels == 1 &&
                      (d.space == Space::kGray || d.space == Space::kYCbCr);
  std::vector<std::vector<uint8_t>> up(d.ncomp);
  for (int ci = 0; ci < (only_y ? 1 : d.ncomp); ci++)
    up[ci] = upsample(d.comps[ci], samples(d, ci, smp), d.hmax, d.vmax, W, H);
  if (only_y || d.space == Space::kGray) {
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
  if (four) {
    const uint8_t* k = up[3].data();
    for (size_t i = 0; i < np; i++) {
      int cc = a[i], mm = b[i], yy = c[i], kk = k[i];
      if (d.space == Space::kYCCK) {  // jdcolor.c ycck_cmyk_convert
        int y = a[i], cb = b[i], cr = c[i];
        cc = g_limit[256 + 255 - (y + g_cr_r[cr])];
        mm = g_limit[256 + 255 -
                     (y + static_cast<int>((g_cb_g[cb] + g_cr_g[cr]) >>
                                           kScale))];
        yy = g_limit[256 + 255 - (y + g_cb_b[cb])];
      }
      // OpenCV's CMYK -> BGR (here RGB) and CMYK -> gray
      cc = kk - ((255 - cc) * kk >> 8);
      mm = kk - ((255 - mm) * kk >> 8);
      yy = kk - ((255 - yy) * kk >> 8);
      if (channels == 1) {
        out[i] = static_cast<uint8_t>((yy * 1868 + mm * 9617 + cc * 4899 +
                                       (1 << 13)) >> 14);
      } else {
        out[3 * i] = static_cast<uint8_t>(cc);
        out[3 * i + 1] = static_cast<uint8_t>(mm);
        out[3 * i + 2] = static_cast<uint8_t>(yy);
      }
    }
    return;
  }
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

// A strip or tile of a JPEG-compressed TIFF as libtiff's tif_jpeg.c has
// libjpeg decode it for the RGBA reader: every component upsampled to full
// size and left as it is (JCS_UNKNOWN in and out), or, where `ycc` is set
// (photometric YCbCr, JPEGCOLORMODE_RGB), three converted to RGB whatever
// the stream's markers say. `out` [H, W, ncomp].
void render_tiff(const Decoder& d, bool ycc, uint8_t* out) {
  if (d.lossless) fail("a lossless frame in a TIFF strip is not read");
  const int W = d.width, H = d.height, n = d.ncomp;
  const size_t np = static_cast<size_t>(W) * H;
  Smoothing sm;
  const Smoothing* smp = smoothing_ok(d, sm) ? &sm : nullptr;
  std::vector<std::vector<uint8_t>> up(n);
  for (int ci = 0; ci < n; ci++)
    up[ci] = upsample(d.comps[ci], samples(d, ci, smp), d.hmax, d.vmax, W, H);
  if (ycc && n == 3) {
    for (size_t i = 0; i < np; i++) {  // ycc_rgb_convert
      int y = up[0][i], cb = up[1][i], cr = up[2][i];
      out[3 * i] = g_limit[256 + y + g_cr_r[cr]];
      out[3 * i + 1] = g_limit[256 + y + static_cast<int>(
                                            (g_cb_g[cb] + g_cr_g[cr]) >> kScale)];
      out[3 * i + 2] = g_limit[256 + y + g_cb_b[cb]];
    }
    return;
  }
  for (size_t i = 0; i < np; i++)
    for (int ci = 0; ci < n; ci++) out[n * i + ci] = up[ci][i];
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

int jd_header(const uint8_t* buf, int64_t len, int32_t flags, int32_t* hwc,
              char* err, int64_t errlen) {
  try {
    Decoder d(buf, static_cast<size_t>(len), flags & 1);
    d.read_header();
    hwc[0] = d.height;
    hwc[1] = d.width;
    hwc[2] = d.ncomp;
    return 0;
  } catch (const JpegError& e) {
    set_error(err, errlen, e.msg);
    return -1;
  } catch (const std::exception& e) {  // std::bad_alloc and the like
    set_error(err, errlen, std::string("decoder error: ") + e.what());
    return -1;
  }
}

int jd_decode(const uint8_t* buf, int64_t len, int32_t flags,
              int32_t channels, uint8_t* out, int64_t outlen, char* err,
              int64_t errlen) {
  try {
    if (channels != 1 && channels != 3) fail("channels must be 1 or 3");
    Decoder d(buf, static_cast<size_t>(len), flags & 1);
    d.read_header();
    if (outlen != static_cast<int64_t>(d.width) * d.height * channels)
      fail("output buffer of the wrong size");
    d.decode_image();
    render(d, channels, out);
    return 0;
  } catch (const JpegError& e) {
    set_error(err, errlen, e.msg);
    return -1;
  } catch (const std::exception& e) {  // std::bad_alloc and the like
    set_error(err, errlen, std::string("decoder error: ") + e.what());
    return -1;
  }
}

// jd_header's hwc[3] also gives each component's sampling in `samp`
// (h0, v0, h1, v1, ...; at most 4 components) and the precision in samp[8]
int jd_tiff_header(const uint8_t* buf, int64_t len, int32_t* hwc,
                   int32_t* samp, char* err, int64_t errlen) {
  try {
    Decoder d(buf, static_cast<size_t>(len), true);
    d.read_header();
    hwc[0] = d.height;
    hwc[1] = d.width;
    hwc[2] = d.ncomp;
    for (int ci = 0; ci < std::min(d.ncomp, 4); ci++) {
      samp[2 * ci] = d.comps[ci].h;
      samp[2 * ci + 1] = d.comps[ci].v;
    }
    samp[8] = d.precision;
    return 0;
  } catch (const JpegError& e) {
    set_error(err, errlen, e.msg);
    return -1;
  } catch (const std::exception& e) {
    set_error(err, errlen, std::string("decoder error: ") + e.what());
    return -1;
  }
}

// A TIFF strip's stream (its tables spliced in), read as libtiff's source
// manager feeds it (a fake EOI where the data run out): `out` [H, W, ncomp]
// as render_tiff gives it.
int jd_tiff_decode(const uint8_t* buf, int64_t len, int32_t ycc, uint8_t* out,
                   int64_t outlen, char* err, int64_t errlen) {
  try {
    Decoder d(buf, static_cast<size_t>(len), true);
    d.read_header();
    if (outlen != static_cast<int64_t>(d.width) * d.height * d.ncomp)
      fail("output buffer of the wrong size");
    d.decode_image();
    render_tiff(d, ycc != 0, out);
    return 0;
  } catch (const JpegError& e) {
    set_error(err, errlen, e.msg);
    return -1;
  } catch (const std::exception& e) {
    set_error(err, errlen, std::string("decoder error: ") + e.what());
    return -1;
  }
}

}  // extern "C"
