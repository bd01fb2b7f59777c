// Decoders of the image formats cv2 5.0 reads besides JPEG and PNG, with a
// plain C interface, equal pixel for pixel to what cv2 gives:
//
//  - BMP as OpenCV's grfmt_bmp reads it: 1, 4, 8 bits with a palette (a
//    palette of grays reads as one channel), RLE4 and RLE8 (its quirks
//    kept: a delta's dy ignored in RLE4, skipped pixels in colour 0), 16
//    bits 555 / 565 (BI_RGB or the two BI_BITFIELDS layouts it accepts),
//    24 bits, 32 bits (BI_RGB as 3 channels, BI_BITFIELDS as 4, the masks
//    not applied; with a V3+ header's alpha mask the gray read is a
//    float luma, truncated), top-down and bottom-up rows; OS/2 core headers
//    read as one channel, as cv2 leaves them.
//  - PBM / PGM / PPM (P1-P6) as grfmt_pxm reads them: ASCII values scaled
//    by 255 / maxval, binary ones not; maxval above 255 gives 16 bits.
//  - TIFF's LZW (libtiff's LZWDecode, and LZWDecodeCompat for old-style
//    codes) and PackBits, failing where libtiff fails and keeping what it
//    keeps; `data/tiff.py` parses the TIFF itself.
//  - WebP as the libwebp OpenCV bundles decodes it (WebPDecodeBGR(A)Into):
//    lossy VP8 (RFC 6386: boolean decoder, segments, intra prediction,
//    inverse DCT / WHT, simple and normal loop filters, then libwebp's fancy
//    upsampler and its 14-bit YUV -> RGB), lossless VP8L (RFC 9649: prefix
//    code groups, colour cache, LZ77 with the distance map, the four
//    transforms) and the ALPH chunk (raw or VP8L-coded, its three filters);
//    of an animation, the first frame on a cleared canvas, as cv2 5.0
//    reads it.
//  - PAM (P7), PFM, Sun raster, Radiance HDR and GIF as OpenCV 5.0's
//    grfmt_pam.cpp, grfmt_pfm.cpp, grfmt_sunras.cpp, grfmt_hdr.cpp /
//    rgbe.cpp and grfmt_gif.cpp read them (each section below says how);
//    PFM and HDR give float32, which `data/imageio.py` saturates for the
//    colour and gray reads as convertTo does.
//
// Interface (Python binds it with ctypes, spinnerf_tpu_torch/data/imageio.py).
// Every function returns 0, or -1 with a message in `err`:
//   im_bmp_info(buf, len, info[3], err, errlen)    info: height, width,
//                                                  channels of cv2's
//                                                  unchanged read
//   im_bmp_decode(buf, len, channels, out, outlen, err, errlen)
//                                                  BGR(A) / gray as cv2
//   im_pxm_info(buf, len, info[4], err, errlen)    info: height, width,
//                                                  channels, bytes a sample
//   im_pxm_decode(buf, len, channels, depth, out, outlen, err, errlen)
//   im_webp_info(buf, len, info[4], err, errlen)   info: height, width,
//                                                  has alpha, animated
//   im_webp_decode(buf, len, channels, out, outlen, err, errlen)
//                                                  channels 3: BGR, 4: BGRA
//   im_lzw_decode(buf, len, compat, out, outlen, written[2], err, errlen)
//   im_packbits_decode(buf, len, out, outlen, written[2], err, errlen)
//                                                  at most outlen bytes:
//                                                  written[0] bytes came,
//                                                  written[1] 1 where
//                                                  libtiff's decode fails
//   im_fax_decode(buf, len, compression, two_d, lsb_first, width, rows,
//                 out, outlen, failed[2], err, errlen)
//                                                  a CCITT strip's rows
//                                                  (1 bit, black 1);
//                                                  failed[0] where libtiff
//                                                  fails, [1] where a row
//                                                  was damaged
//   im_pam_info(buf, len, info[4], ...)            height, width, channels,
//                                                  bytes a sample
//   im_pam_decode(buf, len, channels, depth, out, outlen, err, errlen)
//   im_pfm_info / im_hdr_info(buf, len, info, ...) height, width (PFM:
//                                                  and channels)
//   im_pfm_decode / im_hdr_decode(buf, len, out, outlen, err, errlen)
//                                                  float32 RGB / gray
//   im_sunras_info / im_gif_info(buf, len, info[3], ...)
//                                                  height, width, channels
//   im_sunras_decode / im_gif_decode(buf, len, channels, out, outlen, err,
//                                    errlen)       BGR(A) / gray as cv2

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct ImageError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw ImageError{msg}; }

void set_error(char* err, int64_t errlen, const std::string& msg) {
  if (err == nullptr || errlen <= 0) return;
  size_t n = std::min(msg.size(), static_cast<size_t>(errlen - 1));
  memcpy(err, msg.data(), n);
  err[n] = 0;
}

// OpenCV's fixed-point luma of imgcodecs/src/utils.cpp (descale(..., 14))
constexpr int kCR = 4899, kCG = 9617, kCB = 1868;

inline uint8_t luma14(int b, int g, int r) {
  return static_cast<uint8_t>((b * kCB + g * kCG + r * kCR + (1 << 13)) >> 14);
}

// RLByteStream of imgcodecs/src/bitstrm.cpp: little-endian, reading past the
// end is an error (cv2 gives None)
struct Stream {
  const uint8_t* d;
  int64_t n;
  int64_t pos = 0;
  Stream(const uint8_t* d_, int64_t n_) : d(d_), n(n_) {}
  int byte() {
    if (pos < 0 || pos >= n) fail("unexpected end of data");
    return d[pos++];
  }
  int word() {
    int a = byte();
    return a | (byte() << 8);
  }
  int dword() {
    uint32_t a = static_cast<uint32_t>(word());
    return static_cast<int>(a | (static_cast<uint32_t>(word()) << 16));
  }
  void bytes(uint8_t* out, int64_t k) {
    if (pos < 0 || k > n - pos) fail("unexpected end of data");
    memcpy(out, d + pos, static_cast<size_t>(k));
    pos += k;
  }
  void skip(int64_t k) { pos += k; }
};

// ------------------------------------------------------------------ BMP --

struct Pal {
  uint8_t b, g, r, a;
};

struct Bmp {
  int width = 0, height = 0, bpp = 0, rle = 0, offset = 0;
  bool bottom_up = true, iscolor = false, alpha_mask = false;
  int type_cn = 3;
  Pal palette[256];
};

enum { BMP_RGB = 0, BMP_RLE8 = 1, BMP_RLE4 = 2, BMP_BITFIELDS = 3 };

bool color_palette(const Pal* p, int bpp) {
  for (int i = 0; i < (1 << bpp); ++i)
    if (p[i].b != p[i].g || p[i].b != p[i].r) return true;
  return false;
}

Bmp bmp_header(Stream& s) {
  Bmp h;
  memset(h.palette, 0, sizeof(h.palette));
  bool ok = false;
  s.skip(10);
  h.offset = s.dword();
  int size = s.dword();
  if (size <= 0) fail("BMP header size out of range");
  bool alpha_mask = false;
  if (size >= 36) {
    h.width = s.dword();
    h.height = s.dword();
    h.bpp = s.dword() >> 16;
    int rle = s.dword();
    if (rle < 0 || rle > BMP_BITFIELDS)
      fail("BMP compression " + std::to_string(rle) + " is not read by cv2");
    h.rle = rle;
    s.skip(12);
    int clrused = s.dword();
    if (size >= 56) {   // a V3+ header: its alpha mask
      const int64_t at = s.pos + 16;
      alpha_mask = at + 4 <= s.n && (s.d[at] | s.d[at + 1] | s.d[at + 2] | s.d[at + 3]);
    }
    s.skip(size - 36);
    int bpp = h.bpp;
    if (h.width > 0 && h.height != 0 &&
        (((bpp == 1 || bpp == 4 || bpp == 8 || bpp == 24 || bpp == 32) &&
          rle == BMP_RGB) ||
         ((bpp == 16 || bpp == 32) &&
          (rle == BMP_RGB || rle == BMP_BITFIELDS)) ||
         (bpp == 4 && rle == BMP_RLE4) || (bpp == 8 && rle == BMP_RLE8))) {
      ok = true;
      h.iscolor = true;
      h.alpha_mask = alpha_mask && bpp == 32 && rle == BMP_BITFIELDS;
      if (bpp <= 8) {
        if (clrused < 0 || clrused > 256) fail("BMP palette size out of range");
        uint8_t buf[1024];
        int k = (clrused == 0 ? 1 << bpp : clrused) * 4;
        s.bytes(buf, k);
        memcpy(h.palette, buf, static_cast<size_t>(k));
        h.iscolor = color_palette(h.palette, bpp);
      } else if (bpp == 16 && rle == BMP_BITFIELDS) {
        int red = s.dword(), green = s.dword(), blue = s.dword();
        if (blue == 0x1f && green == 0x3e0 && red == 0x7c00)
          h.bpp = 15;
        else if (!(blue == 0x1f && green == 0x7e0 && red == 0xf800))
          ok = false;
      } else if (bpp == 16 && rle == BMP_RGB) {
        h.bpp = 15;
      }
    }
  } else if (size == 12) {
    h.width = s.word();
    h.height = static_cast<int16_t>(s.word());
    h.bpp = s.dword() >> 16;
    h.rle = BMP_RGB;
    int bpp = h.bpp;
    if (h.width > 0 && h.height != 0 &&
        (bpp == 1 || bpp == 4 || bpp == 8 || bpp == 24 || bpp == 32)) {
      if (bpp <= 8) {
        uint8_t buf[768];
        int k = 1 << bpp;
        s.bytes(buf, k * 3);
        for (int j = 0; j < k; ++j)
          h.palette[j] = Pal{buf[3 * j], buf[3 * j + 1], buf[3 * j + 2], 0};
      }
      ok = true;
    }
  }
  if (!ok) fail("BMP header not read by cv2 (size " + std::to_string(size) +
                ", " + std::to_string(h.bpp) + " bits, compression " +
                std::to_string(h.rle) + ")");
  h.type_cn = h.iscolor ? ((h.bpp == 32 && h.rle != BMP_RGB) ? 4 : 3) : 1;
  h.bottom_up = h.height > 0;
  h.height = std::abs(h.height);
  return h;
}

// FillUniColor / FillUniGray of grfmt_bmp.cpp: `count` bytes of one value,
// running on into the next rows
int64_t fill_uni(uint8_t* img, int64_t pos, int64_t& line_end, int64_t step,
                 int64_t width3, int& y, int height, int64_t count,
                 const uint8_t* clr, int nch) {
  do {
    int64_t end = pos + count;
    if (end > line_end) end = line_end;
    count -= end - pos;
    for (; pos < end; pos += nch) memcpy(img + pos, clr, static_cast<size_t>(nch));
    if (pos >= line_end) {
      line_end += step;
      pos = line_end - width3;
      if (++y >= height) break;
    }
  } while (count > 0);
  return pos;
}

void bmp_decode(const uint8_t* buf, int64_t len, int channels, uint8_t* out,
                int64_t outlen) {
  Stream s(buf, len);
  Bmp h = bmp_header(s);
  const bool color = channels > 1;
  const int nch = color ? 3 : 1;
  if (outlen != static_cast<int64_t>(h.width) * h.height * channels)
    fail("output buffer of the wrong size");
  if (channels == 4 && h.bpp != 32) fail("4 channels need a 32-bit BMP");
  const int64_t src_pitch =
      ((static_cast<int64_t>(h.width) * (h.bpp != 15 ? h.bpp : 16) + 7) / 8 +
       3) & -4;
  if (h.offset < 0 || h.offset > len) fail("BMP pixel offset out of range");
  // rows in file order: bottom-up files start at the last output row; the
  // RLE decoders work on one contiguous buffer with a positive step and the
  // rows are flipped at the end
  const int64_t step = static_cast<int64_t>(h.width) * channels;
  const int64_t width3 = static_cast<int64_t>(h.width) * nch;
  std::vector<uint8_t> src(static_cast<size_t>(src_pitch + 32));
  uint8_t gray_palette[256] = {0};
  if (!color)
    for (int i = 0; i < (1 << std::min(h.bpp, 8)); ++i)
      gray_palette[i] =
          luma14(h.palette[i].b, h.palette[i].g, h.palette[i].r);
  auto row_ptr = [&](int y) { return out + static_cast<int64_t>(y) * step; };
  auto pix = [&](uint8_t* d, const Pal& p) {
    if (color) {
      d[0] = p.b;
      d[1] = p.g;
      d[2] = p.r;
    }
  };
  s.pos = h.offset;
  const int H = h.height, W = h.width;
  if (h.rle == BMP_RLE4 || h.rle == BMP_RLE8) {
    memset(out, 0, static_cast<size_t>(outlen));
    int64_t pos = 0, line_end = width3;
    int y = 0;
    uint8_t clr0[3] = {h.palette[0].b, h.palette[0].g, h.palette[0].r};
    const uint8_t* c0 = color ? clr0 : gray_palette;
    if (h.rle == BMP_RLE4) {
      for (;;) {
        int code = s.word();
        const int n = code & 255;
        code >>= 8;
        if (n != 0) {
          uint8_t clr[2][3];
          for (int t = 0; t < 2; ++t) {
            const Pal& p = h.palette[t == 0 ? code >> 4 : code & 15];
            if (color) {
              clr[t][0] = p.b;
              clr[t][1] = p.g;
              clr[t][2] = p.r;
            } else {
              clr[t][0] = gray_palette[t == 0 ? code >> 4 : code & 15];
            }
          }
          int64_t end = pos + static_cast<int64_t>(n) * nch;
          if (end > line_end) break;
          int t = 0;
          do {
            memcpy(out + pos, clr[t], static_cast<size_t>(nch));
            t ^= 1;
          } while ((pos += nch) < end);
        } else if (code > 2) {
          if (pos + static_cast<int64_t>(code) * nch > line_end) break;
          int sz = (((code + 1) >> 1) + 1) & ~1;
          s.bytes(src.data(), sz);
          for (int x = 0; x < code; ++x, pos += nch) {
            int idx = (src[x >> 1] >> ((x & 1) ? 0 : 4)) & 15;
            if (color)
              pix(out + pos, h.palette[idx]);
            else
              out[pos] = gray_palette[idx];
          }
        } else {
          int64_t x_shift3 = line_end - pos;
          if (code == 2) {
            x_shift3 = static_cast<int64_t>(s.byte()) * nch;
            s.byte();
          }
          pos = fill_uni(out, pos, line_end, step, width3, y, H, x_shift3, c0,
                         nch);
          if (y >= H) break;
        }
      }
    } else {
      int line_end_flag = 0;
      for (;;) {
        int code = s.word();
        int n = code & 255;
        code >>= 8;
        if (n != 0) {
          int prev_y = y;
          int64_t n3 = static_cast<int64_t>(n) * nch;
          if (pos + n3 > line_end) break;
          uint8_t clr[3];
          if (color) {
            clr[0] = h.palette[code].b;
            clr[1] = h.palette[code].g;
            clr[2] = h.palette[code].r;
          } else {
            clr[0] = gray_palette[code];
          }
          pos = fill_uni(out, pos, line_end, step, width3, y, H, n3, clr, nch);
          line_end_flag = y - prev_y;
          if (y >= H) break;
        } else if (code > 2) {
          int prev_y = y;
          int64_t code3 = static_cast<int64_t>(code) * nch;
          if (pos + code3 > line_end) break;
          int sz = (code + 1) & ~1;
          s.bytes(src.data(), sz);
          for (int x = 0; x < code; ++x, pos += nch) {
            if (color)
              pix(out + pos, h.palette[src[x]]);
            else
              out[pos] = gray_palette[src[x]];
          }
          line_end_flag = y - prev_y;
          if (y >= H) break;
        } else {
          int64_t x_shift3 = line_end - pos;
          int64_t y_shift = H - y;
          if (code || !line_end_flag || x_shift3 < width3) {
            if (code == 2) {
              x_shift3 = static_cast<int64_t>(s.byte()) * nch;
              y_shift = s.byte();
            }
            if (code != 0) x_shift3 += y_shift * width3;
            if (y >= H) break;
            pos = fill_uni(out, pos, line_end, step, width3, y, H, x_shift3,
                           c0, nch);
            if (y >= H) break;
          }
          line_end_flag = 0;
          if (y >= H) break;
        }
      }
    }
  } else {
    for (int y = 0; y < H; ++y) {
      uint8_t* d = row_ptr(y);
      s.bytes(src.data(), src_pitch);
      const uint8_t* p = src.data();
      switch (h.bpp) {
        case 1:
        case 4:
        case 8:
          for (int x = 0; x < W; ++x) {
            int idx = h.bpp == 8 ? p[x]
                      : h.bpp == 4
                          ? (p[x >> 1] >> ((x & 1) ? 0 : 4)) & 15
                          : (p[x >> 3] >> (7 - (x & 7))) & 1;
            if (color)
              pix(d + 3 * x, h.palette[idx]);
            else
              d[x] = gray_palette[idx];
          }
          break;
        case 15:
        case 16:
          for (int x = 0; x < W; ++x) {
            int t = p[2 * x] | (p[2 * x + 1] << 8);
            int b = (t << 3) & 0xf8;
            int g = h.bpp == 15 ? (t >> 2) & 0xf8 : (t >> 3) & 0xfc;
            int r = h.bpp == 15 ? (t >> 7) & 0xf8 : (t >> 8) & 0xf8;
            if (color) {
              d[3 * x] = static_cast<uint8_t>(b);
              d[3 * x + 1] = static_cast<uint8_t>(g);
              d[3 * x + 2] = static_cast<uint8_t>(r);
            } else {
              d[x] = luma14(b, g, r);
            }
          }
          break;
        case 24:
        case 32: {
          const int k = h.bpp / 8;
          for (int x = 0; x < W; ++x) {
            const uint8_t* q = p + k * x;
            if (!color && h.alpha_mask)   // cv2's 32-bit read with an alpha
              // mask: float weights summed R, G, B in order, truncated
              d[x] = static_cast<uint8_t>(0.299f * q[2] + 0.587f * q[1] + 0.114f * q[0]);
            else if (!color)
              d[x] = luma14(q[0], q[1], q[2]);
            else
              memcpy(d + channels * x, q, static_cast<size_t>(channels));
          }
          break;
        }
        default:
          fail("BMP bit depth not read");
      }
    }
  }
  if (h.bottom_up) {
    std::vector<uint8_t> tmp(static_cast<size_t>(step));
    for (int y = 0; y < H / 2; ++y) {
      memcpy(tmp.data(), row_ptr(y), static_cast<size_t>(step));
      memcpy(row_ptr(y), row_ptr(H - 1 - y), static_cast<size_t>(step));
      memcpy(row_ptr(H - 1 - y), tmp.data(), static_cast<size_t>(step));
    }
  }
}

// ------------------------------------------------------------------ PxM --

struct Pxm {
  int width = 0, height = 0, bpp = 0, maxval = 0;
  bool binary = false;
  int64_t offset = 0;
  int cn() const { return bpp > 8 ? 3 : 1; }
  int depth() const { return maxval > 255 ? 2 : 1; }
};

inline bool is_digit(int c) { return c >= '0' && c <= '9'; }
inline bool is_space(int c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\v' || c == '\f' ||
         c == '\r';
}

// ReadNumber of grfmt_pxm.cpp
int read_number(Stream& s, int maxdigits = 0) {
  int code = s.byte();
  while (!is_digit(code)) {
    if (code == '#') {
      do {
        code = s.byte();
      } while (code != '\n' && code != '\r');
      code = s.byte();
    } else if (is_space(code)) {
      while (is_space(code)) code = s.byte();
    } else {
      fail("PxM: unexpected byte " + std::to_string(code) + " in a number");
    }
  }
  int64_t val = 0;
  int digits = 0;
  do {
    val = val * 10 + (code - '0');
    if (val > 0x7fffffff) fail("PxM: number too large");
    digits++;
    if (maxdigits != 0 && digits >= maxdigits) break;
    code = s.byte();
  } while (is_digit(code));
  return static_cast<int>(val);
}

Pxm pxm_header(Stream& s) {
  Pxm h;
  if (s.byte() != 'P') fail("not a PxM file");
  int code = s.byte();
  switch (code) {
    case '1':
    case '4':
      h.bpp = 1;
      break;
    case '2':
    case '5':
      h.bpp = 8;
      break;
    case '3':
    case '6':
      h.bpp = 24;
      break;
    default:
      fail("not a PBM / PGM / PPM file");
  }
  h.binary = code >= '4';
  h.width = read_number(s);
  h.height = read_number(s);
  h.maxval = h.bpp == 1 ? 1 : read_number(s);
  if (h.maxval > 65535) fail("PxM maxval above 65535");
  if (!(h.width > 0 && h.height > 0 && h.maxval > 0))
    fail("PxM size or maxval out of range");
  h.offset = s.pos;
  return h;
}

void pxm_decode(const uint8_t* buf, int64_t len, int channels, int depth,
                uint8_t* out, int64_t outlen) {
  Stream s(buf, len);
  Pxm h = pxm_header(s);
  const bool color = channels > 1;
  const int bit_depth = h.depth() * 8;   // of the file's own type
  const int out_bytes = depth;           // 1 or 2, as cv2's read asks
  if (out_bytes == 2 && bit_depth != 16) fail("16 bits asked of an 8-bit file");
  if (outlen != static_cast<int64_t>(h.width) * h.height * channels * out_bytes)
    fail("output buffer of the wrong size");
  const int nch = h.cn();
  const int64_t width3 = static_cast<int64_t>(h.width) * nch;
  const int64_t src_pitch =
      (static_cast<int64_t>(h.width) * h.bpp * (bit_depth / 8) + 7) / 8;
  uint8_t gray_palette[256] = {0};
  if (bit_depth == 8)
    for (int i = 0; i <= h.maxval; ++i)
      gray_palette[i] = static_cast<uint8_t>((i * 255 / h.maxval) ^
                                             (h.bpp == 1 ? 255 : 0));
  s.pos = h.offset;
  const int64_t row_out = static_cast<int64_t>(h.width) * channels * out_bytes;
  if (h.bpp == 1) {
    std::vector<uint8_t> src(static_cast<size_t>(std::max<int64_t>(src_pitch, h.width)));
    for (int y = 0; y < h.height; ++y) {
      uint8_t* d = out + y * row_out;
      if (!h.binary) {
        for (int x = 0; x < h.width; ++x) src[x] = read_number(s, 1) != 0;
      } else {
        s.bytes(src.data(), src_pitch);
      }
      for (int x = 0; x < h.width; ++x) {
        int bit = h.binary ? (src[x >> 3] >> (7 - (x & 7))) & 1 : src[x];
        if (color) {
          uint8_t v = bit ? 0 : 255;   // FillGrayPalette(palette, 1, true)
          d[3 * x] = d[3 * x + 1] = d[3 * x + 2] = v;
        } else {
          d[x] = gray_palette[bit];
        }
      }
    }
    return;
  }
  std::vector<uint8_t> src(static_cast<size_t>(std::max<int64_t>(width3 * 2, src_pitch)));
  uint16_t* s16 = reinterpret_cast<uint16_t*>(src.data());
  for (int y = 0; y < h.height; ++y) {
    uint8_t* d = out + y * row_out;
    if (!h.binary) {
      for (int64_t x = 0; x < width3; ++x) {
        int code = read_number(s);
        if (static_cast<unsigned>(code) > static_cast<unsigned>(h.maxval))
          code = h.maxval;
        if (bit_depth == 8)
          src[x] = gray_palette[code];
        else
          s16[x] = static_cast<uint16_t>(code);
      }
    } else {
      s.bytes(src.data(), src_pitch);
      if (bit_depth == 16)
        for (int64_t x = 0; x < width3; ++x)
          s16[x] = static_cast<uint16_t>((src[2 * x] << 8) | src[2 * x + 1]);
    }
    if (out_bytes == 1 && bit_depth == 16)
      for (int64_t x = 0; x < width3; ++x)
        src[x] = static_cast<uint8_t>(s16[x] >> 8);
    if (out_bytes == 1) {
      if (nch == 1) {
        if (color)
          for (int x = 0; x < h.width; ++x)
            d[3 * x] = d[3 * x + 1] = d[3 * x + 2] = src[x];
        else
          memcpy(d, src.data(), static_cast<size_t>(h.width));
      } else if (color) {
        for (int x = 0; x < h.width; ++x) {   // RGB -> BGR
          d[3 * x] = src[3 * x + 2];
          d[3 * x + 1] = src[3 * x + 1];
          d[3 * x + 2] = src[3 * x];
        }
      } else {
        for (int x = 0; x < h.width; ++x)
          d[x] = luma14(src[3 * x + 2], src[3 * x + 1], src[3 * x]);
      }
    } else {
      uint16_t* d16 = reinterpret_cast<uint16_t*>(d);
      if (nch == 1) {
        if (color)
          for (int x = 0; x < h.width; ++x)
            d16[3 * x] = d16[3 * x + 1] = d16[3 * x + 2] = s16[x];
        else
          memcpy(d16, s16, static_cast<size_t>(h.width) * 2);
      } else if (color) {
        for (int x = 0; x < h.width; ++x) {
          d16[3 * x] = s16[3 * x + 2];
          d16[3 * x + 1] = s16[3 * x + 1];
          d16[3 * x + 2] = s16[3 * x];
        }
      } else {   // icvCvt_BGRA2Gray_16u_CnC1R, swapped channels
        for (int x = 0; x < h.width; ++x)
          d16[x] = static_cast<uint16_t>(
              (s16[3 * x + 2] * kCB + s16[3 * x + 1] * kCG +
               s16[3 * x] * kCR + (1 << 13)) >> 14);
      }
    }
  }
}

// ----------------------------------------------------- TIFF LZW, PackBits --

// tif_lzw.c's LZWDecode (codes most significant bit first, the width
// growing one code early) or, with `compat`, LZWDecodeCompat (least
// significant bit first, no early change), as libtiff picks them by the
// first bytes. Up to `cap` bytes are written; `*failed` is set where libtiff
// reports an error (a corrupted code, or data that end before `cap` bytes),
// the bytes written so far kept, as TIFFReadEncodedStrip leaves them.
int64_t lzw_decode(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap,
                   bool compat, bool* failed) {
  struct Entry {
    int next = -1;
    uint8_t value = 0, firstchar = 0;
    int length = 0;
  };
  std::vector<Entry> tab(4096);
  for (int i = 0; i < 256; ++i) {
    tab[i].value = tab[i].firstchar = static_cast<uint8_t>(i);
    tab[i].length = 1;
  }
  int64_t bitsleft = n * 8, ip = 0, op = 0;
  uint64_t nextdata = 0;
  int nextbits = 0, nbits = 9, mask = 511, free_ent = 258, old = 0;
  int maxcode = 510;   // LZWPreDecode: dec_nbitsmask - 1, for either style
  bool cleared = false;   // no entry can be added before the first clear
  *failed = false;
  auto next = [&]() -> int {
    if (bitsleft < nbits) return 257;   // "not terminated with EOI code"
    bitsleft -= nbits;
    if (compat) {
      nextdata |= static_cast<uint64_t>(in[ip++]) << nextbits;
      nextbits += 8;
      if (nextbits < nbits) {
        nextdata |= static_cast<uint64_t>(in[ip++]) << nextbits;
        nextbits += 8;
      }
      int code = static_cast<int>(nextdata & static_cast<uint64_t>(mask));
      nextdata >>= nbits;
      nextbits -= nbits;
      return code;
    }
    nextdata = (nextdata << 8) | in[ip++];
    nextbits += 8;
    if (nextbits < nbits) {
      nextdata = (nextdata << 8) | in[ip++];
      nextbits += 8;
    }
    nextbits -= nbits;
    return static_cast<int>((nextdata >> nextbits) & static_cast<uint64_t>(mask));
  };
  auto corrupted = [&] {
    *failed = true;
    return op;
  };
  while (op < cap) {
    int code = next();
    if (code == 257) break;
    if (code == 256) {
      do {
        free_ent = 258;
        for (int i = 258; i < 4096; ++i) tab[i] = Entry{};
        nbits = 9;
        mask = 511;
        maxcode = compat ? 511 : 510;
        code = next();
      } while (code == 256);
      if (code == 257) break;
      if (code > 256) return corrupted();
      out[op++] = static_cast<uint8_t>(code);
      old = code;
      cleared = true;
      continue;
    }
    if (!cleared || free_ent >= 4096) return corrupted();
    Entry& e = tab[free_ent];
    e.next = old;
    e.firstchar = tab[old].firstchar;
    e.length = tab[old].length + 1;
    e.value = code < free_ent ? tab[code].firstchar : e.firstchar;
    if (++free_ent > maxcode) {
      nbits = std::min(nbits + 1, 12);
      mask = (1 << nbits) - 1;
      maxcode = compat ? mask : mask - 1;
    }
    old = code;
    if (code < 256) {
      out[op++] = static_cast<uint8_t>(code);
      continue;
    }
    int len = tab[code].length;
    if (len == 0) return corrupted();   // "Wrong length of decoded string"
    // a string longer than the room left gives its first bytes
    int c = code;
    while (tab[c].length > cap - op) c = tab[c].next;
    const int keep = tab[c].length;
    for (int k = keep - 1; k >= 0; --k) {
      out[op + k] = tab[c].value;
      c = tab[c].next;
    }
    op += keep;
  }
  if (op < cap) *failed = true;   // "Not enough data"
  return op;
}

// tif_packbits.c's PackBitsDecode: a run or a literal cut short by the end
// of the data ends the decode; `*failed` where fewer than `cap` bytes came.
int64_t packbits_decode(const uint8_t* in, int64_t n, uint8_t* out,
                        int64_t cap, bool* failed) {
  int64_t ip = 0, op = 0;
  while (ip < n && op < cap) {
    int64_t c = static_cast<int8_t>(in[ip++]);
    if (c < 0) {
      if (c == -128) continue;
      int64_t k = std::min<int64_t>(1 - c, cap - op);
      if (ip >= n) break;
      memset(out + op, in[ip++], static_cast<size_t>(k));
      op += k;
    } else {
      int64_t k = std::min<int64_t>(c + 1, cap - op);
      if (n - ip < k) break;
      memcpy(out + op, in + ip, static_cast<size_t>(k));
      ip += k;
      op += k;
    }
  }
  *failed = op < cap;
  return op;
}


// ---------------------------------------------------------- CCITT fax ----

// tif_fax3.c's decoders of CCITT RLE (Compression 2), Group 3 (3; 1D or,
// with T4Options bit 0, 2D rows tagged after each EOL) and Group 4 (4), as
// libtiff runs them: the T.4 code tables looked up 7 / 12 / 13 bits at a
// time least significant bit first (each byte's bits reversed unless
// FillOrder is 2), zero bits padded past the data, runs cleaned up where a
// row's runs miss its width, and a bad code ending its row rather than the
// strip. Each row is filled as _TIFFFax3fillruns fills it (1 for black).
namespace fax {

enum State : uint8_t {
  kNull, kPass, kHoriz, kV0, kVR, kVL, kExt, kTermW, kTermB, kMakeUpW,
  kMakeUpB, kMakeUp, kEOL
};
struct Ent {
  uint8_t state = kNull, width = 0;
  uint32_t param = 0;
};

const char* const kWhiteTerm[64] = {
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111",
    "10011", "10100", "00111", "01000", "001000", "000011", "110100",
    "110101", "101010", "101011", "0100111", "0001100", "0001000",
    "0010111", "0000011", "0000100", "0101000", "0101011", "0010011",
    "0100100", "0011000", "00000010", "00000011", "00011010", "00011011",
    "00010010", "00010011", "00010100", "00010101", "00010110", "00010111",
    "00101000", "00101001", "00101010", "00101011", "00101100", "00101101",
    "00000100", "00000101", "00001010", "00001011", "01010010", "01010011",
    "01010100", "01010101", "00100100", "00100101", "01011000", "01011001",
    "01011010", "01011011", "01001010", "01001011", "00110010", "00110011",
    "00110100"};
const char* const kWhiteMakeUp[27] = {
    "11011", "10010", "010111", "0110111", "00110110", "00110111",
    "01100100", "01100101", "01101000", "01100111", "011001100",
    "011001101", "011010010", "011010011", "011010100", "011010101",
    "011010110", "011010111", "011011000", "011011001", "011011010",
    "011011011", "010011000", "010011001", "010011010", "011000",
    "010011011"};
const char* const kBlackTerm[64] = {
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011",
    "000101", "000100", "0000100", "0000101", "0000111", "00000100",
    "00000111", "000011000", "0000010111", "0000011000", "0000001000",
    "00001100111", "00001101000", "00001101100", "00000110111",
    "00000101000", "00000010111", "00000011000", "000011001010",
    "000011001011", "000011001100", "000011001101", "000001101000",
    "000001101001", "000001101010", "000001101011", "000011010010",
    "000011010011", "000011010100", "000011010101", "000011010110",
    "000011010111", "000001101100", "000001101101", "000011011010",
    "000011011011", "000001010100", "000001010101", "000001010110",
    "000001010111", "000001100100", "000001100101", "000001010010",
    "000001010011", "000000100100", "000000110111", "000000111000",
    "000000100111", "000000101000", "000001011000", "000001011001",
    "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111"};
const char* const kBlackMakeUp[27] = {
    "0000001111", "000011001000", "000011001001", "000001011011",
    "000000110011", "000000110100", "000000110101", "0000001101100",
    "0000001101101", "0000001001010", "0000001001011", "0000001001100",
    "0000001001101", "0000001110010", "0000001110011", "0000001110100",
    "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010",
    "0000001011011", "0000001100100", "0000001100101"};
const char* const kExtMakeUp[13] = {
    "00000001000", "00000001100", "00000001101", "000000010010",
    "000000010011", "000000010100", "000000010101", "000000010110",
    "000000010111", "000000011100", "000000011101", "000000011110",
    "000000011111"};

// every index of a `bits`-wide table whose low bits are `code` (first bit
// lowest) gets the entry
void put(std::vector<Ent>& tab, int bits, const char* code, uint8_t state,
         uint32_t param) {
  const int n = static_cast<int>(strlen(code));
  int low = 0;
  for (int i = 0; i < n; ++i) low |= (code[i] - '0') << i;
  for (int hi = 0; hi < (1 << (bits - n)); ++hi) {
    Ent& e = tab[(hi << n) | low];
    e.state = state;
    e.width = static_cast<uint8_t>(n);
    e.param = param;
  }
}

struct Tables {
  std::vector<Ent> main = std::vector<Ent>(128),
                   white = std::vector<Ent>(4096),
                   black = std::vector<Ent>(8192);
  Tables() {
    put(main, 7, "0001", kPass, 0);
    put(main, 7, "001", kHoriz, 0);
    put(main, 7, "1", kV0, 0);
    put(main, 7, "011", kVR, 1);
    put(main, 7, "000011", kVR, 2);
    put(main, 7, "0000011", kVR, 3);
    put(main, 7, "010", kVL, 1);
    put(main, 7, "000010", kVL, 2);
    put(main, 7, "0000010", kVL, 3);
    put(main, 7, "0000001", kExt, 0);
    put(main, 7, "0000000", kEOL, 0);
    for (int i = 0; i < 64; ++i) {
      put(white, 12, kWhiteTerm[i], kTermW, i);
      put(black, 13, kBlackTerm[i], kTermB, i);
    }
    for (int i = 0; i < 27; ++i) {
      put(white, 12, kWhiteMakeUp[i], kMakeUpW, 64 * (i + 1));
      put(black, 13, kBlackMakeUp[i], kMakeUpB, 64 * (i + 1));
    }
    for (int i = 0; i < 13; ++i) {
      put(white, 12, kExtMakeUp[i], kMakeUp, 1792 + 64 * i);
      put(black, 13, kExtMakeUp[i], kMakeUp, 1792 + 64 * i);
    }
    put(white, 12, "00000000000", kEOL, 0);
    put(black, 13, "00000000000", kEOL, 0);
  }
};

// _TIFFFax3fillruns: runs alternate white, black from the row's start
void fill_runs(uint8_t* row, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0;
  for (; runs < erun; runs += 2) {
    uint32_t run = runs[0];
    if (x + run > lastx || run > lastx) run = runs[0] = lastx - x;
    x += run;
    run = runs[1];
    if (x + run > lastx || run > lastx) run = runs[1] = lastx - x;
    for (uint32_t k = 0; k < run; ++k, ++x)
      row[x >> 3] |= static_cast<uint8_t>(0x80 >> (x & 7));
  }
}

// One strip or tile: `rows` rows of `width` pixels into `out` (zeroed,
// ceil(width / 8) bytes a row). Returns false where libtiff's decode
// returns an error (the data end before the last row); `*damaged` is set
// where a row met a bad code, the data's end or a length not its width.
bool decode(const uint8_t* in, int64_t n, int compression, bool two_d,
            bool lsb_first, uint32_t width, int rows, uint8_t* out,
            bool* damaged) {
  static const Tables tabs;
  const int64_t rowbytes = (width + 7) / 8;
  const bool ref_line = compression == 4 || (compression == 3 && two_d);
  // Fax3SetupState: roundup(width + 1, 32) runs, twice that with a
  // reference line
  const uint32_t nruns = (width + 32) / 32 * 32 * (ref_line ? 2 : 1);
  std::vector<uint32_t> runs(2 * static_cast<size_t>(std::max<uint32_t>(nruns, 1)), 0);
  uint32_t* thisrun = runs.data();
  uint32_t* refruns = ref_line ? runs.data() + nruns : nullptr;
  if (refruns) {
    refruns[0] = width;
    refruns[1] = 0;
  }
  const int64_t lastx = width;
  int64_t ip = 0;
  uint32_t acc = 0;
  int avail = 0;
  auto byte = [&]() -> uint32_t {
    uint8_t b = in[ip++];
    if (!lsb_first) {   // FillOrder 1: the bitmap reverses each byte
      b = static_cast<uint8_t>(((b * 0x0802LU & 0x22110LU) |
                                (b * 0x8020LU & 0x88440LU)) * 0x10101LU >> 16);
    }
    return b;
  };
  // NeedBits8 / NeedBits16: false where the data are gone with no bits left
  auto need8 = [&](int k) -> bool {
    if (avail < k) {
      if (ip >= n) {
        if (avail == 0) return false;
        avail = k;
      } else {
        acc |= byte() << avail;
        avail += 8;
      }
    }
    return true;
  };
  auto need16 = [&](int k) -> bool {
    if (avail < k) {
      if (ip >= n) {
        if (avail == 0) return false;
        avail = k;
      } else {
        acc |= byte() << avail;
        if ((avail += 8) < k) {
          if (ip >= n) {
            avail = k;
          } else {
            acc |= byte() << avail;
            avail += 8;
          }
        }
      }
    }
    return true;
  };
  auto bits = [&](int k) -> uint32_t { return acc & ((1u << k) - 1); };
  auto clr = [&](int k) {
    avail -= k;
    acc >>= k;
  };
  int eol = 0;
  uint32_t* pa = nullptr;
  int64_t a0 = 0, run_length = 0;
  bool overflow = false;
  auto setvalue = [&](int64_t x) {
    if (pa >= thisrun + nruns) {
      overflow = true;
      return;
    }
    *pa++ = static_cast<uint32_t>(run_length + x);
    a0 += x;
    run_length = 0;
  };
  auto cleanup = [&]() {
    if (run_length) setvalue(0);
    if (a0 != lastx) {
      *damaged = true;
      while (a0 > lastx && pa > thisrun) a0 -= *--pa;
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if ((pa - thisrun) & 1) setvalue(0);
        setvalue(lastx - a0);
      } else if (a0 > lastx) {
        setvalue(lastx);
        setvalue(0);
      }
    }
  };
  // a run of `color` (0 white) with its make-up codes: 1 done, 0 bad code
  // or EOL (the row ends), -1 out of data
  auto run = [&](int color, bool stop_at_eol) -> int {
    for (;;) {
      const bool w = color == 0;
      if (!need16(w ? 12 : 13)) return -1;
      const Ent& e = (w ? tabs.white : tabs.black)[bits(w ? 12 : 13)];
      clr(e.width);
      if (e.state == kEOL && stop_at_eol) {
        eol = 1;
        return 0;
      }
      if (e.state == (w ? kTermW : kTermB)) {
        setvalue(e.param);
        return 1;
      }
      if (e.state == (w ? kMakeUpW : kMakeUpB) || e.state == kMakeUp) {
        a0 += e.param;
        run_length += e.param;
        continue;
      }
      *damaged = true;   // unexpected(): the row ends here
      return 0;
    }
  };
  // EXPAND1D: 1 the row is whole (or ended by a bad code), -1 out of data
  auto expand1d = [&]() -> int {
    for (;;) {
      int r = run(0, true);
      if (r < 0) break;
      if (r == 0 || a0 >= lastx) { cleanup(); return 1; }
      r = run(1, true);
      if (r < 0) break;
      if (r == 0 || a0 >= lastx) { cleanup(); return 1; }
      if (pa - thisrun >= 2 && *(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;
    }
    cleanup();
    return -1;
  };
  // EXPAND2D against the reference runs
  auto expand2d = [&]() -> int {
    uint32_t* pb = refruns;
    int64_t b1 = *pb++;
    auto check_b1 = [&] {
      if (pa != thisrun)
        while (b1 <= a0 && b1 < lastx) {
          b1 += pb[0] + pb[1];
          pb += 2;
        }
    };
    while (a0 < lastx) {
      if (pa >= thisrun + nruns) { overflow = true; return -1; }
      if (!need8(7)) { cleanup(); return -1; }
      const Ent& e = tabs.main[bits(7)];
      clr(e.width);
      switch (e.state) {
        case kPass:
          check_b1();
          b1 += *pb++;
          run_length += b1 - a0;
          a0 = b1;
          b1 += *pb++;
          break;
        case kHoriz: {
          const int first = (pa - thisrun) & 1;
          int r = run(first, false);
          if (r > 0) r = run(1 - first, false);
          if (r < 0) { cleanup(); return -1; }
          if (r == 0) {
            cleanup();
            return 1;
          }
          check_b1();
          break;
        }
        case kV0:
        case kVR:
          check_b1();
          setvalue(b1 - a0 + (e.state == kVR ? e.param : 0));
          b1 += *pb++;
          break;
        case kVL:
          check_b1();
          if (b1 < a0 + static_cast<int64_t>(e.param)) {
            *damaged = true;
            cleanup();
            return 1;
          }
          setvalue(b1 - a0 - e.param);
          b1 -= *--pb;
          break;
        case kExt:
          *pa++ = static_cast<uint32_t>(lastx - a0);
          *damaged = true;
          cleanup();
          return 1;
        case kEOL:
          *pa++ = static_cast<uint32_t>(lastx - a0);
          if (!need8(4)) { cleanup(); return -1; }
          clr(4);
          eol = 1;
          cleanup();
          return 1;
        default:
          *damaged = true;
          cleanup();
          return 1;
      }
      if (overflow) return -1;
    }
    if (run_length) {
      if (run_length + a0 < lastx) {   // expect a final V0
        if (!need8(1)) { cleanup(); return -1; }
        if (!bits(1)) {
          *damaged = true;
          cleanup();
          return 1;
        }
        clr(1);
      }
      setvalue(0);
    }
    cleanup();
    return 1;
  };
  // SYNC_EOL: false where the data end first
  auto sync_eol = [&]() -> bool {
    if (eol == 0) {
      for (;;) {
        if (!need16(11)) return false;
        if (bits(11) == 0) break;
        clr(1);
      }
    }
    for (;;) {
      if (!need8(8)) return false;
      if (bits(8)) break;
      clr(8);
    }
    while (bits(1) == 0) clr(1);
    clr(1);
    eol = 0;
    return true;
  };
  for (int line = 0; line < rows; ++line) {
    uint8_t* row = out + line * rowbytes;
    a0 = 0;
    run_length = 0;
    pa = thisrun;
    int r;
    if (compression == 2) {
      r = expand1d();
      if (r > 0) clr(avail & 7);   // each row starts on a byte
    } else if (compression == 3) {
      if (!sync_eol()) {
        cleanup();
        fill_runs(row, thisrun, pa, width);
        return false;
      }
      if (two_d) {
        if (!need8(1)) {
          cleanup();
          fill_runs(row, thisrun, pa, width);
          return false;
        }
        const bool is1d = bits(1);
        clr(1);
        r = is1d ? expand1d() : expand2d();
      } else {
        r = expand1d();
      }
    } else {
      r = expand2d();
      if (r > 0 && eol) r = -1;
    }
    if (overflow) return false;
    fill_runs(row, thisrun, pa, width);
    if (r < 0 || eol) *damaged = true;
    if (r < 0) {
      // Fax4Decode does not fail a strip that ends early after a row
      if (compression == 4) return line != 0;
      return false;
    }
    if (ref_line) {
      if (pa < thisrun + nruns) setvalue(0);
      std::swap(thisrun, refruns);
    }
  }
  return true;
}

}  // namespace fax


// ------------------------------------------------------------ WebP VP8L --

struct LBits {   // VP8L's LSB-first bit reader
  const uint8_t* d;
  int64_t n;
  int64_t pos = 0;   // in bits
  bool eos = false;
  LBits(const uint8_t* d_, int64_t n_) : d(d_), n(n_) {}
  uint32_t peek(int k) const {
    uint64_t v = 0;
    int64_t byte = pos >> 3;
    int shift = static_cast<int>(pos & 7);
    for (int i = 0; i < 4; ++i)
      if (byte + i < n) v |= static_cast<uint64_t>(d[byte + i]) << (8 * i);
    return static_cast<uint32_t>((v >> shift) & ((1ull << k) - 1));
  }
  uint32_t read(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    pos += k;
    if (pos > n * 8) eos = true;
    return v;
  }
};

struct Huff {   // a canonical prefix code, read first-bit-is-MSB
  std::vector<uint16_t> lut;   // 8 stream bits -> symbol << 4 | length
  std::vector<int> count, first_index, symbols;
  int single = -1;             // a code of one symbol reads no bits
  int max_len = 0;
  bool build(const std::vector<int>& lengths) {
    const int n = static_cast<int>(lengths.size());
    count.assign(16, 0);
    int nonzero = 0, last = -1;
    for (int i = 0; i < n; ++i)
      if (lengths[i] > 0) {
        count[lengths[i]]++;
        nonzero++;
        last = i;
      }
    if (nonzero == 0) return false;
    if (nonzero == 1) {
      single = last;
      return true;
    }
    // complete, not over-subscribed (libwebp refuses anything else)
    int left = 1;
    for (int l = 1; l < 16; ++l) {
      left <<= 1;
      left -= count[l];
      if (left < 0) return false;
    }
    if (left != 0) return false;
    first_index.assign(16, 0);
    for (int l = 1; l < 16; ++l) first_index[l] = first_index[l - 1] + count[l - 1];
    symbols.assign(static_cast<size_t>(nonzero), 0);
    std::vector<int> offs(first_index);
    for (int i = 0; i < n; ++i)
      if (lengths[i] > 0) symbols[offs[lengths[i]]++] = i;
    lut.assign(256, 0);
    int code = 0;
    int idx = 0;
    for (int l = 1; l < 16; ++l) {
      for (int k = 0; k < count[l]; ++k, ++code, ++idx) {
        if (l <= 8) {
          int rev = 0;
          for (int b = 0; b < l; ++b) rev |= ((code >> b) & 1) << (l - 1 - b);
          for (int fill = rev; fill < 256; fill += 1 << l)
            lut[fill] = static_cast<uint16_t>((symbols[idx] << 4) | l);
        }
        max_len = l;
      }
      code <<= 1;
    }
    return true;
  }
  int read(LBits& br) const {
    if (single >= 0) return single;
    uint16_t e = lut[br.peek(8)];
    if (e != 0) {
      br.read(e & 15);
      return e >> 4;
    }
    int code = 0, first = 0, index = 0;
    for (int l = 1; l < 16; ++l) {
      code |= static_cast<int>(br.read(1));
      int c = count[l];
      if (code - c < first) return symbols[index + (code - first)];
      index += c;
      first += c;
      first <<= 1;
      code <<= 1;
    }
    fail("invalid VP8L prefix code");
  }
};

const int kCodeLengthCodeOrder[19] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                      7,  8,  9, 10, 11, 12, 13, 14, 15};
const uint8_t kCodeToPlane[120] = {
    24,  7,   23,  25,  40,  6,   39,  41,  22,  26,  38,  42,
    56,  5,   55,  57,  21,  27,  54,  58,  37,  43,  72,  4,
    71,  73,  20,  28,  53,  59,  70,  74,  36,  44,  88,  69,
    75,  52,  60,  3,   87,  89,  19,  29,  86,  90,  35,  45,
    68,  76,  85,  91,  51,  61,  104, 2,   103, 105, 18,  30,
    102, 106, 34,  46,  84,  92,  67,  77,  101, 107, 50,  62,
    120, 1,   119, 121, 83,  93,  17,  31,  100, 108, 66,  78,
    118, 122, 33,  47,  117, 123, 49,  63,  99,  109, 82,  94,
    0,   116, 124, 65,  79,  16,  32,  98,  110, 48,  115, 125,
    81,  95,  64,  114, 126, 97,  111, 80,  113, 127, 96,  112};

struct VP8L {
  LBits br;
  struct Transform {
    int type, bits, xsize;
    std::vector<uint32_t> data;
  };
  std::vector<Transform> transforms;
  unsigned seen = 0;
  int height = 0;
  VP8L(const uint8_t* d, int64_t n) : br(d, n) {}

  void read_code(int alphabet, Huff& h) {
    std::vector<int> lengths(static_cast<size_t>(alphabet), 0);
    if (br.read(1)) {   // simple code
      int num = static_cast<int>(br.read(1)) + 1;
      int first_bits = br.read(1) == 0 ? 1 : 8;
      int sym = static_cast<int>(br.read(first_bits));
      if (sym >= alphabet) fail("VP8L symbol out of range");
      lengths[sym] = 1;
      if (num == 2) {
        sym = static_cast<int>(br.read(8));
        if (sym >= alphabet) fail("VP8L symbol out of range");
        lengths[sym] = 1;
      }
    } else {
      std::vector<int> cl(19, 0);
      int num_codes = static_cast<int>(br.read(4)) + 4;
      for (int i = 0; i < num_codes; ++i)
        cl[kCodeLengthCodeOrder[i]] = static_cast<int>(br.read(3));
      Huff lh;
      if (!lh.build(cl)) fail("invalid VP8L code length code");
      int max_symbol = alphabet;
      if (br.read(1)) {
        int nbits = 2 + 2 * static_cast<int>(br.read(3));
        max_symbol = 2 + static_cast<int>(br.read(nbits));
        if (max_symbol > alphabet) fail("VP8L max_symbol out of range");
      }
      int prev = 8, sym = 0;
      while (sym < alphabet) {
        if (max_symbol-- == 0) break;
        int code_len = lh.read(br);
        if (code_len < 16) {
          lengths[sym++] = code_len;
          if (code_len != 0) prev = code_len;
        } else {
          static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
          int slot = code_len - 16;
          int repeat = static_cast<int>(br.read(extra[slot])) + offset[slot];
          if (sym + repeat > alphabet) fail("VP8L code lengths overrun");
          int v = code_len == 16 ? prev : 0;
          while (repeat-- > 0) lengths[sym++] = v;
        }
      }
    }
    if (br.eos) fail("VP8L data ends early");
    if (!h.build(lengths)) fail("invalid VP8L prefix code");
  }

  static int sub_size(int size, int bits) {
    return (size + (1 << bits) - 1) >> bits;
  }

  int copy_distance(int sym) {
    if (sym < 4) return sym + 1;
    int extra = (sym - 2) >> 1;
    int offset = (2 + (sym & 1)) << extra;
    return offset + static_cast<int>(br.read(extra)) + 1;
  }

  // DecodeImageStream of vp8l_dec.c; returns the decoded ARGB pixels of an
  // xsize x ysize image (for the main image, at the width its transforms
  // leave)
  std::vector<uint32_t> decode_stream(int xsize, int ysize, bool level0) {
    int txs = xsize;
    if (level0) {
      while (br.read(1)) {
        Transform t;
        t.type = static_cast<int>(br.read(2));
        if (seen & (1u << t.type)) fail("VP8L transform repeated");
        seen |= 1u << t.type;
        t.xsize = txs;
        t.bits = 0;
        if (t.type == 0 || t.type == 1) {
          t.bits = static_cast<int>(br.read(3)) + 2;
          t.data = decode_stream(sub_size(t.xsize, t.bits),
                                 sub_size(height, t.bits), false);
        } else if (t.type == 3) {
          int num_colors = static_cast<int>(br.read(8)) + 1;
          t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1
                   : num_colors > 2 ? 2 : 3;
          txs = sub_size(t.xsize, t.bits);
          std::vector<uint32_t> pal = decode_stream(num_colors, 1, false);
          const int final_num = 1 << (8 >> t.bits);
          t.data.assign(static_cast<size_t>(final_num), 0);
          t.data[0] = pal[0];
          for (int i = 1; i < num_colors; ++i) {   // deltas, per byte
            uint32_t a = pal[i], b = t.data[i - 1];
            uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
            uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
            t.data[i] = (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
          }
        }
        transforms.push_back(std::move(t));
      }
    }
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = static_cast<int>(br.read(4));
      if (cache_bits < 1 || cache_bits > 11) fail("VP8L colour cache size");
    }
    // prefix code groups and the image that maps tiles to them
    int meta_bits = 0, meta_xsize = 0;
    std::vector<uint32_t> meta;
    int num_groups = 1;
    if (level0 && br.read(1)) {
      meta_bits = static_cast<int>(br.read(3)) + 2;
      meta_xsize = sub_size(txs, meta_bits);
      meta = decode_stream(meta_xsize, sub_size(ysize, meta_bits), false);
      for (auto& m : meta) {
        m = (m >> 8) & 0xffff;
        num_groups = std::max(num_groups, static_cast<int>(m) + 1);
      }
    }
    const int cache_size = cache_bits ? 1 << cache_bits : 0;
    std::vector<Huff> groups(static_cast<size_t>(num_groups) * 5);
    static const int alphabet[5] = {256 + 24, 256, 256, 256, 40};
    for (int g = 0; g < num_groups; ++g)
      for (int j = 0; j < 5; ++j)
        read_code(alphabet[j] + (j == 0 ? cache_size : 0), groups[g * 5 + j]);
    // the pixels
    const int64_t total = static_cast<int64_t>(txs) * ysize;
    std::vector<uint32_t> px(static_cast<size_t>(total));
    std::vector<uint32_t> cache(static_cast<size_t>(cache_size));
    const int cache_shift = 32 - cache_bits;
    auto insert = [&](uint32_t argb) {
      if (cache_size) cache[(0x1e35a7bdu * argb) >> cache_shift] = argb;
    };
    int64_t pos = 0;
    while (pos < total) {
      const int x = static_cast<int>(pos % txs), y = static_cast<int>(pos / txs);
      const Huff* g = &groups[0];
      if (!meta.empty())
        g = &groups[static_cast<size_t>(
                meta[(y >> meta_bits) * meta_xsize + (x >> meta_bits)]) * 5];
      int code = g[0].read(br);
      if (code < 256) {
        uint32_t r = static_cast<uint32_t>(g[1].read(br));
        uint32_t b = static_cast<uint32_t>(g[2].read(br));
        uint32_t a = static_cast<uint32_t>(g[3].read(br));
        uint32_t argb = (a << 24) | (r << 16) | (static_cast<uint32_t>(code) << 8) | b;
        px[pos++] = argb;
        insert(argb);
      } else if (code < 256 + 24) {
        int length = copy_distance(code - 256);
        int dist_code = copy_distance(g[4].read(br));
        int64_t dist;
        if (dist_code > 120) {
          dist = dist_code - 120;
        } else {
          int dc = kCodeToPlane[dist_code - 1];
          dist = static_cast<int64_t>(dc >> 4) * txs + (8 - (dc & 0xf));
          if (dist < 1) dist = 1;
        }
        if (pos < dist || total - pos < length) fail("VP8L backward reference out of range");
        for (int k = 0; k < length; ++k, ++pos) {
          px[pos] = px[pos - dist];
          insert(px[pos]);
        }
      } else if (code < 256 + 24 + cache_size) {
        uint32_t argb = cache[code - 280];
        px[pos++] = argb;
        insert(argb);
      } else {
        fail("VP8L symbol out of range");
      }
      if (br.eos) fail("VP8L data ends early");
    }
    return px;
  }

  // the main image with its transforms undone, xsize x ysize ARGB
  std::vector<uint32_t> decode_image(int xsize, int ysize) {
    height = ysize;
    std::vector<uint32_t> px = decode_stream(xsize, ysize, true);
    for (int i = static_cast<int>(transforms.size()) - 1; i >= 0; --i)
      px = inverse(transforms[i], px, ysize);
    return px;
  }

  static uint32_t add(uint32_t a, uint32_t b) {
    uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
    uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
    return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
  }
  static uint32_t avg2(uint32_t a, uint32_t b) {
    return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
  }
  static int clip255(int a) { return a < 0 ? 0 : a > 255 ? 255 : a; }
  static int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }
  static uint32_t select(uint32_t a, uint32_t b, uint32_t c) {
    int pa_minus_pb = 0;
    for (int s = 0; s < 32; s += 8)
      pa_minus_pb += sub3((a >> s) & 0xff, (b >> s) & 0xff, (c >> s) & 0xff);
    return pa_minus_pb <= 0 ? a : b;
  }
  static uint32_t full(uint32_t c0, uint32_t c1, uint32_t c2) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
      int v = clip255(static_cast<int>((c0 >> s) & 0xff) +
                      static_cast<int>((c1 >> s) & 0xff) -
                      static_cast<int>((c2 >> s) & 0xff));
      out |= static_cast<uint32_t>(v) << s;
    }
    return out;
  }
  static uint32_t half(uint32_t c0, uint32_t c1, uint32_t c2) {
    uint32_t ave = avg2(c0, c1), out = 0;
    for (int s = 0; s < 32; s += 8) {
      int a = static_cast<int>((ave >> s) & 0xff);
      int b = static_cast<int>((c2 >> s) & 0xff);
      out |= static_cast<uint32_t>(clip255(a + (a - b) / 2)) << s;
    }
    return out;
  }
  static uint32_t predict(int mode, uint32_t L, const uint32_t* top) {
    switch (mode) {
      case 1: return L;
      case 2: return top[0];
      case 3: return top[1];
      case 4: return top[-1];
      case 5: return avg2(avg2(L, top[1]), top[0]);
      case 6: return avg2(L, top[-1]);
      case 7: return avg2(L, top[0]);
      case 8: return avg2(top[-1], top[0]);
      case 9: return avg2(top[0], top[1]);
      case 10: return avg2(avg2(L, top[-1]), avg2(top[0], top[1]));
      case 11: return select(top[0], L, top[-1]);
      case 12: return full(L, top[0], top[-1]);
      case 13: return half(L, top[0], top[-1]);
      default: return 0xff000000u;   // 0, and 14 / 15 as libwebp takes them
    }
  }

  std::vector<uint32_t> inverse(const Transform& t, std::vector<uint32_t>& in,
                                int ysize) {
    const int w = t.xsize;
    if (t.type == 0) {   // predictor
      std::vector<uint32_t>& out = in;   // in place, row by row
      const int tiles = sub_size(w, t.bits);
      out[0] = add(in[0], 0xff000000u);
      for (int x = 1; x < w; ++x) out[x] = add(in[x], out[x - 1]);
      for (int y = 1; y < ysize; ++y) {
        uint32_t* row = out.data() + static_cast<int64_t>(y) * w;
        const uint32_t* up = row - w;
        row[0] = add(row[0], up[0]);
        const uint32_t* modes = t.data.data() + (y >> t.bits) * tiles;
        for (int x = 1; x < w; ++x) {
          int mode = (modes[x >> t.bits] >> 8) & 0xf;
          row[x] = add(row[x], predict(mode, row[x - 1], up + x));
        }
      }
      return std::move(out);
    }
    if (t.type == 1) {   // cross colour
      const int tiles = sub_size(w, t.bits);
      for (int y = 0; y < ysize; ++y) {
        uint32_t* row = in.data() + static_cast<int64_t>(y) * w;
        const uint32_t* m = t.data.data() + (y >> t.bits) * tiles;
        for (int x = 0; x < w; ++x) {
          uint32_t code = m[x >> t.bits];
          int8_t g2r = static_cast<int8_t>(code & 0xff);
          int8_t g2b = static_cast<int8_t>((code >> 8) & 0xff);
          int8_t r2b = static_cast<int8_t>((code >> 16) & 0xff);
          uint32_t argb = row[x];
          int8_t green = static_cast<int8_t>(argb >> 8);
          int new_red = (argb >> 16) & 0xff;
          int new_blue = argb & 0xff;
          new_red += (static_cast<int>(g2r) * green) >> 5;
          new_red &= 0xff;
          new_blue += (static_cast<int>(g2b) * green) >> 5;
          new_blue += (static_cast<int>(r2b) * static_cast<int8_t>(new_red)) >> 5;
          new_blue &= 0xff;
          row[x] = (argb & 0xff00ff00u) | (static_cast<uint32_t>(new_red) << 16) |
                   static_cast<uint32_t>(new_blue);
        }
      }
      return std::move(in);
    }
    if (t.type == 2) {   // subtract green
      for (auto& argb : in) {
        uint32_t green = (argb >> 8) & 0xff;
        uint32_t rb = (argb & 0x00ff00ffu) + ((green << 16) | green);
        argb = (argb & 0xff00ff00u) | (rb & 0x00ff00ffu);
      }
      return std::move(in);
    }
    // colour indexing
    const int bits_per_pixel = 8 >> t.bits;
    const int count_mask = (1 << t.bits) - 1;
    const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
    const int packed_w = sub_size(w, t.bits);
    std::vector<uint32_t> out(static_cast<size_t>(w) * ysize);
    for (int y = 0; y < ysize; ++y) {
      const uint32_t* src = in.data() + static_cast<int64_t>(y) * packed_w;
      uint32_t* dst = out.data() + static_cast<int64_t>(y) * w;
      uint32_t packed = 0;
      for (int x = 0; x < w; ++x) {
        if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
        dst[x] = t.data[packed & bit_mask];
        packed >>= bits_per_pixel;
      }
    }
    return out;
  }
};

// ------------------------------------------------------------- WebP VP8 --
// The tables of RFC 6386 (section 14.1 and 13), in libwebp's order of the
// intra 4x4 modes: DC, TM, VE, HE, RD, VR, LD, VL, HD, HU.

static const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

static const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

static const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};

static const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

static const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};
const int8_t kYModesIntra4[18] = {-0, 1, -1, 2, -2, 3, 4, 6, -3, 5,
                                  -4, -5, -6, 7, -7, 8, -8, -9};

enum { B_DC = 0, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU,
       DC_NOTOP = 10, DC_NOLEFT, DC_NOTOPLEFT };

struct BoolDec {   // RFC 6386 section 7
  const uint8_t* p;
  const uint8_t* end;
  uint32_t value = 0;
  int range = 255, bit_count = 0, past = 0;
  void init(const uint8_t* d, int64_t n) {
    p = d;
    end = d + n;
    value = (static_cast<uint32_t>(next()) << 8) | next();
    range = 255;
    bit_count = 0;
  }
  int next() {
    if (p < end) return *p++;
    ++past;
    return 0;
  }
  // libwebp loads one byte later than this reader and reports the end of
  // the data at its first byte past the end
  bool eof() const { return past >= 2; }
  int get(int prob) {
    uint32_t split = 1 + (((range - 1) * prob) >> 8);
    uint32_t big = split << 8;
    int bit;
    if (value >= big) {
      bit = 1;
      range -= split;
      value -= big;
    } else {
      bit = 0;
      range = split;
    }
    while (range < 128) {
      value <<= 1;
      range <<= 1;
      if (++bit_count == 8) {
        bit_count = 0;
        value |= next();
      }
    }
    return bit;
  }
  int value_bits(int n) {
    int v = 0;
    while (n-- > 0) v = (v << 1) | get(0x80);
    return v;
  }
  int signed_bits(int n) {
    int v = value_bits(n);
    return get(0x80) ? -v : v;
  }
};

constexpr int BPS = 32;

inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : static_cast<uint8_t>(v); }

#define AVG3(a, b, c) (static_cast<uint8_t>(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) (((a) + (b) + 1) >> 1)
#define DST(x, y) dst[(x) + (y) * BPS]

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1 + y * BPS];
    for (int x = 0; x < size; ++x) dst[x + y * BPS] = clip8(top[x] + l - tl);
  }
}

void fill_block(uint8_t* dst, int v, int size) {
  for (int y = 0; y < size; ++y) memset(dst + y * BPS, v, static_cast<size_t>(size));
}

void pred_large(uint8_t* dst, int mode, int size) {   // 16x16 luma, 8x8 chroma
  const int sh = size == 16 ? 4 : 3;
  switch (mode) {
    case B_DC: {
      int dc = size;
      for (int j = 0; j < size; ++j) dc += dst[j - BPS] + dst[-1 + j * BPS];
      fill_block(dst, dc >> (sh + 1), size);
      break;
    }
    case DC_NOTOP: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      fill_block(dst, dc >> sh, size);
      break;
    }
    case DC_NOLEFT: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[j - BPS];
      fill_block(dst, dc >> sh, size);
      break;
    }
    case DC_NOTOPLEFT:
      fill_block(dst, 0x80, size);
      break;
    case B_TM:
      true_motion(dst, size);
      break;
    case B_VE:
      for (int y = 0; y < size; ++y) memcpy(dst + y * BPS, dst - BPS, static_cast<size_t>(size));
      break;
    case B_HE:
      for (int y = 0; y < size; ++y) memset(dst + y * BPS, dst[-1 + y * BPS], static_cast<size_t>(size));
      break;
  }
}

void pred4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  switch (mode) {
    case B_DC: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill_block(dst, static_cast<int>(dc >> 3), 4);
      break;
    }
    case B_TM:
      true_motion(dst, 4);
      break;
    case B_VE: {
      const uint8_t vals[4] = {AVG3(top[-1], top[0], top[1]), AVG3(top[0], top[1], top[2]),
                               AVG3(top[1], top[2], top[3]), AVG3(top[2], top[3], top[4])};
      for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE: {
      const int A = dst[-1 - BPS], B = dst[-1], C = dst[-1 + BPS],
                D = dst[-1 + 2 * BPS], E = dst[-1 + 3 * BPS];
      memset(dst + 0 * BPS, AVG3(A, B, C), 4);
      memset(dst + 1 * BPS, AVG3(B, C, D), 4);
      memset(dst + 2 * BPS, AVG3(C, D, E), 4);
      memset(dst + 3 * BPS, AVG3(D, E, E), 4);
      break;
    }
    case B_RD: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS], X = dst[-1 - BPS], A = dst[0 - BPS],
                B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS];
      DST(0, 3) = AVG3(J, K, L);
      DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
      DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
      DST(3, 0) = AVG3(D, C, B);
      break;
    }
    case B_LD: {
      const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS],
                E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
      DST(0, 0) = AVG3(A, B, C);
      DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
      DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
      DST(3, 3) = AVG3(G, H, H);
      break;
    }
    case B_VR: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS],
                C = dst[2 - BPS], D = dst[3 - BPS];
      DST(0, 0) = DST(1, 2) = AVG2(X, A);
      DST(1, 0) = DST(2, 2) = AVG2(A, B);
      DST(2, 0) = DST(3, 2) = AVG2(B, C);
      DST(3, 0) = AVG2(C, D);
      DST(0, 3) = AVG3(K, J, I);
      DST(0, 2) = AVG3(J, I, X);
      DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
      DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
      DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
      DST(3, 1) = AVG3(B, C, D);
      break;
    }
    case B_VL: {
      const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS],
                E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
      DST(0, 0) = AVG2(A, B);
      DST(1, 0) = DST(0, 2) = AVG2(B, C);
      DST(2, 0) = DST(1, 2) = AVG2(C, D);
      DST(3, 0) = DST(2, 2) = AVG2(D, E);
      DST(0, 1) = AVG3(A, B, C);
      DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
      DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
      DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
      DST(3, 2) = AVG3(E, F, G);
      DST(3, 3) = AVG3(F, G, H);
      break;
    }
    case B_HU: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS];
      DST(0, 0) = AVG2(I, J);
      DST(2, 0) = DST(0, 1) = AVG2(J, K);
      DST(2, 1) = DST(0, 2) = AVG2(K, L);
      DST(1, 0) = AVG3(I, J, K);
      DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
      DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
    }
    case B_HD: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS], X = dst[-1 - BPS], A = dst[0 - BPS],
                B = dst[1 - BPS], C = dst[2 - BPS];
      DST(0, 0) = DST(2, 1) = AVG2(I, X);
      DST(0, 1) = DST(2, 2) = AVG2(J, I);
      DST(0, 2) = DST(2, 3) = AVG2(K, J);
      DST(0, 3) = AVG2(L, K);
      DST(3, 0) = AVG3(A, B, C);
      DST(2, 0) = AVG3(X, A, B);
      DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
      DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
      DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
      DST(1, 3) = AVG3(L, K, J);
      break;
    }
  }
}

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void idct_add(const int16_t* in, uint8_t* dst) {   // TransformOne
  int C[16];
  int* tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
    tmp++;
    dst += BPS;
  }
}

void inverse_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    out += 64;
  }
}

// loop filters (libwebp dsp/dec.c)
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
         std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i)
    if (needs_filter(p + i * vstride, hstride, t2)) do_filter2(p + i * vstride, hstride);
}

void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh,
                 int ithresh, int hev_thresh, bool edge) {
  const int t2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, t2, ithresh)) {
      if (hev(p, hstride, hev_thresh))
        do_filter2(p, hstride);
      else if (edge)
        do_filter6(p, hstride);
      else
        do_filter4(p, hstride);
    }
    p += vstride;
  }
}

struct VP8 {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  // headers
  bool use_segment = false, update_map = false, absolute_delta = false;
  int quantizer[4] = {0}, filter_strength[4] = {0};
  uint8_t seg_probs[3] = {255, 255, 255};
  bool simple = false;
  int level = 0, sharpness = 0;
  bool use_lf_delta = false;
  int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
  int filter_type = 0;
  int num_parts = 1;
  BoolDec br, parts[8];
  struct Quant {
    int y1[2], y2[2], uv[2];
  } dqm[4];
  uint8_t proba[4][8][3][11];
  bool use_skip = false;
  int skip_p = 0;
  struct FInfo {
    int limit = 0, ilevel = 0, hev_thresh = 0;
    bool inner = false;
  } fstrengths[4][2];
  // planes (macroblock-aligned)
  std::vector<uint8_t> Y, U, V;
  int ystride = 0, uvstride = 0;

  void headers(const uint8_t* d, int64_t n) {
    if (n < 10) fail("VP8 frame too short");
    const uint32_t bits = d[0] | (d[1] << 8) | (d[2] << 16);
    const bool key = !(bits & 1);
    const int profile = (bits >> 1) & 7;
    const bool show = (bits >> 4) & 1;
    const uint32_t part_len = bits >> 5;
    if (!key) fail("VP8: not a key frame");
    if (profile > 3) fail("VP8: incorrect keyframe parameters");
    if (!show) fail("VP8: frame not displayable");
    if (d[3] != 0x9d || d[4] != 0x01 || d[5] != 0x2a) fail("VP8: bad start code");
    width = ((d[7] << 8) | d[6]) & 0x3fff;
    height = ((d[9] << 8) | d[8]) & 0x3fff;
    if (width == 0 || height == 0) fail("VP8: zero size");
    mb_w = (width + 15) >> 4;
    mb_h = (height + 15) >> 4;
    d += 10;
    n -= 10;
    if (part_len > n) fail("VP8: bad partition length");
    br.init(d, part_len);
    const uint8_t* rest = d + part_len;
    int64_t rest_n = n - part_len;
    br.get(0x80);   // colour space
    br.get(0x80);   // clamping type
    // segment header
    use_segment = br.get(0x80);
    if (use_segment) {
      update_map = br.get(0x80);
      if (br.get(0x80)) {
        absolute_delta = br.get(0x80);
        for (int s = 0; s < 4; ++s) quantizer[s] = br.get(0x80) ? br.signed_bits(7) : 0;
        for (int s = 0; s < 4; ++s) filter_strength[s] = br.get(0x80) ? br.signed_bits(6) : 0;
      }
      if (update_map)
        for (int s = 0; s < 3; ++s) seg_probs[s] = br.get(0x80) ? br.value_bits(8) : 255;
    }
    // filter header
    simple = br.get(0x80);
    level = br.value_bits(6);
    sharpness = br.value_bits(3);
    use_lf_delta = br.get(0x80);
    if (use_lf_delta && br.get(0x80)) {
      for (int i = 0; i < 4; ++i)
        if (br.get(0x80)) ref_lf_delta[i] = br.signed_bits(6);
      for (int i = 0; i < 4; ++i)
        if (br.get(0x80)) mode_lf_delta[i] = br.signed_bits(6);
    }
    filter_type = level == 0 ? 0 : simple ? 1 : 2;
    // partitions
    num_parts = 1 << br.value_bits(2);
    const int last = num_parts - 1;
    if (rest_n < 3 * last) fail("VP8: not enough data for the partitions");
    const uint8_t* sz = rest;
    const uint8_t* part_start = rest + 3 * last;
    int64_t left = rest_n - 3 * last;
    for (int p = 0; p < last; ++p) {
      int64_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (psize > left) psize = left;
      parts[p].init(part_start, psize);
      part_start += psize;
      left -= psize;
      sz += 3;
    }
    parts[last].init(part_start, left);
    if (!(part_start < rest + rest_n)) fail("VP8: partitions end early");
    // quantizers
    const int base_q0 = br.value_bits(7);
    const int dqy1_dc = br.get(0x80) ? br.signed_bits(4) : 0;
    const int dqy2_dc = br.get(0x80) ? br.signed_bits(4) : 0;
    const int dqy2_ac = br.get(0x80) ? br.signed_bits(4) : 0;
    const int dquv_dc = br.get(0x80) ? br.signed_bits(4) : 0;
    const int dquv_ac = br.get(0x80) ? br.signed_bits(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment) {
        q = quantizer[i];
        if (!absolute_delta) q += base_q0;
      } else {
        if (i > 0) {
          dqm[i] = dqm[0];
          continue;
        }
        q = base_q0;
      }
      Quant& m = dqm[i];
      m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
      m.y1[1] = kAcTable[clip(q + 0, 127)];
      m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
      m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
    }
    br.get(0x80);   // refresh entropy probs, ignored on a key frame
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p)
            proba[t][b][c][p] = br.get(kCoeffsUpdateProba[t][b][c][p])
                                    ? static_cast<uint8_t>(br.value_bits(8))
                                    : kCoeffsProba0[t][b][c][p];
    use_skip = br.get(0x80);
    if (use_skip) skip_p = br.value_bits(8);
    if (br.eof()) fail("VP8: cannot parse the frame header");
    // filter strengths
    if (filter_type > 0) {
      for (int s = 0; s < 4; ++s) {
        int base = level;
        if (use_segment) {
          base = filter_strength[s];
          if (!absolute_delta) base += level;
        }
        for (int i4 = 0; i4 <= 1; ++i4) {
          FInfo& info = fstrengths[s][i4];
          int lv = base;
          if (use_lf_delta) {
            lv += ref_lf_delta[0];
            if (i4) lv += mode_lf_delta[0];
          }
          lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
          if (lv > 0) {
            int ilevel = lv;
            if (sharpness > 0) {
              ilevel >>= sharpness > 4 ? 2 : 1;
              if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
            }
            if (ilevel < 1) ilevel = 1;
            info.ilevel = ilevel;
            info.limit = 2 * lv + ilevel;
            info.hev_thresh = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
          } else {
            info.limit = 0;
          }
          info.inner = i4;
        }
      }
    }
  }

  int get_large(BoolDec& b, const uint8_t* p) {
    int v;
    if (!b.get(p[3])) {
      if (!b.get(p[4]))
        v = 2;
      else
        v = 3 + b.get(p[5]);
    } else {
      if (!b.get(p[6])) {
        if (!b.get(p[7])) {
          v = 5 + b.get(159);
        } else {
          v = 7 + 2 * b.get(165);
          v += b.get(145);
        }
      } else {
        const int bit1 = b.get(p[8]);
        const int bit0 = b.get(p[9 + bit1]);
        const int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + b.get(*tab);
        v += 3 + (8 << cat);
      }
    }
    return v;
  }

  // GetCoeffs: the tokens of one 4x4 block from position n; returns the
  // position after the last non-zero one
  int get_coeffs(BoolDec& b, int type, int ctx, const int* dq, int n, int16_t* out) {
    const uint8_t* p = proba[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!b.get(p[0])) return n;
      while (!b.get(p[1])) {
        ++n;
        if (n == 16) return 16;
        p = proba[type][kBands[n]][0];
      }
      int v;
      if (!b.get(p[2])) {
        v = 1;
        p = proba[type][kBands[n + 1]][1];
      } else {
        v = get_large(b, p);
        p = proba[type][kBands[n + 1]][2];
      }
      out[kZigzag[n]] = static_cast<int16_t>((b.get(0x80) ? -v : v) * dq[n > 0]);
    }
    return 16;
  }

  void decode(const uint8_t* d, int64_t n) {
    headers(d, n);
    ystride = mb_w * 16;
    uvstride = mb_w * 8;
    Y.assign(static_cast<size_t>(ystride) * mb_h * 16, 0);
    U.assign(static_cast<size_t>(uvstride) * mb_h * 8, 0);
    V.assign(static_cast<size_t>(uvstride) * mb_h * 8, 0);
    // contexts
    std::vector<uint8_t> intra_t(static_cast<size_t>(mb_w) * 4, B_DC);
    std::vector<uint8_t> top_nz(static_cast<size_t>(mb_w) * 9, 0);   // 4 y, 2 u, 2 v, dc
    std::vector<FInfo> finfo(static_cast<size_t>(mb_w) * mb_h);
    struct Top {
      uint8_t y[16], u[8], v[8];
    };
    std::vector<Top> top(static_cast<size_t>(mb_w));
    uint8_t yuv[BPS * 17 + BPS * 9];
    uint8_t* const ydst = yuv + BPS * 1 + 8;
    uint8_t* const udst = ydst + BPS * 16 + BPS;
    uint8_t* const vdst = udst + 16;
    int16_t coeffs[384];
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
      uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
      uint8_t left_nz[9] = {0};
      BoolDec& tb = parts[mb_y & (num_parts - 1)];
      for (int j = 0; j < 16; ++j) ydst[j * BPS - 1] = 129;
      for (int j = 0; j < 8; ++j) udst[j * BPS - 1] = vdst[j * BPS - 1] = 129;
      if (mb_y > 0) {
        ydst[-1 - BPS] = udst[-1 - BPS] = vdst[-1 - BPS] = 129;
      } else {
        memset(ydst - BPS - 1, 127, 16 + 4 + 1);
        memset(udst - BPS - 1, 127, 8 + 1);
        memset(vdst - BPS - 1, 127, 8 + 1);
      }
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        // modes (first partition)
        int segment = 0;
        if (update_map)
          segment = !br.get(seg_probs[0]) ? br.get(seg_probs[1]) : br.get(seg_probs[2]) + 2;
        int skip = use_skip ? br.get(skip_p) : 0;
        const bool is_i4x4 = !br.get(145);
        uint8_t imodes[16];
        uint8_t* tmodes = &intra_t[static_cast<size_t>(mb_x) * 4];
        if (!is_i4x4) {
          const int ymode = br.get(156) ? (br.get(128) ? B_TM : B_HE)
                                        : (br.get(163) ? B_VE : B_DC);
          imodes[0] = static_cast<uint8_t>(ymode);
          memset(tmodes, ymode, 4);
          memset(intra_l, ymode, 4);
        } else {
          uint8_t* modes = imodes;
          for (int y = 0; y < 4; ++y) {
            int ymode = intra_l[y];
            for (int x = 0; x < 4; ++x) {
              const uint8_t* prob = kBModesProba[tmodes[x]][ymode];
              int i = kYModesIntra4[br.get(prob[0])];
              while (i > 0) i = kYModesIntra4[2 * i + br.get(prob[i])];
              ymode = -i;
              tmodes[x] = static_cast<uint8_t>(ymode);
            }
            memcpy(modes, tmodes, 4);
            modes += 4;
            intra_l[y] = static_cast<uint8_t>(ymode);
          }
        }
        const int uvmode = !br.get(142) ? B_DC : !br.get(114) ? B_VE
                           : br.get(183) ? B_TM : B_HE;
        if (br.eof()) fail("VP8: premature end of partition 0");
        // residuals (token partition)
        uint8_t* tnz = &top_nz[static_cast<size_t>(mb_x) * 9];
        memset(coeffs, 0, sizeof(coeffs));
        const Quant& q = dqm[segment];
        if (!skip) {
          bool any = false;
          int first = 0, ytype = 3;
          if (!is_i4x4) {
            int16_t dc[16] = {0};
            const int ctx = tnz[8] + left_nz[8];
            const int nz = get_coeffs(tb, 1, ctx, q.y2, 0, dc);
            tnz[8] = left_nz[8] = nz > 0;
            if (nz > 1) {
              inverse_wht(dc, coeffs);
            } else {
              const int dc0 = (dc[0] + 3) >> 3;
              for (int i = 0; i < 256; i += 16) coeffs[i] = static_cast<int16_t>(dc0);
            }
            for (int i = 0; i < 256; i += 16) any |= coeffs[i] != 0;
            first = 1;
            ytype = 0;
          }
          for (int y = 0; y < 4; ++y)
            for (int x = 0; x < 4; ++x) {
              const int ctx = left_nz[y] + tnz[x];
              const int nz = get_coeffs(tb, ytype, ctx, q.y1, first, coeffs + (y * 4 + x) * 16);
              tnz[x] = left_nz[y] = nz > first;
              any |= nz > first;
            }
          for (int ch = 0; ch < 2; ++ch)
            for (int y = 0; y < 2; ++y)
              for (int x = 0; x < 2; ++x) {
                uint8_t& t = tnz[4 + ch * 2 + x];
                uint8_t& l = left_nz[4 + ch * 2 + y];
                const int nz = get_coeffs(tb, 2, l + t, q.uv, 0,
                                          coeffs + 256 + ch * 64 + (y * 2 + x) * 16);
                t = l = nz > 0;
                any |= nz > 0;
              }
          skip = !any;
        } else {
          memset(tnz, 0, 8);
          memset(left_nz, 0, 8);
          if (!is_i4x4) tnz[8] = left_nz[8] = 0;
        }
        if (tb.eof()) fail("VP8: premature end of file");
        if (filter_type > 0) {
          FInfo f = fstrengths[segment][is_i4x4];
          f.inner = f.inner || !skip;
          finfo[static_cast<size_t>(mb_y) * mb_w + mb_x] = f;
        }
        // reconstruction (ReconstructRow)
        if (mb_x > 0) {
          for (int j = -1; j < 16; ++j) memcpy(&ydst[j * BPS - 4], &ydst[j * BPS + 12], 4);
          for (int j = -1; j < 8; ++j) {
            memcpy(&udst[j * BPS - 4], &udst[j * BPS + 4], 4);
            memcpy(&vdst[j * BPS - 4], &vdst[j * BPS + 4], 4);
          }
        }
        Top& tp = top[mb_x];
        if (mb_y > 0) {
          memcpy(ydst - BPS, tp.y, 16);
          memcpy(udst - BPS, tp.u, 8);
          memcpy(vdst - BPS, tp.v, 8);
        }
        auto check_mode = [&](int mode) {
          if (mode == B_DC) {
            if (mb_x == 0) return mb_y == 0 ? static_cast<int>(DC_NOTOPLEFT) : static_cast<int>(DC_NOLEFT);
            return mb_y == 0 ? static_cast<int>(DC_NOTOP) : static_cast<int>(B_DC);
          }
          return mode;
        };
        if (is_i4x4) {
          uint8_t* top_right = ydst - BPS + 16;
          if (mb_y > 0) {
            if (mb_x >= mb_w - 1)
              memset(top_right, tp.y[15], 4);
            else
              memcpy(top_right, top[mb_x + 1].y, 4);
          }
          for (int r = 1; r <= 3; ++r) memcpy(top_right + 4 * r * BPS, top_right, 4);
          for (int k = 0; k < 16; ++k) {
            uint8_t* dst = ydst + (k & 3) * 4 + (k >> 2) * 4 * BPS;
            pred4(dst, imodes[k]);
            idct_add(coeffs + k * 16, dst);
          }
        } else {
          pred_large(ydst, check_mode(imodes[0]), 16);
          for (int k = 0; k < 16; ++k)
            idct_add(coeffs + k * 16, ydst + (k & 3) * 4 + (k >> 2) * 4 * BPS);
        }
        const int uvm = check_mode(uvmode);
        pred_large(udst, uvm, 8);
        pred_large(vdst, uvm, 8);
        for (int k = 0; k < 4; ++k) {
          const int off = (k & 1) * 4 + (k >> 1) * 4 * BPS;
          idct_add(coeffs + 256 + k * 16, udst + off);
          idct_add(coeffs + 320 + k * 16, vdst + off);
        }
        if (mb_y < mb_h - 1) {
          memcpy(tp.y, ydst + 15 * BPS, 16);
          memcpy(tp.u, udst + 7 * BPS, 8);
          memcpy(tp.v, vdst + 7 * BPS, 8);
        }
        for (int j = 0; j < 16; ++j)
          memcpy(&Y[static_cast<size_t>(mb_y * 16 + j) * ystride + mb_x * 16], ydst + j * BPS, 16);
        for (int j = 0; j < 8; ++j) {
          memcpy(&U[static_cast<size_t>(mb_y * 8 + j) * uvstride + mb_x * 8], udst + j * BPS, 8);
          memcpy(&V[static_cast<size_t>(mb_y * 8 + j) * uvstride + mb_x * 8], vdst + j * BPS, 8);
        }
      }
    }
    // the loop filter, macroblocks in raster order
    if (filter_type == 0) return;
    for (int mb_y = 0; mb_y < mb_h; ++mb_y)
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        const FInfo& f = finfo[static_cast<size_t>(mb_y) * mb_w + mb_x];
        const int limit = f.limit;
        if (limit == 0) continue;
        uint8_t* y = &Y[static_cast<size_t>(mb_y) * 16 * ystride + mb_x * 16];
        if (filter_type == 1) {
          if (mb_x > 0) simple_filter(y, 1, ystride, limit + 4);
          if (f.inner)
            for (int k = 4; k < 16; k += 4) simple_filter(y + k, 1, ystride, limit);
          if (mb_y > 0) simple_filter(y, ystride, 1, limit + 4);
          if (f.inner)
            for (int k = 4; k < 16; k += 4) simple_filter(y + k * ystride, ystride, 1, limit);
        } else {
          const int il = f.ilevel, ht = f.hev_thresh;
          uint8_t* u = &U[static_cast<size_t>(mb_y) * 8 * uvstride + mb_x * 8];
          uint8_t* v = &V[static_cast<size_t>(mb_y) * 8 * uvstride + mb_x * 8];
          const int us = uvstride, ys = ystride;
          if (mb_x > 0) {
            filter_loop(y, 1, ys, 16, limit + 4, il, ht, true);
            filter_loop(u, 1, us, 8, limit + 4, il, ht, true);
            filter_loop(v, 1, us, 8, limit + 4, il, ht, true);
          }
          if (f.inner) {
            for (int k = 4; k < 16; k += 4) filter_loop(y + k, 1, ys, 16, limit, il, ht, false);
            filter_loop(u + 4, 1, us, 8, limit, il, ht, false);
            filter_loop(v + 4, 1, us, 8, limit, il, ht, false);
          }
          if (mb_y > 0) {
            filter_loop(y, ys, 1, 16, limit + 4, il, ht, true);
            filter_loop(u, us, 1, 8, limit + 4, il, ht, true);
            filter_loop(v, us, 1, 8, limit + 4, il, ht, true);
          }
          if (f.inner) {
            for (int k = 4; k < 16; k += 4) filter_loop(y + k * ys, ys, 1, 16, limit, il, ht, false);
            filter_loop(u + 4 * us, us, 1, 8, limit, il, ht, false);
            filter_loop(v + 4 * us, us, 1, 8, limit, il, ht, false);
          }
        }
      }
  }
};

// libwebp's YUV -> RGB (dsp/yuv.h, 14-bit fixed point)
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) {
  return ((v & ~16383) == 0) ? static_cast<uint8_t>(v >> 6) : (v < 0) ? 0 : 255;
}
inline void yuv_to_bgr(int y, int u, int v, uint8_t* bgr) {
  bgr[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  bgr[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  bgr[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// libwebp's fancy upsampler (dsp/upsampling.c UPSAMPLE_FUNC) for one pair of
// output rows; `bottom_y` null for a single row
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y,
                   const uint8_t* top_u, const uint8_t* top_v,
                   const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len, int xstep) {
  const int last_pixel_pair = (len - 1) >> 1;
  auto load = [](int u, int v) { return static_cast<uint32_t>(u) | (static_cast<uint32_t>(v) << 16); };
  uint32_t tl_uv = load(top_u[0], top_v[0]);
  uint32_t l_uv = load(cur_u[0], cur_v[0]);
  {
    const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
    yuv_to_bgr(top_y[0], uv0 & 0xff, (uv0 >> 16), top_dst);
  }
  if (bottom_y != nullptr) {
    const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
    yuv_to_bgr(bottom_y[0], uv0 & 0xff, (uv0 >> 16), bottom_dst);
  }
  for (int x = 1; x <= last_pixel_pair; ++x) {
    const uint32_t t_uv = load(top_u[x], top_v[x]);
    const uint32_t uv = load(cur_u[x], cur_v[x]);
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    {
      const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
      const uint32_t uv1 = (diag_03 + t_uv) >> 1;
      yuv_to_bgr(top_y[2 * x - 1], uv0 & 0xff, (uv0 >> 16), top_dst + (2 * x - 1) * xstep);
      yuv_to_bgr(top_y[2 * x - 0], uv1 & 0xff, (uv1 >> 16), top_dst + (2 * x - 0) * xstep);
    }
    if (bottom_y != nullptr) {
      const uint32_t uv0 = (diag_03 + l_uv) >> 1;
      const uint32_t uv1 = (diag_12 + uv) >> 1;
      yuv_to_bgr(bottom_y[2 * x - 1], uv0 & 0xff, (uv0 >> 16), bottom_dst + (2 * x - 1) * xstep);
      yuv_to_bgr(bottom_y[2 * x + 0], uv1 & 0xff, (uv1 >> 16), bottom_dst + (2 * x + 0) * xstep);
    }
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    {
      const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
      yuv_to_bgr(top_y[len - 1], uv0 & 0xff, (uv0 >> 16), top_dst + (len - 1) * xstep);
    }
    if (bottom_y != nullptr) {
      const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
      yuv_to_bgr(bottom_y[len - 1], uv0 & 0xff, (uv0 >> 16), bottom_dst + (len - 1) * xstep);
    }
  }
}

// the frame to BGR(A) rows as EmitFancyRGB does it over the whole picture
void vp8_to_bgr(const VP8& f, uint8_t* out, int channels) {
  const int W = f.width, H = f.height;
  const int64_t stride = static_cast<int64_t>(W) * channels;
  auto yrow = [&](int y) { return &f.Y[static_cast<size_t>(y) * f.ystride]; };
  auto urow = [&](int y) { return &f.U[static_cast<size_t>(y) * f.uvstride]; };
  auto vrow = [&](int y) { return &f.V[static_cast<size_t>(y) * f.uvstride]; };
  upsample_pair(yrow(0), nullptr, urow(0), vrow(0), urow(0), vrow(0), out, nullptr, W, channels);
  int y = 1, k = 1;
  for (; y + 1 < H; y += 2, ++k)
    upsample_pair(yrow(y), yrow(y + 1), urow(k - 1), vrow(k - 1), urow(k), vrow(k),
                  out + y * stride, out + (y + 1) * stride, W, channels);
  if (y < H)   // the last row of an even height
    upsample_pair(yrow(y), nullptr, urow(k - 1), vrow(k - 1), urow(k - 1), vrow(k - 1),
                  out + y * stride, nullptr, W, channels);
}

// --------------------------------------------------------- WebP container --

inline uint32_t le32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<uint32_t>(p[3]) << 24);
}
inline uint32_t le24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }

struct WebP {
  int width = 0, height = 0;       // the image, or an animation's canvas
  bool has_alpha = false, animated = false, lossless = false;
  int fx = 0, fy = 0, fw = 0, fh = 0;   // the (first) frame in it
  const uint8_t* bits = nullptr;   // the VP8 / VP8L payload
  int64_t bits_size = 0;
  const uint8_t* alpha = nullptr;  // the ALPH payload
  int64_t alpha_size = 0;
};

WebP webp_bitstream(const uint8_t* p, int64_t left, uint32_t riff_size,
                    uint64_t total, bool all, bool optional);

// ParseHeadersInternal of libwebp's webp_dec.c; `all` is its have_all_data
// (set when decoding, clear for WebPGetFeatures, cv2's header read)
WebP webp_headers(const uint8_t* d, int64_t n, bool all) {
  WebP w;
  const uint8_t* p = d;
  int64_t left = n;
  uint32_t riff_size = 0;
  if (left >= 12 && !memcmp(p, "RIFF", 4)) {
    if (memcmp(p + 8, "WEBP", 4)) fail("WebP: wrong signature");
    riff_size = le32(p + 4);
    if (riff_size < 12) fail("WebP: RIFF size too small");
    if (riff_size > 0xfffffff6u) fail("WebP: RIFF size too large");
    if (all && riff_size > left - 8) fail("WebP: truncated file");
    p += 12;
    left -= 12;
  } else {
    fail("WebP: no RIFF header");
  }
  bool vp8x = false;
  uint32_t flags = 0;
  int canvas_w = 0, canvas_h = 0;
  if (left < 8) fail("WebP: not enough data");
  if (!memcmp(p, "VP8X", 4)) {
    if (le32(p + 4) != 10) fail("WebP: wrong VP8X chunk size");
    if (left < 18) fail("WebP: not enough data");
    vp8x = true;
    flags = le32(p + 8);
    canvas_w = 1 + static_cast<int>(le24(p + 12));
    canvas_h = 1 + static_cast<int>(le24(p + 15));
    if (static_cast<uint64_t>(canvas_w) * canvas_h >= (1ull << 32)) fail("WebP: canvas too large");
    p += 18;
    left -= 18;
  }
  w.animated = (flags & 0x02) != 0;
  w.has_alpha = (flags & 0x10) != 0;
  if (w.animated) {   // cv2 5.0 reads the first frame on a cleared canvas
    w.width = canvas_w;
    w.height = canvas_h;
    if (!all) return w;
    for (;;) {
      if (left < 8) fail("WebP: an animation without frames");
      const int64_t disk = (8ll + le32(p + 4) + 1) & ~1ll;
      if (!memcmp(p, "ANMF", 4)) break;
      if (left < disk) fail("WebP: not enough data");
      p += disk;
      left -= disk;
    }
    const int64_t size = std::min<int64_t>(le32(p + 4), left - 8);
    if (size < 16 + 8) fail("WebP: ANMF chunk too short");
    const uint8_t* f = p + 8;
    w.fx = 2 * static_cast<int>(le24(f));
    w.fy = 2 * static_cast<int>(le24(f + 3));
    w.fw = 1 + static_cast<int>(le24(f + 6));
    w.fh = 1 + static_cast<int>(le24(f + 9));
    if (w.fx + w.fw > canvas_w || w.fy + w.fh > canvas_h)
      fail("WebP: a frame outside the canvas");
    WebP frame = webp_bitstream(f + 16, size - 16, 0, 0, all, true);
    if (frame.width != w.fw || frame.height != w.fh)
      fail("WebP: a frame's size differs from its ANMF header");
    frame.width = canvas_w;
    frame.height = canvas_h;
    frame.fx = w.fx;
    frame.fy = w.fy;
    frame.fw = w.fw;
    frame.fh = w.fh;
    frame.has_alpha = w.has_alpha;
    frame.animated = true;
    return frame;
  }
  WebP b = webp_bitstream(p, left, riff_size, vp8x ? 22 : 0, all, vp8x);
  if (vp8x && (canvas_w != b.width || canvas_h != b.height))
    fail("WebP: VP8X canvas and frame sizes differ");
  b.fw = b.width;
  b.fh = b.height;
  return b;
}

// An image's chunks from its first optional one (`optional`: after VP8X,
// or in an ANMF frame) to its VP8 / VP8L bitstream: ParseOptionalChunks and
// ParseVP8Header of webp_dec.c. `total` counts the bytes the RIFF size
// must cover so far.
WebP webp_bitstream(const uint8_t* p, int64_t left, uint32_t riff_size,
                    uint64_t total, bool all, bool optional) {
  WebP w;
  if (left < 4) fail("WebP: not enough data");
  if (optional) {   // optional chunks up to VP8 / VP8L
    for (;;) {
      if (left < 8) fail("WebP: not enough data");
      uint32_t size = le32(p + 4);
      if (size > 0xfffffff6u) fail("WebP: chunk too large");
      uint64_t disk = (8ull + size + 1) & ~1ull;
      total += disk;
      if (riff_size > 0 && total > riff_size) fail("WebP: chunks overrun the RIFF size");
      if (!memcmp(p, "VP8 ", 4) || !memcmp(p, "VP8L", 4)) break;
      if (static_cast<uint64_t>(left) < disk) fail("WebP: not enough data");
      if (!memcmp(p, "ALPH", 4)) {
        w.alpha = p + 8;
        w.alpha_size = size;
      }
      p += disk;
      left -= static_cast<int64_t>(disk);
    }
  }
  if (left < 8) fail("WebP: not enough data");
  const bool is_vp8 = !memcmp(p, "VP8 ", 4), is_vp8l = !memcmp(p, "VP8L", 4);
  if (!is_vp8 && !is_vp8l) fail("WebP: no VP8 / VP8L chunk");
  uint32_t size = le32(p + 4);
  if (riff_size >= 12 && size > riff_size - 12) fail("WebP: inconsistent chunk size");
  if (all && size > left - 8) fail("WebP: truncated file");
  w.bits = p + 8;
  w.bits_size = std::min<int64_t>(size, left - 8);
  w.lossless = is_vp8l;
  if (!is_vp8l) {
    const uint8_t* b = w.bits;
    if (w.bits_size < 10) fail("WebP: not enough data");
    const uint32_t tag = b[0] | (b[1] << 8) | (b[2] << 16);
    if (b[3] != 0x9d || b[4] != 0x01 || b[5] != 0x2a) fail("VP8: bad start code");
    if ((tag & 1) || ((tag >> 1) & 7) > 3 || !((tag >> 4) & 1) || (tag >> 5) >= size)
      fail("VP8: not a displayable key frame");
    w.width = ((b[7] << 8) | b[6]) & 0x3fff;
    w.height = ((b[9] << 8) | b[8]) & 0x3fff;
    if (w.width == 0 || w.height == 0) fail("VP8: zero size");
  } else {
    const uint8_t* b = w.bits;
    if (w.bits_size < 5) fail("WebP: not enough data");
    if (b[0] != 0x2f || (b[4] >> 5) != 0) fail("VP8L: bad signature or version");
    LBits br(b + 1, 4);
    w.width = static_cast<int>(br.read(14)) + 1;
    w.height = static_cast<int>(br.read(14)) + 1;
    w.has_alpha = br.read(1);
  }
  w.has_alpha = w.has_alpha || w.alpha != nullptr;
  return w;
}

// the ALPH chunk (alpha_dec.c) into `plane`, width x height
void decode_alpha(const uint8_t* d, int64_t n, int width, int height,
                  std::vector<uint8_t>& plane) {
  if (n <= 1) fail("WebP: could not decode alpha data");
  const int method = d[0] & 3, filter = (d[0] >> 2) & 3,
            pre = (d[0] >> 4) & 3, rsrv = (d[0] >> 6) & 3;
  if (method > 1 || pre > 1 || rsrv != 0) fail("WebP: could not decode alpha data");
  const int64_t total = static_cast<int64_t>(width) * height;
  plane.assign(static_cast<size_t>(total), 0);
  if (method == 0) {
    if (n - 1 < total) fail("WebP: could not decode alpha data");
    memcpy(plane.data(), d + 1, static_cast<size_t>(total));
  } else {
    VP8L dec(d + 1, n - 1);
    std::vector<uint32_t> argb = dec.decode_image(width, height);
    for (int64_t i = 0; i < total; ++i) plane[i] = static_cast<uint8_t>((argb[i] >> 8) & 0xff);
  }
  if (filter == 0) return;
  for (int y = 0; y < height; ++y) {   // WebPUnfilters, in place
    uint8_t* row = plane.data() + static_cast<int64_t>(y) * width;
    const uint8_t* prev = y > 0 ? row - width : nullptr;
    if (prev == nullptr || filter == 1) {
      uint8_t pred = prev == nullptr ? 0 : prev[0];
      for (int i = 0; i < width; ++i) {
        row[i] = static_cast<uint8_t>(pred + row[i]);
        pred = row[i];
      }
    } else if (filter == 2) {
      for (int i = 0; i < width; ++i) row[i] = static_cast<uint8_t>(prev[i] + row[i]);
    } else {
      uint8_t top = prev[0], top_left = top, left = top;
      for (int i = 0; i < width; ++i) {
        top = prev[i];
        const int g = left + top - top_left;
        const int pred = (g & ~0xff) == 0 ? g : g < 0 ? 0 : 255;
        left = static_cast<uint8_t>(row[i] + pred);
        top_left = top;
        row[i] = left;
      }
    }
  }
}

// the image's pixels, fw x fh, BGR (channels 3) or BGRA (4)
void decode_frame(const WebP& w, int channels, uint8_t* out) {
  const int64_t total = static_cast<int64_t>(w.fw) * w.fh;
  if (w.lossless) {
    VP8L dec(w.bits + 5, w.bits_size - 5);
    std::vector<uint32_t> argb = dec.decode_image(w.fw, w.fh);
    for (int64_t i = 0; i < total; ++i) {
      const uint32_t v = argb[i];
      uint8_t* o = out + i * channels;
      o[0] = static_cast<uint8_t>(v);
      o[1] = static_cast<uint8_t>(v >> 8);
      o[2] = static_cast<uint8_t>(v >> 16);
      if (channels == 4) o[3] = static_cast<uint8_t>(v >> 24);
    }
    return;
  }
  VP8 dec;
  dec.decode(w.bits, w.bits_size);
  if (dec.width != w.fw || dec.height != w.fh) fail("VP8: frame size changed");
  vp8_to_bgr(dec, out, channels);
  if (channels == 4) {
    if (w.alpha != nullptr) {
      std::vector<uint8_t> plane;
      decode_alpha(w.alpha, w.alpha_size, w.fw, w.fh, plane);
      for (int64_t i = 0; i < total; ++i) out[i * 4 + 3] = plane[i];
    } else {
      for (int64_t i = 0; i < total; ++i) out[i * 4 + 3] = 255;
    }
  }
}

void webp_decode(const uint8_t* d, int64_t n, int channels, uint8_t* out, int64_t outlen) {
  WebP w = webp_headers(d, n, true);
  if (channels != 3 && channels != 4) fail("channels must be 3 or 4");
  if (outlen != static_cast<int64_t>(w.width) * w.height * channels)
    fail("output buffer of the wrong size");
  if (!w.animated) {
    decode_frame(w, channels, out);
    return;
  }
  // WebPAnimDecoder's first frame: a zeroed BGRA canvas, the frame's
  // pixels at its offset as they decode (no blending on a key frame)
  std::vector<uint8_t> frame(static_cast<size_t>(w.fw) * w.fh * 4);
  decode_frame(w, 4, frame.data());
  memset(out, 0, static_cast<size_t>(outlen));
  for (int y = 0; y < w.fh; ++y)
    for (int x = 0; x < w.fw; ++x) {
      const uint8_t* src = &frame[(static_cast<size_t>(y) * w.fw + x) * 4];
      uint8_t* dst = out + ((static_cast<int64_t>(y) + w.fy) * w.width + x + w.fx) * channels;
      memcpy(dst, src, static_cast<size_t>(channels));
    }
}

// RMByteStream of bitstrm.cpp: big-endian words
inline int be32(Stream& s) {
  uint32_t v = 0;
  for (int i = 0; i < 4; i++) v = (v << 8) | static_cast<uint32_t>(s.byte());
  return static_cast<int>(v);
}

inline bool c_space(int c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\v' || c == '\f' || c == '\r';
}

// ------------------------------------------------------------------ PAM --
// grfmt_pam.cpp: P7 with WIDTH / HEIGHT / DEPTH / MAXVAL / TUPLTYPE lines;
// samples are not scaled by MAXVAL (above 255: 16 bits, big-endian);
// MAXVAL 1 is its "bit mode", which reads each row's bytes as packed bits.

enum { PAM_NULL, PAM_BW, PAM_GRAY, PAM_GA, PAM_RGB, PAM_RGBA };

struct Pam {
  int width = 0, height = 0, channels = 0, maxval = 0, fmt = PAM_NULL;
  int64_t offset = 0;
  int bytes() const { return maxval > 255 ? 2 : 1; }
};

Pam pam_header(Stream& s) {
  Pam h;
  if (s.byte() != 'P' || s.byte() != '7') fail("not a PAM file");
  int c = s.byte();
  if (c != '\n' && c != '\r') fail("PAM: no line break after P7");
  bool got[4] = {false, false, false, false};
  for (;;) {
    do c = s.byte(); while (c_space(c));
    if (c == '#') {
      do c = s.byte(); while (c != '\n' && c != '\r');
      continue;
    }
    std::string id;
    while (!c_space(c) && id.size() < 8) {
      id += static_cast<char>(c);
      c = s.byte();
    }
    if (!c_space(c)) fail("PAM: header field " + id + "... too long");
    if (id == "ENDHDR") {
      if (c != '\n' && c != '\r') fail("PAM: no line break after ENDHDR");
      break;
    }
    static const char* kFields[5] = {"HEIGHT", "WIDTH", "DEPTH", "MAXVAL", "TUPLTYPE"};
    int f = -1;
    for (int i = 0; i < 5; i++)
      if (id == kFields[i]) f = i;
    if (f < 0) fail("PAM: unknown header field " + id);
    do c = s.byte(); while (c == ' ' || c == '\t');
    std::string value;
    while (c != '\n' && c != '\r' && value.size() < 255) {
      value += static_cast<char>(c);
      c = s.byte();
    }
    while (!value.empty() && c_space(value.back())) value.pop_back();
    if (f == 4) {
      static const char* kTypes[6] = {"", "BLACKANDWHITE", "GRAYSCALE", "GRAYSCALE_ALPHA", "RGB",
                                      "RGB_ALPHA"};
      int t = -1;
      for (int i = 1; i < 6; i++)
        if (value == kTypes[i]) t = i;
      if (t < 0) fail("PAM: unknown TUPLTYPE " + value);
      h.fmt = t;
      continue;
    }
    if (got[f]) fail("PAM: header field " + id + " given twice");
    got[f] = true;
    char* end = nullptr;
    long v = strtol(value.c_str(), &end, 10);
    if (end == value.c_str() || *end) fail("PAM: " + id + " is not a number");
    if (f == 0) h.height = static_cast<int>(v);
    if (f == 1) h.width = static_cast<int>(v);
    if (f == 2) h.channels = static_cast<int>(v);
    if (f == 3) {
      if (v > 65535) fail("PAM: MAXVAL above 65535");
      h.maxval = static_cast<int>(v);
    }
  }
  if (!(got[0] && got[1] && got[2] && got[3])) fail("PAM: header field missing");
  static const int kNeed[6] = {0, 1, 1, 2, 3, 4};
  if (h.fmt != PAM_NULL && h.channels != kNeed[h.fmt])
    fail("PAM: TUPLTYPE does not match DEPTH " + std::to_string(h.channels));
  if (h.fmt == PAM_NULL) {
    if (h.channels == 1 && h.maxval == 1)
      h.fmt = PAM_BW;
    else if (h.channels == 1 && h.maxval < 256)
      h.fmt = PAM_GRAY;
    else if (h.channels == 3 && h.maxval < 256)
      h.fmt = PAM_RGB;
    else
      fail("PAM: no TUPLTYPE, and DEPTH / MAXVAL name no format cv2 guesses");
  }
  if (h.channels < 1 || h.channels > 4) fail("PAM: DEPTH out of range");
  if (h.width <= 0 || h.height <= 0) fail("PAM: bad size");
  h.offset = s.pos;
  return h;
}

// PAMDecoder::readData for `channels` (the file's own for the unchanged read,
// 3 or 1) and `depth` bytes a sample (the file's for the unchanged read, else
// 1); cv2's reads that it leaves partly unwritten are refused
void pam_decode(const uint8_t* buf, int64_t len, int t, int depth, uint8_t* out,
                int64_t outlen) {
  Stream s(buf, len);
  Pam h = pam_header(s);
  const int W = h.width, H = h.height, C = h.channels, sd = h.bytes();
  if (outlen != static_cast<int64_t>(W) * H * t * depth) fail("output buffer of the wrong size");
  const int64_t row = static_cast<int64_t>(W) * C * sd;
  std::vector<uint8_t> src(static_cast<size_t>(row) * 2 + 8);
  const bool bit = h.maxval == 1;
  if (bit && t != 1 && t != 3) fail("PAM: cv2 gives None for this read of a MAXVAL 1 file");
  if (!bit && t != C && t == 3 && (W + C - 1) / C < W)
    fail("PAM: cv2 leaves part of the colour read of a " + std::to_string(C) +
         "-channel file unwritten (its conversion fills one pixel in " + std::to_string(C) + ")");
  if (!bit && t == 1 && C != 1 && C != 3 && 3 * ((W + C - 1) / C) < W)
    fail("PAM: cv2 leaves part of the gray read of a " + std::to_string(C) +
         "-channel file unwritten");
  static const int kLayout[6][4] = {{0, 1, 2, 0}, {0, 0, 0, 0}, {0, 0, 0, 0},
                                    {0, 0, 0, 0}, {0, 1, 2, 0}, {2, 1, 0, 0}};
  const int* lay = kLayout[h.fmt];  // b, g, r, gray channel of basic_conversion
  for (int y = 0; y < H; y++) {
    s.bytes(src.data(), row);
    uint8_t* o = out + static_cast<int64_t>(y) * W * t * depth;
    if (bit) {
      for (int x = 0; x < W; x++) {
        uint8_t v = (src[x >> 3] >> (7 - (x & 7))) & 1 ? 255 : 0;
        for (int k = 0; k < t; k++) o[x * t + k] = v;
      }
      continue;
    }
    if (sd == 2) {  // big-endian samples
      for (int64_t i = 0; i < row; i += 2) std::swap(src[i], src[i + 1]);
      if (depth == 1)
        for (int64_t i = 0; i < row / 2; i++) src[i] = src[2 * i + 1];
    }
    if (t == C) {
      memcpy(o, src.data(), static_cast<size_t>(W) * t * depth);
    } else if (t == 1 && C == 3) {  // rgb_convert: the file read as RGB
      for (int x = 0; x < W; x++)
        o[x] = luma14(src[3 * x + 2], src[3 * x + 1], src[3 * x]);
    } else if (t == 1) {  // basic_conversion: three bytes a step
      for (int x = 0; x < W; x++) o[x] = src[(x / 3) * C + lay[3]];
    } else {
      const int n = (W + C - 1) / C;
      for (int x = 0; x < n; x++)
        for (int k = 0; k < 3; k++) o[x * 3 + k] = src[x * C + lay[k]];
    }
  }
}

// ------------------------------------------------------------------ PFM --
// grfmt_pfm.cpp: "PF" (3 channels) or "Pf", a line break, then width,
// height and scale each ended by one whitespace byte (atoi / atof); rows
// bottom-up; little-endian where the scale is negative; samples divided
// by |scale| (as a float product). Out: float32 in the file's channel order.

struct Pfm {
  int width = 0, height = 0, channels = 0;
  double scale = 0;
  int64_t offset = 0;
};

std::string pfm_token(Stream& s) {
  std::string t;
  for (int i = 0; i < 2048; i++) {
    int c = s.byte();
    if (c_space(c)) break;
    t += static_cast<char>(c);
  }
  return t;
}

Pfm pfm_header(Stream& s) {
  Pfm h;
  if (s.byte() != 'P') fail("not a PFM file");
  int c = s.byte();
  if (c != 'f' && c != 'F') fail("not a PFM file");
  h.channels = c == 'F' ? 3 : 1;
  if (s.byte() != '\n') fail("PFM: no line break after P" + std::string(1, static_cast<char>(c)));
  h.width = atoi(pfm_token(s).c_str());
  h.height = atoi(pfm_token(s).c_str());
  h.scale = atof(pfm_token(s).c_str());
  if (h.width <= 0 || h.height <= 0) fail("PFM: bad size");
  if (!(std::abs(h.scale) > 0.0)) fail("PFM: scale 0");
  h.offset = s.pos;
  return h;
}

void pfm_decode(const uint8_t* buf, int64_t len, float* out, int64_t outlen) {
  Stream s(buf, len);
  Pfm h = pfm_header(s);
  const int64_t n = static_cast<int64_t>(h.width) * h.channels;
  if (outlen != n * h.height) fail("output buffer of the wrong size");
  const float k = static_cast<float>(1.0 / std::abs(h.scale));
  const bool big = h.scale > 0;
  std::vector<uint8_t> row(static_cast<size_t>(n) * 4);
  for (int y = h.height - 1; y >= 0; y--) {
    s.bytes(row.data(), n * 4);
    for (int64_t i = 0; i < n; i++) {
      const uint8_t* b = &row[i * 4];
      uint32_t u = big ? (uint32_t{b[0]} << 24 | uint32_t{b[1]} << 16 | uint32_t{b[2]} << 8 | b[3])
                       : (uint32_t{b[3]} << 24 | uint32_t{b[2]} << 16 | uint32_t{b[1]} << 8 | b[0]);
      float f;
      memcpy(&f, &u, 4);
      out[static_cast<int64_t>(y) * n + i] = f * k;
    }
  }
}

// ----------------------------------------------------------- Sun raster --
// grfmt_sunras.cpp as cv2 5.0 runs it: its header test compares the Mat
// type, not the raster type, with RT_BYTE_ENCODED and RT_FORMAT_RGB, so
// only RT_OLD and RT_STANDARD rasters read (depth 1, 8 with or without an
// RGB colour map, 24 as BGR, 32 as XBGR); rows padded to 16 bits. Without
// a map the gray and unchanged reads of depths 1 and 8 are zeros (its
// gray palette is left empty) and the colour read a gray ramp.

struct Ras {
  int width = 0, height = 0, bpp = 0, type = 0, maptype = 0, maplength = 0;
  int channels = 1;
  Pal palette[256];
  int64_t offset = 0;
};

Ras ras_header(Stream& s) {
  Ras h;
  memset(h.palette, 0, sizeof(h.palette));
  s.skip(4);
  h.width = be32(s);
  h.height = be32(s);
  h.bpp = be32(s);
  const int pal_size = h.bpp > 0 && h.bpp <= 8 ? (1 << h.bpp) * 3 : 0;
  s.skip(4);
  h.type = be32(s);
  h.maptype = be32(s);
  h.maplength = be32(s);
  if (!(h.width > 0 && h.height > 0)) fail("Sun raster: bad size");
  if (h.bpp != 1 && h.bpp != 8 && h.bpp != 24 && h.bpp != 32)
    fail("Sun raster: depth " + std::to_string(h.bpp) + " is not read by cv2");
  if (h.type != 0 && h.type != 1)
    fail("Sun raster: type " + std::to_string(h.type) +
         (h.type == 2 ? " (RT_BYTE_ENCODED)" : h.type == 3 ? " (RT_FORMAT_RGB)" : "") +
         ": cv2 5.0's header test refuses it (it gives None)");
  if (!((h.maptype == 0 && h.maplength == 0) ||
        (h.maptype == 1 && h.maplength > 0 && h.maplength <= pal_size && h.bpp <= 8)))
    fail("Sun raster: colour map type " + std::to_string(h.maptype) + " / length " +
         std::to_string(h.maplength) + " is not read by cv2");
  if (h.maplength) {
    std::vector<uint8_t> map(static_cast<size_t>(h.maplength));
    s.bytes(map.data(), h.maplength);
    const int n = h.maplength / 3;
    for (int i = 0; i < n; i++) {
      h.palette[i].b = map[i + 2 * n];
      h.palette[i].g = map[i + n];
      h.palette[i].r = map[i];
    }
    h.channels = color_palette(h.palette, h.bpp) ? 3 : 1;
  } else {
    h.channels = h.bpp > 8 ? 3 : 1;
    for (int i = 0; i < (1 << std::min(h.bpp, 8)); i++) {  // FillGrayPalette
      uint8_t v = static_cast<uint8_t>(i * 255 / ((1 << std::min(h.bpp, 8)) - 1));
      h.palette[i] = {v, v, v, 0};
    }
  }
  h.offset = s.pos;
  return h;
}

void ras_decode(const uint8_t* buf, int64_t len, int channels, uint8_t* out, int64_t outlen) {
  Stream s(buf, len);
  Ras h = ras_header(s);
  const int W = h.width, H = h.height;
  if (outlen != static_cast<int64_t>(W) * H * channels) fail("output buffer of the wrong size");
  const bool color = channels > 1;
  const int64_t pitch = ((int64_t{W} * h.bpp + 7) / 8 + 1) & -2;
  uint8_t gray[256] = {0};
  if (!color && h.maptype == 1)
    for (int i = 0; i < (1 << std::min(h.bpp, 8)); i++)
      gray[i] = luma14(h.palette[i].b, h.palette[i].g, h.palette[i].r);
  std::vector<uint8_t> src(static_cast<size_t>(pitch) + 8);
  for (int y = 0; y < H; y++) {
    s.bytes(src.data(), pitch);
    uint8_t* o = out + static_cast<int64_t>(y) * W * channels;
    for (int x = 0; x < W; x++) {
      if (h.bpp <= 8) {
        int i = h.bpp == 1 ? (src[x >> 3] >> (7 - (x & 7))) & 1 : src[x];
        if (color) {
          o[3 * x] = h.palette[i].b;
          o[3 * x + 1] = h.palette[i].g;
          o[3 * x + 2] = h.palette[i].r;
        } else {
          o[x] = gray[i];
        }
      } else {
        const uint8_t* p = h.bpp == 24 ? &src[3 * x] : &src[4 * x + 1];
        if (color) {
          o[3 * x] = p[0];
          o[3 * x + 1] = p[1];
          o[3 * x + 2] = p[2];
        } else {
          o[x] = luma14(p[0], p[1], p[2]);
        }
      }
    }
  }
}

// ------------------------------------------------------------------ HDR --
// grfmt_hdr.cpp and rgbe.cpp (Greg Ward's reader): header lines up to a
// blank one, "FORMAT=32-bit_rle_rgbe" among them, then "-Y h +X w" (the
// only orientation); scanlines in new-style RLE (2 2 w, runs per component) or
// flat, where a scanline without the RLE mark turns the rest of the image
// flat; widths below 8 or above 32767 are flat throughout. Old-style RLE
// is not known to it: such pixels read as they are. Out: float32 RGB.

struct Hdr {
  int width = 0, height = 0;
  int64_t offset = 0;
};

bool hdr_line(Stream& s, std::string& line) {  // fgets(buf, 128)
  line.clear();
  while (line.size() < 127 && s.pos < s.n) {
    char c = static_cast<char>(s.d[s.pos++]);
    line += c;
    if (c == '\n') break;
  }
  return !line.empty();
}

// sscanf(line, "-Y %d +X %d", &h, &w) == 2
bool hdr_size(const std::string& line, int& h, int& w) {
  const char* p = line.c_str();
  auto lit = [&](char c) {
    if (*p != c) return false;
    p++;
    return true;
  };
  auto num = [&](int& v) {
    while (c_space(*p)) p++;
    char* end = nullptr;
    long x = strtol(p, &end, 10);
    if (end == p) return false;
    v = static_cast<int>(x);
    p = end;
    return true;
  };
  auto ws = [&] {
    while (c_space(*p)) p++;
  };
  if (!lit('-') || !lit('Y')) return false;
  ws();
  if (!num(h)) return false;
  ws();
  return lit('+') && lit('X') && (ws(), num(w));
}

Hdr hdr_header(Stream& s) {
  Hdr h;
  std::string line;
  if (!hdr_line(s, line)) fail("HDR: empty file");
  bool format = false;
  while (!(line.empty() || line[0] == '\n')) {  // lines up to a blank one
    format = format || line == "FORMAT=32-bit_rle_rgbe\n";
    if (!hdr_line(s, line)) fail("HDR: header cut short");
  }
  if (!format) fail("HDR: no FORMAT=32-bit_rle_rgbe line (cv2 reads no other)");
  if (!hdr_line(s, line) || !hdr_size(line, h.height, h.width))
    fail("HDR: no \"-Y height +X width\" line (cv2 reads no other orientation)");
  if (h.width <= 0 || h.height <= 0) fail("HDR: bad size");
  h.offset = s.pos;
  return h;
}

inline void rgbe_float(const uint8_t* e, float* o) {
  if (e[3]) {
    const float f = static_cast<float>(ldexp(1.0, e[3] - 136));
    o[0] = e[0] * f;
    o[1] = e[1] * f;
    o[2] = e[2] * f;
  } else {
    o[0] = o[1] = o[2] = 0.f;
  }
}

void hdr_decode(const uint8_t* buf, int64_t len, float* out, int64_t outlen) {
  Stream s(buf, len);
  Hdr h = hdr_header(s);
  const int W = h.width;
  if (outlen != static_cast<int64_t>(W) * h.height * 3) fail("output buffer of the wrong size");
  auto flat = [&](float* o, int64_t n) {
    uint8_t e[4];
    for (int64_t i = 0; i < n; i++) {
      if (s.pos + 4 > s.n) fail("HDR: pixel data cut short");
      s.bytes(e, 4);
      rgbe_float(e, o + 3 * i);
    }
  };
  if (W < 8 || W > 0x7fff) {
    flat(out, static_cast<int64_t>(W) * h.height);
    return;
  }
  std::vector<uint8_t> line(static_cast<size_t>(W) * 4);
  float* o = out;
  for (int y = 0; y < h.height; y++) {
    uint8_t e[4];
    if (s.pos + 4 > s.n) fail("HDR: pixel data cut short");
    s.bytes(e, 4);
    if (e[0] != 2 || e[1] != 2 || (e[2] & 0x80)) {
      rgbe_float(e, o);
      flat(o + 3, static_cast<int64_t>(W) * (h.height - y) - 1);
      return;
    }
    if (((e[2] << 8) | e[3]) != W) fail("HDR: wrong scanline width");
    for (int c = 0; c < 4; c++) {
      uint8_t* p = &line[static_cast<size_t>(c) * W];
      uint8_t* end = p + W;
      while (p < end) {
        if (s.pos + 2 > s.n) fail("HDR: scanline cut short");
        int a = s.byte(), b = s.byte();
        if (a > 128) {
          int count = a - 128;
          if (count > end - p) fail("HDR: bad scanline data");
          while (count--) *p++ = static_cast<uint8_t>(b);
        } else {
          int count = a;
          if (count == 0 || count > end - p) fail("HDR: bad scanline data");
          *p++ = static_cast<uint8_t>(b);
          if (--count > 0) {
            if (s.pos + count > s.n) fail("HDR: scanline cut short");
            s.bytes(p, count);
            p += count;
          }
        }
      }
    }
    for (int x = 0; x < W; x++) {
      const uint8_t q[4] = {line[x], line[x + W], line[x + 2 * W], line[x + 3 * W]};
      rgbe_float(q, o + 3 * x);
    }
    o += 3 * W;
  }
}

// ------------------------------------------------------------------ GIF --
// grfmt_gif.cpp (OpenCV 5): the whole block structure is read up to the
// trailer; the first image is decoded (LZW code sizes 2-11, clear codes, a
// full table kept until the next clear, an end code read as a clear;
// decoding stops where the frame is full, and a string that runs past it,
// data that end before it, or bytes past those that the next code would
// take give None, as do codes left in hand after an end code in the last
// byte) onto a canvas of the logical
// screen filled with the background colour (the global table's entry, or
// black); a transparent index in any graphic control extension makes the
// read BGRA, the canvas then transparent and the first frame's transparent
// pixels left as the canvas.

struct Gif {
  int width = 0, height = 0, channels = 3;
  int fx = 0, fy = 0, fw = 0, fh = 0;
  bool interlace = false, transparent = false;
  int transp_index = -1, min_code = 0;
  std::vector<Pal> global, local;
  int bg = 0;
  std::vector<uint8_t> lzw;  // the first image's sub-blocks, joined
};

std::vector<Pal> gif_table(Stream& s, int bits) {
  std::vector<Pal> t(static_cast<size_t>(1) << (bits + 1));
  for (Pal& p : t) {
    p.r = static_cast<uint8_t>(s.byte());
    p.g = static_cast<uint8_t>(s.byte());
    p.b = static_cast<uint8_t>(s.byte());
    p.a = 255;
  }
  return t;
}

Gif gif_parse(const uint8_t* buf, int64_t len) {
  Stream s(buf, len);
  Gif g;
  s.skip(6);
  g.width = s.word();
  g.height = s.word();
  int flags = s.byte();
  g.bg = s.byte();
  s.byte();
  if (flags & 0x80) {
    g.global = gif_table(s, flags & 7);
    if (g.bg >= static_cast<int>(g.global.size())) fail("GIF: background index past the colour table");
  }
  if (g.width <= 0 || g.height <= 0) fail("GIF: bad size");
  bool have = false;
  int pending = -1;  // the transparent index of the last GCE
  for (;;) {
    int c = s.byte();
    if (c == 0x3B) break;
    if (c == 0x21) {
      int label = s.byte();
      if (label == 0xF9) {
        int n = s.byte();
        if (n != 4) fail("GIF: bad graphic control extension");
        int f = s.byte();
        s.word();
        int t = s.byte();
        if (f & 1) {
          g.transparent = true;
          pending = t;
        } else {
          pending = -1;
        }
      }
      for (int n = s.byte(); n; n = s.byte()) {
        if (s.pos + n > s.n) fail("GIF: data cut short");
        s.skip(n);
      }
      continue;
    }
    if (c != 0x2C) fail("GIF: unknown block");
    int x = s.word(), y = s.word(), w = s.word(), h = s.word(), f = s.byte();
    std::vector<Pal> local;
    if (f & 0x80) local = gif_table(s, f & 7);
    int mcs = s.byte();
    std::vector<uint8_t> data;
    for (int n = s.byte(); n; n = s.byte()) {
      if (s.pos + n > s.n) fail("GIF: data cut short");
      if (!have) data.insert(data.end(), s.d + s.pos, s.d + s.pos + n);
      s.skip(n);
    }
    if (!have) {
      have = true;
      g.fx = x, g.fy = y, g.fw = w, g.fh = h;
      g.interlace = f & 0x40;
      g.local = std::move(local);
      g.min_code = mcs;
      g.transp_index = pending;
      g.lzw = std::move(data);
    }
    pending = -1;
  }
  if (!have) fail("GIF: no image");
  g.channels = g.transparent ? 4 : 3;
  return g;
}

// LZW, least significant bit first, into w*h indices
void gif_lzw(const Gif& g, std::vector<uint8_t>& idx) {
  const int mcs = g.min_code;
  if (mcs < 2 || mcs > 11) fail("GIF: LZW minimum code size " + std::to_string(mcs));
  const int clear = 1 << mcs, eoi = clear + 1;
  const int64_t total = static_cast<int64_t>(g.fw) * g.fh;
  idx.assign(static_cast<size_t>(total), 0);
  std::vector<int> prefix(4096), first(4096), length(4096);
  std::vector<uint8_t> suffix(4096);
  for (int i = 0; i < clear; i++) {
    prefix[i] = -1;
    suffix[i] = static_cast<uint8_t>(i);
    first[i] = i;
    length[i] = 1;
  }
  // lzwDecode's loop: a byte is read where a code's bits are short, then
  // every whole code in hand is taken; an end code resets as a clear does
  // but ends that pass, so codes left in hand after the last byte are lost
  int size = mcs + 1, next = eoi + 1, prev = -1, left = 0;
  uint64_t src = 0;
  int64_t out = 0;
  size_t pos = 0;
  const size_t n_bytes = g.lzw.size();
  for (bool more = n_bytes > 0; more; more = pos < n_bytes) {
    if (left < size) {
      src |= static_cast<uint64_t>(g.lzw[pos++]) << left;
      left += 8;
    }
    while (left >= size) {
      if (out == total) {  // done: the data must end with the codes in hand
        if (pos < n_bytes) fail("GIF: LZW data go on past the frame's last pixel");
        return;
      }
      const int code = static_cast<int>(src & ((1u << size) - 1));
      src >>= size;
      left -= size;
      if (code == clear || code == eoi) {
        size = mcs + 1;
        next = eoi + 1;
        prev = -1;
        if (code == eoi) break;
        continue;
      }
      if (prev < 0) {
        if (code >= clear) fail("GIF: bad LZW code");
      } else {
        if (code > next || (code == next && next >= 4096)) fail("GIF: bad LZW code");
        if (next < 4096) {
          prefix[next] = prev;
          suffix[next] = static_cast<uint8_t>(code == next ? first[prev] : first[code]);
          first[next] = first[prev];
          length[next] = length[prev] + 1;
          next++;
          if (next == (1 << size) && size < 12) size++;
        }
      }
      const int n = length[code];
      if (out + n > total) fail("GIF: an LZW string runs past the frame");
      for (int k = code, i = n - 1; i >= 0; i--, k = prefix[k]) idx[out + i] = suffix[k];
      out += n;
      prev = code;
    }
  }
  if (out < total) fail("GIF: LZW data end before the frame's last pixel");
}

void gif_decode(const uint8_t* buf, int64_t len, int channels, uint8_t* out, int64_t outlen) {
  Gif g = gif_parse(buf, len);
  const int W = g.width, H = g.height;
  if (channels != g.channels || outlen != static_cast<int64_t>(W) * H * channels)
    fail("output buffer of the wrong size");
  if (g.fw <= 0 || g.fh <= 0 || g.fx + g.fw > W || g.fy + g.fh > H)
    fail("GIF: the frame is empty or lies outside the screen");
  std::vector<uint8_t> idx;
  gif_lzw(g, idx);
  const std::vector<Pal>& table = g.local.empty() ? g.global : g.local;
  Pal bg{0, 0, 0, 0};
  if (!g.global.empty()) bg = g.global[g.bg];
  bg.a = g.transparent ? 0 : 255;
  for (int64_t i = 0; i < static_cast<int64_t>(W) * H; i++) {
    uint8_t* o = out + i * channels;
    o[0] = bg.b, o[1] = bg.g, o[2] = bg.r;
    if (channels == 4) o[3] = bg.a;
  }
  std::vector<int> rows(g.fh);
  int r = 0;
  if (g.interlace) {
    static const int kStart[4] = {0, 4, 2, 1}, kStep[4] = {8, 8, 4, 2};
    for (int p = 0; p < 4; p++)
      for (int y = kStart[p]; y < g.fh; y += kStep[p]) rows[r++] = y;
  } else {
    for (int y = 0; y < g.fh; y++) rows[y] = y;
  }
  for (int k = 0; k < g.fh; k++) {
    for (int x = 0; x < g.fw; x++) {
      int i = idx[static_cast<size_t>(k) * g.fw + x];
      if (i == g.transp_index) continue;
      if (i >= static_cast<int>(table.size())) fail("GIF: colour index past the colour table");
      uint8_t* o = out + (static_cast<int64_t>(rows[k] + g.fy) * W + x + g.fx) * channels;
      o[0] = table[i].b, o[1] = table[i].g, o[2] = table[i].r;
      if (channels == 4) o[3] = 255;
    }
  }
}

template <class F>
int guarded(char* err, int64_t errlen, F&& f) {
  try {
    f();
    return 0;
  } catch (const ImageError& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  } catch (const std::exception& e) {
    set_error(err, errlen, std::string("decoder error: ") + e.what());
  }
  return -1;
}

}  // namespace

extern "C" {

int im_bmp_info(const uint8_t* buf, int64_t len, int32_t* info, char* err, int64_t errlen) {
  return guarded(err, errlen, [&] {
    Stream s(buf, len);
    Bmp h = bmp_header(s);
    info[0] = h.height;
    info[1] = h.width;
    info[2] = h.type_cn;
  });
}

int im_bmp_decode(const uint8_t* buf, int64_t len, int32_t channels, uint8_t* out,
                  int64_t outlen, char* err, int64_t errlen) {
  return guarded(err, errlen, [&] { bmp_decode(buf, len, channels, out, outlen); });
}

int im_pxm_info(const uint8_t* buf, int64_t len, int32_t* info, char* err, int64_t errlen) {
  return guarded(err, errlen, [&] {
    Stream s(buf, len);
    Pxm h = pxm_header(s);
    info[0] = h.height;
    info[1] = h.width;
    info[2] = h.cn();
    info[3] = h.depth();
  });
}

int im_pxm_decode(const uint8_t* buf, int64_t len, int32_t channels, int32_t depth,
                  uint8_t* out, int64_t outlen, char* err, int64_t errlen) {
  return guarded(err, errlen, [&] { pxm_decode(buf, len, channels, depth, out, outlen); });
}

int im_webp_info(const uint8_t* buf, int64_t len, int32_t* info, char* err, int64_t errlen) {
  return guarded(err, errlen, [&] {
    WebP w = webp_headers(buf, len, false);
    info[0] = w.height;
    info[1] = w.width;
    info[2] = w.has_alpha;
    info[3] = w.animated;
  });
}

int im_webp_decode(const uint8_t* buf, int64_t len, int32_t channels, uint8_t* out,
                   int64_t outlen, char* err, int64_t errlen) {
  return guarded(err, errlen, [&] { webp_decode(buf, len, channels, out, outlen); });
}

int im_lzw_decode(const uint8_t* buf, int64_t len, int32_t compat, uint8_t* out,
                  int64_t outlen, int64_t* written, char* err, int64_t errlen) {
  return guarded(err, errlen, [&] {
    bool failed = false;
    written[0] = lzw_decode(buf, len, out, outlen, compat != 0, &failed);
    written[1] = failed;
  });
}

int im_fax_decode(const uint8_t* buf, int64_t len, int32_t compression,
                  int32_t two_d, int32_t lsb_first, int32_t width, int32_t rows,
                  uint8_t* out, int64_t outlen, int64_t* failed, char* err,
                  int64_t errlen) {
  return guarded(err, errlen, [&] {
    if (width <= 0 || rows < 0 || outlen < int64_t{(width + 7) / 8} * rows)
      fail("fax: output buffer of the wrong size");
    bool damaged = false;
    failed[0] = !fax::decode(buf, len, compression, two_d != 0, lsb_first != 0,
                             static_cast<uint32_t>(width), rows, out, &damaged);
    failed[1] = damaged;
  });
}

int im_packbits_decode(const uint8_t* buf, int64_t len, uint8_t* out, int64_t outlen,
                       int64_t* written, char* err, int64_t errlen) {
  return guarded(err, errlen, [&] {
    bool failed = false;
    written[0] = packbits_decode(buf, len, out, outlen, &failed);
    written[1] = failed;
  });
}

int im_pam_info(const uint8_t* buf, int64_t len, int32_t* info, char* err, int64_t errlen) {
  return guarded(err, errlen, [&] {
    Stream s(buf, len);
    Pam h = pam_header(s);
    info[0] = h.height;
    info[1] = h.width;
    info[2] = h.channels;
    info[3] = h.bytes();
  });
}

int im_pam_decode(const uint8_t* buf, int64_t len, int32_t channels, int32_t depth,
                  uint8_t* out, int64_t outlen, char* err, int64_t errlen) {
  return guarded(err, errlen, [&] { pam_decode(buf, len, channels, depth, out, outlen); });
}

int im_pfm_info(const uint8_t* buf, int64_t len, int32_t* info, char* err, int64_t errlen) {
  return guarded(err, errlen, [&] {
    Stream s(buf, len);
    Pfm h = pfm_header(s);
    info[0] = h.height;
    info[1] = h.width;
    info[2] = h.channels;
  });
}

int im_pfm_decode(const uint8_t* buf, int64_t len, float* out, int64_t outlen, char* err,
                  int64_t errlen) {
  return guarded(err, errlen, [&] { pfm_decode(buf, len, out, outlen); });
}

int im_sunras_info(const uint8_t* buf, int64_t len, int32_t* info, char* err, int64_t errlen) {
  return guarded(err, errlen, [&] {
    Stream s(buf, len);
    Ras h = ras_header(s);
    info[0] = h.height;
    info[1] = h.width;
    info[2] = h.channels;
  });
}

int im_sunras_decode(const uint8_t* buf, int64_t len, int32_t channels, uint8_t* out,
                  int64_t outlen, char* err, int64_t errlen) {
  return guarded(err, errlen, [&] { ras_decode(buf, len, channels, out, outlen); });
}

int im_hdr_info(const uint8_t* buf, int64_t len, int32_t* info, char* err, int64_t errlen) {
  return guarded(err, errlen, [&] {
    Stream s(buf, len);
    Hdr h = hdr_header(s);
    info[0] = h.height;
    info[1] = h.width;
  });
}

int im_hdr_decode(const uint8_t* buf, int64_t len, float* out, int64_t outlen, char* err,
                  int64_t errlen) {
  return guarded(err, errlen, [&] { hdr_decode(buf, len, out, outlen); });
}

int im_gif_info(const uint8_t* buf, int64_t len, int32_t* info, char* err, int64_t errlen) {
  return guarded(err, errlen, [&] {
    Gif g = gif_parse(buf, len);
    info[0] = g.height;
    info[1] = g.width;
    info[2] = g.channels;
  });
}

int im_gif_decode(const uint8_t* buf, int64_t len, int32_t channels, uint8_t* out,
                  int64_t outlen, char* err, int64_t errlen) {
  return guarded(err, errlen, [&] { gif_decode(buf, len, channels, out, outlen); });
}

}  // extern "C"
