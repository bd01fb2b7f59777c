// JPEG 2000 Part 1 (ISO/IEC 15444-1) decoded as the OpenJPEG 2.5.3 that
// cv2 5.0 bundles decodes it (opj_read_header, then opj_decode), with a
// plain C interface. `data/jpeg2000.py` turns the components it gives into
// cv2's unchanged, colour and gray reads (grfmt_jpeg2000_openjpeg.cpp).
//
//  - The JP2 boxes as opj_jp2_read_header walks them (signature, ftyp,
//    jp2h with ihdr / bpcc / colr / pclr / cmap / cdef, then jp2c; the
//    codestream runs to the end of the file), and opj_jp2_decode's
//    post-processing: the colour space from colr's EnumCS, the palette
//    expanded through cmap, the channels reordered and marked by cdef.
//  - The codestream as opj_j2k_read_header / opj_j2k_decode_tiles read
//    it, in strict mode: the main header (SIZ, COD / COC, QCD / QCC, RGN,
//    POC, PPM, TLM, PLM, CRG, COM, CAP, CPF; unknown markers skipped as
//    opj_j2k_read_unk skips them), tile-parts (SOT, their own COD / COC /
//    QCD / QCC / RGN / POC / PPT / PLT / COM, SOD) in OpenJPEG's order of
//    reading and decoding tiles, the checks that make opj_decode fail,
//    and the one-tile fast path that hands over the tile's buffer as is.
//  - Tier 2: packet headers (inclusion and zero bit-plane tag trees,
//    pass counts, Lblock, the segments of each code-block style) read from
//    the tile data or from the PPM / PPT headers, SOP / EPH, the five
//    progression orders and POC volumes as opj_pi_next_* walks them.
//  - Tier 1: the MQ decoder with its 0xFFFF end marker, the three coding
//    passes and their contexts for each sub-band, the raw passes of
//    BYPASS, RESET, TERMALL, VSC, PTERM and SEGSYM, ROI max-shift, and
//    OpenJPEG's reconstruction (half a step above each decoded bit plane).
//  - Dequantisation and the inverse 5/3 (integer) and 9/7 (float32, in
//    OpenJPEG's order of operations: its constants, its K / 2/K scaling
//    step and its step sizes) transforms, the inverse RCT / ICT, the DC
//    level shift with lrintf rounding, and the clamp to each precision.
//
// The 9/7 path must round as OpenJPEG's does: no operation of this file
// may be contracted into a fused multiply-add.
//
// Interface (bound with ctypes by spinnerf_tpu_torch/data/jpeg2000.py).
// Every function returns 0, or -1 with a message in `err`:
//   j2k_header(buf, len, jp2, info[6], err, errlen)
//       what opj_read_header gives: info = width, height, components,
//       largest precision, 1 if a component is signed, 1 if a code-block
//       style is HTJ2K (Part 15)
//   j2k_decode(buf, len, jp2, handle[1], err, errlen)
//       opj_decode and the JP2 post-processing; *handle holds the result
//   j2k_result(handle, meta[2 + 7 * n], n, data[], err, errlen)
//       meta = colour space (OpenJPEG's OPJ_COLOR_SPACE), components;
//       then per component: w, h, dx, dy, x0, y0, 1 if it has data;
//       data[c] (w * h int32 each) is filled where not null
//   j2k_free(handle)
#pragma GCC optimize("fp-contract=off")

#include <algorithm>
#include <cmath>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

struct Failure {
  std::string msg;
};

[[noreturn]] __attribute__((format(printf, 1, 2))) void fail(const char* fmt,
                                                              ...) {
  char buf[400];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw Failure{buf};
}

uint32_t rd(const uint8_t* p, int n) {
  uint32_t v = 0;
  for (int i = 0; i < n; ++i) v = (v << 8) | p[i];
  return v;
}

int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
int64_t ceildivpow2(int64_t a, int b) { return (a + (int64_t(1) << b) - 1) >> b; }
int64_t floordivpow2(int64_t a, int b) { return a >> b; }

// ---------------------------------------------------------------------------
// Codestream parameters (opj_cp_t / opj_tcp_t / opj_tccp_t)

enum {
  CSTY_PRT = 1, CSTY_SOP = 2, CSTY_EPH = 4,
  CBLK_LAZY = 1, CBLK_RESET = 2, CBLK_TERMALL = 4, CBLK_VSC = 8,
  CBLK_PTERM = 16, CBLK_SEGSYM = 32, CBLK_HT = 64, CBLK_HTMIXED = 128,
  QNT_NONE = 0, QNT_DERIVED = 1,
  MAXBANDS = 97, MAXRLVLS = 33,
};

enum {  // opj_j2k decoder states
  ST_NONE = 0, ST_MHSOC = 1, ST_MHSIZ = 2, ST_MH = 4, ST_TPHSOT = 8,
  ST_TPH = 16, ST_NEOC = 64, ST_DATA = 128, ST_EOC = 256,
};

enum : uint32_t {
  M_SOC = 0xff4f, M_SOT = 0xff90, M_SOD = 0xff93, M_EOC = 0xffd9,
  M_CAP = 0xff50, M_SIZ = 0xff51, M_COD = 0xff52, M_COC = 0xff53,
  M_CPF = 0xff59, M_TLM = 0xff55, M_PLM = 0xff57, M_PLT = 0xff58,
  M_QCD = 0xff5c, M_QCC = 0xff5d, M_RGN = 0xff5e, M_POC = 0xff5f,
  M_PPM = 0xff60, M_PPT = 0xff61, M_CRG = 0xff63, M_COM = 0xff64,
  M_SOP = 0xff91, M_MCT = 0xff74, M_MCC = 0xff75, M_MCO = 0xff77,
  M_CBD = 0xff78,
};

struct StepSize {
  int32_t expn = 0, mant = 0;
};

struct Tccp {
  uint32_t csty = 0, numres = 0, cblkw = 0, cblkh = 0, cblksty = 0;
  uint32_t qmfbid = 0, qntsty = 0, numgbits = 0, roishift = 0;
  uint32_t prcw[MAXRLVLS] = {}, prch[MAXRLVLS] = {};
  StepSize ss[MAXBANDS];
  int32_t dc_shift = 0;
};

struct Poc {
  uint32_t resno0, compno0, layno1, resno1, compno1, prg;
};

struct Chunk {
  bool present = false;
  std::vector<uint8_t> data;
};

struct Tcp {
  uint32_t csty = 0, numlayers = 0, mct = 0;
  int prg = 0;  // -1: unknown (no packet is read)
  std::vector<Tccp> tccps;
  bool poc = false;
  std::vector<Poc> pocs;
  bool ppt = false;
  std::vector<Chunk> ppt_markers;
  std::vector<uint8_t> ppt_buf;  // merged PPT data
  size_t ppt_pos = 0;
  int cur_part = -1;
  uint32_t nb_parts = 0;
  bool has_data = false;  // m_data != NULL
  std::vector<uint8_t> data;
};

struct Comp {
  uint32_t dx = 1, dy = 1, prec = 0, sgnd = 0;
  uint32_t resno_decoded = 0;
};

// ---------------------------------------------------------------------------
// The MQ decoder (ISO 15444-1 C.3, opj_mqc) over one segment, which reads
// 0xFF 0xFF past its end as OpenJPEG's synthetic marker.

struct Qe {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

const Qe QE[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

enum { CTX_ZC = 0, CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18,
       NUM_CTX = 19 };

struct Ctx {
  uint8_t i = 0, mps = 0;
};

struct Mq {
  const uint8_t* buf = nullptr;
  size_t end = 0, bp = 0;
  uint32_t c = 0, a = 0;
  int ct = 0;
  Ctx ctx[NUM_CTX];

  uint32_t byte(size_t i) const { return i < end ? buf[i] : 0xFFu; }

  void reset_states() {
    for (auto& x : ctx) x = Ctx();
    ctx[CTX_UNI].i = 46;
    ctx[CTX_AGG].i = 3;
    ctx[CTX_ZC].i = 4;
  }
  void bytein() {
    uint32_t next = byte(bp + 1);
    if (byte(bp) == 0xFF) {
      if (next > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        bp++;
        c += next << 9;
        ct = 7;
      }
    } else {
      bp++;
      c += next << 8;
      ct = 8;
    }
  }
  void init(const uint8_t* data, size_t start, size_t len) {
    buf = data;
    bp = start;
    end = start + len;
    c = len == 0 ? 0xFFu << 16 : byte(bp) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void raw_init(const uint8_t* data, size_t start, size_t len) {
    buf = data;
    bp = start;
    end = start + len;
    c = 0;
    ct = 0;
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      ct--;
    } while ((a & 0x8000) == 0);
  }
  int decode(int cx) {
    Ctx& x = ctx[cx];
    const Qe& q = QE[x.i];
    int d;
    a -= q.qe;
    if ((c >> 16) < q.qe) {
      if (a < q.qe) {
        a = q.qe;
        d = x.mps;
        x.i = q.nmps;
      } else {
        a = q.qe;
        d = !x.mps;
        if (q.sw) x.mps ^= 1;
        x.i = q.nlps;
      }
      renorm();
    } else {
      c -= uint32_t(q.qe) << 16;
      if ((a & 0x8000) == 0) {
        if (a < q.qe) {
          d = !x.mps;
          if (q.sw) x.mps ^= 1;
          x.i = q.nlps;
        } else {
          d = x.mps;
          x.i = q.nmps;
        }
        renorm();
      } else {
        d = x.mps;
      }
    }
    return d;
  }
  int raw() {
    if (ct == 0) {
      if (c == 0xFF) {
        if (byte(bp) > 0x8F) {
          c = 0xFF;
          ct = 8;
        } else {
          c = byte(bp);
          bp++;
          ct = 7;
        }
      } else {
        c = byte(bp);
        bp++;
        ct = 8;
      }
    }
    ct--;
    return (c >> ct) & 1;
  }
};

// ---------------------------------------------------------------------------
// Tier 1: one code-block's coding passes (Annex D) as opj_t1_decode_cblk
// runs them. A coefficient's flags hold its 8 neighbours' significance,
// the signs of its 4 direct neighbours, and its own state.

enum : uint32_t {
  F_NW = 1u << 0, F_N = 1u << 1, F_NE = 1u << 2, F_W = 1u << 3,
  F_E = 1u << 4, F_SW = 1u << 5, F_S = 1u << 6, F_SE = 1u << 7,
  F_NEG_N = 1u << 8, F_NEG_S = 1u << 9, F_NEG_W = 1u << 10,
  F_NEG_E = 1u << 11, F_SIG = 1u << 12, F_VISIT = 1u << 13,
  F_REF = 1u << 14,
};

uint8_t ZC_LUT[4][256];
uint8_t SC_LUT[256];  // context | xor bit << 7

int zc_context(int orient, int h, int v, int d) {
  if (orient == 1) std::swap(h, v);  // HL: horizontally high-pass
  if (orient == 3) {
    int hv = h + v;
    if (d >= 3) return 8;
    if (d == 2) return hv >= 1 ? 7 : 6;
    if (d == 1) return hv >= 2 ? 5 : hv == 1 ? 4 : 3;
    return hv >= 2 ? 2 : hv == 1 ? 1 : 0;
  }
  if (h == 2) return 8;
  if (h == 1) return v >= 1 ? 7 : d >= 1 ? 6 : 5;
  if (v == 2) return 4;
  if (v == 1) return 3;
  return d >= 2 ? 2 : d == 1 ? 1 : 0;
}

struct LutInit {
  LutInit() {
    for (int o = 0; o < 4; ++o)
      for (int m = 0; m < 256; ++m) {
        int h = !!(m & F_W) + !!(m & F_E), v = !!(m & F_N) + !!(m & F_S);
        int d = !!(m & F_NW) + !!(m & F_NE) + !!(m & F_SW) + !!(m & F_SE);
        ZC_LUT[o][m] = uint8_t(zc_context(o, h, v, d));
      }
    // key bits: sig N, S, W, E, then negative N, S, W, E
    for (int k = 0; k < 256; ++k) {
      auto contrib = [&](int sig, int neg) {
        return (k >> sig & 1) ? ((k >> neg & 1) ? -1 : 1) : 0;
      };
      int hc = std::clamp(contrib(2, 6) + contrib(3, 7), -1, 1);
      int vc = std::clamp(contrib(0, 4) + contrib(1, 5), -1, 1);
      int ctx, x = 0;
      if (hc == 0) {
        ctx = vc == 0 ? 9 : 10;
        x = vc < 0;
      } else {
        ctx = vc == hc ? 13 : vc == 0 ? 12 : 11;
        x = hc < 0;
      }
      SC_LUT[k] = uint8_t(ctx | x << 7);
    }
  }
} lut_init;

struct Seg {
  uint32_t len = 0, numpasses = 0, maxpasses = 0, newlen = 0;
  uint32_t numnewpasses = 0, real_num_passes = 0;
};

struct Cblk {
  int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  uint32_t numbps = 0, numlenbits = 0, numnewpasses = 0, numsegs = 0;
  std::vector<Seg> segs;
  std::vector<uint8_t> data;  // the chunks of every packet, in order
};

class T1 {
 public:
  int w = 0, h = 0, stride = 0;
  std::vector<int32_t> data;
  std::vector<uint32_t> flags;

  void decode(const Cblk& cb, int orient, uint32_t roishift,
              uint32_t cblksty) {
    w = cb.x1 - cb.x0;
    h = cb.y1 - cb.y0;
    stride = w + 2;
    data.assign(size_t(w) * h, 0);
    flags.assign(size_t(stride) * (h + 2), 0);
    orient_ = orient;
    vsc_ = cblksty & CBLK_VSC;
    int32_t bpno_plus_one = int32_t(roishift + cb.numbps);
    if (bpno_plus_one >= 31)
      fail("a code-block has %d bit planes, past OpenJPEG's 30",
           bpno_plus_one);
    int passtype = 2;
    mq_.reset_states();
    size_t index = 0;
    for (uint32_t segno = 0; segno < cb.numsegs; ++segno) {
      const Seg& seg = cb.segs[segno];
      bool raw = bpno_plus_one <= int32_t(cb.numbps) - 4 && passtype < 2 &&
                 (cblksty & CBLK_LAZY);
      if (raw)
        mq_.raw_init(cb.data.data(), index, seg.len);
      else
        mq_.init(cb.data.data(), index, seg.len);
      index += seg.len;
      for (uint32_t passno = 0;
           passno < seg.real_num_passes && bpno_plus_one >= 1; ++passno) {
        if (passtype == 0) {
          sigpass(bpno_plus_one, raw);
        } else if (passtype == 1) {
          refpass(bpno_plus_one, raw);
        } else {
          clnpass(bpno_plus_one, cblksty);
        }
        if ((cblksty & CBLK_RESET) && !raw) mq_.reset_states();
        if (++passtype == 3) {
          passtype = 0;
          bpno_plus_one--;
        }
      }
    }
  }

 private:
  Mq mq_;
  int orient_ = 0;
  bool vsc_ = false;

  uint32_t& fl(int x, int y) { return flags[size_t(y + 1) * stride + x + 1]; }

  void make_significant(int x, int y, bool neg) {
    uint32_t* f = &fl(x, y);
    *f |= F_SIG;
    if (!(vsc_ && (y & 3) == 0)) {
      f[-stride - 1] |= F_SE;
      f[-stride] |= F_S | (neg ? F_NEG_S : 0u);
      f[-stride + 1] |= F_SW;
    }
    f[-1] |= F_E | (neg ? F_NEG_E : 0u);
    f[1] |= F_W | (neg ? F_NEG_W : 0u);
    f[stride - 1] |= F_NE;
    f[stride] |= F_N | (neg ? F_NEG_N : 0u);
    f[stride + 1] |= F_NW;
  }

  int sign_key(uint32_t f) const {
    return (!!(f & F_N)) | (!!(f & F_S)) << 1 | (!!(f & F_W)) << 2 |
           (!!(f & F_E)) << 3 | (!!(f & F_NEG_N)) << 4 |
           (!!(f & F_NEG_S)) << 5 | (!!(f & F_NEG_W)) << 6 |
           (!!(f & F_NEG_E)) << 7;
  }

  void decode_sign(int x, int y, int32_t oneplushalf) {
    uint32_t f = fl(x, y);
    int lut = SC_LUT[sign_key(f)];
    int v = mq_.decode(lut & 0x7f) ^ (lut >> 7);
    data[size_t(y) * w + x] = v ? -oneplushalf : oneplushalf;
    make_significant(x, y, v);
  }

  void sigpass(int bpno, bool raw) {
    int32_t one = 1 << bpno, half = one >> 1, oneplushalf = one | half;
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x)
        for (int y = k; y < std::min(k + 4, h); ++y) {
          uint32_t f = fl(x, y);
          if ((f & (F_SIG | F_VISIT)) || !(f & 0xFF)) continue;
          if (raw) {
            if (mq_.raw()) {
              int v = mq_.raw();
              data[size_t(y) * w + x] = v ? -oneplushalf : oneplushalf;
              make_significant(x, y, v);
            }
          } else if (mq_.decode(ZC_LUT[orient_][f & 0xFF])) {
            decode_sign(x, y, oneplushalf);
          }
          fl(x, y) |= F_VISIT;
        }
  }

  void refpass(int bpno, bool raw) {
    int32_t poshalf = (1 << bpno) >> 1;
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x)
        for (int y = k; y < std::min(k + 4, h); ++y) {
          uint32_t& f = fl(x, y);
          if ((f & (F_SIG | F_VISIT)) != F_SIG) continue;
          int v;
          if (raw) {
            v = mq_.raw();
          } else {
            int ctx = (f & F_REF) ? CTX_MAG + 2
                                  : (f & 0xFF) ? CTX_MAG + 1 : CTX_MAG;
            v = mq_.decode(ctx);
          }
          int32_t& d = data[size_t(y) * w + x];
          d += (v ^ (d < 0)) ? poshalf : -poshalf;
          f |= F_REF;
        }
  }

  void clnpass(int bpno, uint32_t cblksty) {
    int32_t one = 1 << bpno, half = one >> 1, oneplushalf = one | half;
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x) {
        int y = k, ymax = std::min(k + 4, h);
        if (ymax - k == 4) {
          bool agg = true;
          for (int yy = k; yy < ymax && agg; ++yy)
            agg = !(fl(x, yy) & (F_SIG | F_VISIT | 0xFF));
          if (agg) {
            if (!mq_.decode(CTX_AGG)) {
              for (int yy = k; yy < ymax; ++yy) fl(x, yy) &= ~F_VISIT;
              continue;
            }
            int runlen = mq_.decode(CTX_UNI) << 1;
            runlen |= mq_.decode(CTX_UNI);
            y = k + runlen;
            decode_sign(x, y, oneplushalf);
            fl(x, y) &= ~F_VISIT;
            ++y;
          }
        }
        for (; y < ymax; ++y) {
          uint32_t f = fl(x, y);
          if (!(f & (F_SIG | F_VISIT)) &&
              mq_.decode(ZC_LUT[orient_][f & 0xFF]))
            decode_sign(x, y, oneplushalf);
          fl(x, y) &= ~F_VISIT;
        }
      }
    if (cblksty & CBLK_SEGSYM) {
      for (int i = 0; i < 4; ++i) mq_.decode(CTX_UNI);
    }
  }
};

// ---------------------------------------------------------------------------
// Tag trees (B.10.2, opj_tgt) and the packet-header bit reader (opj_bio)

struct TagTree {
  struct Node {
    int32_t parent = -1, value = 999, low = 0;
  };
  std::vector<Node> nodes;

  void create(uint32_t w, uint32_t h) {
    nodes.clear();
    if (w == 0 || h == 0) return;
    std::vector<uint32_t> lw{w}, lh{h}, base{0};
    uint32_t total = w * h;
    while (lw.back() * lh.back() > 1) {
      uint32_t nw = (lw.back() + 1) / 2, nh = (lh.back() + 1) / 2;
      base.push_back(total);
      total += nw * nh;
      lw.push_back(nw);
      lh.push_back(nh);
    }
    nodes.assign(total, Node());
    for (size_t l = 0; l + 1 < lw.size(); ++l)
      for (uint32_t y = 0; y < lh[l]; ++y)
        for (uint32_t x = 0; x < lw[l]; ++x)
          nodes[base[l] + y * lw[l] + x].parent =
              int32_t(base[l + 1] + (y / 2) * lw[l + 1] + x / 2);
  }
  void reset() {
    for (auto& n : nodes) {
      n.value = 999;
      n.low = 0;
    }
  }
};

struct Bio {
  const uint8_t* start;
  const uint8_t* bp;
  const uint8_t* end;
  uint32_t buf = 0;
  int ct = 0;

  Bio(const uint8_t* p, size_t len) : start(p), bp(p), end(p + len) {}
  void bytein() {
    buf = (buf << 8) & 0xffff;
    ct = buf == 0xff00 ? 7 : 8;
    if (bp < end) buf |= *bp++;
  }
  uint32_t bit() {
    if (ct == 0) bytein();
    ct--;
    return (buf >> ct) & 1;
  }
  uint32_t read(uint32_t n) {
    uint32_t v = 0;
    for (uint32_t i = n; i-- > 0;) v |= bit() << i;
    return v;
  }
  void inalign() {
    if ((buf & 0xff) == 0xff) bytein();
    ct = 0;
  }
  size_t numbytes() const { return size_t(bp - start); }
};

uint32_t tgt_decode(Bio& bio, TagTree& tree, uint32_t leaf, int32_t threshold) {
  int32_t stk[64];
  int n = 0;
  int32_t node = int32_t(leaf);
  while (tree.nodes[node].parent >= 0) {
    stk[n++] = node;
    node = tree.nodes[node].parent;
  }
  int32_t low = 0;
  for (;;) {
    auto& nd = tree.nodes[node];
    if (low > nd.low)
      nd.low = low;
    else
      low = nd.low;
    while (low < threshold && low < nd.value) {
      if (bio.read(1))
        nd.value = low;
      else
        ++low;
    }
    nd.low = low;
    if (n == 0) break;
    node = stk[--n];
  }
  return tree.nodes[node].value < threshold ? 1 : 0;
}

// ---------------------------------------------------------------------------
// The tile's geometry (opj_tcd_init_tile)

union Sample {
  int32_t i;
  float f;
};

struct Precinct {
  int32_t x0, y0, x1, y1;
  uint32_t cw = 0, ch = 0;
  std::vector<Cblk> cblks;
  TagTree incl, imsb;
};

struct Band {
  uint32_t bandno = 0;
  int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  int32_t numbps = 0;
  float stepsize = 0;
  std::vector<Precinct> precincts;
  bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};

struct Resolution {
  int32_t x0, y0, x1, y1;
  uint32_t pw, ph, pdx, pdy, numbands;
  Band bands[3];
};

struct TileComp {
  int32_t x0, y0, x1, y1;
  uint32_t numres;
  std::vector<Resolution> res;
  std::vector<Sample> data;
  int32_t width() const { return res.empty() ? 0 : res.back().x1 - res.back().x0; }
  int32_t height() const { return res.empty() ? 0 : res.back().y1 - res.back().y0; }
};

struct Tile {
  int32_t x0, y0, x1, y1;
  std::vector<TileComp> comps;
};

// ---------------------------------------------------------------------------
// The decoder: the codestream's state machine (opj_j2k), tier 2, tier 1,
// reconstruction and the output image.

const float DWT_ALPHA = -1.586134342f, DWT_BETA = -0.052980118f;
const float DWT_GAMMA = 0.882911075f, DWT_DELTA = 0.443506852f;
const float DWT_K = 1.230174105f, DWT_TWO_INVK = 1.625732422f;

struct OutComp {
  uint32_t w = 0, h = 0, dx = 1, dy = 1, x0 = 0, y0 = 0;
  bool has_data = false;
  std::vector<int32_t> data;
};

struct Color {  // JP2 colour boxes
  bool has_colr = false;
  uint32_t meth = 0, enumcs = 0;
  bool has_pclr = false;
  uint32_t nr_entries = 0, nr_channels = 0;
  std::vector<uint32_t> channel_size, entries;
  bool has_cmap = false;
  std::vector<uint32_t> cmp, mtyp, pcol;
  bool has_cdef = false;
  std::vector<uint32_t> cn, typ, asoc;
};

struct Result {
  int color_space = 0;
  std::vector<OutComp> comps;
};

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t len) : d_(data), n_(len) {}

  // opj_read_header
  void read_header(bool jp2) {
    jp2_ = jp2;
    if (jp2) read_jp2_boxes();
    read_main_header();
  }

  void info(int32_t* out) const {
    uint32_t maxprec = 0, sgnd = 0;
    for (auto& c : comps_) {
      maxprec = std::max(maxprec, c.prec);
      sgnd |= c.sgnd;
    }
    out[0] = int32_t(x1_ - x0_);
    out[1] = int32_t(y1_ - y0_);
    out[2] = int32_t(comps_.size());
    out[3] = int32_t(maxprec);
    out[4] = int32_t(sgnd);
    out[5] = int32_t(ht_seen_);
  }

  Result decode() {
    decode_tiles();
    Result r;
    r.color_space = -1;  // OPJ_CLRSPC_UNKNOWN: cv2 assumes sRGB
    r.comps = std::move(out_);
    if (jp2_) jp2_postprocess(r);
    return r;
  }

 private:
  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0;
  bool jp2_ = false;
  bool ht_seen_ = false;

  // JP2
  uint32_t ihdr_w_ = 0, ihdr_h_ = 0, ihdr_nc_ = 0, bpc_ = 0;
  bool has_ihdr_ = false;
  Color color_;

  // SIZ
  uint32_t x0_ = 0, y0_ = 0, x1_ = 0, y1_ = 0;
  uint32_t tx0_ = 0, ty0_ = 0, tdx_ = 0, tdy_ = 0, tw_ = 0, th_ = 0;
  std::vector<Comp> comps_;

  Tcp deftcp_;
  std::vector<Tcp> tcps_;
  bool ppm_ = false;
  std::vector<Chunk> ppm_markers_;
  std::vector<uint8_t> ppm_buf_;
  size_t ppm_pos_ = 0;

  uint32_t state_ = ST_NONE;
  uint32_t cur_tile_ = 0;
  bool can_decode_ = false, last_tile_part_ = false;
  uint32_t sot_length_ = 0;
  bool correction_checked_ = false;
  uint32_t nb_parts_correction_ = 0;

  std::vector<OutComp> out_;
  bool fast_path_ = false;

  size_t left() const { return n_ - pos_; }
  bool read(uint8_t* out, size_t k) {
    if (left() < k) {
      pos_ = n_;
      return false;
    }
    memcpy(out, d_ + pos_, k);
    pos_ += k;
    return true;
  }
  bool read_u16(uint32_t* v) {
    uint8_t b[2];
    if (!read(b, 2)) return false;
    *v = rd(b, 2);
    return true;
  }

  // ----- JP2 boxes (opj_jp2_read_header_procedure)

  void read_jp2_boxes() {
    enum { SIG = 1, FTYP = 2, HEADER = 4 };
    uint32_t st = 0;
    bool has_jp2h = false;
    for (;;) {
      if (left() < 8) fail("JP2: no 'jp2c' box (the stream ends first)");
      uint64_t length = rd(d_ + pos_, 4);
      uint32_t type = rd(d_ + pos_ + 4, 4);
      uint32_t hdr = 8;
      pos_ += 8;
      if (length == 0) {
        length = left() + 8;
      } else if (length == 1) {
        if (left() < 8) fail("JP2: a box's XLBox runs past the file");
        if (rd(d_ + pos_, 4) != 0)
          fail("JP2: a box of 2^32 bytes or more");
        length = rd(d_ + pos_ + 4, 4);
        pos_ += 8;
        hdr = 16;
      }
      if (type == 0x6a703263) {  // 'jp2c'
        if (!(st & HEADER)) fail("JP2: the 'jp2c' box comes before 'jp2h'");
        break;
      }
      if (length < hdr) fail("JP2: box length %u is below its header", unsigned(length));
      uint64_t size = length - hdr;
      bool known = type == 0x6a502020 || type == 0x66747970 ||
                   type == 0x6a703268;
      bool inner = type == 0x69686472 || type == 0x636f6c72 ||
                   type == 0x62706363 || type == 0x70636c72 ||
                   type == 0x636d6170 || type == 0x63646566;
      if (!known && inner && !(st & HEADER)) {  // misplaced, ignored
        if (size > left()) fail("JP2: a box runs past the file");
        pos_ += size;
        continue;
      }
      if (!known && !inner) {
        if (!(st & SIG)) fail("JP2: the first box is not the signature box");
        if (!(st & FTYP)) fail("JP2: the second box is not 'ftyp'");
        if (size > left()) fail("JP2: a box runs past the file");
        pos_ += size;
        continue;
      }
      if (size > left()) fail("JP2: box '%.4s' runs past the file", d_ + pos_ - hdr + 4);
      const uint8_t* p = d_ + pos_;
      pos_ += size;
      if (type == 0x6a502020) {  // 'jP  '
        if (st != 0) fail("JP2: the signature box is not first");
        if (size != 4 || rd(p, 4) != 0x0d0a870a)
          fail("JP2: bad signature box");
        st |= SIG;
      } else if (type == 0x66747970) {  // 'ftyp'
        if (st != SIG) fail("JP2: 'ftyp' is not the second box");
        if (size < 8 || ((size - 8) & 3)) fail("JP2: bad 'ftyp' box size");
        st |= FTYP;
      } else if (type == 0x6a703268) {  // 'jp2h'
        if ((st & FTYP) != FTYP) fail("JP2: 'jp2h' before 'ftyp'");
        read_jp2h(p, uint32_t(size));
        st |= HEADER;
        has_jp2h = true;
      } else {
        read_jp2h_box(type, p, uint32_t(size));  // misplaced, after jp2h
      }
    }
    if (!has_jp2h) fail("JP2: no 'jp2h' box");
    if (!has_ihdr_) fail("JP2: no 'ihdr' box");
  }

  void read_jp2h(const uint8_t* p, uint32_t size) {
    bool has_ihdr = false;
    while (size > 0) {
      if (size < 8) fail("JP2: a box of less than 8 bytes in 'jp2h'");
      uint32_t length = rd(p, 4), type = rd(p + 4, 4), hdr = 8;
      if (length == 0) {
        length = size;
      } else if (length == 1) {
        if (size < 16) fail("JP2: an XL box of less than 16 bytes in 'jp2h'");
        if (rd(p + 8, 4) != 0) fail("JP2: a box of 2^32 bytes or more");
        length = rd(p + 12, 4);
        hdr = 16;
        if (length == 0) fail("JP2: a box of undefined size in 'jp2h'");
      }
      if (length < hdr) fail("JP2: inconsistent box length in 'jp2h'");
      if (length > size) fail("JP2: a box in 'jp2h' runs past it");
      read_jp2h_box(type, p + hdr, length - hdr);
      if (type == 0x69686472) has_ihdr = true;
      p += length;
      size -= length;
    }
    if (!has_ihdr) fail("JP2: 'jp2h' holds no 'ihdr' box");
  }

  void read_jp2h_box(uint32_t type, const uint8_t* p, uint32_t size) {
    Color& c = color_;
    if (type == 0x69686472) {  // 'ihdr'
      if (has_ihdr_) return;
      if (size != 14) fail("JP2: bad 'ihdr' box size");
      ihdr_h_ = rd(p, 4);
      ihdr_w_ = rd(p + 4, 4);
      ihdr_nc_ = rd(p + 8, 2);
      if (ihdr_h_ < 1 || ihdr_w_ < 1 || ihdr_nc_ < 1)
        fail("JP2: 'ihdr' gives a zero size or no component");
      if (ihdr_nc_ - 1 >= 16384) fail("JP2: 'ihdr' gives too many components");
      bpc_ = p[10];
      has_ihdr_ = true;
    } else if (type == 0x62706363) {  // 'bpcc'
      if (size != ihdr_nc_) fail("JP2: bad 'bpcc' box size");
    } else if (type == 0x636f6c72) {  // 'colr'
      if (size < 3) fail("JP2: bad 'colr' box size");
      if (c.has_colr) return;
      c.meth = p[0];
      if (c.meth == 1) {
        if (size < 7) fail("JP2: bad 'colr' box size");
        c.enumcs = rd(p + 3, 4);
        c.has_colr = true;
      } else if (c.meth == 2) {
        c.has_colr = true;
      }
    } else if (type == 0x70636c72) {  // 'pclr'
      if (c.has_pclr || size < 3) fail("JP2: bad 'pclr' box");
      c.nr_entries = rd(p, 2);
      if (c.nr_entries == 0 || c.nr_entries > 1024)
        fail("JP2: 'pclr' has %u entries", c.nr_entries);
      c.nr_channels = p[2];
      if (c.nr_channels == 0) fail("JP2: 'pclr' has no column");
      if (size < 3 + c.nr_channels) fail("JP2: bad 'pclr' box");
      const uint8_t* q = p + 3;
      for (uint32_t i = 0; i < c.nr_channels; ++i, ++q) {
        c.channel_size.push_back((*q & 0x7f) + 1);
      }
      for (uint32_t j = 0; j < c.nr_entries; ++j)
        for (uint32_t i = 0; i < c.nr_channels; ++i) {
          uint32_t nb = std::min<uint32_t>((c.channel_size[i] + 7) >> 3, 4);
          if (size < uint32_t(q - p) + nb) fail("JP2: 'pclr' runs short");
          c.entries.push_back(rd(q, int(nb)));
          q += nb;
        }
      c.has_pclr = true;
    } else if (type == 0x636d6170) {  // 'cmap'
      if (!c.has_pclr) fail("JP2: 'cmap' before 'pclr'");
      if (c.has_cmap) fail("JP2: a second 'cmap'");
      if (size < c.nr_channels * 4) fail("JP2: 'cmap' runs short");
      for (uint32_t i = 0; i < c.nr_channels; ++i) {
        c.cmp.push_back(rd(p + 4 * i, 2));
        c.mtyp.push_back(p[4 * i + 2]);
        c.pcol.push_back(p[4 * i + 3]);
      }
      c.has_cmap = true;
    } else if (type == 0x63646566) {  // 'cdef'
      if (c.has_cdef) fail("JP2: a second 'cdef'");
      if (size < 2) fail("JP2: 'cdef' runs short");
      uint32_t n = rd(p, 2);
      if (n == 0) fail("JP2: 'cdef' defines no channel");
      if (size < 2 + n * 6) fail("JP2: 'cdef' runs short");
      for (uint32_t i = 0; i < n; ++i) {
        c.cn.push_back(rd(p + 2 + 6 * i, 2));
        c.typ.push_back(rd(p + 4 + 6 * i, 2));
        c.asoc.push_back(rd(p + 6 + 6 * i, 2));
      }
      c.has_cdef = true;
    }
  }

  // ----- markers

  static uint32_t marker_states(uint32_t m) {
    switch (m) {
      case M_SOT: return ST_MH | ST_TPHSOT;
      case M_COD: case M_COC: case M_RGN: case M_QCD: case M_QCC:
      case M_POC: case M_COM: case M_MCT: case M_MCC: case M_MCO:
        return ST_MH | ST_TPH;
      case M_SIZ: return ST_MHSIZ;
      case M_TLM: case M_PLM: case M_PPM: case M_CRG: case M_CBD:
      case M_CAP: case M_CPF:
        return ST_MH;
      case M_PLT: case M_PPT: return ST_TPH;
      case M_SOP: return 0;
      default: return ~0u;  // unknown
    }
  }

  Tcp& tcp() { return state_ == ST_TPH ? tcps_[cur_tile_] : deftcp_; }
  uint32_t comp_room() const { return comps_.size() <= 256 ? 1 : 2; }

  void handle(uint32_t m, const uint8_t* p, uint32_t size) {
    switch (m) {
      case M_SIZ: read_siz(p, size); break;
      case M_COD: read_cod(p, size); break;
      case M_COC: read_coc(p, size); break;
      case M_QCD: read_qcd(p, size); break;
      case M_QCC: read_qcc(p, size); break;
      case M_RGN: read_rgn(p, size); break;
      case M_POC: read_poc(p, size); break;
      case M_PPM: read_ppx(p, size, true); break;
      case M_PPT: read_ppx(p, size, false); break;
      case M_TLM: read_tlm(p, size); break;
      case M_PLM:
        if (size < 1) fail("bad PLM marker");
        break;
      case M_PLT: read_plt(p, size); break;
      case M_CRG:
        if (size != comps_.size() * 4) fail("bad CRG marker");
        break;
      case M_SOT: read_sot(p, size); break;
      default: break;  // COM, CAP, CPF and Part 2's MCT, MCC, MCO, CBD
    }
  }

  void read_siz(const uint8_t* p, uint32_t size) {
    if (size < 36) fail("bad SIZ marker size");
    uint32_t nb = (size - 36) / 3;
    if (nb > 16384 || (size - 36) % 3) fail("bad SIZ marker size");
    x1_ = rd(p + 2, 4); y1_ = rd(p + 6, 4);
    x0_ = rd(p + 10, 4); y0_ = rd(p + 14, 4);
    tdx_ = rd(p + 18, 4); tdy_ = rd(p + 22, 4);
    tx0_ = rd(p + 26, 4); ty0_ = rd(p + 30, 4);
    uint32_t nc = rd(p + 34, 2);
    if (nc >= 16385) fail("SIZ: %u components", nc);
    if (nc != nb) fail("SIZ: %u components for %u component records", nc, nb);
    if (x0_ >= x1_ || y0_ >= y1_) fail("SIZ: a zero or negative image size");
    if (tdx_ == 0 || tdy_ == 0) fail("SIZ: a zero tile size");
    uint64_t tx1 = uint64_t(tx0_) + tdx_, ty1 = uint64_t(ty0_) + tdy_;
    tx1 = std::min<uint64_t>(tx1, 0xffffffffu);
    ty1 = std::min<uint64_t>(ty1, 0xffffffffu);
    if (tx0_ > x0_ || ty0_ > y0_ || tx1 <= x0_ || ty1 <= y0_)
      fail("SIZ: illegal tile offset");
    if (ihdr_w_ > 0 && ihdr_h_ > 0 &&
        (ihdr_w_ != x1_ - x0_ || ihdr_h_ != y1_ - y0_))
      fail("SIZ: size %u x %u differs from 'ihdr''s %u x %u", x1_ - x0_,
           y1_ - y0_, ihdr_w_, ihdr_h_);
    comps_.assign(nc, Comp());
    for (uint32_t i = 0; i < nc; ++i) {
      const uint8_t* q = p + 36 + 3 * i;
      comps_[i].prec = (q[0] & 0x7f) + 1;
      comps_[i].sgnd = q[0] >> 7;
      comps_[i].dx = q[1];
      comps_[i].dy = q[2];
      if (q[1] < 1 || q[2] < 1) fail("SIZ: component %u has a zero sub-sampling", i);
      if (comps_[i].prec > 31) fail("SIZ: component %u has %u bits", i, comps_[i].prec);
    }
    tw_ = uint32_t(ceildiv(int64_t(x1_) - tx0_, tdx_));
    th_ = uint32_t(ceildiv(int64_t(y1_) - ty0_, tdy_));
    if (tw_ == 0 || th_ == 0 || tw_ > 65535 / th_)
      fail("SIZ: %u x %u tiles", tw_, th_);
    deftcp_.tccps.assign(nc, Tccp());
    for (uint32_t i = 0; i < nc; ++i)
      if (!comps_[i].sgnd)
        deftcp_.tccps[i].dc_shift = int32_t(1u << (comps_[i].prec - 1));
    state_ = ST_MH;
  }

  void read_spcod(Tccp& t, const uint8_t*& p, uint32_t& size) {
    if (size < 5) fail("bad SPCod / SPCoc");
    t.numres = p[0] + 1u;
    if (t.numres > MAXRLVLS) fail("%u resolutions", t.numres);
    t.cblkw = p[1] + 2u;
    t.cblkh = p[2] + 2u;
    if (t.cblkw > 10 || t.cblkh > 10 || t.cblkw + t.cblkh > 12)
      fail("bad code-block size");
    t.cblksty = p[3];
    if (t.cblksty & CBLK_HTMIXED) fail("mixed HTJ2K code-blocks");
    if (t.cblksty & CBLK_HT) ht_seen_ = true;
    t.qmfbid = p[4];
    if (t.qmfbid > 1) fail("a Part 2 wavelet (%u)", t.qmfbid);
    p += 5;
    size -= 5;
    if (t.csty & CSTY_PRT) {
      if (size < t.numres) fail("bad SPCod / SPCoc");
      for (uint32_t i = 0; i < t.numres; ++i) {
        uint32_t v = p[i];
        if (i != 0 && ((v & 0xf) == 0 || (v >> 4) == 0))
          fail("bad precinct size");
        t.prcw[i] = v & 0xf;
        t.prch[i] = v >> 4;
      }
      p += t.numres;
      size -= t.numres;
    } else {
      for (uint32_t i = 0; i < t.numres; ++i) t.prcw[i] = t.prch[i] = 15;
    }
  }

  void read_cod(const uint8_t* p, uint32_t size) {
    Tcp& t = tcp();
    if (size < 5) fail("bad COD marker");
    t.csty = p[0];
    if (t.csty & ~7u) fail("unknown Scod value in COD");
    t.prg = p[1] > 4 ? -1 : p[1];
    t.numlayers = rd(p + 2, 2);
    if (t.numlayers < 1) fail("COD: no layer");
    t.mct = p[4];
    if (t.mct > 1) fail("COD: multiple component transform %u", t.mct);
    p += 5;
    size -= 5;
    for (auto& c : t.tccps) c.csty = t.csty & CSTY_PRT;
    read_spcod(t.tccps[0], p, size);
    if (size != 0) fail("bad COD marker");
    for (size_t i = 1; i < t.tccps.size(); ++i) {
      Tccp& c = t.tccps[i];
      const Tccp& r = t.tccps[0];
      c.numres = r.numres; c.cblkw = r.cblkw; c.cblkh = r.cblkh;
      c.cblksty = r.cblksty; c.qmfbid = r.qmfbid;
      memcpy(c.prcw, r.prcw, sizeof c.prcw);
      memcpy(c.prch, r.prch, sizeof c.prch);
    }
  }

  void read_coc(const uint8_t* p, uint32_t size) {
    Tcp& t = tcp();
    uint32_t room = comp_room();
    if (size < room + 1) fail("bad COC marker");
    uint32_t c = rd(p, int(room));
    if (c >= comps_.size()) fail("COC: component %u", c);
    t.tccps[c].csty = p[room];
    p += room + 1;
    size -= room + 1;
    read_spcod(t.tccps[c], p, size);
    if (size != 0) fail("bad COC marker");
  }

  void read_sqcd(Tccp& t, const uint8_t* p, uint32_t& size) {
    if (size < 1) fail("bad QCD / QCC");
    size -= 1;
    t.qntsty = p[0] & 0x1f;
    t.numgbits = p[0] >> 5;
    ++p;
    uint32_t nb = t.qntsty == QNT_DERIVED ? 1
                  : t.qntsty == QNT_NONE  ? size
                                          : size / 2;
    if (t.qntsty == QNT_NONE) {
      for (uint32_t b = 0; b < nb; ++b)
        if (b < MAXBANDS) t.ss[b] = {int32_t(p[b] >> 3), 0};
      size -= nb;
    } else {
      if (size < 2 * nb) fail("bad QCD / QCC");
      for (uint32_t b = 0; b < nb; ++b) {
        uint32_t v = rd(p + 2 * b, 2);
        if (b < MAXBANDS) t.ss[b] = {int32_t(v >> 11), int32_t(v & 0x7ff)};
      }
      size -= 2 * nb;
    }
    if (t.qntsty == QNT_DERIVED)
      for (int b = 1; b < MAXBANDS; ++b)
        t.ss[b] = {std::max(t.ss[0].expn - (b - 1) / 3, 0), t.ss[0].mant};
  }

  void read_qcd(const uint8_t* p, uint32_t size) {
    Tcp& t = tcp();
    read_sqcd(t.tccps[0], p, size);
    if (size != 0) fail("bad QCD marker");
    for (size_t i = 1; i < t.tccps.size(); ++i) {
      t.tccps[i].qntsty = t.tccps[0].qntsty;
      t.tccps[i].numgbits = t.tccps[0].numgbits;
      memcpy(t.tccps[i].ss, t.tccps[0].ss, sizeof t.tccps[0].ss);
    }
  }

  void read_qcc(const uint8_t* p, uint32_t size) {
    Tcp& t = tcp();
    uint32_t room = comp_room();
    if (size < room) fail("bad QCC marker");
    uint32_t c = rd(p, int(room));
    if (c >= comps_.size()) fail("QCC: component %u", c);
    size -= room;
    read_sqcd(t.tccps[c], p + room, size);
    if (size != 0) fail("bad QCC marker");
  }

  void read_rgn(const uint8_t* p, uint32_t size) {
    uint32_t room = comp_room();
    if (size != 2 + room) fail("bad RGN marker");
    uint32_t c = rd(p, int(room));
    if (c >= comps_.size()) fail("RGN: component %u", c);
    tcp().tccps[c].roishift = p[room + 1];
  }

  void read_poc(const uint8_t* p, uint32_t size) {
    Tcp& t = tcp();
    uint32_t room = comp_room(), chunk = 5 + 2 * room;
    uint32_t n = size / chunk;
    if (n == 0 || size % chunk) fail("bad POC marker");
    if (!t.poc) t.pocs.clear();
    if (t.pocs.size() + n >= 32) fail("too many POC entries");
    for (uint32_t i = 0; i < n; ++i, p += chunk) {
      Poc q;
      q.resno0 = p[0];
      q.compno0 = rd(p + 1, int(room));
      q.layno1 = rd(p + 1 + room, 2);
      q.resno1 = p[3 + room];
      q.compno1 = std::min<uint32_t>(rd(p + 4 + room, int(room)),
                                     uint32_t(comps_.size()));
      q.prg = p[4 + 2 * room];
      t.pocs.push_back(q);
    }
    t.poc = true;
  }

  void read_ppx(const uint8_t* p, uint32_t size, bool main) {
    if (size < 2) fail("bad %s marker", main ? "PPM" : "PPT");
    if (!main && ppm_) fail("PPT after PPM");
    std::vector<Chunk>& v = main ? ppm_markers_ : tcp().ppt_markers;
    if (v.empty()) v.resize(256);
    uint32_t z = p[0];
    if (v[z].present) fail("%s %u read twice", main ? "Zppm" : "Zppt", z);
    v[z].present = true;
    v[z].data.assign(p + 1, p + size);
    if (main)
      ppm_ = true;
    else
      tcp().ppt = true;
  }

  void read_tlm(const uint8_t* p, uint32_t size) {
    if (size < 2) fail("bad TLM marker");
    uint32_t st = (p[1] >> 4) & 3, sp = (p[1] >> 6) & 1;
    (void)st;
    (void)sp;  // OpenJPEG only warns of a TLM it cannot use
  }

  void read_plt(const uint8_t* p, uint32_t size) {
    if (size < 1) fail("bad PLT marker");
    uint32_t len = 0;
    for (uint32_t i = 1; i < size; ++i) {
      len |= p[i] & 0x7f;
      if (p[i] & 0x80)
        len <<= 7;
      else
        len = 0;
    }
    if (len != 0) fail("bad PLT marker");
  }

  void read_sot(const uint8_t* p, uint32_t size) {
    if (size != 8) fail("bad SOT marker");
    cur_tile_ = rd(p, 2);
    uint32_t tot_len = rd(p + 2, 4), part = p[6], num_parts = p[7];
    if (cur_tile_ >= tw_ * th_) fail("SOT: tile %u of %u", cur_tile_, tw_ * th_);
    Tcp& t = tcps_[cur_tile_];
    if (t.cur_part + 1 != int(part))
      fail("SOT: tile-part %u of tile %u, expected %d", part, cur_tile_,
           t.cur_part + 1);
    t.cur_part = int(part);
    if (tot_len != 0 && tot_len < 14 && tot_len != 12)
      fail("SOT: Psot %u", tot_len);
    if (tot_len == 0) last_tile_part_ = true;
    if (t.nb_parts != 0 && part >= t.nb_parts) {
      last_tile_part_ = true;
      fail("SOT: TPsot %u past the tile's %u parts", part, t.nb_parts);
    }
    if (num_parts != 0) {
      num_parts += nb_parts_correction_;
      if (part >= num_parts) {
        last_tile_part_ = true;
        fail("SOT: TPsot %u past TNsot %u", part, num_parts);
      }
      t.nb_parts = num_parts;
    }
    if (t.nb_parts && t.nb_parts == part + 1) can_decode_ = true;
    sot_length_ = last_tile_part_ ? 0 : tot_len - 12;
    state_ = ST_TPH;
  }

  // opj_j2k_read_unk: skip two bytes at a time to the next known marker
  uint32_t skip_unknown() {
    for (;;) {
      uint32_t m;
      if (!read_u16(&m)) fail("the stream ends in an unknown marker");
      if (m < 0xff00) continue;
      uint32_t st = marker_states(m);
      if (st == ~0u) st = ST_MH | ST_TPH;
      if (!(state_ & st)) fail("marker %04x out of place", m);
      if (marker_states(m) != ~0u) return m;
    }
  }

  void read_main_header() {
    pos_ = jp2_ ? pos_ : 0;
    state_ = ST_MHSOC;
    uint32_t m;
    if (!read_u16(&m) || m != M_SOC) fail("no SOC marker");
    state_ = ST_MHSIZ;
    if (!read_u16(&m)) fail("the stream ends in the main header");
    bool has_siz = false, has_cod = false, has_qcd = false;
    while (m != M_SOT) {
      if (m < 0xff00) fail("a marker was expected, found %04x", m);
      uint32_t st = marker_states(m);
      if (st == ~0u) {
        m = skip_unknown();
        if (m == M_SOT) break;
        st = marker_states(m);
      }
      has_siz |= m == M_SIZ;
      has_cod |= m == M_COD;
      has_qcd |= m == M_QCD;
      if (!(state_ & st)) fail("marker %04x out of place", m);
      uint32_t size;
      if (!read_u16(&size)) fail("the stream ends in the main header");
      if (size < 2) fail("marker %04x: bad size", m);
      size -= 2;
      if (size > left()) fail("the stream ends in marker %04x", m);
      const uint8_t* p = d_ + pos_;
      pos_ += size;
      handle(m, p, size);
      if (!read_u16(&m)) fail("the stream ends in the main header");
    }
    if (!has_siz) fail("no SIZ marker");
    if (!has_cod) fail("no COD marker");
    if (!has_qcd) fail("no QCD marker");
    merge_ppm();
    state_ = ST_TPHSOT;
    tcps_.assign(size_t(tw_) * th_, deftcp_);
    out_.assign(comps_.size(), OutComp());
    for (size_t i = 0; i < comps_.size(); ++i) {
      OutComp& o = out_[i];
      const Comp& c = comps_[i];
      uint64_t ix0 = std::max(tx0_, x0_), iy0 = std::max(ty0_, y0_);
      uint64_t ix1 = std::min<uint64_t>(uint64_t(tx0_) + uint64_t(tw_ - 1) * tdx_ + tdx_, x1_);
      uint64_t iy1 = std::min<uint64_t>(uint64_t(ty0_) + uint64_t(th_ - 1) * tdy_ + tdy_, y1_);
      o.x0 = uint32_t(ceildiv(int64_t(ix0), c.dx));
      o.y0 = uint32_t(ceildiv(int64_t(iy0), c.dy));
      o.w = uint32_t(ceildiv(int64_t(ix1), c.dx)) - o.x0;
      o.h = uint32_t(ceildiv(int64_t(iy1), c.dy)) - o.y0;
      o.dx = c.dx;
      o.dy = c.dy;
    }
  }

  static void merge(std::vector<Chunk>& markers, std::vector<uint8_t>& out) {
    out.clear();
    for (auto& m : markers)
      if (m.present) out.insert(out.end(), m.data.begin(), m.data.end());
  }

  void merge_ppm() {
    if (!ppm_) return;
    // the packet headers without each tile-part's Nppm, as
    // opj_j2k_merge_ppm joins them (an Nppm's data may span markers)
    ppm_buf_.clear();
    uint32_t remaining = 0;
    for (auto& m : ppm_markers_) {
      if (!m.present) continue;
      size_t k = 0, sz = m.data.size();
      if (remaining >= sz) {
        remaining -= uint32_t(sz);
        ppm_buf_.insert(ppm_buf_.end(), m.data.begin(), m.data.end());
        continue;
      }
      ppm_buf_.insert(ppm_buf_.end(), m.data.begin(), m.data.begin() + remaining);
      k = remaining;
      remaining = 0;
      while (k < sz) {
        if (sz - k < 4) fail("PPM: not enough bytes for Nppm");
        uint32_t nppm = rd(m.data.data() + k, 4);
        k += 4;
        if (sz - k >= nppm) {
          ppm_buf_.insert(ppm_buf_.end(), m.data.begin() + k, m.data.begin() + k + nppm);
          k += nppm;
        } else {
          ppm_buf_.insert(ppm_buf_.end(), m.data.begin() + k, m.data.end());
          remaining = nppm - uint32_t(sz - k);
          k = sz;
        }
      }
    }
    if (remaining != 0) fail("corrupted PPM markers");
    ppm_pos_ = 0;
  }

  // ----- tile-parts (opj_j2k_read_tile_header / read_sod / decode_tile)

  void read_sod() {
    Tcp& t = tcps_[cur_tile_];
    if (last_tile_part_) {
      sot_length_ = uint32_t(left() >= 2 ? left() - 2 : uint32_t(left() - 2));
    } else if (sot_length_ >= 2) {
      sot_length_ -= 2;
    }
    size_t got = 0;
    if (sot_length_) {
      if (sot_length_ > left()) fail("a tile-part runs past the end of the stream");
      got = sot_length_;
      t.data.insert(t.data.end(), d_ + pos_, d_ + pos_ + got);
      t.has_data = true;
      pos_ += got;
    }
    state_ = got != sot_length_ ? ST_NEOC : ST_TPHSOT;
  }

  // opj_j2k_need_nb_tile_parts_correction
  bool need_parts_correction(uint32_t tile) {
    size_t save = pos_;
    bool need = false;
    for (;;) {
      uint32_t m;
      if (!read_u16(&m) || m != M_SOT) break;
      uint32_t sz;   // a stream that ends here is left to fail later
      if (!read_u16(&sz)) break;
      if (sz != 10) fail("bad SOT marker size");
      if (left() < 8) break;
      const uint8_t* p = d_ + pos_;
      pos_ += 8;
      uint32_t tno = rd(p, 2), tot = rd(p + 2, 4), part = p[6], nparts = p[7];
      if (tno == tile) {
        need = part == nparts;
        break;
      }
      if (tot < 14) break;
      if (tot - 12 > left()) break;
      pos_ += tot - 12;
    }
    pos_ = save;
    return need;
  }

  // returns false where no tile is left to decode
  bool read_tile_header(uint32_t* tile) {
    uint32_t m = M_SOT;
    if (state_ == ST_EOC)
      m = M_EOC;
    else if (state_ != ST_TPHSOT)
      fail("the stream does not continue with a tile-part");
    while (!can_decode_ && m != M_EOC) {
      while (m != M_SOD) {
        if (left() == 0) {
          state_ = ST_NEOC;
          break;
        }
        uint32_t size;
        if (!read_u16(&size)) fail("the stream ends in a tile-part header");
        if (size < 2) fail("marker %04x: bad size", m);
        if (m == 0x8080 && left() == 0) {
          state_ = ST_NEOC;
          break;
        }
        if ((state_ & ST_TPH) && sot_length_ != 0) {
          if (sot_length_ < size + 2) fail("a tile-part header runs past Psot");
          sot_length_ -= size + 2;
        }
        size -= 2;
        uint32_t st = marker_states(m);
        if (st == ~0u) st = ST_MH | ST_TPH;
        if (!(state_ & st)) fail("marker %04x out of place", m);
        if (size > left()) fail("the stream ends in marker %04x", m);
        if (marker_states(m) == ~0u)
          fail("unknown marker %04x in a tile-part header", m);
        const uint8_t* p = d_ + pos_;
        pos_ += size;
        handle(m, p, size);
        if (!read_u16(&m)) fail("the stream ends in a tile-part header");
      }
      if (left() == 0 && state_ == ST_NEOC) break;
      read_sod();
      if (can_decode_ && !correction_checked_) {
        correction_checked_ = true;
        if (need_parts_correction(cur_tile_)) {
          nb_parts_correction_ = 1;
          for (auto& t : tcps_)
            if (t.nb_parts) t.nb_parts++;
          can_decode_ = false;
        }
      }
      if (!can_decode_ && !read_u16(&m)) {
        // the stream ends without EOC. As measured against cv2, OpenJPEG
        // goes on only after a tile-part of the last tile with TNsot 0,
        // and then decodes the tiles from the first one of a single
        // tile-part on
        const Tcp& t = tcps_[cur_tile_];
        if (cur_tile_ + 1 != tcps_.size() || t.nb_parts)
          fail("the stream ends after a tile-part");
        uint32_t first = 0;
        while (first < tcps_.size() && tcps_[first].cur_part != 0) ++first;
        if (first == tcps_.size()) fail("the stream ends after a tile-part");
        cur_tile_ = first;
        state_ = ST_EOC;
        m = M_EOC;
        break;
      }
    }
    if (m == M_EOC && state_ != ST_EOC) {
      cur_tile_ = 0;
      state_ = ST_EOC;
    }
    if (!can_decode_) {
      while (cur_tile_ < tcps_.size() && !tcps_[cur_tile_].has_data) ++cur_tile_;
      if (cur_tile_ == tcps_.size()) return false;
    }
    merge(tcps_[cur_tile_].ppt_markers, tcps_[cur_tile_].ppt_buf);
    tcps_[cur_tile_].ppt_pos = 0;
    *tile = cur_tile_;
    return true;
  }

  void after_tile() {
    can_decode_ = false;
    if (left() == 0 && state_ == ST_NEOC) return;
    if (state_ != ST_EOC) {
      uint32_t m;
      if (!read_u16(&m)) fail("the stream ends after a tile (no EOC)");
      if (m == M_EOC) {
        cur_tile_ = 0;
        state_ = ST_EOC;
      } else if (m != M_SOT) {
        if (left() == 0) {
          state_ = ST_NEOC;
          return;
        }
        fail("a SOT marker was expected, found %04x", m);
      }
    }
  }

  void decode_tiles() {
    size_t ntiles = tcps_.size();
    uint32_t tile;
    if (tw_ == 1 && th_ == 1 && tx0_ == 0 && ty0_ == 0 && x0_ == 0 &&
        y0_ == 0 && x1_ == tdx_ && y1_ == tdy_) {
      fast_path_ = true;
      if (!read_tile_header(&tile)) fail("no tile to decode");
      Tile t = decode_tile(tile);
      after_tile();
      for (size_t c = 0; c < comps_.size(); ++c) {
        OutComp& o = out_[c];
        TileComp& tc = t.comps[c];
        o.data.resize(tc.data.size());
        for (size_t i = 0; i < tc.data.size(); ++i) o.data[i] = tc.data[i].i;
        o.has_data = true;
      }
      return;
    }
    size_t decoded = 0;
    for (;;) {
      if (!read_tile_header(&tile)) break;
      Tile t = decode_tile(tile);
      after_tile();
      update_image(t);
      if (left() == 0 && state_ == ST_NEOC) break;
      if (++decoded == ntiles) break;
    }
    for (auto& o : out_)
      if (!o.has_data) fail("no tile of a component was decoded");
  }

  // ----- one tile (opj_tcd_init_tile, opj_tcd_decode_tile)

  Tile init_tile(uint32_t tileno, const Tcp& t) {
    Tile tile;
    uint32_t p = tileno % tw_, q = tileno / tw_;
    tile.x0 = int32_t(std::max<uint64_t>(uint64_t(tx0_) + uint64_t(p) * tdx_, x0_));
    tile.y0 = int32_t(std::max<uint64_t>(uint64_t(ty0_) + uint64_t(q) * tdy_, y0_));
    tile.x1 = int32_t(std::min<uint64_t>(uint64_t(tx0_) + uint64_t(p + 1) * tdx_, x1_));
    tile.y1 = int32_t(std::min<uint64_t>(uint64_t(ty0_) + uint64_t(q + 1) * tdy_, y1_));
    tile.comps.resize(comps_.size());
    for (size_t c = 0; c < comps_.size(); ++c) {
      const Comp& cp = comps_[c];
      const Tccp& tc = t.tccps[c];
      TileComp& k = tile.comps[c];
      k.x0 = int32_t(ceildiv(tile.x0, cp.dx));
      k.y0 = int32_t(ceildiv(tile.y0, cp.dy));
      k.x1 = int32_t(ceildiv(tile.x1, cp.dx));
      k.y1 = int32_t(ceildiv(tile.y1, cp.dy));
      k.numres = tc.numres;
      k.res.resize(tc.numres);
      uint32_t step = 0;
      for (uint32_t r = 0; r < tc.numres; ++r) {
        Resolution& res = k.res[r];
        int lev = int(tc.numres - 1 - r);
        res.x0 = int32_t(ceildivpow2(k.x0, lev));
        res.y0 = int32_t(ceildivpow2(k.y0, lev));
        res.x1 = int32_t(ceildivpow2(k.x1, lev));
        res.y1 = int32_t(ceildivpow2(k.y1, lev));
        res.pdx = tc.prcw[r];
        res.pdy = tc.prch[r];
        int64_t tlpx = floordivpow2(res.x0, int(res.pdx)) << res.pdx;
        int64_t tlpy = floordivpow2(res.y0, int(res.pdy)) << res.pdy;
        int64_t brpx = ceildivpow2(res.x1, int(res.pdx)) << res.pdx;
        int64_t brpy = ceildivpow2(res.y1, int(res.pdy)) << res.pdy;
        if (brpx > INT32_MAX || brpy > INT32_MAX) fail("a precinct past 2^31");
        res.pw = res.x0 == res.x1 ? 0 : uint32_t((brpx - tlpx) >> res.pdx);
        res.ph = res.y0 == res.y1 ? 0 : uint32_t((brpy - tlpy) >> res.pdy);
        if (res.pw && uint64_t(res.pw) * res.ph > (1u << 28))
          fail("too many precincts");
        res.numbands = r == 0 ? 1 : 3;
        int64_t tlcbgx, tlcbgy;
        uint32_t cbgw, cbgh;
        if (r == 0) {
          tlcbgx = tlpx; tlcbgy = tlpy; cbgw = res.pdx; cbgh = res.pdy;
        } else {
          tlcbgx = ceildivpow2(tlpx, 1); tlcbgy = ceildivpow2(tlpy, 1);
          cbgw = res.pdx - 1; cbgh = res.pdy - 1;
        }
        uint32_t cblkw = std::min(tc.cblkw, cbgw), cblkh = std::min(tc.cblkh, cbgh);
        for (uint32_t b = 0; b < res.numbands; ++b, ++step) {
          Band& band = res.bands[b];
          if (r == 0) {
            band.bandno = 0;
            band.x0 = int32_t(ceildivpow2(k.x0, lev));
            band.y0 = int32_t(ceildivpow2(k.y0, lev));
            band.x1 = int32_t(ceildivpow2(k.x1, lev));
            band.y1 = int32_t(ceildivpow2(k.y1, lev));
          } else {
            band.bandno = b + 1;
            int64_t xb = band.bandno & 1, yb = band.bandno >> 1;
            band.x0 = int32_t(ceildivpow2(k.x0 - (xb << lev), lev + 1));
            band.y0 = int32_t(ceildivpow2(k.y0 - (yb << lev), lev + 1));
            band.x1 = int32_t(ceildivpow2(k.x1 - (xb << lev), lev + 1));
            band.y1 = int32_t(ceildivpow2(k.y1 - (yb << lev), lev + 1));
          }
          const StepSize& ss = tc.ss[std::min<uint32_t>(step, MAXBANDS - 1)];
          band.stepsize = float((1.0 + ss.mant / 2048.0) *
                                std::pow(2.0, int32_t(cp.prec) - ss.expn));
          band.numbps = ss.expn + int32_t(tc.numgbits) - 1;
          if (band.empty()) continue;
          band.precincts.resize(size_t(res.pw) * res.ph);
          for (uint32_t pn = 0; pn < res.pw * res.ph; ++pn) {
            Precinct& pr = band.precincts[pn];
            int64_t cx = tlcbgx + int64_t(pn % res.pw) * (int64_t(1) << cbgw);
            int64_t cy = tlcbgy + int64_t(pn / res.pw) * (int64_t(1) << cbgh);
            pr.x0 = int32_t(std::max<int64_t>(cx, band.x0));
            pr.y0 = int32_t(std::max<int64_t>(cy, band.y0));
            pr.x1 = int32_t(std::min<int64_t>(cx + (int64_t(1) << cbgw), band.x1));
            pr.y1 = int32_t(std::min<int64_t>(cy + (int64_t(1) << cbgh), band.y1));
            int64_t tlbx = floordivpow2(pr.x0, int(cblkw)) << cblkw;
            int64_t tlby = floordivpow2(pr.y0, int(cblkh)) << cblkh;
            int64_t brbx = ceildivpow2(pr.x1, int(cblkw)) << cblkw;
            int64_t brby = ceildivpow2(pr.y1, int(cblkh)) << cblkh;
            pr.cw = uint32_t(std::max<int64_t>(0, (brbx - tlbx) >> cblkw));
            pr.ch = uint32_t(std::max<int64_t>(0, (brby - tlby) >> cblkh));
            pr.cblks.resize(size_t(pr.cw) * pr.ch);
            for (uint32_t cn = 0; cn < pr.cw * pr.ch; ++cn) {
              Cblk& cb = pr.cblks[cn];
              int64_t bx = tlbx + int64_t(cn % pr.cw) * (int64_t(1) << cblkw);
              int64_t by = tlby + int64_t(cn / pr.cw) * (int64_t(1) << cblkh);
              cb.x0 = int32_t(std::max<int64_t>(bx, pr.x0));
              cb.y0 = int32_t(std::max<int64_t>(by, pr.y0));
              cb.x1 = int32_t(std::min<int64_t>(bx + (int64_t(1) << cblkw), pr.x1));
              cb.y1 = int32_t(std::min<int64_t>(by + (int64_t(1) << cblkh), pr.y1));
            }
            pr.incl.create(pr.cw, pr.ch);
            pr.imsb.create(pr.cw, pr.ch);
          }
        }
      }
      uint64_t need = uint64_t(std::max(k.width(), 0)) * std::max(k.height(), 0);
      if (need > (uint64_t(1) << 31)) fail("a tile component past 2^31 samples");
      k.data.assign(need, Sample{0});
    }
    return tile;
  }

  Tile decode_tile(uint32_t tileno) {
    Tcp& t = tcps_[tileno];
    if (!t.has_data) fail("tile %u has no data", tileno);
    Tile tile = init_tile(tileno, t);
    t2_decode(tile, t);
    t1_decode(tile, t);
    for (size_t c = 0; c < comps_.size(); ++c) {
      if (comps_[c].resno_decoded >= tile.comps[c].numres)
        fail("the tiles of component %zu differ in resolutions", c);
      if (t.tccps[c].qmfbid == 1)
        dwt53(tile.comps[c], comps_[c].resno_decoded + 1);
      else
        dwt97(tile.comps[c], comps_[c].resno_decoded + 1);
    }
    mct(tile, t);
    dc_shift(tile, t);
    t.data.clear();
    t.data.shrink_to_fit();
    t.has_data = false;
    return tile;
  }

  // ----- tier 2

  struct Packet {
    uint32_t layno, resno, compno, precno;
  };

  std::vector<Packet> packets(const Tile& tile, const Tcp& t) {
    uint32_t maxres = 0, maxprec = 0;
    for (auto& k : tile.comps) {
      maxres = std::max(maxres, k.numres);
      for (auto& r : k.res) maxprec = std::max(maxprec, r.pw * r.ph);
    }
    uint64_t step_c = maxprec, step_r = comps_.size() * step_c;
    uint64_t step_l = maxres * step_r;
    uint64_t include_size = (uint64_t(t.numlayers) + 1) * step_l;
    if (include_size > (uint64_t(1) << 32)) fail("too many packets");
    std::vector<uint8_t> include(include_size, 0);
    std::vector<Packet> out;
    std::vector<Poc> vols;
    if (t.poc) {
      for (auto q : t.pocs) {
        q.layno1 = std::min(q.layno1, t.numlayers);
        vols.push_back(q);
      }
    } else {
      if (t.prg < 0) fail("an unknown progression order");
      vols.push_back(Poc{0, 0, t.numlayers, maxres, uint32_t(comps_.size()),
                         uint32_t(t.prg)});
    }
    auto add = [&](uint32_t l, uint32_t r, uint32_t c, uint32_t p) {
      uint64_t idx = l * step_l + r * step_r + c * step_c + p;
      if (idx >= include_size) fail("a packet index past OpenJPEG's table");
      if (!include[idx]) {
        include[idx] = 1;
        out.push_back(Packet{l, r, c, p});
      }
    };
    int64_t tx0 = tile.x0, ty0 = tile.y0, tx1 = tile.x1, ty1 = tile.y1;
    for (const Poc& v : vols) {
      uint32_t nc = uint32_t(comps_.size());
      if (v.prg == 0 || v.prg == 1) {  // LRCP / RLCP
        bool lrcp = v.prg == 0;
        uint32_t n1 = lrcp ? v.layno1 : v.resno1, n2 = lrcp ? v.resno1 : v.layno1;
        uint32_t s1 = lrcp ? 0 : v.resno0, s2 = lrcp ? v.resno0 : 0;
        for (uint32_t a = s1; a < n1; ++a)
          for (uint32_t b = s2; b < n2; ++b)
            for (uint32_t c = v.compno0; c < v.compno1; ++c) {
              uint32_t l = lrcp ? a : b, r = lrcp ? b : a;
              if (r >= tile.comps[c].numres) continue;
              const Resolution& res = tile.comps[c].res[r];
              for (uint32_t p = 0; p < res.pw * res.ph; ++p) add(l, r, c, p);
            }
        continue;
      }
      if (v.prg > 4) continue;
      // position-driven orders: the precinct a (x, y) starts, if any
      auto precinct_at = [&](uint32_t c, uint32_t r, int64_t x, int64_t y,
                             uint32_t* prec) {
        const TileComp& k = tile.comps[c];
        const Resolution& res = k.res[r];
        const Comp& cp = comps_[c];
        uint32_t lev = k.numres - 1 - r;
        if (lev >= 32) return false;
        int64_t cdx = int64_t(cp.dx) << lev, cdy = int64_t(cp.dy) << lev;
        if (cdx > INT32_MAX || cdy > INT32_MAX) return false;
        int64_t trx0 = ceildiv(tx0, cdx), try0 = ceildiv(ty0, cdy);
        int64_t trx1 = ceildiv(tx1, cdx), try1 = ceildiv(ty1, cdy);
        uint32_t rpx = res.pdx + lev, rpy = res.pdy + lev;
        if (rpx >= 31 || rpy >= 31) return false;
        if (!(y % (int64_t(cp.dy) << rpy) == 0 ||
              (y == ty0 && ((try0 << lev) % (int64_t(1) << rpy)))))
          return false;
        if (!(x % (int64_t(cp.dx) << rpx) == 0 ||
              (x == tx0 && ((trx0 << lev) % (int64_t(1) << rpx)))))
          return false;
        if (res.pw == 0 || res.ph == 0) return false;
        if (trx0 == trx1 || try0 == try1) return false;
        int64_t prci = floordivpow2(ceildiv(x, cdx), int(res.pdx)) -
                       floordivpow2(trx0, int(res.pdx));
        int64_t prcj = floordivpow2(ceildiv(y, cdy), int(res.pdy)) -
                       floordivpow2(try0, int(res.pdy));
        *prec = uint32_t(prci + prcj * res.pw);
        return true;
      };
      auto steps = [&](uint32_t c0, uint32_t c1, int64_t* dx, int64_t* dy) {
        *dx = 0;
        *dy = 0;
        for (uint32_t c = c0; c < c1; ++c) {
          const TileComp& k = tile.comps[c];
          for (uint32_t r = 0; r < k.numres; ++r) {
            uint32_t sx = k.res[r].pdx + k.numres - 1 - r;
            uint32_t sy = k.res[r].pdy + k.numres - 1 - r;
            if (sx < 32 && comps_[c].dx <= (0xffffffffu >> sx)) {
              int64_t v2 = int64_t(comps_[c].dx) << sx;
              *dx = *dx ? std::min(*dx, v2) : v2;
            }
            if (sy < 32 && comps_[c].dy <= (0xffffffffu >> sy)) {
              int64_t v2 = int64_t(comps_[c].dy) << sy;
              *dy = *dy ? std::min(*dy, v2) : v2;
            }
          }
        }
        return *dx != 0 && *dy != 0;
      };
      int64_t dx, dy;
      uint32_t prec;
      if (v.prg == 2) {  // RPCL
        if (!steps(0, nc, &dx, &dy)) continue;
        for (uint32_t r = v.resno0; r < v.resno1; ++r)
          for (int64_t y = ty0; y < ty1; y += dy - (y % dy))
            for (int64_t x = tx0; x < tx1; x += dx - (x % dx))
              for (uint32_t c = v.compno0; c < v.compno1; ++c) {
                if (r >= tile.comps[c].numres) continue;
                if (!precinct_at(c, r, x, y, &prec)) continue;
                for (uint32_t l = 0; l < v.layno1; ++l) add(l, r, c, prec);
              }
      } else if (v.prg == 3) {  // PCRL
        if (!steps(0, nc, &dx, &dy)) continue;
        for (int64_t y = ty0; y < ty1; y += dy - (y % dy))
          for (int64_t x = tx0; x < tx1; x += dx - (x % dx))
            for (uint32_t c = v.compno0; c < v.compno1; ++c) {
              uint32_t rmax = std::min(v.resno1, tile.comps[c].numres);
              for (uint32_t r = v.resno0; r < rmax; ++r) {
                if (!precinct_at(c, r, x, y, &prec)) continue;
                for (uint32_t l = 0; l < v.layno1; ++l) add(l, r, c, prec);
              }
            }
      } else {  // CPRL
        for (uint32_t c = v.compno0; c < v.compno1; ++c) {
          if (!steps(c, c + 1, &dx, &dy)) break;
          uint32_t rmax = std::min(v.resno1, tile.comps[c].numres);
          for (int64_t y = ty0; y < ty1; y += dy - (y % dy))
            for (int64_t x = tx0; x < tx1; x += dx - (x % dx))
              for (uint32_t r = v.resno0; r < rmax; ++r) {
                if (!precinct_at(c, r, x, y, &prec)) continue;
                for (uint32_t l = 0; l < v.layno1; ++l) add(l, r, c, prec);
              }
        }
      }
    }
    return out;
  }

  static void init_seg(Cblk& cb, uint32_t index, uint32_t cblksty, bool first) {
    if (cb.segs.size() <= index) cb.segs.resize(index + 1);
    Seg& s = cb.segs[index];
    s = Seg();
    if (cblksty & CBLK_TERMALL)
      s.maxpasses = 1;
    else if (cblksty & CBLK_LAZY)
      s.maxpasses = first ? 10
                    : (cb.segs[index - 1].maxpasses == 1 ||
                       cb.segs[index - 1].maxpasses == 10) ? 2 : 1;
    else
      s.maxpasses = 109;
  }

  void t2_decode(Tile& tile, Tcp& t) {
    const uint8_t* src = t.data.data();
    size_t max_len = t.data.size();
    size_t at = 0;
    for (const Packet& pk : packets(tile, t)) {
      size_t used = decode_packet(tile, t, pk, src + at, max_len - at);
      comps_[pk.compno].resno_decoded =
          std::max(pk.resno, comps_[pk.compno].resno_decoded);
      at += used;
    }
  }

  size_t decode_packet(Tile& tile, Tcp& t, const Packet& pk,
                       const uint8_t* src, size_t max_len) {
    TileComp& k = tile.comps[pk.compno];
    Resolution& res = k.res[pk.resno];
    const Tccp& tc = t.tccps[pk.compno];
    if (pk.layno == 0) {
      for (uint32_t b = 0; b < res.numbands; ++b) {
        Band& band = res.bands[b];
        if (band.empty()) continue;
        if (pk.precno >= band.precincts.size()) fail("invalid precinct");
        Precinct& pr = band.precincts[pk.precno];
        pr.incl.reset();
        pr.imsb.reset();
        for (auto& cb : pr.cblks) cb.numsegs = 0;
      }
    }
    const uint8_t* cur = src;
    if (t.csty & CSTY_SOP) {
      if (max_len >= 6 && cur[0] == 0xff && cur[1] == 0x91) cur += 6;
    }
    // the header: from PPM, PPT or the packet itself
    const uint8_t* hdr;
    size_t hdr_len;
    if (ppm_) {
      hdr = ppm_buf_.data() + ppm_pos_;
      hdr_len = ppm_buf_.size() - ppm_pos_;
    } else if (t.ppt) {
      hdr = t.ppt_buf.data() + t.ppt_pos;
      hdr_len = t.ppt_buf.size() - t.ppt_pos;
    } else {
      hdr = cur;
      hdr_len = size_t(src + max_len - cur);
    }
    Bio bio(hdr, hdr_len);
    bool present = bio.read(1);
    if (present) {
      for (uint32_t b = 0; b < res.numbands; ++b) {
        Band& band = res.bands[b];
        if (band.empty()) continue;
        Precinct& pr = band.precincts[pk.precno];
        for (uint32_t cn = 0; cn < pr.cw * pr.ch; ++cn) {
          Cblk& cb = pr.cblks[cn];
          uint32_t included = cb.numsegs == 0
                                  ? tgt_decode(bio, pr.incl, cn, int32_t(pk.layno + 1))
                                  : bio.read(1);
          if (!included) {
            cb.numnewpasses = 0;
            continue;
          }
          if (cb.numsegs == 0) {
            uint32_t i = 0;
            while (!tgt_decode(bio, pr.imsb, cn, int32_t(i))) ++i;
            cb.numbps = uint32_t(band.numbps) + 1 - i;
            cb.numlenbits = 3;
          }
          // number of passes
          uint32_t np;
          if (!bio.read(1))
            np = 1;
          else if (!bio.read(1))
            np = 2;
          else if ((np = bio.read(2)) != 3)
            np = 3 + np;
          else if ((np = bio.read(5)) != 31)
            np = 6 + np;
          else
            np = 37 + bio.read(7);
          cb.numnewpasses = np;
          uint32_t inc = 0;
          while (bio.read(1)) ++inc;
          cb.numlenbits += inc;
          uint32_t segno;
          if (cb.numsegs == 0) {
            segno = 0;
            init_seg(cb, 0, tc.cblksty, true);
          } else {
            segno = cb.numsegs - 1;
            if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
              ++segno;
              init_seg(cb, segno, tc.cblksty, false);
            }
          }
          int32_t n = int32_t(np);
          do {
            Seg& s = cb.segs[segno];
            s.numnewpasses = uint32_t(std::min<int64_t>(int64_t(s.maxpasses) - s.numpasses, n));
            uint32_t bits = cb.numlenbits;
            for (uint32_t v = s.numnewpasses; v > 1; v >>= 1) ++bits;
            if (bits > 32) fail("a code-block length of %u bits", bits);
            s.newlen = bio.read(bits);
            n -= int32_t(s.numnewpasses);
            if (n > 0) {
              ++segno;
              init_seg(cb, segno, tc.cblksty, false);
            }
          } while (n > 0);
        }
      }
    }
    bio.inalign();
    const uint8_t* hp = hdr + bio.numbytes();
    if (t.csty & CSTY_EPH) {
      size_t rest = hdr_len - size_t(hp - hdr);
      if (rest < 2 || hp[0] != 0xff || hp[1] != 0x92)
        fail("an EPH marker was expected");
      hp += 2;
    }
    size_t hlen = size_t(hp - hdr);
    if (ppm_)
      ppm_pos_ += hlen;
    else if (t.ppt)
      t.ppt_pos += hlen;
    else
      cur += hlen;
    if (!present) return size_t(cur - src);
    // the packet's body
    for (uint32_t b = 0; b < res.numbands; ++b) {
      Band& band = res.bands[b];
      if (band.empty()) continue;
      Precinct& pr = band.precincts[pk.precno];
      for (auto& cb : pr.cblks) {
        if (!cb.numnewpasses) continue;
        uint32_t si;
        if (cb.numsegs == 0) {
          si = 0;
          cb.numsegs = 1;
        } else {
          si = cb.numsegs - 1;
          if (cb.segs[si].numpasses == cb.segs[si].maxpasses) {
            ++si;
            ++cb.numsegs;
          }
        }
        do {
          Seg& s = cb.segs[si];
          if (s.newlen > size_t(src + max_len - cur))
            fail("a code-block segment runs past its tile's data");
          cb.data.insert(cb.data.end(), cur, cur + s.newlen);
          cur += s.newlen;
          s.len += s.newlen;
          s.numpasses += s.numnewpasses;
          cb.numnewpasses -= s.numnewpasses;
          s.real_num_passes = s.numpasses;
          if (cb.numnewpasses > 0) {
            ++si;
            ++cb.numsegs;
          }
        } while (cb.numnewpasses > 0);
      }
    }
    return size_t(cur - src);
  }

  // ----- tier 1 and dequantisation

  void t1_decode(Tile& tile, const Tcp& t) {
    T1 t1;
    for (size_t c = 0; c < tile.comps.size(); ++c) {
      TileComp& k = tile.comps[c];
      const Tccp& tc = t.tccps[c];
      int32_t tw = k.width();
      for (uint32_t r = 0; r < k.numres; ++r) {
        Resolution& res = k.res[r];
        for (uint32_t b = 0; b < res.numbands; ++b) {
          Band& band = res.bands[b];
          if (band.empty()) continue;
          for (auto& pr : band.precincts)
            for (auto& cb : pr.cblks) {
              if (cb.x1 <= cb.x0 || cb.y1 <= cb.y0) continue;
              if (tc.cblksty & CBLK_HT)
                fail("HTJ2K (Part 15) code-blocks");
              t1.decode(cb, int(band.bandno), tc.roishift, tc.cblksty);
              int32_t x = cb.x0 - band.x0, y = cb.y0 - band.y0;
              if (band.bandno & 1) x += k.res[r - 1].x1 - k.res[r - 1].x0;
              if (band.bandno & 2) y += k.res[r - 1].y1 - k.res[r - 1].y0;
              int32_t* dp = t1.data.data();
              size_t cnt = size_t(t1.w) * t1.h;
              if (tc.roishift) {
                if (tc.roishift >= 31) {
                  std::fill(dp, dp + cnt, 0);
                } else {
                  int32_t thresh = 1 << tc.roishift;
                  for (size_t i = 0; i < cnt; ++i) {
                    int32_t v = dp[i], mag = v < 0 ? -v : v;
                    if (mag >= thresh) {
                      mag >>= tc.roishift;
                      dp[i] = v < 0 ? -mag : mag;
                    }
                  }
                }
              }
              float step = 0.5f * band.stepsize;
              for (int j = 0; j < t1.h; ++j) {
                Sample* out = &k.data[size_t(y + j) * tw + x];
                const int32_t* in = dp + size_t(j) * t1.w;
                if (tc.qmfbid == 1)
                  for (int i = 0; i < t1.w; ++i) out[i].i = in[i] / 2;
                else
                  for (int i = 0; i < t1.w; ++i) out[i].f = float(in[i]) * step;
              }
            }
        }
      }
    }
  }

  // ----- inverse wavelet transforms (opj_dwt_decode / opj_dwt_decode_real)

  static void idwt53_1d(int32_t* a, int32_t* tmp, int sn, int dn, int cas) {
    int len = sn + dn;
    if (cas == 0) {
      if (len <= 1) return;
      auto L = [&](int i) { return a[std::clamp(i, 0, sn - 1)]; };
      int32_t* H = a + sn;
      auto Hc = [&](int i) { return H[std::clamp(i, 0, dn - 1)]; };
      std::vector<int32_t> l(sn);
      for (int i = 0; i < sn; ++i) l[i] = L(i) - ((Hc(i - 1) + Hc(i) + 2) >> 2);
      for (int i = 0; i < sn; ++i) tmp[2 * i] = l[i];
      for (int i = 0; i < dn; ++i)
        tmp[2 * i + 1] = int32_t(uint32_t(H[i]) + uint32_t((l[i] + l[std::min(i + 1, sn - 1)]) >> 1));
    } else {
      if (len == 1) {
        a[0] /= 2;
        return;
      }
      int32_t* H = a + sn;  // the high samples sit at even positions
      auto Hc = [&](int i) { return H[std::clamp(i, 0, dn - 1)]; };
      std::vector<int32_t> l(sn);
      for (int i = 0; i < sn; ++i) l[i] = a[i] - ((Hc(i) + Hc(i + 1) + 2) >> 2);
      for (int i = 0; i < sn; ++i) tmp[2 * i + 1] = l[i];
      for (int i = 0; i < dn; ++i)
        tmp[2 * i] = H[i] + ((l[std::clamp(i - 1, 0, sn - 1)] +
                              l[std::clamp(i, 0, sn - 1)]) >> 1);
    }
    memcpy(a, tmp, sizeof(int32_t) * size_t(len));
  }

  static void dwt53(TileComp& k, uint32_t numres) {
    if (numres <= 1 || k.res.empty()) return;
    int32_t w = k.width();
    std::vector<int32_t> line, tmp;
    int rw = k.res[0].x1 - k.res[0].x0, rh = k.res[0].y1 - k.res[0].y0;
    for (uint32_t r = 1; r < numres; ++r) {
      const Resolution& res = k.res[r];
      int hsn = rw, vsn = rh;
      rw = res.x1 - res.x0;
      rh = res.y1 - res.y0;
      int hdn = rw - hsn, vdn = rh - vsn;
      int hcas = res.x0 % 2, vcas = res.y0 % 2;
      line.resize(std::max(rw, rh));
      tmp.resize(std::max(rw, rh));
      for (int j = 0; j < rh; ++j) {
        Sample* row = &k.data[size_t(j) * w];
        for (int i = 0; i < rw; ++i) line[i] = row[i].i;
        idwt53_1d(line.data(), tmp.data(), hsn, hdn, hcas);
        for (int i = 0; i < rw; ++i) row[i].i = line[i];
      }
      for (int i = 0; i < rw; ++i) {
        for (int j = 0; j < rh; ++j) line[j] = k.data[size_t(j) * w + i].i;
        idwt53_1d(line.data(), tmp.data(), vsn, vdn, vcas);
        for (int j = 0; j < rh; ++j) k.data[size_t(j) * w + i].i = line[j];
      }
    }
  }

  static void step2(float* l, float* w, int end, int m, float c) {
    float* fl = l;
    float* fw = w;
    int imax = std::min(end, m);
    for (int i = 0; i < imax; ++i) {
      fw[-1] = fw[-1] + (fl[0] + fw[0]) * c;
      fl = fw;
      fw += 2;
    }
    if (m < end) {
      float c2 = c + c;
      fw[-1] = fw[-1] + fl[0] * c2;
    }
  }

  // opj_v8dwt_decode on one signal: `w` holds it interleaved
  static void idwt97_1d(float* w, int sn, int dn, int cas) {
    int a, b;
    if (cas == 0) {
      if (!(dn > 0 || sn > 1)) return;
      a = 0;
      b = 1;
    } else {
      if (!(sn > 0 || dn > 1)) return;
      a = 1;
      b = 0;
    }
    for (int i = 0; i < sn; ++i) w[a + 2 * i] = w[a + 2 * i] * DWT_K;
    for (int i = 0; i < dn; ++i) w[b + 2 * i] = w[b + 2 * i] * DWT_TWO_INVK;
    step2(w + b, w + a + 1, sn, std::min(sn, dn - a), -DWT_DELTA);
    step2(w + a, w + b + 1, dn, std::min(dn, sn - b), -DWT_GAMMA);
    step2(w + b, w + a + 1, sn, std::min(sn, dn - a), -DWT_BETA);
    step2(w + a, w + b + 1, dn, std::min(dn, sn - b), -DWT_ALPHA);
  }

  static void dwt97(TileComp& k, uint32_t numres) {
    if (numres <= 1 || k.res.empty()) return;
    int32_t w = k.width();
    std::vector<float> buf;
    int rw = k.res[0].x1 - k.res[0].x0, rh = k.res[0].y1 - k.res[0].y0;
    for (uint32_t r = 1; r < numres; ++r) {
      const Resolution& res = k.res[r];
      int hsn = rw, vsn = rh;
      rw = res.x1 - res.x0;
      rh = res.y1 - res.y0;
      int hdn = rw - hsn, vdn = rh - vsn;
      int hcas = res.x0 % 2, vcas = res.y0 % 2;
      buf.assign(size_t(std::max(rw, rh)) + 2, 0.0f);
      for (int j = 0; j < rh; ++j) {
        Sample* row = &k.data[size_t(j) * w];
        for (int i = 0; i < hsn; ++i) buf[hcas + 2 * i] = row[i].f;
        for (int i = 0; i < hdn; ++i) buf[1 - hcas + 2 * i] = row[hsn + i].f;
        idwt97_1d(buf.data(), hsn, hdn, hcas);
        for (int i = 0; i < rw; ++i) row[i].f = buf[i];
      }
      for (int i = 0; i < rw; ++i) {
        for (int j = 0; j < vsn; ++j)
          buf[vcas + 2 * j] = k.data[size_t(j) * w + i].f;
        for (int j = 0; j < vdn; ++j)
          buf[1 - vcas + 2 * j] = k.data[size_t(vsn + j) * w + i].f;
        idwt97_1d(buf.data(), vsn, vdn, vcas);
        for (int j = 0; j < rh; ++j) k.data[size_t(j) * w + i].f = buf[j];
      }
    }
  }

  // ----- components (opj_tcd_mct_decode, opj_tcd_dc_level_shift_decode)

  void mct(Tile& tile, const Tcp& t) {
    if (!t.mct) return;
    if (tile.comps.size() >= 3) {
      TileComp &c0 = tile.comps[0], &c1 = tile.comps[1], &c2 = tile.comps[2];
      size_t n = c0.data.size();
      if (c0.numres != c1.numres || c0.numres != c2.numres ||
          comps_[0].resno_decoded != comps_[1].resno_decoded ||
          comps_[0].resno_decoded != comps_[2].resno_decoded ||
          c1.data.size() != n || c2.data.size() != n)
        fail("the components of a tile differ in size: no MCT");
      if (t.tccps[0].qmfbid == 0) {
        for (size_t i = 0; i < n; ++i) {
          float y = c0.data[i].f, u = c1.data[i].f, v = c2.data[i].f;
          float r = y + (v * 1.402f);
          float g = y - (u * 0.34413f) - (v * (0.71414f));
          float b = y + (u * 1.772f);
          c0.data[i].f = r;
          c1.data[i].f = g;
          c2.data[i].f = b;
        }
      } else {
        for (size_t i = 0; i < n; ++i) {
          int32_t y = c0.data[i].i, u = c1.data[i].i, v = c2.data[i].i;
          int32_t g = y - ((u + v) >> 2);
          c0.data[i].i = v + g;
          c1.data[i].i = g;
          c2.data[i].i = u + g;
        }
      }
    }
  }

  void dc_shift(Tile& tile, const Tcp& t) {
    for (size_t c = 0; c < tile.comps.size(); ++c) {
      TileComp& k = tile.comps[c];
      if (k.res.empty()) continue;
      const Comp& cp = comps_[c];
      const Resolution& res = k.res[cp.resno_decoded];
      int32_t w = res.x1 - res.x0, h = res.y1 - res.y0, tw = k.width();
      int32_t lo, hi;
      if (cp.sgnd) {
        lo = -(1 << (cp.prec - 1));
        hi = (1 << (cp.prec - 1)) - 1;
      } else {
        lo = 0;
        hi = int32_t((1u << cp.prec) - 1);
      }
      int32_t shift = t.tccps[c].dc_shift;
      for (int32_t j = 0; j < h; ++j) {
        Sample* p = &k.data[size_t(j) * tw];
        if (t.tccps[c].qmfbid == 1) {
          for (int32_t i = 0; i < w; ++i)
            p[i].i = std::clamp(int32_t(uint32_t(p[i].i) + uint32_t(shift)), lo, hi);
        } else {
          for (int32_t i = 0; i < w; ++i) {
            float v = p[i].f;
            if (v > float(INT32_MAX)) {
              p[i].i = hi;
            } else if (v < float(INT32_MIN)) {
              p[i].i = lo;
            } else {
              int64_t r = int64_t(lrintf(v)) + shift;
              p[i].i = int32_t(std::clamp<int64_t>(r, lo, hi));
            }
          }
        }
      }
    }
  }

  // opj_j2k_update_image_data: the tile's decoded resolution into the image
  void update_image(Tile& tile) {
    for (size_t c = 0; c < comps_.size(); ++c) {
      OutComp& o = out_[c];
      TileComp& k = tile.comps[c];
      if (k.res.empty()) continue;
      const Resolution& res = k.res[comps_[c].resno_decoded];
      int64_t rx0 = res.x0, rx1 = res.x1, ry0 = res.y0, ry1 = res.y1;
      int64_t wsrc = rx1 - rx0, hsrc = ry1 - ry0;
      int64_t dx0 = o.x0, dy0 = o.y0, dx1 = dx0 + o.w, dy1 = dy0 + o.h;
      int64_t sx, ox0, wd, sy, oy0, hd;
      if (dx0 < rx0) {
        sx = rx0 - dx0;
        ox0 = 0;
        wd = dx1 >= rx1 ? wsrc : dx1 - rx0;
      } else {
        sx = 0;
        ox0 = dx0 - rx0;
        wd = dx1 >= rx1 ? wsrc - ox0 : o.w;
      }
      if (dy0 < ry0) {
        sy = ry0 - dy0;
        oy0 = 0;
        hd = dy1 >= ry1 ? hsrc : dy1 - ry0;
      } else {
        sy = 0;
        oy0 = dy0 - ry0;
        hd = dy1 >= ry1 ? hsrc - oy0 : o.h;
      }
      if (wd <= 0 || hd <= 0) continue;
      int64_t stride = k.width();
      if (!o.has_data) {
        o.data.assign(size_t(o.w) * o.h, 0);
        o.has_data = true;
      }
      for (int64_t j = 0; j < hd; ++j)
        for (int64_t i = 0; i < wd; ++i)
          o.data[size_t((sy + j) * o.w + sx + i)] =
              k.data[size_t((oy0 + j) * stride + ox0 + i)].i;
    }
  }

  // ----- JP2 post-processing (opj_jp2_apply_color_postprocessing)

  void jp2_postprocess(Result& r) {
    Color& c = color_;
    auto& comps = r.comps;
    uint32_t nc = uint32_t(comps.size());
    // opj_jp2_check_color
    if (c.has_cdef) {
      uint32_t nch = (c.has_pclr && c.has_cmap) ? c.nr_channels : nc;
      for (size_t i = 0; i < c.cn.size(); ++i) {
        if (c.cn[i] >= nch) fail("JP2: 'cdef' names channel %u of %u", c.cn[i], nch);
        if (c.asoc[i] == 65535) continue;
        if (c.asoc[i] > 0 && c.asoc[i] - 1 >= nch)
          fail("JP2: 'cdef' associates channel %u of %u", c.asoc[i] - 1, nch);
      }
      for (uint32_t k = nch; k > 0; --k)
        if (std::find(c.cn.begin(), c.cn.end(), k - 1) == c.cn.end())
          fail("JP2: 'cdef' leaves out channel %u", k - 1);
    }
    if (c.has_pclr && c.has_cmap) {
      uint32_t nch = c.nr_channels;
      bool sane = true;
      for (uint32_t i = 0; i < nch; ++i)
        if (c.cmp[i] >= nc) sane = false;
      std::vector<bool> used(nch, false);
      for (uint32_t i = 0; i < nch; ++i) {
        uint32_t mt = c.mtyp[i], pc = c.pcol[i];
        if (mt != 0 && mt != 1)
          sane = false;
        else if (pc >= nch)
          sane = false;
        else if (used[pc] && mt == 1)
          sane = false;
        else if (mt == 0 && pc != 0)
          sane = false;
        else if (mt == 1 && pc != i)
          sane = false;
        else
          used[pc] = true;
      }
      for (uint32_t i = 0; i < nch; ++i)
        if (!used[i] && c.mtyp[i] != 0) sane = false;
      if (sane && nc == 1) {
        bool all = true;
        for (uint32_t i = 0; i < nch; ++i) all = all && used[i];
        if (!all)
          for (uint32_t i = 0; i < nch; ++i) {
            c.mtyp[i] = 1;
            c.pcol[i] = i;
          }
      }
      if (!sane) fail("JP2: 'cmap' does not map the palette's columns");
    }
    switch (c.enumcs) {
      case 16: r.color_space = 1; break;  // sRGB
      case 17: r.color_space = 2; break;  // greyscale
      case 18: r.color_space = 3; break;  // sYCC
      case 24: r.color_space = 4; break;  // e-YCC
      case 12: r.color_space = 5; break;  // CMYK
      default: r.color_space = -1;        // unknown
    }
    if (c.has_pclr && c.has_cmap) {
      uint32_t nch = c.nr_channels;
      for (uint32_t i = 0; i < nch; ++i)
        if (!comps[c.cmp[i]].has_data) fail("JP2: a palette component without data");
      std::vector<OutComp> nw(nch);
      uint32_t top = c.nr_entries - 1;
      for (uint32_t i = 0; i < nch; ++i) {
        const OutComp& src = comps[c.cmp[i]];
        uint32_t at = c.mtyp[i] == 0 ? i : c.pcol[i];
        nw[at] = src;
        nw[at].data.assign(size_t(src.w) * src.h, 0);
      }
      for (uint32_t i = 0; i < nch; ++i) {
        const OutComp& src = comps[c.cmp[i]];
        size_t mx = size_t(nw[i].w) * nw[i].h;
        if (c.mtyp[i] == 0) {
          for (size_t j = 0; j < mx; ++j) nw[i].data[j] = src.data[j];
        } else {
          uint32_t pc = c.pcol[i];
          for (size_t j = 0; j < mx; ++j) {
            int32_t k = src.data[j];
            uint32_t idx = k < 0 ? 0 : uint32_t(k) > top ? top : uint32_t(k);
            nw[pc].data[j] = int32_t(c.entries[idx * nch + pc]);
          }
        }
      }
      comps = std::move(nw);
    }
    if (c.has_cdef) {
      uint32_t n = uint32_t(c.cn.size());
      std::vector<uint32_t> cn = c.cn;
      for (uint32_t i = 0; i < n; ++i) {
        // opj_jp2_apply_cdef: a colour channel moves to its association
        // (the alpha flags it sets cv2 does not read)
        uint32_t asoc = c.asoc[i], k = cn[i];
        if (k >= comps.size() || asoc == 0 || asoc == 65535) continue;
        uint32_t acn = asoc - 1;
        if (acn >= comps.size()) continue;
        if (k != acn && c.typ[i] == 0) {
          std::swap(comps[k], comps[acn]);
          for (uint32_t j = i + 1; j < n; ++j) {
            if (cn[j] == k)
              cn[j] = acn;
            else if (cn[j] == acn)
              cn[j] = k;
          }
        }
      }
    }
  }
};

int report(const Failure& f, char* err, int64_t errlen) {
  if (err && errlen > 0) {
    strncpy(err, f.msg.c_str(), size_t(errlen) - 1);
    err[errlen - 1] = 0;
  }
  return -1;
}

}  // namespace

extern "C" {

int j2k_header(const uint8_t* buf, int64_t len, int32_t jp2, int32_t* info,
               char* err, int64_t errlen) {
  try {
    Decoder d(buf, size_t(len));
    d.read_header(jp2 != 0);
    d.info(info);
    return 0;
  } catch (const Failure& f) {
    return report(f, err, errlen);
  } catch (const std::exception& e) {
    return report(Failure{e.what()}, err, errlen);
  }
}

int j2k_decode(const uint8_t* buf, int64_t len, int32_t jp2, void** handle,
               char* err, int64_t errlen) {
  *handle = nullptr;
  try {
    Decoder d(buf, size_t(len));
    d.read_header(jp2 != 0);
    *handle = new Result(d.decode());
    return 0;
  } catch (const Failure& f) {
    return report(f, err, errlen);
  } catch (const std::exception& e) {
    return report(Failure{e.what()}, err, errlen);
  }
}

int j2k_result(void* handle, int32_t* meta, int64_t n, int32_t** data,
               char* err, int64_t errlen) {
  const Result* r = static_cast<const Result*>(handle);
  meta[0] = r->color_space;
  meta[1] = int32_t(r->comps.size());
  for (int64_t c = 0; c < n && c < int64_t(r->comps.size()); ++c) {
    const OutComp& o = r->comps[size_t(c)];
    int32_t* m = meta + 2 + 7 * c;
    m[0] = int32_t(o.w); m[1] = int32_t(o.h); m[2] = int32_t(o.dx);
    m[3] = int32_t(o.dy); m[4] = int32_t(o.x0); m[5] = int32_t(o.y0);
    m[6] = o.has_data;
    if (data && data[c]) {
      if (o.data.size() != size_t(o.w) * o.h)
        return report(Failure{"a component's data does not fill it"}, err, errlen);
      memcpy(data[c], o.data.data(), o.data.size() * sizeof(int32_t));
    }
  }
  return 0;
}

void j2k_free(void* handle) { delete static_cast<Result*>(handle); }

}  // extern "C"
