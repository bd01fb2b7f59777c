"""TIFF read as cv2 5.0 reads it, through the libtiff 4.7.1 it bundles,
without cv2.

cv2 reads a TIFF one of two ways (imgcodecs/src/grfmt_tiff.cpp):

- 8-bit output (every colour and gray read, and the unchanged read of 1-,
  4- and 8-bit samples and of the photometrics past RGB): libtiff's RGBA
  reader (tif_getimage.c), strip by strip (`TIFFReadRGBAStrip`) or tile
  by tile (`TIFFReadRGBATile`), then RGBA to BGR(A) or to OpenCV's 14-bit
  gray. `_rgba` does what the reader's "put" routines do: MinIsWhite /
  MinIsBlack through libtiff's grey maps (1 bit to 0 / 255, 16 bits to the
  high byte), palettes of 1, 4 and 8 bits (a 16-bit colour map to its high
  byte), RGB with associated or unassociated alpha (premultiplied through
  its UaToAa table, 16 bits rounded (v + 128) // 257), separated CMYK
  (r = (255 - k) (255 - c) / 255), YCbCr through TIFFYCbCrToRGBInit's
  float tables at every subsampling libtiff enumerates, CIELab through
  TIFFCIELab16ToXYZ / TIFFXYZToRGB in float32, planar samples as
  gtStripSeparate reads them. A strip or tile whose data libtiff cannot
  decode whole keeps what the codec wrote (the rest zero, no predictor),
  as the reader goes on past it.
- The unchanged read of 16-bit and float samples: `TIFFReadEncodedStrip`
  / `Tile` into cv2's buffer, samples as stored; a decode error gives
  None. For planar samples cv2 asks for the first plane's strips as if
  they held every sample, and the rest of its buffer is memory it never
  wrote: the port refuses that read.

The strips and tiles are decoded as libtiff decodes them: none, LZW (old-
style LSB-first codes too, picked once by the first strip decoded),
Deflate, PackBits, CCITT RLE / Group 3 / Group 4 (native/image_native.cpp)
and JPEG (native/jpeg_native.cpp: each strip's stream with the JPEGTables
stream spliced in, read as libtiff's source manager feeds it, YCbCr
converted to RGB as JPEGCOLORMODE_RGB asks and other photometrics left as
they are); FillOrder 2 reversed before (the CCITT decoders read it
themselves), and predictor 2 or 3 (the floating-point byte planes,
most significant first in either byte order) applied after, for LZW and
Deflate. Classic TIFF and BigTIFF, either byte order. libtiff's repairs
and limits are kept where cv2's pixels show them: the directory's
checks (a vital tag that does not read fails it; the strip arrays read
to the image's strip count; cv2's image and tile size limits), byte
counts estimated where they look wrong or are missing, a single
uncompressed strip chopped into ~8 KiB strips, a 4 x 4 YCbCr strip read short by a rounded-down scanline size,
clipped tiles whose gray rows start short (put16bitbwtile's and
putgreytile's skew), and cv2.imdecode's unmapped raw buffer, which grows
in 1 KiB steps and refuses an uncompressed tile of another size.

The Orientation tag applies in every read; `cv2.imread` gives None where
it transposes (5-8) a picture that is not square, `cv2.imdecode` not.
Where libtiff mirrors a tiled image it mirrors each tile in place, so the
tile columns come in reverse order; `read` does the same.

What cv2 gives None for raises ValueError naming the file and saying so
(LZMA, Zstd and WebP strips among it: cv2's libtiff has no such codec).
What the port does not read raises ValueError naming the tag or the
reason (ROADMAP F2): LogLuv, old-style JPEG, a damaged CCITT strip, an
uncompressed tile of another byte count than its size, a JPEG strip that
libjpeg aborts.
"""
from __future__ import annotations

import ctypes
import functools
import struct
import zlib

import numpy as np

from spinnerf_tpu_torch.data import jpeg
from spinnerf_tpu_torch.native import build as _native

_ERR_LEN = 512
_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h",
          9: "i", 10: "ii", 11: "f", 12: "d", 13: "I", 16: "Q", 17: "q",
          18: "Q"}
_COMPRESSION = {1: "none", 2: "CCITT RLE", 3: "CCITT Group 3 fax",
                4: "CCITT Group 4 fax", 5: "LZW", 7: "JPEG", 8: "Deflate",
                32946: "Deflate", 32773: "PackBits"}
# codecs libtiff knows but cv2 5.0's build leaves out (TIFFRGBAImageOK
# and every strip read fail: cv2 gives None)
_NO_CODEC = {34661: "JBIG", 34887: "LERC", 34925: "LZMA", 50000: "Zstd",
             50001: "WebP", 50002: "JPEG XL"}
# codecs cv2's libtiff has and the port does not yet (ROADMAP F2)
_NOT_YET = {6: "old-style JPEG", 32766: "NeXT", 32771: "CCITT RLEW",
            32809: "ThunderScan", 32909: "PixarLog", 34676: "SGI Log",
            34677: "SGI Log24"}
_PHOTOMETRIC = {0: "MinIsWhite", 1: "MinIsBlack", 2: "RGB", 3: "palette",
                4: "mask", 5: "separated", 6: "YCbCr", 8: "CIELab",
                9: "ICCLab", 10: "ITULab", 32844: "LogL", 32845: "LogLuv"}
# the colour channels each photometric has (_TIFFGetMaxColorChannels)
_COLOR_CHANNELS = {0: 1, 1: 1, 3: 1, 4: 1, 32844: 1, 2: 3, 6: 3, 8: 3,
                   9: 3, 10: 3, 32845: 3, 5: 4}


@functools.cache
def _lib():
    """native/image_native.cpp's LZW, PackBits and CCITT decoders and
    native/jpeg_native.cpp's TIFF entries, typed."""
    img, jpg = _native.load("image_native"), _native.load("jpeg_native")
    vp, i64, i32, buf = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                         ctypes.c_char_p)
    for lib, fn, args in (
            (img, "im_lzw_decode", [buf, i64, i32, vp, i64, vp, vp, i64]),
            (img, "im_packbits_decode", [buf, i64, vp, i64, vp, vp, i64]),
            (img, "im_fax_decode", [buf, i64, i32, i32, i32, i32, i32, vp,
                                    i64, vp, vp, i64]),
            (jpg, "jd_tiff_header", [buf, i64, vp, vp, vp, i64]),
            (jpg, "jd_tiff_decode", [buf, i64, i32, vp, i64, vp, i64])):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = args
    return img, jpg


class _Failed(Exception):
    """A strip or tile libtiff cannot read: TIFFReadRGBA* gives 0, cv2 None."""


def _call(fn, *args):
    err = ctypes.create_string_buffer(_ERR_LEN)
    if fn(*args, ctypes.addressof(err), _ERR_LEN):
        raise _Failed(err.value.decode(errors="replace"))


# tags TIFFReadDirectory fails on where their values do not read (past
# the file's end, of another type, out of range); another such tag is
# dropped with a warning
_VITAL = (256, 257, 258, 259, 273, 277, 278, 279, 284, 322, 323, 324, 325,
          338, 339)
# StripOffsets, StripByteCounts, TileOffsets, TileByteCounts
_STRIPS = (273, 279, 324, 325)
# tags libtiff reads as unsigned integers (TIFFReadDirEntryShort / Long /
# Long8 refuse other types and negative values)
_INTEGER = (256, 257, 258, 259, 262, 266, 273, 274, 277, 278, 279, 284, 292,
            317, 320, 322, 323, 324, 325, 332, 338, 339, 347, 530)


def _ifd(data: bytes, name):
    """Byte order, the first IFD's tags (tag -> tuple of values; RATIONALs
    as float32 quotients, as libtiff reads them) and the bytes the header,
    the IFD and its out-of-line values take (EstimateStripByteCounts'
    `space`)."""
    if len(data) < 8:
        raise ValueError(f"{name}: TIFF header cut short")
    order = {b"II": "<", b"MM": ">"}[data[:2]]
    (magic,) = struct.unpack(order + "H", data[2:4])
    big = magic == 43
    if big:
        if len(data) < 16:
            raise ValueError(f"{name}: BigTIFF header cut short")
        (offset,) = struct.unpack(order + "Q", data[8:16])
        count_fmt, entry, word = "Q", 20, "Q"
    else:
        (offset,) = struct.unpack(order + "I", data[4:8])
        count_fmt, entry, word = "H", 12, "I"
    head = struct.calcsize(order + count_fmt)
    inline = 8 if big else 4
    if offset + head > len(data):
        raise ValueError(f"{name}: TIFF directory out of range")
    (n,) = struct.unpack(order + count_fmt, data[offset:offset + head])
    tags = {}
    space = (16 if big else 8) + head + entry * n + inline
    for k in range(n):
        e = offset + head + entry * k
        if e + entry > len(data):
            raise ValueError(f"{name}: TIFF directory cut short")
        tag, typ, count = struct.unpack(order + "HH" + word,
                                        data[e:e + 4 + inline])
        fmt = _TYPES.get(typ)
        if tag in _STRIPS and fmt is not None and typ not in (5, 10, 11, 12):
            # TIFFFetchStripThing reads no more values than the image has
            # strips (known later): keep those that lie inside the file
            width = struct.calcsize(order + fmt)
            at = e + 4 + inline
            if count * width > inline:
                (at,) = struct.unpack(order + word, data[at:at + inline])
                space += count * width
            have = max(min(count, (len(data) - at) // width), 0)
            tags[tag] = struct.unpack(order + fmt * have,
                                      data[at:at + have * width])
            tags[tag, "count"] = count
            continue
        if fmt is None or count > len(data):
            if tag in _VITAL:
                raise ValueError(f"{name}: cv2 gives None for a TIFF whose "
                                 f"tag {tag} has type {typ} and count "
                                 f"{count}")
            continue
        size = struct.calcsize(order + fmt) * count
        at = e + 4 + inline
        if size > inline:
            (at,) = struct.unpack(order + word, data[at:at + inline])
            space += size
        raw = data[at:at + size]
        if len(raw) < size:
            if tag in _VITAL:
                raise ValueError(f"{name}: cv2 gives None for a TIFF whose "
                                 f"tag {tag} lies past the file's end")
            continue
        vals = struct.unpack(order + fmt * count, raw)
        if tag in _INTEGER and (typ in (5, 10, 11, 12) or any(
                v < 0 for v in vals)):
            if tag in _VITAL:
                raise ValueError(f"{name}: cv2 gives None for a TIFF whose "
                                 f"tag {tag} has values of type {typ} "
                                 f"{vals[:4]}")
            continue
        if typ in (5, 10):
            vals = tuple(float(np.float32(a) / np.float32(b)) if b else 0.0
                         for a, b in zip(vals[::2], vals[1::2]))
        tags[tag] = vals
    return order, tags, space


# -------------------------------------------------------------- decoding --

_REVERSED = np.array([int(f"{v:08b}"[::-1], 2) for v in range(256)],
                     np.uint8)


def _splice(tables: bytes | None, stream: bytes) -> bytes:
    """A JPEG strip's stream with the JPEGTables stream's segments put
    after its SOI: what libjpeg sees reading the tables, then the strip."""
    if not tables or tables[:2] != b"\xff\xd8" or stream[:2] != b"\xff\xd8":
        return stream
    body = tables[2:-2] if tables[-2:] == b"\xff\xd9" else tables[2:]
    return stream[:2] + body + stream[2:]


class _Tiff:
    """The first image's fields (libtiff's defaults filled in) and its
    strips or tiles, each decoded as libtiff decodes it."""

    def __init__(self, data: bytes, name, mapped=False):
        # cv2.imread's libtiff maps the file; cv2.imdecode's reads it
        # through OpenCV's callbacks, unmapped
        self.data, self.name, self.mapped = data, name, mapped
        self.lzw_compat = None
        self.channels = 4   # what the RGBA reader's blocks keep: 3 or 4
        self.order, self.tags, self.space = _ifd(data, name)
        self.w, self.h = self.tag(256), self.tag(257)
        if not self.w or not self.h:
            raise ValueError(f"{name}: TIFF without ImageWidth / "
                             f"ImageLength")
        # cv2's validateInputImageSize
        if not (self.w <= 1 << 20 and self.h <= 1 << 20
                and self.w * self.h <= 1 << 30):
            raise self.none(f"of {self.w} x {self.h}, past the image size "
                            f"cv2 reads")
        self.spp = self.tag(277, 1)
        if not 1 <= self.spp <= 4:   # readData's CV_CheckLE(ncn, 4)
            raise self.none(f"with SamplesPerPixel (277) {self.spp}")
        bps = self.tags.get(258, (1,))
        if len(set(bps[:self.spp])) > 1:
            raise ValueError(f"{name}: cv2 gives None for a TIFF whose "
                             f"samples differ in BitsPerSample (258) {bps}")
        self.bits = bps[0]
        self.compression = self.tag(259, 1)
        self.photometric = self.tag(262)
        self.planar = self.tag(284, 1)
        if self.planar not in (1, 2):
            raise self.none(f"with PlanarConfiguration (284) {self.planar}")
        self.predictor = self.tag(317, 1)
        self.sample_format = self.tag(339, 1)
        self.orientation = self.tag(274, 1)
        self.fill_order = self.tag(266, 1)
        self.tiled = 322 in self.tags
        # libtiff defines the samples past the colour channels as extra
        # samples (unspecified) where the ExtraSamples tag leaves them out
        extras = list(self.tags.get(338, ()))
        if len(extras) > self.spp or any(e > 2 for e in extras):
            # setExtraSamples refuses them, and the directory with them
            raise self.none(f"with ExtraSamples (338) {tuple(extras)}")
        colors = _COLOR_CHANNELS.get(self.photometric, 0)
        if colors and self.spp - len(extras) > colors:
            extras += [0] * (self.spp - colors - len(extras))
        self.extras = extras
        if self.tiled:
            self.bw, self.bh = self.tag(322), self.tag(323)
        else:
            rps = self.tag(278, 2 ** 32 - 1)
            if rps == 0 or (1 << 24 < rps < 2 ** 32 - 1):
                # libtiff refuses 0; cv2 asserts a strip of at most 2^24
                raise self.none(f"with RowsPerStrip (278) {rps}")
            self.bw, self.bh = self.w, min(rps, self.h)
        if not self.bw or not self.bh:
            raise self.none("with a tile of no size")
        self.ycbcr = self.photometric == 6 and self.compression != 7
        ss = self.tags.get(530, ())
        self.subsampling = tuple(ss[:2]) if len(ss) >= 2 else (2, 2)
        n = ((self.spp if self.planar == 2 else 1) * -(-self.h // self.bh)
             * (-(-self.w // self.bw) if self.tiled else 1))
        self.offsets = self._strip_thing(324 if self.tiled else 273, n)
        if self.offsets is None:
            raise self.none("without StripOffsets / TileOffsets")
        self.counts = self._strip_thing(325 if self.tiled else 279, n)
        if self.counts is None:
            # TIFFReadDirectory estimates them where one strip (or one a
            # plane) needs them, and fails otherwise
            if n != (self.spp if self.planar == 2 else 1):
                raise self.none("without StripByteCounts / TileByteCounts")
            self.counts = self._estimate_counts(n)
        if self.photometric == 6 and self.compression == 7 and 530 not in \
                self.tags and self.planar == 1 and self.spp == 3:
            self.subsampling = self._jpeg_sampling()   # JPEGFixupTags...
        if not (self.bw <= 1 << 24 and self.bh <= 1 << 24):
            raise self.none(f"whose tiles of {self.bw} x {self.bh} pass "
                            f"cv2's limit of 2^24")
        if not self.tiled:
            self._fix_strips()
        # a strip or tile of the first plane with no bytes fails TIFFFillStrip
        # / Tile ("Invalid strip byte count"): cv2 gives None, whatever the
        # read (found before the image is allocated)
        first = -(-self.h // self.bh) * (-(-self.w // self.bw)
                                         if self.tiled else 1)
        if 0 in self.counts[:first]:
            raise self.none(f"whose strip or tile "
                            f"{self.counts.index(0)} has no bytes")

    def _strip_thing(self, tag, n):
        """TIFFFetchStripThing: `n` values of `tag`, the ones it leaves
        out zero (None without the tag; ValueError where the values it
        reads lie past the file's end)."""
        vals = self.tags.get(tag)
        if vals is None:
            return None
        if len(vals) < min(self.tags[tag, "count"], n):
            raise self.none(f"whose tag {tag} lies past the file's end")
        return list(vals[:n]) + [0] * (n - len(vals))

    def _estimate_counts(self, n):
        """EstimateStripByteCounts: compressed, the file's bytes past its
        header and directory (a plane's share; the last strip cut at the
        file's end); tiles, the tile's size; uncompressed strips, the
        scanline times h // n."""
        size = len(self.data)
        if self.compression != 1:
            space = max(size - self.space, 0)
            if self.planar == 2:
                space //= self.spp
            counts = [space] * n
            if self.offsets[-1] + space > size:
                counts[-1] = max(size - self.offsets[-1], 0)
            return counts
        if self.tiled:
            return [self.row_bytes(self.spp if self.planar == 1 else 1)
                    * self.bh] * n
        return [self.scanline() * (self.h // max(n, 1))] * n

    def scanline(self):
        """TIFFScanlineSize64: a row's bytes (packed YCbCr: a sampling
        row's bytes over the vertical subsampling, rounded down)."""
        if self.ycbcr and self.planar == 1 and self.spp == 3:
            hs, vs = self.subsampling
            return (-(-self.w // hs) * (hs * vs + 2) * self.bits // 8) // vs
        return -(-self.w * (self.spp if self.planar == 1 else 1)
                 * self.bits // 8)

    def _fix_strips(self):
        """TIFFReadDirectory's repairs of StripByteCounts: estimated where
        they look wrong (EstimateStripByteCounts), and a single
        uncompressed strip chopped into strips of about 8 KiB
        (ChopUpSingleUncompressedStrip), as cv2 then reads them."""
        n, counts, offsets = len(self.offsets), self.counts, self.offsets
        size, none = len(self.data), self.compression == 1
        bad = False
        if n == 1 and offsets[0]:   # ByteCountLooksBad
            bad = counts[0] == 0 or none and (
                offsets[0] <= size and counts[0] > size - offsets[0]
                or counts[0] < self.scanline() * self.h)
        elif (self.planar == 1 and n > 2 and none and len(counts) > 1
              and counts[0] != counts[1] and counts[0] and counts[1]):
            bad = True
        if bad:
            self.counts = counts = self._estimate_counts(n)
        if not (n == 1 and none and self.planar == 1):
            return
        block = self.subsampling[1] if self.ycbcr else 1
        block_bytes = self.scanline() * block
        if block_bytes <= 0:
            return
        if block_bytes > 8192:
            strip_bytes, rows = block_bytes, block
        else:
            strip_bytes = 8192 // block_bytes * block_bytes
            rows = 8192 // block_bytes * block
        if rows >= self.bh or rows == 0:
            return
        left, at = counts[0], offsets[0]
        self.offsets, self.counts = [], []
        for _ in range(-(-self.h // rows)):
            take = min(strip_bytes, left)
            self.offsets.append(at if take else 0)
            self.counts.append(take)
            at += take
            left -= take
        self.bh = rows

    def tag(self, t, default=None):
        v = self.tags.get(t)
        return default if not v else v[0]

    def refuse(self, why):
        return ValueError(f"{self.name}: TIFF {why} is not read by the port "
                          f"(ROADMAP F2)")

    def none(self, why):
        return ValueError(f"{self.name}: cv2 gives None for a TIFF {why}")

    # -- blocks --

    def block_rows(self, k):
        """Rows of strip / tile `k` (of a plane) that libtiff decodes."""
        if self.tiled:
            return self.bh
        per = -(-self.h // self.bh)
        return min(self.bh, self.h - (k % per) * self.bh)

    def row_bytes(self, samples):
        return -(-self.bw * samples * self.bits // 8)

    def block_bytes(self, k, samples):
        rows = self.block_rows(k)
        if self.ycbcr and self.planar == 1:
            hs, vs = self.subsampling
            row = -(-self.bw // hs) * (hs * vs + 2)
            size = row * -(-rows // vs)
            if not self.tiled:
                # gtStripContig asks for its rows (rounded up to vs) times
                # TIFFScanlineSize, a sampling row's bytes / vs rounded down
                size = min(size, -(-rows // vs) * vs * (row // vs))
            return size
        return rows * self.row_bytes(samples)

    def raw(self, k):
        if k >= len(self.offsets) or k >= len(self.counts):
            raise _Failed("strip or tile missing")
        off, cnt = self.offsets[k], self.counts[k]
        if cnt == 0 or off + cnt > len(self.data):
            raise _Failed(f"Read error on strip or tile {k}")
        raw = self.data[off:off + cnt]
        if self.fill_order == 2 and self.compression not in (2, 3, 4, 7):
            raw = _REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
        return raw

    def read_raw(self, k, samples, partial=False):
        """TIFFReadEncodedStrip / Tile's shortcut for uncompressed data in
        a file it has not mapped: the strip's bytes read from its offset,
        whatever its byte count says. Cut short by the file's end it
        fails, or with `partial` gives (the bytes read, then zeros; False)."""
        expected = self.block_bytes(k, samples)
        off = self.offsets[k] if k < len(self.offsets) else 0
        raw = self.data[off:off + expected]
        if len(raw) < expected:
            if not partial:
                raise _Failed(f"Read error on strip or tile {k}")
            buf = np.zeros(expected, np.uint8)
            buf[:len(raw)] = np.frombuffer(raw, np.uint8)
            return buf, False
        if self.fill_order == 2:
            raw = _REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
        buf = np.frombuffer(raw, np.uint8).copy()
        if self.bits in (16, 32, 64) and self.order == ">":
            size = self.bits // 8
            buf = buf.view(f">u{size}").astype(f"<u{size}").view(np.uint8)
        return (buf, True) if partial else buf

    def decode(self, k, samples):
        """Strip or tile `k`'s bytes as TIFFReadEncodedStrip / Tile leaves
        them, and whether the decode succeeded (predictor applied, samples
        in the host's order) or failed (what the codec wrote, then zeros).
        Raises _Failed where libtiff cannot start the strip."""
        expected = self.block_bytes(k, samples)
        raw = self.raw(k)
        c = self.compression
        if c == 1 and self.tiled and len(raw) != expected:
            raise self.refuse(f"uncompressed tile {k} of {len(raw)} bytes, "
                              f"not its {expected} (libtiff reads some "
                              f"such tiles whole, some in part and refuses "
                              f"others)")
        if c == 1:
            ok = len(raw) >= expected
            out = raw[:expected] if ok else b""
        elif c in (8, 32946):
            out, ok = _inflate(raw, expected)
        elif c in (2, 3, 4):
            if self.bits != 1 or samples != 1:
                raise _Failed("Bits/sample must be 1 for Group 3/4 decoding")
            buf = np.zeros(expected, np.uint8)
            failed = np.zeros(2, np.int64)
            _call(_lib()[0].im_fax_decode, raw, len(raw), c,
                  self.tag(292, 0) & 1, self.fill_order == 2, self.bw,
                  self.block_rows(k), buf.ctypes.data, expected,
                  failed.ctypes.data)
            if failed[1]:
                # libtiff recovers row by row (and a Group 3 decoder carries
                # its state into the next strip): not followed by the port
                raise self.refuse(f"damaged {_COMPRESSION[c]} strip or tile "
                                  f"{k} (a bad code, a row cut short or the "
                                  f"data's end)")
            out, ok = buf.tobytes(), not failed[0]
        elif c in (5, 32773):
            lib = _lib()[0]
            buf = np.zeros(expected, np.uint8)
            written = np.zeros(2, np.int64)
            if c == 5:
                if self.lzw_compat is None:
                    # LZWPreDecode picks old-style codes once, by the first
                    # strip it decodes (0x00, then an odd byte)
                    self.lzw_compat = (len(raw) >= 2 and raw[0] == 0
                                       and raw[1] & 1)
                _call(lib.im_lzw_decode, raw, len(raw), int(self.lzw_compat),
                      buf.ctypes.data, expected, written.ctypes.data)
            else:
                _call(lib.im_packbits_decode, raw, len(raw), buf.ctypes.data,
                      expected, written.ctypes.data)
            out, ok = buf[:int(written[0])].tobytes(), not written[1]
        else:   # a scheme libtiff does not know: its decode fails
            out, ok = b"", False
        if ok:   # read-only where the codec gave the whole strip
            buf = np.frombuffer(out, np.uint8, count=expected)
        else:
            buf = np.zeros(expected, np.uint8)
            buf[:len(out)] = np.frombuffer(out, np.uint8)[:expected]
            return buf, ok
        if self.predictor != 1 and c in (5, 8, 32946):
            return self.predict(buf, k, samples), ok
        if self.bits in (16, 32, 64) and self.order == ">":   # postdecode
            size = self.bits // 8
            buf = buf.view(f">u{size}").astype(f"<u{size}").view(np.uint8)
        return buf, ok

    def predict(self, buf, k, samples):
        p = self.predictor
        rows = self.block_rows(k)
        stride = samples
        if p == 2:
            size = self.bits // 8
            if size not in (1, 2, 4) or self.bits % 8:
                raise _Failed(f"horizontal differencing with {self.bits}-bit "
                              f"samples")
            v = buf.view(np.dtype(self.order + f"u{size}")).reshape(
                rows, self.bw, stride)
            return np.cumsum(v, axis=1, dtype=v.dtype).astype(
                v.dtype.newbyteorder("=")).view(np.uint8).reshape(-1)
        if p == 3:
            size = self.bits // 8
            if self.sample_format != 3 or self.bits not in (16, 32, 64):
                raise _Failed("the floating-point predictor on other samples")
            row = buf.reshape(rows, -1)
            acc = np.empty_like(row)
            for j in range(stride):   # fpAcc: byte sums with stride spp
                acc[:, j::stride] = np.cumsum(row[:, j::stride], axis=1,
                                              dtype=np.uint8)
            planes = acc.reshape(rows, size, -1)   # most significant first
            return np.ascontiguousarray(planes[:, ::-1].transpose(0, 2, 1)
                                        ).reshape(-1)
        raise _Failed(f"Predictor tag (317) value {p}")

    def _jpeg_sampling(self):
        try:
            stream = self.raw(0)
            hwc, samp = np.zeros(3, np.int32), np.zeros(9, np.int32)
            _call(_lib()[1].jd_tiff_header, stream, len(stream),
                  hwc.ctypes.data, samp.ctypes.data)
            return int(samp[0]), int(samp[1])
        except _Failed:
            return 2, 2

    def decode_jpeg(self, k, rows, cols, ycc):
        """Strip or tile `k` of a JPEG-compressed TIFF: [rows, cols, n]
        (crop of the stream's image), or _Failed where JPEGPreDecode
        refuses the stream."""
        stream = _splice(bytes(self.tags[347]) if 347 in self.tags else None,
                         self.raw(k))
        lib = _lib()[1]
        hwc, samp = np.zeros(3, np.int32), np.zeros(9, np.int32)
        _call(lib.jd_tiff_header, stream, len(stream), hwc.ctypes.data,
              samp.ctypes.data)
        jh, jw, n = (int(v) for v in hwc)
        want = self.spp if self.planar == 1 else 1
        if n != want:
            raise _Failed("Improper JPEG component count")
        if samp[8] != self.bits:
            raise _Failed("Improper JPEG data precision")
        hv = (self.subsampling if self.photometric == 6 and self.planar == 1
              else (1, 1))
        if (tuple(samp[:2]) != hv or any(samp[2 * i] != 1 or
                                         samp[2 * i + 1] != 1
                                         for i in range(1, n))):
            raise _Failed("Improper JPEG sampling factors")
        per = -(-self.h // self.bh)
        last = not self.tiled and (k % per) * self.bh + rows == self.h
        if jw > cols or (jh > rows and not (jw == cols and last)):
            raise _Failed("JPEG strip/tile size exceeds expected dimensions")
        out = np.zeros((jh, jw, n), np.uint8)
        try:
            _call(lib.jd_tiff_decode, stream, len(stream), int(ycc),
                  out.ctypes.data, out.size)
        except _Failed as e:
            raise self.refuse(f"JPEG strip {k} that libjpeg stops in ({e}: "
                              f"libtiff keeps the rows it decoded)") from None
        full = np.zeros((rows, cols, n), np.uint8)
        full[:min(rows, jh), :min(cols, jw)] = out[:rows, :cols]
        return full


def _inflate(raw, expected):
    """zlib's inflate of a Deflate strip as ZIPDecode runs it: the bytes it
    writes before the stream ends, breaks or runs out, and whether it gave
    `expected` bytes without error."""
    d = zlib.decompressobj()
    try:
        out = d.decompress(raw, expected)
        return out, len(out) >= expected
    except zlib.error:
        pass
    d, out = zlib.decompressobj(), b""   # what inflate wrote before the error
    try:
        for i in range(len(raw)):
            out += d.decompress(raw[i:i + 1], expected - len(out))
            if len(out) >= expected:
                break
    except zlib.error:
        pass
    return out[:expected], False


# ------------------------------------------------------------ the reads --

def _l14(rgb: np.ndarray) -> np.ndarray:
    """OpenCV's icvCvt_BGR2Gray_8u (imgcodecs/src/utils.cpp): 14-bit
    weights, rounded."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 4899 + g * 9617 + b * 1868 + 8192) >> 14).astype(np.uint8)


def read(data: bytes, mode: str, name, source: str) -> np.ndarray:
    """The first image of a TIFF as cv2 5.0 reads it (`mode` "unchanged",
    "color" or "gray"; `source` "file" for cv2.imread, "buffer" for
    cv2.imdecode), in RGB(A) order. ValueError where cv2 gives None or the
    port does not read the file."""
    t = _Tiff(data, name, mapped=source == "file")
    c = t.compression
    if c in _NO_CODEC:
        raise t.none(f"with Compression (259) {c} ({_NO_CODEC[c]}): its "
                     f"libtiff has no such codec")
    if c in _NOT_YET:
        raise t.refuse(f"Compression tag (259) value {c} ({_NOT_YET[c]})")
    ph_name = _PHOTOMETRIC.get(t.photometric, "unknown")
    if t.photometric in (32844, 32845) or t.photometric is None:
        raise t.refuse(f"PhotometricInterpretation tag (262) value "
                       f"{t.photometric} ({ph_name})")
    if t.photometric not in (0, 1, 2, 3, 5, 6, 8):
        if t.bits == 32:
            raise t.refuse(f"float image with PhotometricInterpretation "
                           f"(262) {t.photometric} ({ph_name})")
        raise t.none(f"with PhotometricInterpretation (262) {t.photometric} "
                     f"({ph_name}): libtiff's RGBA reader does not take it")
    if source == "file" and t.orientation in (5, 6, 7, 8) and t.w != t.h:
        # imread's check of the image against the header's size
        raise ValueError(f"{name}: cv2.imread gives None for a TIFF whose "
                         f"Orientation ({t.orientation}) transposes it, "
                         f"not square (cv2.imdecode reads it)")
    bits, ph = t.bits, t.photometric
    # grfmt_tiff.cpp's readHeader: the type of the unchanged read
    if bits in (2, 4) and not (bits == 4 and ph == 3) or bits not in (
            1, 2, 4, 8, 16, 32):
        raise t.none(f"with {bits}-bit samples (BitsPerSample 258) and "
                     f"PhotometricInterpretation {ph}")
    wide = bits > 8 and ph <= 2 and t.spp in (1, 3, 4)
    direct = mode == "unchanged" and wide
    if direct and c not in _COMPRESSION:
        raise t.none(f"with Compression (259) {c}, which no libtiff codec "
                     f"decodes")
    # readData's assert on a strip or tile's buffer: its samples, or
    # TIFFReadRGBA*'s 4 bytes a pixel
    if t.bw * t.bh * (t.spp * max(1, bits // 8) if direct else 4) >= 1 << 30:
        raise t.none(f"whose strips or tiles of {t.bw} x {t.bh} pass cv2's "
                     f"1 GiB limit")
    if direct:
        out = _direct(t)
    else:
        if bits == 32:
            raise t.none(f"read to 8 bits with {bits}-bit samples "
                         f"(SampleFormat {t.sample_format})")
        channels = {"color": 3, "gray": 1}.get(mode) or (
            1 if ph in (0, 1) or bits == 1 else 3 if ph == 3
            else min(t.spp, 4))
        t.channels = 4 if channels == 4 else 3   # RGBA only where kept
        rgb = _rgba(t)
        # a grey photometric draws R = G = B, whose 14-bit luma is itself
        out = (rgb if channels > 1 else rgb[..., 0] if ph in (0, 1)
               else _l14(rgb))
    out = np.ascontiguousarray(out)
    return jpeg.orient(out, t.orientation if 1 <= t.orientation <= 8 else 1)


def _direct(t: _Tiff) -> np.ndarray:
    """The unchanged read of 16-bit and float samples: each strip or tile
    through TIFFReadEncodedStrip / Tile, as stored (cv2 gives None where
    one does not decode)."""
    kinds = {(16, 1): "u2", (32, 3): "f4"}
    kind = kinds.get((t.bits, t.sample_format))
    if kind is None:
        raise t.refuse(f"unchanged read of {t.bits}-bit samples with "
                       f"SampleFormat (339) {t.sample_format}")
    if t.compression == 7:
        raise t.refuse(f"{t.bits}-bit JPEG-compressed strip")
    if t.planar == 2 and t.spp > 1:
        raise ValueError(f"{t.name}: the unchanged read of a planar TIFF of "
                         f"{t.bits}-bit samples is refused: cv2 reads the "
                         f"first plane's strips into a buffer of every "
                         f"sample and returns the rest of it unwritten")
    dtype = np.dtype(kind)
    img = np.zeros((t.h, t.w, t.spp), dtype)
    k = 0
    for y0 in range(0, t.h, t.bh):
        for x0 in range(0, t.w, t.bw) if t.tiled else (0,):
            try:
                if t.compression == 1 and not t.mapped:
                    buf, ok = t.read_raw(k, t.spp), True
                else:
                    buf, ok = t.decode(k, t.spp)
            except _Failed as e:
                raise t.none(f"whose strip or tile {k} does not read "
                             f"({e})") from None
            if not ok:
                raise t.none(f"whose strip or tile {k} does not decode")
            k += 1
            blk = buf.view(dtype).reshape(-1, t.bw, t.spp)
            part = blk[:t.h - y0, :t.w - x0]
            img[y0:y0 + part.shape[0], x0:x0 + part.shape[1]] = part
    return img[..., 0] if t.spp == 1 else img


# ------------------------------------------------------------ RGBA reader --

def _rgba_ok(t: _Tiff):
    """TIFFRGBAImageOK / Begin and PickContigCase / PickSeparateCase: why
    libtiff's RGBA reader refuses the image (None where it takes it)."""
    ph, bits, spp = t.photometric, t.bits, t.spp
    if bits not in (1, 2, 4, 8, 16):
        return f"{bits}-bit samples"
    if t.sample_format == 3:
        return "floating-point samples"
    colors = spp - len(t.extras)
    contig = not (t.planar == 2 and spp > 1)
    if ph in (0, 1, 3) and t.planar == 1 and spp != 1 and bits < 8:
        return "contiguous samples of under 8 bits"
    if ph == 3 and (320 not in t.tags or len(t.tags[320]) != 3 << bits):
        return "palette image without its colour map"
    if ph == 2 and colors < 3:
        return "RGB image with under 3 colour channels"
    if ph == 5 and (t.tag(332, 1) != 1 or spp < 4):
        return "separated image other than 8-bit CMYK"
    if ph == 8 and (spp != 3 or colors != 3 or bits not in (8, 16)):
        return "CIELab image other than 3 8- or 16-bit samples"
    if ph == 6 and t.compression == 7 and contig:
        ph = 2   # JPEGCOLORMODE_RGB: libjpeg converts
    if contig:
        if ph == 2:
            ok = bits in (8, 16) and spp >= 3
        elif ph == 5:
            ok = bits == 8
        elif ph == 3:
            ok = bits in (1, 2, 4, 8)
        elif ph in (0, 1):
            ok = bits in (1, 2, 4, 8, 16)
        elif ph == 8:
            ok = True
        else:   # YCbCr
            ok = bits == 8 and spp == 3 and t.subsampling in (
                (1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))
    else:
        ok = ((ph in (0, 1, 2) and bits in (8, 16)) or (
            ph == 5 and bits == 8 and spp == 4) or (
            ph == 6 and bits == 8 and spp == 3 and t.subsampling == (1, 1)))
    return None if ok else (f"{bits}-bit {_PHOTOMETRIC.get(ph, ph)} image "
                            f"with {spp} samples")


def _alpha(t: _Tiff) -> int:
    """img->alpha: 1 associated, 2 unassociated, 0 none."""
    if not t.extras:
        return 0
    e = t.extras[0]
    if e == 0:
        return 1 if t.spp > 3 else 0
    return e if e in (1, 2) else 0


def _ycbcr_tables(t: _Tiff):
    """TIFFYCbCrToRGBInit's tables (float32 arithmetic, as tif_color.c
    computes it): Y_tab, Cr_r, Cb_b, Cr_g, Cb_g."""
    f32 = np.float32
    luma = [f32(v) for v in t.tags.get(529, (0.299, 0.587, 0.114))]
    rbw = [f32(v) for v in t.tags.get(532, (0, 255, 128, 255, 128, 255))]
    if len(luma) < 3 or len(rbw) < 6 or luma[1] == 0 or any(
            np.isnan(luma)):
        raise _Failed("Invalid values for YCbCrCoefficients")
    if any(not (-(2 ** 31) < v < 2 ** 31) for v in rbw):
        raise _Failed("Invalid values for ReferenceBlackWhite")

    def fix(x):
        return int(np.floor(np.float64(x) * 65536 + 0.5))

    def clamp(f, lo, hi):
        return lo if not f >= lo else hi if f > hi else f

    f1 = f32(2) - f32(2) * luma[0]
    d1 = fix(clamp(f1, f32(0), f32(2)))
    f2 = luma[0] * f1 / luma[1]
    d2 = -fix(clamp(f2, f32(0), f32(2)))
    f3 = f32(2) - f32(2) * luma[2]
    d3 = fix(clamp(f3, f32(0), f32(2)))
    f4 = luma[2] * f3 / luma[1]
    d4 = -fix(clamp(f4, f32(0), f32(2)))

    def code2v(c, rb, rw, cr):
        den = rw - rb
        v = f32(int(c) - int(rb)) * f32(cr) / (den if den != 0 else f32(1))
        return int(clamp(v, f32(-4096), f32(4096)))

    ytab, crr, cbb, crg, cbg = (np.zeros(256, np.int64) for _ in range(5))
    for i in range(256):
        x = i - 128
        cr = code2v(x, rbw[4] - f32(128), rbw[5] - f32(128), 127)
        cb = code2v(x, rbw[2] - f32(128), rbw[3] - f32(128), 127)
        crr[i] = (d1 * cr + 32768) >> 16
        cbb[i] = (d3 * cb + 32768) >> 16
        crg[i] = d2 * cr
        cbg[i] = d4 * cb + 32768
        ytab[i] = code2v(x + 128, rbw[0], rbw[1], 255)
    return ytab, crr, cbb, crg, cbg


def _ycbcr_to_rgb(tables, y, cb, cr, spread=lambda a: a):
    """TIFFYCbCrtoRGB: [..., 3] RGB of Y and its Cb, Cr samples (the
    chroma terms computed on `cb` / `cr` as given, then `spread` to Y's
    shape)."""
    ytab, crr, cbb, crg, cbg = tables
    yv = ytab[y]
    chroma = (crr[cr], (cbg[cb] + crg[cr]) >> 16, cbb[cb])
    return np.stack([np.clip(yv + spread(c), 0, 255) for c in chroma],
                    -1).astype(np.uint8)


@functools.cache
def _yc_to_value() -> np.ndarray:
    """TIFFCIELabToRGBInit's Yr2r table for the sRGB display: 1,501 steps
    of luminance to 255 x (i / 1500) ^ (1 / 2.4)."""
    gamma = 1.0 / float(np.float32(2.4))
    return np.array([np.float32(255) * np.float32((k / 1500) ** gamma)
                     for k in range(1501)], np.float32)


def _cielab_to_rgb(t: _Tiff, lab: np.ndarray) -> np.ndarray:
    """tif_color.c's TIFFCIELab16ToXYZ and TIFFXYZToRGB with libtiff's
    sRGB display and the WhitePoint (D50 where the tag is absent), in
    float32 as libtiff computes them: [..., 3] L*a*b* (8 bits: L unsigned,
    a and b signed; 16 bits: L unsigned, a and b signed x 256) to RGB."""
    f32 = np.float32
    wide = t.bits == 16
    d50 = (f32(96.4250), f32(100.0), f32(82.4680))
    total = d50[0] + d50[1] + d50[2]
    wp = t.tags.get(318)
    wp0, wp1 = ((d50[0] / total, d50[1] / total) if not wp or len(wp) < 2
                else (f32(wp[0]), f32(wp[1])))
    if wp1 == 0:
        raise _Failed("Invalid value for WhitePoint tag")
    y0 = f32(100.0)
    x0, z0 = wp0 / wp1 * y0, (f32(1.0) - wp0 - wp1) / wp1 * y0
    l = lab[..., 0].astype(f32)
    a = lab[..., 1].view(np.int16 if wide else np.int8).astype(f32)
    b = lab[..., 2].view(np.int16 if wide else np.int8).astype(f32)
    if wide:
        big_l = l * f32(100.0) / f32(65535.0)
        a, b = a / f32(256.0) / f32(500.0), b / f32(256.0) / f32(200.0)
    else:
        big_l = l * f32(100.0) / f32(255.0)
        a, b = a / f32(500.0), b / f32(200.0)
    low = big_l < f32(8.856)
    y_low = (big_l * y0) / f32(903.292)
    cby = np.where(low, f32(7.787) * (y_low / y0) + f32(16.0) / f32(116.0),
                   (big_l + f32(16.0)) / f32(116.0)).astype(f32)
    y = np.where(low, y_low, y0 * cby * cby * cby).astype(f32)

    def comp(t_, w0):
        return np.where(t_ < f32(0.2069), w0 * (t_ - f32(0.13793)) /
                        f32(7.787), w0 * t_ * t_ * t_).astype(f32)

    x, z = comp(a + cby, x0), comp(cby - b, z0)
    mat = ((3.2410, -1.5374, -0.4986), (-0.9692, 1.8760, 0.0416),
           (0.0556, -0.2040, 1.0570))
    steps = len(_yc_to_value()) - 1
    step = (f32(100.0) - f32(1.0)) / f32(steps)
    table = _yc_to_value()
    out = []
    for row in mat:
        m = [f32(v) for v in row]
        lum = np.minimum(np.maximum(m[0] * x + m[1] * y + m[2] * z, f32(1.0)),
                         f32(100.0))
        i = np.minimum(((lum - f32(1.0)) / step).astype(np.int64), steps)
        v = table[i].astype(np.float64)
        out.append(np.minimum(np.where(v > 0, v + 0.5, v - 0.5).astype(
            np.int64), 255))
    return np.stack(out, -1).astype(np.uint8)


def _bw_map(t: _Tiff) -> np.ndarray:
    """setupMap / makebwmap: a sample's grey (16 bits by the high byte)."""
    rng = 255 if t.bits >= 8 else (1 << t.bits) - 1
    x = np.arange(rng + 1)
    m = ((rng - x) * 255 // rng if t.photometric == 0 else x * 255 // rng)
    return m.astype(np.uint8)


def _unpack(buf, rows, cols, bits):
    """Sub-byte samples of `rows` rows padded to bytes, MSB first."""
    per = -(-cols * bits // 8)
    b = np.unpackbits(buf[:rows * per].reshape(rows, per), axis=1)
    b = b[:, :cols * bits].reshape(rows, cols, bits)
    return (b * (1 << np.arange(bits - 1, -1, -1))).sum(-1).astype(np.uint8)


def _canvas(rows, cols, channels):
    """A block's RGB, or RGBA with alpha 255 where no put sets it."""
    out = np.empty((rows, cols, channels), np.uint8)
    if channels == 4:
        out[..., 3] = 255
    return out


def _put_contig(t: _Tiff, buf, ok, rows, cols, tables):
    """The RGB(A) of one decoded strip or tile [rows, cols, t.channels]
    (contiguous samples; `cols` the columns drawn, fewer than the tile's
    width in the last tile column), as the put routine PickContigCase
    chose draws it."""
    ph, bits, spp, bw = t.photometric, t.bits, t.spp, t.bw
    out = _canvas(rows, cols, t.channels)
    if ph == 6:   # putcontig8bitYCbCr<hs><vs>tile
        hs, vs = t.subsampling
        bc, br = -(-bw // hs), -(-rows // vs)
        full = np.zeros(br * bc * (hs * vs + 2), np.uint8)
        full[:len(buf)] = buf[:len(full)]
        blk = full.reshape(br, bc, hs * vs + 2)
        ys = blk[..., :hs * vs].reshape(br, bc, vs, hs).transpose(
            0, 2, 1, 3).reshape(br * vs, bc * hs)[:rows, :cols]
        out[..., :3] = _ycbcr_to_rgb(
            tables, ys, blk[..., hs * vs], blk[..., hs * vs + 1],
            lambda c: np.repeat(np.repeat(c, vs, 0), hs, 1)[:rows, :cols])
        return out
    if bits < 8:
        s = _unpack(buf, rows, bw, bits)[:, :cols]
        if ph == 3:
            out[..., :3] = _palette(t)[s]
        else:
            out[..., :3] = _bw_map(t)[s][..., None]
        return out
    size = bits // 8
    stride = bw * spp * size
    if ph in (0, 1) and cols < bw and (size == 2 or spp > 1):
        # put16bitbwtile / putgreytile skip the clipped tile's columns by
        # their count in bytes, not in samples: each row starts short
        stride = cols * spp * size + (bw - cols)
        at = np.arange(rows)[:, None] * stride + np.arange(cols * spp * size)
        raw = buf[at]
    else:
        raw = buf[:rows * stride].reshape(rows, stride)[:, :cols * spp * size]
    wide = size == 2
    v = (raw.view(np.uint16 if ok else "<u2") if wide else raw).reshape(
        rows, cols, spp)
    if ph in (0, 1):
        g = _bw_map(t)[(v[..., 0] >> 8) if wide else v[..., 0]]
        out[..., :3] = g[..., None]
        if not wide and _alpha(t) and spp == 2:   # putagreytile
            out[..., 3:] = v[..., 1:2]
        return out
    if ph == 3:
        out[..., :3] = _palette(t)[v[..., 0]]
        return out
    if ph == 8:   # putcontig8bitCIELab8 / 16
        out[..., :3] = _cielab_to_rgb(t, v[..., :3])
        return out
    if ph == 5:   # putRGBcontig8bitCMYKtile
        out[..., :3] = _cmyk_to_rgb(v[..., :3], v[..., 3])
        return out
    alpha = _alpha(t) if spp >= 4 else 0
    if not wide and not alpha:   # putRGBcontig8bittile
        out[..., :3] = v[..., :3]
        return out
    rgb = v[..., :3].astype(np.uint32)
    if wide:
        rgb = (rgb + 128) // 257
    out[..., :3] = rgb
    if alpha:
        a = v[..., 3].astype(np.uint32)
        if wide:
            a = (a + 128) // 257
        out[..., 3:] = a[..., None]
        if alpha == 2:   # UaToAa
            out[..., :3] = (rgb * a[..., None] + 127) // 255
    return out


def _cmyk_to_rgb(cmy, k):
    """libtiff's CMYK to RGB: (255 - k)(255 - c) / 255, truncated."""
    kk = (255 - k.astype(np.uint32))[..., None]
    return (kk * (255 - cmy.astype(np.uint32)) // 255).astype(np.uint8)


def _put_separate(t: _Tiff, planes, rows, tables):
    """gtStripSeparate / gtTileSeparate with the put routine
    PickSeparateCase chose: planes [spp] of [rows, bw] samples."""
    ph, bits = t.photometric, t.bits
    out = _canvas(rows, t.bw, t.channels)
    if ph == 5:   # putCMYKseparate8bittile
        out[..., :3] = _cmyk_to_rgb(np.stack(planes[:3], -1), planes[3])
        return out
    p = [x.astype(np.int64) for x in planes]
    if ph == 6:
        out[..., :3] = _ycbcr_to_rgb(tables, p[0], p[1], p[2])
        return out
    colors = 1 if ph in (0, 1) else 3
    rgb = [p[0]] * 3 if colors == 1 else p[:3]
    alpha = _alpha(t)
    a = p[colors] if alpha and len(p) > colors else None
    if bits == 16:
        rgb = [(x + 128) // 257 for x in rgb]
        a = None if a is None else (a + 128) // 257
    for i in range(3):
        out[..., i] = rgb[i] if a is None or alpha != 2 else (
            rgb[i] * a + 127) // 255
    if a is not None:
        out[..., 3:] = a[..., None]
    return out


def _palette(t: _Tiff) -> np.ndarray:
    """The colour map as buildMap leaves it (16 bits to their high byte
    unless every entry is below 256), [2^bits, 3] uint8."""
    cmap = np.asarray(t.tags[320], np.int64).reshape(3, -1).T
    if cmap.max(initial=0) >= 256:
        cmap = cmap >> 8
    return (cmap & 0xFF).astype(np.uint8)


def _rgba(t: _Tiff) -> np.ndarray:
    """The image as libtiff's RGBA reader draws it for cv2, strip by strip
    or tile by tile, [h, w, t.channels] (RGB, or RGBA) top row first
    (before the Orientation tag applies)."""
    why = _rgba_ok(t)
    if why is not None:
        raise t.none(f"that libtiff's RGBA reader does not take: {why}")
    contig = not (t.planar == 2 and t.spp > 1)
    tables = None
    if t.photometric == 6 and (t.compression != 7 or not contig):
        try:
            tables = _ycbcr_tables(t)
        except _Failed as e:
            raise t.none(f"({e})") from None
    img = np.empty((t.h, t.w, t.channels), np.uint8)   # the blocks cover it
    per_plane = -(-t.h // t.bh) * (-(-t.w // t.bw) if t.tiled else 1)
    raw_size = 0
    k = 0
    for y0 in range(0, t.h, t.bh):
        for x0 in range(0, t.w, t.bw) if t.tiled else (0,):
            rows = min(t.block_rows(k), t.h - y0)   # the rows drawn
            if (t.tiled and t.compression == 1 and contig
                    and not (t.mapped and t.fill_order == 1)):
                # _TIFFReadTileAndAllocBuffer wants the raw buffer as large
                # as the tile; cv2.imdecode's (not mapped) or a bit-reversed
                # one grows in steps of 1,024 bytes (a mapped file's tiles:
                # decode)
                count = t.counts[k] if k < len(t.counts) else 0
                if count > raw_size:
                    raw_size = -(-count // 1024) * 1024
                if raw_size != t.block_bytes(k, t.spp):
                    raise t.none(f"whose uncompressed tile {k} reads into "
                                 f"a raw buffer of {raw_size} bytes: "
                                 f"libtiff wants the tile's "
                                 f"{t.block_bytes(k, t.spp)}")
            try:
                if t.compression == 7:
                    blk = _jpeg_rgba(t, k, rows, contig)
                elif contig:
                    buf, ok = t.decode(k, t.spp)
                    blk = _put_contig(t, buf, ok, rows, min(t.bw, t.w - x0),
                                      tables)
                else:
                    blk = _put_separate(t, _planes(t, k, per_plane, rows),
                                        rows, tables)
            except _Failed as e:
                raise t.none(f"whose strip or tile {k} does not read "
                             f"({e})") from None
            k += 1
            part = blk[:t.h - y0, :t.w - x0]
            img[y0:y0 + part.shape[0], x0:x0 + part.shape[1]] = part
    if t.tiled and t.orientation in (2, 3, 6, 7) and t.bw < t.w:
        # TIFFReadRGBATile mirrors each tile in place: once the image is
        # mirrored whole, the tile columns stand in reverse order
        cols = [img[:, x0:x0 + t.bw] for x0 in range(0, t.w, t.bw)]
        img = np.concatenate(cols[::-1], axis=1)
    return img


def _planes(t: _Tiff, k, per_plane, rows):
    """The planes gtStripSeparate / gtTileSeparate reads for strip or
    tile `k`: the colour planes (one for grey) and the alpha plane; a plane
    past the first that does not read stays zero, as in its buffer."""
    ph = t.photometric
    colors = 1 if ph in (0, 1) else 3
    alpha = _alpha(t) or ph == 5   # CMYK's K is read as the "alpha" plane
    planes = []
    for s in range(colors + bool(alpha)):
        try:
            if s and t.compression == 1 and not (t.tiled or t.mapped):
                # TIFFReadEncodedStrip's shortcut (read_raw); the first
                # plane comes through TIFFFillStrip
                buf, ok = t.read_raw(k + s * per_plane, 1, partial=True)
            else:
                buf, ok = t.decode(k + s * per_plane, 1)
        except _Failed:
            if not s:
                raise
            buf, ok = np.zeros(t.block_bytes(k, 1), np.uint8), False
        v = buf.view(np.uint16) if t.bits == 16 else buf
        planes.append(v[:rows * t.bw].reshape(rows, t.bw))
    return planes


def _jpeg_rgba(t: _Tiff, k, rows, contig):
    """A JPEG-compressed strip or tile as the RGBA reader draws it."""
    if not contig:
        raise t.refuse("JPEG-compressed planar image")
    ycc = t.photometric == 6
    s = t.decode_jpeg(k, t.block_rows(k), t.bw, ycc)[:rows]
    out = _canvas(rows, t.bw, t.channels)
    if ycc or t.photometric == 2:
        out[..., :3] = s[..., :3]
        if not ycc and _alpha(t) and t.spp >= 4:
            a = s[..., 3].astype(np.int64)
            out[..., 3:] = a[..., None]
            if _alpha(t) == 2:
                out[..., :3] = (s[..., :3].astype(np.int64) * a[..., None]
                                + 127) // 255
    elif t.photometric == 5:
        out[..., :3] = _cmyk_to_rgb(s[..., :3], s[..., 3])
    elif t.photometric == 3:
        out[..., :3] = _palette(t)[s[..., 0]]
    else:
        g = _bw_map(t)[s[..., 0]]
        out[..., :3] = g[..., None]
        if _alpha(t) and t.spp == 2:
            out[..., 3:] = s[..., 1:2]
    return out
