"""Image files read by their content, as cv2 5.0 reads them, without cv2.

cv2 never picks a decoder by a file's name: `cv2.imread` and `cv2.imdecode`
ask each decoder in turn whether the first bytes are its signature
(imgcodecs/src/loadsave.cpp, findDecoder). `sniff` does the same, and
`read` runs the port's decoder of that format:

  JPEG                    `data/jpeg.py` (native/jpeg_native.cpp: Huffman
                          and arithmetic coding, lossless)
  PNG                     `eval/render.py::read_png`
  BMP, PBM / PGM / PPM,   native/image_native.cpp (g++ at first use, like
  PAM, PFM, Sun raster,   the JPEG decoder)
  Radiance HDR, GIF,
  WebP
  TIFF                    `_read_tiff` here; LZW and PackBits in
                          native/image_native.cpp, Deflate through zlib

`read(data, mode=..., source=..., name=...)` gives cv2's unchanged, colour
or grayscale read (`IMREAD_UNCHANGED`, `IMREAD_COLOR`, `IMREAD_GRAYSCALE`)
with the channels in RGB(A) order. The orientation is applied where cv2
applies it: the EXIF orientation of a JPEG (APP1), PNG (eXIf) or WebP
(EXIF chunk) in the colour and gray reads; a TIFF's Orientation tag in all
three; none for the other formats. Each format's gray read is cv2's own:
libjpeg's Y, libpng's rgb_to_gray (`read_png`), cvtColor's 15-bit luma of
the colour read of a WebP, HDR or GIF, OpenCV's 14-bit `icvCvt_BGR2Gray`
for BMP, PxM, PAM, Sun raster and TIFF, and PFM's saturated samples. HDR
and PFM read float32 unchanged, as cv2 does.

Content that no cv2 decoder recognises raises FileNotFoundError (JAX's
`imread_float` raises it where cv2 gives None); a damaged stream or a part
of a format the port refuses raises ValueError naming the file and the
reason; where cv2 gives pixels it never wrote (PAM conversions that fill a
part of each row) the port refuses too. AVIF and JPEG 2000 are recognised
but not decoded here (ROADMAP F2): they go through cv2, and raise
RuntimeError naming cv2 where it is absent; no other read reaches cv2.
"""
from __future__ import annotations

import ctypes
import functools
import struct
import zlib

import numpy as np

from spinnerf_tpu_torch.data import jpeg
from spinnerf_tpu_torch.native import build as _native

MODES = ("unchanged", "color", "gray")
_ERR_LEN = 512


def sniff(data: bytes) -> str:
    """The format whose cv2 5.0 decoder claims `data` by its first bytes,
    asked in cv2's order: "avif", "bmp", "hdr", "jpeg", "webp", "sunras",
    "pxm" (P1-P6), "pam" (P7), "pfm", "tiff", "png", "jpeg2000", "gif"; ""
    where none does."""
    head = bytes(data[:32])
    if len(head) >= 12 and head[4:8] == b"ftyp" and (
            b"avif" in bytes(data[8:64]) or b"avis" in bytes(data[8:64])):
        return "avif"
    if head[:2] == b"BM":
        return "bmp"
    if head.startswith((b"#?RGBE", b"#?RADIANCE")):
        return "hdr"
    if head[:3] == b"\xff\xd8\xff":
        return "jpeg"
    if len(head) >= 12 and head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "webp"
    if head[:4] == b"\x59\xa6\x6a\x95":
        return "sunras"
    if len(head) >= 3 and head[0:1] == b"P" and head[2:3].isspace():
        if b"1"[0] <= head[1] <= b"6"[0]:
            return "pxm"
        if head[1:2] == b"7":
            return "pam"
        if head[1:2] in (b"f", b"F"):
            return "pfm"
    if head[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"):
        return "tiff"
    if head[:8] == b"\x89PNG\r\n\x1a\n":
        return "png"
    if head[:4] == b"\xff\x4f\xff\x51" or head[:12] == (
            b"\x00\x00\x00\x0cjP  \r\n\x87\n"):
        return "jpeg2000"
    if head[:6] in (b"GIF87a", b"GIF89a"):
        return "gif"
    return ""


def read(data: bytes, *, mode: str = "unchanged", source: str = "buffer",
         name) -> np.ndarray:
    """The pixels cv2 5.0 reads from an image file's bytes, channels in
    RGB(A) order: `mode` "unchanged", "color" (uint8 [H, W, 3]) or "gray"
    (uint8 [H, W]); `source` "file" for `cv2.imread`'s semantics, "buffer"
    for `cv2.imdecode`'s (they differ for truncated JPEGs only). Raises
    FileNotFoundError where no cv2 decoder recognises the content,
    ValueError where cv2 gives None or the port refuses the stream."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    data = bytes(data)
    kind = sniff(data)
    if not kind:
        raise FileNotFoundError(f"{name}: no image format that cv2 reads "
                                f"recognises this content")
    if kind == "jpeg":
        img = jpeg.decode(data, name=name, mode=mode, source=source)
        return img if mode == "unchanged" else jpeg.orient(
            img, jpeg.exif_orientation(data))
    if kind == "png":
        from spinnerf_tpu_torch.eval.render import read_png
        img, orientation = read_png(data, with_orientation=True, mode=mode,
                                    name=name)
        return img if mode == "unchanged" else jpeg.orient(img, orientation)
    if kind in ("bmp", "sunras"):
        return _read_bgr(data, mode, name, kind)
    if kind in ("pxm", "pam"):
        return _read_pxm(data, mode, name, kind)
    if kind == "webp":
        return _read_webp(data, mode, name)
    if kind == "tiff":
        return _read_tiff(data, mode, name, source)
    if kind == "pfm":
        return _read_pfm(data, mode, name, source)
    if kind == "hdr":
        return _read_hdr(data, mode, name)
    if kind == "gif":
        return _read_gif(data, mode, name)
    return _cv2_read(data, mode, name, kind)


def _cv2_read(data: bytes, mode: str, name, kind: str) -> np.ndarray:
    """cv2.imdecode's read of AVIF or JPEG 2000, which the port does not
    decode yet (ROADMAP F2), in RGB(A) order; RuntimeError naming cv2
    where it is absent."""
    try:
        import cv2
    except ImportError:
        raise RuntimeError(
            f"{name}: {kind} images are read through cv2, which is not "
            f"installed (ROADMAP F2: the port decodes JPEG, PNG, BMP, PxM, "
            f"PAM, PFM, Sun raster, Radiance HDR, GIF, WebP and TIFF "
            f"without it; AVIF and JPEG 2000 not yet)") from None
    flag = {"unchanged": cv2.IMREAD_UNCHANGED, "color": cv2.IMREAD_COLOR,
            "gray": cv2.IMREAD_GRAYSCALE}[mode]
    img = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
    if img is None:
        raise ValueError(f"{name}: cv2 cannot decode this {kind} image")
    return _bgr_to_rgb(img)


def _bgr_to_rgb(img: np.ndarray) -> np.ndarray:
    if img.ndim == 3 and img.shape[2] >= 3:
        order = [2, 1, 0] + list(range(3, img.shape[2]))
        return np.ascontiguousarray(img[..., order])
    return img


@functools.cache
def _lib() -> ctypes.CDLL:
    """native/image_native.cpp's library (built at first use), typed."""
    lib = _native.load("image_native")
    vp, i64, i32, buf = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                         ctypes.c_char_p)
    for fn, args in (("im_bmp_info", [buf, i64, vp, vp, i64]),
                     ("im_bmp_decode", [buf, i64, i32, vp, i64, vp, i64]),
                     ("im_pxm_info", [buf, i64, vp, vp, i64]),
                     ("im_pxm_decode", [buf, i64, i32, i32, vp, i64, vp,
                                        i64]),
                     ("im_webp_info", [buf, i64, vp, vp, i64]),
                     ("im_webp_decode", [buf, i64, i32, vp, i64, vp, i64]),
                     ("im_lzw_decode", [buf, i64, vp, i64, vp, vp, i64]),
                     ("im_pam_info", [buf, i64, vp, vp, i64]),
                     ("im_pam_decode", [buf, i64, i32, i32, vp, i64, vp,
                                        i64]),
                     ("im_pfm_info", [buf, i64, vp, vp, i64]),
                     ("im_pfm_decode", [buf, i64, vp, i64, vp, i64]),
                     ("im_sunras_info", [buf, i64, vp, vp, i64]),
                     ("im_sunras_decode", [buf, i64, i32, vp, i64, vp, i64]),
                     ("im_hdr_info", [buf, i64, vp, vp, i64]),
                     ("im_hdr_decode", [buf, i64, vp, i64, vp, i64]),
                     ("im_gif_info", [buf, i64, vp, vp, i64]),
                     ("im_gif_decode", [buf, i64, i32, vp, i64, vp, i64]),
                     ("im_packbits_decode", [buf, i64, vp, i64, vp, vp,
                                             i64])):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = args
    return lib


def _call(name, fn, *args):
    err = ctypes.create_string_buffer(_ERR_LEN)
    if fn(*args, ctypes.addressof(err), _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode(errors='replace')}")


def _info(name, fn, data, n):
    info = np.zeros(n, np.int32)
    _call(name, fn, data, len(data), info.ctypes.data)
    h, w = int(info[0]), int(info[1])
    # cv2's validateInputImageSize (CV_IO_MAX_IMAGE_WIDTH / HEIGHT /
    # PIXELS), which it raises on
    if not (0 < w <= 1 << 20 and 0 < h <= 1 << 20 and w * h <= 1 << 30):
        raise ValueError(f"{name}: image size {w} x {h} is past what cv2 "
                         f"reads")
    return [int(v) for v in info]


def _channels(mode: str, native: int) -> int:
    return {"unchanged": native, "color": 3, "gray": 1}[mode]


def _empty(h, w, channels, dtype=np.uint8):
    return np.empty((h, w, channels) if channels > 1 else (h, w), dtype)


def _read_bgr(data, mode, name, kind):
    """BMP, or a Sun raster (RT_OLD / RT_STANDARD, as grfmt_sunras.cpp
    reads them): 8-bit BGR(A) or gray as cv2 gives it."""
    lib = _lib()
    h, w, native = _info(name, getattr(lib, f"im_{kind}_info"), data, 3)
    channels = _channels(mode, native)
    out = _empty(h, w, channels)
    _call(name, getattr(lib, f"im_{kind}_decode"), data, len(data), channels,
          out.ctypes.data, out.size)
    return _bgr_to_rgb(out)


def _read_pxm(data, mode, name, kind):
    """PBM / PGM / PPM, or PAM (P7) as grfmt_pam.cpp reads it: samples as
    stored (not scaled by MAXVAL; 16 bits above 255), the file's channels
    taken as BGR(A); its gray read of RGB is the 14-bit luma of the file
    read as RGB."""
    lib = _lib()
    h, w, native, depth = _info(name, getattr(lib, f"im_{kind}_info"), data,
                                4)
    channels = _channels(mode, native)
    if mode != "unchanged":
        depth = 1
    out = _empty(h, w, channels, np.uint16 if depth == 2 else np.uint8)
    _call(name, getattr(lib, f"im_{kind}_decode"), data, len(data), channels,
          depth, out.ctypes.data, out.nbytes)
    return _bgr_to_rgb(out)


def _webp_orientation(data: bytes) -> int:
    """The EXIF orientation of a WebP's EXIF chunk (1 without one)."""
    pos = 12
    while pos + 8 <= len(data):
        tag = data[pos:pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
        if tag == b"EXIF":
            body = data[pos + 8:pos + 8 + size]
            if body[:6] == b"Exif\x00\x00":
                body = body[6:]
            return jpeg.exif_orientation(body)
        pos += 8 + size + (size & 1)
    return 1


def _read_webp(data, mode, name):
    """WebPDecodeBGR(A)Into as cv2 calls it (an animation: its first frame
    on a cleared canvas, as WebPAnimDecoder gives it): 4 channels where the
    file has alpha; the colour read drops it and the gray read is
    cvtColor's BGR2GRAY (15-bit weights, rounded)."""
    lib = _lib()
    h, w, has_alpha, _ = _info(name, lib.im_webp_info, data, 4)
    native = 4 if has_alpha else 3
    out = _empty(h, w, native)
    _call(name, lib.im_webp_decode, data, len(data), native,
          out.ctypes.data, out.size)
    if mode == "unchanged":
        return _bgr_to_rgb(out)
    img = _bgr_to_rgb(out[..., :3])
    return jpeg.orient(img if mode == "color" else _l15(img),
                       _webp_orientation(data))


def _l15(rgb: np.ndarray) -> np.ndarray:
    """cvtColor's COLOR_BGR2GRAY on 8 bits: 15-bit weights, rounded."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    return ((b * 3735 + g * 19235 + r * 9798 + 16384) >> 15).astype(np.uint8)


def _saturate_u8(v: np.ndarray) -> np.ndarray:
    """saturate_cast<uchar> of float32 as OpenCV's convertTo computes it:
    rounded half to even, where the 32-bit conversion overflows (NaN,
    +-inf, |v| >= 2^31) 0, then clipped to [0, 255]."""
    inside = np.abs(v) < 2.0 ** 31
    r = np.clip(np.rint(np.where(inside, v, 0)), 0, 255)
    return np.where(inside, r, 0).astype(np.uint8)


def _read_pfm(data, mode, name, source):
    """PFM as grfmt_pfm.cpp reads it: float32 divided by |scale|, RGB; the
    colour and gray reads are convertTo's saturate of the floats (no
    x255), with the file's channel count: `cv2.imread` gives None where it
    differs from the read's, `cv2.imdecode` keeps it."""
    lib = _lib()
    h, w, c = _info(name, lib.im_pfm_info, data, 3)
    img = np.empty((h, w, 3) if c == 3 else (h, w), np.float32)
    _call(name, lib.im_pfm_decode, data, len(data), img.ctypes.data,
          img.size)
    if mode == "unchanged":
        return img
    if (3 if mode == "color" else 1) != c and source == "file":
        raise ValueError(f"{name}: cv2.imread gives None for the {mode} read "
                         f"of a {c}-channel PFM (cv2.imdecode reads it with "
                         f"{c} channels)")
    return _saturate_u8(img)


def _read_hdr(data, mode, name):
    """Radiance HDR as grfmt_hdr.cpp reads it: float32 RGB; the colour read
    is the floats x255 saturated, the gray read cvtColor's luma of it."""
    lib = _lib()
    h, w = _info(name, lib.im_hdr_info, data, 2)
    img = np.empty((h, w, 3), np.float32)
    _call(name, lib.im_hdr_decode, data, len(data), img.ctypes.data,
          img.size)
    if mode == "unchanged":
        return img
    with np.errstate(over="ignore"):
        rgb = _saturate_u8(img * np.float32(255))
    return rgb if mode == "color" else _l15(rgb)


def _read_gif(data, mode, name):
    """GIF as OpenCV 5's grfmt_gif.cpp reads it: the first frame on the
    logical screen, RGBA where any frame has a transparent index; the
    colour read drops alpha, the gray read is cvtColor's luma."""
    lib = _lib()
    h, w, native = _info(name, lib.im_gif_info, data, 3)
    out = _empty(h, w, native)
    _call(name, lib.im_gif_decode, data, len(data), native, out.ctypes.data,
          out.size)
    if mode == "unchanged":
        return _bgr_to_rgb(out)
    rgb = _bgr_to_rgb(out[..., :3])
    return rgb if mode == "color" else _l15(rgb)


# ----------------------------------------------------------------- TIFF --

_TIFF_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B",
               8: "h", 9: "i", 10: "ii", 11: "f", 12: "d", 13: "I"}
_COMPRESSION = {1: "none", 5: "LZW", 8: "Deflate", 32946: "Deflate",
                32773: "PackBits"}
_TIFF_NAMES = {2: "CCITT RLE", 3: "CCITT fax 3", 4: "CCITT fax 4",
               6: "old-style JPEG", 7: "JPEG", 34712: "JPEG 2000",
               34887: "LERC", 34925: "LZMA", 50000: "Zstd", 50001: "WebP",
               32845: "SGI LogLuv", 34676: "SGI Log"}
_PHOTOMETRIC = {0: "MinIsWhite", 1: "MinIsBlack", 2: "RGB", 3: "palette",
                4: "mask", 5: "separated (CMYK)", 6: "YCbCr", 8: "CIELab",
                9: "ICCLab", 10: "ITULab", 32844: "LogL", 32845: "LogLuv"}


def _l14(rgb: np.ndarray) -> np.ndarray:
    """OpenCV's icvCvt_BGR2Gray_8u (imgcodecs/src/utils.cpp): 14-bit
    weights, rounded."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    return ((r * 4899 + g * 9617 + b * 1868 + 8192) >> 14).astype(np.uint8)


def _tiff_ifd(data: bytes, name):
    """The byte order and the first IFD's tags (tag -> tuple of values)."""
    order = {b"II": "<", b"MM": ">"}[data[:2]]
    if len(data) < 8:
        raise ValueError(f"{name}: TIFF header cut short")
    magic, offset = struct.unpack(order + "HI", data[2:8])
    if magic == 43:
        raise ValueError(f"{name}: BigTIFF is not read by the port yet "
                         f"(ROADMAP F2)")
    if offset + 2 > len(data):
        raise ValueError(f"{name}: TIFF directory out of range")
    (n,) = struct.unpack(order + "H", data[offset:offset + 2])
    tags = {}
    for k in range(n):
        e = offset + 2 + 12 * k
        if e + 12 > len(data):
            raise ValueError(f"{name}: TIFF directory cut short")
        tag, typ, count = struct.unpack(order + "HHI", data[e:e + 8])
        fmt = _TIFF_TYPES.get(typ)
        if fmt is None:
            continue
        size = struct.calcsize(order + fmt) * count
        if size <= 4:
            raw = data[e + 8:e + 8 + size]
        else:
            (at,) = struct.unpack(order + "I", data[e + 8:e + 12])
            raw = data[at:at + size]
            if len(raw) < size:
                raise ValueError(f"{name}: TIFF tag {tag} out of range")
        tags[tag] = struct.unpack(order + fmt * count, raw)
    return order, tags


def _tiff_block(data, offset, count, expected, compression, name):
    raw = data[offset:offset + count]
    if len(raw) < count:
        raise ValueError(f"{name}: TIFF strip or tile out of range")
    if compression == 1:
        out = raw
    elif compression in (8, 32946):
        try:
            out = zlib.decompressobj().decompress(raw, expected)
        except zlib.error as e:
            raise ValueError(f"{name}: TIFF Deflate data damaged ({e})") \
                from None
    else:
        lib = _lib()
        buf = np.zeros(expected, np.uint8)
        written = np.zeros(1, np.int64)
        fn = lib.im_lzw_decode if compression == 5 else lib.im_packbits_decode
        _call(name, fn, raw, len(raw), buf.ctypes.data, expected,
              written.ctypes.data)
        out = buf[:int(written[0])].tobytes()
    if len(out) < expected:
        raise ValueError(f"{name}: TIFF strip or tile data ends early "
                         f"({len(out)} of {expected} bytes)")
    return out[:expected]


def _read_tiff(data, mode, name, source):
    """The first image of a TIFF as cv2 5.0 (libtiff 4.7.1) reads it.
    Taken: strips and (compressed) tiles, either byte order, compression
    none, LZW, Deflate or PackBits, predictor 1 or 2 (applied with LZW and
    Deflate only, as libtiff does), 8- and 16-bit unsigned and
    32-bit float samples, 1, 3 or 4 of them (2, gray and alpha, in 8-bit
    strips), chunky or planar, MinIsBlack, MinIsWhite, RGB and palette. cv2
    reads 8-bit output through libtiff's RGBA reader: MinIsWhite inverted,
    unassociated alpha premultiplied, a 16-bit colour map to its high byte,
    16-bit RGB rounded to 8 bits ((v + 128) // 257), 16-bit gray to its high
    byte; its unchanged read keeps 16-bit and float samples as they are
    (MinIsWhite not inverted), and it gives None for the colour and gray
    reads of float images. The Orientation tag applies in every read;
    `cv2.imread` gives None where it transposes (5-8), `cv2.imdecode` not.
    Other compressions and photometrics raise ValueError naming the tag."""
    order, tags = _tiff_ifd(data, name)

    def tag(t, default=None):
        v = tags.get(t)
        return default if v is None else v[0]

    def refuse(why):
        return ValueError(f"{name}: TIFF {why} is not read by the port")

    w, h = tag(256), tag(257)
    if not w or not h:
        raise ValueError(f"{name}: TIFF without ImageWidth / ImageLength")
    spp = tag(277, 1)
    bps = tags.get(258, (1,) * spp)
    compression = tag(259, 1)
    photometric = tag(262)
    planar, predictor = tag(284, 1), tag(317, 1)
    sample_format = tag(339, 1)
    extras = tags.get(338, ())
    orientation = tag(274, 1)
    tiled = 322 in tags
    if compression not in _COMPRESSION:
        raise refuse(f"Compression tag (259) value {compression} "
                     f"({_TIFF_NAMES.get(compression, 'unknown')})")
    if photometric not in (0, 1, 2, 3):
        raise refuse(f"PhotometricInterpretation tag (262) value "
                     f"{photometric} ({_PHOTOMETRIC.get(photometric, '?')})")
    if len(set(bps)) != 1:
        raise refuse(f"BitsPerSample tag (258) {bps}")
    bits = bps[0]
    kinds = {(8, 1): "u1", (16, 1): "u2", (32, 3): "f4"}
    if (bits, sample_format) not in kinds:
        raise refuse(f"BitsPerSample (258) {bits} with SampleFormat (339) "
                     f"{sample_format}")
    # libtiff's LZW and Deflate codecs apply the predictor; it ignores the
    # tag for uncompressed and PackBits data
    if compression not in (5, 8, 32946):
        predictor = 1
    if predictor not in (1, 2):
        raise refuse(f"Predictor tag (317) value {predictor}")
    if tag(266, 1) != 1:
        raise refuse("FillOrder tag (266) value 2")
    if planar == 2 and (bits != 8 or spp == 2):
        # cv2 reads the first plane's strips as if they held every sample
        raise refuse(f"PlanarConfiguration (284) 2 with {spp} {bits}-bit "
                     f"samples")
    if tiled and compression == 1:
        # libtiff under cv2 refuses most of them ("Invalid tile byte count")
        raise refuse("uncompressed tiles")
    if tiled and orientation in (2, 3, 6, 7) and tag(322) < w:
        # cv2's pixels there were not matched (its tiles' mirroring)
        raise refuse(f"Orientation (274) {orientation} over several tile "
                     f"columns")
    if source == "file" and orientation in (5, 6, 7, 8):
        raise ValueError(f"{name}: cv2.imread gives None for a TIFF whose "
                         f"Orientation ({orientation}) transposes it "
                         f"(cv2.imdecode reads it)")
    gray = photometric in (0, 1)
    if not ((gray and spp == 1) or (photometric == 1 and spp == 2
                                    and bits == 8 and not tiled)
            or (photometric == 2 and spp in (3, 4))
            or (photometric == 3 and spp == 1 and bits == 8)):
        raise refuse(f"SamplesPerPixel (277) {spp} with "
                     f"PhotometricInterpretation (262) {photometric} and "
                     f"{bits} bits")
    dtype = np.dtype(order + kinds[(bits, sample_format)])
    if tiled:
        bw, bh = tag(322), tag(323)
        offsets, counts = tags.get(324), tags.get(325)
    else:
        bw, bh = w, min(tag(278, 2 ** 32 - 1), h)
        offsets, counts = tags.get(273), tags.get(279)
    if not bw or not bh or offsets is None or counts is None:
        raise ValueError(f"{name}: TIFF without strip or tile offsets")
    planes = spp if planar == 2 else 1
    per = 1 if planar == 2 else spp
    img = np.zeros((planes, h, w, per), dtype.newbyteorder("="))
    k = 0
    for p in range(planes):
        for y0 in range(0, h, bh):
            for x0 in range(0, w, bw) if tiled else (0,):
                rows = bh if tiled else min(bh, h - y0)
                if k >= len(offsets) or k >= len(counts):
                    raise ValueError(f"{name}: TIFF strip or tile missing")
                raw = _tiff_block(data, offsets[k], counts[k],
                                  rows * bw * per * dtype.itemsize,
                                  compression, name)
                k += 1
                blk = np.frombuffer(raw, dtype).reshape(rows, bw, per)
                if predictor == 2:
                    ints = blk.view(np.dtype(order + f"u{dtype.itemsize}"))
                    blk = np.cumsum(ints.astype(np.uint64), axis=1).astype(
                        ints.dtype.newbyteorder("=")).view(
                        dtype.newbyteorder("="))
                part = blk[:min(rows, h - y0), :min(bw, w - x0)]
                img[p, y0:y0 + part.shape[0], x0:x0 + part.shape[1]] = part
    samples = (img[0] if planes == 1
               else img[..., 0].transpose(1, 2, 0))
    if bits == 32:
        if mode != "unchanged":
            raise ValueError(f"{name}: cv2 gives None for the {mode} read "
                             f"of a floating-point TIFF")
        out = samples[..., 0] if spp == 1 else samples
    elif photometric == 3:
        cmap = np.asarray(tags[320], np.int64).reshape(3, -1).T
        if cmap.max(initial=0) > 255:      # libtiff's checkcmap
            cmap = cmap >> 8
        table = np.zeros((256, 3), np.uint8)
        table[:min(256, len(cmap))] = cmap[:256]
        rgb = table[samples[..., 0]]
        out = _l14(rgb) if mode == "gray" else rgb
    elif gray:
        g = samples[..., 0]
        if bits == 16:
            if mode == "unchanged":
                out = g
            elif tiled:
                raise refuse("colour or gray read of 16-bit gray tiles")
            else:
                g = (g >> 8).astype(np.uint8)
                out = 255 - g if photometric == 0 else g
        else:
            out = 255 - g if photometric == 0 else g
        if mode == "color":
            out = np.repeat(out[..., None], 3, axis=-1)
    else:
        rgb = samples
        unassociated = spp == 4 and tuple(extras[:1]) == (2,)
        if bits == 8 and unassociated:
            a = rgb[..., 3:].astype(np.int64)
            rgb = np.concatenate(
                [(rgb[..., :3].astype(np.int64) * a + 127) // 255, a],
                axis=-1).astype(np.uint8)
        if bits == 16 and mode != "unchanged":
            if unassociated:
                raise refuse("colour or gray read of 16-bit RGBA with "
                             "unassociated alpha")
            rgb = ((rgb.astype(np.int64) + 128) // 257).astype(np.uint8)
        out = (rgb if mode == "unchanged" else rgb[..., :3]
               if mode == "color" else _l14(rgb))
    out = np.ascontiguousarray(out)
    return jpeg.orient(out, orientation if 1 <= orientation <= 8 else 1)
