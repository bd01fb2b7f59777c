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
  TIFF                    `data/tiff.py` (libtiff's RGBA reader; LZW and
                          PackBits in native/image_native.cpp, JPEG
                          strips in native/jpeg_native.cpp, Deflate
                          through zlib)
  JPEG 2000 (J2K, JP2)    `data/jpeg2000.py` (OpenJPEG's decoder in
                          native/j2k_native.cpp)

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
part of each row) the port refuses too. AVIF is recognised but not decoded
here (ROADMAP F2): it goes through cv2, and raises RuntimeError naming cv2
where it is absent; no other read reaches cv2.
"""
from __future__ import annotations

import ctypes
import functools
import struct

import numpy as np

from spinnerf_tpu_torch.data import jpeg, jpeg2000, tiff
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
        return tiff.read(data, mode, name, source)
    if kind == "pfm":
        return _read_pfm(data, mode, name, source)
    if kind == "hdr":
        return _read_hdr(data, mode, name)
    if kind == "gif":
        return _read_gif(data, mode, name)
    if kind == "jpeg2000":
        return jpeg2000.read(data, mode, name)
    return _cv2_read(data, mode, name)


def _cv2_read(data: bytes, mode: str, name) -> np.ndarray:
    """cv2.imdecode's read of AVIF, which the port does not decode yet
    (ROADMAP F2), in RGB(A) order; RuntimeError naming cv2 where it is
    absent."""
    kind = "avif"
    try:
        import cv2
    except ImportError:
        raise RuntimeError(
            f"{name}: {kind} images are read through cv2, which is not "
            f"installed (ROADMAP F2: the port decodes JPEG, PNG, BMP, PxM, "
            f"PAM, PFM, Sun raster, Radiance HDR, GIF, WebP, TIFF and JPEG "
            f"2000 without it; AVIF not yet)") from None
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
                     ("im_gif_decode", [buf, i64, i32, vp, i64, vp, i64])):
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
