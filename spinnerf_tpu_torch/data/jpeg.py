"""JPEG decoding and EXIF orientation without cv2.

`decode` runs the port's native decoder (`native/jpeg_native.cpp`, built
with g++ at first use and loaded with ctypes), whose pixels equal those
libjpeg-turbo gives cv2, on valid and on damaged streams alike:
`decode(data, name=...)` is cv2's `IMREAD_UNCHANGED` read (gray stays
[H, W], colour and CMYK / YCCK are [H, W, 3], no orientation applied),
`mode="color"` / `"gray"` cv2's colour and grayscale decodes before their
orientation step. Channels are in RGB order.

`source` says whose semantics a read follows where the data ends early.
`"file"` is `cv2.imread`'s: libjpeg's stdio source inserts a fake EOI, so a
truncated file decodes (blocks past the cut grey, a progressive image
block-smoothed). `"buffer"` is `cv2.imdecode`'s: OpenCV's memory source
suspends there and cv2 gives None, which `decode` reports as a ValueError;
only a single-scan image whose scan is whole survives a missing EOI.

`exif_orientation` reads the orientation tag (0x0112) of IFD0 from a JPEG's
APP1 `Exif` segment or from a PNG's `eXIf` chunk, and `orient` applies it as
cv2's `ExifTransform` does; cv2's colour and grayscale reads do both, its
unchanged read neither.

Huffman and arithmetic coding (SOF0-SOF2, SOF9, SOF10) and lossless frames
(SOF3, 2-8 bits; gray, RGB and CMYK, no colour converted) are decoded. The
decoder refuses, with a ValueError naming the file and the marker where
there is one, what cv2 5.0 gives None for: lossless arithmetic (SOF11),
hierarchical frames, 12-bit and 9-16-bit lossless precision, 2 components,
frames without a scan, and every stream that libjpeg refuses.
"""
from __future__ import annotations

import ctypes
import functools
import struct

import numpy as np

from spinnerf_tpu_torch.native import build as _native

_MODES = {"unchanged": None, "color": 3, "gray": 1}   # -> output channels
_SOURCES = {"buffer": 0, "file": 1}                    # -> the decoder's flags
_ERR_LEN = 512


@functools.cache
def _lib() -> ctypes.CDLL:
    """The decoder's library (built at first use), its functions typed."""
    lib = _native.load("jpeg_native")
    vp, i64, i32, buf = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                         ctypes.c_char_p)
    lib.jd_header.restype = ctypes.c_int
    lib.jd_header.argtypes = [buf, i64, i32, vp, vp, i64]
    lib.jd_decode.restype = ctypes.c_int
    lib.jd_decode.argtypes = [buf, i64, i32, i32, vp, i64, vp, i64]
    return lib


def decode(data: bytes, *, name, mode: str = "unchanged",
           source: str = "buffer") -> np.ndarray:
    """uint8 pixels of a JPEG byte string: [H, W] gray or [H, W, 3] RGB
    (`mode`: "unchanged" as the file stores it, "color" always RGB,
    "gray" always [H, W]), read as `cv2.imdecode` (`source="buffer"`) or
    `cv2.imread` (`source="file"`) reads it. Raises ValueError naming
    `name` where that cv2 read gives None or the decoder refuses."""
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {sorted(_MODES)}, got {mode!r}")
    if source not in _SOURCES:
        raise ValueError(f"source must be one of {sorted(_SOURCES)}, got "
                         f"{source!r}")
    data = bytes(data)
    lib, flags = _lib(), _SOURCES[source]
    err = ctypes.create_string_buffer(_ERR_LEN)
    hwc = np.zeros(3, np.int32)
    if lib.jd_header(data, len(data), flags, hwc.ctypes.data,
                     ctypes.addressof(err), _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    h, w, ncomp = (int(v) for v in hwc)
    channels = _MODES[mode] or (1 if ncomp == 1 else 3)
    out = np.empty((h, w, channels) if channels == 3 else (h, w), np.uint8)
    if lib.jd_decode(data, len(data), flags, channels, out.ctypes.data,
                     out.size, ctypes.addressof(err), _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def _tiff_orientation(tiff: bytes) -> int:
    """IFD0's orientation in a TIFF block, as cv2's ExifReader reads it (the
    value's first two bytes, in the block's byte order); 1 where the block
    or the tag is missing or the value is outside 1-8."""
    order = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if order is None or len(tiff) < 8:
        return 1
    if struct.unpack(order + "H", tiff[2:4])[0] != 0x2A:
        return 1
    (ofs,) = struct.unpack(order + "I", tiff[4:8])
    if ofs + 2 > len(tiff):
        return 1
    (n,) = struct.unpack(order + "H", tiff[ofs:ofs + 2])
    for e in range(ofs + 2, ofs + 2 + 12 * n, 12):
        if e + 10 > len(tiff):
            break
        tag, = struct.unpack(order + "H", tiff[e:e + 2])
        if tag == 0x0112:
            (val,) = struct.unpack(order + "H", tiff[e + 8:e + 10])
            return val if 1 <= val <= 8 else 1
    return 1


def _jpeg_exif(data: bytes) -> bytes | None:
    """The TIFF block of the first APP1 `Exif` segment before the first
    scan (other APP1 segments, such as XMP, are passed over as cv2 does)."""
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            return None
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker in (0xDA, 0xD9):
            return None
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        body = data[pos + 4:pos + 2 + length]
        if marker == 0xE1 and body[:6] == b"Exif\x00\x00":
            return body[6:]
        pos += 2 + length
    return None


def exif_orientation(data: bytes) -> int:
    """The EXIF orientation (1-8) of a JPEG file's bytes (the TIFF block of
    its APP1 `Exif` segment) or of a PNG `eXIf` chunk's body (a bare TIFF
    block). 1 where there is none."""
    if data[:2] == b"\xff\xd8":     # a JPEG's SOI
        tiff = _jpeg_exif(data)
        return 1 if tiff is None else _tiff_orientation(tiff)
    return _tiff_orientation(data)


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """img [H, W(, C)] turned as cv2's ExifTransform turns it for EXIF
    orientation 1-8 (5-8 transpose first, then flip)."""
    if orientation >= 5:
        img = img.swapaxes(0, 1)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)
