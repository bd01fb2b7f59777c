"""JPEG 2000 (ISO/IEC 15444-1, Part 1: J2K codestreams and JP2 files) read
as cv2 5.0 reads it, without cv2.

cv2 reads JPEG 2000 through the OpenJPEG 2.5.3 it bundles
(imgcodecs/src/grfmt_jpeg2000_openjpeg.cpp). `native/j2k_native.cpp`
decodes the file as OpenJPEG does (codestream and JP2 boxes, tier 2, tier 1
on the MQ coder, the 5/3 and 9/7 wavelets, the palette and channel
definitions of a JP2 file) and gives its components; `read` then does what
cv2's decoder does with them:

- the header: 1 to 4 components, none signed, the largest precision at
  least 8 bits, or cv2 gives None; the unchanged read is 8-bit for 8 bits,
  16-bit up to 16 and None past that (cv2 5.0 asks its decoder for float
  samples, which it refuses), with as many
  channels as the codestream has components (after OpenJPEG expands a
  palette the count may differ: cv2 keeps the header's); the colour read
  is 8-bit BGR, the gray read 8-bit, each sample shifted right by the
  largest precision less the output's (8 or 16 bits);
- the colour space: sRGB, or unknown (a J2K codestream, a JP2 file without
  an enumerated colour space), as sRGB: components 0-2 are R, G, B (3 on
  its own is alpha), the gray read of three or more is cvtColor's
  BGR2GRAY and fewer than three components give None in colour; greyscale
  (EnumCS 17): component 0 as gray or copied into three channels; sYCC
  (EnumCS 18): component 0 as gray, or Y, Cb, Cr through cvtColor's
  YUV2BGR; other colour spaces (CMYK, e-YCC) give None;
- None where any component is sub-sampled or starts past the origin (an
  image offset), or where the unchanged read would have 2 channels.

Where cv2 gives None `read` raises ValueError naming the file and saying
so; HTJ2K (Part 15) code-blocks, which OpenJPEG decodes, the port refuses
(ValueError naming HTJ2K and ROADMAP F2).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

from spinnerf_tpu_torch.native import build as _native

_ERR_LEN = 512
_SRGB, _GRAY, _SYCC, _UNKNOWN = 1, 2, 3, -1
_SPACE_NAMES = {0: "unspecified", 4: "e-YCC", 5: "CMYK"}


@functools.cache
def _lib() -> ctypes.CDLL:
    """native/j2k_native.cpp's library (built at first use), typed."""
    lib = _native.load("j2k_native")
    vp, i64, i32, buf = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                         ctypes.c_char_p)
    lib.j2k_header.argtypes = [buf, i64, i32, vp, vp, i64]
    lib.j2k_decode.argtypes = [buf, i64, i32, vp, vp, i64]
    lib.j2k_result.argtypes = [vp, vp, i64, vp, vp, i64]
    lib.j2k_free.argtypes = [vp]
    for fn in (lib.j2k_header, lib.j2k_decode, lib.j2k_result):
        fn.restype = ctypes.c_int
    lib.j2k_free.restype = None
    return lib


def _none(name, why):
    return ValueError(f"{name}: cv2 gives None for this JPEG 2000 image "
                      f"({why})")


def _check(name, rc, err):
    if rc:
        msg = err.value.decode(errors="replace")
        if "HTJ2K" in msg:
            raise ValueError(f"{name}: HTJ2K (Part 15) code-blocks, which the "
                             f"port does not decode (ROADMAP F2)")
        raise _none(name, msg)


def header(data: bytes, name) -> dict:
    """What opj_read_header gives cv2: width, height, components, the
    largest precision, whether a component is signed or HTJ2K-coded."""
    jp2 = data[:4] != b"\xff\x4f\xff\x51"
    info = np.zeros(6, np.int32)
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(name, _lib().j2k_header(data, len(data), int(jp2),
                                   info.ctypes.data, ctypes.addressof(err),
                                   _ERR_LEN), err)
    w, h, nc, prec, sgnd, ht = (int(v) for v in info)
    return dict(jp2=jp2, width=w, height=h, components=nc, precision=prec,
                signed=bool(sgnd), htj2k=bool(ht))


def _decode(data: bytes, jp2: bool, name):
    """opj_decode with the JP2 post-processing: (colour space, [(meta,
    int32 [h, w] or None)])."""
    lib = _lib()
    handle = ctypes.c_void_p()
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(name, lib.j2k_decode(data, len(data), int(jp2),
                                ctypes.addressof(handle),
                                ctypes.addressof(err), _ERR_LEN), err)
    try:
        head = np.zeros(2, np.int32)
        lib.j2k_result(handle, head.ctypes.data, 0, None, None, 0)
        n = int(head[1])
        meta = np.zeros(2 + 7 * n, np.int32)
        lib.j2k_result(handle, meta.ctypes.data, n, None, None, 0)
        comps, ptrs = [], (ctypes.c_void_p * max(n, 1))()
        for c in range(n):
            m = [int(v) for v in meta[2 + 7 * c:9 + 7 * c]]
            arr = np.empty((m[1], m[0]), np.int32) if m[6] else None
            if arr is not None:
                ptrs[c] = arr.ctypes.data
            comps.append((m, arr))
        _check(name, lib.j2k_result(handle, meta.ctypes.data, n, ptrs,
                                    ctypes.addressof(err), _ERR_LEN), err)
    finally:
        lib.j2k_free(handle)
    return int(meta[0]), comps


def _cast(v: np.ndarray, dtype) -> np.ndarray:
    """static_cast<T>(int) as copyToMat does it."""
    return v.astype(np.int64).astype(dtype)


def _bgr2gray(r, g, b):
    """cvtColor's COLOR_BGR2GRAY on 8 bits: 15-bit weights, rounded."""
    r, g, b = (x.astype(np.int64) for x in (r, g, b))
    return ((b * 3735 + g * 19235 + r * 9798 + 16384) >> 15).astype(np.uint8)


def _yuv2rgb(y, u, v, dtype):
    """cvtColor's COLOR_YUV2BGR on 8 or 16 bits (14-bit coefficients),
    channels in RGB order."""
    bits = 8 if dtype == np.uint8 else 16
    delta, top = 1 << (bits - 1), (1 << bits) - 1
    y, u, v = (x.astype(np.int64) for x in (y, u, v))
    u, v = u - delta, v - delta
    b = y + ((u * 33292 + (1 << 13)) >> 14)
    g = y + ((u * -6472 + v * -9519 + (1 << 13)) >> 14)
    r = y + ((v * 18678 + (1 << 13)) >> 14)
    return np.stack([np.clip(x, 0, top) for x in (r, g, b)], -1).astype(dtype)


def read(data: bytes, mode: str, name) -> np.ndarray:
    """cv2.imread / cv2.imdecode of a J2K or JP2 file: `mode` "unchanged",
    "color" or "gray", channels in RGB(A) order (the two sources read
    alike). Raises ValueError where cv2 gives None."""
    hd = header(data, name)
    nc, prec = hd["components"], hd["precision"]
    if not 1 <= nc <= 4:
        raise _none(name, f"{nc} components")
    if hd["signed"]:
        raise _none(name, "a signed component")
    if prec < 8:
        raise _none(name, f"{prec}-bit samples")
    w, h = hd["width"], hd["height"]
    # cv2's validateInputImageSize (CV_IO_MAX_IMAGE_WIDTH / HEIGHT / PIXELS)
    if not (0 < w <= 1 << 20 and 0 < h <= 1 << 20 and w * h <= 1 << 30):
        raise ValueError(f"{name}: image size {w} x {h} is past what cv2 "
                         f"reads")
    if hd["htj2k"]:
        raise ValueError(f"{name}: HTJ2K (Part 15) code-blocks, which the "
                         f"port does not decode (ROADMAP F2)")
    if mode == "unchanged":
        if prec > 16:   # cv2 5.0 asks for float32 / float64, then refuses
            raise _none(name, f"{prec}-bit samples read unchanged")
        dtype, out = (np.uint8 if prec == 8 else np.uint16), nc
    else:
        dtype, out = np.uint8, 3 if mode == "color" else 1
    space, comps = _decode(data, hd["jp2"], name)
    if out == 2:
        raise _none(name, "2 output channels")
    if space not in (_SRGB, _GRAY, _SYCC, _UNKNOWN):
        raise _none(name, f"the {_SPACE_NAMES.get(space, space)} colour "
                          f"space")
    for m, arr in comps:
        cw, ch, dx, dy, x0, y0 = m[:6]
        if (dx, dy, x0, y0, cw, ch) != (1, 1, 0, 0, w, h):
            raise _none(name, "a sub-sampled or offset component")
        if arr is None:
            raise _none(name, "a component without data")
    outprec = 8 if dtype == np.uint8 else 16
    shift = max(prec - outprec, 0)
    planes = [_cast(arr >> shift, dtype) for _, arr in comps]
    nin = len(planes)
    if space in (_SRGB, _UNKNOWN):
        if out == 1:
            if nin <= 2:
                return planes[0]
            return _bgr2gray(*planes[:3])
        if nin < 3:
            raise _none(name, f"{nin} components in sRGB to {out} channels")
        if out > nin:
            raise ValueError(f"{name}: cv2 reads a component past the "
                             f"image's here; the port refuses it")
        return np.ascontiguousarray(np.stack(planes[:out], -1))
    if space == _GRAY:
        if out not in (1, 3):
            raise _none(name, f"greyscale to {out} channels")
        return planes[0] if out == 1 else np.ascontiguousarray(
            np.stack([planes[0]] * 3, -1))
    if out == 1:
        return planes[0]
    if out != 3 or nin < 3:
        raise _none(name, f"sYCC from {nin} components to {out} channels")
    return _yuv2rgb(*planes[:3], dtype)
