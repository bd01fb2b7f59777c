"""cv2's INTER_AREA and INTER_NEAREST resizes of float images, in numpy.

The JAX package calls `cv2.resize` where the LaMa stage shrinks an image
pyramid and brings a prediction back to the image's size
(`spinnerf_tpu/pipeline/inpaint2d.py:48-51,166-178,220,299-300`), and where
a mask is brought to its image's size (`:291-293`). The machine with the
card has no cv2, so the same arithmetic is written here as a pair of
separable weight matrices (rows, then columns), built in float64 as cv2
builds its tables and applied in float32:

- INTER_AREA when neither side grows: each output pixel is the mean of the
  source cells it covers, fractional edge cells weighted by their covered
  part (cv2's `computeResizeAreaTab`);
- INTER_AREA when a side grows: cv2 then interpolates linearly on both
  axes, with its own area-mode coefficients (`resizeGeneric` with
  `area_mode`): source index floor(d * scale), weight of the next pixel
  (d + 1) - (s + 1) / scale, fractional part, 0 when not positive; the
  last source pixel taken alone at the border;
- INTER_NEAREST: source index floor(d * src / dst), clamped.

`area_resize_int` is INTER_AREA on uint8 / uint16 pixels (the scene
loader's `minify`), bit for bit: cv2 sums integer blocks when both scales
are whole numbers, and otherwise applies the same fractional weights in
float32, in its order, before rounding to the nearest integer.
"""
from __future__ import annotations

import math

import numpy as np


def _area_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] weights of a shrinking axis (`computeResizeAreaTab`)."""
    scale = 1.0 / (dst / src)
    w = np.zeros((dst, src), np.float64)
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s2 = min(math.floor(f2), src - 1)
        s1 = min(math.ceil(f1), s2)
        if s1 - f1 > 1e-3:
            w[d, s1 - 1] = np.float32((s1 - f1) / cell)
        w[d, s1:s2] = np.float32(1.0 / cell)
        if f2 - s2 > 1e-3:
            w[d, s2] = np.float32(min(f2 - s2, 1.0, cell) / cell)
    return w


def _area_tab(src: int, dst: int):
    """`computeResizeAreaTab` as cv2 walks it: [dst, K] source indices and
    float32 weights of each output pixel, in increasing source order,
    padded with weight 0 (adding 0 leaves a float32 sum unchanged)."""
    w = _area_weights(src, dst)
    nz = w != 0
    idx = np.zeros((dst, int(nz.sum(1).max())), np.int64)
    wt = np.zeros(idx.shape, np.float32)
    for d in range(dst):
        s = np.flatnonzero(nz[d])
        idx[d, :len(s)] = s
        wt[d, :len(s)] = w[d, s]
    return idx, wt


def _linear_area_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] weights of an axis under cv2's area-mode linear
    interpolation (taken when either axis grows)."""
    scale = 1.0 / (dst / src)
    inv = dst / src
    w = np.zeros((dst, src), np.float64)
    for d in range(dst):
        s = math.floor(d * scale)
        f = float(np.float32((d + 1) - (s + 1) * inv))
        f = 0.0 if f <= 0 else f - math.floor(f)
        if s >= src - 1:
            s, f = src - 1, 0.0
        w[d, s] += np.float32(1.0 - f)
        if f:
            w[d, s + 1] += np.float32(f)
    return w


def _apply(img: np.ndarray, wy: np.ndarray, wx: np.ndarray) -> np.ndarray:
    a = np.asarray(img, np.float32)
    sh, sw = a.shape[:2]
    rows = wy.astype(np.float32) @ a.reshape(sh, -1)          # [h, sw * C]
    rows = rows.reshape(len(wy), sw, -1).transpose(0, 2, 1)   # [h, C, sw]
    out = (rows @ wx.astype(np.float32).T).transpose(0, 2, 1)  # [h, w, C]
    return np.ascontiguousarray(out).reshape((len(wy), len(wx))
                                             + a.shape[2:])


def area_resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """`cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)` of a float
    image [H, W] or [H, W, C], in float32."""
    sh, sw = img.shape[:2]
    if h <= sh and w <= sw:
        return _apply(img, _area_weights(sh, h), _area_weights(sw, w))
    return _apply(img, _linear_area_weights(sh, h),
                  _linear_area_weights(sw, w))


def area_resize_int(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """`cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)` of a uint8
    or uint16 image [H, W] or [H, W, C] that neither side grows, bit for
    bit.

    Both scales whole (`resizeAreaFast_`): each block's integer sum, as
    (sum + 2) >> 2 for 2 x 2 blocks of 1, 3 or 4 channels (its vector
    path), else sum * float32(1 / area) rounded to the nearest, ties to
    even. Otherwise (`ResizeArea_Invoker`): each source row's float32 sum
    of pixel * weight over the columns, then each output row's float32
    sum of weight * row, both in `_area_tab`'s order, rounded the same
    way and saturated."""
    sh, sw = img.shape[:2]
    if h > sh or w > sw:
        raise ValueError(f"area_resize_int shrinks only: {sw} x {sh} to "
                         f"{w} x {h}")
    top = np.iinfo(img.dtype).max
    sx, sy = sw / w, sh / h
    if sx == int(sx) and sy == int(sy):
        sx, sy = int(sx), int(sy)
        s = img.reshape(h, sy, w, sx, *img.shape[2:]).astype(np.int64) \
            .sum(axis=(1, 3))
        cn = img.shape[2] if img.ndim == 3 else 1
        if sx == sy == 2 and cn in (1, 3, 4):
            return ((s + 2) >> 2).astype(img.dtype)
        scale = np.float32(1.0) / np.float32(sx * sy)
        out = np.rint(s.astype(np.float32) * scale)
        return np.clip(out, 0, top).astype(img.dtype)
    a = np.asarray(img, np.float32)
    trail = (1,) * (a.ndim - 2)
    ix, wx = _area_tab(sw, w)
    buf = np.zeros((sh, w) + a.shape[2:], np.float32)
    for k in range(ix.shape[1]):
        buf = buf + a[:, ix[:, k]] * wx[:, k].reshape((1, w) + trail)
    iy, wy = _area_tab(sh, h)
    out = np.zeros((h, w) + a.shape[2:], np.float32)
    for k in range(iy.shape[1]):
        out = out + buf[iy[:, k]] * wy[:, k].reshape((h, 1) + trail)
    return np.clip(np.rint(out), 0, top).astype(img.dtype)


def nearest_resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """`cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)`: source
    index floor(i * src / dst), clamped to the last row / column."""
    sh, sw = img.shape[:2]
    rows = np.minimum(np.floor(np.arange(h) * (sh / h)).astype(np.int64),
                      sh - 1)
    cols = np.minimum(np.floor(np.arange(w) * (sw / w)).astype(np.int64),
                      sw - 1)
    return img[rows][:, cols]
