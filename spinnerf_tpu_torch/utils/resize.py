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


def nearest_resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """`cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)`: source
    index floor(i * src / dst), clamped to the last row / column."""
    sh, sw = img.shape[:2]
    rows = np.minimum(np.floor(np.arange(h) * (sh / h)).astype(np.int64),
                      sh - 1)
    cols = np.minimum(np.floor(np.arange(w) * (sw / w)).astype(np.int64),
                      sw - 1)
    return img[rows][:, cols]
