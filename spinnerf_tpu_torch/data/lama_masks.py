"""On-the-fly training-mask synthesis for the 2D inpainter (port of
`spinnerf_tpu/data/lama_masks.py`).

Parity: `lama/saicinpainting/training/data/masks.py:22-332` — irregular
brush strokes (line / circle / square), rectangles, the super-resolution
grid, outpainting borders, the "dumb area" centre box, a segmentation-driven
generator, the `LinearRamp` difficulty schedule and the weighted
`MixedMaskGenerator`.

Pure numpy; each generator maps (height, width, rng) -> float32 mask
[H, W] with 1 = hole, drawing from the `np.random.RandomState` in the JAX
package's order, so one seed gives one mask in both packages.

The JAX module draws its strokes with cv2 (`cv2.line` at widths 5-24 and
a filled `cv2.circle`); the card's machine has no cv2, so the rasteriser
below reproduces OpenCV's integer drawing code (`imgproc/src/drawing.cpp`)
for an 8-connected line (LINE_8) at shift 0:

- a thick line is a convex quadrilateral in 16-bit fixed point: the ends
  offset by the rounded normal of half the width (`ThickLine`), its
  outline drawn with the fixed-point DDA (`Line2`, clipped by `clipLine`)
  and its inside filled scanline by scanline (`FillConvexPoly`), plus a
  filled circle of radius (width + 1) // 2 at each end (round caps);
- a filled circle is the midpoint circle's horizontal spans (`Circle`).
"""
from __future__ import annotations

import inspect

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


class LinearRamp:
    """Linear schedule start_value -> end_value over [start_iter, end_iter]
    (`saicinpainting/utils.py:66-79`); ramps mask difficulty in training."""

    def __init__(self, start_value=0.0, end_value=1.0, start_iter=-1,
                 end_iter=0):
        self.start_value = start_value
        self.end_value = end_value
        self.start_iter = start_iter
        self.end_iter = end_iter

    def __call__(self, i):
        if i < self.start_iter:
            return self.start_value
        if i >= self.end_iter:
            return self.end_value
        part = (i - self.start_iter) / (self.end_iter - self.start_iter)
        return self.start_value * (1 - part) + self.end_value * part


# --- OpenCV's integer rasteriser ---------------------------------------------

def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _hline(mask, y, x0, x1):
    """Fill row y from x0 to x1 inclusive, clipped to the image."""
    h, w = mask.shape
    if 0 <= y < h:
        x0, x1 = max(x0, 0), min(x1, w - 1)
        if x0 <= x1:
            mask[y, x0:x1 + 1] = 1.0


def fill_circle(mask, cx: int, cy: int, radius: int):
    """`cv2.circle(mask, (cx, cy), radius, 1.0, thickness=-1)` (LINE_8):
    the midpoint circle's spans, rows cy +- dy over cx +- dx and rows
    cy +- dx over cx +- dy."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        _hline(mask, cy - dy, cx - dx, cx + dx)
        _hline(mask, cy + dy, cx - dx, cx + dx)
        _hline(mask, cy - dx, cx - dy, cx + dy)
        _hline(mask, cy + dx, cx - dy, cx + dy)
        dy += 1
        err += plus
        plus += 2
        step = -1 if err > 0 else 0         # (err <= 0) - 1
        err -= minus & step
        dx += step
        minus -= step & 2


def _clip_line(w: int, h: int, p1, p2):
    """OpenCV's `clipLine` on a fixed-point image of w x h (both already
    scaled): clips the segment in place; False when it misses."""
    right, bottom = w - 1, h - 1
    x1, y1 = p1
    x2, y2 = p2

    def code(x, y):
        return ((x < 0) + (x > right) * 2 + (y < 0) * 4
                + (y > bottom) * 8)
    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _line2(mask, p1, p2):
    """OpenCV's `Line2`: the fixed-point (16-bit) DDA line between p1 and
    p2, one pixel per step of the major axis."""
    h, w = mask.shape
    ok, (x1, y1), (x2, y2) = _clip_line(w << XY_SHIFT, h << XY_SHIFT,
                                        p1, p2)
    if not ok:
        return
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step = XY_ONE
        y_step = _cdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step = _cdiv(dx << XY_SHIFT, ay | 1)
        y_step = XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1

    def put(x, y):
        if 0 <= x < w and 0 <= y < h:
            mask[y, x] = 1.0
    put((x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT)
    if ax > ay:
        x1 >>= XY_SHIFT
        for _ in range(ecount + 1):
            put(x1, y1 >> XY_SHIFT)
            x1 += 1
            y1 += y_step
    else:
        y1 >>= XY_SHIFT
        for _ in range(ecount + 1):
            put(x1 >> XY_SHIFT, y1)
            x1 += x_step
            y1 += 1


def _fill_convex_poly(mask, v):
    """OpenCV's `FillConvexPoly` at shift XY_SHIFT (LINE_8): the outline
    with `_line2`, then each scanline between the two active edges, their
    x stepped in fixed point from the edges' upper vertices."""
    h, w = mask.shape
    n = len(v)
    delta = XY_ONE >> 1
    p0 = v[-1]
    imin = 0
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    for i, p in enumerate(v):
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax = max(ymax, p[1])
        xmax = max(xmax, p[0])
        xmin = min(xmin, p[0])
        _line2(mask, p0, p)
        p0 = p
    xmin, xmax = (xmin + delta) >> XY_SHIFT, (xmax + delta) >> XY_SHIFT
    ymin, ymax = (ymin + delta) >> XY_SHIFT, (ymax + delta) >> XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = n
    # per edge: [idx, di, x, dx, ye]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, n - 1, -XY_ONE, 0, ymin]]
    y = ymin
    while True:
        for e in edge:
            if y >= e[4]:
                idx0 = e[0]
                idx = (idx0 + e[1]) % n
                while edges > 0:
                    edges -= 1
                    ty = (v[idx][1] + delta) >> XY_SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        e[4] = ty
                        e[3] = _cdiv((xe - xs) * 2 + (ty - y),
                                     2 * (ty - y))
                        e[2] = xs
                        e[0] = idx
                        break
                    idx0 = idx
                    idx = (idx + e[1]) % n
                else:
                    edges -= 1          # the C loop's final post-decrement
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0][2] > edge[1][2] else (0, 1)
            _hline(mask, y, (edge[left][2] + delta) >> XY_SHIFT,
                   (edge[right][2] + delta) >> XY_SHIFT)
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def thick_line(mask, p0, p1, thickness: int):
    """`cv2.line(mask, p0, p1, 1.0, thickness)` (LINE_8, thickness > 1):
    the quadrilateral of half-width thickness / 2 around the segment and a
    filled circle of radius (thickness + 1) // 2 at each end."""
    x0, y0 = p0[0] << XY_SHIFT, p0[1] << XY_SHIFT
    x1, y1 = p1[0] << XY_SHIFT, p1[1] << XY_SHIFT
    dx = (x0 - x1) / XY_ONE
    dy = (y1 - y0) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    t = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (t + odd * XY_ONE * 0.5) / np.sqrt(r)
        px, py = int(round(dy * r)), int(round(dx * r))   # cvRound: ties even
        _fill_convex_poly(mask, [(x0 + px, y0 + py), (x0 - px, y0 - py),
                                 (x1 - px, y1 - py), (x1 + px, y1 + py)])
    radius = (t + (XY_ONE >> 1)) >> XY_SHIFT
    fill_circle(mask, p0[0], p0[1], radius)
    fill_circle(mask, p1[0], p1[1], radius)


# --- the generators ----------------------------------------------------------

def irregular_mask(h, w, rng, *, max_angle=4.0, max_len=60, max_width=20,
                   min_times=0, max_times=10, draw_method="line"):
    """Random brush strokes (`make_random_irregular_mask:22-64`).

    draw_method: "line" | "circle" | "square" (`DrawMethod:16-19`)."""
    mask = np.zeros((h, w), np.float32)
    times = rng.randint(min_times, max_times + 1)
    for _ in range(times):
        x = rng.randint(w)
        y = rng.randint(h)
        for _ in range(1 + rng.randint(5)):
            angle = 0.01 + rng.uniform(0, max_angle)
            if rng.rand() < 0.5:
                angle = 2 * np.pi - angle
            length = 10 + rng.randint(max_len)
            width = 5 + rng.randint(max_width)
            x2 = int(np.clip(x + int(length * np.sin(angle)), 0, w - 1))
            y2 = int(np.clip(y + int(length * np.cos(angle)), 0, h - 1))
            if draw_method == "line":
                thick_line(mask, (int(x), int(y)), (x2, y2), int(width))
            elif draw_method == "circle":
                fill_circle(mask, int(x), int(y), int(width))
            elif draw_method == "square":
                r = width // 2
                mask[max(y - r, 0):y + r, max(x - r, 0):x + r] = 1.0
            else:
                raise ValueError(f"unknown draw_method {draw_method!r}")
            x, y = x2, y2
    return mask


def squares_mask(h, w, rng, **kwargs):
    """Irregular walk stamping squares (the `squares_proba` mixture slot)."""
    return irregular_mask(h, w, rng, draw_method="square", **kwargs)


def superres_mask(h, w, rng, *, min_step=2, max_step=4, min_width=1,
                  max_width=3):
    """Periodic row / column stripes (`make_random_superres_mask:118-133`):
    every `step`-th stripe of `width` pixels is a hole in both axes."""
    mask = np.zeros((h, w), np.float32)
    step_x = rng.randint(min_step, max_step + 1)
    width_x = rng.randint(min_width, min(step_x, max_width + 1))
    offset_x = rng.randint(step_x)
    step_y = rng.randint(min_step, max_step + 1)
    width_y = rng.randint(min_width, min(step_y, max_width + 1))
    offset_y = rng.randint(step_y)
    for dy in range(width_y):
        mask[offset_y + dy::step_y] = 1.0
    for dx in range(width_x):
        mask[:, offset_x + dx::step_x] = 1.0
    return mask


class SegmentationMaskGenerator:
    """Object mask from a segmentation model
    (`RandomSegmentationMaskGenerator:104-115`): any
    `segment_fn(image [H, W, 3] float) -> int label map [H, W]`; one random
    non-background segment, or `rectangle_mask` when the image yields none
    (or no image is given)."""

    def __init__(self, segment_fn, *, min_area_frac=0.005,
                 max_area_frac=0.6):
        self.segment_fn = segment_fn
        self.min_area_frac = min_area_frac
        self.max_area_frac = max_area_frac

    def __call__(self, h, w, rng, image=None):
        if image is None:
            return rectangle_mask(h, w, rng)
        labels = np.asarray(self.segment_fn(image))
        ids, counts = np.unique(labels, return_counts=True)
        frac = counts / float(labels.size)
        ok = ids[(frac >= self.min_area_frac) & (frac <= self.max_area_frac)]
        ok = ok[ok != 0]  # 0 = background by convention
        if ok.size == 0:
            return rectangle_mask(h, w, rng)
        pick = ok[rng.randint(ok.size)]
        return (labels == pick).astype(np.float32)


def rectangle_mask(h, w, rng, *, margin=10, bbox_min_size=30,
                   bbox_max_size=100, min_times=0, max_times=3):
    """Random axis-aligned boxes (`make_random_rectangle_mask:83-109`)."""
    mask = np.zeros((h, w), np.float32)
    bbox_max = min(bbox_max_size, h - margin * 2 - 1, w - margin * 2 - 1)
    bbox_min = min(bbox_min_size, bbox_max)
    times = rng.randint(min_times, max_times + 1)
    for _ in range(times):
        bh = rng.randint(bbox_min, bbox_max + 1)
        bw = rng.randint(bbox_min, bbox_max + 1)
        y = rng.randint(margin, max(h - margin - bh, margin) + 1)
        x = rng.randint(margin, max(w - margin - bw, margin) + 1)
        mask[y:y + bh, x:x + bw] = 1.0
    return mask


def outpainting_mask(h, w, rng, *, min_padding_percent=0.04,
                     max_padding_percent=0.25):
    """Mask one or more borders (`OutpaintingMaskGenerator:200-263`)."""
    mask = np.zeros((h, w), np.float32)
    sides = rng.choice(["left", "right", "top", "bottom"],
                       size=rng.randint(1, 5), replace=False)
    for side in sides:
        frac = rng.uniform(min_padding_percent, max_padding_percent)
        if side == "left":
            mask[:, : int(w * frac)] = 1.0
        elif side == "right":
            mask[:, w - int(w * frac):] = 1.0
        elif side == "top":
            mask[: int(h * frac)] = 1.0
        else:
            mask[h - int(h * frac):] = 1.0
    return mask


def dumb_area_mask(h, w, rng, *, min_ratio=0.1, max_ratio=0.5):
    """One centred box of random area ratio (`DumbAreaMaskGenerator`)."""
    mask = np.zeros((h, w), np.float32)
    ratio = rng.uniform(min_ratio, max_ratio)
    bh = int(h * np.sqrt(ratio))
    bw = int(w * np.sqrt(ratio))
    y = (h - bh) // 2
    x = (w - bw) // 2
    mask[y:y + bh, x:x + bw] = 1.0
    return mask


class RampedGenerator:
    """A generator whose named int / float kwargs ramp up with `iter_i`
    (the reference's `ramp_kwargs`, `masks.py:51-102`): each scales from
    `coef * value` to `value` along a `LinearRamp`, ints floored at 1."""

    def __init__(self, gen, ramp: LinearRamp, ramped_kwargs: dict):
        self.gen = gen
        self.ramp = ramp
        self.ramped_kwargs = ramped_kwargs

    def __call__(self, h, w, rng, iter_i=None, **kwargs):
        coef = self.ramp(iter_i) if iter_i is not None else 1.0
        scaled = {k: (max(1, int(v * coef)) if isinstance(v, int)
                      else v * coef)
                  for k, v in self.ramped_kwargs.items()}
        return self.gen(h, w, rng, **scaled, **kwargs)


class MixedMaskGenerator:
    """Weighted mixture of mask generators (`MixedMaskGenerator:252-316`),
    each called as `gen(h, w, rng)` plus `iter_i` and `image` where its
    signature takes them."""

    DEFAULT = ((irregular_mask, 1.0), (rectangle_mask, 1.0),
               (outpainting_mask, 0.3))

    def __init__(self, generators_and_weights=DEFAULT, invert_proba=0.0):
        self.gens = [g for g, _ in generators_and_weights]
        w = np.array([w for _, w in generators_and_weights], np.float64)
        self.probs = w / w.sum()
        self.invert_proba = invert_proba

    def __call__(self, h, w, rng, iter_i=None, image=None):
        gen = self.gens[rng.choice(len(self.gens), p=self.probs)]
        kwargs = {}
        try:
            sig_params = inspect.signature(gen).parameters
        except (TypeError, ValueError):
            sig_params = {}
        if iter_i is not None and "iter_i" in sig_params:
            kwargs["iter_i"] = iter_i
        if image is not None and "image" in sig_params:
            kwargs["image"] = image
        mask = gen(h, w, rng, **kwargs)
        if self.invert_proba > 0 and rng.rand() < self.invert_proba:
            mask = 1.0 - mask
        return mask
