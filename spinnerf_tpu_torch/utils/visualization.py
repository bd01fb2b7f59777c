"""Visualization helpers: sigma-vs-depth plots, keypoint overlays, the i_feat
sanity panel and HTML galleries (port of
`spinnerf_tpu/utils/visualization.py`).

The card's machine has neither matplotlib nor cv2, so the port draws with
numpy and writes with its own PNG writer: the sanity panel
(`run_nerf.py:1581-1597`) lays its three panels side by side, each scaled
to [0, 1]; `visualize_sigma` rasterises the curve in a frame, without text;
`draw_keypoints` fills each disc pixel for pixel as cv2.circle does.
"""
from __future__ import annotations

import html
from pathlib import Path

import numpy as np

from spinnerf_tpu_torch.eval.metrics import to8b
from spinnerf_tpu_torch.eval.render import write_png


def _unit_range(a):
    """A float map scaled to [0, 1] by its finite min and max (a constant
    map gives 0); NaN and inf give 0."""
    a = np.asarray(a, np.float64)
    finite = np.isfinite(a)
    a = np.where(finite, a, 0.0)
    if not finite.any():
        return a
    lo, hi = a[finite].min(), a[finite].max()
    return (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)


def _resize_nearest(a, h: int, w: int):
    ys = np.arange(h) * a.shape[0] // h
    xs = np.arange(w) * a.shape[1] // w
    return a[ys][:, xs]


# the plot box of `visualize_sigma` in pixels, (left, top, right, bottom):
# matplotlib's default figure (640 x 480) and subplot margins
SIGMA_PLOT_SIZE = (480, 640)
SIGMA_PLOT_BOX = (80, 58, 576, 427)
_CURVE_RGB = (31, 119, 180)      # matplotlib's first line colour


def sigma_plot_coords(sigma, z_vals):
    """Pixel (column, row) floats of the curve's points inside
    SIGMA_PLOT_BOX: each axis spans its finite data range padded by 5 %
    (matplotlib's margins; a constant axis spans +-0.5), rows grow down.
    Points with a non-finite value are dropped."""
    x = np.asarray(z_vals, np.float64).ravel()
    y = np.asarray(sigma, np.float64).ravel()
    keep = np.isfinite(x) & np.isfinite(y)
    x, y = x[keep], y[keep]
    left, top, right, bottom = SIGMA_PLOT_BOX

    def to_unit(a):
        lo, hi = (a.min(), a.max()) if a.size else (0.0, 1.0)
        lo, hi = (lo - 0.5, hi + 0.5) if hi <= lo else (
            lo - 0.05 * (hi - lo), hi + 0.05 * (hi - lo))
        return (a - lo) / (hi - lo)
    return (left + to_unit(x) * (right - left),
            bottom - to_unit(y) * (bottom - top))


def visualize_sigma(sigma, z_vals, filename):
    """Plot density along one ray (the --render_test_ray mode output) as an
    RGB PNG: white, a black frame around SIGMA_PLOT_BOX, the curve's
    segments as one-pixel lines; no axis text. Returns the image [H, W, 3]
    uint8."""
    h, w = SIGMA_PLOT_SIZE
    left, top, right, bottom = SIGMA_PLOT_BOX
    img = np.full((h, w, 3), 255, np.uint8)
    img[top:bottom + 1, [left, right]] = 0
    img[[top, bottom], left:right + 1] = 0
    pts = list(zip(*sigma_plot_coords(sigma, z_vals)))
    for (c0, r0), (c1, r1) in list(zip(pts, pts[1:])) or zip(pts, pts):
        n = int(np.ceil(max(abs(c1 - c0), abs(r1 - r0)))) + 1
        t = np.linspace(0.0, 1.0, n)
        img[np.rint(r0 + t * (r1 - r0)).astype(int),
            np.rint(c0 + t * (c1 - c0)).astype(int)] = _CURVE_RGB
    write_png(filename, img)
    return img


def draw_keypoints(image, coords, radius: int = 2, color=(255, 0, 0)):
    """Overlay keypoints on a float image ([H, W] or [H, W, C] in [0, 1]);
    coords are (x, y), truncated to integers. Each is a filled disc drawn
    as cv2.circle(img, (x, y), radius, color, -1) draws it on the 8-bit
    image: the horizontal spans of its midpoint circle, clipped to the
    image. Returns the float32 image."""
    img = (np.clip(np.asarray(image), 0, 1) * 255).astype(np.uint8).copy()
    h, w = img.shape[:2]
    fill = (np.asarray(color, np.uint8)[:img.shape[2]] if img.ndim == 3
            else np.uint8(color[0]))

    def span(y, x0, x1):
        if 0 <= y < h and x0 < w and x1 >= 0:
            img[y, max(x0, 0):min(x1, w - 1) + 1] = fill

    for x, y in np.asarray(coords):
        cx, cy = int(x), int(y)
        # cv2's `Circle` (drawing.cpp), thickness < 0 and LINE_8
        err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
        while dx >= dy:
            span(cy - dy, cx - dx, cx + dx)
            span(cy + dy, cx - dx, cx + dx)
            span(cy - dx, cx - dy, cx + dy)
            span(cy + dx, cx - dy, cx + dy)
            dy += 1
            err += plus
            plus += 2
            step = -1 if err > 0 else 0
            err -= minus & step
            dx += step
            minus -= step & 2
    return img.astype(np.float32) / 255.0


def sanity_panel(rgb, inpainted_depth, disp, filename):
    """The reference's per-i_feat 3-panel debug image: the render, the
    inpainted depth prior and the rendered disparity side by side, at the
    render's size (the prior taken nearest-neighbour), as an 8-bit RGB PNG.
    Returns the panel [H, 3W, 3] in [0, 1]."""
    rgb = np.clip(np.nan_to_num(np.asarray(rgb, np.float64)), 0.0, 1.0)
    h, w = rgb.shape[:2]
    gray = [_unit_range(_resize_nearest(np.asarray(m), h, w))
            for m in (inpainted_depth, disp)]
    panel = np.concatenate(
        [rgb] + [np.repeat(g[..., None], 3, -1) for g in gray], axis=1)
    write_png(filename, to8b(panel))
    return panel


def write_gallery(out_path, rows, title: str = "spinnerf results"):
    """Write a self-contained HTML image gallery.

    Args:
      rows: list of (label, [image paths relative to out_path's dir]).
    """
    out_path = Path(out_path)
    parts = [f"<!doctype html><html><head><meta charset='utf-8'>"
             f"<title>{html.escape(title)}</title>"
             "<style>body{font-family:sans-serif;background:#111;color:#eee}"
             "img{max-height:220px;margin:4px;border-radius:4px}"
             "h2{margin:12px 4px 2px}</style></head><body>"
             f"<h1>{html.escape(title)}</h1>"]
    for label, paths in rows:
        parts.append(f"<h2>{html.escape(str(label))}</h2><div>")
        for p in paths:
            parts.append(f"<img src='{html.escape(str(p))}' "
                         f"title='{html.escape(str(p))}'>")
        parts.append("</div>")
    parts.append("</body></html>")
    out_path.write_text("".join(parts))
    return out_path
