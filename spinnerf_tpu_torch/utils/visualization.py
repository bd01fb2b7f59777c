"""Visualization helpers: the i_feat sanity panel and HTML galleries (port
of `spinnerf_tpu/utils/visualization.py`).

The JAX module draws the sanity panel (`run_nerf.py:1581-1597`) with
matplotlib; the card's machine has none, so the port lays the three panels
side by side with numpy, each scaled to [0, 1], and writes them with the
port's PNG writer. `visualize_sigma` and `draw_keypoints` (matplotlib and
cv2) are not ported yet (ROADMAP.md queue A9 / A5).
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
