"""Synthetic plane-and-ball world, rendered analytically in numpy (port of
`spinnerf_tpu/data/synthetic.py` without its file writer `make_scene`).

A checkerboard ground plane (z = 0) with a colored ball floating above it.
`render_view` gives a view's RGB, camera-z depth and ball mask, so a scene
can be built in memory.
"""
from __future__ import annotations

import numpy as np

BALL_CENTER = np.array([0.0, 0.0, 0.6])
BALL_RADIUS = 0.5
PLANE_Z = 0.0


def look_at_pose(pos, target=(0, 0, 0), up=(0, 0, 1.0)):
    """NeRF-convention c2w ([right, up, backward] columns, camera looks -z)."""
    pos = np.asarray(pos, np.float64)
    fwd = pos - np.asarray(target, np.float64)   # backward = +z column
    fwd /= np.linalg.norm(fwd)
    right = np.cross(np.asarray(up, np.float64), fwd)
    right /= np.linalg.norm(right)
    true_up = np.cross(fwd, right)
    return np.stack([right, true_up, fwd, pos], axis=1)  # [3, 4]


def _checker(p, scale=1.5):
    c = (np.floor(p[..., 0] * scale) + np.floor(p[..., 1] * scale)) % 2
    return np.stack([0.25 + 0.5 * c, 0.45 + 0.25 * c, 0.7 - 0.3 * c], axis=-1)


def trace(rays_o, rays_d, with_ball: bool = True):
    """Analytic raytrace of the plane+ball world: (rgb [N,3], zdepth [N],
    hit_ball [N] bool); zdepth is the NeRF `z_val` of the hit (inf on a miss,
    where the background is white)."""
    o, d = rays_o, rays_d
    n = o.shape[0]
    rgb = np.ones((n, 3), np.float32)
    t_hit = np.full(n, np.inf)

    with np.errstate(divide="ignore", invalid="ignore"):
        t_plane = (PLANE_Z - o[:, 2]) / d[:, 2]
    ok = (t_plane > 1e-6) & np.isfinite(t_plane)
    p = o + t_plane[:, None] * d
    rgb[ok] = _checker(p[ok])
    t_hit[ok] = t_plane[ok]

    hit_ball = np.zeros(n, bool)
    if with_ball:
        oc = o - BALL_CENTER
        b = np.sum(oc * d, -1)
        c = np.sum(oc * oc, -1) - BALL_RADIUS ** 2
        a = np.sum(d * d, -1)
        disc = b * b - a * c
        ok_b = disc > 0
        t_ball = np.where(ok_b, (-b - np.sqrt(np.maximum(disc, 0))) / a, np.inf)
        ok_b &= (t_ball > 1e-6) & (t_ball < t_hit)
        pb = o + np.where(np.isfinite(t_ball), t_ball, 0.0)[:, None] * d
        nrm = (pb - BALL_CENTER) / BALL_RADIUS
        shade = 0.6 + 0.4 * np.clip(nrm[:, 2], 0, 1)
        ball_rgb = np.stack([0.85 * shade, 0.25 * shade, 0.2 * shade], -1)
        rgb[ok_b] = ball_rgb[ok_b]
        t_hit[ok_b] = t_ball[ok_b]
        hit_ball = ok_b

    return rgb.astype(np.float32), t_hit, hit_ball


def render_view(c2w, h, w, focal, with_ball=True):
    """(rgb [h,w,3], zdepth [h,w], hit_ball [h,w]) of one camera."""
    i, j = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32), indexing="xy")
    dirs = np.stack([(i - w * 0.5) / focal, -(j - h * 0.5) / focal,
                     -np.ones_like(i)], -1).reshape(-1, 3)
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)
    rgb, t, hit = trace(rays_o, rays_d, with_ball)
    return (rgb.reshape(h, w, 3), t.reshape(h, w), hit.reshape(h, w))
