"""Synthetic plane-and-ball world, rendered analytically in numpy, and a
scene directory of it in the SPIn-NeRF disk layout (port of
`spinnerf_tpu/data/synthetic.py`).

A checkerboard ground plane (z = 0) with a colored ball floating above it.
`render_view` gives a view's RGB, camera-z depth and ball mask, so a scene
can be built in memory; `make_scene` writes one to disk (images, masks, the
ball-free "inpainted" RGB and disparity, poses_bounds.npy and a COLMAP
sparse model), PNGs through `eval.render.write_png`.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from spinnerf_tpu_torch.data import colmap
from spinnerf_tpu_torch.eval.render import write_png

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


def make_scene(out_dir, *, n_views: int = 10, h: int = 80, w: int = 100,
               focal: float | None = None, factor: int = 1,
               n_points: int = 600, seed: int = 0,
               mask_views=None, gt_mask_subdir: str | None = None,
               n_gt: int = 0):
    """Render and write the scene; returns its directory. The files decode
    to the JAX package's `make_scene` pixels and arrays for the same
    arguments.

    mask_views: only these views get a `label/` mask (the MVSeg bootstrap
      setting). gt_mask_subdir: also write every view's exact object mask
      into this directory (e.g. "label_full"). n_gt: the first n_gt views
      are rendered without the object (the object-removed ground-truth views
      of the SPIn-NeRF evaluation); their `label/` masks still mark where
      the object would be.
    """
    def to8(a):
        return (a * 255).astype(np.uint8)

    rng = np.random.RandomState(seed)
    out = Path(out_dir)
    focal = focal if focal is not None else 1.2 * w

    img_dir = out / "images"
    fdir = out / (f"images_{factor}" if factor != 1 else "images")
    lama_dir = fdir / "lama_images"
    label_dir = fdir / "label"
    depth_dir = fdir / "depth"
    for d in (img_dir, fdir, lama_dir, label_dir, depth_dir):
        d.mkdir(parents=True, exist_ok=True)

    hh, ww = h // factor, w // factor
    ff = focal / factor

    poses, rows, names = [], [], []
    zdepths = []
    for v in range(n_views):
        th = 2 * np.pi * v / n_views
        pos = np.array([3.5 * np.cos(th), 3.5 * np.sin(th),
                        2.0 + 0.3 * np.sin(3 * th)])
        c2w = look_at_pose(pos, target=(0, 0, 0.3))
        poses.append(c2w)
        name = f"view{v:03d}.png"
        names.append(name)

        is_gt = v < n_gt
        rgb, t, _ = render_view(c2w, h, w, focal, with_ball=not is_gt)
        write_png(img_dir / name, to8(rgb))
        rgb_ball, t_ball, hit_f = render_view(c2w, hh, ww, ff, with_ball=True)
        rgb_nb, t_nb, _ = render_view(c2w, hh, ww, ff, with_ball=False)
        rgb_f = rgb_nb if is_gt else rgb_ball
        write_png(fdir / name, to8(rgb_f))
        write_png(lama_dir / name, to8(rgb_nb))
        if is_gt or mask_views is None or v in mask_views:
            write_png(label_dir / name, to8(hit_f))
        if gt_mask_subdir is not None:
            gt_dir = fdir / gt_mask_subdir
            gt_dir.mkdir(exist_ok=True)
            write_png(gt_dir / name, to8(hit_f))
        # the "inpainted" disparity: 1/z of the ball-free world, normalized
        disp = 1.0 / np.clip(t_nb, 1e-3, None)
        write_png(depth_dir / name, to8(disp / disp.max()))
        zdepths.append(t[np.isfinite(t)])

    # poses_bounds.npy: [down, right, backward | t | hwf] + bounds
    for v, c2w in enumerate(poses):
        r, u, b, t3 = c2w[:, 0], c2w[:, 1], c2w[:, 2], c2w[:, 3]
        m = np.stack([-u, r, b, t3], axis=1)
        m = np.concatenate([m, np.array([[h], [w], [focal]])], axis=1)
        z = zdepths[v]
        rows.append(np.concatenate(
            [m.ravel(), [np.percentile(z, 1), np.percentile(z, 99.5)]]))
    np.save(out / "poses_bounds.npy", np.stack(rows))

    # the COLMAP sparse model: points on the plane outside the ball's
    # footprint
    sparse = out / "sparse" / "0"
    sparse.mkdir(parents=True, exist_ok=True)
    pts_xy = rng.uniform(-2.5, 2.5, size=(n_points, 2))
    keep = np.linalg.norm(pts_xy, axis=1) > BALL_RADIUS * 1.4
    pts = np.concatenate([pts_xy[keep],
                          np.full((keep.sum(), 1), PLANE_Z)], axis=1)

    cameras = {1: colmap.Camera(1, "SIMPLE_PINHOLE", w, h,
                                np.array([focal, w / 2, h / 2]))}
    images, cm_points = {}, {}
    tracks: dict[int, list] = {i: [] for i in range(len(pts))}
    for v, c2w in enumerate(poses):
        # COLMAP's camera frame: x right, y down, z forward
        r_nerf = c2w[:3, :3]
        r_colmap_c2w = np.stack([r_nerf[:, 0], -r_nerf[:, 1], -r_nerf[:, 2]],
                                1)
        w2c_r = r_colmap_c2w.T
        w2c_t = -w2c_r @ c2w[:3, 3]
        cam_pts = pts @ w2c_r.T + w2c_t
        z = cam_pts[:, 2]
        x = focal * cam_pts[:, 0] / z + w / 2
        y = focal * cam_pts[:, 1] / z + h / 2
        vis = (z > 0.1) & (x >= 0) & (x < w) & (y >= 0) & (y < h)
        idxs = np.where(vis)[0]
        xys = np.stack([x[idxs], y[idxs]], -1)
        ids = idxs.astype(np.int64) + 1
        for k, pid in enumerate(ids):
            tracks[pid - 1].append((v + 1, k))
        images[v + 1] = colmap.Image(
            v + 1, colmap.rotmat_to_qvec(w2c_r), w2c_t, 1, names[v],
            xys, ids)
    for i, p in enumerate(pts):
        tr = tracks[i]
        if not tr:
            continue
        cm_points[i + 1] = colmap.Point3D(
            i + 1, p, np.array([128, 128, 128], np.uint8),
            float(rng.uniform(0.2, 1.0)),
            np.array([t[0] for t in tr], np.int32),
            np.array([t[1] for t in tr], np.int32))
    # drop the points without a track from the image records
    live = set(cm_points)
    for im in images.values():
        mask = np.array([pid in live for pid in im.point3d_ids])
        images[im.id] = colmap.Image(im.id, im.qvec, im.tvec, im.camera_id,
                                     im.name, im.xys[mask],
                                     im.point3d_ids[mask])

    colmap.write_cameras_binary(cameras, sparse / "cameras.bin")
    colmap.write_images_binary(images, sparse / "images.bin")
    colmap.write_points3d_binary(cm_points, sparse / "points3D.bin")
    return out
