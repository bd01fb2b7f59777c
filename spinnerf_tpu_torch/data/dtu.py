"""DTU and NeRD scenes (port of `spinnerf_tpu/data/dtu.py`).

- DTU (`DS_NeRF/load_dtu.py:6-71`): `cameras.npz` of `world_mat_<i>`
  projection matrices P = K [R | t], decomposed into intrinsics and a
  NeRF-frame c2w; images from `image/`.
- NeRD (`DS_NeRF/load_nerd.py:244-326`): an LLFF scene plus `masks/` and,
  when present, object images; the LLFF pose math.

Images are read without cv2 where they are PNGs (`llff.imread_rgb8`, cv2's
colour read in RGB order).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from spinnerf_tpu_torch.data import llff


def decompose_projection(p: np.ndarray):
    """P [3,4] -> (K [3,3] normalized, c2w [3,4] NeRF convention).

    RQ-decompose the left 3x3 (by numpy's QR of the flipped matrix) into K
    (upper triangular, positive diagonal) and R (world -> camera); the
    camera centre is -R^T K^-1 p4. The NeRF frame flips the OpenCV
    camera's y and z axes."""
    m = p[:3, :3]
    rev = np.eye(3)[::-1]
    q, r = np.linalg.qr((rev @ m).T)
    k = rev @ r.T @ rev
    rot = rev @ q.T
    # positive diagonal of K
    sgn = np.diag(np.sign(np.diag(k)))
    k = k @ sgn
    rot = sgn @ rot
    if np.linalg.det(rot) < 0:
        rot = -rot
        k = -k
    k = k / k[2, 2]
    t = np.linalg.inv(k) @ p[:3, 3]
    center = -rot.T @ t
    # OpenCV axes (x right, y down, z forward) -> NeRF (x right, y up, -z)
    r_nerf = np.stack([rot[0], -rot[1], -rot[2]], axis=0).T  # c2w rotation
    c2w = np.concatenate([r_nerf, center[:, None]], axis=1)
    return k, c2w.astype(np.float32)


def load_dtu_data(basedir):
    """Returns (images [N,H,W,3], poses [N,3,4], (H, W, focal))."""
    basedir = Path(basedir)
    cams = np.load(basedir / "cameras.npz")
    img_files = sorted((basedir / "image").glob("*"))
    images, poses, focals = [], [], []
    for i, f in enumerate(img_files):
        images.append(llff.imread_rgb8(f).astype(np.float32) / 255.0)
        k, c2w = decompose_projection(cams[f"world_mat_{i}"][:3, :4])
        poses.append(c2w)
        focals.append((k[0, 0] + k[1, 1]) / 2.0)
    images = np.stack(images)
    h, w = images.shape[1:3]
    return images, np.stack(poses), (h, w, float(np.mean(focals)))


def load_nerd_data(basedir, factor=8, recenter=True, bd_factor=0.75,
                   spherify=False):
    """NeRD layout: an LLFF scene + `masks/`. Returns (images, poses, bds,
    render_poses, i_holdout, masks, objects)."""
    scene = llff.load_scene(basedir, factor=factor, recenter=recenter,
                            bd_factor=bd_factor, spherify=spherify,
                            prepare=True, mask_subdir="masks",
                            dilate_iterations=0, load_inpainted=False)
    objects = None
    obj_dir = Path(basedir) / (f"images_{factor}" if factor != 1
                               else "images") / "objects"
    if obj_dir.exists():
        objs = [llff.imread_rgb8(f).astype(np.float32) / 255.0
                for f in sorted(obj_dir.glob("*.png"))]
        objects = np.stack(objs) if objs else None
    return (scene.images, scene.poses, scene.bounds, scene.render_poses,
            scene.i_holdout, scene.masks, objects)
