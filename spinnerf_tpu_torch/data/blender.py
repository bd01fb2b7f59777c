"""Blender-synthetic scenes (NeRF `transforms_*.json`; port of
`spinnerf_tpu/data/blender.py`, the reference's `DS_NeRF/load_blender.py:
36-107`): per-split transforms, camera_angle_x -> focal, optional half
resolution, the SPIn-NeRF variant's `mask/m_*.png` object masks and
`object/o_*.png` object images, and the 40-pose spherical render path.

The machine with the card has no cv2: PNGs are decoded by
`eval.render.read_png` (RGBA kept, RGB given an opaque alpha, as cv2's
BGR2RGBA does), masks by `llff.imread_gray8`, and the half-resolution
resizes are `utils/resize.py`'s INTER_AREA (an exact 2 x 2 mean at an even
side) and INTER_NEAREST.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from spinnerf_tpu_torch.data.llff import imread, imread_gray8
from spinnerf_tpu_torch.utils.resize import area_resize, nearest_resize


def _trans_t(t):
    m = np.eye(4)
    m[2, 3] = t
    return m


def _rot_phi(phi):
    m = np.eye(4)
    m[1, 1] = m[2, 2] = np.cos(phi)
    m[1, 2] = -np.sin(phi)
    m[2, 1] = np.sin(phi)
    return m


def _rot_theta(th):
    m = np.eye(4)
    m[0, 0] = m[2, 2] = np.cos(th)
    m[0, 2] = -np.sin(th)
    m[2, 0] = np.sin(th)
    return m


def pose_spherical(theta_deg, phi_deg, radius):
    """c2w on a sphere looking at the origin (blender convention)."""
    c2w = _trans_t(radius)
    c2w = _rot_phi(phi_deg / 180.0 * np.pi) @ c2w
    c2w = _rot_theta(theta_deg / 180.0 * np.pi) @ c2w
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1.0]])
    return flip @ c2w


def _read_rgba(path) -> np.ndarray:
    """[H, W, 4] in RGBA order, as cv2's IMREAD_UNCHANGED and BGR(A)2RGBA
    give it (an RGB file gets alpha 255)."""
    img = imread(path)
    if img.ndim == 2:
        raise ValueError(f"{path}: a Blender frame needs colour channels")
    if img.shape[2] == 3:
        top = np.iinfo(img.dtype).max
        img = np.concatenate([img, np.full(img.shape[:2] + (1,), top,
                                           img.dtype)], axis=-1)
    return img


def load_blender_data(basedir, half_res: bool = False, testskip: int = 1,
                      load_masks: bool = True):
    """Returns (images [N,H,W,4], poses [N,4,4], render_poses, (H,W,focal),
    i_split, masks, objects); an absent mask is -1 everywhere, an absent
    object image 0. Object images keep cv2's unconverted BGR(A) channel
    order, as the JAX loader reads them."""
    basedir = Path(basedir)
    splits = ["train", "val", "test"]
    metas = {s: json.loads((basedir / f"transforms_{s}.json").read_text())
             for s in splits if (basedir / f"transforms_{s}.json").exists()}

    all_imgs, all_poses, counts = [], [], [0]
    masks, objects = [], []
    for s in splits:
        if s not in metas:
            counts.append(counts[-1])
            continue
        meta = metas[s]
        skip = 1 if s == "train" or testskip == 0 else testskip
        for frame in meta["frames"][::skip]:
            fp = basedir / (frame["file_path"] + ".png")
            img = _read_rgba(fp)
            all_imgs.append(img.astype(np.float32) / 255.0)
            all_poses.append(np.array(frame["transform_matrix"], np.float32))

            if load_masks:
                name = Path(frame["file_path"]).name
                mdir = fp.parent / "mask" / f"m_{name}.png"
                odir = fp.parent / "object" / f"o_{name}.png"
                h, w = img.shape[:2]
                if mdir.exists():
                    masks.append((imread_gray8(mdir) > 127)
                                 .astype(np.float32))
                else:
                    masks.append(-np.ones((h, w), np.float32))
                if odir.exists():
                    o = imread(odir)
                    if o.ndim == 3:     # back to cv2's BGR(A) order
                        o = np.concatenate([o[..., 2::-1], o[..., 3:]], -1)
                    objects.append(o.astype(np.float32) / 255.0)
                else:
                    objects.append(np.zeros((h, w, 3), np.float32))
        counts.append(len(all_imgs))

    imgs = np.stack(all_imgs)
    poses = np.stack(all_poses)
    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]

    h, w = imgs.shape[1:3]
    camera_angle_x = float(next(iter(metas.values()))["camera_angle_x"])
    focal = 0.5 * w / np.tan(0.5 * camera_angle_x)

    render_poses = np.stack(
        [pose_spherical(a, -30.0, 4.0)
         for a in np.linspace(-180, 180, 41)[:-1]]).astype(np.float32)

    if half_res:
        h, w, focal = h // 2, w // 2, focal / 2.0
        imgs = np.stack([area_resize(i, h, w) for i in imgs])
        if load_masks and masks:
            masks = [nearest_resize(m, h, w) for m in masks]
            objects = [area_resize(o, h, w) for o in objects]

    masks = np.stack(masks) if load_masks and masks else None
    objects = np.stack(objects) if load_masks and objects else None
    return imgs, poses, render_poses, (h, w, focal), i_split, masks, objects


def composite_white(images):
    """RGBA -> RGB over white (the `--white_bkgd` path,
    `run_nerf.py:1074-1078`)."""
    return images[..., :3] * images[..., 3:] + (1.0 - images[..., 3:])
