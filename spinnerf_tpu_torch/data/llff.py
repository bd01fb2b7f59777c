"""LLFF-style scenes: the `Scene` container, the loader of a scene directory
(poses_bounds.npy and the images / label / depth directories), the pose math
and the view split (port of `spinnerf_tpu/data/llff.py`).

Disk layout (the reference's `README.md:32-51`):
  scene/poses_bounds.npy        [N,17] LLFF poses + depth bounds
  scene/images/                 full-size originals
  scene/images_<f>/             factor-f downsampled RGB
  scene/images_<f>/label/       object masks (nonzero = inpaint region)
  scene/images_<f>/depth/       LaMa-inpainted disparity maps (uint8)
  scene/images_<f>/lama_images/ LaMa-inpainted RGB
  scene/sparse/0/*.bin          COLMAP model

The machine with the card has neither cv2 nor PIL: PNG files are decoded by
`eval.render.read_png`, and the three cv2 operations the JAX loader uses are
computed here with the same results: `minify` (INTER_AREA: cv2's block
means and fractional weights with its integer rounding), `dilate_mask`
(5 x 5, 5 iterations) and `resize_nearest` (INTER_NEAREST, from
`utils/resize.py`).
Other image formats (JPEG) go through cv2, imported when such a file is
read.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from spinnerf_tpu_torch.eval.render import read_png, write_png
from spinnerf_tpu_torch.utils.resize import (area_resize_int,
                                              nearest_resize as resize_nearest)

IMG_EXTS = (".jpg", ".jpeg", ".png", ".JPG", ".JPEG", ".PNG")


@dataclass
class Scene:
    """A loaded scene, everything as numpy (host) arrays."""
    images: np.ndarray            # [N, H, W, 3] float32 in [0,1]
    poses: np.ndarray             # [N, 3, 4] c2w (LLFF world frame)
    bounds: np.ndarray            # [N, 2] per-view near/far
    render_poses: np.ndarray      # [M, 3, 4] spiral/eval path
    hwf: tuple                    # (H, W, focal)
    i_holdout: int                # closest-to-mean view
    masks: np.ndarray | None = None            # [N, H, W]; >0 inpaint region,
    #                                            <0 view excluded from masked sup.
    inpainted_depths: np.ndarray | None = None  # [N, H, W] float32 in [0,1]
    mask_indices: list = field(default_factory=list)
    masks_gt: np.ndarray | None = None         # [N, H, W] GT masks (MVSeg eval)
    scale: float = 1.0            # world rescale applied (1/(min_bd*bd_factor))

    @property
    def near(self) -> float:
        return float(self.bounds.min()) * 0.9

    @property
    def far(self) -> float:
        return float(self.bounds.max()) * 1.0


# --- images -------------------------------------------------------------------

def _list_images(d: Path):
    return sorted(p for p in d.iterdir()
                  if p.suffix in IMG_EXTS
                  and "cutout" not in p.name and "pseudo" not in p.name)


def imread(path) -> np.ndarray:
    """An image file's pixels as `cv2.imread(path, IMREAD_UNCHANGED)` gives
    them, in RGB(A) channel order: PNG through `read_png`, other formats
    through cv2 (raises naming the file where cv2 is absent)."""
    path = Path(path)
    if path.suffix.lower() == ".png":
        return read_png(path)
    try:
        import cv2
    except ImportError:
        raise RuntimeError(f"{path}: reading {path.suffix} files needs cv2, "
                           f"which is not installed (PNG files are read "
                           f"without it)") from None
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGRA2RGBA if img.shape[2] == 4
                           else cv2.COLOR_BGR2RGB)
    return img


def imread_float(path) -> np.ndarray:
    """Read an image as float32 RGB in [0, 1] (grayscale repeated, alpha
    dropped; 16-bit images over 65535)."""
    img = imread(path)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img[..., :3].astype(np.float32) / np.float32(
        65535.0 if img.dtype == np.uint16 else 255.0)


def imread_rgb8(path) -> np.ndarray:
    """uint8 [H, W, 3] as cv2.imread's colour read gives it (in RGB order):
    gray repeated, alpha dropped, 16-bit to its high byte."""
    return to_rgb8(imread(path))


def to_rgb8(img: np.ndarray) -> np.ndarray:
    """`imread_rgb8`'s conversion of pixels as `imread` gives them."""
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img[..., :3]


def imread_gray8(path) -> np.ndarray:
    """uint8 [H, W] as cv2's grayscale read gives it: gray as stored,
    colour by cvtColor's fixed-point luma (R 4899, G 9617, B 1868, >> 14,
    rounded; exact on masks whose channels are equal). cv2's PNG reader
    rounds some colour pixels 1 apart, which moves a mask's 0.5 threshold
    only at gray 127 / 128."""
    img = imread_rgb8(path)
    r, g, b = (img[..., i].astype(np.int64) for i in range(3))
    return ((r * 4899 + g * 9617 + b * 1868 + 8192) >> 14).astype(np.uint8)


def area_downsample(img: np.ndarray, factor: int) -> np.ndarray:
    """cv2.resize(img, (W // f, H // f), INTER_AREA) of a uint8 or uint16
    image, bit for bit (`utils/resize.py::area_resize_int`): block means
    where both scales are whole, cv2's fractional weights elsewhere."""
    h, w = img.shape[:2]
    return area_resize_int(img, h // factor, w // factor)


def minify(scene_dir, factor: int):
    """Create `images_<factor>/` by area-downsampling `images/` (PNG files;
    no-op if the directory exists). Returns the directory."""
    scene_dir = Path(scene_dir)
    out_dir = scene_dir / f"images_{factor}"
    if out_dir.exists():
        return out_dir
    src_dir = scene_dir / "images"
    out_dir.mkdir(parents=True)
    for p in _list_images(src_dir):
        write_png(out_dir / (p.stem + ".png"),
                  area_downsample(imread(p), factor))
    return out_dir


def dilate_mask(mask: np.ndarray, kernel: int = 5, iterations: int = 5):
    """cv2.dilate(mask, ones(k, k), iterations=n), the SPIn-NeRF mask growing
    (5 x 5, 5 iterations): n dilations by a k x k square are one max filter
    of side n (k - 1) + 1, and cv2's default border never wins a max, as
    max_pool2d's implicit -inf padding does not."""
    side = iterations * (kernel - 1) + 1
    m = torch.from_numpy(np.ascontiguousarray(mask, np.float32))[None, None]
    out = torch.nn.functional.max_pool2d(m, side, stride=1,
                                         padding=side // 2)
    return out[0, 0].numpy().astype(mask.dtype)


# --- pose math ----------------------------------------------------------------

def _normalize(v):
    return v / np.linalg.norm(v)


def view_matrix(z, up, pos):
    """Camera-to-world basis from forward (z), up hint, and position."""
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], axis=1)


def average_pose(poses):
    """Mean camera: average center, average viewing dir, average up."""
    center = poses[:, :3, 3].mean(0)
    z = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return view_matrix(z, up, center)


def recenter_poses(poses):
    """Rigidly transform all poses so the average pose is the identity."""
    c2w = np.eye(4)
    c2w[:3] = average_pose(poses)
    bottom = np.tile(np.array([0, 0, 0, 1.0])[None, None], (len(poses), 1, 1))
    poses44 = np.concatenate([poses[:, :3, :4], bottom], axis=1)
    out = (np.linalg.inv(c2w) @ poses44)[:, :3, :4]
    return out.astype(poses.dtype)


def spiral_path(poses, bounds, n_views: int = 120, n_rots: int = 2,
                zrate: float = 0.5, dt: float = 0.75, path_zflat: bool = False):
    """The LLFF spiral render path around the average pose (the reference's
    `load_llff.py:380-408` and `render_path_spiral`)."""
    c2w = average_pose(poses)
    up = _normalize(poses[:, :3, 1].sum(0))
    close, inf_d = bounds.min() * 0.9, bounds.max() * 5.0
    focal = 1.0 / ((1.0 - dt) / close + dt / inf_d)
    rads = np.percentile(np.abs(poses[:, :3, 3]), 90, 0)
    if path_zflat:
        c2w = c2w.copy()
        c2w[:3, 3] += -close * 0.1 * c2w[:3, 2]
        rads[2] = 0.0
        n_rots, n_views = 1, n_views // 2
    rads = np.append(rads, 1.0)
    out = []
    for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n_views + 1)[:-1]:
        c = c2w[:3, :4] @ (np.array([np.cos(theta), -np.sin(theta),
                                     -np.sin(theta * zrate), 1.0]) * rads)
        z = _normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        out.append(view_matrix(z, up, c))
    return np.stack(out).astype(np.float32)


def spherify_poses(poses, bounds):
    """Re-frame an inward-facing 360 capture onto a unit sphere and make a
    circular render path (the reference's `load_llff.py:252-312`)."""
    dirs, origins = poses[:, :3, 2:3], poses[:, :3, 3:4]

    # the point nearest to all camera axes (least squares)
    eye = np.eye(3)
    a = eye - dirs * dirs.transpose(0, 2, 1)
    b = -a @ origins
    center = np.squeeze(-np.linalg.inv((a.transpose(0, 2, 1) @ a).mean(0))
                        @ b.mean(0))

    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = _normalize(up)
    vec1 = _normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = _normalize(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], axis=1)

    bottom = np.tile(np.array([0, 0, 0, 1.0])[None, None], (len(poses), 1, 1))
    poses44 = np.concatenate([poses[:, :3, :4], bottom], 1)
    w2c = np.linalg.inv(np.concatenate([c2w, [[0, 0, 0, 1.0]]], 0))
    reset = (w2c @ poses44)[:, :3, :4]

    rad = np.sqrt(np.mean(np.sum(reset[:, :3, 3] ** 2, -1)))
    sc = 1.0 / rad
    reset[:, :3, 3] *= sc
    bounds = bounds * sc

    centroid = reset[:, :3, 3].mean(0)
    zh = centroid[2]
    radcircle = np.sqrt(max(1.0 - zh ** 2, 1e-6))
    render = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        pos = np.array([radcircle * np.cos(th), radcircle * np.sin(th), zh])
        z = _normalize(pos)
        up2 = np.array([0, 0, -1.0])
        vec0 = _normalize(np.cross(z, up2))
        vec1 = _normalize(np.cross(z, vec0))
        render.append(np.stack([vec0, vec1, z, pos], 1))
    return (reset.astype(np.float32), np.stack(render).astype(np.float32),
            bounds.astype(np.float32))


# --- the loader ---------------------------------------------------------------

def _load_gray_dir(d: Path, img_files, h: int, w: int, norm_max: bool):
    """One float32 [H, W] map per image file from `d/<stem>.png` (the first
    channel in cv2's BGR order, over its max or 255, resized to [h, w] with
    INTER_NEAREST); -1 where the file is missing. Returns (maps, indices of
    the views that have one)."""
    out, idx = [], []
    for i, p in enumerate(img_files):
        f = d / (p.stem + ".png")
        if not f.exists():
            out.append(-np.ones((h, w), np.float32))
            continue
        m = imread(f)
        if m.ndim == 3:
            m = m[..., 2]       # cv2's channel 0 is blue
        m = m.astype(np.float32)
        m = m / (m.max() if norm_max and m.max() > 0 else 255.0)
        if m.shape != (h, w):
            m = resize_nearest(m, h, w)
        out.append(m)
        idx.append(i)
    return np.stack(out), idx


def load_scene(scene_dir, factor: int = 4, *, prepare: bool = False,
               bd_factor: float = 0.75, recenter: bool = True,
               spherify: bool = False, load_inpainted: bool = True,
               lpips_reserve: int | None = 5, lpips_mode: bool = False,
               mask_subdir: str = "label", masks_gt_subdir: str | None = None,
               dilate_iterations: int = 5, path_zflat: bool = False) -> Scene:
    """Load an LLFF / SPIn-NeRF scene directory, as the JAX loader does.

    factor: image downsample factor (`images_<factor>` is made by `minify`
      if missing). prepare: stage-3 mode, the raw RGB of `images_<f>/`
      instead of the inpainted `images_<f>/lama_images/`, and masks never
      flipped negative. lpips_mode: every masked view but number
      `len - lpips_reserve` gets its mask negated (excluded from the masked
      MSE, supervised by the patch LPIPS loss). mask_subdir / masks_gt_subdir:
      the mask and ground-truth mask directories. dilate_iterations: 5 x 5
      dilations of each mask (0 disables)."""
    scene_dir = Path(scene_dir)
    pb = np.load(scene_dir / "poses_bounds.npy")
    poses35 = pb[:, :-2].reshape(-1, 3, 5)
    bounds = pb[:, -2:].astype(np.float32)

    img_dir = (minify(scene_dir, factor) if factor and factor != 1
               else scene_dir / "images")
    rgb_dir = img_dir if prepare else img_dir / "lama_images"
    if not rgb_dir.exists():
        rgb_dir = img_dir   # no inpainted set: the raw RGB

    img_files = _list_images(rgb_dir)
    if len(img_files) == 0:
        raise FileNotFoundError(f"no images in {rgb_dir}")
    n = min(len(img_files), len(poses35))
    img_files, poses35, bounds = img_files[:n], poses35[:n], bounds[:n]

    images = np.stack([imread_float(p)[..., :3] for p in img_files])
    h, w = images.shape[1:3]

    # hwf in poses_bounds is the full size's; the focal of the loaded size
    full_h, full_w, full_f = poses35[0, :, 4]
    focal = float(full_f) * (w / full_w)

    # LLFF stores [down, right, backward]; the NeRF camera is [right, up,
    # backward] (the reference's `load_llff.py:329-330`)
    poses = np.concatenate(
        [poses35[:, :, 1:2], -poses35[:, :, 0:1], poses35[:, :, 2:4]],
        axis=2).astype(np.float32)

    # world rescale so that the nearest depth is ~1 / bd_factor
    sc = 1.0 if bd_factor is None else 1.0 / (float(bounds.min()) * bd_factor)
    poses[:, :3, 3] *= sc
    bounds = bounds * sc

    if recenter:
        poses = recenter_poses(poses)

    if spherify:
        poses, render_poses, bounds = spherify_poses(poses, bounds)
    else:
        render_poses = spiral_path(poses, bounds, path_zflat=path_zflat)

    masks = inpainted_depths = masks_gt = None
    mask_indices: list = []
    mask_dir = img_dir / mask_subdir
    if mask_dir.exists():
        masks, mask_indices = _load_gray_dir(mask_dir, img_files, h, w,
                                             norm_max=True)
        if dilate_iterations > 0:
            for i in mask_indices:
                masks[i] = dilate_mask(masks[i], iterations=dilate_iterations)
        mx = masks.max()
        if mx > 0:
            masks = masks / mx
        if lpips_mode and not prepare and lpips_reserve is not None:
            keep = len(img_files) - lpips_reserve
            for i in mask_indices:
                if i != keep:
                    masks[i] = masks[i] * -1.0

    depth_dir = img_dir / "depth"
    if load_inpainted and depth_dir.exists():
        inpainted_depths, _ = _load_gray_dir(depth_dir, img_files, h, w,
                                             norm_max=False)

    if masks_gt_subdir is not None and (img_dir / masks_gt_subdir).exists():
        masks_gt, _ = _load_gray_dir(img_dir / masks_gt_subdir, img_files, h,
                                     w, norm_max=True)

    # held-out view: the one nearest the average pose (`load_llff.py:417`)
    c2w = average_pose(poses)
    dists = np.sum((c2w[:3, 3] - poses[:, :3, 3]) ** 2, -1)
    i_holdout = int(np.argmin(dists))

    return Scene(images=images, poses=poses[:, :3, :4], bounds=bounds,
                 render_poses=render_poses, hwf=(h, w, focal),
                 i_holdout=i_holdout, masks=masks,
                 inpainted_depths=inpainted_depths,
                 mask_indices=mask_indices, masks_gt=masks_gt, scale=sc)


def train_test_split(n_images: int, *, n_gt: int = 0, train_gt: bool = False,
                     llffhold: int = 0, n_train: int | None = None,
                     train_scene=None, test_scene=None):
    """The reference's view split: N_gt object-removed GT views come first
    and become the test set; with llffhold > 0 and no N_gt the holdout views
    stay inside i_train; `test_scene` overrides the holdout (a single
    negative index means none) and `train_scene` restricts training, both
    before the N_gt logic. Returns (i_train, i_test)."""
    i_all = np.arange(n_images)
    if llffhold > 0:
        i_test = i_all[::llffhold]
    else:
        i_test = np.array([], dtype=int)
    if test_scene:
        i_test = np.asarray(list(test_scene), dtype=int)
        if len(i_test) and i_test[0] < 0:
            i_test = np.array([], dtype=int)
    if train_scene:
        i_train = np.asarray([i for i in train_scene if i not in i_test],
                             dtype=int)
    else:
        i_train = i_all
    if n_gt > 0:
        if train_gt:
            i_test = i_train
            i_train = i_train[:n_gt]
        else:
            i_test = i_train[:n_gt]
            i_train = (i_train[n_gt:] if n_train is None
                       else i_train[n_gt:n_gt + n_train])
    return np.asarray(i_train), np.asarray(i_test)
