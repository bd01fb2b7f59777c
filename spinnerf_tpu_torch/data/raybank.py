"""Ray banks: image/pose stacks plus per-group pixel indices on the
trainer's device, sampled into ray batches each step (port of
`spinnerf_tpu/data/raybank.py`).

Rays are never materialized: a bank stores the images, poses and labels and
one (view, row, col) index array per supervision group; a step draws indices
and computes the rays on the device.

Groups: rgb (label == 1; all pixels in prepare/train-GT mode), clf
(label == 0; all pixels in prepare mode), inp (label != 0, with the
inpainted disparity as target), depth (COLMAP sparse-depth rays).

Under data parallelism (`mesh=`) every rank draws a group's whole batch
from the same generator and keeps its contiguous 1/N of it, so the ranks
together hold what one rank would, group by group.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from spinnerf_tpu_torch import resolve_device
from spinnerf_tpu_torch.core import rays as ray_lib
from spinnerf_tpu_torch.parallel.mesh import pad_to_multiple


@dataclass(frozen=True)
class RayGroup:
    """Index set for one supervision group: `idx` [K, 3] int64 (view, row,
    col), padded; `count` rows are real."""
    idx: Any
    count: int


@dataclass(frozen=True)
class DepthRayGroup:
    view: Any         # [K] int64
    coord: Any        # [K, 2] float32 (x, y) pixel coords
    depth: Any        # [K] float32 target depth
    weight: Any       # [K] float32 reprojection-error weight
    count: int
    max_depth: float


@dataclass(frozen=True)
class RayBank:
    images: Any            # [N, H, W, 3] float32
    poses: Any             # [N, 3, 4] float32
    labels: Any            # [N, H, W] float32 mask labels (+1/0/-1)
    inp_depths: Any | None  # [N, H, W] float32 inpainted disparity (or None)
    groups: dict           # name -> RayGroup
    depth_group: DepthRayGroup | None
    hwf: tuple             # (H, W, focal)
    near: float
    far: float
    ndc: bool

    @property
    def device(self):
        return self.images.device


def _pad_idx(idx: np.ndarray, multiple: int = 1024):
    """Pad index rows to a multiple (the JAX bank's shapes)."""
    k = len(idx)
    if k == 0:
        return np.zeros((multiple, idx.shape[1]), np.int64), 0
    padded_len = ((k + multiple - 1) // multiple) * multiple
    pad = np.zeros((padded_len - k, idx.shape[1]), idx.dtype)
    return np.concatenate([idx, pad]).astype(np.int64), k


def build_raybank(scene, i_train, *, depth_list=None, prepare: bool = False,
                  train_gt: bool = False, ndc: bool = False,
                  near: float | None = None, far: float | None = None,
                  semantic: bool = False, device=None) -> RayBank:
    """Assemble a RayBank from a `llff.Scene` on `device`.

    depth_list: per-view sparse-depth dicts ({"coord", "depth", "weight"}),
    indexed by scene view id; outside prepare mode, points inside the
    object mask are dropped. The groups are pre-shuffled with the fixed
    generator `np.random.default_rng(0xC0FFEE)`, in the JAX bank's order, so
    epoch batches are identical to the JAX package's. near / far: the
    dataset's constants (blender, dtu); None takes NDC's (0, 1) or the
    scene's bounds."""
    device = resolve_device(device)
    h, w, focal = scene.hwf
    i_train = np.asarray(i_train)
    images = scene.images[i_train]
    poses = scene.poses[i_train]
    if scene.masks is not None:
        labels = scene.masks[i_train].astype(np.float32)
    else:
        labels = np.zeros(images.shape[:3], np.float32)
    inp = (scene.inpainted_depths[i_train].astype(np.float32)
           if scene.inpainted_depths is not None else None)

    def dev(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    n = len(i_train)
    vv, rr, cc = np.meshgrid(np.arange(n), np.arange(h), np.arange(w),
                             indexing="ij")
    all_idx = np.stack([vv, rr, cc], axis=-1).reshape(-1, 3)
    flat_labels = labels.reshape(-1)

    if semantic:
        group_idx = (("rgb", all_idx), ("clf", all_idx),
                     ("seg", all_idx[flat_labels >= 0]),
                     ("inp", all_idx[flat_labels != 0]))
    elif prepare or train_gt:
        group_idx = (("rgb", all_idx), ("clf", all_idx),
                     ("inp", all_idx[flat_labels != 0]))
    else:
        group_idx = (("rgb", all_idx[flat_labels == 1]),
                     ("clf", all_idx[flat_labels == 0]),
                     ("inp", all_idx[flat_labels != 0]))

    groups = {}
    cache = {}   # groups sharing a source array share one buffer (as in JAX)
    shuffle_rng = np.random.default_rng(0xC0FFEE)
    for name, idx in group_idx:
        key = id(idx)
        if key not in cache:
            idx = idx[shuffle_rng.permutation(len(idx))] if len(idx) else idx
            padded, count = _pad_idx(idx)
            cache[key] = RayGroup(idx=dev(padded, torch.int64), count=count)
        groups[name] = cache[key]

    depth_group = None
    if depth_list is not None:
        views, coords, depths, weights = [], [], [], []
        for bank_v, scene_v in enumerate(i_train):
            d = depth_list[scene_v]
            coord = np.asarray(d["coord"], np.float32).reshape(-1, 2)
            depth = np.asarray(d["depth"], np.float32).reshape(-1)
            weight = np.asarray(d["weight"], np.float32).reshape(-1)
            if scene.masks is not None and not prepare:
                r = np.clip(coord[:, 1].astype(int), 0, h - 1)
                c = np.clip(coord[:, 0].astype(int), 0, w - 1)
                keep = scene.masks[scene_v][r, c] == 0
                coord, depth, weight = coord[keep], depth[keep], weight[keep]
            views.append(np.full(len(depth), bank_v, np.int64))
            coords.append(coord)
            depths.append(depth)
            weights.append(weight)
        view = np.concatenate(views)
        coord = np.concatenate(coords)
        depth = np.concatenate(depths)
        weight = np.concatenate(weights)
        k = len(view)
        if k:
            perm = shuffle_rng.permutation(k)
            view, coord = view[perm], coord[perm]
            depth, weight = depth[perm], weight[perm]
        pad = pad_to_multiple(max(k, 1), 1024) - k
        depth_group = DepthRayGroup(
            view=dev(np.pad(view, (0, pad)), torch.int64),
            coord=dev(np.pad(coord, ((0, pad), (0, 0))), torch.float32),
            depth=dev(np.pad(depth, (0, pad)), torch.float32),
            weight=dev(np.pad(weight, (0, pad)), torch.float32),
            count=k, max_depth=float(depth.max()) if k else 1.0)

    if near is None:
        near = 0.0 if ndc else scene.near
    if far is None:
        far = 1.0 if ndc else scene.far
    return RayBank(images=dev(images, torch.float32),
                   poses=dev(poses, torch.float32),
                   labels=dev(labels, torch.float32),
                   inp_depths=dev(inp, torch.float32) if inp is not None else None,
                   hwf=(h, w, float(focal)), near=float(near), far=float(far),
                   ndc=ndc, groups=groups, depth_group=depth_group)


def rays_for_pixels(poses, hwf, view, x, y):
    """World rays (rays_o, rays_d), each [B, 3], for (view, x, y) pixel
    coords; poses [N, 3, 4]."""
    h, w, focal = hwf
    dirs = torch.stack([(x - w * 0.5) / focal,
                        -(y - h * 0.5) / focal,
                        -torch.ones_like(x)], dim=-1)          # [B, 3]
    c2w = poses[view]                                           # [B, 3, 4]
    rays_d = torch.einsum("bj,bij->bi", dirs, c2w[:, :3, :3])
    rays_o = c2w[:, :3, 3]
    return rays_o, rays_d


def _finish_ray_batch(bank, rays_o, rays_d, **extra):
    """NDC warp + batch assembly; viewdirs are taken before the warp."""
    h, w, focal = bank.hwf
    viewdirs = None
    if bank.ndc:
        viewdirs = ray_lib.normalize(rays_d)
        rays_o, rays_d = ray_lib.ndc_rays(h, w, focal, 1.0, rays_o, rays_d)
    return ray_lib.make_ray_batch(rays_o, rays_d, bank.near, bank.far,
                                  viewdirs=viewdirs, **extra)


def _wrap_int32(v):
    """Two's-complement int32 wrap of int64 values (the JAX index math runs
    in int32)."""
    return ((v + (1 << 31)) % (1 << 32)) - (1 << 31)


def epoch_indices(step, batch_size: int, count: int, device=None):
    """Without-replacement epoch sampling, stateless: positions stride
    through the pre-shuffled ray order and each epoch rotates by 65521, so
    every ray is visited once per `count` draws. int32 arithmetic, as in the
    JAX package."""
    c = max(count, 1)
    j = _wrap_int32(int(step) * batch_size
                    + torch.arange(batch_size, dtype=torch.int64,
                                   device=device))
    e = torch.div(j, c, rounding_mode="floor")
    return torch.remainder(_wrap_int32(j + _wrap_int32(e * 65521)), c)


def _draw(count, batch_size, step, generator, device, mesh=None):
    if step is None:
        i = torch.randint(0, max(count, 1), (batch_size,),
                          generator=generator, device=device)
    else:
        i = epoch_indices(step, batch_size, count, device=device)
    return i if mesh is None else mesh.shard_rows(i)


def pixel_batch(bank: RayBank, view, row, col, inp_depth: bool = True):
    """The ray batch and targets of bank pixels (view, row, col), each [B]
    int64: targets 'rgb' [B,3], 'label' [B] and, with `inp_depth` when the
    bank has inpainted depths, 'inp_depth' [B]."""
    rays_o, rays_d = rays_for_pixels(bank.poses, bank.hwf, view,
                                     col.to(torch.float32),
                                     row.to(torch.float32))
    batch = _finish_ray_batch(bank, rays_o, rays_d)
    targets = {"rgb": bank.images[view, row, col],
               "label": bank.labels[view, row, col]}
    if inp_depth and bank.inp_depths is not None:
        targets["inp_depth"] = bank.inp_depths[view, row, col]
    return batch, targets


def sample_group(bank: RayBank, name: str, batch_size: int, step=None,
                 generator=None, mesh=None):
    """A ray batch from a pixel group: epoch strides when `step` is given,
    else uniform with replacement from `generator`; with `mesh`, this
    rank's 1/N of it. Returns (ray_batch, targets) as `pixel_batch` gives
    them."""
    g = bank.groups[name]
    i = _draw(g.count, batch_size, step, generator, bank.device, mesh)
    vrc = g.idx[i]
    return pixel_batch(bank, vrc[:, 0], vrc[:, 1], vrc[:, 2])


def single_image_bounds(hwf, step_idx: int, precrop_iters: int = 0,
                        precrop_frac: float = 0.5):
    """(row lo, row hi, col lo, col hi), half-open, of the pixels the
    `--no_batching` sampler draws at `step_idx`: the centered crop while
    step_idx < precrop_iters, else the whole image."""
    h, w = int(hwf[0]), int(hwf[1])
    if precrop_iters > 0 and step_idx < precrop_iters:
        dh, dw = int(h // 2 * precrop_frac), int(w // 2 * precrop_frac)
        return h // 2 - dh, h // 2 + dh, w // 2 - dw, w // 2 + dw
    return 0, h, 0, w


def sample_single_image(bank: RayBank, batch_size: int, step_idx: int, *,
                        precrop_iters: int = 0, precrop_frac: float = 0.5,
                        generator=None, mesh=None):
    """The reference's `--no_batching` sampler (`run_nerf.py:1415-1452`):
    `batch_size` pixels, uniform with replacement from `generator`, of one
    training view drawn uniformly, within `single_image_bounds`; with
    `mesh`, this rank's 1/N of them. Returns (ray_batch, targets 'rgb' and
    'label')."""
    r0, r1, c0, c1 = single_image_bounds(bank.hwf, step_idx, precrop_iters,
                                         precrop_frac)
    dev = bank.device
    view = torch.randint(0, bank.poses.shape[0], (1,), generator=generator,
                         device=dev).expand(batch_size)
    row = torch.randint(r0, r1, (batch_size,), generator=generator,
                        device=dev)
    col = torch.randint(c0, c1, (batch_size,), generator=generator,
                        device=dev)
    if mesh is not None:
        view, row, col = (mesh.shard_rows(a) for a in (view, row, col))
    return pixel_batch(bank, view, row, col, inp_depth=False)


def sample_depth_group(bank: RayBank, batch_size: int, step=None,
                       generator=None, mesh=None):
    """A sparse-depth ray batch (epoch strides when `step` is given; with
    `mesh`, this rank's 1/N of it)."""
    g = bank.depth_group
    i = _draw(g.count, batch_size, step, generator, bank.device, mesh)
    view = g.view[i]
    coord = g.coord[i]
    rays_o, rays_d = rays_for_pixels(bank.poses, bank.hwf, view,
                                     coord[:, 0], coord[:, 1])
    return _finish_ray_batch(bank, rays_o, rays_d,
                             depths=g.depth[i], weights=g.weight[i])


def frame_ray_batch(hwf, c2w, near, far, ndc: bool = False):
    """All rays of one camera pose c2w [3, 4] (a tensor on the render
    device) as a ray batch. Returns (ray_batch, (H, W))."""
    h, w, focal = hwf
    rays_o, rays_d = ray_lib.get_rays(h, w, focal, c2w)
    viewdirs = None
    if ndc:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        rays_o, rays_d = ray_lib.ndc_rays(h, w, focal, 1.0, rays_o, rays_d)
    return ray_lib.make_ray_batch(rays_o, rays_d, near, far,
                                  viewdirs=viewdirs), (h, w)
