"""Ray generation and camera geometry.

Port of `spinnerf_tpu/core/rays.py`: pixel grid in xy-indexing, camera
looks down -z, y up, directions are *not* normalized (z-depth convention for
`z_vals`), plus the NDC warp used for forward-facing scenes.
"""
from __future__ import annotations

import torch


def pixel_dirs(height: int, width: int, focal, dtype=torch.float32,
               device=None):
    """Per-pixel camera-frame ray directions, shape [H, W, 3]."""
    cx, cy = width * 0.5, height * 0.5
    i = torch.arange(width, dtype=dtype, device=device)[None, :]
    j = torch.arange(height, dtype=dtype, device=device)[:, None]
    x = ((i - cx) / focal).expand(height, width)
    y = (-(j - cy) / focal).expand(height, width)
    return torch.stack([x, y, -torch.ones_like(x)], dim=-1)


def get_rays(height: int, width: int, focal, c2w):
    """World-frame (rays_o, rays_d), each [H, W, 3], for a [3, 4] c2w."""
    dirs = pixel_dirs(height, width, focal, dtype=c2w.dtype, device=c2w.device)
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def get_rays_at_coords(height: int, width: int, focal, c2w, coords):
    """Rays through [N, 2] pixel coords ordered (x, y); each [N, 3]."""
    x = (coords[:, 0] - width * 0.5) / focal
    y = -(coords[:, 1] - height * 0.5) / focal
    dirs = torch.stack([x, y, -torch.ones_like(x)], dim=-1)
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def ndc_rays(height: int, width: int, focal, near, rays_o, rays_d):
    """Warp rays into NDC space for forward-facing scenes."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    ox, oy, oz = rays_o[..., 0], rays_o[..., 1], rays_o[..., 2]
    dx, dy, dz = rays_d[..., 0], rays_d[..., 1], rays_d[..., 2]

    sx = -1.0 / (width / (2.0 * focal))
    sy = -1.0 / (height / (2.0 * focal))

    o0 = sx * ox / oz
    o1 = sy * oy / oz
    o2 = 1.0 + 2.0 * near / oz

    d0 = sx * (dx / dz - ox / oz)
    d1 = sy * (dy / dz - oy / oz)
    d2 = -2.0 * near / oz

    return torch.stack([o0, o1, o2], dim=-1), torch.stack([d0, d1, d2], dim=-1)


def normalize(v, eps: float = 1e-12):
    """Unit-normalize along the last axis."""
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def make_ray_batch(rays_o, rays_d, near, far, viewdirs=None, depths=None,
                   weights=None):
    """Pack rays into the dict-of-tensors ray batch: origins [B,3],
    directions [B,3], near [B], far [B], viewdirs [B,3] (unit; defaults to
    normalized directions), optional depths [B] and weights [B]."""
    origins = rays_o.reshape(-1, 3)
    directions = rays_d.reshape(-1, 3)
    n = origins.shape[0]

    def full(v):
        return torch.as_tensor(v, dtype=origins.dtype,
                               device=origins.device).expand(n)

    batch = {
        "origins": origins,
        "directions": directions,
        "near": full(near),
        "far": full(far),
        "viewdirs": (normalize(directions) if viewdirs is None
                     else viewdirs.reshape(-1, 3)),
    }
    if depths is not None:
        batch["depths"] = depths.reshape(-1)
    if weights is not None:
        batch["weights"] = weights.reshape(-1)
    return batch
