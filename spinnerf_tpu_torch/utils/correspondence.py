"""Cross-view correspondence via rendered depth (port of
`spinnerf_tpu/utils/correspondence.py`; parity:
`DS_NeRF/correspondence_utils.py:4-50`).

Take the weight-argmax depth of each source pixel, unproject it to world,
reproject it into a target view, and validate by comparing against the
target's own unprojection (world-space error check). Functions on tensors,
on the caller's device, in float64 as the JAX package's numpy computes it;
the 3 x 3 rotations are written out as products and sums, so that the card
and the CPU give the same bits.
"""
from __future__ import annotations

import torch


def weight_argmax_depth(z_vals: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """Depth of the max-weight sample per pixel ([H, W, S] -> [H, W]); the
    first of equal maxima, as np.argmax takes it."""
    idx = torch.argmax(weights, dim=-1, keepdim=True)
    return torch.take_along_dim(z_vals, idx, dim=-1)[..., 0]


def rotate(x: torch.Tensor, rot: torch.Tensor, *,
           transpose: bool = False) -> torch.Tensor:
    """x [..., 3] @ rot.T (transpose=False) or x @ rot (transpose=True),
    with rot [3, 3], as three products summed left to right per output."""
    r = rot.T if transpose else rot
    return torch.stack([x[..., 0] * r[j, 0] + x[..., 1] * r[j, 1]
                        + x[..., 2] * r[j, 2] for j in range(3)], dim=-1)


def unproject(u, v, z, c2w, focal, cx, cy):
    """Pixel (u, v) at NeRF z-depth z to world ([..., 3]): the pixel's
    direction (x right, y up, -1 forward) scaled by z, rotated and
    translated by c2w [3 or 4, 4]."""
    dirs = torch.stack([(u - cx) / focal, -(v - cy) / focal,
                        -torch.ones_like(u)], dim=-1)
    return c2w[:3, 3] + rotate(dirs * z[..., None], c2w[:3, :3])


def project(pts, c2w, focal, cx, cy):
    """World points into a camera. Returns (u, v, zdepth)."""
    cam = rotate(pts - c2w[:3, 3], c2w[:3, :3], transpose=True)
    z = -cam[..., 2]
    zc = torch.clamp(z, min=1e-9)
    u = cx + focal * cam[..., 0] / zc
    v = cy - focal * cam[..., 1] / zc
    return u, v, z


def reproject_correspondences(depth_a, c2w_a, c2w_b, depth_b, *, focal, cx,
                              cy, world_err_thresh: float = 0.05):
    """Dense A->B correspondences through depth, with a world-error check.

    Args:
      depth_a/depth_b: [H, W] per-pixel depths (NeRF z-convention).
      c2w_a/c2w_b: [3or4, 4] NeRF camera-to-world, float64.
    Returns:
      (uv_b [H, W, 2] float64 pixel coords in B, valid [H, W] bool) — valid
      where the reprojection lands in-frame AND B's own surface unprojects to
      (approximately) the same world point.
    """
    h, w = depth_a.shape
    dev = depth_a.device
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=dev),
                          torch.arange(w, dtype=torch.float64, device=dev),
                          indexing="ij")
    world_a = unproject(u, v, depth_a, c2w_a, focal, cx, cy)
    u_b, v_b, z_b = project(world_a, c2w_b, focal, cx, cy)
    in_frame = (z_b > 0) & (u_b >= 0) & (u_b < w) & (v_b >= 0) & (v_b < h)

    # truncation toward zero, then the clip (numpy's astype, then clip)
    ui = torch.clamp(u_b.to(torch.int64), 0, w - 1)
    vi = torch.clamp(v_b.to(torch.int64), 0, h - 1)
    world_b = unproject(u_b, v_b, depth_b[vi, ui], c2w_b, focal, cx, cy)
    err = torch.linalg.vector_norm(world_b - world_a, dim=-1)
    valid = in_frame & (err < world_err_thresh)
    return torch.stack([u_b, v_b], dim=-1), valid
