"""Patch-perceptual (LPIPS) training loss (port of
`spinnerf_tpu/train/lpips_patch.py`).

Reference mechanism (`DS_NeRF/run_nerf.py:1523-1561`): every iteration
after step 300, pick `lpips_batch_size` random training views, render a
`render_factor`-downsampled patch whose top-left corner is sampled inside the
(dilated) object-mask bounding box, and penalise LPIPS between the rendered
patch (weights detached) and the same crop of the inpainted target image,
scaled by 1/100.

As in the JAX module the patch size is static (H/rf/plf x W/rf/plf) and the
anchors come from per-view mask bounding boxes computed once. The views and
the anchor uniforms come from the step's `torch.Generator`. Without
perturbation or density noise each ray's render is deterministic and
independent of the others, so the patches render as one ray batch; the
result equals the JAX module's loop over patches. Under data parallelism
every rank computes the whole term from the same draws: its mean across
ranks, which the step takes, is the term itself.
"""
from __future__ import annotations

import numpy as np
import torch

from spinnerf_tpu_torch.core import rays as ray_lib
from spinnerf_tpu_torch.core import rendering
from spinnerf_tpu_torch.core.rendering import RenderConfig
from spinnerf_tpu_torch.models.lpips import MIN_SIDE


def mask_bboxes(masks: np.ndarray, render_factor: int) -> np.ndarray:
    """Per-view inclusive bbox (r0, r1, c0, c1) of |mask|>0 in downsampled
    coords. Views with empty masks get the full-frame box."""
    n, h, w = masks.shape
    out = np.zeros((n, 4), np.int32)
    for i in range(n):
        ys, xs = np.where(np.abs(masks[i]) > 0)
        if len(ys) == 0:
            out[i] = (0, h - 1, 0, w - 1)
        else:
            out[i] = (ys.min(), ys.max(), xs.min(), xs.max())
    return out // render_factor


def patch_size(hwf, lpips_render_factor: int, patch_len_factor: int):
    """(ph, pw): the render-resolution frame's sides over patch_len_factor,
    at least 4 (the JAX module's static size)."""
    hh, ww = hwf[0] // lpips_render_factor, hwf[1] // lpips_render_factor
    return max(hh // patch_len_factor, 4), max(ww // patch_len_factor, 4)


def patch_targets(images: np.ndarray, render_factor: int) -> np.ndarray:
    """images [N, H, W, 3] area-downsampled by `render_factor` from their
    [:hh*rf, :ww*rf] crop: [N, hh, ww, 3] float32."""
    n, h, w = images.shape[:3]
    rf = render_factor
    hh, ww = h // rf, w // rf
    small = images[:, :hh * rf, :ww * rf].reshape(n, hh, rf, ww, rf, 3)
    return small.mean(axis=(2, 4)).astype(np.float32)


def anchor_ranges(masks: np.ndarray, render_factor: int, ph: int, pw: int):
    """(lo, hi), each [N, 2] int32 (row, column): the range of a patch's
    top-left corner in each view's mask box, clamped so that the patch
    fits in the downsampled frame."""
    hh, ww = masks.shape[1] // render_factor, masks.shape[2] // render_factor
    boxes = mask_bboxes(masks, render_factor)
    lo = np.stack([np.clip(boxes[:, 0], 0, hh - ph),
                   np.clip(boxes[:, 2], 0, ww - pw)], -1)
    hi = np.stack([np.clip(boxes[:, 1] - ph, lo[:, 0], hh - ph),
                   np.clip(boxes[:, 3] - pw, lo[:, 1], ww - pw)], -1)
    return lo.astype(np.int32), hi.astype(np.int32)


def patch_rays(c2w, rows, cols, hwf_small, ndc: bool = False):
    """The rays of B patches: c2w [B, 3, 4], the pixel rows [B, ph] and
    columns [B, pw] of each patch in the frame hwf_small = (hh, ww, ff).
    Pixel (x, y) looks along ((x - ww/2)/ff, -(y - hh/2)/ff, -1), no
    half-pixel offset, as in the JAX module. Returns (rays_o, rays_d,
    viewdirs), each [B, ph*pw, 3] row-major; viewdirs is None without NDC
    (the batch normalises rays_d)."""
    hh, ww, ff = hwf_small
    b, ph, pw = len(c2w), rows.shape[1], cols.shape[1]
    y = rows[:, :, None].expand(-1, ph, pw).reshape(b, -1).float()
    x = cols[:, None, :].expand(-1, ph, pw).reshape(b, -1).float()
    dirs = torch.stack([(x - ww * 0.5) / ff, -(y - hh * 0.5) / ff,
                        -torch.ones_like(x)], -1)
    rays_d = dirs @ c2w[:, :3, :3].transpose(1, 2)
    rays_o = c2w[:, None, :3, 3].expand_as(rays_d)
    viewdirs = None
    if ndc:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        rays_o, rays_d = ray_lib.ndc_rays(hh, ww, ff, 1.0, rays_o, rays_d)
    return rays_o, rays_d, viewdirs


def make_patch_lpips_fn(fields, scene, i_train, *, lpips,
                        render: RenderConfig, near: float, far: float,
                        ndc: bool = False, lpips_render_factor: int = 2,
                        patch_len_factor: int = 8, batch_size: int = 4,
                        start_iter: int = 300, weight: float = 1.0 / 100.0):
    """Build `lpips_fn(generator=None, *, views=None, u=None) -> scalar`
    for `make_train_step`, over `fields` ({"coarse"[, "fine"]}) and `lpips`
    (a `models.lpips.LPIPS` on the fields' device).

    `views` ([batch_size] positions in `i_train`, taken `i % n_views`) and
    `u` ([batch_size, 2] anchor uniforms) default to draws from
    `generator`: a permutation of the training views, then the uniforms.
    Targets are `scene.images` (the inpainted RGB in fit mode) downsampled
    by `lpips_render_factor` with area averaging.

    Raises ValueError when a patch side is under 16 pixels: VGG16's fifth
    block would have no pixel, where the JAX module returns NaN."""
    h, w, focal = scene.hwf
    rf = lpips_render_factor
    hh, ww, ff = h // rf, w // rf, focal / rf
    ph, pw = patch_size(scene.hwf, rf, patch_len_factor)
    if min(ph, pw) < MIN_SIDE:
        raise ValueError(
            f"the LPIPS patch is {ph} x {pw} pixels: the frame {h} x {w} "
            f"over lpips_render_factor {rf} and patch_len_factor "
            f"{patch_len_factor} must leave at least {MIN_SIDE} x "
            f"{MIN_SIDE} (VGG16 pools 2 x 2 four times)")
    device = lpips.lin0.device
    n_views = len(i_train)
    targets = torch.as_tensor(patch_targets(scene.images[i_train], rf),
                              device=device)                # [N, hh, ww, 3]
    lo, hi = (torch.as_tensor(a, device=device)
              for a in anchor_ranges(scene.masks[i_train], rf, ph, pw))
    poses = torch.as_tensor(scene.poses[i_train], dtype=torch.float32,
                            device=device)

    # patches render without sampling jitter or density noise (the
    # reference's test-mode kwargs, `run_nerf.py:1540-1549`) and with
    # detached weights (colour-only gradients)
    rcfg = render._replace(perturb=False, raw_noise_std=0.0)
    coarse = fields["coarse"]
    fine = fields["fine"] if "fine" in fields else coarse

    def lpips_fn(generator=None, *, views=None, u=None):
        if views is None:
            views = torch.randperm(n_views, generator=generator,
                                   device=device)[:batch_size]
        if u is None:
            u = torch.rand((batch_size, 2), generator=generator,
                           device=device)
        v = torch.as_tensor(views, device=device)[
            torch.arange(batch_size, device=device) % n_views].long()
        u = torch.as_tensor(u, dtype=torch.float32, device=device)
        lo_v, hi_v = lo[v], hi[v]
        # truncated to int32 in f32, as the JAX module computes it
        anchors = (lo_v + u * (hi_v - lo_v + 1)).to(torch.int32).long()
        rows = anchors[:, 0:1] + torch.arange(ph, device=device)
        cols = anchors[:, 1:2] + torch.arange(pw, device=device)
        rays_o, rays_d, viewdirs = patch_rays(poses[v], rows, cols,
                                              (hh, ww, ff), ndc)
        batch = ray_lib.make_ray_batch(rays_o, rays_d, near, far,
                                       viewdirs=viewdirs)
        res = rendering.render_rays(batch, coarse, rcfg, fine_field_fn=fine)
        pred = res.fine.rgb_sg.reshape(batch_size, ph, pw, 3)
        tgt = targets[v[:, None, None], rows[:, :, None], cols[:, None, :]]
        return torch.mean(lpips(pred, tgt)) * weight

    lpips_fn.start_iter = start_iter
    return lpips_fn
