"""Loss terms for the SPIn-NeRF training objectives.

Port of `spinnerf_tpu/core/losses.py`; all losses take optional per-element
masks.
"""
from __future__ import annotations

import math

import torch


def masked_mean(x, mask=None):
    """Mean of x over elements where mask != 0 (all elements when mask=None)."""
    if mask is None:
        return torch.mean(x)
    mask = mask.to(x.dtype)
    denom = torch.clamp(torch.sum(mask), min=1.0)
    return torch.sum(x * mask) / denom


def mse(pred, target, mask=None):
    """Mean squared error; `mask` broadcasts over trailing dims."""
    err = (pred - target) ** 2
    if mask is not None and mask.ndim < err.ndim:
        mask = mask[..., None] * torch.ones_like(err)
    return masked_mean(err, mask)


def mse_to_psnr(x):
    return -10.0 * torch.log(x) / math.log(10.0)


def depth_loss(pred_depth, target_depth, *, ray_weights=None, mask=None,
               weighted: bool = False, relative: bool = False,
               normalize: bool = False, max_depth=None):
    """COLMAP sparse-depth supervision: plain, weighted (reprojection-error
    weights, taking precedence over relative), relative (error over target
    depth), and weighted+normalized (error over max_depth)."""
    if weighted:
        if ray_weights is None:
            raise ValueError("weighted=True requires ray_weights")
        err = pred_depth - target_depth
        if normalize:
            if max_depth is None:
                raise ValueError("normalize=True requires max_depth")
            err = err / max_depth
        per_ray = err ** 2 * ray_weights
    elif relative:
        per_ray = ((pred_depth - target_depth) / target_depth) ** 2
    else:
        per_ray = (pred_depth - target_depth) ** 2
    return masked_mean(per_ray, mask)


def sigma_loss(raw_sigma):
    """URF-style loss on relu'd densities [B, S] whose last sample sits at
    the ground-truth depth: -exp(s_S) / (sum_s exp(s_s) + 1), shifted by the
    row max (with 0 folded in) so large densities do not overflow. [B]."""
    m = torch.clamp(torch.max(raw_sigma, dim=1).values, min=0.0)
    num = torch.exp(raw_sigma[:, -1] - m)
    den = torch.sum(torch.exp(raw_sigma - m[:, None]), dim=1) + torch.exp(-m)
    return -num / den


def bce_with_logits(logits, labels, mask=None):
    """Numerically stable binary cross-entropy on logits."""
    per = (torch.clamp(logits, min=0) - logits * labels
           + torch.log1p(torch.exp(-torch.abs(logits))))
    return masked_mean(per, mask)


def distortion_loss(weights, z_vals):
    """Mip-NeRF 360 distortion regularizer over all S samples (bin edges
    [z_0, midpoints, z_{S-1}])."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    edges = torch.cat([z_vals[..., :1], mids, z_vals[..., -1:]], dim=-1)
    centers = 0.5 * (edges[..., 1:] + edges[..., :-1])
    w = weights
    dist = torch.abs(centers[..., :, None] - centers[..., None, :])
    loss_inter = torch.sum(w[..., :, None] * w[..., None, :] * dist,
                           dim=(-1, -2))
    deltas = edges[..., 1:] - edges[..., :-1]
    loss_intra = torch.sum(w ** 2 * deltas, dim=-1) / 3.0
    return torch.mean(loss_inter + loss_intra)
