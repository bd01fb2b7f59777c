"""LaMa training losses (port of `spinnerf_tpu/train/lama_losses.py`),
on NCHW tensors (masks [N, 1, H, W], 1 = hole).

big-lama weights (`configs/training/big-lama.yaml:8-23`): masked L1 with
weight_known 10 / weight_missing 0, the non-saturating adversarial loss
with the R1 gradient penalty (weight 10, gp 0.001, mask_as_fake_target),
discriminator feature matching (weight 100) and the resnet_pl perceptual
term (weight 30, `models/segmentation.py::make_resnet_pl`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


class LamaLossWeights(NamedTuple):
    l1_known: float = 10.0
    l1_missing: float = 0.0
    adversarial: float = 10.0
    gp_coef: float = 0.001
    feature_matching: float = 100.0
    perceptual: float = 30.0


def masked_l1(pred, target, mask, *, weight_known: float,
              weight_missing: float):
    """Per-pixel L1 weighted inside / outside the hole (`masked_l1_loss`)."""
    per = torch.abs(pred - target)
    w = mask * weight_missing + (1.0 - mask) * weight_known
    return torch.mean(per * w)


def generator_adversarial_loss(fake_logits, mask=None, *,
                               use_unmasked: bool = True,
                               extra_mask_weight: float = 0.0):
    """Non-saturating generator loss softplus(-D(fake)), averaged over all
    pixels in the big-lama configuration (`adversarial.py:102-115`); the
    mask reweights only when those settings are overridden."""
    per = F.softplus(-fake_logits)
    if mask is not None and (not use_unmasked or extra_mask_weight > 0):
        m = _resize_mask(mask, fake_logits.shape[2:])
        per = per * (m if not use_unmasked
                     else 1.0 + m * extra_mask_weight)
    return torch.mean(per)


def discriminator_adversarial_loss(real_logits, fake_logits, mask):
    """Non-saturating D loss with mask-as-fake-target
    (`adversarial.py:121-140`): the real image is real everywhere; the
    generator output is fake inside the hole and real outside it."""
    m = _resize_mask(mask, fake_logits.shape[2:])
    loss_real = F.softplus(-real_logits)
    loss_fake = m * F.softplus(fake_logits) + \
        (1.0 - m) * F.softplus(-fake_logits)
    return torch.mean(loss_real + loss_fake)


def r1_gradient_penalty(disc_fn, real):
    """R1 penalty (`adversarial.py:70-78` make_r1_gp): the batch mean of
    the per-sample squared norm of d sum(D(real)) / d real. The gradient
    keeps its graph (`create_graph`), so the penalty is differentiated
    through D a second time."""
    x = real.detach().requires_grad_(True)
    logits, _ = disc_fn(x)
    (g,) = torch.autograd.grad(logits.sum(), x, create_graph=True)
    return torch.mean(torch.sum(g.reshape(g.shape[0], -1) ** 2, dim=1))


def feature_matching_loss(fake_feats, real_feats, mask=None):
    """Mean over layers of the L2 between D features of fake and (no
    gradient) real (`feature_matching.py:19`)."""
    total = 0.0
    for f, r in zip(fake_feats, real_feats):
        total = total + torch.mean((f - r.detach()) ** 2)
    return total / len(fake_feats)


def perceptual_loss(features_fn, pred, target):
    """Mean over layers of the feature-space L2 through a frozen conv net;
    `features_fn(x)` returns a list of feature maps."""
    fp = features_fn(pred)
    with torch.no_grad():
        ft = features_fn(target)
    total = 0.0
    for a, b in zip(fp, ft):
        total = total + torch.mean((a - b) ** 2)
    return total / len(fp)


def _nearest_index(src: int, dst: int) -> np.ndarray:
    """`jax.image.resize(..., "nearest")`'s source index of each output:
    the half-pixel centre floor((i + 1/2) src / dst), in integers."""
    return (2 * np.arange(dst) + 1) * src // (2 * dst)


def _resize_mask(mask, hw):
    """Nearest-resize a [N, 1, H, W] mask to the logit grid `hw`, sampling
    at half-pixel centres as JAX's resize does (torch's "nearest" samples
    at floor(i src / dst))."""
    h, w = int(hw[0]), int(hw[1])
    if tuple(mask.shape[2:]) == (h, w):
        return mask
    rows = torch.as_tensor(_nearest_index(mask.shape[2], h),
                           device=mask.device)
    cols = torch.as_tensor(_nearest_index(mask.shape[3], w),
                           device=mask.device)
    return mask[:, :, rows][:, :, :, cols]
