"""Image-quality metrics: PSNR, SSIM (MATLAB convention), mask IoU/accuracy
(port of `spinnerf_tpu/eval/metrics.py`).

Parity targets, as in the JAX module: `DS_NeRF/eval_metrics_script.py:20-62`
and the MATLAB-equivalent masked SSIM of `DS_NeRF/eval_utils.py:38-118`;
segmentation accuracy and IoU of `MVSeg/DS_NeRF/run_nerf.py:950-962`.
Inputs are tensors on any device; results are 0-d float32 tensors.
"""
from __future__ import annotations

import numpy as np
import torch


def psnr(pred, target, mask=None, max_val: float = 1.0):
    """PSNR in dB; `mask` [H, W] restricts it to masked pixels."""
    err = (pred - target) ** 2
    if mask is not None:
        m = mask[..., None] if err.ndim == mask.ndim + 1 else mask
        mse = (torch.sum(err * m)
               / torch.clamp(torch.sum(m * torch.ones_like(err)), min=1))
    else:
        mse = torch.mean(err)
    return 10.0 * torch.log10(max_val ** 2 / mse)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device=None):
    x = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def _filter_valid(img, kern):
    """Depthwise 'valid' correlation of img [H, W, C] with kern [k, k] in
    f32 elementwise products — exact f32 on every device (a float32 conv2d
    may take TF32 on the card, and TF32 rounding turns SSIM's E[x^2] - mu^2
    variance terms into noise)."""
    k = kern.shape[0]
    oh, ow = img.shape[0] - k + 1, img.shape[1] - k + 1
    out = torch.zeros((oh, ow) + img.shape[2:], dtype=img.dtype,
                      device=img.device)
    for a in range(k):
        for b in range(k):
            out = out + kern[a, b] * img[a:a + oh, b:b + ow]
    return out


def ssim(pred, target, *, max_val: float = 1.0, kernel_size: int = 11,
         sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03, mask=None):
    """MATLAB-convention SSIM with an 11x11 gaussian window (sigma 1.5),
    'valid' padding, averaged over channels. pred/target [H, W, C] or
    [H, W] in [0, max_val]; `mask` [H, W] averages the SSIM map only over
    the valid windows whose center pixel is masked."""
    if pred.ndim == 2:
        pred = pred[..., None]
        target = target[..., None]
    kern = _gaussian_kernel(kernel_size, sigma, pred.device)
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    mu_p = _filter_valid(pred, kern)
    mu_t = _filter_valid(target, kern)
    mu_pp, mu_tt, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    sig_p = _filter_valid(pred * pred, kern) - mu_pp
    sig_t = _filter_valid(target * target, kern) - mu_tt
    sig_pt = _filter_valid(pred * target, kern) - mu_pt
    ssim_map = ((2 * mu_pt + c1) * (2 * sig_pt + c2)
                / ((mu_pp + mu_tt + c1) * (sig_p + sig_t + c2)))
    if mask is None:
        return torch.mean(ssim_map)
    # the mask cropped to exactly the valid output's extent
    pad = (kernel_size - 1) // 2
    oh, ow = ssim_map.shape[0], ssim_map.shape[1]
    center = mask[pad:pad + oh, pad:pad + ow][..., None]
    return (torch.sum(ssim_map * center)
            / torch.clamp(torch.sum(center * torch.ones_like(ssim_map)),
                          min=1))


def mask_metrics(pred_mask, gt_mask):
    """Pixel accuracy and IoU of binary masks of equal shape (MVSeg eval):
    {"accuracy", "iou"}."""
    p = pred_mask > 0.5
    g = gt_mask > 0.5
    inter = torch.sum(p & g)
    union = torch.sum(p | g)
    acc = torch.mean((p == g).to(torch.float32))
    iou = inter / torch.clamp(union, min=1)
    return {"accuracy": acc, "iou": iou.to(torch.float32)}


def to8b(x) -> np.ndarray:
    """Float [0, 1] image -> uint8, NaN-safe (`run_nerf_helpers.py:18`)."""
    x = np.nan_to_num(np.asarray(x), nan=0.0)
    return (255 * np.clip(x, 0, 1)).astype(np.uint8)
