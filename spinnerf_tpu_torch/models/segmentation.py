"""ADE20k segmentation models: the dilated ResNet encoder, the PPM decoder
and the `resnet_pl` segmentation-perceptual loss built on them (port of
`spinnerf_tpu/models/segmentation.py`), in NCHW.

Parity: `lama/models/ade20k/` — the MIT scene-parsing ResNet with a
3-conv stem (`resnet.py:95-160`), the dilate-8 conversion (stages 3 / 4
keep stride 1 at dilations 2 / 4, `base.py` ResnetDilated
`_nostride_dilate`), the `PPMDeepsup` pyramid-pooling decoder
(`base.py:290-340`) and the ResNetPL loss
(`saicinpainting/training/losses/perceptual.py:88-113`).

The modules carry the MIT checkpoints' names (`conv1`, `bn1`, ...,
`layer3.0.downsample.0`; `ppm.{k}.1`, `conv_last.{0,1,4}`), so
`ade20k_resnet50.pth` loads into `ResNetDilated` with `strict=True`, and
`ade20k_ppm_decoder.pth` into `PPMDecoder` once its train-time deep
supervision head (`cbr_deepsup`, `conv_last_deepsup`, which the JAX package
ignores too) is dropped; the JAX package converts both
(`convert_mit_encoder` / `convert_mit_decoder`). Without the files the
weights are seeded random (flax's default initialisers from a CPU
`torch.Generator`, not the JAX package's draws), a frozen random-projection
perceptual loss as in JAX. BatchNorm is `models/batchnorm.py`'s; the
convolutions run in f32 with TF32 off on the card.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from spinnerf_tpu_torch import resolve_device
from spinnerf_tpu_torch import weights as wreg
from spinnerf_tpu_torch.models.batchnorm import BatchNorm2d, flax_init_
from spinnerf_tpu_torch.models.lpips import _f32_convs

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
NUM_ADE20K_CLASSES = 150
_DEEPSUP = ("cbr_deepsup.", "conv_last_deepsup.")


def _conv(cin, cout, kernel, *, stride=1, dilation=1):
    return nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2 * dilation,
                     dilation, bias=False)


class BasicBlock(nn.Module):
    """ResNet-18/34 block (`resnet.py:24-55`)."""
    expansion = 1

    def __init__(self, cin, planes, stride=1, dilation=1, downsample=False):
        super().__init__()
        self.conv1 = _conv(cin, planes, 3, stride=stride, dilation=dilation)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, dilation=dilation)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = nn.Sequential(
            nn.Conv2d(cin, planes, 1, stride, bias=False),
            BatchNorm2d(planes)) if downsample else None

    def forward(self, x):
        h = torch.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + h)


class Bottleneck(nn.Module):
    """ResNet-50/101 block, expansion 4 (`resnet.py:56-92`)."""
    expansion = 4

    def __init__(self, cin, planes, stride=1, dilation=1, downsample=False):
        super().__init__()
        out = planes * 4
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride=stride,
                           dilation=dilation)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = BatchNorm2d(out)
        self.downsample = nn.Sequential(
            nn.Conv2d(cin, out, 1, stride, bias=False),
            BatchNorm2d(out)) if downsample else None

    def forward(self, x):
        h = torch.relu(self.bn1(self.conv1(x)))
        h = torch.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + h)


_DEPTH_PLAN = {18: (BasicBlock, (2, 2, 2, 2)),
               34: (BasicBlock, (3, 4, 6, 3)),
               50: (Bottleneck, (3, 4, 6, 3))}


class ResNetDilated(nn.Module):
    """MIT scene-parsing ResNet encoder, dilate 8 by default: the 3-conv
    stem (64, 64, 128) and a 3 x 3 / 2 max pool, four stages; stage 3
    keeps stride 1 at dilation 2, stage 4 at dilation 4 (each stage's
    formerly stride-2 first block at half its stage's dilation,
    `_nostride_dilate`), so the output stride is 8. `forward` returns the
    four stage feature maps."""

    def __init__(self, depth: int = 50, dilate_scale: int = 8, device=None):
        super().__init__()
        block_cls, layers = _DEPTH_PLAN[depth]
        self.conv1 = _conv(3, 64, 3, stride=2)
        self.bn1 = BatchNorm2d(64)
        self.conv2 = _conv(64, 64, 3)
        self.bn2 = BatchNorm2d(64)
        self.conv3 = _conv(64, 128, 3)
        self.bn3 = BatchNorm2d(128)
        if dilate_scale == 8:
            strides, dilations = (1, 2, 1, 1), (1, 1, 2, 4)
        elif dilate_scale == 16:
            strides, dilations = (1, 2, 2, 1), (1, 1, 1, 2)
        else:
            strides, dilations = (1, 2, 2, 2), (1, 1, 1, 1)
        in_ch = 128
        for s, (n_blocks, p) in enumerate(zip(layers, (64, 128, 256, 512))):
            blocks = []
            for b in range(n_blocks):
                stride = strides[s] if b == 0 else 1
                down = b == 0 and (stride != 1
                                   or in_ch != p * block_cls.expansion)
                dil = (dilations[s] // 2 if b == 0 and dilations[s] > 1
                       else dilations[s])
                blocks.append(block_cls(in_ch, p, stride, dil, down))
                in_ch = p * block_cls.expansion
            setattr(self, f"layer{s + 1}", nn.Sequential(*blocks))
        self.out_channels = in_ch
        self.to(resolve_device(device))

    def reset_parameters(self, generator=None):
        return flax_init_(self, generator)

    def forward(self, x):
        with _f32_convs():
            h = torch.relu(self.bn1(self.conv1(x)))
            h = torch.relu(self.bn2(self.conv2(h)))
            h = torch.relu(self.bn3(self.conv3(h)))
            h = F.max_pool2d(h, 3, 2, 1)
            feats = []
            for s in range(1, 5):
                h = getattr(self, f"layer{s}")(h)
                feats.append(h)
        return feats


class PPMDecoder(nn.Module):
    """Pyramid-pooling segmentation head (`PPMDeepsup`, `base.py:290-340`):
    conv5 pooled at scales (1, 2, 3, 6), each 1 x 1 conv to 512 + BN +
    ReLU, bilinearly resized back (`_resize`), concatenated with conv5;
    a fused 3 x 3 conv + BN + ReLU, then the 1 x 1 class logits."""

    def __init__(self, fc_dim: int = 2048, num_class: int = NUM_ADE20K_CLASSES,
                 pool_scales=(1, 2, 3, 6), device=None):
        super().__init__()
        self.ppm = nn.ModuleList(
            nn.Sequential(nn.AdaptiveAvgPool2d(s),
                          nn.Conv2d(fc_dim, 512, 1, bias=False),
                          BatchNorm2d(512), nn.ReLU())
            for s in pool_scales)
        # index 3 is the reference's Dropout2d, which the JAX package omits
        self.conv_last = nn.Sequential(
            nn.Conv2d(fc_dim + len(pool_scales) * 512, 512, 3, padding=1,
                      bias=False),
            BatchNorm2d(512), nn.ReLU(), nn.Identity(),
            nn.Conv2d(512, num_class, 1))
        self.to(resolve_device(device))

    def forward(self, conv_out, seg_size=None):
        conv5 = conv_out[-1]
        h, w = conv5.shape[2:]
        with _f32_convs():
            outs = [conv5] + [_resize(p(conv5), (h, w)) for p in self.ppm]
            logits = self.conv_last(torch.cat(outs, dim=1))
        if seg_size is not None:
            logits = _resize(logits, tuple(seg_size))
        return logits


def _resize(x, hw):
    """`jax.image.resize(..., "bilinear")`: half-pixel centres, and where a
    side shrinks (the scale-6 pool on a conv5 under 6 x 6) the triangle
    kernel widened by the scale (antialias), as torch's antialias mode."""
    return F.interpolate(x, hw, mode="bilinear", align_corners=False,
                         antialias=True)


class SegmentationModel(nn.Module):
    """Encoder + decoder, the reference's SegmentationModule
    (`base.py:200-211`): per-pixel class logits [N, 150, H, W] at
    `seg_size` (default: the input's)."""

    def __init__(self, depth: int = 50, device=None):
        super().__init__()
        self.encoder = ResNetDilated(depth, device="cpu")
        self.decoder = PPMDecoder(self.encoder.out_channels, device="cpu")
        self.to(resolve_device(device))

    def reset_parameters(self, generator=None):
        return flax_init_(self, generator)

    def forward(self, x, seg_size=None):
        return self.decoder(self.encoder(x),
                            seg_size=seg_size or tuple(x.shape[2:]))


def imagenet_normalize(img):
    """[N, 3, H, W] in [0, 1] -> ImageNet-normalised."""
    mean = torch.as_tensor(IMAGENET_MEAN, dtype=img.dtype, device=img.device)
    std = torch.as_tensor(IMAGENET_STD, dtype=img.dtype, device=img.device)
    return (img - mean[:, None, None]) / std[:, None, None]


def _load(path):
    sd = torch.load(path, map_location="cpu")
    return sd.get("state_dict", sd)


def load_segmentation_model(encoder_path=None, decoder_path=None, *,
                            depth: int = 50, seed: int = 0, device=None):
    """A frozen `SegmentationModel` in inference mode on `device` (the card
    unless the caller asks for the CPU) with whatever MIT weights are
    found: explicit paths win, else `$SPINNERF_WEIGHTS_DIR`, else the seeded
    random init. Returns (model, is_real), is_real True only when both the
    encoder and the decoder were loaded."""
    if encoder_path is None and depth == 50:
        encoder_path = wreg.find("ade20k_resnet50")
    if decoder_path is None:
        decoder_path = wreg.find("ade20k_ppm_decoder")
    model = SegmentationModel(depth, device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(seed))
    if encoder_path:
        model.encoder.load_state_dict(_load(encoder_path), strict=True)
    if decoder_path:
        model.decoder.load_state_dict(
            {k: v for k, v in _load(decoder_path).items()
             if not k.startswith(_DEEPSUP)}, strict=True)
    model = model.to(resolve_device(device)).eval().requires_grad_(False)
    return model, bool(encoder_path and decoder_path)


def make_resnet_pl(*, depth: int = 50, weights_path=None, seed: int = 0,
                   device=None):
    """The resnet_pl segmentation-perceptual loss (`perceptual.py:88-113`):
    loss(pred, target) = the sum over the four stage features of the MSE
    through the frozen dilated encoder, after ImageNet normalisation; pred
    and target [N, 3, H, W] in [0, 1], the gradient reaching pred only.
    Returns (loss_fn, encoder)."""
    if weights_path is None and depth == 50:
        weights_path = wreg.find("ade20k_resnet50")
    enc = ResNetDilated(depth, device="cpu")
    if weights_path:
        enc.load_state_dict(_load(weights_path), strict=True)
    else:
        enc.reset_parameters(torch.Generator().manual_seed(seed))
    enc = enc.to(resolve_device(device)).eval().requires_grad_(False)

    def loss_fn(pred, target):
        fp = enc(imagenet_normalize(pred))
        with torch.no_grad():
            ft = enc(imagenet_normalize(target))
        total = 0.0
        for a, b in zip(fp, ft):
            total = total + torch.mean((a - b) ** 2)
        return total

    return loss_fn, enc


def segmentation_class_stats(seg_pred, seg_target, *, num_class: int):
    """Per-class pixel fractions and prediction agreement
    (`SegmentationClassStats`, `evaluation/losses/base_loss.py`)."""
    out = {}
    agree = (seg_pred == seg_target)
    for c in range(num_class):
        m = seg_target == c
        frac = float(np.mean(m))
        if frac == 0:
            continue
        out[c] = {"target_frac": frac,
                  "agreement": float(np.mean(agree[m]))}
    return out


def segmentation_aware_scores(pred, target, seg_labels, *, num_class: int,
                              score_fn=None):
    """Score pred against target within each class's region of the
    target's segmentation (SegmentationAware{SSIM,LPIPS,FID}).

    Args:
      seg_labels: [H, W] int class map of the target.
      score_fn(pred, target, mask) -> float; defaults to masked L1.
    Returns {class_id: score} over the classes present.
    """
    if score_fn is None:
        def score_fn(p, t, m):
            denom = max(float(m.sum()) * p.shape[-1], 1.0)
            return float(np.sum(np.abs(p - t) * m[..., None]) / denom)
    out = {}
    for c in range(num_class):
        m = (seg_labels == c).astype(np.float32)
        if m.sum() == 0:
            continue
        out[c] = score_fn(pred, target, m)
    return out
