"""COUNTLESS 2x downsampling, mode pooling without counting (port of
`spinnerf_tpu/utils/countless.py`).

Parity: the reference's vendored COUNTLESS suite
(`lama/saicinpainting/evaluation/masks/countless/countless2d.py`); its one
load-bearing call is `zero_corrected_countless` for the mask pyramid
(`evaluation/masks/mask.py:226`). For each 2 x 2 block (a, b, c, d) the
majority label if a pair among a / b / c matches, else d: the mode of 4
samples. Labels are shifted so the minimum maps to 1, making 0 the
"no match" sentinel. `countless2d` runs in numpy (host-side mask prep),
`countless2d_torch` on tensors of any device.
"""
from __future__ import annotations

import numpy as np
import torch


def countless2d(img: np.ndarray) -> np.ndarray:
    """Mode-downsample a 2D label image by 2 x 2 (numpy). Odd sides are
    edge-padded (the reference's `upgraded_countless2d`); any integer
    dtype, 0 and negative labels included."""
    if img.ndim != 2:
        raise ValueError(f"countless2d expects a 2D image, got {img.shape}")
    h, w = img.shape
    if h % 2 or w % 2:
        img = np.pad(img, ((0, h % 2), (0, w % 2)), mode="edge")
    # int64 first: a +1 shift would wrap uint8 255 and collide with -1
    wide = img.astype(np.int64)
    data = wide - wide.min() + 1
    a, b = data[0::2, 0::2], data[0::2, 1::2]
    c, d = data[1::2, 0::2], data[1::2, 1::2]
    ab, ac, bc = a * (a == b), a * (a == c), b * (b == c)
    mode = np.where(ab != 0, ab, np.where(ac != 0, ac, bc))
    mode = np.where(mode != 0, mode, d)
    return (mode - 1 + wide.min()).astype(img.dtype)


def countless2d_torch(img: torch.Tensor) -> torch.Tensor:
    """`countless2d` on a 2D integer tensor, on its device (the JAX
    package's `countless2d_jax`)."""
    if img.ndim != 2:
        raise ValueError(f"countless2d expects a 2D image, got "
                         f"{tuple(img.shape)}")
    h, w = img.shape
    if h % 2 or w % 2:
        img = torch.cat([img, img[-1:]]) if h % 2 else img
        img = torch.cat([img, img[:, -1:]], dim=1) if w % 2 else img
    wide = img.to(torch.int64)
    data = wide - wide.min() + 1
    a, b = data[0::2, 0::2], data[0::2, 1::2]
    c, d = data[1::2, 0::2], data[1::2, 1::2]
    ab, ac, bc = a * (a == b), a * (a == c), b * (b == c)
    mode = torch.where(ab != 0, ab, torch.where(ac != 0, ac, bc))
    mode = torch.where(mode != 0, mode, d)
    return (mode - 1 + wide.min()).to(img.dtype)


def downsample_mask(mask: np.ndarray, factor: int) -> np.ndarray:
    """Repeated COUNTLESS 2x down to a power-of-two `factor`: mode pooling,
    so label identities survive."""
    if factor < 1 or factor & (factor - 1):
        raise ValueError(f"factor must be a power of two, got {factor}")
    out = mask
    while factor > 1:
        out = countless2d(out)
        factor //= 2
    return out
