"""Input encodings: NeRF sinusoidal positional encoding and spherical
harmonics for view directions (port of `spinnerf_tpu/models/embedding.py`).
"""
from __future__ import annotations

import torch


def positional_encoding_dim(input_dim: int, num_freqs: int,
                            include_input: bool = True) -> int:
    return input_dim * ((1 if include_input else 0) + 2 * num_freqs)


def positional_encoding(x, num_freqs: int, include_input: bool = True):
    """[x, sin(x*f0), cos(x*f0), sin(x*f1), ...] with f_k = 2^k, each applied
    to the full input vector. x: [..., D]."""
    if num_freqs == 0:
        return x
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * freqs[:, None]                # [..., F, D]
    enc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)
    enc = enc.reshape(*x.shape[:-1], 2 * num_freqs * x.shape[-1])
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc


def sh_encoding(dirs, degree: int = 4):
    """Real spherical-harmonics basis (tiny-cuda-nn's ordering) at unit
    directions [..., 3]. Output dim = degree**2 (degree 1..4)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, 0.28209479177387814)]
    if degree > 1:
        out += [-0.48860251190291987 * y,
                0.48860251190291987 * z,
                -0.48860251190291987 * x]
    if degree > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [1.0925484305920792 * xy,
                -1.0925484305920792 * yz,
                0.94617469575755997 * zz - 0.31539156525251999,
                -1.0925484305920792 * xz,
                0.54627421529603959 * (xx - yy)]
    if degree > 3:
        out += [0.59004358992664352 * y * (-3.0 * xx + yy),
                2.8906114426405538 * xy * z,
                0.45704579946446572 * y * (1.0 - 5.0 * zz),
                0.3731763325901154 * z * (5.0 * zz - 3.0),
                0.45704579946446572 * x * (1.0 - 5.0 * zz),
                1.4453057213202769 * z * (xx - yy),
                0.59004358992664352 * x * (-xx + 3.0 * yy)]
    return torch.stack(out, dim=-1)
