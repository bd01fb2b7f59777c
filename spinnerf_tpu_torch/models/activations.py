"""Field activations (port of `spinnerf_tpu/models/activations.py`).

`trunc_exp` is the density activation of the hash-grid field: exp(x) with a
backward of exp(clip(x, -15, 15)), so density stays positive and its
gradient cannot overflow.
"""
from __future__ import annotations

import torch


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def trunc_exp(x):
    """exp(x) with gradient exp(clip(x, -15, 15))."""
    return _TruncExp.apply(x)
