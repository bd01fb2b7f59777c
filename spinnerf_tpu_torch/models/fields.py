"""The classic NeRF MLP field (port of `spinnerf_tpu/models/fields.py`).

`NeRFField` is the field the trainer takes with `--no_tcnn` when the fused
kernel field (`ops/fused_mlp.py::FusedMLPField`) does not apply: no view
directions, `--i_embed -1`, depth 5, or `fused_mlp=False`. Its matrix
products are plain PyTorch. Layer names follow the flax module's
(`trunk_{i}`, `sigma_head`, `semantic_head`, `feature`, `view_0`,
`rgb_head`), so `convert.field_state_dict` carries its weights across.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from spinnerf_tpu_torch import resolve_device
from spinnerf_tpu_torch.models.embedding import (positional_encoding,
                                                 positional_encoding_dim)
from spinnerf_tpu_torch.models.hashgrid import _lecun_normal_


class NeRFField(nn.Module):
    """`depth` trunk layers of `width` with the encoded position concatenated
    after each layer in `skips`; a sigma head (and optional semantic head)
    off the trunk; with `use_viewdirs` a feature layer and one width/2 view
    layer on [feature, encoded direction] before the rgb head. Raw channels
    [rgb(3), sigma(1), (logit)] in float32.

    In bfloat16 each layer rounds as flax's `Dense(dtype=bfloat16)` does:
    the product of bf16 operands (f32 accumulation) is rounded to bf16,
    then the bf16 bias is added with a second rounding."""

    def __init__(self, *, depth: int = 8, width: int = 256,
                 skips: Sequence[int] = (4,), multires: int = 10,
                 multires_views: int = 4, use_viewdirs: bool = True,
                 semantic: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        device = resolve_device(device)
        self.depth = depth
        self.width = width
        self.skips = tuple(skips)
        self.multires = multires
        self.multires_views = multires_views
        self.use_viewdirs = use_viewdirs
        self.semantic = semantic
        self.compute_dtype = compute_dtype
        in_ch = positional_encoding_dim(3, multires)
        d_in = in_ch
        for i in range(depth):
            self.add_module(f"trunk_{i}",
                            nn.Linear(d_in, width, device=device))
            d_in = width + (in_ch if i in self.skips else 0)
        self.sigma_head = nn.Linear(d_in, 1, device=device)
        if semantic:
            self.semantic_head = nn.Linear(d_in, 1, device=device)
        if use_viewdirs:
            view_ch = positional_encoding_dim(3, multires_views)
            self.feature = nn.Linear(d_in, width, device=device)
            self.view_0 = nn.Linear(width + view_ch, width // 2, device=device)
            d_in = width // 2
        self.rgb_head = nn.Linear(d_in, 3, device=device)

    def reset_parameters(self, generator=None):
        """flax-default init from a CPU `generator`: lecun-normal kernels
        (fan_in = the layer's input width), zero biases."""
        for lin in self.children():
            _lecun_normal_(lin.weight, generator)
            nn.init.zeros_(lin.bias)

    def _dense(self, name, h):
        lin = getattr(self, name)
        dt = self.compute_dtype
        if dt == torch.float32:
            return nn.functional.linear(h, lin.weight, lin.bias)
        return (nn.functional.linear(h.to(dt), lin.weight.to(dt))
                + lin.bias.to(dt))

    def forward(self, pts, viewdirs=None, frozen_sigma=None):
        """pts [..., 3]; viewdirs [B, 3] against pts [B, S, 3]. Returns
        [..., 4 (+1)] float32. `frozen_sigma` [..., 1] (the frozen-density
        mode, already detached by the caller) is the density, and the sigma
        head is not applied."""
        dt = self.compute_dtype
        pe = positional_encoding(pts, self.multires).to(dt)
        h = pe
        for i in range(self.depth):
            h = torch.relu(self._dense(f"trunk_{i}", h))
            if i in self.skips:
                h = torch.cat([pe, h], dim=-1)
        sigma = (frozen_sigma.float() if frozen_sigma is not None
                 else self._dense("sigma_head", h).float())
        heads = [self._dense("semantic_head", h).float()] if self.semantic \
            else []
        if self.use_viewdirs:
            if viewdirs is None:
                raise ValueError("use_viewdirs=True requires viewdirs")
            feat = self._dense("feature", h)
            vd = viewdirs[..., None, :].expand(*pts.shape[:-1], 3)
            ve = positional_encoding(vd, self.multires_views).to(dt)
            h = torch.relu(self._dense("view_0", torch.cat([feat, ve], -1)))
        rgb = self._dense("rgb_head", h).float()
        return torch.cat([rgb, sigma] + heads, dim=-1)


def make_field_fn(model: nn.Module):
    """The `(pts, viewdirs) -> raw` callable of `core.rendering.render_rays`
    for `model`."""
    def field_fn(pts, viewdirs):
        return model(pts, viewdirs)
    return field_fn
