"""Patch discriminator for LaMa adversarial training (port of
`spinnerf_tpu/models/discriminator.py`), in NCHW.

Parity: pix2pixHD's `NLayerDiscriminator`, big-lama's discriminator
(`lama/saicinpainting/training/modules/pix2pixhd.py`,
`configs/training/big-lama.yaml` `discriminator: pix2pixhd_nlayer`): 4 x 4
convolutions zero-padded by 2, stride 2, LeakyReLU(0.2), BatchNorm
(`models/batchnorm.py`) after every layer but the first, the width doubling
to 512, a stride-1 layer, then a 1-channel logit head. The module names
are the JAX package's (`conv0`, `conv{i}` / `bn{i}`, `conv_last` /
`bn_last`, `head`); `convert.discriminator_state_dict` carries its
variables across.
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from spinnerf_tpu_torch import resolve_device
from spinnerf_tpu_torch.models.batchnorm import BatchNorm2d, flax_init_


class NLayerDiscriminator(nn.Module):
    """x [N, input_nc, H, W] -> (logits [N, 1, h, w], the feature maps
    after each layer's activation)."""

    def __init__(self, ndf: int = 64, n_layers: int = 4, input_nc: int = 3,
                 device=None):
        super().__init__()
        self.n_layers = n_layers
        self.conv0 = nn.Conv2d(input_nc, ndf, 4, 2, 2)
        nf = ndf
        for i in range(1, n_layers):
            nf_prev, nf = nf, min(nf * 2, 512)
            setattr(self, f"conv{i}", nn.Conv2d(nf_prev, nf, 4, 2, 2,
                                                bias=False))
            setattr(self, f"bn{i}", BatchNorm2d(nf))
        nf_prev, nf = nf, min(nf * 2, 512)
        self.conv_last = nn.Conv2d(nf_prev, nf, 4, 1, 2, bias=False)
        self.bn_last = BatchNorm2d(nf)
        self.head = nn.Conv2d(nf, 1, 4, 1, 2)
        self.to(resolve_device(device))

    def reset_parameters(self, generator=None):
        """flax's default initialisers from a CPU `generator`."""
        return flax_init_(self, generator)

    def forward(self, x):
        feats = []
        h = F.leaky_relu(self.conv0(x), 0.2)
        feats.append(h)
        for i in range(1, self.n_layers):
            h = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(h))
            h = F.leaky_relu(h, 0.2)
            feats.append(h)
        h = F.leaky_relu(self.bn_last(self.conv_last(h)), 0.2)
        feats.append(h)
        return self.head(h), feats
