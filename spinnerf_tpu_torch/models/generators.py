"""The pix2pixHD generator / discriminator zoo and the model factories
(port of `spinnerf_tpu/models/generators.py`), in NCHW.

Parity: `lama/saicinpainting/training/modules/pix2pixhd.py`
(`GlobalGenerator:341`, `MultiDilatedGlobalGenerator:178`,
`MultidilatedNLayerDiscriminator:616`, `ResnetBlock:30`),
`multidilated_conv.py:6` (`MultidilatedConv`), `ffc.py:370`
(`FFCNLayerDiscriminator`) and the factories of `modules/__init__.py:7,22`:
the architectures the reference's config tree can select besides big-lama's
pair (`models/lama.py`, `models/discriminator.py`). No entry point builds
them. Module names are the JAX package's; `convert.flax_state_dict` (and
`convert.ffc_discriminator_state_dict`) carry its variables across.
Reflect padding as in JAX; BatchNorm is `models/batchnorm.py`'s.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from spinnerf_tpu_torch import resolve_device
from spinnerf_tpu_torch.models.batchnorm import BatchNorm2d
from spinnerf_tpu_torch.models.lama import FFCBnAct, FFCResNetGenerator
from spinnerf_tpu_torch.models.lpips import _f32_convs


def _reflect(x, pad: int):
    """numpy's (and `jnp.pad`'s) reflect padding of H and W by `pad`,
    which may exceed a side (the reflection repeats; torch's reflect mode
    takes pads under the side only)."""
    if not pad:
        return x
    h, w = x.shape[2:]
    if pad < min(h, w):
        return F.pad(x, (pad,) * 4, mode="reflect")

    def index(n):
        i = torch.arange(-pad, n + pad, device=x.device)
        period = max(2 * (n - 1), 1)
        m = i % period
        return torch.where(m < n, m, period - m)
    return x[:, :, index(h)][:, :, :, index(w)]


class MultidilatedConv(nn.Module):
    """Parallel reflect-padded convs at dilations min_dilation * 2^i,
    summed (`multidilated_conv.py:6-65`, comb_mode 'sum'); `dil{i}`."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 dilation_num: int = 3, min_dilation: int = 1,
                 use_bias: bool = True):
        super().__init__()
        self.kernel = kernel
        self.dilations = [min_dilation * 2 ** i for i in range(dilation_num)]
        for i, d in enumerate(self.dilations):
            setattr(self, f"dil{i}", nn.Conv2d(cin, features, kernel,
                                               dilation=d, bias=use_bias))

    def forward(self, x):
        out = 0.0
        for i, d in enumerate(self.dilations):
            out = out + getattr(self, f"dil{i}")(
                _reflect(x, (self.kernel - 1) // 2 * d))
        return out


class ResnetBlock(nn.Module):
    """pix2pixHD residual block: two reflect-padded 3 x 3 conv + BN (ReLU
    after the first) (`pix2pixhd.py:30-89`); `multidilated` swaps the
    convs for `MultidilatedConv` (`MultidilatedResnetBlock:155-175`)."""

    def __init__(self, features: int, dilation: int = 1,
                 multidilated: bool = False):
        super().__init__()
        self.dilation = dilation
        self.multidilated = multidilated
        for name in ("conv1", "conv2"):
            setattr(self, name,
                    MultidilatedConv(features, features) if multidilated
                    else nn.Conv2d(features, features, 3, dilation=dilation))
        self.bn1 = BatchNorm2d(features)
        self.bn2 = BatchNorm2d(features)

    def _conv(self, conv, h):
        return conv(h) if self.multidilated else \
            conv(_reflect(h, self.dilation))

    def forward(self, x):
        h = torch.relu(self.bn1(self._conv(self.conv1, x)))
        h = self.bn2(self._conv(self.conv2, h))
        return x + h


class GlobalGenerator(nn.Module):
    """pix2pixHD GlobalGenerator (`pix2pixhd.py:341-436`): a 7 x 7 stem,
    stride-2 downsamples, a residual bottleneck, transpose-conv upsamples
    (k 3, s 2, p 1, output_padding 1) and a 7 x 7 head with tanh, sigmoid
    or no activation. `multidilated=True` is `MultiDilatedGlobalGenerator`
    (`pix2pixhd.py:178-236`)."""

    def __init__(self, input_nc: int = 4, output_nc: int = 3, ngf: int = 64,
                 n_downsampling: int = 3, n_blocks: int = 9,
                 max_features: int = 1024, multidilated: bool = False,
                 out_act: str = "tanh", device=None):
        super().__init__()
        maxf = max_features
        self.n_down, self.n_blocks, self.out_act = (n_downsampling, n_blocks,
                                                    out_act)
        self.stem = nn.Conv2d(input_nc, ngf, 7)
        self.stem_bn = BatchNorm2d(ngf)
        c = ngf
        for i in range(n_downsampling):
            cout = min(maxf, ngf * 2 ** i * 2)
            setattr(self, f"down{i}", nn.Conv2d(c, cout, 3, 2))
            setattr(self, f"down{i}_bn", BatchNorm2d(cout))
            c = cout
        feats = min(maxf, ngf * 2 ** n_downsampling)
        for i in range(n_blocks):
            setattr(self, f"block{i}", ResnetBlock(feats,
                                                   multidilated=multidilated))
        c = feats
        for i in range(n_downsampling):
            cout = min(maxf, ngf * 2 ** (n_downsampling - i) // 2)
            setattr(self, f"up{i}", nn.ConvTranspose2d(
                c, cout, 3, stride=2, padding=1, output_padding=1))
            setattr(self, f"up{i}_bn", BatchNorm2d(cout))
            c = cout
        self.head = nn.Conv2d(c, output_nc, 7)
        self.to(resolve_device(device))

    def forward(self, x):
        with _f32_convs():
            h = torch.relu(self.stem_bn(self.stem(_reflect(x, 3))))
            for i in range(self.n_down):
                h = getattr(self, f"down{i}")(_reflect(h, 1))
                h = torch.relu(getattr(self, f"down{i}_bn")(h))
            for i in range(self.n_blocks):
                h = getattr(self, f"block{i}")(h)
            for i in range(self.n_down):
                h = torch.relu(getattr(self, f"up{i}_bn")(
                    getattr(self, f"up{i}")(h)))
            h = self.head(_reflect(h, 3))
        if self.out_act == "tanh":
            return torch.tanh(h)
        if self.out_act == "sigmoid":
            return torch.sigmoid(h)
        return h


def MultiDilatedGlobalGenerator(**kwargs):
    """`pix2pixhd.py:178`: GlobalGenerator with multidilated blocks."""
    return GlobalGenerator(multidilated=True, **kwargs)


class MultidilatedNLayerDiscriminator(nn.Module):
    """Patch discriminator of multidilated convs (`pix2pixhd.py:616-664`),
    stride 2 as a 2 x 2 average pool after each stride-1 conv. Returns
    (logits, feature maps)."""

    def __init__(self, ndf: int = 64, n_layers: int = 4, input_nc: int = 3,
                 device=None):
        super().__init__()
        self.n_layers = n_layers
        self.conv0 = MultidilatedConv(input_nc, ndf)
        nf = ndf
        for i in range(1, n_layers):
            nf_prev, nf = nf, min(nf * 2, 512)
            setattr(self, f"conv{i}", MultidilatedConv(nf_prev, nf,
                                                       use_bias=False))
            setattr(self, f"bn{i}", BatchNorm2d(nf))
        nf_prev, nf = nf, min(nf * 2, 512)
        self.conv_last = MultidilatedConv(nf_prev, nf, use_bias=False)
        self.bn_last = BatchNorm2d(nf)
        self.out = nn.Conv2d(nf, 1, 3, padding=1)
        self.to(resolve_device(device))

    def forward(self, x):
        feats = []
        with _f32_convs():
            h = F.leaky_relu(F.avg_pool2d(self.conv0(x), 2, 2), 0.2)
            feats.append(h)
            for i in range(1, self.n_layers):
                h = F.avg_pool2d(getattr(self, f"conv{i}")(h), 2, 2)
                h = F.leaky_relu(getattr(self, f"bn{i}")(h), 0.2)
                feats.append(h)
            h = F.leaky_relu(self.bn_last(self.conv_last(h)), 0.2)
            feats.append(h)
            return self.out(h), feats


class FFCNLayerDiscriminator(nn.Module):
    """FFC patch discriminator (`ffc.py:370-433`): FFC + BN + leaky ReLU
    layers, the global share `ratio_g` after the first, the branches
    concatenated for each feature map and the head. Returns (logits,
    feature maps)."""

    def __init__(self, ndf: int = 64, n_layers: int = 3, input_nc: int = 3,
                 max_features: int = 512, ratio_g: float = 0.5,
                 device=None):
        super().__init__()
        self.n_layers = n_layers
        self.conv0 = FFCBnAct(input_nc, ndf, 3, act="leaky")
        nf = ndf
        for i in range(1, n_layers):
            nf_prev, nf = nf, min(nf * 2, max_features)
            setattr(self, f"conv{i}", FFCBnAct(
                nf_prev, nf, 3, 0.0 if i == 1 else ratio_g, ratio_g,
                stride=2, act="leaky"))
        nf_prev, nf = nf, min(nf * 2, 512)
        self.conv_last = FFCBnAct(nf_prev, nf, 3, ratio_g, ratio_g,
                                  act="leaky")
        self.out = nn.Conv2d(nf, 1, 3, padding=1)
        self.to(resolve_device(device))

    @staticmethod
    def _cat(h):
        h_l, h_g = h
        return h_l if h_g is None else torch.cat([h_l, h_g], dim=1)

    def forward(self, x):
        feats = []
        with _f32_convs():
            h = self.conv0((x, None))
            feats.append(self._cat(h))
            for i in range(1, self.n_layers):
                h = getattr(self, f"conv{i}")(h)
                feats.append(self._cat(h))
            y = self._cat(self.conv_last(h))
            feats.append(y)
            return self.out(y), feats


def make_generator(kind: str, **kwargs):
    """Generator factory (`modules/__init__.py:7-19`): `ffc_resnet`
    (big-lama's), `pix2pixhd_global`, `pix2pixhd_multidilated`."""
    if kind == "ffc_resnet":
        return FFCResNetGenerator(**kwargs)
    if kind == "pix2pixhd_global":
        return GlobalGenerator(**kwargs)
    if kind == "pix2pixhd_multidilated":
        return MultiDilatedGlobalGenerator(**kwargs)
    raise ValueError(f"Unknown generator kind {kind}")


def make_discriminator(kind: str, **kwargs):
    """Discriminator factory (`modules/__init__.py:22-32` and `ffc.py:370`):
    `pix2pixhd_nlayer` (big-lama's), `pix2pixhd_nlayer_multidilated`,
    `ffc_nlayer`."""
    from spinnerf_tpu_torch.models.discriminator import NLayerDiscriminator
    if kind == "pix2pixhd_nlayer":
        return NLayerDiscriminator(**kwargs)
    if kind == "pix2pixhd_nlayer_multidilated":
        return MultidilatedNLayerDiscriminator(**kwargs)
    if kind == "ffc_nlayer":
        return FFCNLayerDiscriminator(**kwargs)
    raise ValueError(f"Unknown discriminator kind {kind}")
