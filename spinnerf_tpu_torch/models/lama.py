"""LaMa's fast-Fourier-convolution inpainting generator (port of
`spinnerf_tpu/models/lama.py`), in NCHW.

The modules keep the reference's tree (`lama/saicinpainting/training/
modules/ffc.py`), so a big-lama generator `state_dict` loads with
`strict=True` at any `n_blocks`, where the JAX package needs
`convert_big_lama`:

- `FourierUnit` (`fu`): rfft2 -> 1x1 `conv_layer` + `bn` + ReLU on the
  (re, im)-interleaved channels -> the inverse below (`ffc.py:49-113`);
- `SpectralTransform` (`convg2g`): `conv1` (1x1, BN, ReLU) -> `fu` (+ the
  local Fourier unit `lfu`) -> residual 1x1 `conv2` (`ffc.py:116-163`);
- `FFC` (`ffc`): the local / global branches `convl2l`, `convl2g`,
  `convg2l`, `convg2g`, reflect-padded (`ffc.py:166-225`);
- `FFCBnAct` (`bn_l`, `bn_g`, ReLU or leaky ReLU), `FFCResnetBlock`
  (`conv1`, `conv2`, residual) and `ConcatTupleLayer`;
- `FFCResNetGenerator`: one `nn.Sequential` named `model` — the reflect
  pad (`model.0`), the 7x7 stem (`model.1`), three stride-2 downsamples
  (`model.2-4`), `n_blocks` blocks (`model.5...`), the concat layer, three
  (ConvTranspose2d(k 3, s 2, p 1, output_padding 1), BN, ReLU) triples, the
  reflect pad, the 7x7 head and the sigmoid (`ffc.py:305-367`,
  big-lama.yaml). `front` (pad, stem, downsamples -> the latent pair) and
  `rear` (the rest) split it as the refiner does.

BatchNorm is `models/batchnorm.py`'s: in `eval()` mode (the default) it
normalises with the running statistics (eps 1e-5, as flax's); in `train()`
mode with the batch's, updating the running ones as flax does. The
convolutions run in f32 with TF32 off on the card.

The inverse FFT: after the 1x1 conv, BN and ReLU the half spectrum that
`FourierUnit` inverts is not Hermitian, so "irfft2" of it is a choice. The
JAX package takes the real part of a full complex ifft2 with the mirrored
columns rebuilt from the half spectrum (`lama.py:55-71`). The same function
is computed here explicitly and on every device alike: a complex ifft over
H, the imaginary part of the DC column (and of the Nyquist column when W is
even) set to 0, then a 1-D irfft over W of length W. cuFFT's 2-D C2R leaves
its result on non-Hermitian input unspecified.
"""
from __future__ import annotations

import torch
from torch import nn

from spinnerf_tpu_torch import resolve_device
from spinnerf_tpu_torch.models.batchnorm import BatchNorm2d, flax_init_
from spinnerf_tpu_torch.models.lpips import _f32_convs


def irfft2_half(spec, h: int, w: int):
    """The JAX package's inverse of a half spectrum [..., H, W // 2 + 1]
    (`irfft2_via_c2c`, ortho): the real part of the complex ifft2 of the
    spectrum completed by its mirrored columns. Returns [..., H, W]."""
    y = torch.fft.ifft(spec, dim=-2, norm="ortho")
    keep = torch.ones(spec.shape[-1], device=spec.device)
    keep[0] = 0.0
    if w % 2 == 0:
        keep[-1] = 0.0
    y = torch.complex(y.real, y.imag * keep)
    return torch.fft.irfft(y, n=w, dim=-1, norm="ortho")


class FourierUnit(nn.Module):
    """Spectral 1x1 conv: rfft2 -> conv + BN + ReLU on the interleaved
    (re, im) channels (channel 2c + 0 the real part of channel c, 2c + 1
    its imaginary part) -> `irfft2_half`."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv_layer = nn.Conv2d(2 * in_channels, 2 * out_channels, 1,
                                    bias=False)
        self.bn = BatchNorm2d(2 * out_channels)

    def forward(self, x):
        n, c, h, w = x.shape
        f = torch.fft.rfft2(x, norm="ortho")                  # [N, C, H, Wf]
        f = torch.stack((f.real, f.imag), dim=2).reshape(n, 2 * c, h, -1)
        f = torch.relu(self.bn(self.conv_layer(f)))
        f = f.reshape(n, -1, 2, h, f.shape[-1])
        return irfft2_half(torch.complex(f[:, :, 0], f[:, :, 1]), h, w)


class SpectralTransform(nn.Module):
    """conv1 (1x1 + BN + ReLU) -> FourierUnit (+ LFU) -> residual 1x1
    conv2. With `enable_lfu` the first quarter of the channels is cut into
    2 x 2 spatial quadrants stacked on channels, Fourier-transformed, and
    tiled back (the JAX package's halves, `lama.py:140-146`)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 enable_lfu: bool = False):
        super().__init__()
        self.stride = stride
        self.enable_lfu = enable_lfu
        half = out_channels // 2
        self.conv1 = nn.Sequential(
            nn.Conv2d(in_channels, half, 1, bias=False),
            BatchNorm2d(half), nn.ReLU())
        self.fu = FourierUnit(half, half)
        if enable_lfu:
            self.lfu = FourierUnit(half, half)
        self.conv2 = nn.Conv2d(half, out_channels, 1, bias=False)

    def forward(self, x):
        if self.stride == 2:
            x = nn.functional.avg_pool2d(x, 2, 2)
        x = self.conv1(x)
        out = self.fu(x)
        if self.enable_lfu:
            xs = x[:, : x.shape[1] // 4]
            xs = torch.cat(torch.chunk(xs, 2, dim=2), dim=1)
            xs = torch.cat(torch.chunk(xs, 2, dim=3), dim=1)
            out = out + self.lfu(xs).repeat(1, 1, 2, 2)
        return self.conv2(x + out)


def _conv(cin, cout, kernel, stride, padding, dilation):
    return nn.Conv2d(cin, cout, kernel, stride, padding, dilation,
                     bias=False, padding_mode="reflect")


class FFC(nn.Module):
    """The dual-branch fast Fourier convolution on a (local, global) pair;
    either side is None when its channel count is 0. The spatial convs pad
    by reflection, `padding` pixels (default: the kernel's half-width)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 ratio_gin: float = 0.0, ratio_gout: float = 0.0,
                 stride: int = 1, dilation: int = 1,
                 enable_lfu: bool = False, padding: int | None = None):
        super().__init__()
        pad = (kernel - 1) // 2 * dilation if padding is None else padding
        in_cg = int(in_channels * ratio_gin)
        in_cl = in_channels - in_cg
        out_cg = int(out_channels * ratio_gout)
        out_cl = out_channels - out_cg
        if in_cl and out_cl:
            self.convl2l = _conv(in_cl, out_cl, kernel, stride, pad,
                                 dilation)
        if in_cl and out_cg:
            self.convl2g = _conv(in_cl, out_cg, kernel, stride, pad,
                                 dilation)
        if in_cg and out_cl:
            self.convg2l = _conv(in_cg, out_cl, kernel, stride, pad,
                                 dilation)
        if in_cg and out_cg:
            self.convg2g = SpectralTransform(in_cg, out_cg, stride,
                                             enable_lfu)
        self.out_cl, self.out_cg = out_cl, out_cg

    def forward(self, x):
        x_l, x_g = x if isinstance(x, tuple) else (x, None)

        def branch(n_out, local, glob):
            if not n_out:
                return None
            out = 0.0
            if x_l is not None and hasattr(self, local):
                out = getattr(self, local)(x_l)
            if x_g is not None and hasattr(self, glob):
                out = out + getattr(self, glob)(x_g)
            return out
        return (branch(self.out_cl, "convl2l", "convg2l"),
                branch(self.out_cg, "convl2g", "convg2g"))


class FFCBnAct(nn.Module):
    """FFC, then BN and the activation on each branch: "relu" (the
    generator) or "leaky" (slope 0.2, the FFC discriminator)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 ratio_gin: float = 0.0, ratio_gout: float = 0.0,
                 stride: int = 1, dilation: int = 1,
                 enable_lfu: bool = False, act: str = "relu",
                 padding: int | None = None):
        super().__init__()
        self.ffc = FFC(in_channels, out_channels, kernel, ratio_gin,
                       ratio_gout, stride, dilation, enable_lfu, padding)
        if self.ffc.out_cl:
            self.bn_l = BatchNorm2d(self.ffc.out_cl)
        if self.ffc.out_cg:
            self.bn_g = BatchNorm2d(self.ffc.out_cg)
        self.act = (nn.functional.relu if act == "relu" else
                    lambda h: nn.functional.leaky_relu(h, 0.2))

    def forward(self, x):
        x_l, x_g = self.ffc(x)
        if x_l is not None:
            x_l = self.act(self.bn_l(x_l))
        if x_g is not None:
            x_g = self.act(self.bn_g(x_g))
        return x_l, x_g


class FFCResnetBlock(nn.Module):
    """Two FFCBnAct layers with a residual on each branch."""

    def __init__(self, channels: int, ratio: float = 0.75,
                 dilation: int = 1, enable_lfu: bool = False):
        super().__init__()
        self.conv1 = FFCBnAct(channels, channels, 3, ratio, ratio,
                              dilation=dilation, enable_lfu=enable_lfu)
        self.conv2 = FFCBnAct(channels, channels, 3, ratio, ratio,
                              dilation=dilation, enable_lfu=enable_lfu)

    def forward(self, x):
        x_l, x_g = self.conv2(self.conv1(x))
        return x[0] + x_l, x[1] + x_g


class ConcatTupleLayer(nn.Module):
    """(local, global) -> one tensor, the channels concatenated."""

    def forward(self, x):
        x_l, x_g = x
        return x_l if x_g is None else torch.cat([x_l, x_g], dim=1)


class FFCResNetGenerator(nn.Module):
    """The big-lama generator: input [N, 4, H, W] (the masked RGB and the
    mask, H and W multiples of 8), output [N, 3, H, W] in (0, 1).

    Built on `device` (the card unless the caller asks for the CPU) in
    inference mode (`train()` for flax's training-mode BatchNorm). Its
    parameters are seeded random until a checkpoint is
    loaded (`reset_parameters`)."""

    def __init__(self, input_nc: int = 4, output_nc: int = 3, ngf: int = 64,
                 n_downsampling: int = 3, n_blocks: int = 18,
                 ratio_g: float = 0.75, max_features: int = 1024,
                 enable_lfu: bool = False, device=None):
        super().__init__()
        self.n_front = 2 + n_downsampling
        model = [nn.ReflectionPad2d(3),
                 FFCBnAct(input_nc, ngf, kernel=7, padding=0)]
        for i in range(n_downsampling):
            mult = 2 ** i
            gout = ratio_g if i == n_downsampling - 1 else 0.0
            model.append(FFCBnAct(min(max_features, ngf * mult),
                                  min(max_features, ngf * mult * 2),
                                  kernel=3, stride=2, ratio_gout=gout))
        feats = min(max_features, ngf * 2 ** n_downsampling)
        model += [FFCResnetBlock(feats, ratio_g, enable_lfu=enable_lfu)
                  for _ in range(n_blocks)]
        model.append(ConcatTupleLayer())
        for i in range(n_downsampling):
            mult = 2 ** (n_downsampling - i)
            cout = min(max_features, ngf * mult // 2)
            model += [nn.ConvTranspose2d(min(max_features, ngf * mult), cout,
                                         3, stride=2, padding=1,
                                         output_padding=1),
                      BatchNorm2d(cout), nn.ReLU()]
        model += [nn.ReflectionPad2d(3), nn.Conv2d(ngf, output_nc, 7),
                  nn.Sigmoid()]
        self.model = nn.Sequential(*model)
        self.to(resolve_device(device))
        self.eval()

    def reset_parameters(self, generator=None):
        """Seeded random weights from a CPU `generator`: lecun-normal
        kernels (fan_in the inputs of one output), zero biases, BN scale 1,
        bias 0, mean 0, variance 1 — flax's default initialisers, drawn
        from another random stream than `jax.random`, so they cannot equal
        the JAX package's random generator."""
        return flax_init_(self, generator)

    def front(self, x):
        """Pad, stem and downsamples -> the latent pair (z_l, z_g)."""
        with _f32_convs():
            return self.model[:self.n_front](x)

    def rear(self, z):
        """Blocks, upsamples and head on the latent pair -> RGB."""
        with _f32_convs():
            return self.model[self.n_front:](z)

    def forward(self, x):
        return self.rear(self.front(x))
