"""LPIPS perceptual distance, VGG16 variant (port of
`spinnerf_tpu/models/lpips.py`).

Zhang et al. 2018, as the reference uses it for the patch perceptual loss
(`DS_NeRF/run_nerf.py:970-974,1523-1561`): inputs scaled to [-1, 1], the
shift/scale normalisation, VGG16 conv features after relu 1_2, 2_2, 3_3,
4_3 and 5_3, each unit-normalised over channels, the squared difference
weighted per channel by the non-negative linear heads, a spatial mean and
a sum over the five layers.

The repo holds no VGG16 or LPIPS weights. `load_lpips` takes, in order,
explicit torchvision-format files, files dropped into
`$SPINNERF_WEIGHTS_DIR` (`weights.py`), or a seeded random VGG (flax's Conv
default: truncated lecun-normal kernels, zero biases) with uniform 1/C
heads. A random VGG is a random-projection perceptual metric, not
numerically LPIPS, so `load_lpips_labeled` names its results
"lpips_random_vgg" unless both files back it. The tests carry the JAX
package's random VGG across with `convert.lpips_state_dict`.

The convolutions are `torch.nn.functional.conv2d` in NCHW. The JAX module
runs them at `Precision.HIGHEST`; PyTorch lets cuDNN take TF32 for float32
convolutions by default, so the trunk runs forward and backward with
cuDNN's TF32 off. The parameters are frozen: the gradient reaches the
input only.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from spinnerf_tpu_torch import resolve_device
from spinnerf_tpu_torch import weights as wreg
from spinnerf_tpu_torch.models.hashgrid import _lecun_normal_

# VGG16 conv plan: (out_channels, 2x2 max-pool before, feature tap after)
_VGG_PLAN = [
    (64, False, False), (64, False, True),
    (128, True, False), (128, False, True),
    (256, True, False), (256, False, False), (256, False, True),
    (512, True, False), (512, False, False), (512, False, True),
    (512, True, False), (512, False, False), (512, False, True),
]
FEATURE_CHANNELS = (64, 128, 256, 512, 512)
# four 2x2 pools: a side under 16 leaves relu 5_3 without a pixel, and the
# JAX module's spatial mean of that empty map is NaN
MIN_SIDE = 16

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


@contextlib.contextmanager
def _f32_convs():
    """TF32 off for cuDNN convolutions and CUDA matmuls within the block,
    the previous settings restored after. The backward of a graph built
    inside runs under whatever is set when it runs."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


class _F32Trunk(torch.autograd.Function):
    """The trunk with TF32 off in both passes. The backward runs outside
    the forward's context, so the forward builds the trunk's graph under
    its own and the backward differentiates that graph under it again."""

    @staticmethod
    def forward(ctx, x, vgg):
        xd = x.detach().requires_grad_()
        with torch.enable_grad(), _f32_convs():
            feats = vgg.trunk(xd)
        ctx.graph = (xd, feats)
        return tuple(f.detach() for f in feats)

    @staticmethod
    def backward(ctx, *grads):
        xd, feats = ctx.graph
        del ctx.graph
        pairs = [(f, g) for f, g in zip(feats, grads) if g is not None]
        with _f32_convs():
            (gx,) = torch.autograd.grad([f for f, _ in pairs], xd,
                                        [g for _, g in pairs])
        return gx, None


class VGG16Features(nn.Module):
    """The 13 VGG16 convolutions (`conv_0` ... `conv_12`, the flax module's
    names); `forward` maps a normalised [N, 3, H, W] batch to the five
    feature maps, max-pooling 2 x 2 / stride 2 (floor) before blocks 2-5."""

    def __init__(self, device=None):
        super().__init__()
        device = resolve_device(device)
        c_in = 3
        for i, (ch, _, _) in enumerate(_VGG_PLAN):
            self.add_module(f"conv_{i}", nn.Conv2d(c_in, ch, 3, padding=1,
                                                   device=device))
            c_in = ch
        self.requires_grad_(False)

    def reset_parameters(self, generator=None):
        """flax's Conv default from a CPU `generator`: truncated lecun-normal
        kernels (fan_in = 9 x input channels), zero biases."""
        for conv in self.children():
            _lecun_normal_(conv.weight, generator)
            nn.init.zeros_(conv.bias)

    def trunk(self, x):
        feats = []
        h = x
        for i, (_, pool, tap) in enumerate(_VGG_PLAN):
            if pool:
                h = F.max_pool2d(h, 2, 2)
            conv = getattr(self, f"conv_{i}")
            h = torch.relu(F.conv2d(h, conv.weight, conv.bias, padding=1))
            if tap:
                feats.append(h)
        return feats

    def forward(self, x):
        if torch.is_grad_enabled() and x.requires_grad:
            return list(_F32Trunk.apply(x, self))
        with _f32_convs():
            return self.trunk(x)


def _unit_normalize(f, eps=1e-10):
    return f / (torch.sqrt(torch.sum(f ** 2, dim=1, keepdim=True)) + eps)


def lpips_distance(vgg: VGG16Features, lin_weights, x, y):
    """LPIPS(x, y) per image: x, y [N, H, W, 3] (or [H, W, 3]) in [0, 1];
    lin_weights the five [C_l] heads. Returns [N] (a scalar if unbatched).
    Both sides run through the trunk as one batch."""
    squeeze = x.ndim == 3
    if squeeze:
        x, y = x[None], y[None]
    n, h, w = x.shape[:3]
    if min(h, w) < MIN_SIDE:
        raise ValueError(f"LPIPS needs images of at least {MIN_SIDE} x "
                         f"{MIN_SIDE} pixels (VGG16 pools 2 x 2 four times); "
                         f"got {h} x {w}")
    shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)
    scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)

    def norm_input(img):
        img = img * 2.0 - 1.0
        return ((img - shift) / scale).permute(0, 3, 1, 2)

    feats = vgg(torch.cat([norm_input(x), norm_input(y)]))
    total = 0.0
    for f, wl in zip(feats, lin_weights):
        d = (_unit_normalize(f[:n]) - _unit_normalize(f[n:])) ** 2
        d = torch.sum(d * wl.to(d.dtype).view(1, -1, 1, 1), dim=1)
        total = total + torch.mean(d, dim=(1, 2))
    return total[0] if squeeze else total


class LPIPS(nn.Module):
    """The VGG16 trunk (`vgg`) and the five linear heads (buffers `lin0` ...
    `lin4`, uniform 1/C until loaded); `lpips(x, y)` is
    `lpips_distance`."""

    def __init__(self, device=None):
        super().__init__()
        device = resolve_device(device)
        self.vgg = VGG16Features(device=device)
        for l, c in enumerate(FEATURE_CHANNELS):
            self.register_buffer(f"lin{l}", torch.full((c,), 1.0 / c,
                                                       device=device))

    @property
    def lin_weights(self):
        return [getattr(self, f"lin{l}") for l in range(len(FEATURE_CHANNELS))]

    def forward(self, x, y):
        return lpips_distance(self.vgg, self.lin_weights, x, y)


def load_vgg_params_from_torch(path, vgg: VGG16Features):
    """Load a torchvision-format VGG16 `state_dict` (features.* keys) into
    `vgg`'s convolutions, in the order of their feature index."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    conv_keys = sorted(
        (k for k in sd if k.endswith(".weight") and sd[k].ndim == 4),
        key=lambda k: int(k.split(".")[1]) if k.split(".")[0] == "features"
        else 0)
    if len(conv_keys) < len(_VGG_PLAN):
        raise ValueError(f"{path}: {len(conv_keys)} convolution weights, "
                         f"VGG16 has {len(_VGG_PLAN)}")
    with torch.no_grad():
        for i, k in enumerate(conv_keys[:len(_VGG_PLAN)]):
            conv = getattr(vgg, f"conv_{i}")
            conv.weight.copy_(sd[k])
            conv.bias.copy_(sd[k[:-len("weight")] + "bias"])
    return vgg


def load_lin_weights_from_torch(path):
    """The LPIPS linear heads (`lin{i}.model.1.weight` [1, C, 1, 1]) as five
    [C] tensors, clamped at 0."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return [torch.clamp(sd[f"lin{i}.model.1.weight"].reshape(-1).float(),
                        min=0.0) for i in range(len(FEATURE_CHANNELS))]


def load_lpips(vgg_weights_path=None, lin_weights_path=None, *,
               seed: int = 0, device=None,
               require_weights: bool = False) -> LPIPS:
    """An `LPIPS` module on `device`: explicit paths, else files in
    `$SPINNERF_WEIGHTS_DIR`, else the seeded random VGG and uniform heads
    (NOT numerically LPIPS); `require_weights` raises
    `weights.MissingWeightsError` instead of falling back."""
    find = wreg.require if require_weights else wreg.find
    if vgg_weights_path is None:
        vgg_weights_path = find("vgg16")
    if lin_weights_path is None:
        lin_weights_path = find("lpips_lin")
    model = LPIPS(device=device)
    if vgg_weights_path is not None:
        load_vgg_params_from_torch(vgg_weights_path, model.vgg)
    else:
        model.vgg.reset_parameters(torch.Generator().manual_seed(seed))
    if lin_weights_path is not None:
        with torch.no_grad():
            for buf, wl in zip(model.lin_weights,
                               load_lin_weights_from_torch(lin_weights_path)):
                buf.copy_(wl)
    return model


def load_lpips_labeled(vgg_weights_path=None, lin_weights_path=None, **kw):
    """(lpips, key): the key is "lpips" only when both a VGG16 backbone and
    the LPIPS heads are found; any random fallback labels the results
    "lpips_random_vgg", so that they never read as published LPIPS."""
    vgg = vgg_weights_path or wreg.find("vgg16")
    lin = lin_weights_path or wreg.find("lpips_lin")
    key = "lpips" if (vgg and lin) else "lpips_random_vgg"
    return load_lpips(vgg, lin, **kw), key
