"""InceptionV3 FID feature extractor, pool3 (2048-d) (port of
`spinnerf_tpu/models/inception.py`), in NCHW.

Parity: `lama/saicinpainting/evaluation/losses/fid/inception.py`, the
pytorch-fid InceptionV3 the reference uses for FID and for the
`ssim_fid100_f1` checkpoint monitor, with its three TensorFlow-parity
patches (inception.py:171-323):
- the pool branches of InceptionA / C and Mixed_7b average with
  `count_include_pad=False`;
- Mixed_7c's pool branch takes the MAX;
- the input is resized to 299 x 299 bilinearly (half-pixel centres, no
  antialias: `align_corners=False`) and scaled to [-1, 1].

Inference only: each Conv + BN(eps 1e-3) + ReLU `BasicConv2d` is folded
into one convolution with a bias when the weights are read
(`load_inception_params_from_torch`). `FIDInceptionV3` holds the folded
convolutions under torchvision's module names (`Mixed_5b.branch1x1`, ...),
so its state dict is {"<block>.<branch>.weight" [out, in, kh, kw],
".bias"}. `random_inception_params` draws the JAX package's numpy-seeded
random network (not comparable to published FID), equal to it from the
same seed; `convert.inception_state_dict` carries any JAX parameters
across.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from spinnerf_tpu_torch import resolve_device
from spinnerf_tpu_torch.models.lpips import _f32_convs

_BN_EPS = 1e-3
_V = ((0, 0), (0, 0))

# conv spec: (branch name, c_in, c_out, (kh, kw), stride, ((ph, ph), (pw, pw)))


def _a(cin, pool):
    return [("branch1x1", cin, 64, (1, 1), 1, _V),
            ("branch5x5_1", cin, 48, (1, 1), 1, _V),
            ("branch5x5_2", 48, 64, (5, 5), 1, ((2, 2), (2, 2))),
            ("branch3x3dbl_1", cin, 64, (1, 1), 1, _V),
            ("branch3x3dbl_2", 64, 96, (3, 3), 1, ((1, 1), (1, 1))),
            ("branch3x3dbl_3", 96, 96, (3, 3), 1, ((1, 1), (1, 1))),
            ("branch_pool", cin, pool, (1, 1), 1, _V)]


def _b(cin):
    return [("branch3x3", cin, 384, (3, 3), 2, _V),
            ("branch3x3dbl_1", cin, 64, (1, 1), 1, _V),
            ("branch3x3dbl_2", 64, 96, (3, 3), 1, ((1, 1), (1, 1))),
            ("branch3x3dbl_3", 96, 96, (3, 3), 2, _V)]


def _c(cin, c7):
    return [("branch1x1", cin, 192, (1, 1), 1, _V),
            ("branch7x7_1", cin, c7, (1, 1), 1, _V),
            ("branch7x7_2", c7, c7, (1, 7), 1, ((0, 0), (3, 3))),
            ("branch7x7_3", c7, 192, (7, 1), 1, ((3, 3), (0, 0))),
            ("branch7x7dbl_1", cin, c7, (1, 1), 1, _V),
            ("branch7x7dbl_2", c7, c7, (7, 1), 1, ((3, 3), (0, 0))),
            ("branch7x7dbl_3", c7, c7, (1, 7), 1, ((0, 0), (3, 3))),
            ("branch7x7dbl_4", c7, c7, (7, 1), 1, ((3, 3), (0, 0))),
            ("branch7x7dbl_5", c7, 192, (1, 7), 1, ((0, 0), (3, 3))),
            ("branch_pool", cin, 192, (1, 1), 1, _V)]


def _d(cin):
    return [("branch3x3_1", cin, 192, (1, 1), 1, _V),
            ("branch3x3_2", 192, 320, (3, 3), 2, _V),
            ("branch7x7x3_1", cin, 192, (1, 1), 1, _V),
            ("branch7x7x3_2", 192, 192, (1, 7), 1, ((0, 0), (3, 3))),
            ("branch7x7x3_3", 192, 192, (7, 1), 1, ((3, 3), (0, 0))),
            ("branch7x7x3_4", 192, 192, (3, 3), 2, _V)]


def _e(cin):
    return [("branch1x1", cin, 320, (1, 1), 1, _V),
            ("branch3x3_1", cin, 384, (1, 1), 1, _V),
            ("branch3x3_2a", 384, 384, (1, 3), 1, ((0, 0), (1, 1))),
            ("branch3x3_2b", 384, 384, (3, 1), 1, ((1, 1), (0, 0))),
            ("branch3x3dbl_1", cin, 448, (1, 1), 1, _V),
            ("branch3x3dbl_2", 448, 384, (3, 3), 1, ((1, 1), (1, 1))),
            ("branch3x3dbl_3a", 384, 384, (1, 3), 1, ((0, 0), (1, 1))),
            ("branch3x3dbl_3b", 384, 384, (3, 1), 1, ((1, 1), (0, 0))),
            ("branch_pool", cin, 192, (1, 1), 1, _V)]


# (kind, torchvision module name, conv specs)
BLOCKS = [
    ("conv", "Conv2d_1a_3x3", [(None, 3, 32, (3, 3), 2, _V)]),
    ("conv", "Conv2d_2a_3x3", [(None, 32, 32, (3, 3), 1, _V)]),
    ("conv", "Conv2d_2b_3x3", [(None, 32, 64, (3, 3), 1, ((1, 1), (1, 1)))]),
    ("maxpool", None, []),
    ("conv", "Conv2d_3b_1x1", [(None, 64, 80, (1, 1), 1, _V)]),
    ("conv", "Conv2d_4a_3x3", [(None, 80, 192, (3, 3), 1, _V)]),
    ("maxpool", None, []),
    ("A", "Mixed_5b", _a(192, 32)),
    ("A", "Mixed_5c", _a(256, 64)),
    ("A", "Mixed_5d", _a(288, 64)),
    ("B", "Mixed_6a", _b(288)),
    ("C", "Mixed_6b", _c(768, 128)),
    ("C", "Mixed_6c", _c(768, 160)),
    ("C", "Mixed_6d", _c(768, 160)),
    ("C", "Mixed_6e", _c(768, 192)),
    ("D", "Mixed_7a", _d(768)),
    ("E1", "Mixed_7b", _e(1280)),
    ("E2", "Mixed_7c", _e(2048)),
]

FEATURE_DIM = 2048


def _spec_conv(spec):
    _, cin, cout, (kh, kw), stride, ((ph, _), (pw, _)) = spec
    return nn.Conv2d(cin, cout, (kh, kw), stride, (ph, pw))


class FIDInceptionV3(nn.Module):
    """The folded InceptionV3 up to pool3: `forward(images [N, 3, H, W] in
    [0, 1]) -> [N, 2048]` (`inception_pool3`). Parameters are zero until a
    state dict is loaded (`random_inception_params`,
    `load_inception_params_from_torch`, `convert.inception_state_dict`)."""

    def __init__(self, device=None):
        super().__init__()
        for kind, name, specs in BLOCKS:
            if kind == "conv":
                self.add_module(name, _spec_conv(specs[0]))
            elif kind != "maxpool":
                self.add_module(name, nn.ModuleDict(
                    {s[0]: _spec_conv(s) for s in specs}))
        for p in self.parameters():
            nn.init.zeros_(p)
        self.to(resolve_device(device)).requires_grad_(False)

    def forward(self, images, *, resize_input=True, normalize_input=True):
        return inception_pool3(self, images, resize_input=resize_input,
                               normalize_input=normalize_input)


def _run(x, block, names):
    for n in names:
        x = torch.relu(block[n](x))
    return x


def _avgpool_nopad(x):
    """3 x 3 / 1 average, padding excluded from the count (the TF-parity
    patch at inception.py:221-225)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _block_a(x, p):
    return torch.cat([
        _run(x, p, ["branch1x1"]),
        _run(x, p, ["branch5x5_1", "branch5x5_2"]),
        _run(x, p, ["branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"]),
        _run(_avgpool_nopad(x), p, ["branch_pool"])], dim=1)


def _block_b(x, p):
    return torch.cat([
        _run(x, p, ["branch3x3"]),
        _run(x, p, ["branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"]),
        F.max_pool2d(x, 3, 2)], dim=1)


def _block_c(x, p):
    return torch.cat([
        _run(x, p, ["branch1x1"]),
        _run(x, p, ["branch7x7_1", "branch7x7_2", "branch7x7_3"]),
        _run(x, p, ["branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3",
                    "branch7x7dbl_4", "branch7x7dbl_5"]),
        _run(_avgpool_nopad(x), p, ["branch_pool"])], dim=1)


def _block_d(x, p):
    return torch.cat([
        _run(x, p, ["branch3x3_1", "branch3x3_2"]),
        _run(x, p, ["branch7x7x3_1", "branch7x7x3_2", "branch7x7x3_3",
                    "branch7x7x3_4"]),
        F.max_pool2d(x, 3, 2)], dim=1)


def _block_e(x, p, pool_kind):
    b3 = _run(x, p, ["branch3x3_1"])
    b3 = torch.cat([_run(b3, p, ["branch3x3_2a"]),
                    _run(b3, p, ["branch3x3_2b"])], dim=1)
    bd = _run(x, p, ["branch3x3dbl_1", "branch3x3dbl_2"])
    bd = torch.cat([_run(bd, p, ["branch3x3dbl_3a"]),
                    _run(bd, p, ["branch3x3dbl_3b"])], dim=1)
    # Mixed_7c pools with MAX: the TF FID network's quirk, kept by the
    # reference (inception.py:299-303)
    pooled = (F.max_pool2d(x, 3, 1, 1) if pool_kind == "max"
              else _avgpool_nopad(x))
    return torch.cat([_run(x, p, ["branch1x1"]), b3, bd,
                      _run(pooled, p, ["branch_pool"])], dim=1)


def inception_pool3(net: FIDInceptionV3, images, *, resize_input=True,
                    normalize_input=True):
    """images [N, 3, H, W] float in [0, 1] -> pool3 features [N, 2048]
    (`InceptionV3.forward`, inception.py:134-169, output_blocks=[3]):
    resize to 299 (bilinear, half-pixel centres, no antialias), scale to
    [-1, 1], every block, a global average pool."""
    x = images if images.is_floating_point() else images.float()
    if resize_input:
        x = F.interpolate(x, (299, 299), mode="bilinear",
                          align_corners=False)
    if normalize_input:
        x = 2.0 * x - 1.0
    with _f32_convs():
        for kind, name, _ in BLOCKS:
            if kind == "maxpool":
                x = F.max_pool2d(x, 3, 2)
                continue
            p = getattr(net, name)
            if kind == "conv":
                x = torch.relu(p(x))
            elif kind == "A":
                x = _block_a(x, p)
            elif kind == "B":
                x = _block_b(x, p)
            elif kind == "C":
                x = _block_c(x, p)
            elif kind == "D":
                x = _block_d(x, p)
            else:
                x = _block_e(x, p, "avg" if kind == "E1" else "max")
    return x.mean(dim=(2, 3))


def _key(name, branch):
    return name if branch is None else f"{name}.{branch}"


def _fold_bn(w_oihw, gamma, beta, mean, var):
    """Fold inference BatchNorm(eps 1e-3) into the preceding conv, in
    float64, as float32 (weight [out, in, kh, kw], bias)."""
    scale = gamma / np.sqrt(var + _BN_EPS)
    return (torch.from_numpy((w_oihw * scale[:, None, None, None])
                             .astype(np.float32)),
            torch.from_numpy((beta - mean * scale).astype(np.float32)))


def load_inception_params_from_torch(path) -> dict:
    """A torchvision-format `inception_v3` state dict (pytorch-fid's
    `pt_inception-2015-12-05-*.pth` naming: `<module>.conv.weight`,
    `<module>.bn.{weight,bias,running_mean,running_var}`) -> the folded
    state dict of `FIDInceptionV3`."""
    sd = torch.load(path, map_location="cpu")
    if "state_dict" in sd:
        sd = sd["state_dict"]
    out = {}
    for kind, name, specs in BLOCKS:
        if kind == "maxpool":
            continue
        for s in specs:
            pre = _key(name, s[0])
            g = lambda k: sd[f"{pre}.{k}"].numpy().astype(np.float64)
            w, b = _fold_bn(g("conv.weight"), g("bn.weight"), g("bn.bias"),
                            g("bn.running_mean"), g("bn.running_var"))
            out[pre + ".weight"], out[pre + ".bias"] = w, b
    return out


def random_inception_params(seed: int = 0) -> dict:
    """The JAX package's architecture-faithful random folded weights
    (numpy `RandomState(seed)`: kernels drawn [kh, kw, in, out] over
    sqrt(fan_in), zero biases) as `FIDInceptionV3`'s state dict, equal to
    JAX's parameters from the same seed. Not comparable to published FID."""
    rng = np.random.RandomState(seed)
    out = {}
    for kind, name, specs in BLOCKS:
        if kind == "maxpool":
            continue
        for s in specs:
            _, cin, cout, (kh, kw), _, _ = s
            # float32 / float64 is float64 in numpy 2, rounded to float32
            # where JAX's jnp.asarray rounds it
            k = (rng.randn(kh, kw, cin, cout).astype(np.float32)
                 / np.sqrt(cin * kh * kw)).astype(np.float32)
            pre = _key(name, s[0])
            out[pre + ".weight"] = torch.from_numpy(
                np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
            out[pre + ".bias"] = torch.zeros(cout)
    return out


def load_inception(weights_path=None, *, seed: int = 0, device=None):
    """`FIDInceptionV3` on `device` (the card unless the caller asks for
    the CPU) with the file's folded weights, else the random ones."""
    net = FIDInceptionV3(device="cpu")
    net.load_state_dict(load_inception_params_from_torch(weights_path)
                        if weights_path else random_inception_params(seed),
                        strict=True)
    return net.to(resolve_device(device))
