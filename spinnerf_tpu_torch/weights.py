"""Central drop point for pretrained torch checkpoints (the port's copy of
`spinnerf_tpu/weights.py`).

The repo holds no learned weights, so every learned component (the LPIPS
VGG16 and its linear heads so far) runs on documented seeded random
fallbacks by default. To run with real weights, drop the files below into
one directory and point `SPINNERF_WEIGHTS_DIR` at it (explicit paths
passed to a loader always win):

    $SPINNERF_WEIGHTS_DIR/
      vgg16.pth                 torchvision VGG16 `state_dict` (features.*)
      lpips_vgg_lin.pth         LPIPS v0.1 VGG linear heads (lin{i}.model.1.*)
      big-lama.ckpt             LaMa big-lama checkpoint
      pt_inception.pth          pytorch-fid InceptionV3
      ade20k_resnet50.pth       MIT CSAIL ADE20k encoder weights
      ade20k_ppm_decoder.pth    MIT CSAIL ADE20k ppm_deepsup decoder weights

Every consumer calls `find(<name>)`; one that has no fallback calls
`require(<name>)`, which raises MissingWeightsError.
"""
from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "SPINNERF_WEIGHTS_DIR"

# name -> (primary filename, alternate filenames accepted)
WELL_KNOWN = {
    "vgg16": ("vgg16.pth", ("vgg16-397923af.pth",)),
    "lpips_lin": ("lpips_vgg_lin.pth", ("vgg.pth", "lpips_lin.pth")),
    "big_lama": ("big-lama.ckpt", ("big-lama.pth", "last.ckpt")),
    "inception_fid": ("pt_inception.pth",
                      ("pt_inception-2015-12-05-6726825d.pth",)),
    "ade20k_resnet50": ("ade20k_resnet50.pth",
                        ("encoder_epoch_30.pth", "encoder_epoch_20.pth")),
    "ade20k_ppm_decoder": ("ade20k_ppm_decoder.pth",
                           ("decoder_epoch_30.pth", "decoder_epoch_20.pth")),
}


def weights_dir() -> Path | None:
    d = os.environ.get(ENV_VAR)
    if not d:
        return None
    p = Path(d)
    return p if p.is_dir() else None


def find(name: str) -> str | None:
    """Path to the named checkpoint if dropped in, else None."""
    primary, alts = WELL_KNOWN[name]
    d = weights_dir()
    if d is None:
        return None
    for fname in (primary, *alts):
        p = d / fname
        if p.is_file():
            return str(p)
    return None


class MissingWeightsError(FileNotFoundError):
    """A checkpoint a caller requires is not dropped in."""


def require(name: str) -> str:
    """Path to the named checkpoint; raises MissingWeightsError when it is
    not dropped in."""
    path = find(name)
    if path is None:
        raise MissingWeightsError(
            f"{WELL_KNOWN[name][0]} is not in ${ENV_VAR} "
            f"({weights_dir() or 'unset'})")
    return path
