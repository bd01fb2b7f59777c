"""Unified configuration: one dataclass covering the reference's ~80
configargparse flags (`DS_NeRF/run_nerf.py:740-925` plus the MVSeg extras,
`MVSeg/DS_NeRF/run_nerf.py:888-895`), readable from the same
`key = value` config.txt files the reference ships
(`DS_NeRF/configs/config.txt`, `MVSeg/DS_NeRF/configs/mv_config.txt`).

Precedence: defaults < config file < CLI flags — matching configargparse.

A copy of `spinnerf_tpu/config.py`: the port shares its flags and defaults
with the JAX package but imports nothing from it.
"""
from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field, fields
from pathlib import Path


@dataclass
class Config:
    # experiment
    config: str | None = None
    expname: str = "exp"
    basedir: str = "./logs"
    datadir: str = "./data/statue"

    # model
    netdepth: int = 8
    netwidth: int = 256
    netdepth_fine: int = 8
    netwidth_fine: int = 256
    multires: int = 10
    multires_views: int = 4
    i_embed: int = 0                  # 0 = positional encoding, -1 = none
    use_viewdirs: bool = True
    no_tcnn: bool = False             # False => hash-grid field (default)
    log2_hashmap_size: int = 19       # per-level hash-table entries (2^k)
    hash_impl: str = "auto"           # auto|win|win_xla (the windowed
    #                                   index) | mxu|xla (the instant-NGP
    #                                   dense/XOR-prime index); auto = mxu
    #                                   below 2^13 entries, else win
    fused_mlp: bool = True            # MLP field through its fused kernel
    alpha_model_path: str | None = None

    # sampling / rendering
    N_samples: int = 64
    N_importance: int = 64
    perturb: float = 1.0
    raw_noise_std: float = 0.0
    white_bkgd: bool = False
    render_factor: int = 0
    chunk: int = 1024 * 32
    netchunk: int = 1024 * 64         # max points per network eval (bounds
    #                                   the remat chunk size in the train step)

    # training
    N_rand: int = 1024
    N_iters: int = 200000
    lrate: float = 0.01
    lrate_decay: float = 10.0
    precrop_iters: int = 0
    precrop_frac: float = 0.5
    no_batching: bool = False
    no_reload: bool = False
    ft_path: str | None = None
    no_coarse: bool = False

    # dataset
    dataset_type: str = "llff"
    factor: int = 8
    no_ndc: bool = False
    lindisp: bool = False
    spherify: bool = False
    llffhold: int = 1000000
    testskip: int = 8
    half_res: bool = False
    shape: str = "greek"
    train_scene: list = field(default_factory=list)
    test_scene: list = field(default_factory=list)

    # depth supervision
    colmap_depth: bool = False
    depth_loss: bool = False
    depth_lambda: float = 0.1
    sigma_loss: bool = False
    sigma_lambda: float = 0.1
    weighted_loss: bool = False
    relative_loss: bool = False
    depth_with_rgb: bool = False
    normalize_depth: bool = False

    # SPIn-NeRF pipeline
    prepare: bool = False
    lpips: bool = False
    N_gt: int = 0
    N_train: int | None = None
    train_gt: bool = False
    masked_NeRF: bool = False
    object_removal: bool = False
    no_geometry: bool = False
    tmp_images: bool = False          # parse-and-ignore IN THE REFERENCE TOO
    #                                   (`run_nerf.py:913` is argparse-only);
    #                                   kept for config-file compatibility
    lpips_render_factor: int = 2
    patch_len_factor: int = 8
    lpips_batch_size: int = 4

    # MVSeg
    mvseg: bool = False               # semantic (multiview-segmentation) mode
    mask_subdir: str = "label"        # e.g. label_mv_bootstrapped for MVSeg
    masks_gt_subdir: str | None = None  # e.g. label_full for IoU eval
    clf_weight: float = 0.01
    clf_reg_weight: float = 0.01      # parse-and-ignore IN THE REFERENCE TOO
    #                                   (`run_nerf.py:893` is argparse-only)
    feat_weight: float = 0.01
    render_mask: bool = False
    post_opening: bool = False
    feature_field: bool = False       # parse-and-ignore IN THE REFERENCE TOO
    #                                   (`MVSeg/.../run_nerf.py:890` is
    #                                   argparse-only)

    # render-only modes
    render_only: bool = False
    render_test: bool = False
    render_train: bool = False
    render_mypath: bool = False
    render_test_ray: bool = False

    # logging cadence
    i_print: int = 100
    i_img: int = 500
    i_weights: int = 10000
    i_testset: int = 100000
    i_video: int = 50000
    i_feat: int = 10
    debug: bool = False

    # extras without a reference equivalent
    mask_dilate_iters: int = 5        # reference hardcodes 5x5 x5 dilation
    compute_dtype: str = "bfloat16"
    grad_clip: float | None = None
    distortion_weight: float = 0.0
    hash_region_calib: bool = True    # density calibration of the windowed
    # hash's Z-CDF page bounds (hashgrid.calibrate_page_bounds). DEFAULT ON:
    # uniform bounds collapse any scene occupying a small part of
    # [-bound, bound]^3 onto a few table segments (measured -15 dB,
    # PARITY_RUN §4); disable only for full-cube synthetic data
    table_wd: float = 0.0             # EXPERIMENTAL — measured HARMFUL at
    # harness scale (over-regularizes through Adam, train tail -4 dB,
    # PARITY_RUN §4); retained for larger-scene experiments only. L2 decay
    # on hash-table params (0 = off = reference parity)
    mesh_shape: int = 0               # 0 = all local devices on the data axis
    seed: int = 0
    epoch_sampling: bool = True       # without-replacement epoch strides over
    # the ray groups (the reference's shuffled-DataLoader semantics,
    # `run_nerf.py:1337-1413`); False = uniform iid with replacement

    @property
    def ndc(self) -> bool:
        return not self.no_ndc

    def exp_dir(self) -> Path:
        return Path(self.basedir) / self.expname

    def save(self, path=None):
        """Dump resolved args to expdir (parity: `run_nerf.py:1129-1141`)."""
        p = Path(path) if path else self.exp_dir() / "args.txt"
        p.parent.mkdir(parents=True, exist_ok=True)
        with open(p, "w") as f:
            for fl in sorted(fields(self), key=lambda x: x.name):
                f.write(f"{fl.name} = {getattr(self, fl.name)}\n")


def _coerce(value: str, target_type):
    v = value.strip()
    if target_type is bool or v in ("True", "False"):
        return v == "True"
    if v == "None":
        return None
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return v


def parse_config_file(path) -> dict:
    """Parse a configargparse-style `key = value` text file."""
    out = {}
    for line in open(path):
        line = line.split("#")[0].strip()
        if not line:
            continue
        if "=" in line:
            key, val = line.split("=", 1)
            out[key.strip().lstrip("-")] = val.strip()
        else:
            out[line.lstrip("-")] = "True"   # bare flag
    return out


def load_config(argv=None, defaults: Config | None = None) -> Config:
    """Build a Config from (defaults, --config file, CLI flags) in order."""
    cfg = dataclasses.replace(defaults) if defaults else Config()

    parser = argparse.ArgumentParser("spinnerf_tpu_torch")
    for fl in fields(Config):
        name = f"--{fl.name}"
        if fl.type == "bool" or isinstance(getattr(cfg, fl.name), bool):
            parser.add_argument(name, nargs="?", const="True", default=None)
        elif fl.name in ("train_scene", "test_scene"):
            parser.add_argument(name, nargs="+", type=int, default=None)
        else:
            parser.add_argument(name, default=None)
    ns = parser.parse_args(argv)

    field_types = {fl.name: fl.type for fl in fields(Config)}

    if ns.config:
        for key, val in parse_config_file(ns.config).items():
            if key not in field_types:
                raise ValueError(f"unknown config key: {key}")
            cur = getattr(cfg, key)
            setattr(cfg, key, _coerce(val, type(cur) if cur is not None else str))
        cfg.config = ns.config

    for fl in fields(Config):
        v = ns.__dict__.get(fl.name)
        if v is None or fl.name == "config":
            continue
        if isinstance(v, list):
            setattr(cfg, fl.name, v)
        else:
            cur = getattr(cfg, fl.name)
            setattr(cfg, fl.name, _coerce(str(v), type(cur) if cur is not None else str))
    return cfg
