"""Dataset-type dispatch: Config -> (Scene, i_train, i_test) (port of
`spinnerf_tpu/data/dispatch.py`, the reference's if-chain over
`--dataset_type`, `DS_NeRF/run_nerf.py:985-1112`).

Ported: llff / spinnerf (an LLFF scene with masks, inpainted RGB and
disparity) and nerd (an LLFF scene with a `masks/` directory). The blender
and dtu loaders raise NotImplementedError (ROADMAP.md queue A #9). Near and
far come from the scene's bounds (or NDC) in every ported branch.
"""
from __future__ import annotations

import numpy as np

from spinnerf_tpu_torch.data import llff


def load_scene_for_config(cfg):
    """Returns (scene: llff.Scene, i_train, i_test)."""
    dt = cfg.dataset_type
    if dt in ("llff", "spinnerf"):
        scene = llff.load_scene(
            cfg.datadir, factor=cfg.factor,
            # MVSeg (stage 2) runs before inpainting: always the raw RGB
            prepare=cfg.prepare or cfg.mvseg,
            spherify=cfg.spherify, lpips_mode=cfg.lpips,
            mask_subdir=cfg.mask_subdir,
            masks_gt_subdir=cfg.masks_gt_subdir,
            # the MVSeg fork trains its semantic head on the raw masks
            # (`MVSeg/DS_NeRF/load_llff.py:132-147`); DS-NeRF dilates them
            dilate_iterations=0 if cfg.mvseg else cfg.mask_dilate_iters)
        i_train, i_test = llff.train_test_split(
            len(scene.images), n_gt=cfg.N_gt, train_gt=cfg.train_gt,
            llffhold=0 if cfg.llffhold >= 1000000 else cfg.llffhold,
            n_train=cfg.N_train,
            train_scene=cfg.train_scene, test_scene=cfg.test_scene)
        return scene, i_train, i_test

    if dt in ("blender", "dtu"):
        raise NotImplementedError(f"the {dt} loader (data/{dt}.py) is not "
                                  f"ported yet; see ROADMAP.md queue A #9")

    if dt == "nerd":
        # an LLFF scene + `masks/` (`load_nerd.py`); the split excludes the
        # held-out views from training (`run_nerf.py:1094-1096`)
        scene = llff.load_scene(
            cfg.datadir, factor=cfg.factor, prepare=True,
            spherify=cfg.spherify, mask_subdir="masks",
            dilate_iterations=0, load_inpainted=False)
        hold = cfg.llffhold if 0 < cfg.llffhold < 1000000 else 0
        i_all = np.arange(len(scene.images))
        i_test = i_all[::hold] if hold else np.asarray([scene.i_holdout])
        i_train = np.asarray([i for i in i_all if i not in i_test])
        return scene, i_train, i_test

    raise ValueError(f"unknown dataset_type {dt!r} "
                     "(expected llff | blender | dtu | nerd)")
