"""Dataset-type dispatch: Config -> (Scene, i_train, i_test, near, far)
(port of `spinnerf_tpu/data/dispatch.py`, the reference's if-chain over
`--dataset_type`, `DS_NeRF/run_nerf.py:985-1112`). Every branch gives the
one `llff.Scene` the Trainer consumes.

near/far per branch (same lines):
  llff/nerd  None: the ray bank takes NDC's (0, 1) or the scene's bounds
  blender    (2, 6), alpha composited onto white under --white_bkgd
  dtu        (0.1, 5.0)
"""
from __future__ import annotations

import numpy as np

from spinnerf_tpu_torch.data import llff


def _uniform_bounds(n: int, near: float, far: float) -> np.ndarray:
    return np.broadcast_to(np.array([near, far], np.float32), (n, 2)).copy()


def load_scene_for_config(cfg):
    """Returns (scene: llff.Scene, i_train, i_test, near, far); near/far are
    None for llff / nerd and the reference's constants for blender / dtu
    (`run_nerf.py:1071-1072`, `1058-1059`)."""
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
        return scene, i_train, i_test, None, None

    if dt == "blender":
        from spinnerf_tpu_torch.data import blender
        imgs, poses, render_poses, hwf, i_split, masks, _ = \
            blender.load_blender_data(cfg.datadir, half_res=cfg.half_res,
                                      testskip=cfg.testskip)
        if cfg.white_bkgd:
            imgs = imgs[..., :3] * imgs[..., -1:] + (1.0 - imgs[..., -1:])
        else:
            imgs = imgs[..., :3]
        near, far = 2.0, 6.0
        if masks is not None and not (masks > 0).any():
            # no object masks shipped with the scene: plain NeRF training
            # on every pixel (the loader pads absent masks with -1)
            masks = None
        scene = llff.Scene(
            images=np.ascontiguousarray(imgs, np.float32),
            poses=np.ascontiguousarray(poses[:, :3, :4], np.float32),
            bounds=_uniform_bounds(len(imgs), near / 0.9, far),
            render_poses=np.ascontiguousarray(render_poses[:, :3, :4],
                                              np.float32),
            hwf=tuple(hwf), i_holdout=0, masks=masks)
        i_train, _, i_test = i_split
        return scene, np.asarray(i_train), np.asarray(i_test), near, far

    if dt == "dtu":
        from spinnerf_tpu_torch.data import dtu
        imgs, poses, hwf = dtu.load_dtu_data(cfg.datadir)
        near, far = 0.1, 5.0
        scene = llff.Scene(
            images=np.ascontiguousarray(imgs, np.float32),
            poses=np.ascontiguousarray(poses[:, :3, :4], np.float32),
            bounds=_uniform_bounds(len(imgs), near / 0.9, far),
            # no spiral path in the reference: the eval renders the poses
            render_poses=np.ascontiguousarray(poses[:, :3, :4], np.float32),
            hwf=tuple(hwf), i_holdout=0)
        # `run_nerf.py:1044-1056`: test_scene / train_scene drive the split
        i_train, i_test = llff.train_test_split(
            len(imgs), train_scene=cfg.train_scene,
            test_scene=cfg.test_scene)
        if not cfg.train_scene:
            # unlike llff, DTU's default leaves the test views out of
            # training (`run_nerf.py:1051-1052`)
            i_train = np.asarray([i for i in i_train if i not in i_test])
        return scene, i_train, i_test, near, far

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
        return scene, i_train, i_test, None, None

    raise ValueError(f"unknown dataset_type {dt!r} "
                     "(expected llff | blender | dtu | nerd)")
