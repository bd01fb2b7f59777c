"""The MVSeg stage: sparse 2D object masks lifted to every view (port of
`spinnerf_tpu/pipeline/mvseg.py`).

The reference runs a forked semantic NeRF (`MVSeg/DS_NeRF/run_nerf.py`)
whose render modes give each view's mask. Here the Trainer with
`Config(mvseg=True)` trains the field's semantic head (the step's BCE
term), and this module renders and scores the masks and writes them:
  render_masks   binary masks (`run_nerf.py:198-201`, acc-gated: see
                 `render_masks`), with the optional 3 x 3 opening
                 (`--post_opening`, `run_nerf.py:221`);
  evaluate_masks pixel accuracy and IoU against ground truth
                 (`run_nerf.py:1409-1423`);
  export_masks   every view's mask into the scene's `label/` layout;
  render_object_removed  the object deleted, optionally on a random
                 background, optionally white outside the object
                 (`only_object`, `mask_filter`).
Masks are numpy on the host; renders run on the trainer's device.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from spinnerf_tpu_torch.data import llff
from spinnerf_tpu_torch.eval import metrics as eval_metrics
from spinnerf_tpu_torch.eval import render as eval_render


def post_opening(mask: np.ndarray, kernel: int = 3) -> np.ndarray:
    """cv2's MORPH_OPEN with a k x k square (k odd) of the mask cast to
    uint8: a min filter, then a max filter. cv2's default border never wins
    either, as the +inf / -inf padding of the pools does not."""
    m = torch.from_numpy(mask.astype(np.uint8).astype(np.float32))[None, None]
    pool = torch.nn.functional.max_pool2d
    m = -pool(-m, kernel, stride=1, padding=kernel // 2)
    m = pool(m, kernel, stride=1, padding=kernel // 2)
    return m[0, 0].numpy().astype(np.uint8)


def _renderer(trainer, render_factor: int, **overrides):
    rcfg = trainer.tcfg.render._replace(perturb=False, raw_noise_std=0.0,
                                        semantic=True, **overrides)
    coarse_fn, fine_fn = trainer.field_fns()
    return eval_render.make_frame_renderer(
        trainer.scene.hwf, coarse_fn, rcfg, near=trainer.bank.near,
        far=trainer.bank.far, ndc=trainer.bank.ndc, chunk=trainer.cfg.chunk,
        fine_field_fn=fine_fn, render_factor=render_factor,
        device=trainer.device)


def _object_mask(maps, threshold: float = 0.5) -> np.ndarray:
    p = 1.0 / (1.0 + np.exp(-maps["prob"]))
    return (p * maps["acc"] > threshold).astype(np.float32)


def render_masks(trainer, poses, *, threshold: float = 0.5,
                 opening: bool = False, render_factor: int = 0):
    """Binary object masks [M, H, W] float 0 / 1 of a pose list, from the
    semantic head."""
    renderer = _renderer(trainer, render_factor)
    out = []
    for c2w in poses:
        # sigmoid(prob) * acc > threshold. DELIBERATE deviation from the
        # reference's render_mask branch (`MVSeg run_nerf.py:198-201`,
        # sigmoid only): empty rays (acc ~ 0) composite a logit near 0,
        # i.e. sigmoid ~ 0.5, and an ungated threshold flips them to
        # "object" on noise sign alone. The acc gate is the reference's own
        # recipe from its mask_filter branch (`run_nerf.py:195`).
        m = _object_mask(renderer(c2w), threshold)
        if opening:
            m = post_opening(m).astype(np.float32)
        out.append(m)
    return np.stack(out)


def evaluate_masks(pred_masks, gt_masks):
    """Mean pixel accuracy and IoU over the views that have ground truth
    (a view whose ground truth holds a negative value has none)."""
    accs, ious = [], []
    for p, g in zip(pred_masks, gt_masks):
        if g.min() < 0:
            continue
        m = eval_metrics.mask_metrics(torch.as_tensor(p), torch.as_tensor(g))
        accs.append(float(m["accuracy"]))
        ious.append(float(m["iou"]))
    return {"accuracy": float(np.mean(accs)) if accs else float("nan"),
            "iou": float(np.mean(ious)) if ious else float("nan")}


def export_masks(trainer, out_subdir: str = "label", *, opening: bool = True,
                 dilate_iterations: int = 0):
    """Render every scene view's mask and write it into the dataset layout,
    `images_<f>/<out_subdir>/<name>.png`: the `label/` the later stages
    read. Returns (the directory, the masks [N, H, W])."""
    cfg = trainer.cfg
    factor = cfg.factor
    img_dir = Path(cfg.datadir) / (f"images_{factor}" if factor and factor != 1
                                   else "images")
    out_dir = img_dir / out_subdir
    out_dir.mkdir(parents=True, exist_ok=True)
    masks = render_masks(trainer, trainer.scene.poses, opening=opening)
    # MUST match the scene loader's file list exactly (cutout/pseudo
    # exclusions, pose-count truncation) or masks misalign to filenames
    names = [p.stem for p in llff._list_images(img_dir)][:len(masks)]
    if dilate_iterations > 0:
        masks = np.stack([llff.dilate_mask(m, iterations=dilate_iterations)
                          for m in masks])
    for name, m in zip(names, masks):
        eval_render.write_png(out_dir / f"{name}.png",
                              (np.clip(m, 0, 1) * 255).astype(np.uint8))
    return out_dir, masks


def render_object_removed(trainer, poses, *, bg_generator=None,
                          render_factor: int = 0, threshold=None,
                          mask_filter: bool = False):
    """The only_object render: the object deleted, the leftover
    transparency composited on a random colour per view when a CPU
    `bg_generator` (a `torch.Generator`) is given; its colours cannot equal
    the JAX package's `jax.random.uniform` draws. `mask_filter` whites out
    every pixel the semantic head does not give to the object
    (`sigmoid(prob) * acc > 0.5`, `MVSeg/DS_NeRF/run_nerf.py:194-197`).
    Returns [M, H, W, 3]."""
    renderer = _renderer(trainer, render_factor, only_object=True,
                         oo_threshold=threshold)
    rgbs = []
    for c2w in poses:
        maps = renderer(c2w)
        rgb = maps["rgb"]
        if mask_filter:
            m = _object_mask(maps)[..., None]
            rgb = rgb * m + (1.0 - m)
        if bg_generator is not None:
            bg = torch.rand(3, generator=bg_generator).numpy()
            rgb = rgb + (1.0 - maps["acc"][..., None]) * bg
        rgbs.append(rgb)
    return np.stack(rgbs)
