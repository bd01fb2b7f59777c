"""SPIn-NeRF pipeline stages (port of `spinnerf_tpu/pipeline/stages.py`).

The reference runs each stage as a separate program glued by shell commands
and directory copies (`README.md:57-141`); here each is a function over the
same on-disk layout:
  stage_mvseg            2. MVSeg lifts the sparse masks to every view
                            (`images_<f>/label/`);
  stage_prepare          3. the depth NeRF and its disparity dump for LaMa;
  stage_inpaint_guidance 4. LaMa on the disparities (`images_<f>/depth/`)
                            and on the RGB images (`images_<f>/lama_images/`);
  stage_fit              5. the inpainted fit: masked MSE, inpainted-RGB MSE
                            and patch LPIPS inside the hole, the
                            inpainted-disparity prior;
  stage_eval             6. PSNR, SSIM and LPIPS of the test views,
                            full-frame and masked;
and `run_pipeline` runs them in order. Stages run on the card unless
`device="cpu"` is passed.
"""
from __future__ import annotations

import json
import shutil
import time
from dataclasses import replace as dc_replace
from pathlib import Path

import numpy as np
import torch

from spinnerf_tpu_torch.config import Config
from spinnerf_tpu_torch.data import llff
from spinnerf_tpu_torch.eval import metrics
from spinnerf_tpu_torch.eval.render import write_png
from spinnerf_tpu_torch.models.lpips import load_lpips_labeled
from spinnerf_tpu_torch.pipeline import inpaint2d, mvseg
from spinnerf_tpu_torch.train.loop import Trainer


def _images_dir(cfg: Config) -> Path:
    f = cfg.factor
    return Path(cfg.datadir) / (f"images_{f}" if f and f != 1 else "images")


def stage_mvseg(cfg: Config, *, n_iters=None, log=print, device=None):
    """Stage 2: train the semantic field on the sparse masks and write every
    view's mask to `images_<f>/label/`. Returns that directory."""
    # i_feat=0: the periodic prepare/sanity render dumps belong to the fit
    # stage (`README.md:140` i_feat=200); MVSeg's product is `export_masks`
    # below
    mv_cfg = dc_replace(cfg, mvseg=True, expname=cfg.expname + "_mvseg",
                        prepare=True, lpips=False, i_feat=0)
    tr = Trainer(mv_cfg, log=log, device=device)
    tr.fit(n_iters)
    out_dir, masks = mvseg.export_masks(tr, out_subdir="label",
                                        opening=cfg.post_opening)
    log(f"[mvseg] wrote {len(masks)} masks to {out_dir}")
    return out_dir


def stage_prepare(cfg: Config, *, n_iters=None, log=print, device=None):
    """Stage 3: fit the depth NeRF on the original images and dump each
    view's disparity and downsampled mask (the LaMa guidance inputs).
    Returns the dump's directory."""
    # i_feat=0 disables in-loop dumps; the one dump below is the
    # reference's i_feat=4000 over N_iters=4001 (`README.md:65`)
    prep_cfg = dc_replace(cfg, prepare=True, lpips=False,
                          expname=cfg.expname + "_prepare", N_gt=0, i_feat=0)
    tr = Trainer(prep_cfg, log=log, device=device)
    tr.fit(n_iters)
    out = tr._prepare_hook(tr.step)
    log(f"[prepare] guidance inputs at {out}")
    return out


def stage_inpaint_guidance(cfg: Config, lama_in, *, checkpoint_path=None,
                           refine: bool = True, log=print, device=None):
    """Stage 4: LaMa inpaints the prepare dump's disparities into
    `images_<f>/depth/` and the RGB images, masked by `label/`, into
    `images_<f>/lama_images/`, one generator for both passes. The staging
    files are `img{i:03d}.png` in the sorted order of the images, renamed
    back to each image's stem. Returns (depth dir, lama_images dir)."""
    img_dir = _images_dir(cfg)
    names = sorted(p.name for p in img_dir.iterdir()
                   if p.suffix.lower() in (".png", ".jpg", ".jpeg"))
    exp = Path(cfg.basedir) / cfg.expname
    inpainter = inpaint2d.Inpainter(
        inpaint2d.load_generator(checkpoint_path, device=device))

    def inpaint(src, tag, out_sub):
        out = inpaint2d.inpaint_directory(src, exp / f"lama_{tag}_out",
                                          refine=refine, inpainter=inpainter)
        dst = img_dir / out_sub
        dst.mkdir(exist_ok=True)
        for i, name in enumerate(names):
            res = out / f"img{i:03d}.png"
            if res.exists():
                shutil.copy(res, dst / (Path(name).stem + ".png"))
        log(f"[inpaint] {tag} -> {dst}")
        return dst

    depth_dir = inpaint(lama_in, "disp", "depth")
    rgb_in = exp / "lama_rgb_in"
    (rgb_in / "label").mkdir(parents=True, exist_ok=True)
    for i, name in enumerate(names):
        src = img_dir / name
        if src.suffix.lower() == ".png":
            shutil.copy(src, rgb_in / f"img{i:03d}.png")
        else:
            write_png(rgb_in / f"img{i:03d}.png", llff.imread(src))
        write_png(rgb_in / "label" / f"img{i:03d}.png", llff.imread_gray8(
            img_dir / "label" / (Path(name).stem + ".png")))
    return depth_dir, inpaint(rgb_in, "rgb", "lama_images")


def stage_fit(cfg: Config, *, n_iters=None, log=print, device=None):
    """Stage 5: the inpainted-NeRF optimisation (masked MSE, patch LPIPS and
    the disparity prior). Returns the Trainer."""
    fit_cfg = dc_replace(cfg, prepare=False, lpips=True,
                         expname=cfg.expname + "_fit")
    tr = Trainer(fit_cfg, log=log, device=device)
    tr.fit(n_iters)
    return tr


def stage_eval(cfg: Config, trainer, *, log=print):
    """Stage 6: PSNR, SSIM and LPIPS of the test views' renders against
    their ground truth (`DS_NeRF/eval_metrics_script.py:26-33`), and the
    masked forms over each view whose mask is not empty: LPIPS on the
    composite pred * m + gt * (1 - m). The LPIPS key is "lpips" only with
    real weights (`weights.py`), else "lpips_random_vgg".

    The masks are `scene.masks_gt` (the exact hole masks, e.g.
    `label_full/`) when loaded, else `scene.masks`. Returns {"per_view":
    rows, "summary": the mean of each key}, or {} without test views."""
    if len(trainer.i_test) == 0:
        log("[eval] no test views")
        return {}
    dev = trainer.device
    lpips_fn, lpips_key = load_lpips_labeled(device=dev)
    eval_masks = (trainer.scene.masks_gt if trainer.scene.masks_gt is not None
                  else trainer.scene.masks)
    rgbs, _ = trainer.render_poses_list(trainer.scene.poses[trainer.i_test])
    rows = []
    with torch.no_grad():
        for r, t in zip(rgbs, trainer.i_test):
            gt = torch.as_tensor(trainer.scene.images[t], device=dev)
            pred = torch.as_tensor(r, device=dev)
            row = {"psnr": float(metrics.psnr(pred, gt)),
                   "ssim": float(metrics.ssim(pred, gt)),
                   lpips_key: float(lpips_fn(pred, gt))}
            if eval_masks is not None:
                m = torch.as_tensor((np.abs(eval_masks[t]) > 0.5)
                                    .astype(np.float32), device=dev)
                if float(m.sum()) > 0:
                    row["masked_psnr"] = float(metrics.psnr(pred, gt, m))
                    row["masked_ssim"] = float(metrics.ssim(pred, gt,
                                                            mask=m))
                    comp = pred * m[..., None] + gt * (1.0 - m[..., None])
                    row["masked_" + lpips_key] = float(lpips_fn(comp, gt))
            rows.append(row)
    summary = {k: float(np.mean([r[k] for r in rows if k in r]))
               for k in set().union(*rows)}
    log(f"[eval] {summary}")
    return {"per_view": rows, "summary": summary}


def run_pipeline(cfg: Config, *, mvseg_iters=None, prepare_iters=None,
                 fit_iters=None, lama_checkpoint=None, refine=True,
                 skip_mvseg=False, guidance_hook=None, log=print,
                 device=None):
    """Run the scene pipeline: MVSeg (unless `skip_mvseg`), prepare, the
    LaMa guidance, then `guidance_hook()` when given (e.g. analytic
    object-removed renders in place of LaMa's), the fit and the eval.
    Returns (the fit's Trainer, the eval's results); the results, with each
    stage's wall-clock seconds under "stage_seconds", are also written to
    `<basedir>/<expname>/pipeline_results.json`."""
    timings: dict[str, float] = {}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        timings[name] = round(time.perf_counter() - t0, 2)
        log(f"[pipeline] stage {name}: {timings[name]:.1f}s")
        return out

    if not skip_mvseg:
        timed("mvseg", stage_mvseg, cfg, n_iters=mvseg_iters, log=log,
              device=device)
    lama_in = timed("prepare", stage_prepare, cfg, n_iters=prepare_iters,
                    log=log, device=device)
    timed("inpaint_guidance", stage_inpaint_guidance, cfg, lama_in,
          checkpoint_path=lama_checkpoint, refine=refine, log=log,
          device=device)
    if guidance_hook is not None:
        guidance_hook()
    trainer = timed("fit", stage_fit, cfg, n_iters=fit_iters, log=log,
                    device=device)
    results = timed("eval", stage_eval, cfg, trainer, log=log)
    results["stage_seconds"] = timings
    out = Path(cfg.basedir) / cfg.expname / "pipeline_results.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=2))
    return trainer, results
