"""SPIn-NeRF pipeline stages (port of `spinnerf_tpu/pipeline/stages.py`).

The reference runs each stage as a separate program glued by shell commands
(`README.md:57-141`). Ported here: stage 3, `stage_prepare` (the depth NeRF
and its disparity dump for LaMa), stage 5, `stage_fit` (the inpainted fit:
masked MSE, inpainted-RGB MSE and patch LPIPS inside the hole, the
inpainted-disparity prior), and `stage_eval` (PSNR, SSIM and LPIPS of the
test views, full-frame and masked). MVSeg, the LaMa guidance and
`run_pipeline` are not ported yet and raise (ROADMAP.md queues A5, A6, A9).
Stages run on the card unless `device="cpu"` is passed.
"""
from __future__ import annotations

from dataclasses import replace as dc_replace
from pathlib import Path

import numpy as np
import torch

from spinnerf_tpu_torch.config import Config
from spinnerf_tpu_torch.eval import metrics
from spinnerf_tpu_torch.models.lpips import load_lpips_labeled
from spinnerf_tpu_torch.train.loop import Trainer


def _images_dir(cfg: Config) -> Path:
    f = cfg.factor
    return Path(cfg.datadir) / (f"images_{f}" if f and f != 1 else "images")


def stage_mvseg(cfg: Config, **kw):
    raise NotImplementedError("stage 2, MVSeg (pipeline/mvseg.py), is not "
                              "ported yet; see ROADMAP.md queue A5")


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


def stage_inpaint_guidance(cfg: Config, lama_in, **kw):
    raise NotImplementedError("stage 4, the LaMa guidance "
                              "(pipeline/inpaint2d.py), is not ported yet; "
                              "see ROADMAP.md queue A6")


def stage_fit(cfg: Config, *, n_iters=None, log=print, device=None):
    """Stage 5: the inpainted-NeRF optimisation (masked MSE, patch LPIPS and
    the disparity prior). Returns the Trainer."""
    fit_cfg = dc_replace(cfg, prepare=False, lpips=True,
                         expname=cfg.expname + "_fit")
    tr = Trainer(fit_cfg, log=log, device=device)
    tr.fit(n_iters)
    return tr


def stage_eval(cfg: Config, trainer, *, log=print):
    """Stage 7: PSNR, SSIM and LPIPS of the test views' renders against
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


def run_pipeline(cfg: Config, **kw):
    raise NotImplementedError("run_pipeline needs stages 2 and 4 (ROADMAP.md "
                              "queues A5 and A6) and is not ported yet; see "
                              "ROADMAP.md queue A9")
