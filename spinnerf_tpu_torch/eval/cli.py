"""Metrics CLI: compare two image directories with PSNR/SSIM(/LPIPS) (port of
`spinnerf_tpu/eval/cli.py`).

Parity: `DS_NeRF/eval_metrics_script.py:20-62` — iterates matching PNGs in a
rendered dir and a GT dir, optionally restricted to mask regions, prints
mean/std per metric. LPIPS is added when its VGG16 and linear heads are
dropped into `$SPINNERF_WEIGHTS_DIR` (`weights.py`); without them the JAX
package scores a random VGG, the port leaves LPIPS out.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from spinnerf_tpu_torch import resolve_device
from spinnerf_tpu_torch import weights as wreg
from spinnerf_tpu_torch.data.llff import imread_float, imread_gray8
from spinnerf_tpu_torch.eval import metrics
from spinnerf_tpu_torch.models.lpips import load_lpips


def eval_dirs(argv=None, *, device=None) -> int:
    ap = argparse.ArgumentParser("spinnerf eval")
    ap.add_argument("--pred_dir", required=True)
    ap.add_argument("--gt_dir", required=True)
    ap.add_argument("--mask_dir", default=None,
                    help="optional masks; metrics restricted to mask>0")
    ap.add_argument("--json_out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(device)

    pred_files = sorted(Path(args.pred_dir).glob("*.png"))
    gt_files = sorted(Path(args.gt_dir).glob("*.png"))
    if len(pred_files) != len(gt_files) or not pred_files:
        raise SystemExit(f"dir mismatch: {len(pred_files)} pred vs "
                         f"{len(gt_files)} gt images")
    mask_files = (sorted(Path(args.mask_dir).glob("*.png"))
                  if args.mask_dir else [None] * len(pred_files))

    try:
        lpips_fn = load_lpips(device=dev, require_weights=True)
    except wreg.MissingWeightsError:
        lpips_fn = None

    rows = []
    with torch.no_grad():
        for pf, gf, mf in zip(pred_files, gt_files, mask_files):
            pred = torch.from_numpy(imread_float(pf)).to(dev)
            gt = torch.from_numpy(imread_float(gf)).to(dev)
            if pred.shape != gt.shape:
                raise SystemExit(f"shape mismatch {pf} vs {gf}")
            mask = None
            if mf is not None:
                mask = torch.from_numpy(
                    (imread_gray8(mf) > 127).astype(np.float32)).to(dev)
            row = {
                "name": pf.name,
                "psnr": float(metrics.psnr(pred, gt, mask)),
                "ssim": float(metrics.ssim(pred, gt, mask=mask)),
            }
            if lpips_fn is not None:
                row["lpips"] = float(lpips_fn(pred, gt))
                if mask is not None:
                    # masked LPIPS (paper inpainting protocol): composite GT
                    # outside the mask so only the hole region contributes
                    comp = pred * mask[..., None] + gt * (1.0 - mask[..., None])
                    row["masked_lpips"] = float(lpips_fn(comp, gt))
            rows.append(row)

    summary = {}
    for k in rows[0]:
        if k == "name":
            continue
        vals = [r[k] for r in rows]
        summary[k] = {"mean": float(np.mean(vals)), "std": float(np.std(vals))}
        print(f"{k}: {summary[k]['mean']:.4f} +/- {summary[k]['std']:.4f}")

    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"per_image": rows, "summary": summary}, f, indent=2)
    return 0
