"""Inpainting evaluation harness (port of `spinnerf_tpu/eval/inpainting.py`).

Parity: `lama/saicinpainting/evaluation/evaluator.py:16-133` — per-image
scores grouped into mask-area bins (0-10 %, 10-20 %, ...), mean / std
tables, and the `ssim_fid100_f1` integral metric, the training
checkpoint monitor (`evaluator.py:112`): the harmonic mean of SSIM and a
normalised (100-point) Fréchet feature distance.

The Fréchet distance (float64, `scipy.linalg.sqrtm`) runs over a feature
extractor:
- `InceptionFeatureExtractor`: InceptionV3 pool3 (`models/inception.py`),
  the reference's FID embedding. With `pt_inception.pth` in
  `$SPINNERF_WEIGHTS_DIR` this is FID; without, the random network's
  result is keyed `fid_random_inception`.
- `FeatureExtractor`: global-average-pooled VGG16 features (`fid_vgg`).

Images are numpy [H, W, 3] in [0, 1] on the host; the networks and the
metrics run on `device` (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import numpy as np
import torch

from spinnerf_tpu_torch import resolve_device
from spinnerf_tpu_torch import weights as wreg
from spinnerf_tpu_torch.eval import metrics as m


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    """Fréchet distance between Gaussians fit to two feature sets [N, D]."""
    import scipy.linalg
    mu1, mu2 = feats_a.mean(0), feats_b.mean(0)
    c1 = np.cov(feats_a, rowvar=False)
    c2 = np.cov(feats_b, rowvar=False)
    diff = mu1 - mu2
    # the matrix alone: SciPy 1.18 removed `disp`, the JAX package's
    # `disp=False`, whose second output it discards
    covmean = scipy.linalg.sqrtm(c1 @ c2)
    if not np.isfinite(covmean).all():
        # rank-deficient product (N images << feature dim is the norm):
        # the standard diagonal offset of the reference FID implementations
        offset = np.eye(c1.shape[0]) * 1e-6
        covmean = scipy.linalg.sqrtm((c1 + offset) @ (c2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    covmean = np.nan_to_num(covmean, nan=0.0, posinf=0.0, neginf=0.0)
    return float(diff @ diff + np.trace(c1) + np.trace(c2)
                 - 2 * np.trace(covmean))


class FeatureExtractor:
    """Global-average-pooled VGG16 features for Fréchet statistics (an
    alternative embedding: results are keyed `fid_vgg`, never `fid`).
    Random weights are the LPIPS module's seeded fallback."""

    fid_key = "fid_vgg"

    def __init__(self, vgg_weights_path=None, seed: int = 0, device=None):
        from spinnerf_tpu_torch.models import lpips as lpips_lib
        if vgg_weights_path is None:
            vgg_weights_path = wreg.find("vgg16")
        self.device = resolve_device(device)
        self.net = lpips_lib.VGG16Features(device=self.device)
        if vgg_weights_path:
            lpips_lib.load_vgg_params_from_torch(vgg_weights_path, self.net)
        else:
            self.net.reset_parameters(torch.Generator().manual_seed(seed))
        self.shift = torch.tensor(lpips_lib._SHIFT, device=self.device)
        self.scale = torch.tensor(lpips_lib._SCALE, device=self.device)

    def __call__(self, images: np.ndarray) -> np.ndarray:
        """images [N, H, W, 3] in [0, 1] -> features [N, D]."""
        x = torch.as_tensor(np.asarray(images, np.float32),
                            device=self.device)
        # LPIPS-normalised input, as the trunk's pretrained weights expect
        x = ((x * 2.0 - 1.0 - self.shift) / self.scale).permute(0, 3, 1, 2)
        with torch.no_grad():
            feats = [f.mean(dim=(2, 3)) for f in self.net(x)]
        return torch.cat(feats, dim=-1).cpu().numpy()


class InceptionFeatureExtractor:
    """InceptionV3 pool3 features, the reference's FID embedding; `fid_key`
    marks results from random weights."""

    def __init__(self, weights_path=None, seed: int = 0, batch: int = 16,
                 device=None):
        from spinnerf_tpu_torch.models import inception as inc
        if weights_path is None:
            weights_path = wreg.find("inception_fid")
        self.fid_key = "fid" if weights_path else "fid_random_inception"
        self.device = resolve_device(device)
        self.net = inc.load_inception(weights_path, seed=seed,
                                      device=self.device)
        self.batch = batch

    def __call__(self, images: np.ndarray) -> np.ndarray:
        """images [N, H, W, 3] in [0, 1] -> pool3 features [N, 2048]."""
        out = []
        for i in range(0, len(images), self.batch):
            x = torch.as_tensor(np.asarray(images[i:i + self.batch],
                                           np.float32), device=self.device)
            with torch.no_grad():
                out.append(self.net(x.permute(0, 3, 1, 2)).cpu().numpy())
        return np.concatenate(out, axis=0)


class InpaintingEvaluator:
    """Accumulates per-image scores; reports per-mask-area-bin tables."""

    def __init__(self, *, lpips_fn=None, feature_extractor=None,
                 bin_edges=(0.0, 0.1, 0.2, 0.3, 0.4, 1.01),
                 integral_fid_norm: float = 100.0, lpips_key: str = "lpips",
                 device=None):
        self.lpips_fn = lpips_fn
        # "lpips_random_vgg" when the metric runs on random weights
        # (models.lpips.load_lpips_labeled)
        self.lpips_key = lpips_key
        self.features = feature_extractor
        self.bin_edges = np.asarray(bin_edges)
        self.integral_fid_norm = integral_fid_norm
        self.device = resolve_device(device)
        self.rows = []
        self._feats_pred = []
        self._feats_gt = []

    def add(self, pred: np.ndarray, target: np.ndarray, mask: np.ndarray):
        """pred / target [H, W, 3] in [0, 1]; mask [H, W] (1 = hole)."""
        p = torch.as_tensor(np.asarray(pred, np.float32), device=self.device)
        t = torch.as_tensor(np.asarray(target, np.float32),
                            device=self.device)
        row = {"mask_area": float((mask > 0.5).mean()),
               "ssim": float(m.ssim(p, t)), "psnr": float(m.psnr(p, t))}
        if self.lpips_fn is not None:
            with torch.no_grad():
                row[self.lpips_key] = float(self.lpips_fn(p, t))
        self.rows.append(row)
        if self.features is not None:
            self._feats_pred.append(pred)
            self._feats_gt.append(target)

    def evaluation_end(self) -> dict:
        """Mean / std per metric, overall and per mask-area bin, plus the
        Fréchet distance and ssim_fid100_f1 when a feature extractor is
        set."""
        if not self.rows:
            return {"total": {"n": 0}}
        out = {"total": self._table(self.rows)}
        for lo, hi in zip(self.bin_edges[:-1], self.bin_edges[1:]):
            rows = [r for r in self.rows if lo <= r["mask_area"] < hi]
            if rows:
                out[f"mask_{lo:.0%}-{hi:.0%}"] = self._table(rows)
        if self.features is not None and self._feats_pred:
            fp = self.features(np.stack(self._feats_pred))
            fg = self.features(np.stack(self._feats_gt))
            fid = frechet_distance(fp, fg)
            ssim_mean = out["total"]["ssim"]["mean"]
            fid_score = max(0.0, 1.0 - fid / self.integral_fid_norm)
            denom = ssim_mean + fid_score
            out["total"][getattr(self.features, "fid_key", "fid_vgg")] = fid
            out["total"]["ssim_fid100_f1"] = (
                2 * ssim_mean * fid_score / denom if denom > 0 else 0.0)
        return out

    @staticmethod
    def _table(rows):
        keys = [k for k in rows[0] if k != "mask_area"]
        return {k: {"mean": float(np.mean([r[k] for r in rows])),
                    "std": float(np.std([r[k] for r in rows]))}
                for k in keys} | {"n": len(rows)}
