"""Inpainter tooling: evaluate predictions, side-by-side sheets, error
analysis, inner-feature dumps, the TorchScript export and training-log
reports (port of `spinnerf_tpu/pipeline/lama_tools.py`).

Parity targets (`lama/bin/`): `evaluate_predicts.py` (score a directory of
precomputed predictions against image / mask pairs, a TSV table out),
`side_by_side.py`, `analyze_errors.py` (worst-case mining and a per-bin
breakdown), `predict_inner_features.py` (generator latents per image),
`to_jit.py` (the generator traced with TorchScript, where the JAX package
writes a `jax.export` StableHLO file) and `report_from_tb.py` (here over
the metrics JSONL the trainers write).

All tools read the LaMa eval layout: `<stem>.png` images with
`<stem>_mask*.png` masks beside them (`saicinpainting/evaluation/data.py`),
predictions named after the mask file in another directory. PNGs are read
and written by `eval/render.py` and INTER_AREA resizes computed by
`utils/resize.py`, with cv2's results; JPEGs need cv2. The networks run on
`device` (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import json
import warnings
from pathlib import Path

import numpy as np
import torch

from spinnerf_tpu_torch.data.llff import imread_gray8, imread_rgb8
from spinnerf_tpu_torch.eval.render import write_png
from spinnerf_tpu_torch.utils.resize import area_resize

IMG_SUFFIXES = (".png", ".jpg", ".jpeg")


def _imread_rgb(path) -> np.ndarray:
    """cv2.imread's colour read, RGB, float32 in [0, 1]."""
    return imread_rgb8(path).astype(np.float32) / 255.0


def _imread_mask(path) -> np.ndarray:
    """cv2's grayscale read thresholded at 0.5 (1 = hole)."""
    m = imread_gray8(path)
    return (m.astype(np.float32) / 255.0 > 0.5).astype(np.float32)


def _imwrite_rgb(path, img) -> None:
    write_png(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))


def _match_size(pred, img):
    """A prediction INTER_AREA-resized to the image's size."""
    if pred.shape != img.shape:
        pred = area_resize(pred, img.shape[0], img.shape[1])
    return pred


def load_eval_pairs(datadir):
    """Enumerate (image_path, mask_path) pairs in a LaMa eval dataset dir.

    Masks are `<imgstem>_mask*.png`; one image may have several masks
    (parity: `InpaintingDataset`, `evaluation/data.py:65-96`).
    """
    datadir = Path(datadir)
    masks = sorted(p for p in datadir.iterdir()
                   if p.suffix.lower() in IMG_SUFFIXES and "_mask" in p.stem)
    pairs = []
    for mp in masks:
        stem = mp.stem[:mp.stem.index("_mask")]
        for suf in IMG_SUFFIXES:
            ip = datadir / (stem + suf)
            if ip.exists():
                pairs.append((ip, mp))
                break
    return pairs


def _find_prediction(predictdir, mask_path):
    """Predictions are named after the mask file (LaMa convention) or the
    image stem (our `inpaint_directory` convention)."""
    predictdir = Path(predictdir)
    stem = mask_path.stem
    img_stem = stem[:stem.index("_mask")] if "_mask" in stem else stem
    for cand in (stem, img_stem):
        for suf in IMG_SUFFIXES:
            p = predictdir / (cand + suf)
            if p.exists():
                return p
    raise FileNotFoundError(
        f"no prediction for {mask_path.name} in {predictdir}")


def score_predictions(datadir, predictdir, *, lpips_fn=None,
                      feature_extractor=None, lpips_key="lpips",
                      device=None):
    """Score a directory of precomputed predictions, the metrics on
    `device`.

    Returns (results dict from `InpaintingEvaluator.evaluation_end`,
    per-image rows). Parity: `bin/evaluate_predicts.py`.
    """
    from spinnerf_tpu_torch.eval.inpainting import InpaintingEvaluator
    ev = InpaintingEvaluator(lpips_fn=lpips_fn, lpips_key=lpips_key,
                             feature_extractor=feature_extractor,
                             device=device)
    names = []
    for ip, mp in load_eval_pairs(datadir):
        img = _imread_rgb(ip)
        mask = _imread_mask(mp)
        pred = _match_size(_imread_rgb(_find_prediction(predictdir, mp)),
                           img)
        ev.add(pred, img, mask)
        names.append(mp.name)
    results = ev.evaluation_end()
    rows = [dict(r, name=n) for r, n in zip(ev.rows, names)]
    return results, rows


def write_results_tsv(results: dict, outpath) -> Path:
    """Flatten the binned results dict into the reference's TSV table shape
    (groups x metrics, mean/std columns)."""
    outpath = Path(outpath)
    outpath.parent.mkdir(parents=True, exist_ok=True)
    metric_names = sorted({k for tbl in results.values()
                           for k in tbl if isinstance(tbl[k], dict)})
    lines = ["group\tn\t" + "\t".join(
        f"{k}_mean\t{k}_std" for k in metric_names)]
    for group, tbl in results.items():
        cells = [group, str(tbl.get("n", ""))]
        for k in metric_names:
            if isinstance(tbl.get(k), dict):
                cells += [f"{tbl[k]['mean']:.4f}", f"{tbl[k]['std']:.4f}"]
            else:
                cells += ["", ""]
        lines.append("\t".join(cells))
    scalars = {k: v for k, v in results.get("total", {}).items()
               if isinstance(v, float)}
    for k, v in scalars.items():
        lines.append(f"{k}\t\t{v:.4f}")
    outpath.write_text("\n".join(lines) + "\n")
    return outpath


def evaluate_predicts(datadir, predictdir, outpath, *, lpips_fn=None,
                      feature_extractor=None, lpips_key="lpips",
                      device=None) -> dict:
    """Score + write the TSV table (parity: `bin/evaluate_predicts.py`)."""
    results, rows = score_predictions(datadir, predictdir, lpips_fn=lpips_fn,
                                      feature_extractor=feature_extractor,
                                      lpips_key=lpips_key, device=device)
    write_results_tsv(results, outpath)
    with open(str(outpath) + ".per_image.json", "w") as f:
        json.dump(rows, f, indent=2)
    return results


def _mask_outline(img, mask):
    """GT panel with the mask region shaded red (the reference's
    `visualize_mask_and_images` mask-on-first-panel behavior)."""
    out = img.copy()
    m = mask > 0.5
    out[m] = 0.6 * out[m] + 0.4 * np.array([1.0, 0.0, 0.0])
    return out


def side_by_side(datadir, predictdirs, outdir, *, max_n: int = 100,
                 black: bool = False, seed: int = 0) -> Path:
    """Comparison sheets: [GT+mask | pred_1 | pred_2 | ...] per example
    (parity: `bin/side_by_side.py`)."""
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    pairs = load_eval_pairs(datadir)
    if len(pairs) > max_n:
        rng = np.random.RandomState(seed)
        pairs = [pairs[i] for i in
                 sorted(rng.choice(len(pairs), max_n, replace=False))]
    for ip, mp in pairs:
        img = _imread_rgb(ip)
        mask = _imread_mask(mp)
        first = img * (1.0 - mask[..., None]) if black \
            else _mask_outline(img, mask)
        panels = [first]
        for pd in predictdirs:
            panels.append(_match_size(
                _imread_rgb(_find_prediction(pd, mp)), img))
        _imwrite_rgb(outdir / mp.name, np.concatenate(panels, axis=1))
    return outdir


def analyze_errors(datadir, predictdir, outdir, *, worst_k: int = 10,
                   sort_by: str = "ssim", lpips_fn=None,
                   device=None) -> dict:
    """Worst-case mining: score everything, write per-mask-area-bin tables,
    and dump side-by-side sheets + an HTML gallery of the `worst_k` examples
    (parity: `bin/analyze_errors.py`, distilled)."""
    from spinnerf_tpu_torch.utils.visualization import write_gallery
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    results, rows = score_predictions(datadir, predictdir, lpips_fn=lpips_fn,
                                      device=device)
    write_results_tsv(results, outdir / "metrics.tsv")

    ascending = sort_by in ("ssim", "psnr")  # low = bad for similarity scores
    rows_sorted = sorted(rows, key=lambda r: r[sort_by],
                         reverse=not ascending)
    worst = rows_sorted[:worst_k]
    by_mask = {mp.name: (ip, mp) for ip, mp in load_eval_pairs(datadir)}
    sheet_paths = []
    for r in worst:
        ip, mp = by_mask[r["name"]]
        img = _imread_rgb(ip)
        mask = _imread_mask(mp)
        pred = _match_size(_imread_rgb(_find_prediction(predictdir, mp)),
                           img)
        name = f"worst_{sort_by}_{r[sort_by]:.4f}_{r['name']}"
        _imwrite_rgb(outdir / name,
                     np.concatenate([_mask_outline(img, mask), pred], axis=1))
        sheet_paths.append(name)
    write_gallery(outdir / "report.html",
                  [(f"worst {worst_k} by {sort_by}", sheet_paths)],
                  title=f"error analysis: {predictdir}")
    with open(outdir / "per_image.json", "w") as f:
        json.dump(rows_sorted, f, indent=2)
    return results


def predict_inner_features(indir, outdir, *, checkpoint_path=None,
                           n_channels: int = 16, device=None) -> Path:
    """Run the generator's front on each image / mask pair and dump the
    latent feature maps: raw `.npy` ([H / 8, W / 8, C], the local and
    global channels concatenated) and a channel-grid PNG per image
    (parity: `bin/predict_inner_features.py`)."""
    from spinnerf_tpu_torch.pipeline.inpaint2d import (load_generator,
                                                       pad_to_modulo)
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    gen = load_generator(checkpoint_path, device)
    dev = next(gen.parameters()).device
    for ip, mp in load_eval_pairs(indir):
        img = _imread_rgb(ip)
        mask = _imread_mask(mp)
        img_p, _ = pad_to_modulo(img)
        m_p, _ = pad_to_modulo(mask)
        m_p = m_p[..., None]
        inp = np.concatenate([img_p * (1 - m_p), m_p], -1)
        x = torch.as_tensor(inp.transpose(2, 0, 1)[None].copy(),
                            dtype=torch.float32, device=dev)
        with torch.no_grad():
            z_l, z_g = gen.front(x)
        z = z_l if z_g is None else torch.cat([z_l, z_g], dim=1)
        z = z[0].permute(1, 2, 0).cpu().numpy()
        np.save(outdir / f"{mp.stem}_features.npy", z)
        k = min(n_channels, z.shape[-1])
        cols = int(np.ceil(np.sqrt(k)))
        h, w = z.shape[:2]
        grid = np.zeros((cols * h, cols * w), np.float32)
        for i in range(k):
            ch = z[..., i]
            lo, hi = ch.min(), ch.max()
            ch = (ch - lo) / max(hi - lo, 1e-8)
            r, c = divmod(i, cols)
            grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = ch
        _imwrite_rgb(outdir / f"{mp.stem}_features.png",
                     np.repeat(grid[..., None], 3, axis=-1))
    return outdir


def export_generator(outpath, *, checkpoint_path=None,
                     input_shape=(1, 4, 512, 512), device=None) -> Path:
    """Trace the generator in inference mode with TorchScript
    (`torch.jit.trace`, the reference's `bin/to_jit.py`) at `input_shape`
    (NCHW: the masked RGB and the mask) on `device`, and save it; reload
    with `torch.jit.load(path)`. The JAX package writes a `jax.export`
    StableHLO file instead."""
    from spinnerf_tpu_torch.pipeline.inpaint2d import load_generator
    gen = load_generator(checkpoint_path, device).eval()
    dev = next(gen.parameters()).device
    x = torch.zeros(input_shape, dtype=torch.float32, device=dev)
    with torch.no_grad(), warnings.catch_warnings():
        # the trace is for this input size: shapes turn into constants
        warnings.simplefilter("ignore", torch.jit.TracerWarning)
        traced = torch.jit.trace(gen, x, check_trace=False)
    outpath = Path(outpath)
    outpath.parent.mkdir(parents=True, exist_ok=True)
    traced.save(str(outpath))
    return outpath


def report_from_logs(jsonl_path, *, keys=None) -> dict:
    """Summarize a metrics JSONL (one dict per step) into first/last/min/max
    per metric (parity: `bin/report_from_tb.py` over our log format)."""
    rows = []
    with open(jsonl_path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    if not rows:
        return {}
    out = {}
    names = keys or sorted({k for r in rows for k in r
                            if isinstance(r[k], (int, float))})
    for k in names:
        vals = [r[k] for r in rows if k in r]
        if not vals:
            continue
        out[k] = {"first": vals[0], "last": vals[-1],
                  "min": min(vals), "max": max(vals), "n": len(vals)}
    return out


def format_report(report: dict) -> str:
    lines = [f"{'metric':<24}{'first':>12}{'last':>12}"
             f"{'min':>12}{'max':>12}{'n':>8}"]
    for k, v in report.items():
        lines.append(f"{k:<24}{v['first']:>12.5g}{v['last']:>12.5g}"
                     f"{v['min']:>12.5g}{v['max']:>12.5g}{v['n']:>8d}")
    return "\n".join(lines)
