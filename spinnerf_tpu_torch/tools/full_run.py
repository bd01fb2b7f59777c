"""The full pipeline at the scale users run it, on the card (the port's copy
of `tools/full_run.py`, with the same flags, scene, budgets and JSON).

    python -m spinnerf_tpu_torch.tools.full_run --model hashgrid \\
        --out FULLRUN_torch_hashgrid.json

Generates a statue-demo-scale synthetic scene: 100 views (the first 40
object-removed ground-truth test views, then 60 training views, the
paper's protocol, `README.md:27-31`) at 2016 x 1134, trained at factor 2
(1008 x 567), and runs every pipeline stage at the reference's budgets:

  MVSeg    N_iters=4000             (`MVSeg/DS_NeRF/configs/mv_config.txt`)
  prepare  N_iters=4001, i_feat=4000 (`README.md:65`)
  LaMa     refine=True              (`README.md:80`)
  fit      N_iters=10001, --lpips, i_feat=200 (`README.md:140`)
  eval     PSNR/SSIM/LPIPS + masked PSNR (`DS_NeRF/eval_metrics_script.py`)

Writes `<workdir>/FULLRUN_torch.json` (or `--out`) with each stage's
wall-clock seconds and the final metrics; `config.device` is the card's
name and power limit. Flags:

  --model {mlp,hashgrid}  the 8 x 256 MLP (the reference's `--no_tcnn`,
                          fused kernels #9/#10) or the hash grid at the
                          default 2^19 table (#1/#2).
  --iters-scale S         divide every stage's budget by S.
  --views N --gt N        the view counts.
  --smoke                 a tiny model and no LaMa refinement (plumbing).
  --skip-mvseg            reuse the label/ masks of an earlier run.
  --analytic-guidance     after timing LaMa, fit on the scene's analytic
                          object-removed renders (the default when no
                          big-lama checkpoint is in SPINNERF_WEIGHTS_DIR).

The scene directory carries a marker of the parameters it was generated
with; a finished scene with the same parameters is reused, any other is
generated anew.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from dataclasses import replace as dc_replace
from pathlib import Path

import torch

from spinnerf_tpu_torch import resolve_device

DEFAULT_WORKDIR = Path(__file__).resolve().parents[2] / "build" / "full_run"


def card_name(device) -> str:
    """`torch.cuda.get_device_name` and the power limit nvidia-smi reports
    (e.g. "NVIDIA H100 80GB HBM3, 700.00 W"); "cpu" on the CPU."""
    if device.type != "cuda":
        return "cpu"
    name = torch.cuda.get_device_name(device)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             f"--id={device.index or 0}"],
            capture_output=True, text=True, check=True, timeout=60)
        return f"{name}, {smi.stdout.strip()}"
    except (OSError, subprocess.SubprocessError):
        return f"{name}, power limit not read (nvidia-smi failed)"


def _images_dir(scene_dir: Path, factor: int) -> Path:
    return scene_dir / (f"images_{factor}" if factor != 1 else "images")


def make_scene(work, *, views, gt, h, w, factor, analytic) -> Path:
    """`<work>/scene`: reused when its marker holds these parameters and its
    last file (sparse/0/points3D.bin) exists, else generated anew. The
    first `gt` views are the object-removed ground truth; initial masks
    are on 6 of the training views (MVSeg lifts the rest); the analytic
    object-removed renders are moved to `analytic_guidance/` (`analytic`)
    or deleted, since the pipeline makes the guidance itself."""
    from spinnerf_tpu_torch.data import synthetic
    scene_dir = Path(work) / "scene"
    gen_params = {"views": views, "gt": gt, "h": h, "w": w,
                  "factor": factor, "analytic": analytic}
    marker = scene_dir / "fullrun_scene.json"
    if (marker.exists() and (scene_dir / "sparse/0/points3D.bin").exists()
            and json.loads(marker.read_text()) == gen_params):
        return scene_dir
    if scene_dir.exists():
        shutil.rmtree(scene_dir)
    print(f"[fullrun] generating {views}-view scene ({h}x{w}, factor "
          f"{factor})", flush=True)
    synthetic.make_scene(
        scene_dir, n_views=views, h=h, w=w, factor=factor, n_gt=gt,
        n_points=3000, mask_views=list(range(gt, views,
                                             max(1, (views - gt) // 6))),
        gt_mask_subdir="label_full")
    fdir = _images_dir(scene_dir, factor)
    if analytic:
        keep = scene_dir / "analytic_guidance"
        keep.mkdir(exist_ok=True)
        shutil.move(str(fdir / "lama_images"), keep / "lama_images")
        shutil.move(str(fdir / "depth"), keep / "depth")
    else:
        shutil.rmtree(fdir / "lama_images")
        shutil.rmtree(fdir / "depth")
    marker.write_text(json.dumps(gen_params))
    return scene_dir


def main(argv=None, *, device=None):
    ap = argparse.ArgumentParser("spinnerf_tpu_torch.tools.full_run")
    ap.add_argument("--model", choices=("mlp", "hashgrid"), default="mlp")
    ap.add_argument("--iters-scale", type=float, default=1.0)
    ap.add_argument("--views", type=int, default=100)
    ap.add_argument("--gt", type=int, default=40)
    ap.add_argument("--h", type=int, default=1134)
    ap.add_argument("--w", type=int, default=2016)
    ap.add_argument("--factor", type=int, default=2)
    ap.add_argument("--workdir", default=str(DEFAULT_WORKDIR))
    ap.add_argument("--out", default=None,
                    help="the JSON's path (default <workdir>/"
                    "FULLRUN_torch.json)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny model + no LaMa refine (plumbing test)")
    ap.add_argument("--analytic-guidance", default=None, action="store_true",
                    help="after timing the LaMa stage, substitute the "
                    "synthetic scene's analytic object-removed renders as "
                    "the fit's guidance. Default: on when no big-lama "
                    "checkpoint is registered (random-weight guidance would "
                    "make the fit and eval measure the missing checkpoint); "
                    "off when real weights exist (SPINNERF_WEIGHTS_DIR)")
    ap.add_argument("--skip-mvseg", action="store_true",
                    help="reuse label/ masks already exported by a previous "
                    "(possibly interrupted) run on the same scene dir")
    ap.add_argument("--mvseg-seconds", type=float, default=None,
                    help="with --skip-mvseg: record this measured mvseg "
                    "wall-clock in stage_seconds")
    args = ap.parse_args(argv)

    from spinnerf_tpu_torch import weights as wreg
    from spinnerf_tpu_torch.config import Config
    from spinnerf_tpu_torch.pipeline import stages

    device = resolve_device(device)
    if args.analytic_guidance is None:
        args.analytic_guidance = wreg.find("big_lama") is None
    if args.gt <= 0:
        # stage_eval needs test views
        raise SystemExit("--gt must be >= 1 (object-removed GT test views)")

    work = Path(args.workdir)
    out_path = Path(args.out) if args.out else work / "FULLRUN_torch.json"
    t0 = time.perf_counter()
    scene_dir = make_scene(work, views=args.views, gt=args.gt, h=args.h,
                           w=args.w, factor=args.factor,
                           analytic=bool(args.analytic_guidance))
    fdir = _images_dir(scene_dir, args.factor)
    gen_s = round(time.perf_counter() - t0, 1)
    print(f"[fullrun] scene ready in {gen_s}s", flush=True)

    s = args.iters_scale
    iters = {"mvseg": max(2, int(4000 / s)),
             "prepare": max(2, int(4001 / s)),
             "fit": max(2, int(10001 / s))}
    cfg = Config(
        # DS_NeRF/configs/config.txt (the statue demo: factor 2)
        expname="fullrun", basedir=str(work / "logs"),
        datadir=str(scene_dir), dataset_type="llff",
        N_gt=args.gt, factor=args.factor,
        N_rand=1024, N_samples=64, N_importance=64,
        use_viewdirs=True, raw_noise_std=1.0,
        colmap_depth=True, depth_loss=True, depth_lambda=0.1,
        no_ndc=True, lindisp=True, render_factor=1,
        i_feat=200, feat_weight=0.1,
        # lrate 0.03 / decay 10 is the hash grid's operating point; the
        # 8 x 256 MLP takes the argparse default 5e-4 / 250
        # (`run_nerf.py:769-771`), as the JAX tool does
        lrate=(0.03 if args.model == "hashgrid" else 5e-4),
        lrate_decay=(10 if args.model == "hashgrid" else 250),
        white_bkgd=True,
        # masked metrics against the exact hole masks: MVSeg's export
        # overwrites label/ with its estimated masks
        masks_gt_subdir="label_full",
        # the stage commands' flags (README.md:65,140): no checkpoint or
        # video dumps
        i_weights=0, i_video=0, i_testset=0, i_print=500,
        no_tcnn=(args.model == "mlp"),
        lpips_batch_size=4,
    )
    if args.smoke:
        cfg = dc_replace(cfg, netdepth=2, netwidth=32, netdepth_fine=2,
                         netwidth_fine=32, multires=4, multires_views=2,
                         N_samples=8, N_importance=4, N_rand=64, chunk=2048,
                         lpips_render_factor=2, patch_len_factor=2,
                         lpips_batch_size=1, compute_dtype="float32")
    if args.skip_mvseg:
        label_dir = fdir / "label"
        n_labels = (len(list(label_dir.glob("*.png")))
                    if label_dir.exists() else 0)
        if n_labels < args.views:
            raise SystemExit(f"--skip-mvseg: only {n_labels}/{args.views} "
                             f"masks under {label_dir}")
    guidance_hook = None
    if args.analytic_guidance:
        def guidance_hook():
            # LaMa was timed above; without a big-lama checkpoint its
            # outputs come from seeded random weights, so the fit takes the
            # scene's analytic object-removed renders instead
            src = scene_dir / "analytic_guidance"
            for d in ("lama_images", "depth"):
                shutil.rmtree(fdir / d, ignore_errors=True)
                shutil.copytree(src / d, fdir / d)
            print("[fullrun] guidance replaced by the analytic "
                  "object-removed renders (--analytic-guidance)", flush=True)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _, results = stages.run_pipeline(
        cfg, mvseg_iters=iters["mvseg"], prepare_iters=iters["prepare"],
        fit_iters=iters["fit"], refine=not args.smoke,
        skip_mvseg=args.skip_mvseg, guidance_hook=guidance_hook,
        device=device)
    if args.skip_mvseg and args.mvseg_seconds is not None:
        results["stage_seconds"]["mvseg"] = args.mvseg_seconds
        results["mvseg_timing_note"] = (
            "measured by a previous interrupted run on this scene "
            "(masks reused)")

    results["config"] = {
        "model": args.model, "views": args.views, "n_gt": args.gt,
        "analytic_guidance": bool(args.analytic_guidance),
        "train_res": [args.h // args.factor, args.w // args.factor],
        "iters": iters,
        "scene_gen_seconds": gen_s,
        "device": card_name(device),
    }
    if device.type == "cuda":
        results["peak_device_memory_gib"] = (
            torch.cuda.max_memory_allocated(device) / 2 ** 30)
    results.pop("per_view", None)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(results, indent=2))
    print(json.dumps({k: results[k] for k in
                      ("summary", "stage_seconds", "config",
                       "peak_device_memory_gib") if k in results}, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
