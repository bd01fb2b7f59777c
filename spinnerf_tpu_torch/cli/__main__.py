"""Command-line entry: `python -m spinnerf_tpu_torch.cli <command> [flags]`.

Commands mirror the reference's separately-launched programs (SURVEY §0):
  train    DS-NeRF training / --prepare pass (`DS_NeRF/run_nerf.py`)
  render   render-only modes (`--render_only` equivalents)
  mvseg    multiview segmentation NeRF (`MVSeg/DS_NeRF/run_nerf.py`)
  refine_masks  reprojection mask refinement (`mask_refinement.py`)
  inpaint  LaMa 2D inpainting (`lama/bin/predict.py`)
  pipeline run all stages end to end
  eval     PSNR/SSIM/LPIPS over two image dirs (`eval_metrics_script.py`)
  poses    COLMAP -> poses_bounds.npy export (`imgs2poses.py`)
  synth    generate the synthetic test scene
  strip_ckpt      distribution checkpoint (`make_checkpoint.py`)
Not ported yet (ROADMAP.md queue A7; each raises NotImplementedError):
  gen_masks, lama_train, eval_inpainting, side_by_side, analyze_errors,
  inner_features, report; export (the JAX package's `jax.export` of the
  generator) stays out.

All accept `--config <file>` with the reference's config.txt syntax.
Commands that train, render or score run on the CUDA card; `main(argv,
device="cpu")` runs them on the CPU.
"""
from __future__ import annotations

import sys

_A7 = "ROADMAP.md queue A7"
# the JAX package's LaMa training and evaluation commands
_LAMA_COMMANDS = {
    "gen_masks": "the inpainting eval-set synthesis (gen_masks)",
    "lama_train": "adversarial inpainter training (lama_train)",
    "eval_inpainting": "inpainting prediction scoring (eval_inpainting)",
    "side_by_side": "predictor comparison sheets (side_by_side)",
    "analyze_errors": "inpainting error analysis (analyze_errors)",
    "inner_features": "generator latent dumps (inner_features)",
    "report": "metrics-log reports (report)",
}


def _render(cfg, device):
    """The render-only modes (`run_nerf.py:1167-1220`) from the
    experiment's newest checkpoint."""
    from spinnerf_tpu_torch.eval import render as eval_render
    from spinnerf_tpu_torch.train.loop import Trainer
    cfg.no_reload = False
    tr = Trainer(cfg, device=device)
    start = tr.step
    if cfg.render_test_ray:
        return _render_test_ray(tr, start)
    if cfg.render_test:
        poses, name = tr.scene.poses[tr.i_test], "test"
        gt = tr.scene.images[tr.i_test]
    elif cfg.render_train:
        poses, name = tr.scene.poses[tr.i_train], "train"
        gt = tr.scene.images[tr.i_train]
    elif cfg.render_mypath:
        # circular path around test view 3 (`run_nerf.py:1124-1127`)
        from spinnerf_tpu_torch.utils.renderpath import generate_renderpath
        anchors = tr.scene.poses[tr.i_test][3:4]
        if len(anchors) == 0:       # fewer than 4 test views
            anchors = tr.scene.poses[tr.i_test][:1]
        if len(anchors) == 0:       # no test views at all: use holdout
            anchors = tr.scene.poses[tr.scene.i_holdout:
                                     tr.scene.i_holdout + 1]
        poses = generate_renderpath(anchors, tr.scene.hwf[2], sc=1.0)
        name, gt = "mypath", None
    else:
        poses, name, gt = tr.scene.render_poses, "path", None
    out = tr.exp_dir / f"renderonly_{name}_{start:06d}"
    rgbs, disps = tr.render_poses_list(poses, save_dir=out, gt_images=gt,
                                       save_alpha=True)
    eval_render.write_video(out / "rgb.mp4", rgbs)
    eval_render.write_video(out / "disp.mp4",
                            eval_render.normalize_disps_for_video(disps))
    print(f"wrote {len(rgbs)} frames to {out}")
    return 0


def _render_test_ray(tr, start):
    """Sigma-vs-depth along the first train view's sparse-depth rays
    (`run_nerf.py:1190-1207`), the ray batch drawn with a seeded
    generator; without sparse-depth rays, rays of the RGB group."""
    import torch

    from spinnerf_tpu_torch.core import rendering, sampling
    from spinnerf_tpu_torch.data import raybank as rb
    from spinnerf_tpu_torch.utils.visualization import visualize_sigma
    out = tr.exp_dir / f"renderonly_ray_{start:06d}"
    out.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator(tr.device).manual_seed(0)
    if tr.bank.depth_group is not None:
        batch = rb.sample_depth_group(tr.bank, 64, generator=gen)
    else:
        batch, _ = rb.sample_group(tr.bank, "rgb", 64, generator=gen)
    coarse_fn, fine_fn = tr.field_fns()
    rcfg = tr.tcfg.render._replace(perturb=False, raw_noise_std=0.0)
    with torch.no_grad():
        z = sampling.stratified_z_vals(batch["near"], batch["far"],
                                       rcfg.n_samples, perturb=False,
                                       lindisp=rcfg.lindisp)
        pts = sampling.ray_points(batch["origins"], batch["directions"], z)
        sigma = torch.relu(fine_fn(pts, batch["viewdirs"])[..., 3])
        visualize_sigma(sigma[0].float().cpu().numpy(),
                        z[0].float().cpu().numpy(), out / "rays.png")
        res = rendering.render_rays(batch, coarse_fn, rcfg,
                                    fine_field_fn=fine_fn)
    if batch.get("depths") is not None:
        print("colmap depth:", float(batch["depths"][0]))
    print("estimated depth:", float(res.fine.depth[0]))
    print(f"sigma plot written to {out}/rays.png")
    return 0


def _refine_masks(rest, device):
    import argparse
    from pathlib import Path

    import numpy as np

    from spinnerf_tpu_torch.data.llff import dilate_mask, imread_gray8
    from spinnerf_tpu_torch.pipeline import mask_refine
    ap = argparse.ArgumentParser("spinnerf refine_masks")
    ap.add_argument("--render_dir", required=True,
                    help="render_path dump dir (rgb/z/alpha/pose/...)")
    ap.add_argument("--mask_dir", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--distance_thresh", type=float, default=0.01)
    ap.add_argument("--alpha_thresh", type=float, default=0.1)
    ap.add_argument("--dilate_iters", type=int, default=5)
    a = ap.parse_args(rest)
    mask_files = sorted(Path(a.mask_dir).glob("*.png"))
    masks = []
    for f in mask_files:
        # cv2.imread(f, IMREAD_GRAYSCALE), then the JAX package's threshold
        m = imread_gray8(f).astype(np.float32)
        m = (m / max(m.max(), 1) > 0.5).astype(np.float32)
        if a.dilate_iters:
            m = dilate_mask(m, iterations=a.dilate_iters)
        masks.append(m)
    dumps = mask_refine.load_view_dumps(a.render_dir, masks, device=device)
    intr = np.loadtxt(Path(a.render_dir) / "intrinsics.txt")
    mask_refine.refine_all(dumps, focal=float(intr[0, 0]),
                           cx=float(intr[0, 2]), cy=float(intr[1, 2]),
                           alpha_thresh=a.alpha_thresh,
                           distance_thresh=a.distance_thresh,
                           out_dir=a.out_dir,
                           names=[f.name for f in mask_files])
    print(f"refined masks written to {a.out_dir}")
    return 0


def _pipeline(rest, device):
    import argparse

    from spinnerf_tpu_torch.config import load_config
    from spinnerf_tpu_torch.pipeline.stages import run_pipeline
    # per-stage budgets (the reference trains each stage with its own
    # N_iters: mvseg 4000, prepare 4001, fit 10001 — README.md:65,140)
    # allow_abbrev=False: prefix matching must not steal the Config
    # flags --mvseg/--prepare as abbreviations of --mvseg_iters/...
    ap = argparse.ArgumentParser("spinnerf pipeline", add_help=False,
                                 allow_abbrev=False)
    ap.add_argument("--mvseg_iters", type=int, default=None)
    ap.add_argument("--prepare_iters", type=int, default=None)
    ap.add_argument("--fit_iters", type=int, default=None)
    ap.add_argument("--skip_mvseg", action="store_true")
    ap.add_argument("--no_refine", action="store_true")
    ap.add_argument("--lama_checkpoint", default=None)
    a, rest = ap.parse_known_args(rest)
    cfg = load_config(rest)
    _, results = run_pipeline(
        cfg, mvseg_iters=a.mvseg_iters, prepare_iters=a.prepare_iters,
        fit_iters=a.fit_iters, lama_checkpoint=a.lama_checkpoint,
        refine=not a.no_refine, skip_mvseg=a.skip_mvseg, device=device)
    print(results.get("summary", {}))
    return 0


def main(argv=None, *, device=None):
    """Run one command; returns its exit code (0, or 2 for an unknown
    command). `device` is handed to every Trainer and stage the command
    builds (default: the card)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]

    if cmd == "train":
        from spinnerf_tpu_torch.config import load_config
        from spinnerf_tpu_torch.train.loop import Trainer
        Trainer(load_config(rest), device=device).fit()
        return 0

    if cmd == "render":
        from spinnerf_tpu_torch.config import load_config
        return _render(load_config(rest), device)

    if cmd == "mvseg":
        from spinnerf_tpu_torch.config import load_config
        from spinnerf_tpu_torch.pipeline import mvseg as mvseg_lib
        from spinnerf_tpu_torch.train.loop import Trainer
        cfg = load_config(rest)
        cfg.mvseg = True
        tr = Trainer(cfg, device=device)
        tr.fit()
        out_dir, masks = mvseg_lib.export_masks(
            tr, out_subdir="label", opening=cfg.post_opening)
        print(f"wrote {len(masks)} lifted masks to {out_dir}")
        if tr.scene.masks_gt is not None:
            m = mvseg_lib.evaluate_masks(masks, tr.scene.masks_gt)
            print(f"mask accuracy {m['accuracy']:.4f} IoU {m['iou']:.4f}")
        return 0

    if cmd == "inpaint":
        import argparse
        ap = argparse.ArgumentParser("spinnerf inpaint")
        ap.add_argument("--indir", required=True)
        ap.add_argument("--outdir", required=True)
        ap.add_argument("--model_path", default=None,
                        help="big-lama torch checkpoint")
        ap.add_argument("--refine", action="store_true")
        a = ap.parse_args(rest)
        from spinnerf_tpu_torch.pipeline import inpaint2d
        out = inpaint2d.inpaint_directory(a.indir, a.outdir,
                                          checkpoint_path=a.model_path,
                                          refine=a.refine, device=device)
        print(f"inpainted images written to {out}")
        return 0

    if cmd == "pipeline":
        return _pipeline(rest, device)

    if cmd == "refine_masks":
        return _refine_masks(rest, device)

    if cmd == "eval":
        from spinnerf_tpu_torch.eval.cli import eval_dirs
        return eval_dirs(rest, device=device)

    if cmd == "poses":
        from spinnerf_tpu_torch.pipeline.poses import gen_poses
        match = rest[1] if len(rest) > 1 else "exhaustive_matcher"
        gen_poses(rest[0], match_type=match)
        print(f"poses_bounds.npy written for {rest[0]}")
        return 0

    if cmd == "strip_ckpt":
        # distribution checkpoint (parity: `lama/bin/make_checkpoint.py`)
        import argparse
        ap = argparse.ArgumentParser("spinnerf strip_ckpt")
        ap.add_argument("--exp_dir", required=True)
        ap.add_argument("--out_dir", required=True)
        ap.add_argument("--step", type=int, default=None)
        a = ap.parse_args(rest)
        from spinnerf_tpu_torch.train.checkpoints import strip_checkpoint
        step, out = strip_checkpoint(a.exp_dir, a.out_dir, step=a.step)
        print(f"stripped step-{step} params written to {out}")
        return 0

    if cmd == "synth":
        from spinnerf_tpu_torch.data import synthetic
        out = synthetic.make_scene(rest[0])
        print(f"synthetic scene written to {out}")
        return 0

    if cmd in _LAMA_COMMANDS:
        from spinnerf_tpu_torch.train.loop import _unported
        raise _unported(_LAMA_COMMANDS[cmd], _A7)

    if cmd == "export":
        raise NotImplementedError(
            f"export (the JAX package's jax.export of the LaMa generator to "
            f"StableHLO) stays out of the port; see {_A7}")

    print(f"unknown command: {cmd}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
