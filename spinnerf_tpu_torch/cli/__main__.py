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
  gen_masks       inpainting eval-set synthesis (`gen_mask_dataset.py`)
  lama_train      adversarial inpainter training (`lama/bin/train.py`)
  eval_inpainting score predictions (`evaluate_predicts.py`)
  side_by_side    predictor comparison sheets (`side_by_side.py`)
  analyze_errors  worst-case mining (`analyze_errors.py`)
  inner_features  generator latent dumps (`predict_inner_features.py`)
  export          the generator traced with TorchScript (`to_jit.py`)
  report          summarize a metrics JSONL (`report_from_tb.py`)

All accept `--config <file>` with the reference's config.txt syntax.
Commands that train, render or score run on the CUDA card; `main(argv,
device="cpu")` runs them on the CPU.
"""
from __future__ import annotations

import sys

_MASK_KINDS = ["mixed", "irregular", "rectangle", "outpainting", "dumb",
               "superres", "squares", "segm"]


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


def _gen_masks(rest, device):
    """An inpainting eval dataset: for each image `<name>_crop000.png` and
    `<name>_crop000_maskNNN.png` pairs (the LaMa eval layout; parity:
    `lama/bin/gen_mask_dataset.py`)."""
    import argparse
    from pathlib import Path

    import numpy as np

    from spinnerf_tpu_torch.data import lama_masks
    from spinnerf_tpu_torch.data.llff import imread_rgb8
    from spinnerf_tpu_torch.eval.render import write_png
    ap = argparse.ArgumentParser("spinnerf gen_masks")
    ap.add_argument("--indir", required=True)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--n_masks", type=int, default=1,
                    help="mask variants per image")
    ap.add_argument("--kind", default="mixed", choices=_MASK_KINDS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--segm_weights", default=None,
                    help="--kind segm: MIT ade20k encoder weights "
                         "(default: $SPINNERF_WEIGHTS_DIR pickup)")
    a = ap.parse_args(rest)
    gen = {"mixed": lama_masks.MixedMaskGenerator(),
           "irregular": lama_masks.irregular_mask,
           "rectangle": lama_masks.rectangle_mask,
           "outpainting": lama_masks.outpainting_mask,
           "dumb": lama_masks.dumb_area_mask,
           "superres": lama_masks.superres_mask,
           "squares": lama_masks.squares_mask, "segm": None}[a.kind]
    segm_gen = None
    if a.kind == "segm":
        # learned object-mask proposal (gen_mask_dataset.py with
        # SegmentationMask; eval/masks.py's ADE20k adaptation)
        from spinnerf_tpu_torch.eval.masks import (LearnedMaskGenerator,
                                                   ade20k_instances)
        segm_gen = LearnedMaskGenerator(
            ade20k_instances(a.segm_weights, device=device), seed=a.seed)
    indir, outdir = Path(a.indir), Path(a.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(a.seed)
    n_pairs = n_skipped = 0
    for p in sorted(indir.iterdir()):
        if p.suffix.lower() not in (".png", ".jpg", ".jpeg"):
            continue
        img = imread_rgb8(p)
        h, w = img.shape[:2]
        stem = f"{p.stem}_crop000"
        write_png(outdir / f"{stem}.png", img)
        if segm_gen is not None:
            segm_masks = segm_gen.get_masks(
                img.astype(np.float32) / 255.0)[:a.n_masks]
            if not segm_masks:   # no usable object: no orphan image
                (outdir / f"{stem}.png").unlink(missing_ok=True)
                n_skipped += 1
                continue
            for k, m in enumerate(segm_masks):
                write_png(outdir / f"{stem}_mask{k:03d}.png",
                          (m * 255).astype(np.uint8))
                n_pairs += 1
            continue
        for k in range(a.n_masks):
            # a generator may legally draw an empty mask (min_times=0);
            # an eval pair needs a hole
            for _ in range(20):
                m = np.asarray(gen(h, w, rng)).reshape(h, w)
                if m.any():
                    break
            write_png(outdir / f"{stem}_mask{k:03d}.png",
                      (m * 255).astype(np.uint8))
            n_pairs += 1
    msg = f"wrote {n_pairs} image/mask pairs to {outdir}"
    if n_skipped:
        msg += f" ({n_skipped} images skipped: no usable object mask)"
    print(msg)
    return 0


def _lama_train(rest, device):
    """Adversarial inpainter training (parity: `lama/bin/train.py`)."""
    import argparse
    ap = argparse.ArgumentParser("spinnerf lama_train")
    ap.add_argument("--indir", required=True)
    ap.add_argument("--exp_dir", required=True)
    ap.add_argument("--val_dir", default=None)
    ap.add_argument("--n_steps", type=int, default=1000)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--crop", type=int, default=256)
    ap.add_argument("--i_val", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ngf", type=int, default=64,
                    help="generator width (big-lama: 64)")
    ap.add_argument("--n_blocks", type=int, default=18,
                    help="FFC resblocks (big-lama: 18)")
    ap.add_argument("--perceptual", default="none",
                    choices=["none", "vgg", "resnet_pl"],
                    help="perceptual loss (big-lama: resnet_pl)")
    ap.add_argument("--perceptual_weights", default=None,
                    help="MIT ade20k encoder torch checkpoint")
    a = ap.parse_args(rest)
    from spinnerf_tpu_torch.train.lama_loop import train_inpainter
    train_inpainter(a.indir, a.exp_dir, n_steps=a.n_steps,
                    batch_size=a.batch_size, crop=a.crop,
                    val_dir=a.val_dir, i_val=a.i_val, seed=a.seed,
                    gen_kwargs=dict(ngf=a.ngf, n_blocks=a.n_blocks),
                    perceptual=a.perceptual,
                    perceptual_weights=a.perceptual_weights, device=device)
    return 0


def _eval_inpainting(rest, device):
    """Score precomputed predictions (`lama/bin/evaluate_predicts.py`)."""
    import argparse
    ap = argparse.ArgumentParser("spinnerf eval_inpainting")
    ap.add_argument("--datadir", required=True)
    ap.add_argument("--predictdir", required=True)
    ap.add_argument("--outpath", required=True)
    ap.add_argument("--fid", action="store_true",
                    help="compute the Fréchet statistic (InceptionV3 "
                         "pool3; real FID when pt_inception.pth is in "
                         "$SPINNERF_WEIGHTS_DIR, else reported as "
                         "fid_random_inception)")
    ap.add_argument("--inception_weights", default=None,
                    help="explicit pytorch-fid InceptionV3 state_dict")
    ap.add_argument("--lpips", action="store_true",
                    help="also score LPIPS (real when vgg16.pth + "
                         "lpips_vgg_lin.pth are dropped in)")
    a = ap.parse_args(rest)
    from spinnerf_tpu_torch.pipeline import lama_tools
    fe = None
    if a.fid or a.inception_weights:
        from spinnerf_tpu_torch.eval.inpainting import \
            InceptionFeatureExtractor
        fe = InceptionFeatureExtractor(a.inception_weights, device=device)
    lpips_fn, lpips_key = None, "lpips"
    if a.lpips:
        from spinnerf_tpu_torch.models.lpips import load_lpips_labeled
        lpips_fn, lpips_key = load_lpips_labeled(device=device)
    results = lama_tools.evaluate_predicts(a.datadir, a.predictdir,
                                           a.outpath, lpips_fn=lpips_fn,
                                           lpips_key=lpips_key,
                                           feature_extractor=fe,
                                           device=device)
    for group, tbl in results.items():
        print(group, {k: (round(v["mean"], 4)
                          if isinstance(v, dict) else round(v, 4))
                      for k, v in tbl.items() if k != "n"})
    return 0


def _side_by_side(rest, device):
    import argparse
    ap = argparse.ArgumentParser("spinnerf side_by_side")
    ap.add_argument("--datadir", required=True)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--max_n", type=int, default=100)
    ap.add_argument("--black", action="store_true")
    ap.add_argument("predictdirs", nargs="+")
    a = ap.parse_args(rest)
    from spinnerf_tpu_torch.pipeline import lama_tools
    out = lama_tools.side_by_side(a.datadir, a.predictdirs, a.outdir,
                                  max_n=a.max_n, black=a.black)
    print(f"comparison sheets written to {out}")
    return 0


def _analyze_errors(rest, device):
    import argparse
    ap = argparse.ArgumentParser("spinnerf analyze_errors")
    ap.add_argument("--datadir", required=True)
    ap.add_argument("--predictdir", required=True)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--worst_k", type=int, default=10)
    ap.add_argument("--sort_by", default="ssim")
    a = ap.parse_args(rest)
    from spinnerf_tpu_torch.pipeline import lama_tools
    lama_tools.analyze_errors(a.datadir, a.predictdir, a.outdir,
                              worst_k=a.worst_k, sort_by=a.sort_by,
                              device=device)
    print(f"error analysis written to {a.outdir}")
    return 0


def _inner_features(rest, device):
    import argparse
    ap = argparse.ArgumentParser("spinnerf inner_features")
    ap.add_argument("--indir", required=True)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--model_path", default=None)
    a = ap.parse_args(rest)
    from spinnerf_tpu_torch.pipeline import lama_tools
    out = lama_tools.predict_inner_features(
        a.indir, a.outdir, checkpoint_path=a.model_path, device=device)
    print(f"inner features written to {out}")
    return 0


def _export(rest, device):
    """The generator traced with TorchScript (parity: `lama/bin/to_jit.py`;
    the JAX package writes StableHLO)."""
    import argparse
    ap = argparse.ArgumentParser("spinnerf export")
    ap.add_argument("--outpath", required=True)
    ap.add_argument("--model_path", default=None)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=512)
    a = ap.parse_args(rest)
    from spinnerf_tpu_torch.pipeline import lama_tools
    out = lama_tools.export_generator(
        a.outpath, checkpoint_path=a.model_path,
        input_shape=(1, 4, a.height, a.width), device=device)
    print(f"serialized generator written to {out}")
    return 0


def _report(rest, device):
    """Summarize a metrics JSONL (parity: `lama/bin/report_from_tb.py`)."""
    from spinnerf_tpu_torch.pipeline import lama_tools
    print(lama_tools.format_report(lama_tools.report_from_logs(rest[0])))
    return 0


# the LaMa training and evaluation commands
_LAMA = {"gen_masks": _gen_masks, "lama_train": _lama_train,
         "eval_inpainting": _eval_inpainting, "side_by_side": _side_by_side,
         "analyze_errors": _analyze_errors,
         "inner_features": _inner_features, "export": _export,
         "report": _report}


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

    if cmd in _LAMA:
        return _LAMA[cmd](rest, device)

    print(f"unknown command: {cmd}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
