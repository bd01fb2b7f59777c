"""Host-side training loop for the 2D inpainter (port of
`spinnerf_tpu/train/lama_loop.py`).

Parity: `lama/bin/train.py` and the Lightning wiring
(`saicinpainting/training/trainers/base.py`): image batches with
on-the-fly masks, the G + D step (`train/lama_trainer.py`), visualizer
grids (`training/visualizers/directory.py`), checkpoints
(`train/checkpoints.py`; resume from the newest), validation with the
binned `InpaintingEvaluator`, and the metrics JSONL that
`pipeline.lama_tools.report_from_logs` reads. Runs on the card unless the
caller asks for the CPU; PNGs are read and written without cv2. With a
mesh (`parallel.Mesh`) every rank draws the same global batch from the
seed and the step keeps its share; only rank 0 writes metrics, grids,
validation and checkpoints.
"""
from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

import numpy as np
import torch

from spinnerf_tpu_torch import resolve_device
from spinnerf_tpu_torch.data.lama_masks import MixedMaskGenerator
from spinnerf_tpu_torch.data.llff import imread_rgb8
from spinnerf_tpu_torch.eval.render import write_png
from spinnerf_tpu_torch.models.discriminator import NLayerDiscriminator
from spinnerf_tpu_torch.models.lama import FFCResNetGenerator
from spinnerf_tpu_torch.parallel import mesh as mesh_lib
from spinnerf_tpu_torch.train.lama_trainer import (make_batch,
                                                   make_lama_train_step,
                                                   to_nchw)


def load_image_dir(indir, *, max_images=None):
    """Training images ([H, W, 3] float32 list) from a directory tree, or
    from tar shards when `indir` holds `*.tar` (`data.shards`)."""
    indir = Path(indir)
    shard_paths = (sorted(indir.glob("*.tar")) if indir.is_dir()
                   else ([indir] if indir.suffix == ".tar" else []))
    if shard_paths:
        from spinnerf_tpu_torch.data import shards
        images = []
        for img in shards.iter_shard_images(shard_paths, shuffle_buffer=64):
            images.append(img)
            if max_images and len(images) >= max_images:
                break
        if not images:
            raise FileNotFoundError(f"no images in shards under {indir}")
        return images
    paths = sorted(p for p in Path(indir).rglob("*")
                   if p.suffix.lower() in (".png", ".jpg", ".jpeg")
                   and "_mask" not in p.stem)
    if max_images:
        paths = paths[:max_images]
    images = [imread_rgb8(p).astype(np.float32) / 255.0 for p in paths]
    if not images:
        raise FileNotFoundError(f"no images under {indir}")
    return images


def visualize_batch(images, masks, preds, out_path, *, max_items: int = 8):
    """One grid PNG: a row per sample, columns [image | masked | pred |
    blended] (`training/visualizers/directory.py`); NHWC numpy in."""
    rows = []
    for i in range(min(len(images), max_items)):
        img, m, pred = images[i], masks[i], preds[i]
        masked = img * (1.0 - m)
        blended = pred * m + img * (1.0 - m)
        rows.append(np.concatenate([img, masked, pred, blended], axis=1))
    grid = np.clip(np.concatenate(rows, axis=0), 0, 1)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    write_png(out_path, (grid * 255).astype(np.uint8))
    return out_path


def make_perceptual_fn(kind: str, *, weights_path=None, device=None):
    """The perceptual term: `resnet_pl` (big-lama's: ADE20k dilated-ResNet
    features, `losses/perceptual.py:88-113`), `vgg` (the sum of VGG16
    feature MSEs) or `none`. The loss takes NCHW tensors in [0, 1]."""
    if kind == "none" or kind is None:
        return None
    if kind == "resnet_pl":
        from spinnerf_tpu_torch.models.segmentation import make_resnet_pl
        loss_fn, _ = make_resnet_pl(weights_path=weights_path, device=device)
        return loss_fn
    if kind == "vgg":
        from spinnerf_tpu_torch.models.lpips import VGG16Features
        net = VGG16Features(device=device)
        net.reset_parameters(torch.Generator().manual_seed(0))

        def loss_fn(pred, target):
            fp = net(pred)
            with torch.no_grad():
                ft = net(target)
            total = 0.0
            for a, b in zip(fp, ft):
                total = total + ((a - b) ** 2).mean()
            return total
        return loss_fn
    raise ValueError(f"unknown perceptual kind {kind}")


def train_inpainter(indir, exp_dir, *, n_steps: int = 1000,
                    batch_size: int = 8, crop: int = 256,
                    val_dir=None, gen_kwargs=None, disc_kwargs=None,
                    i_print: int = 50, i_vis: int = 250, i_ckpt: int = 500,
                    i_val: int = 0, seed: int = 0, max_images=None,
                    perceptual: str = "none", perceptual_weights=None,
                    log=print, device=None, mesh=None):
    """Train the FFC inpainter on an image directory on `device` (the card
    unless the caller asks for the CPU). Returns the `LamaTrainState`.

    Writes `<exp_dir>/metrics.jsonl`, grids under
    `<exp_dir>/visualizations/` and checkpoints of the whole state
    (G, D, EMA, both optimizers) under `<exp_dir>/checkpoints/`; resumes
    from the newest one. With `mesh`, this rank's part of a data-parallel
    run (`batch_size` divisible by its size); every rank returns its state,
    once rank 0 has written what it writes.
    """
    from spinnerf_tpu_torch.train.checkpoints import CheckpointManager

    if mesh is not None and batch_size % mesh.size:
        raise ValueError(f"batch size {batch_size} does not split over "
                         f"{mesh.size} ranks")
    writes = mesh is None or mesh.rank == 0
    if not writes:
        log = mesh_lib.quiet
    device = resolve_device(device)
    exp_dir = Path(exp_dir)
    exp_dir.mkdir(parents=True, exist_ok=True)
    images = load_image_dir(indir, max_images=max_images)
    log(f"{len(images)} training images from {indir}")

    gen = FFCResNetGenerator(device=device, **(gen_kwargs or {}))
    disc = NLayerDiscriminator(device=device, **(disc_kwargs or {}))
    init_fn, step_fn = make_lama_train_step(
        gen, disc,
        perceptual_fn=make_perceptual_fn(perceptual,
                                         weights_path=perceptual_weights,
                                         device=device),
        mesh=mesh)
    state = init_fn(seed)

    ckpt = CheckpointManager(exp_dir, save_interval=i_ckpt)
    latest = ckpt.latest_step()
    if latest is not None:
        _, restored = ckpt.restore(map_location=device)
        state.load_state_dict(restored["params"])
        log(f"resumed inpainter training from step {latest}")
    if mesh is not None:            # every rank starts from rank 0's state
        mesh.broadcast_(list(gen.parameters()) + list(gen.buffers())
                        + list(disc.parameters()) + list(disc.buffers())
                        + list(state.ema.values()))

    mask_gen = MixedMaskGenerator()
    rng = np.random.RandomState(seed)
    ema_gen = FFCResNetGenerator(device=device, **(gen_kwargs or {}))
    start = state.step
    t_print = time.time()
    steps_since_print = 0
    with (open(exp_dir / "metrics.jsonl", "a") if writes
          else contextlib.nullcontext()) as mfile:
        for i in range(start, n_steps):
            idx = rng.choice(len(images), batch_size)
            crops, masks = make_batch([images[j] for j in idx], mask_gen,
                                      rng, crop=crop)
            metrics = step_fn(state, to_nchw(crops, device),
                              to_nchw(masks, device))
            steps_since_print += 1

            if i_print and (i % i_print == 0 or i == n_steps - 1):
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t_print
                t_print = time.time()
                rate = batch_size * steps_since_print / dt
                steps_since_print = 0
                if writes:
                    mfile.write(json.dumps({"step": i, **m}) + "\n")
                    mfile.flush()
                log(f"[{i}/{n_steps}] g_total {m['g_total']:.4f} "
                    f"d_total {m['d_total']:.4f} g_l1 {m['g_l1']:.4f} "
                    f"({rate:.1f} img/s)")
            if not writes:
                continue
            if i_vis and i % i_vis == 0:
                ema_gen.load_state_dict(state.ema_state_dict())
                masked = crops * (1.0 - masks)
                inp = to_nchw(np.concatenate([masked, masks], -1), device)
                with torch.no_grad():
                    preds = ema_gen(inp).permute(0, 2, 3, 1).cpu().numpy()
                visualize_batch(crops, masks, preds, exp_dir
                                / "visualizations" / f"step_{i:06d}.png")
            ckpt.maybe_save(i, state.state_dict(), 0,
                            force=(i == n_steps - 1))
            if i_val and val_dir and i and i % i_val == 0:
                ema_gen.load_state_dict(state.ema_state_dict())
                res = validate_inpainter(ema_gen, val_dir)
                mfile.write(json.dumps({"step": i, "val": res["total"]})
                            + "\n")
                mfile.flush()
    if mesh is not None:
        mesh.barrier()
    return state


def validate_inpainter(gen: FFCResNetGenerator, val_dir) -> dict:
    """Score a generator (the EMA one, in eval mode) on a LaMa eval-layout
    directory with the binned `InpaintingEvaluator` (the reference's
    validation_epoch_end)."""
    from spinnerf_tpu_torch.eval.inpainting import InpaintingEvaluator
    from spinnerf_tpu_torch.pipeline.inpaint2d import predict
    from spinnerf_tpu_torch.pipeline.lama_tools import (_imread_mask,
                                                        _imread_rgb,
                                                        load_eval_pairs)
    ev = InpaintingEvaluator(device=next(gen.parameters()).device)
    for ip, mp in load_eval_pairs(val_dir):
        img = _imread_rgb(ip)
        mask = _imread_mask(mp)
        pred = predict(gen, img, mask)
        ev.add(pred * mask[..., None] + img * (1 - mask[..., None]),
               img, mask)
    return ev.evaluation_end()
