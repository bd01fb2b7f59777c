"""The fused training step (port of `spinnerf_tpu/train/step.py`).

All active ray groups are concatenated into one ray batch and rendered in a
single coarse+fine pass; the detached-weights RGB map comes from the same
composite. Loss terms:
  clf    MSE outside the mask (+ coarse)
  rgb    MSE on inpainted RGB inside the mask, weights detached (+ coarse);
         0.001 * mean(acc) in object-removal mode
  inp    MSE between rendered disparity and the inpainted disparity
         (+ coarse), NaN-guarded
  depth  COLMAP sparse-depth loss, weighted by depth_lambda
  sigma  optional URF sigma loss on the depth rays
  seg    MVSeg BCE on composited logits
  distortion  optional mip-NeRF 360 regularizer
  lpips  stage 5's patch-LPIPS term (`train/lpips_patch.py`), after its
         start step
With a frozen field (`--alpha_model_path`) the density comes, without a
gradient, from that field.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from spinnerf_tpu_torch.core import losses, rendering, sampling
from spinnerf_tpu_torch.core.rendering import RenderConfig
from spinnerf_tpu_torch.data import raybank


class TrainConfig(NamedTuple):
    """Static training hyperparameters."""
    render: RenderConfig = RenderConfig()
    n_rand: int = 1024
    prepare: bool = False
    masked_nerf: bool = False
    object_removal: bool = False
    no_geometry: bool = False
    use_coarse_loss: bool = True        # reference: not --no_coarse
    single_image: bool = False          # reference --no_batching sampler
    precrop_iters: int = 0
    precrop_frac: float = 0.5
    epoch_sampling: bool = True         # without-replacement epoch strides
    depth_supervision: bool = False     # --colmap_depth --depth_loss
    depth_with_rgb: bool = False        # supervise the photometric batch's
    #                                     own rendered depth
    depth_lambda: float = 0.1
    weighted_loss: bool = False
    relative_loss: bool = False
    normalize_depth: bool = False
    sigma_loss: bool = False
    sigma_lambda: float = 0.1
    semantic: bool = False              # MVSeg mode: BCE on composited logits
    clf_weight: float = 0.01
    distortion_weight: float = 0.0


def _active_groups(cfg: TrainConfig, bank: raybank.RayBank):
    """Which pixel groups take part in this run."""
    if cfg.semantic:
        groups = ["rgb"]
        if bank.groups.get("seg") is not None and bank.groups["seg"].count > 0:
            groups.append("seg")
        return groups
    groups = ["clf"]
    if not cfg.masked_nerf or cfg.object_removal:
        groups.append("rgb")
    if (not cfg.prepare and not cfg.object_removal and not cfg.no_geometry
            and bank.inp_depths is not None and bank.groups["inp"].count > 0):
        groups.append("inp")
    # an empty group would train on its zero-padding pixel: drop it
    groups = [g for g in groups if bank.groups[g].count > 0]
    if not groups:
        raise ValueError("no non-empty ray groups for this config/scene "
                         "(is the mask empty or all-covering?)")
    return groups


def _concat_batches(batches: list[dict]) -> dict:
    keys = set.intersection(*(set(b) for b in batches))
    return {k: torch.cat([b[k] for b in batches]) for k in keys}


def _with_frozen_sigma(field, frozen_raw_fn):
    def field_fn(pts, viewdirs):
        with torch.no_grad():
            sigma = frozen_raw_fn(pts, viewdirs)[..., 3:4]
        return field(pts, viewdirs, frozen_sigma=sigma)
    return field_fn


def make_train_step(fields: nn.ModuleDict, cfg: TrainConfig,
                    bank: raybank.RayBank, optimizer, *, lpips_fn=None,
                    frozen_raw_fn=None):
    """Build the train step over `fields` ({"coarse"[, "fine"]}, see
    `init_params`) and `optimizer` (`schedule.make_optimizer` over their
    parameters).

    lpips_fn: optional `lpips_fn(generator) -> scalar` (the patch term of
      `train/lpips_patch.py`), computed only when step_idx > its
      `start_iter` (`run_nerf.py:1523`; JAX multiplies it by a 0/1 factor to
      keep its graph static); otherwise `metrics["lpips_loss"]` is 0.
    frozen_raw_fn: optional frozen field `(pts, viewdirs) -> raw`, run under
      `torch.no_grad()`; its column 3 is the density of both passes (the
      NeRF_RGB / --alpha_model_path mode, `run_nerf_helpers.py:159-216`).

    Returns step(step_idx, generator=None) -> metrics, a dict of 0-d
    tensors; it updates the fields in place. `generator` draws the
    stratified jitter and importance-sampling uniforms (with perturb), the
    density noise, the patch term's views and anchors and, without epoch
    sampling or with `single_image`, the batch indices.
    `step.loss_fn(step_idx, generator)` gives (loss, metrics) without the
    update; `step.field_fns` are the (coarse, fine) field functions the
    step renders with."""
    groups = _active_groups(cfg, bank)
    use_depth = (cfg.depth_supervision and bank.depth_group is not None
                 and bank.depth_group.count > 0)
    b = cfg.n_rand
    rcfg = cfg.render
    coarse_fn = fields["coarse"]
    fine_fn = fields["fine"] if "fine" in fields else coarse_fn
    if frozen_raw_fn is not None:
        coarse_fn = _with_frozen_sigma(coarse_fn, frozen_raw_fn)
        fine_fn = _with_frozen_sigma(fine_fn, frozen_raw_fn)

    def loss_fn(step_idx: int, generator=None):
        batches, targets = [], []
        step = step_idx if cfg.epoch_sampling else None
        for name in groups:
            if cfg.single_image and name in ("clf", "rgb"):
                ba, tg = raybank.sample_single_image(
                    bank, b, step_idx, precrop_iters=cfg.precrop_iters,
                    precrop_frac=cfg.precrop_frac, generator=generator)
            else:
                ba, tg = raybank.sample_group(bank, name, b, step=step,
                                              generator=generator)
            batches.append(ba)
            targets.append(tg)
        if use_depth:
            depth_batch = raybank.sample_depth_group(bank, b, step=step,
                                                     generator=generator)
            if not cfg.depth_with_rgb:
                batches.append({k: depth_batch[k]
                                for k in ("origins", "directions", "near",
                                          "far", "viewdirs")})

        fused = _concat_batches(batches)
        res = rendering.render_rays(fused, coarse_fn, rcfg,
                                    fine_field_fn=fine_fn, generator=generator)
        fine, coarse = res.fine, res.coarse

        def seg(x, i):
            return x[i * b:(i + 1) * b]

        metrics = {}
        loss = torch.zeros((), dtype=torch.float32, device=bank.device)
        gi = {name: i for i, name in enumerate(groups)}

        # primary photometric group: 'clf' in the DS-NeRF modes, 'rgb' in
        # MVSeg mode
        i = gi["clf"] if "clf" in gi else gi["rgb"]
        tgt = targets[i]["rgb"]
        img_loss = losses.mse(seg(fine.rgb, i), tgt)
        metrics["psnr"] = losses.mse_to_psnr(img_loss)
        if cfg.use_coarse_loss and coarse is not None:
            img_loss = img_loss + losses.mse(seg(coarse.rgb, i), tgt)
        loss = loss + img_loss
        metrics["img_loss"] = img_loss

        if "seg" in gi:
            i = gi["seg"]
            lbl = torch.clamp(targets[i]["label"], 0.0, 1.0)
            clf_loss = losses.bce_with_logits(seg(fine.prob, i), lbl)
            if cfg.use_coarse_loss and coarse is not None:
                clf_loss = clf_loss + losses.bce_with_logits(
                    seg(coarse.prob, i), lbl)
            loss = loss + cfg.clf_weight * clf_loss
            metrics["clf_loss"] = clf_loss

        if "rgb" in gi and not cfg.semantic:
            i = gi["rgb"]
            if cfg.object_removal:
                acc_term = 0.001 * torch.mean(seg(fine.acc, i))
                loss = loss + acc_term
                metrics["acc_loss"] = acc_term
            elif not cfg.masked_nerf:
                tgt = targets[i]["rgb"]
                m_loss = losses.mse(seg(fine.rgb_sg, i), tgt)
                if cfg.use_coarse_loss and coarse is not None:
                    m_loss = m_loss + losses.mse(seg(coarse.rgb_sg, i), tgt)
                loss = loss + m_loss
                metrics["masked_loss"] = m_loss

        if "inp" in gi:
            i = gi["inp"]
            tgt = targets[i]["inp_depth"]
            inp_loss = losses.mse(seg(fine.disp, i), tgt)
            if cfg.use_coarse_loss and coarse is not None:
                inp_loss = inp_loss + losses.mse(seg(coarse.disp, i), tgt)
            inp_loss = torch.where(torch.isnan(inp_loss),
                                   torch.zeros_like(inp_loss), inp_loss)
            loss = loss + inp_loss
            metrics["inp_loss"] = inp_loss

        if use_depth:
            # --depth_with_rgb supervises the primary batch's rendered depth
            i = ((gi["clf"] if "clf" in gi else gi["rgb"])
                 if cfg.depth_with_rgb else len(groups))
            d_loss = losses.depth_loss(
                seg(fine.depth, i), depth_batch["depths"],
                ray_weights=depth_batch["weights"],
                weighted=cfg.weighted_loss, relative=cfg.relative_loss,
                normalize=cfg.normalize_depth,
                max_depth=bank.depth_group.max_depth)
            loss = loss + cfg.depth_lambda * d_loss
            metrics["depth_loss"] = d_loss

            if cfg.sigma_loss:
                # resample from near to the GT depth; density should spike at
                # the last sample
                t = torch.linspace(0.0, 1.0, rcfg.n_samples,
                                   device=bank.device)
                z = (depth_batch["near"][:, None] * (1 - t)
                     + depth_batch["depths"][:, None] * t)
                pts = sampling.ray_points(depth_batch["origins"],
                                          depth_batch["directions"], z)
                raw = fine_fn(pts, depth_batch["viewdirs"])
                s_loss = torch.mean(losses.sigma_loss(torch.relu(raw[..., 3])))
                loss = loss + cfg.sigma_lambda * s_loss
                metrics["sigma_loss"] = s_loss

        if cfg.distortion_weight > 0.0:
            dist = losses.distortion_loss(fine.weights, fine.z_vals)
            loss = loss + cfg.distortion_weight * dist
            metrics["distortion"] = dist

        if lpips_fn is not None:
            if step_idx > getattr(lpips_fn, "start_iter", 0):
                lp = lpips_fn(generator)
                loss = loss + lp
            else:
                lp = torch.zeros((), dtype=torch.float32, device=bank.device)
            metrics["lpips_loss"] = lp

        metrics["loss"] = loss
        return loss, metrics

    def step(step_idx: int, generator=None):
        optimizer.zero_grad()
        loss, metrics = loss_fn(step_idx, generator)
        loss.backward()
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    step.loss_fn = loss_fn
    step.field_fns = (coarse_fn, fine_fn)
    return step


def init_params(make_model, generator=None, *, n_importance: int = 64,
                make_fine_model=None) -> nn.ModuleDict:
    """Build and initialize the {"coarse"[, "fine"]} fields: `make_model()`
    builds a field, whose `reset_parameters(generator)` draws its weights
    from the CPU `generator`. `make_fine_model` builds a separately sized
    fine field (`--netdepth_fine/--netwidth_fine`); defaults to
    `make_model`."""
    fields = nn.ModuleDict({"coarse": make_model()})
    fields["coarse"].reset_parameters(generator)
    if n_importance > 0:
        fine = (make_fine_model or make_model)()
        fine.reset_parameters(generator)
        fields["fine"] = fine
    return fields
