"""Adversarial trainer for the 2D inpainter, LaMa training (port of
`spinnerf_tpu/train/lama_trainer.py`).

Parity: `DefaultInpaintingTrainingModule`
(`lama/saicinpainting/training/trainers/{base,default}.py`): alternating
generator / discriminator Adam steps (1e-3 / 1e-4, eps 1e-8,
`configs/training/optimizers/default_optimizers.yaml`), each gradient
clipped to a global norm of 1, the generator's EMA (decay 0.999 over its
parameters, `base.py:34-40,92-97`), the big-lama loss stack
(`train/lama_losses.py`) and on-the-fly masks (`data/lama_masks.py`).

One step reproduces the JAX step's mix of BatchNorm modes
(`models/batchnorm.py`, flax's semantics):
- generator phase: G in train mode (its running statistics updated); D in
  eval mode on its running statistics for the fake and the real image;
- discriminator phase: the fake from the updated G in eval mode; the R1
  penalty through D in eval mode on the running statistics from before
  this phase (taken first: a train-mode pass replaces them);
  D in train mode on the real image, then in eval mode on the fake with
  the statistics that pass produced, differentiated through them as flax
  does (`graph_stats`).

With a mesh (`parallel.Mesh`) the step takes the global batch and keeps
this rank's share; G's and D's train-mode BatchNorms take the whole batch's
statistics (`models/batchnorm.py::sync_batchnorm`), each gradient is
averaged across ranks before the clip, so the norm is the global one, and
the EMA stays replicated.

Clipping is optax's `clip_by_global_norm`: g / |g| * max only when
|g| >= max (torch's `clip_grad_norm_` scales by max / (|g| + 1e-6)). The
whole step runs with TF32 off in cuDNN and in matmuls, forward and
backward; the previous settings are restored afterwards.
"""
from __future__ import annotations

import numpy as np
import torch

from spinnerf_tpu_torch.data.lama_masks import MixedMaskGenerator
from spinnerf_tpu_torch.models.batchnorm import graph_stats, sync_batchnorm
from spinnerf_tpu_torch.models.discriminator import NLayerDiscriminator
from spinnerf_tpu_torch.models.lama import FFCResNetGenerator
from spinnerf_tpu_torch.models.lpips import _f32_convs
from spinnerf_tpu_torch.train.lama_losses import (LamaLossWeights,
                                                  discriminator_adversarial_loss,
                                                  feature_matching_loss,
                                                  generator_adversarial_loss,
                                                  masked_l1,
                                                  r1_gradient_penalty)


class LamaTrainState:
    """G, D, the EMA of G's parameters ({name: tensor}), the two Adam
    optimizers and the step count; `state_dict` / `load_state_dict` for
    checkpoints."""

    def __init__(self, gen, disc, gen_opt, disc_opt):
        self.gen, self.disc = gen, disc
        self.gen_opt, self.disc_opt = gen_opt, disc_opt
        self.ema = {n: p.detach().clone() for n, p in gen.named_parameters()}
        self.step = 0

    def ema_state_dict(self) -> dict:
        """G's state dict with the EMA parameters in place of its own (the
        running statistics are G's)."""
        sd = self.gen.state_dict()
        sd.update(self.ema)
        return sd

    def state_dict(self) -> dict:
        return {"gen": self.gen.state_dict(), "disc": self.disc.state_dict(),
                "ema": dict(self.ema), "gen_opt": self.gen_opt.state_dict(),
                "disc_opt": self.disc_opt.state_dict(), "step": self.step}

    def load_state_dict(self, sd: dict):
        self.gen.load_state_dict(sd["gen"])
        self.disc.load_state_dict(sd["disc"])
        for n, v in sd["ema"].items():
            self.ema[n].copy_(v)
        self.gen_opt.load_state_dict(sd["gen_opt"])
        self.disc_opt.load_state_dict(sd["disc_opt"])
        self.step = int(sd["step"])
        return self


def clip_by_global_norm_(params, max_norm: float):
    """optax's `clip_by_global_norm` on the `.grad` of `params`, in place,
    with no host synchronisation. Returns the norm before clipping."""
    grads = [p.grad for p in params]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    # (g / |g|) * max, optax's order of operations
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return norm


def make_lama_train_step(gen: FFCResNetGenerator, disc: NLayerDiscriminator,
                         *, weights: LamaLossWeights = LamaLossWeights(),
                         gen_lr: float = 1e-3, disc_lr: float = 1e-4,
                         ema_decay: float = 0.999, grad_clip: float = 1.0,
                         perceptual_fn=None, mesh=None):
    """(init_fn, step_fn) for adversarial inpainter training.

    init_fn(seed=0) -> LamaTrainState: G and D reset from
    `torch.Generator().manual_seed(seed)` and `seed + 1` (flax's default
    initialisers; not the JAX package's draws), the EMA a copy of G's
    parameters, fresh optimizers.
    step_fn(state, images [N, 3, H, W], masks [N, 1, H, W]) -> metrics
    ({name: 0-d tensor}); G, D, the EMA and the optimizers update in place.
    With `mesh`, images and masks are the global batch (N divisible by the
    mesh's size) and the metrics are the means across ranks.
    """
    sync_batchnorm(gen, mesh)
    sync_batchnorm(disc, mesh)

    def make_opts(g, d):
        return (torch.optim.Adam(g.parameters(), lr=gen_lr,
                                 betas=(0.9, 0.999), eps=1e-8),
                torch.optim.Adam(d.parameters(), lr=disc_lr,
                                 betas=(0.9, 0.999), eps=1e-8))

    def init_fn(seed: int = 0):
        gen.reset_parameters(torch.Generator().manual_seed(seed))
        disc.reset_parameters(torch.Generator().manual_seed(seed + 1))
        return LamaTrainState(gen, disc, *make_opts(gen, disc))

    def net_input(images, masks):
        return torch.cat([images * (1.0 - masks), masks], dim=1)

    def update(params, loss, opt):
        grads = torch.autograd.grad(loss, params)
        for p, g in zip(params, grads):
            p.grad = g
        if mesh is not None:
            mesh.all_reduce_mean_([p.grad for p in params])
        clip_by_global_norm_(params, grad_clip)
        opt.step()

    def step_fn(state: LamaTrainState, images, masks):
        g_params = list(gen.parameters())
        d_params = list(disc.parameters())
        if mesh is not None:
            images, masks = mesh.shard_rows(images), mesh.shard_rows(masks)
        inp = net_input(images, masks)
        with _f32_convs():
            # ---- generator phase: D, feature matching and the perceptual
            # term see the raw output (`trainers/default.py:96,120`)
            gen.train()
            disc.eval()
            pred = gen(inp)
            fake_logits, fake_feats = disc(pred)
            with torch.no_grad():
                _, real_feats = disc(images)
            l1 = masked_l1(pred, images, masks,
                           weight_known=weights.l1_known,
                           weight_missing=weights.l1_missing)
            adv = generator_adversarial_loss(fake_logits, masks)
            fm = feature_matching_loss(fake_feats, real_feats)
            loss = l1 + weights.adversarial * adv + \
                weights.feature_matching * fm
            metrics = {"g_l1": l1, "g_adv": adv, "g_fm": fm}
            if perceptual_fn is not None and weights.perceptual > 0:
                pl = perceptual_fn(pred, images)
                loss = loss + weights.perceptual * pl
                metrics["g_perceptual"] = pl
            metrics["g_total"] = loss
            update(g_params, loss, state.gen_opt)
            with torch.no_grad():      # decay e + (1 - decay) p
                torch._foreach_lerp_(list(state.ema.values()), g_params,
                                     1.0 - ema_decay)

            # ---- discriminator phase
            gen.eval()
            with torch.no_grad():
                fake = gen(inp)
            gp = r1_gradient_penalty(disc, images)
            with graph_stats(disc):
                disc.train()
                real_logits, _ = disc(images)
                disc.eval()
                fake_logits, _ = disc(fake)
                d_adv = discriminator_adversarial_loss(real_logits,
                                                       fake_logits, masks)
                d_loss = d_adv + weights.gp_coef * gp
                update(d_params, d_loss, state.disc_opt)
        state.step += 1
        metrics.update(d_adv=d_adv, d_gp=gp, d_total=d_loss)
        if mesh is not None:
            return mesh.mean_metrics(metrics)
        return {k: v.detach() for k, v in metrics.items()}

    return init_fn, step_fn


def make_batch(images, mask_gen: MixedMaskGenerator, rng, crop: int = 256):
    """Host-side batch: random crops (reflect-padded when an image is
    smaller) and synthesised masks, drawing from `rng` in the JAX
    package's order. Returns (crops [N, c, c, 3], masks [N, c, c, 1]),
    numpy."""
    crops, masks = [], []
    for img in images:
        h, w = img.shape[:2]
        y = rng.randint(0, max(h - crop + 1, 1))
        x = rng.randint(0, max(w - crop + 1, 1))
        patch = img[y:y + crop, x:x + crop]
        if patch.shape[:2] != (crop, crop):
            patch = np.pad(patch, ((0, crop - patch.shape[0]),
                                   (0, crop - patch.shape[1]), (0, 0)),
                           mode="reflect")
        crops.append(patch)
        masks.append(mask_gen(crop, crop, rng)[..., None])
    return np.stack(crops), np.stack(masks)


def to_nchw(a: np.ndarray, device) -> torch.Tensor:
    """[N, H, W, C] numpy -> [N, C, H, W] float32 on `device`."""
    return torch.as_tensor(np.ascontiguousarray(a.transpose(0, 3, 1, 2)),
                           dtype=torch.float32, device=device)
