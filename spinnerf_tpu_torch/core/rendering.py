"""Volume rendering: alpha compositing and the coarse-to-fine render.

Port of `spinnerf_tpu/core/rendering.py`. One `composite()` returns both the
grad-through-weights RGB and the detached-weights RGB, so a single field
evaluation serves every loss term; the optional semantic channel composites
to a `prob` map with detached weights. Noise and jitter come from an explicit
`torch.Generator` (or explicit tensors, for tests).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from spinnerf_tpu_torch.core import sampling
from spinnerf_tpu_torch.core.sampling import Rows
from spinnerf_tpu_torch.parallel.mesh import pad_to_multiple

# A field function maps (points [B,S,3], viewdirs [B,3]) -> raw outputs
# [B, S, C] with C >= 4: rgb logits (3), sigma (1), then an optional
# semantic logit at index 4.
FieldFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class RenderOutputs(NamedTuple):
    """Per-ray composited maps."""
    rgb: torch.Tensor            # [B, 3]   grad flows through weights
    rgb_sg: torch.Tensor         # [B, 3]   weights detached
    disp: torch.Tensor           # [B]
    acc: torch.Tensor            # [B]
    depth: torch.Tensor          # [B]
    weights: torch.Tensor        # [B, S]
    alpha: torch.Tensor          # [B, S]
    z_vals: torch.Tensor         # [B, S]
    prob: torch.Tensor | None    # [B]
    logits: torch.Tensor | None  # [B, S]


def exclusive_cumprod_one(x):
    """cumprod with a leading 1: T_i = prod_{j<i} x_j. Shape-preserving."""
    ones = torch.ones_like(x[..., :1])
    return torch.cumprod(torch.cat([ones, x], dim=-1), dim=-1)[..., :-1]


def composite(raw, z_vals, rays_d, *, raw_noise_std: float = 0.0,
              noise=None, generator=None, white_bkgd: bool = False,
              semantic: bool = False, only_object: bool = False,
              oo_threshold: float | None = None,
              harsh_bg_remove: bool = False,
              rows: Rows | None = None) -> RenderOutputs:
    """Alpha-composite raw field outputs [B, S, C] along each ray.

    alpha_i = 1 - exp(-relu(sigma_i + noise) * dist_i * |d|)
    w_i     = alpha_i * prod_{j<i}(1 - alpha_j + 1e-10)

    noise: optional [B, S] standard normals (scaled by raw_noise_std);
    drawn from `generator` when None and raw_noise_std > 0 (for the whole
    batch of `rows` when given). The remaining
    flags follow `spinnerf_tpu.core.rendering.composite`.
    """
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)

    rgb = torch.sigmoid(raw[..., :3])

    sigma = raw[..., 3]
    if raw_noise_std > 0.0:
        if noise is None:
            noise = sampling.draw(torch.randn, sigma.shape, rows=rows,
                                  generator=generator, dtype=sigma.dtype,
                                  device=sigma.device)
        sigma = sigma + noise * raw_noise_std

    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)

    logits = raw[..., 4] if raw.shape[-1] > 4 else None
    if only_object:
        if logits is None:
            raise ValueError("only_object requires a semantic channel")
        alpha = alpha * (1.0 - torch.sigmoid(logits))
        if oo_threshold is not None:
            alpha = torch.where(alpha > oo_threshold,
                                torch.zeros_like(alpha), alpha)
            for _ in range(5):
                left = torch.nn.functional.pad(alpha[:, 1:], (0, 1))
                right = torch.nn.functional.pad(alpha[:, :-1], (1, 0))
                alpha = (left + alpha + right) / 3.0

    weights = alpha * exclusive_cumprod_one(1.0 - alpha + 1e-10)
    weights_sg = weights.detach()

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    rgb_map_sg = torch.sum(weights_sg[..., None] * rgb, dim=-2)

    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    # double-where: an all-empty ray (acc == 0) must give a finite disp AND
    # finite gradients, or 0 * NaN poisons every gradient of the batch
    mean_z = depth_map / torch.clamp(acc_map, min=1e-10)
    disp_map = torch.where(acc_map > 1e-8,
                           1.0 / torch.clamp(mean_z, min=1e-10),
                           torch.zeros_like(mean_z))

    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
        rgb_map_sg = rgb_map_sg + (1.0 - torch.sum(weights_sg, dim=-1)[..., None])

    prob = None
    if semantic:
        if logits is None:
            raise ValueError("semantic=True requires raw channel count >= 5")
        prob = torch.sum(weights_sg * logits, dim=-1)
        if harsh_bg_remove:
            prob = prob - 10.0 * (1.0 - acc_map)

    return RenderOutputs(rgb=rgb_map, rgb_sg=rgb_map_sg, disp=disp_map,
                         acc=acc_map, depth=depth_map, weights=weights,
                         alpha=alpha, z_vals=z_vals, prob=prob, logits=logits)


class RenderConfig(NamedTuple):
    """Static rendering hyperparameters."""
    n_samples: int = 64
    n_importance: int = 64
    perturb: bool = True
    lindisp: bool = False
    raw_noise_std: float = 0.0
    white_bkgd: bool = False
    semantic: bool = False
    only_object: bool = False
    oo_threshold: float | None = None
    harsh_bg_remove: bool = False


class RenderResult(NamedTuple):
    coarse: RenderOutputs | None
    fine: RenderOutputs
    z_std: torch.Tensor | None  # [B] std of importance samples


def render_rays(ray_batch: dict, field_fn: FieldFn, cfg: RenderConfig,
                fine_field_fn: FieldFn | None = None,
                generator=None, rows: Rows | None = None) -> RenderResult:
    """Coarse(+fine) volumetric rendering of a ray batch.

    generator: draws the stratified jitter, the importance-sampling uniforms
    and the density noise (only where `cfg` asks for them); with `rows`,
    the batch is those rows of a larger one, and each draw is made for the
    larger batch and indexed by them."""
    origins, dirs = ray_batch["origins"], ray_batch["directions"]
    viewdirs = ray_batch["viewdirs"]

    z_vals = sampling.stratified_z_vals(
        ray_batch["near"], ray_batch["far"], cfg.n_samples,
        lindisp=cfg.lindisp, perturb=cfg.perturb, generator=generator,
        rows=rows)

    pts = sampling.ray_points(origins, dirs, z_vals)
    raw = field_fn(pts, viewdirs)
    kw = dict(raw_noise_std=cfg.raw_noise_std, generator=generator,
              white_bkgd=cfg.white_bkgd, semantic=cfg.semantic,
              only_object=cfg.only_object, oo_threshold=cfg.oo_threshold,
              harsh_bg_remove=cfg.harsh_bg_remove, rows=rows)
    coarse = composite(raw, z_vals, dirs, **kw)

    if cfg.n_importance <= 0:
        return RenderResult(coarse=None, fine=coarse, z_std=None)

    z_combined, z_samples = sampling.hierarchical_z_vals(
        z_vals, coarse.weights, cfg.n_importance, det=not cfg.perturb,
        generator=generator, rows=rows)
    pts_fine = sampling.ray_points(origins, dirs, z_combined)
    fine_fn = fine_field_fn if fine_field_fn is not None else field_fn
    raw_fine = fine_fn(pts_fine, viewdirs)
    fine = composite(raw_fine, z_combined, dirs, **kw)
    z_std = torch.std(z_samples, dim=-1, unbiased=False)
    return RenderResult(coarse=coarse, fine=fine, z_std=z_std)


def _cat_outputs(parts):
    if parts[0] is None:
        return None
    if isinstance(parts[0], tuple):
        return type(parts[0])(*(_cat_outputs([p[i] for p in parts])
                                for i in range(len(parts[0]))))
    return torch.cat(parts, dim=0)


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _rebuild(tree, leaves):
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return type(tree)(*(_rebuild(t, leaves) for t in tree))
    return next(leaves)


def _render_sharded(rb, field_fn, cfg, fine_field_fn, generator, mesh):
    """One chunk split across the mesh: each rank renders its contiguous
    share of ceil(m / size) rows (rows past the chunk's end repeat its last
    ray) with the chunk's draws, and every rank gets the whole result."""
    m = rb["origins"].shape[0]
    per = -(-m // mesh.size)
    index = torch.arange(mesh.rank * per, (mesh.rank + 1) * per,
                         device=rb["origins"].device).clamp(max=m - 1)
    res = render_rays({k: v[index] for k, v in rb.items()}, field_fn, cfg,
                      fine_field_fn, generator=generator,
                      rows=Rows(index, m))
    full = mesh.gather_rows(_leaves(res))
    return _rebuild(res, iter(x[:m] for x in full))


def render_rays_chunked(ray_batch: dict, field_fn: FieldFn,
                        cfg: RenderConfig, chunk: int,
                        fine_field_fn: FieldFn | None = None,
                        generator=None, mesh=None) -> RenderResult:
    """Render a large ray batch in chunks of `chunk` rays (bounds memory) and
    concatenate the per-ray results.

    mesh: optional `parallel.Mesh`: the chunk is rounded up to a multiple of
    its size and each chunk's rays are split across the ranks (pixel-
    parallel frame rendering); every rank returns the whole result, equal
    to the unsplit render's (each ray renders on its own)."""
    n = ray_batch["origins"].shape[0]
    if mesh is not None:
        chunk = pad_to_multiple(chunk, mesh.size)
    parts = []
    for s in range(0, n, chunk):
        rb = {k: v[s:s + chunk] for k, v in ray_batch.items()}
        if mesh is None:
            parts.append(render_rays(rb, field_fn, cfg, fine_field_fn,
                                     generator=generator))
        else:
            parts.append(_render_sharded(rb, field_fn, cfg, fine_field_fn,
                                         generator, mesh))
    return _cat_outputs(parts)
