"""Point sampling along rays: stratified coarse samples and inverse-CDF
hierarchical importance sampling.

Port of `spinnerf_tpu/core/sampling.py`. Randomness is explicit: each
sampler takes its uniforms (`t_rand`, `u`) or a `torch.Generator`. The
inverse-CDF lookup is `torch.searchsorted(right=True)`. Under data
parallelism a rank renders some rows of a batch (`Rows`): it draws for the
whole batch and keeps its rows, so N ranks draw what one rank draws.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Rows(NamedTuple):
    """The rows `index` ([b] int64) of a batch of `total` rays that this
    rank renders."""
    index: torch.Tensor
    total: int


def draw(sampler, shape, *, rows: Rows | None = None, generator=None,
         dtype=None, device=None):
    """`sampler(shape)` (`torch.rand` or `torch.randn`) from `generator`;
    with `rows`, the draw for the whole batch (`rows.total` rows) at
    `rows.index`."""
    if rows is None:
        return sampler(shape, generator=generator, dtype=dtype, device=device)
    full = sampler((rows.total,) + tuple(shape[1:]), generator=generator,
                   dtype=dtype, device=device)
    return full[rows.index]


def stratified_z_vals(near, far, n_samples: int, *, lindisp: bool = False,
                      perturb: bool = True, t_rand=None, generator=None,
                      rows: Rows | None = None):
    """Coarse sample depths [B, n_samples] between per-ray near/far [B].

    perturb jitters each sample within its stratum by `t_rand`
    ([B, n_samples] uniforms) or, when None, by draws from `generator`
    (for the whole batch of `rows` when given)."""
    t = torch.linspace(0.0, 1.0, n_samples, dtype=near.dtype,
                       device=near.device)
    near = near[..., None]
    far = far[..., None]
    if lindisp:
        z_vals = 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    else:
        z_vals = near * (1.0 - t) + far * t
    z_vals = z_vals.expand(*near.shape[:-1], n_samples)
    if perturb:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], mids], dim=-1)
        if t_rand is None:
            t_rand = draw(torch.rand, z_vals.shape, rows=rows,
                          generator=generator, dtype=z_vals.dtype,
                          device=z_vals.device)
        z_vals = lower + (upper - lower) * t_rand
    return z_vals


def sample_pdf(bins, weights, n_samples: int, *, det: bool = False, u=None,
               generator=None, rows: Rows | None = None):
    """Inverse-CDF importance sampling over histogram weights.

    bins [B, N] bin edges, weights [B, N-1]. u: optional [B, n_samples]
    explicit uniforms; otherwise evenly spaced (det) or drawn from
    `generator` (for the whole batch of `rows` when given). Returns samples
    [B, n_samples]."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [B, N]

    batch, n = cdf.shape
    if u is None:
        if det:
            u = torch.linspace(0.0, 1.0, n_samples, dtype=cdf.dtype,
                               device=cdf.device).expand(batch, n_samples)
        else:
            u = draw(torch.rand, (batch, n_samples), rows=rows,
                     generator=generator, dtype=cdf.dtype, device=cdf.device)
    u = u.contiguous()

    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=n - 1)
    cdf_below = torch.gather(cdf, 1, below)
    cdf_above = torch.gather(cdf, 1, above)
    bins_below = torch.gather(bins, 1, below)
    bins_above = torch.gather(bins, 1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def hierarchical_z_vals(z_vals, weights, n_importance: int, *,
                        det: bool = False, u=None, generator=None,
                        rows: Rows | None = None):
    """Fine-pass depths: importance samples merged and sorted with the
    coarse ones. Returns (z_combined [B, Nc+Nf], z_samples [B, Nf])."""
    z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    z_samples = sample_pdf(z_mid, weights[..., 1:-1], n_importance, det=det,
                           u=u, generator=generator, rows=rows).detach()
    z_combined, _ = torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1)
    return z_combined, z_samples


def ray_points(origins, directions, z_vals):
    """World-space sample positions o + d * z, [B, S, 3]."""
    return origins[..., None, :] + directions[..., None, :] * z_vals[..., :, None]
