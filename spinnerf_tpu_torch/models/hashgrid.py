"""Instant-NGP-style multiresolution hash-grid field (port of
`spinnerf_tpu/models/hashgrid.py`).

The reference's default model `NeRF_TCNN`: a 16-level hash grid (2 features
per level, 2^19 entries, base resolution 16, finest 2048*bound), a 2x64
sigma net with trunc_exp density and 15 geometry features, SH degree-4 view
encoding and a 3x64 color net. Raw channel order [rgb logits, sigma,
(semantic logit)].

Two index functions, as in the JAX package (`impl`):
- "win" / "win_xla": the windowed index of `ops/hash_encode_win.py` with an
  exact gather, the fused CUDA kernels on the card (both impls mean that
  here);
- "mxu": the reference's instant-NGP index (dense where the level's grid
  fits the table, else the XOR-prime hash, `corner_indices_weights`)
  through `ops/hash_encode.py::hash_encode_ngp_fused`, whose CUDA kernels
  rebuild the index from the points on the card; the f32 blend, cast to
  `compute_dtype`;
- "xla": the same index and a gather on any device, with no kernel, as
  JAX's XLA branch computes it: table and weights cast to `compute_dtype`,
  their products summed over the 8 corners (an f32 accumulation rounded to
  `compute_dtype`). Any feature count.
Both windowed impls and "mxu" take features=2 and raise ValueError for
others, as JAX does. "auto" resolves as JAX's `_resolve_impl` does on a
TPU: "xla" for features != 2 or tables under 64 entries, else "win" for
tables of 2^13 entries and more and "mxu" below. On the CPU every impl
takes its plain version.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from spinnerf_tpu_torch import resolve_device
from spinnerf_tpu_torch.models.activations import trunc_exp
from spinnerf_tpu_torch.models.embedding import sh_encoding
from spinnerf_tpu_torch.ops import hash_encode as he
from spinnerf_tpu_torch.ops import hash_encode_win as hw

_WIN_IMPLS = ("win", "win_xla")
_IDX_IMPLS = ("mxu", "xla")


def calibrate_page_bounds(x01, log2_table_size: int):
    """Density-calibrated Z-CDF segment boundaries for the windowed hash:
    T//PAGE_ENTRIES sorted Z-keys cutting the samples' Z-order (x01 [K, 3]
    in [0, 1]) into equal-count segments, duplicates advanced to distinct
    keys. None when the table has fewer than two segments."""
    t = 1 << log2_table_size
    n_seg = hw.n_segments(t)
    if n_seg < 2:
        return None
    rc = np.clip((np.asarray(x01, np.float64) * 512.0).astype(np.int64),
                 0, 511)

    def spread(v):
        out = np.zeros_like(v)
        for b in range(9):
            out |= ((v >> b) & 1) << (3 * b)
        return out

    z = np.sort(spread(rc[:, 0]) | (spread(rc[:, 1]) << 1)
                | (spread(rc[:, 2]) << 2))
    bounds = z[(np.arange(n_seg, dtype=np.int64) * len(z)) // n_seg]
    bounds[0] = 0
    for k in range(1, n_seg):
        if bounds[k] <= bounds[k - 1]:
            bounds[k] = bounds[k - 1] + 1
    bounds = np.minimum(bounds, (1 << 27) - 1)
    for k in range(n_seg - 2, -1, -1):   # re-sort after the top clamp
        if bounds[k] >= bounds[k + 1]:
            bounds[k] = bounds[k + 1] - 1
    bounds[0] = 0
    return tuple(int(b) for b in bounds)


def calibrate_dense_box(x01, resolutions, log2_table_size: int):
    """Per-level occupied-box calibration for the shifted-morton regime: the
    samples' cell bounding box padded by one cell, kept where it passes
    `box_dense_ok`. A tuple of per-level None or (ox, oy, oz, ex, ey, ez)."""
    t = 1 << log2_table_size
    x = np.asarray(x01, np.float64)
    out = []
    for r in resolutions:
        cells = np.clip(np.floor(x * r), 0, r - 1).astype(np.int64)
        o = np.maximum(cells.min(axis=0) - 1, 0)
        top = np.minimum(cells.max(axis=0) + 1, r - 1)
        e = top - o
        box = tuple(int(v) for v in o) + tuple(int(v) for v in e)
        out.append(box if hw.box_dense_ok(e, t) else None)
    return tuple(out)


def level_resolutions(n_levels: int, base_res: int, finest_res: float):
    """Per-level grid resolutions N_l = floor(base * b^l) with
    b = exp2(log2(finest/base) / (L-1))."""
    if n_levels == 1:
        return [base_res]
    b = np.exp2(np.log2(finest_res / base_res) / (n_levels - 1))
    return [int(np.floor(base_res * b ** l)) for l in range(n_levels)]


def _lecun_normal_(weight, generator):
    """flax's default Dense and Conv kernel init (truncated normal, variance
    1/fan_in; fan_in the inputs of one output: [out, in] or [out, in, kh,
    kw]), drawn on the CPU so a seed gives the same weights on every
    device."""
    fan_in = weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    w = torch.empty(weight.shape, dtype=torch.float32)
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std,
                          generator=generator)
    with torch.no_grad():
        weight.copy_(w)


class HashGridEncoding(nn.Module):
    """Multiresolution hash encoding of positions [N, 3] in [0, 1] ->
    [N, L*F] in `compute_dtype`, with the index function `impl` selects (see
    the module docstring). `page_bounds` and `dense_box` calibrate the
    windowed index and are pinned per experiment; the instant-NGP index
    ignores them."""

    def __init__(self, n_levels: int = 16, features: int = 2,
                 log2_table_size: int = 19, base_res: int = 16,
                 finest_res: float = 2048.0,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 impl: str = "auto", page_bounds: tuple | None = None,
                 dense_box: tuple | None = None, device=None):
        super().__init__()
        if impl == "auto":
            if features != 2 or ((1 << log2_table_size) * 2) % 128:
                impl = "xla"
            else:
                impl = he.recommended_impl(log2_table_size, on_tpu=True)
        if impl not in _WIN_IMPLS + _IDX_IMPLS:
            raise ValueError(f"unknown hash_impl {impl!r}")
        device = resolve_device(device)
        if features != 2 and impl != "xla":
            raise ValueError(f"the {impl!r} hash encode supports features=2 "
                             f"(impl='xla' takes any)")
        self.impl = impl
        self.n_levels = n_levels
        self.features = features
        self.log2_table_size = log2_table_size
        self.compute_dtype = compute_dtype
        t = 1 << log2_table_size
        self.resolutions = tuple(level_resolutions(n_levels, base_res,
                                                   finest_res))
        self.page_bounds = page_bounds
        self.dense_box = dense_box
        self.table = nn.Parameter(torch.empty(
            (n_levels, t, features), dtype=torch.float32, device=device))
        if impl in _WIN_IMPLS:
            self._boxes = hw.normalize_dense_box(self.resolutions, t,
                                                 dense_box)
            self.register_buffer("bounds", hw.bounds_tensor(
                t, page_bounds, self.table.device), persistent=False)

    def reset_parameters(self, generator=None):
        w = torch.empty(self.table.shape, dtype=torch.float32)
        w.uniform_(-1e-4, 1e-4, generator=generator)
        with torch.no_grad():
            self.table.copy_(w)

    def corner_indices_weights(self, x):
        """x [N, 3] in [0, 1] -> (idx [L, 8, N] int32, w [L, 8, N] f32) of
        the instant-NGP index: the linear index (cx*(r+1) + cy)*(r+1) + cz
        where the level's (r+1)^3 grid fits the table, else the XOR-prime
        hash cx ^ cy*p1 ^ cz*p2 in uint32 arithmetic, then % T. Corner ci
        takes the +1 cell on x, y, z where bits 2, 1, 0 of ci are set. As in
        the JAX function there is no clamp at the grid's last cell: a point
        at x == 1.0 reaches corner r+1 (with weight 0), and % T wraps it. f32
        operations round in the JAX function's order: xs = r*x,
        frac = xs - floor(xs), w = (wx*wy)*wz.

        The integers are int32: products wrap modulo 2^32 and XOR and the
        mask act on the bits, so the low 32 bits are the uint32 results (the
        linear index of a dense level never wraps: (r+2)^3 < 2^31)."""
        return he.corner_indices_weights_ngp(x, self.resolutions,
                                             1 << self.log2_table_size)

    def forward(self, x):
        shape = x.shape[:-1]
        x = torch.clamp(x.reshape(-1, 3), 0.0, 1.0).contiguous()
        if self.impl in _WIN_IMPLS:
            out = hw.hash_encode_win_fused(self.table, x, self.resolutions,
                                           self.bounds, self._boxes)
        elif self.impl == "mxu":
            out = he.hash_encode_ngp_fused(self.table, x, self.resolutions)
        else:
            out = he.hash_encode_xla(self.table.to(self.compute_dtype),
                                     *self.corner_indices_weights(x))
        return out.to(self.compute_dtype).reshape(
            *shape, self.n_levels * self.features)


class HashGridField(nn.Module):
    """Hash-grid NeRF: encoder + tiny sigma/color MLPs (NeRF_TCNN parity).

    Parameter names follow the JAX module's (`encoder.table`, `sigma_0`,
    `sigma_out`, `color_0`, ..., `color_out`; see `convert.py`)."""

    def __init__(self, *, bound: float = 100.0, n_levels: int = 16,
                 features: int = 2, log2_table_size: int = 19,
                 base_res: int = 16, finest_res_per_unit: float = 2048.0,
                 geo_feat_dim: int = 15, hidden_dim: int = 64,
                 num_layers: int = 2, hidden_dim_color: int = 64,
                 num_layers_color: int = 3, sh_degree: int = 4,
                 semantic: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 impl: str = "auto", page_bounds: tuple | None = None,
                 dense_box: tuple | None = None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.bound = bound
        self.n_levels = n_levels
        self.base_res = base_res
        self.finest_res_per_unit = finest_res_per_unit
        self.log2_table_size = log2_table_size
        self.geo_feat_dim = geo_feat_dim
        self.num_layers = num_layers
        self.num_layers_color = num_layers_color
        self.sh_degree = sh_degree
        self.semantic = semantic
        self.compute_dtype = compute_dtype
        self.encoder = HashGridEncoding(
            n_levels=n_levels, features=features,
            log2_table_size=log2_table_size, base_res=base_res,
            finest_res=finest_res_per_unit * bound,
            compute_dtype=compute_dtype, impl=impl, page_bounds=page_bounds,
            dense_box=dense_box, device=device)
        dims = [n_levels * features] + [hidden_dim] * (num_layers - 1)
        for i in range(num_layers - 1):
            self.add_module(f"sigma_{i}",
                            nn.Linear(dims[i], dims[i + 1], device=device))
        n_out = 1 + (1 if semantic else 0) + geo_feat_dim
        self.sigma_out = nn.Linear(dims[-1], n_out, device=device)
        cdims = ([sh_degree ** 2 + geo_feat_dim]
                 + [hidden_dim_color] * (num_layers_color - 1))
        for i in range(num_layers_color - 1):
            self.add_module(f"color_{i}",
                            nn.Linear(cdims[i], cdims[i + 1], device=device))
        self.color_out = nn.Linear(cdims[-1], 3, device=device)

    @property
    def page_bounds(self):
        return self.encoder.page_bounds

    @property
    def dense_box(self):
        return self.encoder.dense_box

    def _linears(self):
        return [m for m in self.children() if isinstance(m, nn.Linear)]

    def reset_parameters(self, generator=None):
        """flax-default init from `generator` (a CPU torch.Generator): the
        table uniform in [-1e-4, 1e-4], kernels lecun-normal, biases 0."""
        self.encoder.reset_parameters(generator)
        for lin in self._linears():
            _lecun_normal_(lin.weight, generator)
            nn.init.zeros_(lin.bias)

    def _dense(self, name, h):
        lin = getattr(self, name)
        dt = self.compute_dtype
        return nn.functional.linear(h, lin.weight.to(dt), lin.bias.to(dt))

    def forward(self, pts, viewdirs, frozen_sigma=None):
        """pts [..., 3] world coords in [-bound, bound]; viewdirs [B, 3] unit,
        broadcast over the sample axis of pts [B, S, 3]. Returns
        [..., 4(+1)] float32. `frozen_sigma` [..., 1] (the frozen-density
        mode, already detached by the caller) replaces the density column;
        the sigma net still runs, for the geometry features."""
        if viewdirs is None:
            raise ValueError("HashGridField requires view directions")
        dt = self.compute_dtype
        shape = pts.shape[:-1]
        x = (pts + self.bound) / (2.0 * self.bound)
        h = self.encoder(x.reshape(-1, 3)).to(dt)
        vd = viewdirs[..., None, :].expand(*shape, 3).reshape(-1, 3)
        d = sh_encoding(vd, degree=self.sh_degree)

        for i in range(self.num_layers - 1):
            h = torch.relu(self._dense(f"sigma_{i}", h))
        h = self._dense("sigma_out", h)
        sigma = trunc_exp(h[..., 0:1].float())
        ofs = 1
        heads = []
        if self.semantic:
            heads.append(h[..., 1:2].float())
            ofs = 2
        geo = h[..., ofs:]

        c = torch.cat([d.to(dt), geo], dim=-1)
        for i in range(self.num_layers_color - 1):
            c = torch.relu(self._dense(f"color_{i}", c))
        rgb = self._dense("color_out", c).float()
        if frozen_sigma is not None:
            sigma = frozen_sigma.reshape(-1, 1).float()
        raw = torch.cat([rgb, sigma] + heads, dim=-1)
        return raw.reshape(*shape, raw.shape[-1])
