"""Fused NeRF MLP: CUDA kernels for the H100 and their plain PyTorch
version (port of `spinnerf_tpu/ops/fused_mlp.py`: the v2 PE-in-kernel path
`fused_mlp_pe`, and the v1 path `fused_mlp` on encodings computed outside).

The network (NeRFField parity at `use_viewdirs=True`):
  trunk: h_0 = relu(x W_0 + b_0); h_i = relu(h_{i-1} W_i + b_i), with the
         skip concat [x, h_skip] feeding layer skip+1;
  sigma = h_last W_s + b_s  (and the semantic logit when out_extra)
  feat  = h_last W_f + b_f;  v = relu([feat, d] W_v + b_v);  rgb = v W_r + b_r
  raw   = [rgb, sigma, (logit)]
with x, d the positional encodings of the point and its view direction,
zero-padded to 128 lanes (the weights' padding rows are zero).

v2 (`fused_mlp_pe`): inputs are xd [P, 8] = (x, y, z, dx, dy, dz, 0, 0),
encoded in the kernel; the backward returns weight gradients only (sample
positions are not trained). v1 (`fused_mlp`, behind `make_fused_field_fn`):
inputs are the encodings x_enc, d_enc [P, 128]; the backward also returns
their gradients dx, dd, so autograd reaches the points. Weights are a dict
of f32 tensors in the JAX layout: kernels [in, out], biases [1, out], named
by `_weight_order`.

Both launch a kernel family for CUDA tensors (or raise) and run their
plain versions (`fused_mlp_pe_plain` / `fused_mlp_pe_bwd_plain`,
`fused_mlp_fwd_plain` / `fused_mlp_bwd_plain`) for CPU tensors. `route`
picks the family from the geometry and the compute type:
- "wgmma" (`csrc/fused_mlp_pe.cu`): bf16 at depth 8, skip 4, width 256,
  view width 128, 128 / 128 encoding lanes and (v2) 10 / 4 octaves. Its
  kernels read the trunk, feature and view matrices as one ring of
  pre-swizzled bf16 weight stages (`pack_ring`, packed by `gather_ring`):
  the forward its first stages, the backward all of them.
- "gen" (`csrc/fused_mlp_gen.cu`): every other configuration within
  `GEN_LIMITS`, f32 or bf16, on the tensor cores with f32 as six exact
  bf16 products (`split_bf16x3`). Its forward and its backward each take
  one of two kernel sets, picked from the dims alone before launch and
  counted apart: the fused kernels wherever their plan's block buffers fit
  (`gen_fwd_plan`: f32 widths to 256; `gen_bwd_plan`: to 512; counted as
  `launches_gen["fwd_tc"]` / "bwd_tc"), from the weights split into bf16
  stages once a call (`gen_ring`: the backward's whole ring, whose first
  stages are the forward's, or the forward's alone); the layer-streamed
  kernels at every wider geometry (`gen_layer_plan`; "fwd_ls" / "bwd_ls"),
  one product a layer with the activations between layers in device
  memory, from their own stages (`gen_ls_ring`). Both read the heads'
  matrices rounded to the compute type (`gen_heads`).
Beyond the limits a kernel entry raises ValueError; nothing falls back to
the plain version on the card. The autograd functions pack the route's
weights once a call, in the forward, and keep them for the backward; a
forward that records no gradient (`torch.no_grad`, or no input that
requires one) launches without them and packs only what it reads.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from spinnerf_tpu_torch import resolve_device
from spinnerf_tpu_torch.models.embedding import positional_encoding
from spinnerf_tpu_torch.ops import cuda_build

# Kernel launches by the wrappers, counted where they launch and nowhere
# else: the v2 kernels (#9/#10) and the v1 kernels (#7/#8) of the wgmma
# route, and the same functions on the generic route, whose forward and
# backward are "fwd_tc" / "bwd_tc" on the fused tensor-core kernels and
# "fwd_ls" / "bwd_ls" on the layer-streamed ones.
launches = {"fwd": 0, "bwd": 0}
launches_v1 = {"fwd": 0, "bwd": 0}
launches_gen = {"fwd_tc": 0, "fwd_ls": 0, "bwd_tc": 0, "bwd_ls": 0}
launches_gen_v1 = {"fwd_tc": 0, "fwd_ls": 0, "bwd_tc": 0, "bwd_ls": 0}

_HALF_PI = float(np.float32(np.pi / 2.0))   # the TPU kernel's f32 phase
_MAX_DEPTH = 16                            # FM_MAX_DEPTH in the CUDA source
_BM = 64                                   # FM_BM: points per kernel block
# The wgmma kernels' one configuration: (depth, skip, width, view_width,
# in_dim, dir_dim, multires, multires_views) in bf16; v1 reads no octaves.
WGMMA_GEOMETRY = (8, 4, 256, 128, 128, 128, 10, 4)
# The generic family's limits (csrc/fused_mlp_gen.cu: FG_MAX_DEPTH,
# FG_MAX_WIDTH). Within them the forward and the backward each run on the
# fused tensor-core kernels where their plan's buffers fit (`gen_fwd_plan`:
# f32 to width 256 with 128-lane encodings and to 192 with 256-lane ones,
# bf16 to 320 and 256; `gen_bwd_plan`: every width to 512 with 128-lane
# encodings, f32 to 384 and bf16 to 512 with 256-lane ones, bf16 to 640
# with 128), on the layer-streamed ones elsewhere (`gen_layer_plan`).
GEN_LIMITS = {"depth": (1, 32), "width": (8, 2048), "enc_dims": (128, 256)}
_GEN_MAX_JOBS = GEN_LIMITS["depth"][1] + 5       # FG_MAX_JOBS
# The tensor-core kernels' constants (csrc/fused_mlp_gen.cu, FT_*; change
# both together): points a block, a weight stage's side, bytes of one bf16
# stage part, f32 row padding, ring slots, shared memory alignment, the
# block's shared memory, and the most output tiles a warpgroup of the
# forward takes a product.
_FT = {"BM": 64, "T": 64, "PLANE": 8192, "PAD": 8, "MIN_SLOTS": 2,
       "MAX_SLOTS": 8, "ALIGN": 1024, "SMEM_MAX": 232448, "FWD_TILES": 3}
# The layer-streamed kernels' constants (csrc/fused_mlp_gen.cu, LS_*;
# change both together): output columns a block, a stage's depth, bytes of
# a bf16 operand tile part and of a weight stage part, ring slots.
_LS = {"BN": 128, "T": 64, "APLANE": 8192, "BPLANE": 16384, "MIN_SLOTS": 2,
       "MAX_SLOTS": 8}


class MLPDims(NamedTuple):
    in_dim: int          # encoded position width (padded)
    dir_dim: int         # encoded direction width (padded)
    width: int = 256
    depth: int = 8
    skip: int = 4        # skip concat after this trunk layer
    view_width: int = 128
    out_extra: int = 0   # extra heads (semantic logit) off the trunk
    compute_dtype: str = "bfloat16"   # matmul input dtype (f32 accumulate)
    multires: int = 10          # frequency octaves of the in-kernel encoding
    multires_views: int = 4


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _weight_order(dims: MLPDims):
    names = []
    for i in range(dims.depth):
        names += [f"tw{i}", f"tb{i}"]
    names += ["sigma_w", "sigma_b"]
    if dims.out_extra:
        names += ["sem_w", "sem_b"]
    names += ["feat_w", "feat_b", "view_w", "view_b", "rgb_w", "rgb_b"]
    return names


def weight_shapes(dims: MLPDims) -> dict:
    """name -> shape of every weight, in `_weight_order`."""
    w = dims.width
    out = {}
    for i in range(dims.depth):
        k = (dims.in_dim if i == 0 else
             dims.in_dim + w if i == dims.skip + 1 else w)
        out[f"tw{i}"], out[f"tb{i}"] = (k, w), (1, w)
    out["sigma_w"], out["sigma_b"] = (w, 1), (1, 1)
    if dims.out_extra:
        out["sem_w"], out["sem_b"] = (w, 1), (1, 1)
    out["feat_w"], out["feat_b"] = (w, w), (1, w)
    out["view_w"] = (w + dims.dir_dim, dims.view_width)
    out["view_b"] = (1, dims.view_width)
    out["rgb_w"], out["rgb_b"] = (dims.view_width, 3), (1, 3)
    return {n: out[n] for n in _weight_order(dims)}


def dims_for_field(multires: int = 10, multires_views: int = 4,
                   width: int = 256, depth: int = 8, skip: int = 4,
                   semantic: bool = False) -> MLPDims:
    in_dim = _round_up(3 * (1 + 2 * multires), 128)
    dir_dim = _round_up(3 * (1 + 2 * multires_views), 128)
    return MLPDims(in_dim=in_dim, dir_dim=dir_dim, width=width, depth=depth,
                   skip=skip, view_width=width // 2,
                   out_extra=1 if semantic else 0,
                   multires=multires, multires_views=multires_views)


def params_to_fused(flax_params, dims: MLPDims, *, raw_in_dim: int,
                    raw_dir_dim: int) -> dict:
    """A NeRFField's flax tree ({"params": {...}} or the inner dict, leaves
    as numpy arrays) -> the kernels' padded weight dict of f32 tensors.
    Zero rows are inserted where the encodings were lane-padded, so padded
    input columns contribute nothing."""
    p = flax_params.get("params", flax_params)

    def dense(name):
        return (np.asarray(p[name]["kernel"], np.float32),
                np.asarray(p[name]["bias"], np.float32))

    def pad_rows(k, n):
        return np.pad(k, ((0, n - k.shape[0]), (0, 0)))

    out = {}
    for i in range(dims.depth):
        k, b = dense(f"trunk_{i}")
        if i == 0:
            k = pad_rows(k, dims.in_dim)
        if i == dims.skip + 1:
            # input was cat([pe(raw_in), h]); pad the pe rows out to in_dim
            k = np.concatenate([pad_rows(k[:raw_in_dim], dims.in_dim),
                                k[raw_in_dim:]])
        out[f"tw{i}"], out[f"tb{i}"] = k, b
    out["sigma_w"], out["sigma_b"] = dense("sigma_head")
    if dims.out_extra:
        out["sem_w"], out["sem_b"] = dense("semantic_head")
    out["feat_w"], out["feat_b"] = dense("feature")
    k, b = dense("view_0")
    # input was cat([feat(width), viewdir_pe(raw_dir)]); pad the pe rows
    out["view_w"] = np.concatenate(
        [k[:dims.width], pad_rows(k[dims.width:], dims.dir_dim)])
    out["view_b"] = b
    out["rgb_w"], out["rgb_b"] = dense("rgb_head")
    return {n: torch.from_numpy(np.array(
        out[n] if n.endswith("_w") or n.startswith("tw") else out[n][None]))
        for n in _weight_order(dims)}


# -----------------------------------------------------------------------------
# the plain version
# -----------------------------------------------------------------------------

def encode(xd, n_freqs: int, col0: int, out_dim: int):
    """The kernels' positional encoding of xd[:, col0:col0+3] in f32:
    [x, sin(x 2^0), sin(x 2^0 + pi/2), sin(x 2^1), ...], zero-padded to
    out_dim. The cos lanes are sin(x 2^f + pi/2) with the phase added in
    f32, as the TPU kernel computes them (`_pe_constants`), which is not
    torch.cos."""
    x = xd[:, col0:col0 + 3].float()
    cols = [x]
    for f in range(n_freqs):
        xb = x * float(2.0 ** f)
        cols += [torch.sin(xb), torch.sin(xb + _HALF_PI)]
    enc = torch.cat(cols, dim=-1)
    return nn.functional.pad(enc, (0, out_dim - enc.shape[-1]))


def _rounding(dims: MLPDims, acc_dtype):
    """Cast to the compute type and back to the accumulation type: the
    rounding of a kernel operand, evaluated in `acc_dtype`."""
    if dims.compute_dtype == "float32":
        return lambda a: a.to(acc_dtype)
    if dims.compute_dtype != "bfloat16":
        raise ValueError(f"unsupported compute_dtype {dims.compute_dtype!r}")
    return lambda a: a.to(torch.bfloat16).to(acc_dtype)


def _forward_acts(weights, x, d, dims: MLPDims, acc_dtype):
    """The forward through the view layer from the encodings x, d (f32,
    rounded here): (inputs of each trunk layer, trunk pre-activations,
    h_last, hv, view pre-activation, v)."""
    r = _rounding(dims, acc_dtype)

    def dense(a, w, b):
        return a @ r(weights[w]) + weights[b].to(acc_dtype)

    x, d = r(x), r(d)
    acts_in, zs = [], []
    h = x
    for i in range(dims.depth):
        acts_in.append(h)
        z = dense(h, f"tw{i}", f"tb{i}")
        zs.append(z)
        h = r(torch.relu(z))
        if i == dims.skip:
            h = torch.cat([x, h], dim=-1)
    feat = r(dense(h, "feat_w", "feat_b"))
    hv = torch.cat([feat, d], dim=-1)
    vz = dense(hv, "view_w", "view_b")
    return acts_in, zs, h, hv, vz, r(torch.relu(vz))


def _encodings(xd, dims: MLPDims):
    return (encode(xd, dims.multires, 0, dims.in_dim),
            encode(xd, dims.multires_views, 3, dims.dir_dim))


def _heads(weights, h, v, dims: MLPDims, acc_dtype):
    r = _rounding(dims, acc_dtype)

    def head(a, name):
        return a @ r(weights[f"{name}_w"]) + weights[f"{name}_b"].to(acc_dtype)

    out = [head(v, "rgb"), head(h, "sigma")]
    if dims.out_extra:
        out.append(head(h, "sem"))
    return torch.cat(out, dim=-1).float()


def fused_mlp_pe_plain(weights, xd, dims: MLPDims, acc_dtype=torch.float32):
    """What the forward kernel computes (`_fwd_pe_kernel`/`_forward_block`):
    operands rounded to the compute type, products accumulated in
    `acc_dtype` (float32; float64 for a reference that keeps the same
    roundings), biases added before the ReLU and the cast. [P, 4+e] f32."""
    _, _, h, _, _, v = _forward_acts(weights, *_encodings(xd, dims), dims,
                                     acc_dtype)
    return _heads(weights, h, v, dims, acc_dtype)


def fused_mlp_fwd_plain(weights, x_enc, d_enc, dims: MLPDims,
                        acc_dtype=torch.float32):
    """What the v1 forward kernel computes (`_fwd_kernel`): the forward of
    `fused_mlp_pe_plain` on the given encodings x_enc [P, in_dim] and d_enc
    [P, dir_dim] (f32, rounded to the compute type). [P, 4+e] f32."""
    _, _, h, _, _, v = _forward_acts(weights, x_enc, d_enc, dims, acc_dtype)
    return _heads(weights, h, v, dims, acc_dtype)


def _relu_masks(zs, vz, masks):
    """The ReLU masks a backward takes: `masks` (trunk layers' [P, width]
    and the view layer's [P, view_width] bool, e.g. another evaluation's)
    or the evaluation's own, z > 0."""
    return masks if masks is not None else ([z > 0 for z in zs], vz > 0)


def fused_mlp_pe_bwd_plain(weights, xd, g, dims: MLPDims,
                           acc_dtype=torch.float32, masks=None) -> dict:
    """What the backward kernel computes (`_bwd_pe_kernel`): the forward
    recomputed with its roundings, then weight gradients only, for the
    cotangent g [P, 4+e], in `_weight_order` (shapes of the weights).
    `masks`: the ReLU masks to take (`_relu_masks`), by default its own.

    Bias gradients are sums in `acc_dtype` over all P points; the JAX kernel
    rounds each block's sum of a bf16 gradient to bf16 (`fused_mlp.py:515`)
    before adding it, which this version does not copy."""
    r = _rounding(dims, acc_dtype)
    acts_in, zs, h_last, hv, vz, v = _forward_acts(
        weights, *_encodings(xd, dims), dims, acc_dtype)
    trunk_masks, view_mask = _relu_masks(zs, vz, masks)
    g = g.to(acc_dtype)
    w = dims.width
    g_rgb, g_sigma = g[:, :3], g[:, 3:4]

    def mm_tn(a, b):
        return a.t() @ r(b)

    def mm_nt(gout, wt):
        return r(gout) @ r(wt).t()

    def colsum(a):
        return a.sum(dim=0, keepdim=True)

    d = {"rgb_w": mm_tn(v, g_rgb), "rgb_b": colsum(g_rgb)}
    g_v = r(mm_nt(g_rgb, weights["rgb_w"]) * view_mask)
    d["view_w"], d["view_b"] = mm_tn(hv, g_v), colsum(g_v)
    g_feat = r(mm_nt(g_v, weights["view_w"][:w]))
    d["feat_w"], d["feat_b"] = mm_tn(h_last, g_feat), colsum(g_feat)
    g_h = mm_nt(g_feat, weights["feat_w"])
    d["sigma_w"], d["sigma_b"] = mm_tn(h_last, g_sigma), colsum(g_sigma)
    g_h = g_h + mm_nt(g_sigma, weights["sigma_w"])
    if dims.out_extra:
        g_sem = g[:, 4:5]
        d["sem_w"], d["sem_b"] = mm_tn(h_last, g_sem), colsum(g_sem)
        g_h = g_h + mm_nt(g_sem, weights["sem_w"])
    for i in range(dims.depth - 1, -1, -1):
        if i == dims.skip:
            g_h = g_h[:, dims.in_dim:]      # the encoding's gradient is dead
        g_z = r(g_h * trunk_masks[i])
        d[f"tw{i}"], d[f"tb{i}"] = mm_tn(acts_in[i], g_z), colsum(g_z)
        if i > 0:
            g_h = mm_nt(g_z, weights[f"tw{i}"])
    return {n: d[n] for n in _weight_order(dims)}


def fused_mlp_bwd_plain(weights, x_enc, d_enc, g, dims: MLPDims,
                        acc_dtype=torch.float32, masks=None):
    """What the v1 backward kernel computes (`_bwd_kernel`): the forward
    recomputed on the encodings, then every weight gradient and the input
    gradients dx [P, in_dim] (layer 0's input gradient plus the skip layer's
    encoding slice) and dd [P, dir_dim] (the view layer's direction slice),
    for the cotangent g [P, 4+e]. Returns (weight gradients in
    `_weight_order`, dx, dd). `masks`: as in `fused_mlp_pe_bwd_plain`.

    The rounding points are v1's, not v2's (`fused_mlp_pe_bwd_plain`): v1
    keeps the gradients g_v, g_feat and g_z in f32 and rounds them only as
    operands of a product, so its bias gradients are sums of the f32
    gradients (JAX `fused_mlp.py:172,177,184,208`), where v2 sums the
    bf16-rounded ones."""
    r = _rounding(dims, acc_dtype)
    acts_in, zs, h_last, hv, vz, v = _forward_acts(weights, x_enc, d_enc,
                                                   dims, acc_dtype)
    trunk_masks, view_mask = _relu_masks(zs, vz, masks)
    g = g.to(acc_dtype)
    w = dims.width
    g_rgb, g_sigma = g[:, :3], g[:, 3:4]

    def mm_tn(a, b):
        return a.t() @ r(b)

    def mm_nt(gout, wt):
        return r(gout) @ r(wt).t()

    def colsum(a):
        return a.sum(dim=0, keepdim=True)

    d = {"rgb_w": mm_tn(v, g_rgb), "rgb_b": colsum(g_rgb)}
    g_v = mm_nt(g_rgb, weights["rgb_w"]) * view_mask
    d["view_w"], d["view_b"] = mm_tn(hv, g_v), colsum(g_v)
    g_hv = mm_nt(g_v, weights["view_w"])
    g_feat, dd = g_hv[:, :w], g_hv[:, w:]
    d["feat_w"], d["feat_b"] = mm_tn(h_last, g_feat), colsum(g_feat)
    g_h = mm_nt(g_feat, weights["feat_w"])
    d["sigma_w"], d["sigma_b"] = mm_tn(h_last, g_sigma), colsum(g_sigma)
    g_h = g_h + mm_nt(g_sigma, weights["sigma_w"])
    if dims.out_extra:
        g_sem = g[:, 4:5]
        d["sem_w"], d["sem_b"] = mm_tn(h_last, g_sem), colsum(g_sem)
        g_h = g_h + mm_nt(g_sem, weights["sem_w"])
    dx = torch.zeros_like(x_enc, dtype=acc_dtype)
    for i in range(dims.depth - 1, -1, -1):
        if i == dims.skip:
            # the skip layer's input was [x, h_skip]
            dx = dx + g_h[:, :dims.in_dim]
            g_h = g_h[:, dims.in_dim:]
        g_z = g_h * trunk_masks[i]
        d[f"tw{i}"], d[f"tb{i}"] = mm_tn(acts_in[i], g_z), colsum(g_z)
        g_h = mm_nt(g_z, weights[f"tw{i}"])
    dx = dx + g_h
    return {n: d[n] for n in _weight_order(dims)}, dx, dd


# -----------------------------------------------------------------------------
# the CUDA kernels
# -----------------------------------------------------------------------------

_VP = ctypes.c_void_p


class _FmParams(ctypes.Structure):
    """`FmParams` of the CUDA source, field for field."""
    _fields_ = [("tb", _VP * _MAX_DEPTH), ("feat_b", _VP), ("view_b", _VP),
                ("rgb_w", _VP), ("rgb_b", _VP), ("sigma_w", _VP),
                ("sigma_b", _VP), ("sem_w", _VP), ("sem_b", _VP),
                ("depth", ctypes.c_int), ("skip", ctypes.c_int),
                ("out_extra", ctypes.c_int), ("multires", ctypes.c_int),
                ("multires_views", ctypes.c_int),
                ("ring", _VP), ("ring_bytes", ctypes.c_longlong)]


class _FmGrads(ctypes.Structure):
    """`FmGrads` of the CUDA source, field for field."""
    _fields_ = [("tw", _VP * _MAX_DEPTH), ("tb", _VP * _MAX_DEPTH)] + [
        (n, _VP) for n in ("feat_w", "feat_b", "view_w", "view_b", "rgb_w",
                           "sigma_w", "sem_w", "head_b", "bias64", "dx",
                           "dd", "dwpart", "hpart", "hpart64", "bpart64")]


def _lib():
    lib = cuda_build.load("fused_mlp_pe")
    if not getattr(lib, "_fm_typed", False):
        prm, grd = ctypes.POINTER(_FmParams), ctypes.POINTER(_FmGrads)
        lib.fm_fwd.argtypes = [prm, _VP, _VP, ctypes.c_int, _VP]
        lib.fm_fwd_pre.argtypes = [prm, _VP, _VP, _VP, ctypes.c_int, _VP]
        lib.fm_bwd.argtypes = [prm, grd, _VP, _VP, _VP, _VP, ctypes.c_int,
                               _VP]
        lib.fm_bwd_pre.argtypes = [prm, grd, _VP, _VP, _VP, _VP, _VP,
                                   ctypes.c_int, _VP]
        lib.fm_bwd_pass.argtypes = [prm, grd, _VP, _VP, _VP, _VP, _VP,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    _VP]
        lib.fm_scratch_cols.argtypes = [ctypes.c_int, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_int),
                                        ctypes.POINTER(ctypes.c_int)]
        lib.fm_partial_sizes.argtypes = [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_longlong)]
        for fn in (lib.fm_fwd, lib.fm_fwd_pre, lib.fm_bwd,
                   lib.fm_bwd_pre, lib.fm_bwd_pass, lib.fm_scratch_cols,
                   lib.fm_partial_sizes):
            fn.restype = ctypes.c_int
        lib.fm_error_string.argtypes = [ctypes.c_int]
        lib.fm_error_string.restype = ctypes.c_char_p
        lib._fm_typed = True
    return lib


def route(dims: MLPDims, pre: bool = False) -> str:
    """The kernel family of `dims` on the card: "wgmma" (bf16 at
    `WGMMA_GEOMETRY`; v1, `pre`, at any octave count) or "gen" (every other
    configuration within `GEN_LIMITS`). Raises ValueError naming the limit
    a configuration breaks."""
    if dims.compute_dtype not in ("bfloat16", "float32"):
        raise ValueError(f"unsupported compute_dtype {dims.compute_dtype!r}")
    if dims.out_extra not in (0, 1):
        raise ValueError(f"the fused MLP kernels take out_extra 0 or 1, got "
                         f"{dims.out_extra}")
    geom = (dims.depth, dims.skip, dims.width, dims.view_width, dims.in_dim,
            dims.dir_dim) + (() if pre else (dims.multires,
                                            dims.multires_views))
    if (dims.compute_dtype == "bfloat16"
            and geom == WGMMA_GEOMETRY[:len(geom)]):
        return "wgmma"
    lo, hi = GEN_LIMITS["depth"]
    if not lo <= dims.depth <= hi:
        raise ValueError(f"the fused MLP kernels take depth {lo}-{hi}, got "
                         f"{dims.depth}")
    if dims.skip < 0 or dims.depth == dims.skip + 1:
        raise ValueError(f"the fused MLP kernels take skip >= 0 and depth "
                         f"!= skip + 1 (the concat would feed the heads), "
                         f"got depth {dims.depth}, skip {dims.skip}")
    lo, hi = GEN_LIMITS["width"]
    if not lo <= dims.width <= hi:
        raise ValueError(f"the fused MLP kernels take width {lo}-{hi}, got "
                         f"{dims.width}")
    if not 1 <= dims.view_width <= dims.width:
        raise ValueError(f"the fused MLP kernels take a view width of 1 to "
                         f"the width, got {dims.view_width}")
    enc = GEN_LIMITS["enc_dims"]
    if dims.in_dim not in enc or dims.dir_dim not in enc:
        raise ValueError(f"the fused MLP kernels take encoding widths "
                         f"(in_dim, dir_dim) of {enc}, got {dims.in_dim}, "
                         f"{dims.dir_dim}")
    if not pre and not (0 <= dims.multires
                        and 3 * (1 + 2 * dims.multires) <= dims.in_dim
                        and 0 <= dims.multires_views
                        and 3 * (1 + 2 * dims.multires_views)
                        <= dims.dir_dim):
        raise ValueError(f"{dims.multires} / {dims.multires_views} octaves "
                         f"do not fit encoding widths {dims.in_dim} / "
                         f"{dims.dir_dim}")
    return "gen"


def _check_kernel_args(weights, inputs, dims: MLPDims, pre: bool) -> str:
    """The route of `dims` (`route`); raise unless the kernels take the
    inputs: xd [P, 8] (v2) or, with `pre`, the encodings (x_enc [P, in_dim],
    d_enc [P, dir_dim]) (v1), each a contiguous float32 CUDA tensor with P a
    multiple of 64."""
    rt = route(dims, pre)
    p = inputs[0].shape[0]
    width = (dims.in_dim, dims.dir_dim) if pre else (8,)
    for a, k in zip(inputs, width):
        # the v1 wgmma kernels read the encodings as float4
        if (not a.is_cuda or a.dtype != torch.float32 or a.shape != (p, k)
                or not a.is_contiguous() or p % _BM
                or a.data_ptr() % 16):
            raise ValueError(f"inputs must be contiguous, 16-byte aligned "
                             f"float32 CUDA [P, {k}] with P a multiple of "
                             f"{_BM}, got {a.dtype} {tuple(a.shape)} on "
                             f"{a.device}")
    dev = inputs[0].device
    for n, shape in weight_shapes(dims).items():
        w = weights[n]
        if (w.device != dev or w.dtype != torch.float32
                or tuple(w.shape) != shape or not w.is_contiguous()
                or w.data_ptr() % 16):
            raise ValueError(f"weight {n} must be a contiguous, 16-byte "
                             f"aligned float32 {shape} on {dev}, got "
                             f"{w.dtype} {tuple(w.shape)} on {w.device}")
    return rt


def _counts(rt: str, pre: bool) -> dict:
    """The launch counter of a route's forward and backward (v1: `pre`)."""
    return {("wgmma", False): launches, ("wgmma", True): launches_v1,
            ("gen", False): launches_gen,
            ("gen", True): launches_gen_v1}[(rt, pre)]


def pack_weights(weights, dims: MLPDims):
    """The heads' bf16 copies the kernels read, in one buffer (the other
    matrices come as `pack_ring`'s stages). Returns (buffer, {name: element
    offset}); every offset is a multiple of 8 (16 bytes)."""
    heads = ["rgb_w", "sigma_w"] + (["sem_w"] if dims.out_extra else [])
    offsets, total = {}, 0
    for n in heads:
        offsets[n] = total
        total += _round_up(weights[n].numel(), 8)
    buf = torch.empty(total, dtype=torch.bfloat16,
                      device=weights["rgb_w"].device)
    for n, off in offsets.items():
        buf[off:off + weights[n].numel()].view(weights[n].shape).copy_(
            weights[n])
    return buf, offsets


def ring_matrices(weights, dims: MLPDims, pre: bool):
    """B^T ([N, K], K contiguous) of every product of the backward kernel
    with a weight operand, in the order it takes them (`ring_schedule` in
    the CUDA source): the recompute's trunk, feature and view layers (the
    first depth + 2, which the forward kernel takes, the same with and
    without `pre`); then g_feat (view_w[:width]), with `pre` dd (the
    direction rows of view_w), the last trunk layer's g_h (feat_w), the
    trunk from the top down (the skip layer's h rows, after, with `pre`,
    its encoding rows), and with `pre` layer 0's input gradient (tw0)."""
    w, e = dims.width, dims.in_dim
    cat = dims.skip + 1 if dims.skip + 1 < dims.depth else -1
    mats = [weights[f"tw{i}"].t() for i in range(dims.depth)]
    mats += [weights["feat_w"].t(), weights["view_w"].t(),
             weights["view_w"][:w]]
    if pre:
        mats.append(weights["view_w"][w:])
    mats.append(weights["feat_w"])
    for i in range(dims.depth - 1, 0, -1):
        tw = weights[f"tw{i}"]
        if i == cat:
            if pre:
                mats.append(tw[:e])
            tw = tw[e:]
        mats.append(tw)
    if pre:
        mats.append(weights["tw0"])
    return mats


def swizzle_stages(bt):
    """B^T [N, K] (K a multiple of 64) -> its K / 64 stages [N, 64], one
    after another, each row's chunk of 8 (16 bytes in bf16) c at chunk
    c ^ (row % 8): the 128-byte swizzle in which wgmma reads a K-major
    operand from shared memory, so that one bulk copy lands a stage as the
    kernel reads it."""
    n, k = bt.shape
    t = bt.reshape(n, k // 64, 8, 8).transpose(0, 1)
    rows = torch.arange(n, device=bt.device)
    src = torch.arange(8, device=bt.device)[None, :] ^ (rows % 8)[:, None]
    return t.gather(2, src[None, :, :, None].expand(t.shape)).reshape(-1)


def pack_ring(weights, dims: MLPDims, pre: bool):
    """The kernels' weight stages, in one bf16 buffer in the order the
    backward takes them (`ring_matrices`, each through `swizzle_stages`);
    the forward reads the first `forward_ring_elems`."""
    return torch.cat([swizzle_stages(m.to(torch.bfloat16))
                      for m in ring_matrices(weights, dims, pre)])


_ring_index_cache: dict = {}


def forward_ring_elems(dims: MLPDims) -> int:
    """Elements of the ring's first depth + 2 matrices, the stages the
    forward kernel takes: the trunk, feature and view layers."""
    return sum(math.prod(s) for n, s in weight_shapes(dims).items()
               if n.startswith("tw") or n in ("feat_w", "view_w"))


def ring_index(dims: MLPDims, pre: bool, device):
    """`pack_ring` as a gather: the index, into the weights flattened and
    concatenated in `_weight_order`, of every element of the ring (int32 on
    `device`, built once per geometry), so that the ring is packed in three
    launches instead of some eighty."""
    key = (dims, pre, str(device))
    if key not in _ring_index_cache:
        ids, off = {}, 0
        for n, shape in weight_shapes(dims).items():
            ids[n] = torch.arange(off, off + math.prod(shape),
                                  dtype=torch.int32).view(shape)
            off += math.prod(shape)
        _ring_index_cache[key] = torch.cat(
            [swizzle_stages(m) for m in ring_matrices(ids, dims, pre)]
        ).to(device)
    return _ring_index_cache[key]


def gather_ring(weights, dims: MLPDims, pre: bool, forward: bool = False):
    """`pack_ring` (v1's with `pre`) with one gather (`ring_index`); with
    `forward` only the forward kernel's stages."""
    flat = torch.cat([weights[n].reshape(-1) for n in _weight_order(dims)])
    idx = ring_index(dims, pre, flat.device)
    if forward:
        idx = idx[:forward_ring_elems(dims)]
    return flat.to(torch.bfloat16)[idx]


def _params(weights, dims: MLPDims, ring):
    """(FmParams, the bf16 buffers it points into): the biases, the heads
    (`pack_weights`) and the weight stages `ring` (`gather_ring`)."""
    buf, offs = pack_weights(weights, dims)
    prm = _FmParams()
    for i in range(dims.depth):
        prm.tb[i] = weights[f"tb{i}"].data_ptr()
    prm.rgb_w = buf.data_ptr() + 2 * offs["rgb_w"]
    prm.sigma_w = buf.data_ptr() + 2 * offs["sigma_w"]
    for n in ("feat_b", "view_b", "rgb_b", "sigma_b"):
        setattr(prm, n, weights[n].data_ptr())
    if dims.out_extra:
        prm.sem_w = buf.data_ptr() + 2 * offs["sem_w"]
        prm.sem_b = weights["sem_b"].data_ptr()
    prm.depth, prm.skip, prm.out_extra = dims.depth, dims.skip, dims.out_extra
    prm.multires, prm.multires_views = dims.multires, dims.multires_views
    prm.ring, prm.ring_bytes = ring.data_ptr(), 2 * ring.numel()
    return prm, (buf, ring)


def _raise_on(lib, fn_name: str, err: int):
    """Raise if a C entry returned an error; `fn_name`'s prefix (fm_, fg_)
    names the library's error-string function."""
    if err:
        text = getattr(lib, fn_name.split("_")[0] + "_error_string")(err)
        raise RuntimeError(f"{fn_name} launch failed: {text.decode()}")


# -----------------------------------------------------------------------------
# the generic kernels (csrc/fused_mlp_gen.cu)
# -----------------------------------------------------------------------------

class _FgParams(ctypes.Structure):
    """`FgParams` of csrc/fused_mlp_gen.cu, field for field."""
    _fields_ = (
        [("tb", _VP * GEN_LIMITS["depth"][1])]
        + [(n, _VP) for n in ("feat_b", "view_b", "rgb_w", "rgb_b", "sigma_w",
                              "sigma_b", "sem_w", "sem_b")]
        + [(n, ctypes.c_longlong * _GEN_MAX_JOBS) for n in ("gw", "gb")]
        + [("n_params", ctypes.c_longlong)]
        + [(n, ctypes.c_int) for n in ("depth", "skip", "width",
                                       "view_width", "in_dim", "dir_dim",
                                       "out_extra", "multires",
                                       "multires_views", "bf16")])


def _gen_lib():
    lib = cuda_build.load("fused_mlp_gen")
    if not getattr(lib, "_fg_typed", False):
        _gen_signatures(lib)
        lib._fg_typed = True
    return lib


def _gen_signatures(lib):
    """Declare the C entries' argument and result types on `lib` (the
    CUDA source's `extern "C"` signatures, in order)."""
    prm, i32 = ctypes.POINTER(_FgParams), ctypes.c_int
    i64, ll_p = ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong)
    lib.fg_tc_sizes.argtypes = [prm, i32, i32, ll_p]
    lib.fg_tc_plan.argtypes = [prm, i32, ll_p]
    lib.fg_tc_fwd_plan.argtypes = [prm, i32, ll_p]
    lib.fg_fwd_tc.argtypes = [prm, _VP, _VP, _VP, i64, i32, _VP]
    lib.fg_fwd_tc_pre.argtypes = [prm, _VP, _VP, _VP, _VP, i64, i32, _VP]
    lib.fg_bwd_tc.argtypes = [prm] + [_VP] * 7 + [i64, i32, _VP]
    lib.fg_bwd_tc_pre.argtypes = [prm] + [_VP] * 10 + [i64, i32, _VP]
    lib.fg_bwd_tc_pass.argtypes = [prm] + [_VP] * 10 + [i64] + [i32] * 3 + [
        _VP]
    lib.fg_ls_plan.argtypes = [prm, i32, i32, ll_p]
    lib.fg_ls_sizes.argtypes = [prm, i32, i32, i32, ll_p]
    lib.fg_fwd_ls.argtypes = [prm, _VP, _VP, _VP, _VP, i64, _VP, i64,
                              i32, i32, _VP]
    lib.fg_bwd_ls.argtypes = [prm] + [_VP] * 10 + [i64, _VP, i64] + [
        i32] * 3 + [_VP]
    for fn in (lib.fg_tc_sizes, lib.fg_tc_plan, lib.fg_bwd_tc,
               lib.fg_bwd_tc_pre, lib.fg_bwd_tc_pass, lib.fg_tc_fwd_plan,
               lib.fg_fwd_tc, lib.fg_fwd_tc_pre, lib.fg_ls_plan,
               lib.fg_ls_sizes, lib.fg_fwd_ls, lib.fg_bwd_ls):
        fn.restype = i32
    lib.fg_error_string.argtypes = [i32]
    lib.fg_error_string.restype = ctypes.c_char_p


def _gen_heads_offsets(dims: MLPDims):
    """({name: element offset}, elements) of `gen_heads`' buffer."""
    shapes = weight_shapes(dims)
    offs, off = {}, 0
    for n in ["rgb_w", "sigma_w"] + (["sem_w"] if dims.out_extra else []):
        offs[n], off = off, off + math.prod(shapes[n])
    return offs, off


def gen_heads(weights, dims: MLPDims):
    """What the generic kernels read of the heads' matrices, in one f32
    buffer (`_gen_heads_offsets`): rgb_w [view_width, 3], sigma_w and with
    the semantic head sem_w [width, 1], rounded to the compute type as the
    plain version rounds them. The other matrices come as bf16 stages
    (`gen_ring`, `gen_ls_ring`); the biases are read as they are."""
    offs, _ = _gen_heads_offsets(dims)
    flat = torch.cat([weights[n].reshape(-1) for n in offs]).float()
    return _rounding(dims, torch.float32)(flat)


def _flat_offsets(dims: MLPDims):
    """({name: element offset}, elements) of the weights flattened one
    after another in `_weight_order`: the generic backward's gradient
    buffer."""
    offs, off = {}, 0
    for n, shape in weight_shapes(dims).items():
        offs[n], off = off, off + math.prod(shape)
    return offs, off


def gen_params(weights, dims: MLPDims, heads) -> _FgParams:
    """FgParams: the biases, the heads' matrices in `heads` (`gen_heads`'
    buffer) and the gradients' offsets in the flat buffer
    (`_flat_offsets`), by job: the trunk, the feature, view, rgb, sigma and
    semantic layers."""
    offs, n_heads = _gen_heads_offsets(dims)
    if heads.dtype != torch.float32 or heads.numel() != n_heads:
        raise ValueError(f"the generic kernels' heads must be gen_heads' "
                         f"f32 buffer of {n_heads} elements, got "
                         f"{heads.dtype} {heads.numel()}")
    prm = _FgParams()
    for i in range(dims.depth):
        prm.tb[i] = weights[f"tb{i}"].data_ptr()
    for n, off in offs.items():
        setattr(prm, n, heads.data_ptr() + 4 * off)
    heads_ = ["sigma"] + (["sem"] if dims.out_extra else [])
    for n in ["feat", "view", "rgb"] + heads_:
        setattr(prm, f"{n}_b", weights[f"{n}_b"].data_ptr())
    goff, prm.n_params = _flat_offsets(dims)
    jobs = [f"tw{i}" for i in range(dims.depth)] + [
        f"{n}_w" for n in ["feat", "view", "rgb"] + heads_]
    for j, n in enumerate(jobs):
        prm.gw[j] = goff[n]
        prm.gb[j] = goff[n.replace("tw", "tb").replace("_w", "_b")]
    prm.depth, prm.skip, prm.width = dims.depth, dims.skip, dims.width
    prm.view_width, prm.in_dim, prm.dir_dim = (dims.view_width, dims.in_dim,
                                               dims.dir_dim)
    prm.out_extra, prm.multires = dims.out_extra, dims.multires
    prm.multires_views = dims.multires_views
    prm.bf16 = int(dims.compute_dtype == "bfloat16")
    return prm


class _GenBwdCall(NamedTuple):
    """The arguments of one generic backward and the buffers they point
    into (`_gen_tc_args`, `_gen_ls_args`)."""
    lib: ctypes.CDLL
    prm: _FgParams
    ptrs: tuple             # in_x, in_d, g, grads, dx, dd, scratch, ...
    n_points: int
    flat: torch.Tensor      # the gradients in `_weight_order`
    dx: torch.Tensor | None
    dd: torch.Tensor | None
    scratch_bytes: int
    keep: tuple             # heads, g, scratch, ...: what ptrs point into


def gen_scratch_columns(dims: MLPDims) -> dict:
    """The generic backward's scratch columns, as `fg_layout` in
    csrc/fused_mlp_gen.cu lays them out (change both together; both
    backwards keep each 64 points' columns together, [P / 64][cols][64]):
    each trunk layer's output "h" (its ReLU mask kept as the sign of a
    zero), the encodings "xe" / "de" (xe right before the skip layer's h,
    so that the skip layer's input is contiguous), "feat", the view output
    "v", the gradients, the cotangent, and "cols" in all."""
    sk = dims.skip + 1 < dims.depth
    c, out = 0, {"h": []}
    for i in range(dims.depth):
        if sk and i == dims.skip:
            out["xe"], c = c, c + dims.in_dim
        out["h"].append(c)
        c += dims.width
    if not sk:
        out["xe"], c = c, c + dims.in_dim
    for name, n in (("feat", dims.width), ("de", dims.dir_dim),
                    ("v", dims.view_width)):
        out[name], c = c, c + n
    out["gz"] = [c + i * dims.width for i in range(dims.depth)]
    c += dims.depth * dims.width
    for name, n in (("gfeat", dims.width), ("gv", dims.view_width),
                    ("gin", 4 + dims.out_extra)):
        out[name], c = c, c + n
    out["cols"] = c
    return out


def gen_relu_masks(weights, inputs, dims: MLPDims, *, pre: bool):
    """The ReLU masks that the generic backward's recompute takes at every
    point (its pass 1 alone, on the kernels `gen_bwd_plan` /
    `gen_layer_plan` pick, read back from the scratch: a unit is on where
    the stored output is not +0): ([P, width] bool per trunk layer,
    [P, view_width] bool), for holding the kernel's gradients against an
    evaluation with the same masks (`fused_mlp_pe_bwd_plain(masks=)`).
    The points run in pieces that fit one chunk of the scratch."""
    cols = gen_scratch_columns(dims)
    p = inputs[0].shape[0]
    piece = max(_BM, (4 << 30) // (4 * cols["cols"]) // _BM * _BM)
    trunk, view = [[] for _ in range(dims.depth)], []
    tc = gen_bwd_plan(dims, pre) is not None
    pack = GenPack(gen_heads(weights, dims),
                   gen_ring(weights, dims, pre) if tc else None,
                   None if tc else gen_ls_ring(weights, dims, pre))
    for p0 in range(0, p, piece):
        part = tuple(a[p0:p0 + piece] for a in inputs)
        g = torch.zeros((part[0].shape[0], 4 + dims.out_extra),
                        device=part[0].device)
        stream = torch.cuda.current_stream(part[0].device).cuda_stream
        if tc:
            c = _gen_tc_args(weights, part, g, dims, pre=pre, pack=pack)
            _raise_on(c.lib, "fg_bwd_tc_pass", c.lib.fg_bwd_tc_pass(
                ctypes.byref(c.prm), *c.ptrs, c.n_points, int(pre), 1,
                stream))
        else:
            c = _gen_ls_args(weights, part, g, dims, pre=pre, pack=pack)
            _raise_on(c.lib, "fg_bwd_ls", c.lib.fg_bwd_ls(
                ctypes.byref(c.prm), *c.ptrs, c.n_points, int(pre), 1,
                stream))
        n = part[0].shape[0]
        scr = c.keep[2][:cols["cols"] * n].view(torch.int32).view(
            n // _BM, cols["cols"], _BM)     # block-major: [P / 64][cols][64]

        def on(c0, k):
            return (scr[:, c0:c0 + k] != 0).transpose(1, 2).reshape(n, k)

        for i, c0 in enumerate(cols["h"]):
            trunk[i].append(on(c0, dims.width))
        view.append(on(cols["v"], dims.view_width))
    return [torch.cat(t) for t in trunk], torch.cat(view)


def _gen_grads(c: _GenBwdCall, dims: MLPDims):
    """(f32 weight gradients in `_weight_order`, dx, dd) of a launched
    backward `c`."""
    offs, _ = _flat_offsets(dims)
    grads = {n: c.flat[offs[n]:offs[n] + math.prod(s)].view(s)
             for n, s in weight_shapes(dims).items()}
    return grads, c.dx, c.dd


# -----------------------------------------------------------------------------
# the generic backward on the tensor cores (csrc/fused_mlp_gen.cu, ft_*)
# -----------------------------------------------------------------------------

def split_bf16x3(x):
    """An f32 tensor as three bf16 parts (hi, mid, lo), largest first:
    hi = rn(x), mid = rn(x - hi), lo = rn(x - hi - mid). Each subtraction
    is exact in f32 and each part keeps 8 significant bits, so hi + mid +
    lo == x bit for bit wherever |x| >= 2^-100 (and for 0); the kernels
    split their operands so (`split2` in the CUDA source)."""
    x = x.to(torch.float32)
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def _ft_products(dims: MLPDims, pre: bool, wp: int, vwp: int):
    """The tensor-core backward's pass-1 products in the kernel's order
    (`ft_product`): (kind, layer, K chunks, chunks from the encoding
    buffer, whether those come first, output columns padded)."""
    t, d = _FT["T"], dims.depth
    e, sk = dims.in_dim // t, dims.skip + 1 < dims.depth
    out = []
    for i in range(d):
        cat = sk and i == dims.skip + 1
        out.append(("trunk", i, e if i == 0 else e + wp // t if cat
                    else wp // t, e if i == 0 or cat else 0, True, wp))
    out += [("feat", 0, wp // t, 0, True, wp),
            ("view", 0, wp // t + dims.dir_dim // t, dims.dir_dim // t,
             False, vwp),
            ("gfeat", 0, vwp // t, 0, True, wp + (dims.dir_dim if pre else 0)),
            ("gtop", 0, wp // t, 0, True, wp)]
    for i in range(d - 1, -1 if pre else 0, -1):
        cat = sk and i == dims.skip + 1
        n = (wp if not pre else dims.in_dim if i == 0
             else dims.in_dim + wp if cat else wp)
        out.append(("gtrunk", i, wp // t, 0, True, n))
    return out


def _ft_plan(dims: MLPDims, pre: bool, forward: bool):
    """`gen_bwd_plan`, or with `forward` `gen_fwd_plan`: `ft_geom` /
    `ft_fwd_geom` of the CUDA source."""
    if route(dims, pre) != "gen":
        return None
    t = _FT["T"]
    if dims.in_dim % t or dims.dir_dim % t:
        return None
    parts = 1 if dims.compute_dtype == "bfloat16" else 3
    wp, vwp = _round_up(dims.width, t), _round_up(dims.view_width, t)
    if forward and wp > 2 * _FT["FWD_TILES"] * t:
        return None
    emax = max(dims.in_dim, dims.dir_dim)
    # besides the ring: the activation buffers (the forward's input and
    # output, the backward's one), the encoding's, the backward's cotangent
    fixed = ((2 if forward else 1) * _FT["BM"] * 4 * (wp + _FT["PAD"])
             + _FT["BM"] * 4 * (emax + _FT["PAD"])
             + (0 if forward else _FT["BM"] * 8 * 4) + _FT["ALIGN"])

    def smem(s):
        return s * parts * _FT["PLANE"] + 16 * s + fixed

    fits = [s for s in range(_FT["MAX_SLOTS"], _FT["MIN_SLOTS"] - 1, -1)
            if smem(s) <= _FT["SMEM_MAX"]]
    if not fits:
        return None
    prods = _ft_products(dims, pre, wp, vwp)
    if forward:
        prods = prods[:dims.depth + 2]
    stages = sum(n // t * nk for _, _, nk, _, _, n in prods)
    return {"parts": parts, "wp": wp, "vwp": vwp, "slots": fits[0],
            "smem": smem(fits[0]), "stages": stages,
            "ring_bytes": stages * parts * _FT["PLANE"], "products": prods}


def gen_bwd_plan(dims: MLPDims, pre: bool = False):
    """The fused tensor-core backward's plan for `dims` (`ft_geom` in the
    CUDA source, from the geometry alone), or None where it does not take
    it (the layer-streamed backward does, `gen_layer_plan`): operand parts
    (3 at f32, 1 at bf16), width and view width padded to 64 with zeros,
    weight stages in the ring and its bytes, ring slots and shared memory,
    and the products."""
    return _ft_plan(dims, pre, forward=False)


def gen_fwd_plan(dims: MLPDims, pre: bool = False):
    """The fused tensor-core forward's plan for `dims` (`ft_fwd_geom` in
    the CUDA source, from the geometry alone), or None where it does not
    take it (the layer-streamed forward does, `gen_layer_plan`):
    `gen_bwd_plan`'s keys for the recompute's products alone (trunk,
    feature, view: the backward's first
    depth + 2, so its stages are the first of the backward's ring), with
    two activation buffers and no cotangent in shared memory, and at most
    2 x FWD_TILES output tiles of 64 a product. Every geometry it takes
    the backward's plan takes too."""
    return _ft_plan(dims, pre, forward=True)


def _pad_map(n, npad, base=0):
    """Index j -> base + j for j < n, -1 (a zero) up to npad."""
    m = np.full(npad, -1, np.int64)
    m[:n] = base + np.arange(n)
    return m


def _ft_swizzle():
    """The 128-byte swizzle of a [64][64] bf16 tile (`swz` in
    csrc/fused_mlp_pe.cu): element (r, k) at r 64 + ((k / 8) ^ (r % 8)) 8 +
    k % 8. It is its own inverse."""
    r, k = np.divmod(np.arange(64 * 64), 64)
    return r * 64 + (((k >> 3) ^ (r & 7)) << 3) + (k & 7)


def _ft_stage_matrix(dims: MLPDims, pre: bool, prod, wp, vwp, offs):
    """Product `prod`'s weights as the kernel reads them, [N][K] padded:
    each entry's index in the weights flattened in `_weight_order`
    (`_flat_offsets`), -1 where it is a zero. The recompute's products
    (trunk, feat, view) read their matrix transposed, M[n][k] = w[k'][n'];
    the back-propagation's as it is, M[n][k] = w[n'][k'] (' : the maps
    below from the padded index to the matrix's)."""
    kind, i, _, _, _, n = prod
    w, vw, e, ed = dims.width, dims.view_width, dims.in_dim, dims.dir_dim
    cat = dims.skip + 1 < dims.depth and i == dims.skip + 1
    hmap, xmap = _pad_map(w, wp), _pad_map(e, e)
    xh = np.concatenate([xmap, _pad_map(w, wp, e)])      # [x, h] rows
    fh = np.concatenate([hmap, _pad_map(ed, ed, w)])     # [feat, d] rows
    name, ncols = {"trunk": (f"tw{i}", w), "feat": ("feat_w", w),
                   "view": ("view_w", vw), "gfeat": ("view_w", vw),
                   "gtop": ("feat_w", w), "gtrunk": (f"tw{i}", w)}[kind]
    if kind == "trunk":        # rows over K, columns over N
        rows, cols = (xmap if i == 0 else xh if cat else hmap), hmap
    elif kind == "feat":
        rows, cols = hmap, hmap
    elif kind == "view":
        rows, cols = fh, _pad_map(vw, vwp)
    elif kind == "gfeat":      # rows over N, columns over K
        rows, cols = (fh if pre else hmap), _pad_map(vw, vwp)
    elif kind == "gtop":
        rows, cols = hmap, hmap
    elif pre:
        rows, cols = (xmap if i == 0 else xh if cat else hmap), hmap
    else:                      # v2: the h part of the layer's input only
        rows, cols = _pad_map(w, wp, e if cat else 0), hmap
    if kind in ("trunk", "feat", "view"):
        r_of, c_of = rows[None, :], cols[:, None]
    else:
        r_of, c_of = rows[:, None], cols[None, :]
    out = np.where((r_of >= 0) & (c_of >= 0), offs[name] + r_of * ncols
                   + c_of, -1)
    assert out.shape == (n, prod[2] * _FT["T"]), (kind, out.shape, n)
    return out


_gen_ring_index_cache: dict = {}


def gen_ring_index(dims: MLPDims, pre: bool, forward: bool = False):
    """The tensor-core backward's weight stages (with `forward`, the
    forward's: `gen_fwd_plan`'s products) in the order its producer
    streams them: for each product, each pair of output tiles (the two
    warpgroups'), each 64-deep chunk, the pair's tiles; each stage a
    [64 N][64 K] tile in the 128-byte swizzle. Returns int64 [stages,
    4096]: each element's index in the weights flattened in
    `_weight_order`, -1 for a zero (padding). Built once per geometry."""
    key = (dims, pre, forward)
    if key not in _gen_ring_index_cache:
        plan = _ft_plan(dims, pre, forward)
        offs, _ = _flat_offsets(dims)
        sw = _ft_swizzle()
        t, stages = _FT["T"], []
        for prod in plan["products"]:
            m = _ft_stage_matrix(dims, pre, prod, plan["wp"], plan["vwp"],
                                 offs)
            nt, nk = prod[5] // t, prod[2]
            assert m.shape == (nt * t, nk * t)
            tiles = m.reshape(nt, t, nk, t).transpose(0, 2, 1, 3).reshape(
                nt, nk, t * t)
            for tp in range((nt + 1) // 2):
                for kc in range(nk):
                    for wgp in range(min(2, nt - 2 * tp)):
                        stages.append(tiles[2 * tp + wgp, kc][sw])
        idx = np.stack(stages)
        assert idx.shape[0] == plan["stages"]
        _gen_ring_index_cache[key] = torch.from_numpy(idx)
    return _gen_ring_index_cache[key]


def gen_ring(weights, dims: MLPDims, pre: bool, forward: bool = False):
    """What the tensor-core backward reads of the weights (with `forward`,
    what the forward reads, the backward's first stages): every stage of
    `gen_ring_index` as its parts (`split_bf16x3` at f32; the bf16
    rounding alone at bf16, as the plain version rounds), part after part:
    bf16 [stages, parts, 4096], flat. Packed once a call."""
    plan = _ft_plan(dims, pre, forward)
    if plan is None:
        what = "forward" if forward else "backward"
        raise ValueError(f"the tensor-core {what} does not take {dims}")
    dev = weights["tw0"].device
    idx = gen_ring_index(dims, pre, forward).to(dev).reshape(-1)
    flat = torch.cat([weights[n].reshape(-1).float()
                      for n in _weight_order(dims)] + [
        torch.zeros(1, device=dev)])
    vals = flat[torch.where(idx < 0, flat.numel() - 1, idx)].view(
        plan["stages"], -1)
    parts = ((vals.to(torch.bfloat16),) if plan["parts"] == 1
             else split_bf16x3(vals))
    return torch.stack(parts, dim=1).reshape(-1)


class GenPack(NamedTuple):
    """The generic route's weights for a forward and its backward
    (`pack_for`): `gen_heads`' buffer, `gen_ring`'s stages where the
    backward runs on the fused tensor-core kernels (the forward there reads
    their first), and `gen_ls_ring`'s where a direction runs on the
    layer-streamed ones (the backward's whole ring, whose first stages the
    forward reads, or the forward's alone); None where not needed."""
    heads: torch.Tensor
    ring: torch.Tensor | None
    ls_ring: torch.Tensor | None


def _check_tc_plan(lib, prm, dims: MLPDims, pre: bool, ring, *,
                   forward: bool):
    """Raise RuntimeError unless the CUDA source's plan (`fg_tc_plan`, with
    `forward` `fg_tc_fwd_plan`) equals `gen_bwd_plan`'s (`gen_fwd_plan`'s)
    and `ring` holds its stages (a forward also reads the first stages of
    the backward's ring)."""
    plan = _ft_plan(dims, pre, forward)
    name = "fg_tc_fwd_plan" if forward else "fg_tc_plan"
    got = (ctypes.c_longlong * 8)()
    _raise_on(lib, name, getattr(lib, name)(ctypes.byref(prm), int(pre),
                                            got))
    want = (1, plan["smem"], plan["slots"], plan["stages"],
            plan["ring_bytes"], plan["wp"], plan["vwp"], plan["parts"])
    rings = {plan["ring_bytes"]}
    if forward:
        rings.add(gen_bwd_plan(dims, pre)["ring_bytes"])
    if tuple(got) != want or ring.numel() * 2 not in rings:
        raise RuntimeError(f"{'gen_fwd_plan' if forward else 'gen_bwd_plan'}"
                           f" {want} disagrees with the CUDA source's "
                           f"{tuple(got)} or the ring's {ring.numel() * 2} "
                           f"bytes")


def _bwd_buffers(lib, prm, sizes_fn, inputs, g, dims: MLPDims, *, pre: bool,
                 args=()):
    """The buffers a generic backward writes: (sizes, scratch f32, split
    partial sums f64, chunk sums f64, the flat f32 gradients (every entry
    written), dx and dd with `pre`) for `sizes_fn` (`fg_tc_sizes` or
    `fg_ls_sizes`, its four sizes then)."""
    p, dev = inputs[0].shape[0], inputs[0].device
    sizes = (ctypes.c_longlong * 4)()
    _raise_on(lib, sizes_fn, getattr(lib, sizes_fn)(
        ctypes.byref(prm), p, int(pre), *args, sizes))
    scratch, part, acc = (torch.empty(max(int(k), 1), dtype=dt, device=dev)
                          for k, dt in zip(sizes, (torch.float32,
                                                   torch.float64,
                                                   torch.float64)))
    flat = (torch.empty if p else torch.zeros)(
        prm.n_params, dtype=torch.float32, device=dev)
    dx = dd = None
    if pre:
        dx = torch.empty((p, dims.in_dim), dtype=torch.float32, device=dev)
        dd = torch.empty((p, dims.dir_dim), dtype=torch.float32, device=dev)
    return sizes, scratch, part, acc, flat, dx, dd


def _check_cotangent(inputs, g, dims: MLPDims):
    p = inputs[0].shape[0]
    if g.shape != (p, 4 + dims.out_extra):
        raise ValueError(f"cotangent must be [{p}, {4 + dims.out_extra}], "
                         f"got {tuple(g.shape)}")
    return g.to(torch.float32).contiguous()


def _gen_tc_args(weights, inputs, g, dims: MLPDims, *, pre: bool,
                 pack: GenPack | None = None) -> _GenBwdCall:
    """Check the inputs and allocate what a fused tensor-core backward on
    (xd,) (v2) or, with `pre`, on the encodings (x_enc, d_enc) (v1) needs:
    `pack_for`'s `GenPack` (packed here when None; the ring in
    `keep[-1]`), the plan checked against the CUDA source's (`fg_tc_plan`),
    its sizes (`fg_tc_sizes`), the flat f32 gradients, with `pre` dx and
    dd."""
    _check_kernel_args(weights, inputs, dims, pre)
    plan = gen_bwd_plan(dims, pre)
    if plan is None:
        raise ValueError(f"the tensor-core backward does not take {dims}")
    g = _check_cotangent(inputs, g, dims)
    lib = _gen_lib()
    if pack is None or pack.ring is None:
        pack = GenPack(gen_heads(weights, dims),
                       gen_ring(weights, dims, pre), None)
    ring = pack.ring
    prm = gen_params(weights, dims, pack.heads)
    _check_tc_plan(lib, prm, dims, pre, ring, forward=False)
    sizes, scratch, part, acc, flat, dx, dd = _bwd_buffers(
        lib, prm, "fg_tc_sizes", inputs, g, dims, pre=pre)
    ptrs = (inputs[0].data_ptr(), inputs[1].data_ptr() if pre else None,
            g.data_ptr(), flat.data_ptr(),
            dx.data_ptr() if pre else None, dd.data_ptr() if pre else None,
            scratch.data_ptr(), part.data_ptr(), acc.data_ptr(),
            ring.data_ptr(), plan["ring_bytes"])
    return _GenBwdCall(lib, prm, ptrs, inputs[0].shape[0], flat, dx, dd,
                       4 * int(sizes[0]),
                       (pack.heads, g, scratch, part, acc, ring))


def _gen_bwd_tc(weights, inputs, g, dims: MLPDims, *, pre: bool,
                pack: GenPack | None = None):
    """One fused tensor-core backward (`fg_bwd_tc`, `fg_bwd_tc_pre`),
    uncounted: (f32 weight gradients in `_weight_order`, dx, dd)."""
    c = _gen_tc_args(weights, inputs, g, dims, pre=pre, pack=pack)
    stream = torch.cuda.current_stream(inputs[0].device).cuda_stream
    in_x, in_d, g_, grads, dx, dd, *rest = c.ptrs
    if pre:
        err = c.lib.fg_bwd_tc_pre(ctypes.byref(c.prm), in_x, in_d, g_, grads,
                                  dx, dd, *rest, c.n_points, stream)
    else:
        err = c.lib.fg_bwd_tc(ctypes.byref(c.prm), in_x, g_, grads, *rest,
                              c.n_points, stream)
    _raise_on(c.lib, "fg_bwd_tc_pre" if pre else "fg_bwd_tc", err)
    return _gen_grads(c, dims)


# -----------------------------------------------------------------------------
# the layer-streamed kernels (csrc/fused_mlp_gen.cu, ls_*)
# -----------------------------------------------------------------------------

# The operand buffers of `ls_products` (LS_BX, LS_BD, LS_BH0, LS_BH1).
_LS_BUFS = ("x", "d", "h0", "h1")


def _ls_products(dims: MLPDims, pre: bool, wp: int, vwp: int):
    """`ls_products` of the CUDA source: every product of the
    layer-streamed backward in launch order (the forward takes the first
    depth + 2), each (kind, layer, output columns, column tiles of 128, K
    chunks of 64, of which from the first segment, that segment's operand
    buffer, the second's or None, the buffer the epilogue writes or None):
    the recompute (trunk, the skip layer on [x, h]; feature; view on
    [feat, d]), then from G_v (in "h0"): G_feat, with `pre` dd, the last
    trunk layer's G, down the trunk to layer 1, with `pre` dx's part of the
    skip layer before it and of layer 0 at the end."""
    t, bn, d = _LS["T"], _LS["BN"], dims.depth
    e, wk = dims.in_dim // t, wp // t
    cat = dims.skip + 1 if dims.skip + 1 < d else -1
    out = []

    def add(kind, layer, n, s0, k0, s1=None, k1=0, dst=None):
        out.append((kind, layer, n, -(-n // bn), k0 + (k1 if s1 else 0), k0,
                    s0, s1, dst))

    def h(i):
        return "h0" if i % 2 == 0 else "h1"

    for i in range(d):
        if i == 0:
            add("trunk", 0, dims.width, "x", e, dst=h(0))
        elif i == cat:
            add("trunk", i, dims.width, "x", e, h(i - 1), wk, dst=h(i))
        else:
            add("trunk", i, dims.width, h(i - 1), wk, dst=h(i))
    add("feat", 0, dims.width, h(d - 1), wk, dst=h(d))
    add("view", 0, dims.view_width, h(d), wk, "d", dims.dir_dim // t)
    add("gfeat", 0, dims.width, "h0", vwp // t, dst="h1")
    if pre:
        add("dd", 0, dims.dir_dim, "h0", vwp // t)
    add("gtop", 0, dims.width, "h1", wk, dst="h0")

    def g(i):     # the buffer of layer i's output gradient
        return h(d - 1 - i)

    for i in range(d - 1, 0, -1):
        if pre and i == cat:
            add("dx", i, dims.in_dim, g(i), wk)
        add("gtrunk", i, dims.width, g(i), wk, dst=g(i - 1))
    if pre:
        add("dx", 0, dims.in_dim, g(0), wk)
    return out


def gen_layer_plan(dims: MLPDims, pre: bool = False, forward: bool = False):
    """The layer-streamed kernels' plan for `dims` (`ls_geom` in the CUDA
    source, from the geometry alone) for the forward (`forward`) or the
    backward, or None where the fused tensor-core kernels take that
    direction (`gen_fwd_plan`, `gen_bwd_plan`) or the route is not "gen":
    operand parts (3 at f32, 1 at bf16), width and view width padded to 64,
    ring slots and shared memory, the products (`_ls_products`; the
    forward's first depth + 2), their weight stages and the ring's
    bytes."""
    if route(dims, pre) != "gen":
        return None
    if (gen_fwd_plan if forward else gen_bwd_plan)(dims, pre) is not None:
        return None
    t = _LS["T"]
    if dims.in_dim % t or dims.dir_dim % t:
        return None
    parts = 1 if dims.compute_dtype == "bfloat16" else 3
    wp, vwp = _round_up(dims.width, t), _round_up(dims.view_width, t)

    def smem(s):
        return (s * parts * (2 * _LS["APLANE"] + _LS["BPLANE"]) + 16 * s
                + _FT["ALIGN"])

    fits = [s for s in range(_LS["MAX_SLOTS"], _LS["MIN_SLOTS"] - 1, -1)
            if smem(s) <= _FT["SMEM_MAX"]]
    if not fits:
        return None
    prods = _ls_products(dims, pre, wp, vwp)
    if forward:
        prods = prods[:dims.depth + 2]
    stages = sum(ntn * nk for _, _, _, ntn, nk, *_ in prods)
    return {"parts": parts, "wp": wp, "vwp": vwp, "slots": fits[0],
            "smem": smem(fits[0]), "stages": stages,
            "ring_bytes": stages * parts * _LS["BPLANE"], "products": prods}


def _ls_swizzle():
    """The 128-byte swizzle of a [128][64] bf16 stage: element (r, k) at
    r 64 + ((k / 8) ^ (r % 8)) 8 + k % 8 (`_ft_swizzle` over 128 rows; its
    own inverse)."""
    r, k = np.divmod(np.arange(128 * 64), 64)
    return r * 64 + (((k >> 3) ^ (r & 7)) << 3) + (k & 7)


def _ls_stage_matrix(w, dims: MLPDims, prod, wp):
    """Product `prod`'s weights as the kernel reads them, B^T [N][K] padded
    with zeros to its column tiles and chunks, from the matrices `w` (on
    their device). The recompute's products read their matrix transposed,
    B^T[n][k] = w[k][n], the back-propagation's as it is; [x, h] and
    [feat, d] with each segment padded to its chunks."""
    kind, i, _, ntn, nk = prod[:5]
    width, e = dims.width, dims.in_dim
    cat = dims.skip + 1 < dims.depth and i == dims.skip + 1
    npad, kpad = ntn * _LS["BN"], nk * _LS["T"]

    def pad(m, rows, cols):
        return nn.functional.pad(m, (0, cols - m.shape[1],
                                     0, rows - m.shape[0]))

    if kind == "trunk":          # K over the matrix's rows, N its columns
        tw = w[f"tw{i}"]
        k = (tw if i == 0 else torch.cat([tw[:e], pad(tw[e:], wp, width)])
             if cat else pad(tw, wp, width))
        return pad(k, kpad, npad).t()
    if kind == "feat":
        return pad(pad(w["feat_w"], wp, width), kpad, npad).t()
    vw = w["view_w"]
    if kind == "view":
        return pad(torch.cat([pad(vw[:width], wp, vw.shape[1]),
                              vw[width:]]), kpad, npad).t()
    if kind == "gfeat":          # N over the matrix's rows, K its columns
        return pad(vw[:width], npad, kpad)
    if kind == "dd":
        return pad(vw[width:], npad, kpad)
    if kind == "gtop":
        return pad(w["feat_w"], npad, kpad)
    tw = w[f"tw{i}"]
    if kind == "gtrunk":
        return pad(tw[e:] if cat else tw, npad, kpad)
    return pad(tw[:e], npad, kpad)   # dx: the encoding's rows of the layer


def gen_ls_ring(weights, dims: MLPDims, pre: bool, forward: bool = False):
    """What the layer-streamed kernels read of the trunk, feature and view
    matrices (with `forward`, what the forward reads: the backward's first
    stages), in the order their producers stream them: for each of
    `gen_layer_plan`'s products (`_ls_stage_matrix`), each column tile of
    128, each 64-deep chunk, a [128 N][64 K] stage in the 128-byte swizzle
    (`_ls_swizzle`) as its parts (`split_bf16x3` at f32; the bf16 rounding
    alone at bf16), part after part: bf16 [stages, parts, 8192], flat.
    Packed once a call, on the weights' device."""
    plan = gen_layer_plan(dims, pre, forward)
    if plan is None:
        what = "forward" if forward else "backward"
        raise ValueError(f"the layer-streamed {what} does not take {dims}")
    w = {n: v.float() for n, v in weights.items()
         if n.startswith("tw") or n in ("feat_w", "view_w")}
    sw = torch.from_numpy(_ls_swizzle()).to(weights["tw0"].device)
    t, bn, stages = _LS["T"], _LS["BN"], []
    for prod in plan["products"]:
        ntn, nk = prod[3], prod[4]
        bt = _ls_stage_matrix(w, dims, prod, plan["wp"])
        stages.append(bt.reshape(ntn, bn, nk, t).permute(0, 2, 1, 3)
                      .reshape(ntn * nk, bn * t)[:, sw])
    vals = torch.cat(stages)
    assert vals.shape[0] == plan["stages"]
    parts = ((vals.to(torch.bfloat16),) if plan["parts"] == 1
             else split_bf16x3(vals))
    return torch.stack(parts, dim=1).reshape(-1)


def _check_ls_plan(lib, prm, dims: MLPDims, pre: bool, ring, *,
                   forward: bool):
    """Raise RuntimeError unless the CUDA source's plan (`fg_ls_plan`)
    equals `gen_layer_plan`'s and `ring` holds its stages (a forward also
    reads the first stages of the backward's ring)."""
    plan = gen_layer_plan(dims, pre, forward)
    got = (ctypes.c_longlong * 9)()
    _raise_on(lib, "fg_ls_plan", lib.fg_ls_plan(ctypes.byref(prm), int(pre),
                                                int(forward), got))
    want = (1, plan["smem"], plan["slots"], plan["stages"],
            plan["ring_bytes"], plan["wp"], plan["vwp"], plan["parts"],
            len(plan["products"]))
    rings = {plan["ring_bytes"]}
    bwd = gen_layer_plan(dims, pre)
    if forward and bwd is not None:
        rings.add(bwd["ring_bytes"])
    if tuple(got) != want or ring.numel() * 2 not in rings:
        raise RuntimeError(f"gen_layer_plan {want} disagrees with the CUDA "
                           f"source's {tuple(got)} or the ring's "
                           f"{ring.numel() * 2} bytes")


def _gen_ls_args(weights, inputs, g, dims: MLPDims, *, pre: bool,
                 pack: GenPack | None = None) -> _GenBwdCall:
    """`_gen_tc_args` for the layer-streamed backward (`fg_bwd_ls`): its
    ring (`gen_ls_ring`, packed here unless `pack` holds it), the plan
    checked against the CUDA source's (`fg_ls_plan`), its sizes and work
    buffer (`fg_ls_sizes`)."""
    _check_kernel_args(weights, inputs, dims, pre)
    plan = gen_layer_plan(dims, pre)
    if plan is None:
        raise ValueError(f"the layer-streamed backward does not take {dims}")
    g = _check_cotangent(inputs, g, dims)
    lib = _gen_lib()
    heads = pack.heads if pack is not None else gen_heads(weights, dims)
    ring = pack.ls_ring if pack is not None else None
    if ring is None or 2 * ring.numel() != plan["ring_bytes"]:
        ring = gen_ls_ring(weights, dims, pre)
    prm = gen_params(weights, dims, heads)
    _check_ls_plan(lib, prm, dims, pre, ring, forward=False)
    sizes, scratch, part, acc, flat, dx, dd = _bwd_buffers(
        lib, prm, "fg_ls_sizes", inputs, g, dims, pre=pre, args=(0,))
    work = torch.empty(max(int(sizes[3]), 1), dtype=torch.uint8,
                       device=inputs[0].device)
    ptrs = (inputs[0].data_ptr(), inputs[1].data_ptr() if pre else None,
            g.data_ptr(), flat.data_ptr(),
            dx.data_ptr() if pre else None, dd.data_ptr() if pre else None,
            scratch.data_ptr(), part.data_ptr(), acc.data_ptr(),
            work.data_ptr(), work.numel(), ring.data_ptr(),
            plan["ring_bytes"])
    return _GenBwdCall(lib, prm, ptrs, inputs[0].shape[0], flat, dx, dd,
                       4 * int(sizes[0]),
                       (heads, g, scratch, part, acc, ring, work))


def _gen_bwd_ls(weights, inputs, g, dims: MLPDims, *, pre: bool,
                pack: GenPack | None = None):
    """One layer-streamed backward (`fg_bwd_ls`, both passes), uncounted:
    (f32 weight gradients in `_weight_order`, dx, dd)."""
    c = _gen_ls_args(weights, inputs, g, dims, pre=pre, pack=pack)
    stream = torch.cuda.current_stream(inputs[0].device).cuda_stream
    _raise_on(c.lib, "fg_bwd_ls", c.lib.fg_bwd_ls(
        ctypes.byref(c.prm), *c.ptrs, c.n_points, int(pre), 3, stream))
    return _gen_grads(c, dims)


def fwd_fn(weights, inputs, dims: MLPDims, *, pre: bool, pack=None):
    """Check the inputs and pack, once, what a forward launch on (xd,) (v2,
    #9) or, with `pre`, on the encodings (x_enc, d_enc) (v1, #7) needs on
    the route of `dims` (`route`): a function that launches the kernel on
    those buffers and returns raw [P, 4+e] f32 (the same tensor each call),
    its route as `run.route` and its launch counter's key as `run.key`
    (generic route: "fwd_tc" where `gen_fwd_plan` takes `dims`, its plan
    checked against the CUDA source's, else "fwd_ls", `gen_layer_plan`'s,
    likewise checked; else "fwd"). `pack`: `pack_for`'s (wgmma:
    `gather_ring`'s whole ring or its forward stages; gen: a `GenPack`),
    packed here when None (the forward's stages alone). Counts no launch,
    so it also times the kernel alone."""
    rt = _check_kernel_args(weights, inputs, dims, pre)
    p, dev = inputs[0].shape[0], inputs[0].device
    out = torch.empty((p, 4 + dims.out_extra), dtype=torch.float32,
                      device=dev)
    ins = [a.data_ptr() for a in inputs]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if rt == "gen":
        lib = _gen_lib()
        heads, ring, ls_ring = (pack if isinstance(pack, GenPack)
                                else (None, None, None))
        if heads is None:
            heads = gen_heads(weights, dims)
        prm = gen_params(weights, dims, heads)
        if gen_fwd_plan(dims, pre) is not None:
            if ring is None:
                ring = gen_ring(weights, dims, pre, forward=True)
            _check_tc_plan(lib, prm, dims, pre, ring, forward=True)
            key, bufs = "fwd_tc", (heads, ring)
            name = "fg_fwd_tc_pre" if pre else "fg_fwd_tc"
            argv = (ctypes.byref(prm), *ins, out.data_ptr(), ring.data_ptr(),
                    2 * ring.numel(), p, stream)
        else:
            if ls_ring is None:
                ls_ring = gen_ls_ring(weights, dims, pre, forward=True)
            _check_ls_plan(lib, prm, dims, pre, ls_ring, forward=True)
            sizes = (ctypes.c_longlong * 4)()
            _raise_on(lib, "fg_ls_sizes", lib.fg_ls_sizes(
                ctypes.byref(prm), p, int(pre), 1, sizes))
            work = torch.empty(max(int(sizes[3]), 1), dtype=torch.uint8,
                               device=dev)
            key, bufs, name = "fwd_ls", (heads, ls_ring, work), "fg_fwd_ls"
            argv = (ctypes.byref(prm), ins[0], ins[1] if pre else None,
                    out.data_ptr(), ls_ring.data_ptr(), 2 * ls_ring.numel(),
                    work.data_ptr(), work.numel(), p, int(pre), stream)
    else:
        lib = _lib()
        if pack is None:
            pack = gather_ring(weights, dims, pre, forward=True)
        prm, bufs = _params(weights, dims, pack)
        name = "fm_fwd_pre" if pre else "fm_fwd"
        key = "fwd"
        argv = (ctypes.byref(prm), *ins, out.data_ptr(), p, stream)
    launch = getattr(lib, name)

    def run():
        _raise_on(lib, name, launch(*argv))
        return out

    run.keep = (prm, bufs)     # what argv points into, alive as long as run
    run.route, run.key = rt, key
    return run


def _fwd_launch(weights, inputs, dims: MLPDims, *, pre: bool, pack=None):
    """One launch of the forward kernel (`fwd_fn`), counted on its route
    and key: raw [P, 4+e] f32 (no autograd)."""
    # the packed buffers stay referenced until the launch is queued; the
    # caching allocator then reuses them in stream order
    run = fwd_fn(weights, inputs, dims, pre=pre, pack=pack)
    out = run()
    _counts(run.route, pre)[run.key] += 1
    return out


def pack_for(weights, dims: MLPDims, pre: bool):
    """What the route's kernels read of the weights, packed once for a
    forward and its backward: the wgmma ring (`gather_ring`) or, on the
    generic route, a `GenPack`: `gen_heads`' buffer; where the backward
    runs on the fused tensor-core kernels (`gen_bwd_plan`), `gen_ring`'s
    stages, whose first are that forward's (`gen_fwd_plan` takes no
    geometry that `gen_bwd_plan` refuses); and `gen_ls_ring`'s where a
    direction is layer-streamed: the backward's whole ring (whose first
    stages are the forward's) or, beside a fused backward, the forward's
    alone."""
    if route(dims, pre) == "gen":
        tc_bwd = gen_bwd_plan(dims, pre) is not None
        tc_fwd = gen_fwd_plan(dims, pre) is not None
        return GenPack(gen_heads(weights, dims),
                       gen_ring(weights, dims, pre) if tc_bwd else None,
                       None if tc_fwd else gen_ls_ring(weights, dims, pre,
                                                       forward=tc_bwd))
    return gather_ring(weights, dims, pre)


class _BwdCall(NamedTuple):
    """The arguments of one backward launch and the buffers they point
    into (`_bwd_args`)."""
    lib: ctypes.CDLL
    args: tuple
    grads: dict                 # views of `flat` at `offs`
    flat: torch.Tensor
    offs: dict
    head_b: torch.Tensor
    bias64: torch.Tensor | None
    dx: torch.Tensor | None
    dd: torch.Tensor | None
    scratch: tuple              # act, grad
    keep: tuple                 # what the arguments point into besides


def _bwd_args(weights, inputs, g, dims: MLPDims, *, pre: bool,
              ring=None) -> _BwdCall:
    """Check the inputs and allocate what a backward launch on (xd,) (v2)
    or, with `pre`, on the encodings (x_enc, d_enc) (v1) needs: the weight
    ring (`gather_ring`, packed here when `ring` is None), the scratch
    (fm_scratch_cols: P x fa and P x fg bf16), the zeroed f32 weight
    gradients in `_weight_order`, the heads' f64 bias sums, and with `pre`
    v1's f64 bias sums and the input gradients dx, dd, and the scratch of
    the partial sums the kernels add in a fixed order (fm_partial_sizes)."""
    _check_kernel_args(weights, inputs, dims, pre)
    p, dev = inputs[0].shape[0], inputs[0].device
    if g.shape != (p, 4 + dims.out_extra):
        raise ValueError(f"cotangent must be [{p}, {4 + dims.out_extra}], "
                         f"got {tuple(g.shape)}")
    g = g.to(torch.float32).contiguous()
    lib = _lib()
    prm, bufs = _params(weights, dims, gather_ring(weights, dims, pre)
                        if ring is None else ring)
    fa, fg = ctypes.c_int(), ctypes.c_int()
    _raise_on(lib, "fm_scratch_cols", lib.fm_scratch_cols(
        dims.depth, dims.skip, ctypes.byref(fa), ctypes.byref(fg)))
    act = torch.empty((p, fa.value), dtype=torch.bfloat16, device=dev)
    grad = torch.empty((p, fg.value), dtype=torch.bfloat16, device=dev)
    # one zeroed buffer; each gradient starts on 16 bytes (float2 atomics)
    # but the heads' biases, which follow the other biases in the order of
    # the kernel's f64 sums (FmGrads.bias64, head_b), so that one copy each
    # brings those in
    shapes = weight_shapes(dims)
    biases = [f"tb{i}" for i in range(dims.depth)] + ["feat_b", "view_b"]
    heads = ["rgb_b", "sigma_b"] + (["sem_b"] if dims.out_extra else [])
    offs, off = {}, 0
    for n in biases + heads + [n for n in shapes if n not in biases + heads]:
        if n not in heads[1:]:
            off = _round_up(off, 4)
        offs[n] = off
        off += math.prod(shapes[n])
    flat = torch.zeros(off, dtype=torch.float32, device=dev)
    grads = {n: flat[offs[n]:offs[n] + math.prod(s)].view(s)
             for n, s in shapes.items()}
    grd = _FmGrads()
    for i in range(dims.depth):
        grd.tw[i] = grads[f"tw{i}"].data_ptr()
        grd.tb[i] = grads[f"tb{i}"].data_ptr()
    for n in ("feat_w", "feat_b", "view_w", "view_b", "rgb_w", "sigma_w") + (
            ("sem_w",) if dims.out_extra else ()):
        setattr(grd, n, grads[n].data_ptr())
    # the heads' bias gradients, summed in f64 by the kernel
    head_b = torch.zeros(8, dtype=torch.float64, device=dev)
    grd.head_b = head_b.data_ptr()
    bias64 = dx = dd = None
    if pre:
        # the trunk's, feature and view biases' f64 sums (FmGrads.bias64),
        # and the input gradients, which the kernel writes whole
        bias64 = torch.zeros(((dims.depth + 2) * dims.width,),
                             dtype=torch.float64, device=dev)
        dx = torch.empty((p, dims.in_dim), dtype=torch.float32, device=dev)
        dd = torch.empty((p, dims.dir_dim), dtype=torch.float32, device=dev)
        grd.bias64, grd.dx, grd.dd = (bias64.data_ptr(), dx.data_ptr(),
                                      dd.data_ptr())
    # the splits' and the blocks' partial sums, added in a fixed order
    sizes = (ctypes.c_longlong * 4)()
    _raise_on(lib, "fm_partial_sizes", lib.fm_partial_sizes(
        dims.depth, dims.skip, int(pre), p, sizes))
    parts = tuple(torch.empty(max(int(k), 1), dtype=dt, device=dev)
                  for k, dt in zip(sizes, (torch.float32, torch.float32,
                                           torch.float64, torch.float64)))
    grd.dwpart, grd.hpart, grd.hpart64 = (a.data_ptr() for a in parts[:3])
    if pre:
        grd.bpart64 = parts[3].data_ptr()
    ins = [a.data_ptr() for a in inputs] + ([] if pre else [None])
    args = (ctypes.byref(prm), ctypes.byref(grd), *ins, g.data_ptr(),
            act.data_ptr(), grad.data_ptr(), p)
    # the bf16 weights, g and the scratch stay referenced until the launch is
    # queued; the caching allocator then reuses them in stream order
    return _BwdCall(lib, args, grads, flat, offs, head_b, bias64, dx, dd,
                    (act, grad), (prm, grd, bufs, g, parts))


def _bwd_launch(weights, inputs, g, dims: MLPDims, *, pre: bool,
                pack=None):
    """One launch of the backward on (xd,) (v2, #10) or, with `pre`, on the
    encodings (x_enc, d_enc) (v1, #8), on the route of `dims` (wgmma:
    `fm_bwd` / `fm_bwd_pre`, the recompute-and-backprop kernel, then the
    split-K weight-gradient kernel; gen: `fg_bwd_tc` / `fg_bwd_tc_pre` on
    the fused tensor-core kernels where `gen_bwd_plan` takes `dims`, else
    `fg_bwd_ls`, the layer-streamed ones, each counted on its own key),
    counted:
    (f32 weight gradients for the cotangent g [P, 4+e] in `_weight_order`,
    dx, dd), the input gradients [P, in_dim] / [P, dir_dim] f32 with `pre`
    and None without. `pack`: `pack_for`'s, packed here when None. The sums
    of the blocks' and splits' partial gradients run in a fixed order (the
    notes in the CUDA sources), so launches on the same inputs are
    bit-equal."""
    if route(dims, pre) == "gen":
        if gen_bwd_plan(dims, pre) is not None:
            out = _gen_bwd_tc(weights, inputs, g, dims, pre=pre, pack=pack)
            _counts("gen", pre)["bwd_tc"] += 1
        else:
            out = _gen_bwd_ls(weights, inputs, g, dims, pre=pre, pack=pack)
            _counts("gen", pre)["bwd_ls"] += 1
        return out
    c = _bwd_args(weights, inputs, g, dims, pre=pre, ring=pack)
    stream = torch.cuda.current_stream(inputs[0].device).cuda_stream
    args = c.args if pre else c.args[:3] + c.args[4:]    # fm_bwd: no d_enc
    name = "fm_bwd_pre" if pre else "fm_bwd"
    _raise_on(c.lib, name, getattr(c.lib, name)(*args, stream))
    _counts("wgmma", pre)["bwd"] += 1
    nout = 4 + dims.out_extra
    h0 = c.offs["rgb_b"]
    c.flat[h0:h0 + nout].copy_(c.head_b[:nout])
    if not pre:
        return c.grads, None, None
    n_bias = (dims.depth + 1) * dims.width + dims.view_width
    c.flat[:n_bias].copy_(c.bias64[:n_bias])
    return c.grads, c.dx, c.dd


def bwd_pass_fns(weights, inputs, g, dims: MLPDims, *, pre: bool):
    """For timing the backward's two passes apart (`fm_bwd_pass`,
    `fg_bwd_tc_pass`, `fg_bwd_ls`, on the route and kernels of `dims`):
    two functions that launch, on one set of buffers, the
    recompute-and-backprop kernels and the weight-gradient reduction
    (which reduces what the first one wrote; call that one first; the
    generic route runs each pass over its chunks of points), and the bytes
    of that scratch. Counts no launch; no result is read. Each pass
    includes its fixed-order sums."""
    if route(dims, pre) == "gen":
        tc = gen_bwd_plan(dims, pre) is not None
        c = (_gen_tc_args if tc else _gen_ls_args)(weights, inputs, g, dims,
                                                   pre=pre)
        scratch_bytes = c.scratch_bytes
        name = "fg_bwd_tc_pass" if tc else "fg_bwd_ls"

        def run(k):
            _raise_on(c.lib, name, getattr(c.lib, name)(
                ctypes.byref(c.prm), *c.ptrs, c.n_points, int(pre), k,
                stream))
    else:
        c = _bwd_args(weights, inputs, g, dims, pre=pre)
        scratch_bytes = sum(a.numel() * a.element_size() for a in c.scratch)

        def run(k):
            _raise_on(c.lib, "fm_bwd_pass",
                      c.lib.fm_bwd_pass(*c.args, int(pre), k, stream))

    stream = torch.cuda.current_stream(inputs[0].device).cuda_stream
    return (lambda: run(1)), (lambda: run(2)), scratch_bytes


def fused_mlp_pe_fwd_kernel(weights, xd, dims: MLPDims):
    """One launch of the v2 forward kernel (#9): raw [P, 4+e] f32."""
    return _fwd_launch(weights, (xd,), dims, pre=False)


def fused_mlp_pe_bwd_kernel(weights, xd, g, dims: MLPDims) -> dict:
    """One launch of the v2 backward (#10): f32 weight gradients for the
    cotangent g [P, 4+e], in `_weight_order`."""
    grads, _, _ = _bwd_launch(weights, (xd,), g, dims, pre=False)
    return grads


def fused_mlp_fwd_kernel(weights, x_enc, d_enc, dims: MLPDims):
    """One launch of the v1 forward kernel (#7) on the encodings x_enc
    [P, in_dim], d_enc [P, dir_dim] f32: raw [P, 4+e] f32."""
    return _fwd_launch(weights, (x_enc, d_enc), dims, pre=True)


def fused_mlp_bwd_kernel(weights, x_enc, d_enc, g, dims: MLPDims):
    """One launch of the v1 backward (#8): (f32 weight gradients in
    `_weight_order`, dx [P, in_dim], dd [P, dir_dim]) for the cotangent
    g."""
    return _bwd_launch(weights, (x_enc, d_enc), g, dims, pre=True)


class _FusedMLPPE(torch.autograd.Function):
    """Kernel forward and backward on CUDA tensors (the route of `dims`),
    the plain version on CPU tensors; the gradient flows to the weights
    only, as in the JAX custom VJP. On CUDA the forward packs the route's
    weights (`pack_for`), which the backward reads too: the saved weights
    cannot change in between (autograd's version check)."""

    @staticmethod
    def forward(ctx, dims, xd, *ws):
        weights = dict(zip(_weight_order(dims), ws))
        ctx.dims = dims
        ctx.save_for_backward(xd, *ws)
        if not xd.is_cuda:
            return fused_mlp_pe_plain(weights, xd, dims)
        ctx.pack = pack_for(weights, dims, pre=False)
        return _fwd_launch(weights, (xd,), dims, pre=False, pack=ctx.pack)

    @staticmethod
    def backward(ctx, g):
        xd, *ws = ctx.saved_tensors
        dims = ctx.dims
        weights = dict(zip(_weight_order(dims), ws))
        if xd.is_cuda:
            d, _, _ = _bwd_launch(weights, (xd,), g, dims, pre=False,
                                  pack=ctx.pack)
        else:
            d = fused_mlp_pe_bwd_plain(weights, xd, g, dims)
        return (None, None, *(d[n] for n in _weight_order(dims)))


def _records_grad(tensors) -> bool:
    """Whether autograd records a function of `tensors` here."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def fused_mlp_pe(weights, xd, dims: MLPDims):
    """Fused encode + MLP: xd [P, 8] f32 (x, y, z, dx, dy, dz, 0, 0) ->
    raw [P, 4 + out_extra] f32, differentiable in `weights` only. On CUDA
    tensors P must be a multiple of 64; where no gradient is recorded the
    forward kernel runs alone, on what it reads of the weights."""
    ws = [weights[n] for n in _weight_order(dims)]
    if xd.is_cuda and not _records_grad(ws):
        return _fwd_launch(weights, (xd,), dims, pre=False)
    return _FusedMLPPE.apply(dims, xd, *ws)


def make_fused_pe_field_fn(dims: MLPDims, *, block: int = 512):
    """`(weights, pts [B, S, 3], viewdirs [B, 3]) -> raw [B, S, C]` over
    `fused_mlp_pe`; the point count is padded to a multiple of `block`."""

    def field_fn(weights, pts, viewdirs):
        b, s = pts.shape[0], pts.shape[1]
        p = b * s
        vd = viewdirs[:, None, :].expand(b, s, 3)
        xd = torch.cat([pts.reshape(-1, 3), vd.reshape(-1, 3),
                        pts.new_zeros((p, 2))], dim=-1).float()
        xd = nn.functional.pad(xd, (0, 0, 0, _round_up(p, block) - p))
        raw = fused_mlp_pe(weights, xd.contiguous(), dims)
        return raw[:p].reshape(b, s, -1)

    return field_fn


class _FusedMLP(torch.autograd.Function):
    """The v1 kernels (#7/#8) on CUDA tensors, their plain version on CPU
    tensors; the gradient flows to the weights and to both encodings, as in
    the JAX custom VJP. The weights are packed once, as in
    `_FusedMLPPE`."""

    @staticmethod
    def forward(ctx, dims, x_enc, d_enc, *ws):
        weights = dict(zip(_weight_order(dims), ws))
        ctx.dims = dims
        ctx.save_for_backward(x_enc, d_enc, *ws)
        if not x_enc.is_cuda:
            return fused_mlp_fwd_plain(weights, x_enc, d_enc, dims)
        ctx.pack = pack_for(weights, dims, pre=True)
        return _fwd_launch(weights, (x_enc, d_enc), dims, pre=True,
                           pack=ctx.pack)

    @staticmethod
    def backward(ctx, g):
        x_enc, d_enc, *ws = ctx.saved_tensors
        dims = ctx.dims
        weights = dict(zip(_weight_order(dims), ws))
        if x_enc.is_cuda:
            d, dx, dd = _bwd_launch(weights, (x_enc, d_enc), g, dims,
                                    pre=True, pack=ctx.pack)
        else:
            d, dx, dd = fused_mlp_bwd_plain(weights, x_enc, d_enc, g, dims)
        return (None, dx, dd, *(d[n] for n in _weight_order(dims)))


def fused_mlp(dims: MLPDims, block: int, weights: dict, x_enc, d_enc):
    """Fused NeRF-MLP forward on encodings computed outside (v1; the JAX
    signature): x_enc [P, in_dim], d_enc [P, dir_dim] f32 with P a multiple
    of `block` -> raw [P, 4 + out_extra] f32, differentiable in the weights
    and both encodings. On CUDA tensors `block` must be a multiple of 64."""
    p = x_enc.shape[0]
    if p % block or (x_enc.is_cuda and block % _BM):
        raise ValueError(f"{p} points are not a multiple of the block "
                         f"{block} (a multiple of {_BM} on the card)")
    ws = [weights[n] for n in _weight_order(dims)]
    if x_enc.is_cuda and not _records_grad(ws + [x_enc, d_enc]):
        return _fwd_launch(weights, (x_enc, d_enc), dims, pre=True)
    return _FusedMLP.apply(dims, x_enc, d_enc, *ws)


def make_fused_field_fn(dims: MLPDims, *, multires: int = 10,
                        multires_views: int = 4, block: int = 512):
    """`(weights, pts [B, S, 3], viewdirs [B, 3]) -> raw [B, S, C]` over
    `fused_mlp`: the positional encodings are computed here in PyTorch,
    zero-padded to the kernels' lanes and to a multiple of `block` points,
    and the output is sliced back. Autograd carries the input gradients
    through the encodings to `pts` and `viewdirs`."""

    def field_fn(weights, pts, viewdirs):
        b, s = pts.shape[0], pts.shape[1]
        x, d = field_encodings(pts, viewdirs, dims, multires=multires,
                               multires_views=multires_views, block=block)
        raw = fused_mlp(dims, block, weights, x, d)
        return raw[:b * s].reshape(b, s, -1)

    return field_fn


def field_encodings(pts, viewdirs, dims: MLPDims, *, multires: int = 10,
                    multires_views: int = 4, block: int = 512):
    """The inputs `make_fused_field_fn` hands `fused_mlp`: the positional
    encodings of pts [B, S, 3] and of viewdirs [B, 3] broadcast over the S
    samples, zero-padded to in_dim / dir_dim lanes and to a multiple of
    `block` rows. Returns contiguous (x_enc, d_enc), differentiable."""
    b, s = pts.shape[0], pts.shape[1]
    x = positional_encoding(pts.reshape(-1, 3), multires)
    vd = viewdirs[:, None, :].expand(b, s, 3).reshape(-1, 3)
    d = positional_encoding(vd, multires_views)
    pad = _round_up(b * s, block) - b * s
    x = nn.functional.pad(x, (0, dims.in_dim - x.shape[-1], 0, pad))
    d = nn.functional.pad(d, (0, dims.dir_dim - d.shape[-1], 0, pad))
    return x.contiguous(), d.contiguous()


class FusedMLPField(nn.Module):
    """The `--no_tcnn` NeRF field on the fused encode+MLP kernels.

    Parameters are one `nn.ParameterDict`, `weights`, keyed by the JAX
    names in the JAX layout (kernels [in, out] with the encodings' padding
    rows, biases [1, out]); `reset_parameters` draws them as an identically
    seeded `NeRFField` would and pads them, as the JAX field does."""

    def __init__(self, *, depth: int = 8, width: int = 256,
                 multires: int = 10, multires_views: int = 4,
                 semantic: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        if depth == 5:
            # skip (4) would concat after the LAST trunk layer, feeding the
            # heads a [in_dim+width] vector — a geometry neither the weight
            # converter nor the backward kernel supports; use NeRFField
            raise ValueError(
                "FusedMLPField does not support depth == skip+1 == 5 "
                "(skip-concat would feed the heads); use NeRFField")
        device = resolve_device(device)
        self.semantic = semantic
        self.dims = dims_for_field(
            multires=multires, multires_views=multires_views, width=width,
            depth=depth, semantic=semantic)._replace(
                compute_dtype=str(compute_dtype).removeprefix("torch."))
        self.weights = nn.ParameterDict({
            n: nn.Parameter(torch.empty(s, dtype=torch.float32,
                                        device=device))
            for n, s in weight_shapes(self.dims).items()})
        self._field = make_fused_pe_field_fn(self.dims)

    def reset_parameters(self, generator=None):
        """lecun-normal kernels (fan_in = the unpadded input width) and zero
        biases, the flax Dense defaults, from a CPU `generator`."""
        from spinnerf_tpu_torch.convert import nerf_field_tree
        from spinnerf_tpu_torch.models.fields import NeRFField
        d = self.dims
        ref = NeRFField(depth=d.depth, width=d.width, multires=d.multires,
                        multires_views=d.multires_views,
                        semantic=self.semantic, device="cpu")
        ref.reset_parameters(generator)
        fused = params_to_fused(
            nerf_field_tree(ref), d, raw_in_dim=3 * (1 + 2 * d.multires),
            raw_dir_dim=3 * (1 + 2 * d.multires_views))
        with torch.no_grad():
            for n, p in self.weights.items():
                p.copy_(fused[n])

    def forward(self, pts, viewdirs=None, frozen_sigma=None):
        if frozen_sigma is not None:
            raise ValueError(
                "FusedMLPField does not support the frozen-sigma "
                "(NeRF_RGB / --alpha_model_path) mode; use NeRFField")
        if viewdirs is None:
            raise ValueError("FusedMLPField requires viewdirs")
        return self._field(dict(self.weights), pts, viewdirs)
