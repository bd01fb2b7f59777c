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

Both launch the kernels of `csrc/fused_mlp_pe.cu` for CUDA tensors (or
raise) and run their plain versions (`fused_mlp_pe_plain` /
`fused_mlp_pe_bwd_plain`, `fused_mlp_fwd_plain` / `fused_mlp_bwd_plain`) for
CPU tensors. The kernels read the trunk, feature and view matrices as one
ring of pre-swizzled weight stages (`pack_ring`, packed by `gather_ring`):
the forward its first stages, the backward all of them. The autograd
functions pack it once a call, in the forward, and keep it for the
backward.
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
# else: the v2 kernels (#9/#10) and the v1 kernels (#7/#8).
launches = {"fwd": 0, "bwd": 0}
launches_v1 = {"fwd": 0, "bwd": 0}

_HALF_PI = float(np.float32(np.pi / 2.0))   # the TPU kernel's f32 phase
_MAX_DEPTH = 16                            # FM_MAX_DEPTH in the CUDA source
_BM = 64                                   # FM_BM: points per kernel block


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


def fused_mlp_pe_bwd_plain(weights, xd, g, dims: MLPDims,
                           acc_dtype=torch.float32) -> dict:
    """What the backward kernel computes (`_bwd_pe_kernel`): the forward
    recomputed with its roundings, then weight gradients only, for the
    cotangent g [P, 4+e], in `_weight_order` (shapes of the weights).

    Bias gradients are sums in `acc_dtype` over all P points; the JAX kernel
    rounds each block's sum of a bf16 gradient to bf16 (`fused_mlp.py:515`)
    before adding it, which this version does not copy."""
    r = _rounding(dims, acc_dtype)
    acts_in, zs, h_last, hv, vz, v = _forward_acts(
        weights, *_encodings(xd, dims), dims, acc_dtype)
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
    g_v = r(mm_nt(g_rgb, weights["rgb_w"]) * (vz > 0))
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
        g_z = r(g_h * (zs[i] > 0))
        d[f"tw{i}"], d[f"tb{i}"] = mm_tn(acts_in[i], g_z), colsum(g_z)
        if i > 0:
            g_h = mm_nt(g_z, weights[f"tw{i}"])
    return {n: d[n] for n in _weight_order(dims)}


def fused_mlp_bwd_plain(weights, x_enc, d_enc, g, dims: MLPDims,
                        acc_dtype=torch.float32):
    """What the v1 backward kernel computes (`_bwd_kernel`): the forward
    recomputed on the encodings, then every weight gradient and the input
    gradients dx [P, in_dim] (layer 0's input gradient plus the skip layer's
    encoding slice) and dd [P, dir_dim] (the view layer's direction slice),
    for the cotangent g [P, 4+e]. Returns (weight gradients in
    `_weight_order`, dx, dd).

    The rounding points are v1's, not v2's (`fused_mlp_pe_bwd_plain`): v1
    keeps the gradients g_v, g_feat and g_z in f32 and rounds them only as
    operands of a product, so its bias gradients are sums of the f32
    gradients (JAX `fused_mlp.py:172,177,184,208`), where v2 sums the
    bf16-rounded ones."""
    r = _rounding(dims, acc_dtype)
    acts_in, zs, h_last, hv, vz, v = _forward_acts(weights, x_enc, d_enc,
                                                   dims, acc_dtype)
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
    g_v = mm_nt(g_rgb, weights["rgb_w"]) * (vz > 0)
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
        g_z = g_h * (zs[i] > 0)
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


def _check_kernel_args(weights, inputs, dims: MLPDims, pre: bool):
    """Raise unless the kernels take `dims` and the inputs: xd [P, 8] (v2)
    or, with `pre`, the encodings (x_enc [P, 128], d_enc [P, 128]) (v1),
    each a contiguous float32 CUDA tensor with P a multiple of 64."""
    if dims.compute_dtype == "float32":
        raise NotImplementedError("compute_dtype='float32' has no kernel on "
                                  "the card yet; see ROADMAP.md B1a")
    # the one geometry chip_smoke.py's phases 6 and 11 hold against the plain
    # version: the reference's 8 x 256 with skip 4 and (v2, whose kernels
    # encode) 10 / 4 octaves
    geom = (dims.depth, dims.skip, dims.width, dims.view_width, dims.in_dim,
            dims.dir_dim) + (() if pre else (dims.multires,
                                            dims.multires_views))
    if geom != (8, 4, 256, 128, 128, 128, 10, 4)[:len(geom)]:
        raise NotImplementedError(
            f"the fused MLP kernels are verified at depth 8, skip 4, width "
            f"256, view width 128{'' if pre else ' and 10 / 4 octaves'} "
            f"only, got {dims}; see ROADMAP.md B1b")
    p = inputs[0].shape[0]
    width = (dims.in_dim, dims.dir_dim) if pre else (8,)
    for a, k in zip(inputs, width):
        # the v1 kernels read the encodings as float4
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
    if err:
        raise RuntimeError(f"{fn_name} launch failed: "
                           f"{lib.fm_error_string(err).decode()}")


def fwd_fn(weights, inputs, dims: MLPDims, *, pre: bool, ring=None):
    """Check the inputs and pack, once, what a forward launch on (xd,) (v2,
    `fm_fwd`, #9) or, with `pre`, on the encodings (x_enc, d_enc) (v1,
    `fm_fwd_pre`, #7) needs: a function that launches the kernel on those
    buffers and returns raw [P, 4+e] f32 (the same tensor each call).
    `ring`: `gather_ring`'s whole ring or its forward stages, packed here
    when None. Counts no launch, so it also times the kernel alone."""
    _check_kernel_args(weights, inputs, dims, pre)
    lib = _lib()
    if ring is None:
        ring = gather_ring(weights, dims, pre, forward=True)
    prm, bufs = _params(weights, dims, ring)
    out = torch.empty((inputs[0].shape[0], 4 + dims.out_extra),
                      dtype=torch.float32, device=inputs[0].device)
    stream = torch.cuda.current_stream(inputs[0].device).cuda_stream
    name = "fm_fwd_pre" if pre else "fm_fwd"
    launch, ins = getattr(lib, name), [a.data_ptr() for a in inputs]

    def run():
        _raise_on(lib, name, launch(ctypes.byref(prm), *ins, out.data_ptr(),
                                    out.shape[0], stream))
        return out

    run.keep = bufs     # what prm points into, alive as long as run
    return run


def _fwd_launch(weights, inputs, dims: MLPDims, *, pre: bool, ring=None):
    """One launch of the forward kernel (`fwd_fn`), counted: raw [P, 4+e]
    f32 (no autograd)."""
    # the bf16 buffers stay referenced until the launch is queued; the
    # caching allocator then reuses them in stream order
    out = fwd_fn(weights, inputs, dims, pre=pre, ring=ring)()
    (launches_v1 if pre else launches)["fwd"] += 1
    return out


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
                ring=None):
    """One launch of the backward (the recompute-and-backprop kernel, then
    the split-K weight-gradient kernel) on (xd,) (v2, `fm_bwd`, #10) or,
    with `pre`, on the encodings (x_enc, d_enc) (v1, `fm_bwd_pre`, #8),
    counted: (f32 weight gradients for the cotangent g [P, 4+e] in
    `_weight_order`, dx, dd), the input gradients [P, 128] f32 with `pre`
    and None without. `ring`: `gather_ring`'s, packed here when None. The
    sums of the blocks' and splits' partial gradients run in a fixed order
    (the note in the CUDA source), so launches on the same inputs are
    bit-equal."""
    c = _bwd_args(weights, inputs, g, dims, pre=pre, ring=ring)
    stream = torch.cuda.current_stream(inputs[0].device).cuda_stream
    args = c.args if pre else c.args[:3] + c.args[4:]    # fm_bwd: no d_enc
    name = "fm_bwd_pre" if pre else "fm_bwd"
    _raise_on(c.lib, name, getattr(c.lib, name)(*args, stream))
    (launches_v1 if pre else launches)["bwd"] += 1
    nout = 4 + dims.out_extra
    h0 = c.offs["rgb_b"]
    c.flat[h0:h0 + nout].copy_(c.head_b[:nout])
    if not pre:
        return c.grads, None, None
    n_bias = (dims.depth + 1) * dims.width + dims.view_width
    c.flat[:n_bias].copy_(c.bias64[:n_bias])
    return c.grads, c.dx, c.dd


def bwd_pass_fns(weights, inputs, g, dims: MLPDims, *, pre: bool):
    """For timing the backward's two kernels apart (`fm_bwd_pass`): two
    functions that launch, on one set of buffers, the recompute-and-backprop
    kernel and the weight-gradient kernel (which reduces what the first one
    wrote; call that one first), and the bytes of that scratch. Counts no
    launch; no result is read. Each pass includes its fixed-order sums."""
    c = _bwd_args(weights, inputs, g, dims, pre=pre)
    stream = torch.cuda.current_stream(inputs[0].device).cuda_stream
    scratch_bytes = sum(a.numel() * a.element_size() for a in c.scratch)

    def run(k):
        _raise_on(c.lib, "fm_bwd_pass",
                  c.lib.fm_bwd_pass(*c.args, int(pre), k, stream))

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
    """One launch of the v1 forward kernel (#7) on the encodings x_enc,
    d_enc [P, 128] f32: raw [P, 4+e] f32."""
    return _fwd_launch(weights, (x_enc, d_enc), dims, pre=True)


def fused_mlp_bwd_kernel(weights, x_enc, d_enc, g, dims: MLPDims):
    """One launch of the v1 backward (#8): (f32 weight gradients in
    `_weight_order`, dx [P, 128], dd [P, 128]) for the cotangent g."""
    return _bwd_launch(weights, (x_enc, d_enc), g, dims, pre=True)


class _FusedMLPPE(torch.autograd.Function):
    """Kernel forward and backward on CUDA tensors, the plain version on CPU
    tensors; the gradient flows to the weights only, as in the JAX custom
    VJP. On CUDA the forward packs the weight ring, which the backward
    reads too: the saved weights cannot change in between (autograd's
    version check)."""

    @staticmethod
    def forward(ctx, dims, xd, *ws):
        weights = dict(zip(_weight_order(dims), ws))
        ctx.dims = dims
        ctx.save_for_backward(xd, *ws)
        if not xd.is_cuda:
            return fused_mlp_pe_plain(weights, xd, dims)
        ctx.ring = gather_ring(weights, dims, pre=False)
        return _fwd_launch(weights, (xd,), dims, pre=False, ring=ctx.ring)

    @staticmethod
    def backward(ctx, g):
        xd, *ws = ctx.saved_tensors
        dims = ctx.dims
        weights = dict(zip(_weight_order(dims), ws))
        if xd.is_cuda:
            d, _, _ = _bwd_launch(weights, (xd,), g, dims, pre=False,
                                  ring=ctx.ring)
        else:
            d = fused_mlp_pe_bwd_plain(weights, xd, g, dims)
        return (None, None, *(d[n] for n in _weight_order(dims)))


def fused_mlp_pe(weights, xd, dims: MLPDims):
    """Fused encode + MLP: xd [P, 8] f32 (x, y, z, dx, dy, dz, 0, 0) ->
    raw [P, 4 + out_extra] f32, differentiable in `weights` only. On CUDA
    tensors P must be a multiple of 64."""
    return _FusedMLPPE.apply(dims, xd,
                             *(weights[n] for n in _weight_order(dims)))


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
    the JAX custom VJP. The weight ring is packed once, as in
    `_FusedMLPPE`."""

    @staticmethod
    def forward(ctx, dims, x_enc, d_enc, *ws):
        weights = dict(zip(_weight_order(dims), ws))
        ctx.dims = dims
        ctx.save_for_backward(x_enc, d_enc, *ws)
        if not x_enc.is_cuda:
            return fused_mlp_fwd_plain(weights, x_enc, d_enc, dims)
        ctx.ring = gather_ring(weights, dims, pre=True)
        return _fwd_launch(weights, (x_enc, d_enc), dims, pre=True,
                           ring=ctx.ring)

    @staticmethod
    def backward(ctx, g):
        x_enc, d_enc, *ws = ctx.saved_tensors
        dims = ctx.dims
        weights = dict(zip(_weight_order(dims), ws))
        if x_enc.is_cuda:
            d, dx, dd = _bwd_launch(weights, (x_enc, d_enc), g, dims,
                                    pre=True, ring=ctx.ring)
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
    return _FusedMLP.apply(dims, x_enc, d_enc,
                           *(weights[n] for n in _weight_order(dims)))


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
