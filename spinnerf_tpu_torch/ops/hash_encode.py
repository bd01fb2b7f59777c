"""Hash-grid encode from precomputed corner indices and weights: CUDA kernels
for the H100 and their plain PyTorch version.

Port of `spinnerf_tpu/ops/hash_encode.py`. The JAX module computes the
encode as one-hot MXU products against a lane-packed table (`packed_rows`,
`_pack`); that layout is the TPU's and is not carried over. The function is
the same: out[n, l, :] = sum_c w[l, c, n] * table[l, idx[l, c, n], :], and
its table gradient the scatter-add of w * g.

- `hash_encode_xla` is the plain version on any device;
- `hash_encode_mxu` launches the kernels of `csrc/hash_encode_idx.cu` on
  CUDA tensors (or raises) and takes the plain version on CPU tensors. It
  computes the f32 blend; the TPU kernel rounds the table and w * g to bf16.
  Under `torch.use_deterministic_algorithms(True)` the backward takes its
  fixed-order variant, whose result does not depend on the order of its
  sums (the note in the CUDA source).
  The windowed entry point `ops/hash_encode_win.py::hash_encode_win` goes
  through the same kernels;
- `hash_encode_ngp_fused` encodes points with the instant-NGP index
  (`corner_indices_weights_ngp`, ported from
  `spinnerf_tpu/models/hashgrid.py::HashGridEncoding.corner_indices_weights`):
  on CUDA tensors the same kernels rebuild each corner in registers from
  the points; on CPU tensors it is `hash_encode_xla` of the index.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from spinnerf_tpu_torch.ops import cuda_build

_MAX_LEVELS = 32        # HI_MAX_LEVELS in the CUDA source
_MAX_TABLE = 1 << 30
_PRIMES = (1, 2654435761, 805459861)
_P1_INT32 = _PRIMES[1] - (1 << 32)    # the bit pattern of p1 as an int32

# Kernel launches by the wrappers, counted where they launch and nowhere else.
# "fwd"/"bwd": corners from idx / w; "fwd_pts"/"bwd_pts": from the points;
# launches_det: the backward's fixed-order variants (`hi_bwd_fix`,
# `hi_bwd_pts_fix`).
launches = {"fwd": 0, "bwd": 0, "fwd_pts": 0, "bwd_pts": 0}
launches_det = {"bwd": 0, "bwd_pts": 0}


def recommended_impl(log2_table_size: int, on_tpu: bool) -> str:
    """The JAX package's choice of encode: on a TPU the windowed kernels for
    any table over one 4096-entry window (log2_table_size >= 13), the dense
    one-hot kernels below; "xla" elsewhere. The JAX function asks JAX for
    the device; here the caller says whether to take the TPU's choice. The
    port's `auto` always takes it (`models/hashgrid.py`); the `on_tpu=False`
    branch is kept so that the function answers as its JAX counterpart does
    for every argument."""
    if not on_tpu:
        return "xla"
    return "win" if log2_table_size >= 13 else "mxu"


def hash_encode_xla(table, idx, weights):
    """Plain gather + trilinear blend on any device: table [L, T, F], idx and
    weights [L, 8, N] -> [N, L, F] in the table's dtype. Differentiable wrt
    the table through autograd (an index_put accumulate)."""
    l, t, f = table.shape
    lvl = torch.arange(l, device=table.device)[:, None, None]
    feats = table[lvl, idx.long()]                          # [L, 8, N, F]
    out = torch.sum(feats * weights[..., None].to(feats.dtype), dim=1)
    return out.permute(1, 0, 2)


def corner_indices_weights_ngp(x, resolutions, t: int):
    """The instant-NGP index of points x [N, 3] in [0, 1] at the levels'
    `resolutions` for table size t = 2^k: (idx [L, 8, N] int32, w [L, 8, N]
    f32), as `models/hashgrid.py::HashGridEncoding.corner_indices_weights`
    documents it (dense levels first: resolutions grow with the level)."""
    res = tuple(resolutions)
    n = x.shape[0]
    scales = torch.tensor(res, dtype=x.dtype, device=x.device)
    xs = scales[:, None, None] * x.T[None]               # [L, 3, N]
    x0f = torch.floor(xs)
    frac = xs - x0f
    x0 = x0f.to(torch.int32)
    # per axis: [L, 2, N] for the offsets 0 and 1
    cx, cy, cz = (torch.stack([x0[:, a], x0[:, a] + 1], dim=1)
                  for a in range(3))
    nd = sum(level_is_dense(r, t) for r in res)
    parts = []
    if nd:
        r1 = torch.tensor([r + 1 for r in res[:nd]], dtype=torch.int32,
                          device=x.device)[:, None, None]
        parts.append((cx[:nd] * (r1 * r1))[:, :, None, None]
                     + (cy[:nd] * r1)[:, None, :, None]
                     + cz[:nd][:, None, None, :])
    if nd < len(res):
        parts.append(cx[nd:][:, :, None, None]
                     ^ (cy[nd:] * _P1_INT32)[:, None, :, None]
                     ^ (cz[nd:] * _PRIMES[2])[:, None, None, :])
    # corners in the order ci = 4i + 2j + k: [L, 2, 2, 2, N] -> [L, 8, N]
    idx = torch.cat(parts) if len(parts) > 1 else parts[0]
    idx = idx.bitwise_and_(t - 1).reshape(-1, 8, n)     # % T, T = 2^k
    wx, wy, wz = (torch.stack([1.0 - frac[:, a], frac[:, a]], dim=1)
                  for a in range(3))
    w = ((wx[:, :, None, None] * wy[:, None, :, None])
         * wz[:, None, None, :]).reshape(-1, 8, n)
    return idx, w


def level_is_dense(r: int, t: int) -> bool:
    """The instant-NGP index is the linear cell index where the level's
    (r+1)^3 corner grid fits the table, else the XOR-prime hash."""
    return (r + 1) ** 3 <= t


# -----------------------------------------------------------------------------
# the backward's plan
# -----------------------------------------------------------------------------

# The regimes and limits of csrc/hash_encode_idx.cu, mirrored here.
DIRECT, STAGED, MAP = 0, 1, 2
LEVEL_CAP = 8192        # HI_LEVEL_CAP: largest level row staged whole
MAP_CAP = 8192          # HI_MAP_CAP: most map slots
STAGED_POINTS = 4096    # points a staged block takes
IDX_MAP_POINTS = 1024   # idx mode: points a map block takes (8 K slots)
# Points mode, from the census of the reference's scenes (PERF.md section
# 6): a level is hot, and takes the shared map, while its cells are coarse
# enough that a block's points share entries (resolution <= 199: a
# 1,024-point block touches at most ~870 entries, each ~10-190 times; at
# 374 the warp's pre-sum already merges most and the map costs more than it
# saves).
HOT_RES = 199
MAP_POINTS = 1024       # points a hot block takes
MAP_SLOTS = 2048        # its map (24 KB: 8 blocks an SM fit; load <= 0.43)
DIRECT_POINTS = 1024    # points a direct block takes (4 a thread)


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How the backward kernel takes each level: its regime (DIRECT,
    STAGED or MAP), the points one block of it takes, and its staged
    entries (STAGED) or map slots (MAP; 0 for DIRECT)."""
    regime: tuple
    points: tuple
    size: tuple

    def c_arrays(self):
        """The plan as the C entry points take it: three int arrays."""
        return tuple((ctypes.c_int * len(v))(*v)
                     for v in (self.regime, self.points, self.size))


@functools.lru_cache(maxsize=64)
def bwd_plan(resolutions, t: int) -> BwdPlan:
    """The backward's plan for a table of t entries a level, from one entry
    of `resolutions` (a tuple) a level: the level's resolution in points
    mode, None in idx mode (its indices say nothing of the level's cells).
    Tables of an even number of entries up to LEVEL_CAP are staged whole.
    In the others the hot levels take the shared map (points mode:
    resolution <= HOT_RES; idx mode: every level) and the rest direct
    reductions. The plan depends on the geometry alone, never on the data,
    and changes the speed, never the result."""
    levels = len(resolutions)
    if t <= LEVEL_CAP and t % 2 == 0:
        return BwdPlan((STAGED,) * levels, (STAGED_POINTS,) * levels,
                       (t,) * levels)

    def level(r):
        if r is None:
            return MAP, IDX_MAP_POINTS, MAP_CAP
        if r <= HOT_RES:
            return MAP, MAP_POINTS, MAP_SLOTS
        return DIRECT, DIRECT_POINTS, 0

    return BwdPlan(*zip(*(level(r) for r in resolutions)))


# -----------------------------------------------------------------------------
# the CUDA kernels
# -----------------------------------------------------------------------------

def _lib():
    lib = cuda_build.load("hash_encode_idx")
    if not getattr(lib, "_hi_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.hi_fwd.argtypes = [p] * 4 + [i, i, ll, p]
        lib.hi_fwd_pts.argtypes = [p] * 5 + [i, i, ll, p]
        lib.hi_bwd.argtypes = [p] * 4 + [i, i, ll] + [p] * 4
        lib.hi_bwd_pts.argtypes = [p] * 5 + [i, i, ll] + [p] * 4
        lib.hi_bwd_fix.argtypes = [p] * 4 + [i, i, ll] + [p] * 4 + [ll, p]
        lib.hi_bwd_pts_fix.argtypes = [p] * 5 + [i, i, ll] + [p] * 4 + [ll, p]
        for fn in (lib.hi_fwd, lib.hi_fwd_pts, lib.hi_bwd, lib.hi_bwd_pts,
                   lib.hi_bwd_fix, lib.hi_bwd_pts_fix):
            fn.restype = ctypes.c_int
        lib.hi_error_string.argtypes = [ctypes.c_int]
        lib.hi_error_string.restype = ctypes.c_char_p
        lib._hi_typed = True
    return lib


def _check_corners(idx, w, levels: int, device):
    """Validate the [L, 8, N] corner inputs: int32 indices, f32 weights,
    contiguous, on the table's CUDA device."""
    if idx.device != device or w.device != device or device.type != "cuda":
        raise ValueError("kernel inputs must be CUDA tensors on one device")
    if idx.ndim != 3 or idx.shape[:2] != (levels, 8) or w.shape != idx.shape:
        raise ValueError(f"idx and w must be [{levels}, 8, N], got "
                         f"{tuple(idx.shape)} and {tuple(w.shape)}")
    if idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError(f"idx must be contiguous int32, got {idx.dtype}")
    if w.dtype != torch.float32 or not w.is_contiguous():
        raise ValueError(f"w must be contiguous float32, got {w.dtype}")


def _check_points(x, levels: int, resolutions, device):
    """Validate points mode's inputs: x a contiguous f32 [N, 3] on the
    table's CUDA device, one resolution a level."""
    if x.device != device or device.type != "cuda":
        raise ValueError("kernel inputs must be CUDA tensors on one device")
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != 3 \
            or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous float32 [N, 3], got "
                         f"{x.dtype} {tuple(x.shape)}")
    if len(resolutions) != levels:
        raise ValueError(f"{len(resolutions)} resolutions for {levels} "
                         f"levels")


def _check_table_shape(shape, points_mode=False):
    l, t, f = shape
    if f != 2:
        raise NotImplementedError(
            f"the index-gather kernels take features=2, got {f}; other "
            f"feature counts run only on the CPU (ROADMAP.md B1d)")
    if not 0 < l <= _MAX_LEVELS or not 0 < t <= _MAX_TABLE:
        raise ValueError(f"table [{l}, {t}, 2]: at most {_MAX_LEVELS} levels "
                         f"and 2^30 entries")
    if points_mode and (t & (t - 1) or t < 2):
        raise ValueError(f"the instant-NGP index takes a power-of-two table "
                         f"of at least 2 entries, got {t}")


def _geometry(resolutions, t: int):
    """Points mode's per-level (resolution, dense flag) as two int arrays."""
    res = [int(r) for r in resolutions]
    return ((ctypes.c_int * len(res))(*res),
            (ctypes.c_int * len(res))(*[int(level_is_dense(r, t))
                                        for r in res]))


def _call(fn_name: str, src, *args):
    """Launch `fn_name` on the current stream; raise on a launch error."""
    lib = _lib()
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = getattr(lib, fn_name)(*args, stream)
    if err:
        raise RuntimeError(f"{fn_name} launch failed: "
                           f"{lib.hi_error_string(err).decode()}")


def _cotangent(g, n: int, levels: int):
    if g.numel() != n * levels * 2:
        raise ValueError(f"cotangent must hold [{n}, {levels}, 2], got "
                         f"{tuple(g.shape)}")
    return g.to(torch.float32).contiguous()


def fix_bytes(table_shape) -> int:
    """Scratch of the fixed-order backward: the maxima (16 bytes), then an
    int64 pair (16 bytes) a table entry."""
    l, t, _ = table_shape
    return 16 + 16 * l * t


def _bwd_call(name, g, args_for, table_shape, deterministic):
    """Launch the backward `name` (or, `deterministic`, its fixed-order
    variant `name`_fix with its scratch) into a new table gradient, which
    the atomic kernel adds to (zeroed here) and the variant writes whole;
    args_for(dtable) gives the C arguments before the stream. Counts the
    launch."""
    key = "bwd_pts" if name == "hi_bwd_pts" else "bwd"
    if deterministic:
        dtable = torch.empty(table_shape, dtype=torch.float32, device=g.device)
        nbytes = fix_bytes(table_shape)
        fix = torch.empty(nbytes // 8, dtype=torch.int64, device=g.device)
        _call(name + "_fix", g, *args_for(dtable), fix.data_ptr(), nbytes)
        launches_det[key] += 1
    else:
        dtable = torch.zeros(table_shape, dtype=torch.float32,
                             device=g.device)
        _call(name, g, *args_for(dtable))
        launches[key] += 1
    return dtable


def _check_table(table):
    if table.dtype != torch.float32 or not table.is_contiguous():
        raise ValueError(f"table must be contiguous float32, got "
                         f"{table.dtype}")


def hash_encode_idx_fwd_kernel(table, idx, w):
    """One launch of the forward kernel, corners from idx / w: [N, L, 2]
    f32 (no autograd)."""
    _check_table_shape(table.shape)
    _check_table(table)
    l, t, _ = table.shape
    _check_corners(idx, w, l, table.device)
    out = torch.empty((idx.shape[2], l, 2), dtype=torch.float32,
                      device=table.device)
    _call("hi_fwd", table, table.data_ptr(), idx.data_ptr(), w.data_ptr(),
          out.data_ptr(), idx.shape[2], l, t)
    launches["fwd"] += 1
    return out


def hash_encode_idx_bwd_kernel(g, idx, w, table_shape, deterministic=None):
    """One launch of the backward, corners from idx / w: the [L, T, 2] f32
    table gradient for cotangent g [N, L, 2] (any float dtype; [N, L*2] is
    the same memory). `deterministic` (default:
    `torch.are_deterministic_algorithms_enabled()`) takes the fixed-order
    variant."""
    if deterministic is None:
        deterministic = torch.are_deterministic_algorithms_enabled()
    _check_table_shape(table_shape)
    l, t, _ = table_shape
    n = idx.shape[2]
    _check_corners(idx, w, l, g.device)
    g = _cotangent(g, n, l)
    plan = bwd_plan((None,) * l, t).c_arrays()
    return _bwd_call("hi_bwd", g, lambda d: (
        g.data_ptr(), idx.data_ptr(), w.data_ptr(), d.data_ptr(), n, l, t,
        *plan), table_shape, deterministic)


def hash_encode_ngp_fwd_kernel(table, x, resolutions):
    """One launch of the forward kernel, corners rebuilt from the points x
    [N, 3] with the instant-NGP index: [N, L, 2] f32 (no autograd)."""
    _check_table_shape(table.shape, points_mode=True)
    _check_table(table)
    l, t, _ = table.shape
    _check_points(x, l, resolutions, table.device)
    out = torch.empty((x.shape[0], l, 2), dtype=torch.float32,
                      device=table.device)
    _call("hi_fwd_pts", table, table.data_ptr(), x.data_ptr(),
          *_geometry(resolutions, t), out.data_ptr(), x.shape[0], l, t)
    launches["fwd_pts"] += 1
    return out


def hash_encode_ngp_bwd_kernel(g, x, resolutions, table_shape,
                               deterministic=None):
    """One launch of the backward, corners rebuilt from the points x: the
    [L, T, 2] f32 table gradient for cotangent g [N, L, 2] (any float
    dtype; [N, L*2] is the same memory). `deterministic` (default:
    `torch.are_deterministic_algorithms_enabled()`) takes the fixed-order
    variant."""
    if deterministic is None:
        deterministic = torch.are_deterministic_algorithms_enabled()
    _check_table_shape(table_shape, points_mode=True)
    l, t, _ = table_shape
    n = x.shape[0]
    _check_points(x, l, resolutions, g.device)
    g = _cotangent(g, n, l)
    plan = bwd_plan(tuple(int(r) for r in resolutions), t).c_arrays()
    geom = _geometry(resolutions, t)
    return _bwd_call("hi_bwd_pts", g, lambda d: (
        g.data_ptr(), x.data_ptr(), *geom, d.data_ptr(), n, l, t, *plan),
        table_shape, deterministic)


class _HashEncodeIdx(torch.autograd.Function):
    """Kernel forward and backward; the gradient flows to the table only
    (corner indices and weights are not trainable), as in the JAX custom
    VJP."""

    @staticmethod
    def forward(ctx, table, idx, w):
        ctx.save_for_backward(idx, w)
        ctx.table_shape = tuple(table.shape)
        return hash_encode_idx_fwd_kernel(table, idx, w)

    @staticmethod
    def backward(ctx, g):
        idx, w = ctx.saved_tensors
        dtable = hash_encode_idx_bwd_kernel(g, idx, w, ctx.table_shape)
        return dtable, None, None


def hash_encode_idx(table, idx, weights):
    """The kernels behind an autograd Function: table [L, T, 2] f32 on a CUDA
    device, idx [L, 8, N] (int32; int64 is converted) and weights [L, 8, N]
    -> [N, L, 2] f32, differentiable wrt the table."""
    return _HashEncodeIdx.apply(table, idx.to(torch.int32).contiguous(),
                                weights.to(torch.float32).contiguous())


def hash_encode_mxu(table, idx, weights):
    """Multi-level hash-grid encode: table [L, T, F] f32, idx/weights
    [L, 8, N] -> [N, L, F] f32, differentiable wrt the table.

    CUDA tensors launch the kernels (or raise, as for F != 2); CPU tensors
    take the plain version `hash_encode_xla`."""
    if not table.is_cuda:
        return hash_encode_xla(table, idx, weights)
    return hash_encode_idx(table, idx, weights)


class _HashEncodeNgp(torch.autograd.Function):
    """Points-mode kernels forward and backward; the gradient flows to the
    table only. Only the points are kept for the backward."""

    @staticmethod
    def forward(ctx, table, x, resolutions):
        ctx.save_for_backward(x)
        ctx.resolutions = resolutions
        ctx.table_shape = tuple(table.shape)
        return hash_encode_ngp_fwd_kernel(table, x, resolutions)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        dtable = hash_encode_ngp_bwd_kernel(g, x, ctx.resolutions,
                                            ctx.table_shape)
        return dtable, None, None


def hash_encode_ngp_fused(table, x, resolutions):
    """Multi-level hash-grid encode of points x [N, 3] in [0, 1] with the
    instant-NGP index: table [L, T, F] f32 -> [N, L, F] f32, differentiable
    wrt the table.

    CUDA tensors launch the points-mode kernels (or raise, as for F != 2);
    CPU tensors take the plain version, `hash_encode_xla` of
    `corner_indices_weights_ngp`."""
    resolutions = tuple(int(r) for r in resolutions)
    if not table.is_cuda:
        return hash_encode_xla(table, *corner_indices_weights_ngp(
            x, resolutions, table.shape[1]))
    return _HashEncodeNgp.apply(table, x.to(torch.float32).contiguous(),
                                resolutions)
