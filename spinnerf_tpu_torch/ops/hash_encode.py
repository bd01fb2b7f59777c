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

The windowed entry point `ops/hash_encode_win.py::hash_encode_win` goes
through the same kernels.
"""
from __future__ import annotations

import ctypes

import torch

from spinnerf_tpu_torch.ops import cuda_build

_MAX_LEVELS = 32        # HI_MAX_LEVELS in the CUDA source
_MAX_TABLE = 1 << 30

# Kernel launches by the wrappers, counted where they launch and nowhere else.
launches = {"fwd": 0, "bwd": 0}


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


# -----------------------------------------------------------------------------
# the CUDA kernels
# -----------------------------------------------------------------------------

def _lib():
    lib = cuda_build.load("hash_encode_idx")
    if not getattr(lib, "_hi_typed", False):
        args = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                        ctypes.c_longlong]
        lib.hi_fwd.argtypes = args + [ctypes.c_void_p]
        lib.hi_bwd.argtypes = args + [ctypes.c_int, ctypes.c_void_p]
        for fn in (lib.hi_fwd, lib.hi_bwd):
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


def _check_table_shape(shape):
    l, t, f = shape
    if f != 2:
        raise NotImplementedError(
            f"the index-gather kernels take features=2, got {f}; other "
            f"feature counts run only on the CPU (ROADMAP.md queue A)")
    if not 0 < l <= _MAX_LEVELS or not 0 < t <= _MAX_TABLE:
        raise ValueError(f"table [{l}, {t}, 2]: at most {_MAX_LEVELS} levels "
                         f"and 2^30 entries")


def _launch(fn_name: str, src, idx, w, dst, levels: int, t: int, *extra):
    lib = _lib()
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = getattr(lib, fn_name)(src.data_ptr(), idx.data_ptr(), w.data_ptr(),
                                dst.data_ptr(), idx.shape[2], levels, t,
                                *extra, stream)
    if err:
        raise RuntimeError(f"{fn_name} launch failed: "
                           f"{lib.hi_error_string(err).decode()}")


def hash_encode_idx_fwd_kernel(table, idx, w):
    """One launch of the forward kernel: [N, L, 2] f32 (no autograd)."""
    _check_table_shape(table.shape)
    if table.dtype != torch.float32 or not table.is_contiguous():
        raise ValueError(f"table must be contiguous float32, got "
                         f"{table.dtype}")
    l, t, _ = table.shape
    _check_corners(idx, w, l, table.device)
    out = torch.empty((idx.shape[2], l, 2), dtype=torch.float32,
                      device=table.device)
    _launch("hi_fwd", table, idx, w, out, l, t)
    launches["fwd"] += 1
    return out


# The backward's designs (`variant` of `hi_bwd`): the default ("auto": the
# whole level staged in shared memory up to 2^13 entries, else the shared
# map), the map at any size, and global atomics alone. The last two are
# there to be timed against the first.
BWD_VARIANTS = {"auto": 0, "map": 1, "atomic": 2}


def hash_encode_idx_bwd_kernel(g, idx, w, table_shape, variant="auto"):
    """One launch of the backward: the [L, T, 2] f32 table gradient for
    cotangent g [N, L, 2] (any float dtype; [N, L*2] is the same memory)."""
    _check_table_shape(table_shape)
    l, t, _ = table_shape
    n = idx.shape[2]
    if g.numel() != n * l * 2:
        raise ValueError(f"cotangent must hold [{n}, {l}, 2], got "
                         f"{tuple(g.shape)}")
    _check_corners(idx, w, l, g.device)
    g = g.to(torch.float32).contiguous()
    dtable = torch.zeros(table_shape, dtype=torch.float32, device=g.device)
    _launch("hi_bwd", g, idx, w, dtable, l, t, BWD_VARIANTS[variant])
    launches["bwd"] += 1
    return dtable


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
