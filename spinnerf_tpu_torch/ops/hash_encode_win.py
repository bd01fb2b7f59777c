"""Hash-grid encode with the windowed index function: CUDA kernels for the
H100 and their plain PyTorch version.

Port of `spinnerf_tpu/ops/hash_encode_win.py`. The index function is
ported exactly (`corner_indices_weights_win`):

- DENSE levels (a calibrated per-level box (o, e) whose corner codes fit
  `box_dense_ok`) use shifted morton: idx = morton27(clip(cell - o, 0, e)
  + corner), injective and global;
- FINE levels use the Z-CDF page hash: seg = #(page_bounds <= zkey27(point))
  - 1 and idx = seg * PAGE_ENTRIES + (xor_prime_hash(cell) & (PAGE_ENTRIES-1)).

What the JAX module adds only for the TPU is not ported: the Z-sort (results
do not depend on point order), the two-page window with its clamp aliasing
and page packing, and the compare-reduce page lookup (here
`torch.searchsorted`; the forward kernel searches the bounds, a part of
them staged in shared memory). The kernels (`csrc/hash_encode_win.cu`)
gather directly, so they compute
`hash_encode_exact(table, *corner_indices_weights_win(...))` at any point
count, for tables of 2^10 to 2^25 entries (JAX's windowed range). Under
`torch.use_deterministic_algorithms(True)` the backward takes its
fixed-order variant, whose result does not depend on the order of its sums.

Layout: points are rows, `x` is [N, 3] in [0, 1] (the JAX functions take
the coords-major [3, N] transpose).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from spinnerf_tpu_torch.ops import cuda_build
from spinnerf_tpu_torch.ops import hash_encode as he

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF

PAGE_ENTRIES = 1024
WINDOW_ENTRIES = 2 * PAGE_ENTRIES
# Max entry count of a calibrated dense box (the JAX package's window-span
# bound; kept because it is part of the index semantics).
DENSE_BOX_CAP = 32 * PAGE_ENTRIES
_MAX_LEVELS = 32        # HE_MAX_LEVELS in the CUDA source
# HF_MAX_SEGS: T <= 2^25, the range JAX's windowed kernel states
# (`spinnerf_tpu/ops/hash_encode_win.py::_pack_pages`: page ids fit 15 bits)
MAX_SEGMENTS = 32768

# Kernel launches by the wrapper, counted where it launches and nowhere else;
# launches_det: the backward's fixed-order variant (`he_win_bwd_fix`).
launches = {"fwd": 0, "bwd": 0}
launches_det = {"bwd": 0}


# -----------------------------------------------------------------------------
# Morton codes — uint32 arithmetic held in int64 tensors
# -----------------------------------------------------------------------------

def _spread9(v):
    """Spread the low 9 bits of v so they occupy every 3rd bit (27 bits)."""
    v = v & 0x1FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton27(cx, cy, cz):
    """27-bit Morton interleave of the low 9 bits of each axis."""
    return _spread9(cx) | (_spread9(cy) << 1) | (_spread9(cz) << 2)


def zkey27(x):
    """[N] int64 Z-order key of each point on the fixed 512^3 partition grid
    (morton27 of floor(x*512)). x: [N, 3] in [0, 1]."""
    rc = torch.clamp((x * 512.0).to(torch.int64), 0, 511)
    return morton27(rc[:, 0], rc[:, 1], rc[:, 2])


# -----------------------------------------------------------------------------
# index semantics: Z-CDF page bounds and shifted-morton dense boxes
# -----------------------------------------------------------------------------

def n_segments(t: int):
    return t // PAGE_ENTRIES


def uniform_bounds(t: int):
    """Equal Z-volume split of the 2^27 key space over t//PAGE_ENTRIES
    segments — the uncalibrated default."""
    n = n_segments(t)
    step = (1 << 27) // n
    return tuple(k * step for k in range(n))


def normalize_bounds(t: int, page_bounds):
    """Validated Z-CDF segment boundaries: a sorted tuple of t//PAGE_ENTRIES
    int keys in [0, 2^27), first 0. None -> `uniform_bounds`."""
    if page_bounds is None:
        return uniform_bounds(t)
    b = tuple(int(v) for v in page_bounds)
    if len(b) != n_segments(t):
        raise ValueError(f"page_bounds must have {n_segments(t)} entries, "
                         f"got {len(b)}")
    if b[0] != 0:
        raise ValueError("page_bounds[0] must be 0")
    if any(lo > hi for lo, hi in zip(b, b[1:])) or b[-1] >= (1 << 27):
        raise ValueError("page_bounds must be sorted and < 2^27")
    return b


def bounds_tensor(t: int, page_bounds, device=None):
    """`normalize_bounds` as an int64 tensor (what `page_lookup` searches)."""
    return torch.tensor(normalize_bounds(t, page_bounds), dtype=torch.int64,
                        device=device)


def page_lookup(z27, t: int, page_bounds=None):
    """(base [N] int64, capmask [N] int64) for per-point Z-keys: base =
    PAGE_ENTRIES * (#bounds <= key - 1). `page_bounds` is a tuple (or None
    for uniform bounds) or a tensor from `bounds_tensor`. searchsorted with
    right=True counts repeated bounds as the JAX compare-reduce does."""
    if not torch.is_tensor(page_bounds):
        page_bounds = bounds_tensor(t, page_bounds, z27.device)
    page = torch.searchsorted(page_bounds, z27.to(torch.int64), right=True) - 1
    base = page * PAGE_ENTRIES
    return base, torch.full_like(base, PAGE_ENTRIES - 1)


def box_morton_span(e) -> int:
    """Upper bound (exclusive) of shifted-morton corner codes for a box with
    per-axis cell extents e: corners reach e_a + 1."""
    bits = max(int(np.ceil(np.log2(int(a) + 2))) for a in e)
    return 1 << (3 * bits)


def box_dense_ok(e, t: int, cap: int = DENSE_BOX_CAP) -> bool:
    """A box qualifies for the injective shifted-morton regime when its corner
    codes fit the level's table row, fit `cap`, and fit morton27's 9-bit
    coordinates."""
    return (box_morton_span(e) <= min(t, cap)
            and max(int(a) for a in e) + 1 <= 511)


def default_dense_box(resolutions, t: int):
    """Uncalibrated dense boxes: the whole grid where its corner codes fit one
    2048-entry window (res <= 7); None (page hash) elsewhere."""
    out = []
    for r in resolutions:
        e = (r - 1, r - 1, r - 1)
        out.append(((0, 0, 0) + e)
                   if box_dense_ok(e, t, cap=WINDOW_ENTRIES) else None)
    return tuple(out)


def normalize_dense_box(resolutions, t: int, dense_box):
    """Validated per-level dense boxes: one entry per level, None (page-hash
    regime) or 6 ints (ox, oy, oz, ex, ey, ez). None for the whole argument
    selects `default_dense_box`."""
    if dense_box is None:
        return default_dense_box(resolutions, t)
    if len(dense_box) != len(resolutions):
        raise ValueError(f"dense_box must have {len(resolutions)} entries, "
                         f"got {len(dense_box)}")
    out = []
    for r, box in zip(resolutions, dense_box):
        if box is None:
            out.append(None)
            continue
        o, e = [int(v) for v in box[:3]], [int(v) for v in box[3:]]
        if len(box) != 6 or min(o) < 0 or min(e) < 0:
            raise ValueError(f"dense_box entry must be 6 ints >= 0: {box}")
        if any(oa + ea > r - 1 for oa, ea in zip(o, e)):
            raise ValueError(f"dense_box {box} exceeds the res-{r} grid")
        if not box_dense_ok(e, t):
            raise ValueError(f"dense_box {box} does not qualify for the "
                             f"dense regime at table size {t}")
        out.append(tuple(o) + tuple(e))
    return tuple(out)


def level_scalars(resolutions, t: int, dense_box):
    """[L][8] ints per level: (resolution, dense flag, box origin ox/oy/oz,
    box extents ex/ey/ez) of the normalized dense boxes — the kernels'
    per-level row (`_res_scalars` in the JAX module)."""
    rows = []
    for r, box in zip(resolutions, normalize_dense_box(resolutions, t,
                                                       dense_box)):
        b = box if box is not None else (0, 0, 0, 0, 0, 0)
        rows.append([int(r), int(box is not None), *[int(v) for v in b]])
    return rows


# -----------------------------------------------------------------------------
# the plain version
# -----------------------------------------------------------------------------

def corner_indices_weights_win(x, resolutions, t: int, page_bounds=None,
                               dense_box=None):
    """(idx [L, 8, N] int64, w [L, 8, N] f32) of the 8 cell corners of each
    point [N, 3] in [0, 1] at every level, with the two-regime index of the
    module docstring. Corner ci takes the +1 cell on x, y, z where bits 2, 1,
    0 of ci are set. f32 operations round in the JAX function's order, and
    uint32 products wrap (int64 arithmetic masked to 32 bits)."""
    if t & (t - 1):
        raise ValueError("table size must be a power of two")
    dense_box = normalize_dense_box(resolutions, t, dense_box)
    base, capm = page_lookup(zkey27(x), t, page_bounds)
    idx_l, w_l = [], []
    for r, box in zip(resolutions, dense_box):
        xs = x * float(r)                                   # [N, 3] f32
        # clamp to the grid's last cell: a boundary point x == 1.0 lands in
        # cell r-1 with frac 1
        x0f = torch.clamp(torch.floor(xs), max=float(r) - 1.0)
        frac = xs - x0f
        x0 = x0f.to(torch.int64)
        fr = [(1.0 - frac[:, a], frac[:, a]) for a in range(3)]
        if box is not None:
            cs = [torch.clamp(x0f[:, a] - float(box[a]), 0.0, float(box[3 + a]))
                  .to(torch.int64) for a in range(3)]
            sp = [[_spread9(cs[a] + d) << a for a in range(3)] for d in (0, 1)]
        idx_c, w_c = [], []
        for ci in range(8):
            i, j, k = (ci >> 2) & 1, (ci >> 1) & 1, ci & 1
            if box is not None:
                idx_c.append(sp[i][0] | sp[j][1] | sp[k][2])
            else:
                cx = x0[:, 0] + i
                cy = x0[:, 1] + j
                cz = x0[:, 2] + k
                h = cx ^ ((cy * _PRIMES[1]) & _U32) ^ ((cz * _PRIMES[2]) & _U32)
                idx_c.append(base + (h & capm))
            w_c.append(fr[0][i] * fr[1][j] * fr[2][k])
        idx_l.append(torch.stack(idx_c))
        w_l.append(torch.stack(w_c))
    return torch.stack(idx_l), torch.stack(w_l)


def hash_encode_exact(table, idx, weights):
    """Plain gather + trilinear blend: table [L, T, F], idx/weights
    [L, 8, N] -> [N, L*F], level-major columns (`hash_encode_xla`'s
    [N, L, F] flattened). Differentiable wrt table through autograd."""
    return he.hash_encode_xla(table, idx, weights).reshape(idx.shape[2], -1)


def hash_encode_plain(table, x, resolutions, page_bounds=None,
                      dense_box=None):
    """The kernels' plain PyTorch version on any device: [N, L*F]."""
    idx, w = corner_indices_weights_win(x, resolutions, table.shape[1],
                                        page_bounds, dense_box)
    return hash_encode_exact(table, idx, w)


# -----------------------------------------------------------------------------
# the CUDA kernels
# -----------------------------------------------------------------------------

# The encode's schedule: compile-time constants of csrc/hash_encode_win.cu,
# mirrored here to plan the launches and size their scratch.
CHUNK_POINTS = 1024     # HB_CHUNK: points of one segment a chunk holds
DENSE_SMEM_SPAN = 4096  # HB_DENSE_SPAN: largest span one block sums (32 KB)
WIDE_SPAN = DENSE_BOX_CAP   # HB_WIDE_SPAN: summed across a cluster of
CLUSTER_BLOCKS = 4          # HB_CLUSTER blocks, a quarter each
_SMS = 132              # the H100's multiprocessors: the dense grids fill them


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How `he_win_bwd` runs the table gradient of N points: per level the
    regime's span (0: paged, its corners in the point's 1024-entry page;
    else the dense box's morton span), the levels of each kernel, the
    partial sums per dense level (`dense_parts` blocks per level of span <=
    DENSE_SMEM_SPAN, `wide_parts` clusters per level of span WIDE_SPAN),
    and the scratch sizes: `work_ints` for the forward's sort, which the
    backward reads, `partial_entries` for the dense levels' partial sums
    (8 bytes an entry, 16 in the fixed-order variant), and that variant's
    `fix_bytes`: max |g| (16 bytes), then an int64 page (1024 x 16 bytes)
    a paged level of each segment that can be split (`split_entries` in
    all)."""
    spans: tuple
    paged: tuple
    dense: tuple
    wide: tuple
    dense_parts: int
    wide_parts: int
    work_ints: int
    partial_entries: int
    split_entries: int
    fix_bytes: int


def bwd_plan(rows, n: int, t: int) -> BwdPlan:
    """The launch plan of the backward for level rows (`level_scalars`), N
    points and table size t, as the CUDA source expects it (cached: the
    trainer asks for the same plan twice a step)."""
    return _bwd_plan(tuple(tuple(int(v) for v in r) for r in rows), int(n),
                     int(t))


@functools.lru_cache(maxsize=64)
def _bwd_plan(rows, n, t):
    spans = tuple(box_morton_span(r[5:8]) if r[1] else 0 for r in rows)
    paged = tuple(l for l, s in enumerate(spans) if s == 0)
    dense = tuple(l for l, s in enumerate(spans) if 0 < s <= DENSE_SMEM_SPAN)
    wide = tuple(l for l, s in enumerate(spans) if s > DENSE_SMEM_SPAN)
    if any(spans[l] != WIDE_SPAN for l in wide) or max(spans) > t:
        raise ValueError(f"dense spans {spans} do not fit table size {t}")
    # enough blocks to fill the card (4 dense blocks or 2 cluster blocks an
    # SM), each at least 2048 (dense) or 1024 (cluster) points
    dense_parts = max(1, min(-(-4 * _SMS // max(len(dense), 1)),
                             -(-n // 2048)))
    wide_parts = max(1, min(-(-2 * _SMS // (CLUSTER_BLOCKS
                                           * max(len(wide), 1))),
                            -(-n // (1024 * CLUSTER_BLOCKS))))
    n_seg = n_segments(t)
    max_chunks = -(-n // CHUNK_POINTS) + n_seg
    max_split = min(n_seg, n // (CHUNK_POINTS + 1))
    split_entries = max_split * len(paged) * PAGE_ENTRIES
    return BwdPlan(
        spans=spans, paged=paged, dense=dense, wide=wide,
        dense_parts=dense_parts, wide_parts=wide_parts,
        work_ints=4 * max_chunks + 2 * n_seg + 4 + max_split + n,
        partial_entries=(dense_parts * sum(spans[l] for l in dense)
                         + wide_parts * WIDE_SPAN * len(wide)),
        split_entries=split_entries, fix_bytes=16 + 16 * split_entries)


def _lib():
    lib = cuda_build.load("hash_encode_win")
    if not getattr(lib, "_he_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.he_win_fwd.argtypes = [p, p, p, i, p, p, p, p, ll, i, i, ll, p]
        lib.he_win_bwd.argtypes = [p, p, p, p, i, i, ll, p, p, ll, p, ll, i,
                                   i, p]
        lib.he_win_bwd_fix.argtypes = [p, p, p, p, i, i, ll, p, p, ll, p, ll,
                                       i, i, p, ll, p]
        for fn in (lib.he_win_fwd, lib.he_win_bwd, lib.he_win_bwd_fix):
            fn.restype = ctypes.c_int
        lib.he_error_string.argtypes = [ctypes.c_int]
        lib.he_error_string.restype = ctypes.c_char_p
        lib._he_typed = True
    return lib


def _check(x, rows, levels: int, t: int, *tensors):
    """Validate the point inputs and the geometry of a launch: `tensors`
    are its other inputs, which must share x's CUDA device."""
    n = x.shape[0]
    if not (x.is_cuda and all(v.device == x.device for v in tensors)):
        raise ValueError("kernel inputs must be CUDA tensors on one device")
    if x.dtype != torch.float32 or x.shape != (n, 3) or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous float32 [N, 3], got "
                         f"{x.dtype} {tuple(x.shape)}")
    if len(rows) != levels or not 0 < levels <= _MAX_LEVELS:
        raise ValueError(f"{len(rows)} level rows for {levels} levels "
                         f"(at most {_MAX_LEVELS})")
    if t & (t - 1) or t < PAGE_ENTRIES:
        raise ValueError(f"table size {t} must be a power of two >= "
                         f"{PAGE_ENTRIES}")


def _call(fn_name: str, dev, *args):
    """Call the C entry `fn_name` on dev's current stream; raise on a
    launch error."""
    lib = _lib()
    err = getattr(lib, fn_name)(*args, torch.cuda.current_stream(dev)
                                .cuda_stream)
    if err:
        raise RuntimeError(f"{fn_name} launch failed: "
                           f"{lib.he_error_string(err).decode()}")


def _rows_c(rows):
    flat = [v for r in rows for v in r]
    return ctypes.cast((ctypes.c_int * len(flat))(*flat), ctypes.c_void_p)


def point_base(x, t: int, page_bounds):
    """[N] int32 segment base per point (`_point_bc` in the JAX module):
    the plain version of what the forward computes in its first kernel."""
    base, _ = page_lookup(zkey27(x), t, page_bounds)
    return base.to(torch.int32).contiguous()


def hash_encode_win_fwd_kernel(table, x, bounds, rows):
    """One call of the forward (`he_win_fwd`: each point's page found in
    the kernel, the counting sort by segment, then the gather; no
    autograd): (out [N, L*2] f32, base [N] int32, work). bounds: the page
    bounds as a `bounds_tensor` on the card; rows from `level_scalars`.
    base is each point's page base, as `point_base` computes it; work is
    the int32 scratch that holds the sort (`bwd_plan`'s `work_ints`), which
    the backward reads."""
    if (table.dtype != torch.float32 or table.ndim != 3
            or table.shape[2] != 2 or not table.is_contiguous()):
        raise ValueError(f"table must be a contiguous float32 [L, T, 2], got "
                         f"{table.dtype} {tuple(table.shape)}")
    l, t, _ = table.shape
    n_seg = n_segments(t)
    if n_seg > MAX_SEGMENTS:
        raise ValueError(f"table size {t} has {n_seg} segments: the windowed "
                         f"kernels take at most {MAX_SEGMENTS} (T <= 2^25, "
                         f"the range JAX's windowed kernel states in "
                         f"_pack_pages: page ids fit 15 bits)")
    _check(x, rows, l, t, table, bounds)
    if (bounds.dtype != torch.int64 or bounds.shape != (n_seg,)
            or not bounds.is_contiguous()):
        raise ValueError(f"bounds must be a contiguous int64 [{n_seg}] "
                         f"(bounds_tensor), got {bounds.dtype} "
                         f"{tuple(bounds.shape)}")
    n = x.shape[0]
    dev = table.device
    out = torch.empty((n, 2 * l), dtype=torch.float32, device=dev)
    base = torch.empty(n, dtype=torch.int32, device=dev)
    work = torch.empty(bwd_plan(rows, n, t).work_ints, dtype=torch.int32,
                       device=dev)
    _call("he_win_fwd", dev, table.data_ptr(), x.data_ptr(),
          bounds.data_ptr(), n_seg, _rows_c(rows), out.data_ptr(),
          base.data_ptr(), work.data_ptr(), work.numel(), n, l, t)
    launches["fwd"] += 1
    return out, base, work


def hash_encode_win_bwd_kernel(g, x, work, rows, table_shape,
                               deterministic=None):
    """One call of the backward (`he_win_bwd`: the page, dense and cluster
    kernels of `bwd_plan`, from the forward's sort): the [L, T, 2] f32 table
    gradient of the encode for cotangent g [N, L*2]. work: the scratch of
    the forward call on the same points and rows. Every entry is written by
    a kernel, so nothing is zero-filled here.

    `deterministic` (default: `torch.are_deterministic_algorithms_enabled()`)
    takes the fixed-order variant `he_win_bwd_fix`, whose sums are exact
    int64 sums of the contributions rounded once to a fixed point (the note
    in the CUDA source), so that launches on the same inputs are bit-equal
    whatever the order of the sort and of the adds."""
    if deterministic is None:
        deterministic = torch.are_deterministic_algorithms_enabled()
    l, t, _ = table_shape
    n = x.shape[0]
    _check(x, rows, l, t, g, work)
    if g.shape != (n, 2 * l):
        raise ValueError(f"cotangent must be [{n}, {2 * l}], got "
                         f"{tuple(g.shape)}")
    plan = bwd_plan(rows, n, t)
    if work.dtype != torch.int32 or work.shape != (plan.work_ints,):
        raise ValueError("work must be the forward's int32 scratch")
    g = g.to(torch.float32).contiguous()
    dtable = torch.empty(table_shape, dtype=torch.float32, device=g.device)
    # a float2 (8 bytes) or, fixed-order, a longlong2 (16) an entry
    partials = torch.empty((max(plan.partial_entries, 1),
                            2 if deterministic else 1),
                           dtype=torch.int64, device=g.device)
    spans_c = (ctypes.c_int * l)(*plan.spans)
    args = (g.data_ptr(), x.data_ptr(), _rows_c(rows), dtable.data_ptr(), n,
            l, t, ctypes.cast(spans_c, ctypes.c_void_p), work.data_ptr(),
            work.numel(), partials.data_ptr(), plan.partial_entries,
            plan.dense_parts, plan.wide_parts)
    if deterministic:
        fix = torch.empty(plan.fix_bytes // 8, dtype=torch.int64,
                          device=g.device)
        _call("he_win_bwd_fix", g.device, *args, fix.data_ptr(),
              plan.fix_bytes)
        launches_det["bwd"] += 1
    else:
        _call("he_win_bwd", g.device, *args)
        launches["bwd"] += 1
    return dtable


class _HashEncodeWin(torch.autograd.Function):
    """Kernel forward and backward; the gradient flows to the table only
    (sample positions are not trainable), as in the JAX custom VJP. The
    backward starts from the forward's sort of the points by segment."""

    @staticmethod
    def forward(ctx, table, x, bounds, rows):
        out, _, work = hash_encode_win_fwd_kernel(table, x, bounds, rows)
        ctx.save_for_backward(x, work)
        ctx.rows = rows
        ctx.table_shape = tuple(table.shape)
        return out

    @staticmethod
    def backward(ctx, g):
        x, work = ctx.saved_tensors
        dtable = hash_encode_win_bwd_kernel(g, x, work, ctx.rows,
                                            ctx.table_shape)
        return dtable, None, None, None


def hash_encode_win(table, idx, weights):
    """Encode from precomputed corner indices and weights [L, 8, N] (from
    `corner_indices_weights_win`) with table [L, T, 2] f32: [N, L*2] f32,
    level-major columns, differentiable wrt the table — the counterpart of
    the JAX `hash_encode_win` without its `pages` argument.

    CUDA tensors launch the index-gather kernels of
    `csrc/hash_encode_idx.cu` (or raise; their launches count in
    `ops/hash_encode.py::launches`); CPU tensors take the plain version
    `hash_encode_exact`."""
    return he.hash_encode_mxu(table, idx, weights).reshape(idx.shape[2], -1)


def hash_encode_win_fused(table, x, resolutions, page_bounds=None,
                          dense_box=None):
    """Hash-grid encode of points x [N, 3] in [0, 1] with table [L, T, 2]:
    [N, L*2] f32, level-major columns, differentiable wrt the table.

    CUDA tensors launch the kernels (or raise); CPU tensors take the plain
    version. `page_bounds` may be a tuple, None, or a `bounds_tensor`."""
    if not table.is_cuda:
        return hash_encode_plain(table, x, resolutions, page_bounds, dense_box)
    t = table.shape[1]
    if not torch.is_tensor(page_bounds):
        page_bounds = bounds_tensor(t, page_bounds, table.device)
    return _HashEncodeWin.apply(table, x, page_bounds,
                                level_scalars(resolutions, t, dense_box))
