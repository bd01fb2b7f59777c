"""The windowed hash encode at the largest table JAX's windowed kernel takes
(T = 2^25 entries, 32,768 segments): the port's calibration, bounds, page
lookup and corner index against the JAX package's (indices bit-identical,
weights within 1.5e-6), the plain encode and its table gradient against
JAX's `hash_encode_exact` on one level of 2^25 x 2, the forward kernel's
two-level page lookup (mirrored here in numpy) against searchsorted, and
the scratch plan of the sort at 32,768 segments against what the CUDA
source's layout needs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spinnerf_tpu.models import hashgrid as jhg
from spinnerf_tpu.ops import hash_encode_win as jhw
from spinnerf_tpu_torch.models import hashgrid as thg
from spinnerf_tpu_torch.ops import hash_encode_win as thw

torch.set_num_threads(1)

LOG2_T = 25
T = 1 << LOG2_T
RES = (7, 16, 45, 300, 5000, 65536)
HF_STAGED = 4096        # csrc/hash_encode_win.cu: bounds the lookup stages


def _points(seed, n=1024):
    """Clustered points (a scene in a small part of the cube) plus uniform
    ones and exact boundary points."""
    rng = np.random.RandomState(seed)
    x = np.concatenate([0.48 + 0.04 * rng.rand(n // 2, 3),
                        rng.rand(n - n // 2, 3)]).astype(np.float32)
    x[:8] = 1.0
    x[8:16, 2] = 0.0
    return x


@pytest.fixture(scope="module")
def calibrated():
    """The calibrated bounds at 2^25 from 4,096 samples: fewer samples than
    segments, so most bounds are advanced duplicates."""
    x = _points(0, n=4096)
    return (thg.calibrate_page_bounds(x, LOG2_T),
            jhg.calibrate_page_bounds(x, LOG2_T),
            thg.calibrate_dense_box(x[:2048], RES, LOG2_T))


def test_calibration_and_bounds_equal(calibrated):
    port, ref, _ = calibrated
    assert len(port) == T // thw.PAGE_ENTRIES == 32768
    assert port == ref
    assert thw.normalize_bounds(T, port) == jhw.normalize_bounds(T, ref)
    assert thw.normalize_bounds(T, None) == jhw.normalize_bounds(T, None)


@pytest.mark.parametrize("bounds", ["uniform", "calibrated"])
def test_page_lookup_and_corner_indices_bit_identical(calibrated, bounds):
    page_bounds = None if bounds == "uniform" else calibrated[0]
    dense_box = None if bounds == "uniform" else calibrated[2]
    x = _points(1)
    z = thw.zkey27(torch.from_numpy(x))
    base_t, capm_t = thw.page_lookup(z, T, page_bounds)
    base_j, capm_j = jhw.page_lookup(jnp.asarray(z.numpy(), jnp.int32), T,
                                     page_bounds)
    np.testing.assert_array_equal(base_t.numpy(), np.asarray(base_j))
    np.testing.assert_array_equal(capm_t.numpy(), np.asarray(capm_j))
    assert int(base_t.max()) < T
    idx_j, w_j = jhw.corner_indices_weights_win(
        jnp.asarray(x.T), RES, T, page_bounds, dense_box)
    idx_t, w_t = thw.corner_indices_weights_win(
        torch.from_numpy(x), RES, T, page_bounds, dense_box)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0,
                               atol=1.5e-6)
    assert idx_t.min() >= 0 and idx_t.max() < T


def test_plain_encode_and_table_grad_one_level():
    """One level of 2^25 x 2 (256 MiB): the output and the table gradient of
    the plain version within 1e-6 of JAX's (f32 sums of 8 products of the
    same weights and entries; the gradient's entries are sums of at most a
    few contributions)."""
    res = (65536,)
    x = _points(2, n=512)
    rng = np.random.RandomState(3)
    table = rng.randn(1, T, 2).astype(np.float32)
    g = rng.randn(len(x), 2).astype(np.float32)

    def jax_out(tab):
        idx, w = jhw.corner_indices_weights_win(jnp.asarray(x.T), res, T)
        return jhw.hash_encode_exact(tab, idx, w)

    tab_j = jnp.asarray(table)
    out_j = np.asarray(jax_out(tab_j))
    grad_j = np.asarray(jax.grad(
        lambda tab: jnp.sum(jax_out(tab) * jnp.asarray(g)))(tab_j))
    del tab_j
    tab_t = torch.from_numpy(table).requires_grad_()
    out_t = thw.hash_encode_win_fused(tab_t, torch.from_numpy(x), res)
    (out_t * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), out_j, rtol=0,
                               atol=1e-6)
    grad_t = tab_t.grad.numpy()
    nz = np.flatnonzero(grad_j.reshape(-1))
    np.testing.assert_array_equal(np.flatnonzero(grad_t.reshape(-1)), nz)
    np.testing.assert_allclose(grad_t.reshape(-1)[nz],
                               grad_j.reshape(-1)[nz], rtol=0, atol=1e-6)
    assert thw.launches == {"fwd": 0, "bwd": 0}


def _page_of(bounds, z):
    """numpy mirror of csrc/hash_encode_win.cu::page_of: halving steps over
    every stride-th bound (the staged ones), then log2(stride) steps over
    the bounds from the one found."""
    n_seg = len(bounds)
    stride = n_seg // HF_STAGED if n_seg > HF_STAGED else 1
    sb = bounds[::stride]
    pos = np.zeros(len(z), np.int64)
    step = len(sb) >> 1
    while step:
        pos = np.where(sb[pos + step] <= z, pos + step, pos)
        step >>= 1
    pos *= stride
    step = stride >> 1
    while step:
        pos = np.where(bounds[pos + step] <= z, pos + step, pos)
        step >>= 1
    return np.where(bounds[0] <= z, pos, -1)


@pytest.mark.parametrize("log2_t", [19, 22, 24, 25])
def test_two_level_page_lookup_counts_as_searchsorted(log2_t):
    """The forward kernel's lookup at every staging stride (1, 1, 4, 8)
    equals searchsorted(right=True) - 1, repeated bounds included, on keys
    at, between and around every bound."""
    t = 1 << log2_t
    rng = np.random.RandomState(log2_t)
    x = np.concatenate([0.5 + 0.01 * rng.rand(300, 3), rng.rand(300, 3)])
    cal = np.asarray(thg.calibrate_page_bounds(x, log2_t), np.int64)
    n_seg = thw.n_segments(t)
    rep = np.sort(rng.randint(0, n_seg // 4, n_seg)).astype(np.int64) * 997
    rep[0] = 0
    assert (rep[1:] == rep[:-1]).sum() > n_seg // 2   # runs of repeats
    for b in (np.asarray(thw.uniform_bounds(t), np.int64), cal, rep):
        z = np.unique(np.concatenate([b, b + 1, b - 1, rng.randint(
            0, 1 << 27, 4096)]))
        z = z[(z >= 0) & (z < 1 << 27)]
        want = torch.searchsorted(torch.from_numpy(b), torch.from_numpy(z),
                                  right=True).numpy() - 1
        np.testing.assert_array_equal(_page_of(b, z), want)


def _plan_chunks(counts):
    """numpy mirror of hb_plan_kernel: the chunk table (segment, first
    sorted position, points, 1 for a sole chunk or -(1 + k) for a chunk of
    split segment k) and the split segments."""
    chunks, split, pos = [], [], 0
    for s, c in enumerate(counts):
        nch = max(1, -(-int(c) // thw.CHUNK_POINTS))
        if c > thw.CHUNK_POINTS:
            split.append(s)
        for j in range(nch):
            chunks.append((s, pos + j * thw.CHUNK_POINTS,
                           min(thw.CHUNK_POINTS, c - j * thw.CHUNK_POINTS),
                           1 if nch == 1 else -len(split)))
        pos += int(c)
    return chunks, split


@pytest.mark.parametrize("n", [262144, 666624])
def test_sort_scratch_plan_at_32768_segments(n):
    """`bwd_plan` at 2^25: the int32 scratch of the sort holds the layout
    of csrc/hash_encode_win.cu::work_layout (4 ints a chunk for at most
    ceil(N / 1024) + n_seg chunks, counts and cursor n_seg each, meta 4, the
    split segments min(n_seg, N // 1025), the order N), and the
    backward's scratch: a flag and a count (16 bytes), a slot index a split
    segment and a sorted id a point (each padded to 16 bytes), and one f32
    page (1024 x 8 bytes) a paged level of each chunk of a split segment,
    at most ceil(N / 1024) + min(n_seg, N // 1025) of them. The chunk
    counts of skewed point distributions stay within those bounds."""
    n_seg = T // thw.PAGE_ENTRIES
    rows = thw.level_scalars(RES, T, None)
    plan = thw.bwd_plan(rows, n, T)
    max_chunks = -(-n // 1024) + n_seg
    max_split = min(n_seg, n // 1025)
    assert plan.work_ints == (4 * max_chunks + 2 * n_seg + 4 + max_split
                              + n)
    assert plan.paged == (1, 2, 3, 4, 5)   # res 7 is dense by default
    split_chunks = -(-n // 1024) + max_split
    assert plan.split_chunks == split_chunks
    assert plan.fix_bytes == (16 + -(-4 * max_split // 16) * 16
                              + -(-4 * n // 16) * 16
                              + split_chunks * 5 * 1024 * 8)
    rng = np.random.RandomState(0)
    for counts in (np.bincount(rng.zipf(1.3, n) % n_seg, minlength=n_seg),
                   np.eye(1, n_seg, 7, dtype=np.int64)[0] * n,
                   np.full(n_seg, n // n_seg)):
        counts[0] += n - counts.sum()
        chunks, split = _plan_chunks(counts)
        assert len(chunks) <= max_chunks and len(split) <= max_split
        assert all(c[2] <= thw.CHUNK_POINTS for c in chunks)
        assert sorted(-c[3] - 1 for c in chunks if c[3] < 0) == sorted(
            k for k, s in enumerate(split)
            for _ in range(-(-int(counts[s]) // thw.CHUNK_POINTS)))
        assert sum(c[3] < 0 for c in chunks) <= split_chunks


def test_tables_over_2_25_raise_naming_jax_limit():
    """The card path refuses 2^26 before any device check, naming JAX's
    limit; the plain version takes it."""
    table = torch.empty((1, 1 << 26, 2))
    x = torch.from_numpy(_points(3, n=64))
    rows = thw.level_scalars((16,), 1 << 26, None)
    bounds = thw.bounds_tensor(1 << 26, None)
    with pytest.raises(ValueError, match="2\\^25.*_pack_pages"):
        thw.hash_encode_win_fwd_kernel(table, x, bounds, rows)
    idx, _ = thw.corner_indices_weights_win(x, (16,), 1 << 26)
    assert int(idx.max()) < 1 << 26
