"""The schedule of the port's windowed hash-encode forward
(`spinnerf_tpu_torch/csrc/hash_encode_win.cu::hf_fwd_kernel`) against the
JAX package (`spinnerf_tpu/ops/hash_encode_win.py`).

Two plain mirrors of what the kernel does in its blocks:
- the page lookup: zkey27 in int32 arithmetic (x * 512 truncated, clamped
  to [0, 511], morton-interleaved) and the halving-step search for the last
  staged bound <= key, held bit for bit against JAX
  `page_lookup(zkey27(x))` on uniform, calibrated and repeated bounds, with
  points at 0, at 1.0 and exactly on a bound's key;
- the gather schedule: the points sorted by segment into chunks, blocks
  of `HF_PTS` sorted points of one chunk taking every level, a paged level
  read from the chunk's page, a dense level's corners ci and ci+4 from one
  16-byte pair where they are entries e and e^1, the blend in corner order
  with f32 products and sums, the rows staged at an odd pitch and each
  written once; held
  against JAX `hash_encode_exact(corner_indices_weights_win(...))` and the
  port's plain version within 1e-6, and bit for bit against the port's
  index gathered and blended in the kernel's order.
The kernel itself runs only on the card (`chip_smoke.py` phases 3 and 13)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spinnerf_tpu.models import hashgrid as jhg
from spinnerf_tpu.ops import hash_encode_win as jhw
from spinnerf_tpu_torch.models.hashgrid import level_resolutions
from spinnerf_tpu_torch.ops import hash_encode_win as thw

torch.set_num_threads(1)

HF_PTS = 256        # sorted points a block (HF_PTS in the CUDA source)
C = thw.CHUNK_POINTS
RES = (4, 7, 16, 45, 300, 5000)


def _on_key(key):
    """A point whose zkey27 is exactly `key`: morton27 inverted, each cell
    coordinate c at x = c / 512 (exact in f32)."""
    c = [0, 0, 0]
    for bit in range(27):
        c[bit % 3] |= ((key >> bit) & 1) << (bit // 3)
    return np.asarray(c, np.float32) / 512.0


def _points(seed, n, bounds):
    """Clustered and uniform points, points at 0 and at 1.0 on every axis
    and on single axes, and points exactly on bound keys."""
    rng = np.random.RandomState(seed)
    x = np.concatenate([0.48 + 0.04 * rng.rand(n // 2, 3),
                        rng.rand(n - n // 2, 3)]).astype(np.float32)
    x[:8] = 1.0
    x[8:16] = 0.0
    x[16:24, 0] = 1.0
    x[24:32, 1] = 0.0
    keys = list(bounds) + [b - 1 for b in bounds if b] + [(1 << 27) - 1]
    for j, key in enumerate(keys[:n - 40]):
        x[40 + j] = _on_key(key)
    return x


def _bounds(case, log2_t):
    n_seg = (1 << log2_t) // thw.PAGE_ENTRIES
    if case == "uniform":
        return thw.uniform_bounds(1 << log2_t)
    if case == "calibrated":
        rng = np.random.RandomState(log2_t)
        x = np.concatenate([0.45 + 0.1 * rng.rand(3000, 3),
                            rng.rand(500, 3)]).astype(np.float32)
        return jhg.calibrate_page_bounds(x, log2_t)
    # repeated: runs of equal keys, the last one near the top of the range
    rng = np.random.RandomState(log2_t + 1)
    keys = np.sort(rng.choice([5000, 90000, 1 << 20, (1 << 27) - 1],
                              n_seg - 1))
    return (0,) + tuple(int(k) for k in keys)


def zkey27_kernel(x):
    """The kernel's zkey27 on x [N, 3]: int32 arithmetic."""
    c = np.clip((x * np.float32(512.0)).astype(np.int32), 0, 511)

    def spread9(v):
        v = v.astype(np.uint32) & 0x1FF
        for shift, mask in ((16, 0x030000FF), (8, 0x0300F00F),
                            (4, 0x030C30C3), (2, 0x09249249)):
            v = (v | (v << shift)) & mask
        return v

    return (spread9(c[:, 0]) | (spread9(c[:, 1]) << 1)
            | (spread9(c[:, 2]) << 2)).astype(np.int32)


def page_of_kernel(z, bounds):
    """The kernel's page_of: the bounds staged as int32, the last i with
    bounds[i] <= z by halving steps from n_seg / 2 (n_seg a power of two),
    -1 if bounds[0] > z."""
    sb = np.asarray(bounds, np.int64).astype(np.int32)
    pos = np.zeros(len(z), np.int64)
    step = len(sb) >> 1
    while step:
        pos += np.where(sb[pos + step] <= z, step, 0)
        step >>= 1
    return np.where(sb[0] <= z, pos, -1)


def base_kernel(x, bounds):
    """[N] int32: what the kernel writes to base_out."""
    return (page_of_kernel(zkey27_kernel(x), bounds)
            * thw.PAGE_ENTRIES).astype(np.int32)


@pytest.mark.parametrize("case", ["uniform", "calibrated", "repeated"])
@pytest.mark.parametrize("log2_t", [13, 19])
def test_page_lookup_mirror_matches_jax(case, log2_t):
    t = 1 << log2_t
    bounds = _bounds(case, log2_t)
    x = _points(log2_t, 1200, bounds)
    base_j, _ = jhw.page_lookup(jhw.zkey27(jnp.asarray(x.T)), t, bounds)
    base_k = base_kernel(x, bounds)
    np.testing.assert_array_equal(base_k, np.asarray(base_j).astype(np.int64))
    np.testing.assert_array_equal(
        base_k, thw.point_base(torch.from_numpy(x), t, bounds).numpy())
    # the points on a bound's key land on the last segment of that key
    on = base_k[40:40 + len(bounds)] // thw.PAGE_ENTRIES
    want = [max(i for i, b in enumerate(bounds) if b == key)
            for key in bounds]
    np.testing.assert_array_equal(on, want)


def test_page_of_below_the_first_bound():
    """A key below bounds[0] gives page -1, as searchsorted(right=True) - 1
    does (unreachable with validated bounds, whose first key is 0)."""
    bounds = torch.tensor([10, 20, 20, 30])
    z = np.array([0, 9, 10, 19, 20, 29, 30, 1 << 26])
    got = page_of_kernel(z, bounds.numpy())
    want = torch.searchsorted(bounds, torch.from_numpy(z), right=True) - 1
    np.testing.assert_array_equal(got, want.numpy())


def emulate_fwd(x, table, res, page_bounds, dense_box):
    """[N, L*2] f32 computed in the blocks and the order of `he_win_fwd`:
    the page bases of the lookup above, the counting sort by segment into
    chunks of at most CHUNK_POINTS points, blocks of HF_PTS sorted points of
    one chunk taking every level; a paged level read from the chunk's page
    (which must hold every corner), a dense level gathered directly with
    corners ci / ci+4 from one 16-byte pair where they are entries e and
    e^1; the blend in corner order with f32 products and sums; the rows
    staged at an odd pitch and each written once. Returns it and the
    shares of the dense levels' (ci, ci+4) pairs read by one load. Out
    slots start as NaN, so a slot no block writes shows."""
    n, (l, t, _) = len(x), table.shape
    bounds = thw.normalize_bounds(t, page_bounds)
    rows = thw.level_scalars(res, t, dense_box)
    seg = base_kernel(x, bounds) // thw.PAGE_ENTRIES
    counts = np.bincount(seg, minlength=thw.n_segments(t))
    order = np.argsort(seg, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    chunks = [(s, starts[s] + j * C, min(C, counts[s] - j * C))
              for s in range(len(counts))
              for j in range(max(1, -(-counts[s] // C)))]
    idx, w = thw.corner_indices_weights_win(torch.from_numpy(x), res, t,
                                            bounds, dense_box)
    idx, w = idx.numpy(), w.numpy()
    pairs = table.reshape(l, t // 2, 4)         # 16-byte pairs of entries
    out = np.full(n * 2 * l, np.nan, np.float32)
    pitch, paired, dense_pairs = 2 * l + 1, 0, 0
    for s, p0, ln in chunks:
        for i0 in range(0, ln, HF_PTS):
            pts = order[p0 + i0:p0 + min(ln, i0 + HF_PTS)]
            tile = np.full((HF_PTS, pitch), np.nan, np.float32)
            for lv in range(l):
                e = idx[lv][:, pts]
                f = np.empty((8, len(pts), 2), np.float32)
                if rows[lv][1]:
                    for c in range(4):
                        e0, e1 = e[c], e[c + 4]
                        pair = pairs[lv, e0 >> 1]
                        odd = (e0 & 1)[:, None] == 1
                        f[c] = np.where(odd, pair[:, 2:], pair[:, :2])
                        both = (e0 ^ e1) == 1
                        paired += int(both.sum())
                        dense_pairs += len(pts)
                        f[c + 4] = np.where(
                            both[:, None],
                            np.where(odd, pair[:, :2], pair[:, 2:]),
                            table[lv, e1])
                else:
                    page = table[lv, s * thw.PAGE_ENTRIES:
                                 (s + 1) * thw.PAGE_ENTRIES]
                    key = e - s * thw.PAGE_ENTRIES
                    assert ((key >= 0) & (key < thw.PAGE_ENTRIES)).all()
                    f[:] = page[key]
                acc = np.zeros((len(pts), 2), np.float32)
                for c in range(8):
                    acc = acc + w[lv, c, pts][:, None] * f[c]
                tile[:len(pts), 2 * lv:2 * lv + 2] = acc
            i = np.arange(len(pts) * 2 * l)
            out[pts[i // (2 * l)] * 2 * l + i % (2 * l)] = tile.reshape(-1)[
                (i // (2 * l)) * pitch + i % (2 * l)]
    return out.reshape(n, 2 * l), paired / max(dense_pairs, 1)


def _fwd_case(case):
    """(x, res, table, page_bounds, dense_box) of a forward case."""
    rng = np.random.RandomState(7)
    if case.startswith("default_field"):
        log2_t, res = 19, tuple(level_resolutions(16, 16, 2048.0 * 100))
    else:
        log2_t, res = 13, RES
    bounds = _bounds("calibrated" if "calibrated" in case else "uniform",
                     log2_t)
    if case == "one_segment":
        # 2,500 points in segment 0: three chunks, cut into blocks
        x = (0.001 + 0.002 * rng.rand(2500, 3)).astype(np.float32)
    else:
        x = _points(3, 300 if log2_t == 19 else 700, bounds)
    box = (jhg.calibrate_dense_box(x[:200], res, log2_t)
           if "box" in case else None)
    table = rng.randn(len(res), 1 << log2_t, 2).astype(np.float32)
    return x, res, table, bounds, box


FWD_CASES = ["uniform", "calibrated", "calibrated_dense_box", "one_segment",
             "default_field_2^19", "default_field_2^19_calibrated_box"]


@pytest.mark.parametrize("case", FWD_CASES)
def test_emulated_forward_matches_jax(case):
    x, res, table, bounds, box = _fwd_case(case)
    t = table.shape[1]
    got, paired = emulate_fwd(x, table, res, bounds, box)
    idx, w = jhw.corner_indices_weights_win(jnp.asarray(x.T), res, t,
                                            bounds, box)
    want = np.asarray(jhw.hash_encode_exact(jnp.asarray(table), idx, w))
    assert got.shape == want.shape == (len(x), 2 * len(res))
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    # the port's index gathered and blended in the kernel's order: bit for
    # bit; the plain version (torch.sum's order): within 1e-6
    idx_t, w_t = thw.corner_indices_weights_win(torch.from_numpy(x), res, t,
                                                bounds, box)
    lvl = np.arange(len(res))[:, None, None]
    feats = table[lvl, idx_t.numpy()]                    # [L, 8, N, 2]
    seq = np.zeros((len(res), len(x), 2), np.float32)
    for c in range(8):
        seq = seq + w_t.numpy()[:, c, :, None] * feats[:, c]
    np.testing.assert_array_equal(got, seq.transpose(1, 0, 2).reshape(
        len(x), -1))
    plain = thw.hash_encode_plain(torch.from_numpy(table),
                                  torch.from_numpy(x), res, bounds, box)
    assert np.abs(got - plain.numpy()).max() <= 1e-6 * np.abs(want).max()
    # where cx is even the dense index pairs ci / ci+4: about half of them
    # on spread points, all of them where every point is in cell 0
    if case == "one_segment":
        assert paired == 1.0
    elif any(r[1] for r in thw.level_scalars(res, t, box)):
        assert 0.3 < paired < 0.7


def test_fwd_kernel_wrapper_takes_only_cuda_tensors():
    """The forward kernel's wrapper raises for CPU tensors and for bounds
    that are not the table's `bounds_tensor`; the encode on CPU tensors
    takes the plain version and launches nothing."""
    t, res = 1 << 13, RES
    table = torch.zeros((len(res), t, 2))
    x = torch.rand(64, 3)
    rows = thw.level_scalars(res, t, None)
    with pytest.raises(ValueError, match="CUDA"):
        thw.hash_encode_win_fwd_kernel(table, x, thw.bounds_tensor(t, None),
                                       rows)
    before = dict(thw.launches)
    out = thw.hash_encode_win_fused(table, x, res,
                                    thw.bounds_tensor(t, None), None)
    assert out.shape == (64, 2 * len(res))
    assert thw.launches == before
