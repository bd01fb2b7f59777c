"""The schedules of the port's windowed hash-encode backwards
(`spinnerf_tpu_torch/csrc/hash_encode_win.cu::he_win_bwd`, the atomic
default, and its fixed-order variant `he_win_bwd_fix`) against the JAX
package (`spinnerf_tpu/ops/hash_encode_win.py`).

`bwd_plan` (per-level regime and span, partial sums and scratch that the
wrapper passes to the CUDA source) is held against JAX `box_morton_span` /
`box_dense_ok` on calibrated boxes. A plain emulation of the atomic
kernels' schedule in f32 (the forward's counting sort by segment, chunks
of `CHUNK_POINTS` points, a page accumulator per (chunk, paged level)
flushed by store or by addition, per-slice partial sums of the dense spans
reduced afterwards) must write every entry and give JAX
`hash_encode_exact`'s table gradient within 1e-6 of its largest entry (the
gradient evaluated in float64, as chip_smoke.py holds the kernel). One of
the variant's (its order within a segment shuffled as the scatter's
atomics may leave it, the split segments' ids sorted; each block's
contributions rounded once to int64 at its own fixed point and summed
exactly, its page or partial sums back in f32, a split segment's chunk
pages and the dense partials added in order) must too, entry by entry
within an f32 sum's own error on a cotangent that spans six orders of
magnitude, and give the same bits whatever the order within the
segments."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spinnerf_tpu.models import hashgrid as jhg
from spinnerf_tpu.ops import hash_encode_win as jhw
from spinnerf_tpu_torch.ops import hash_encode_win as thw

torch.set_num_threads(1)

RES = (4, 7, 16, 45, 300, 5000)
C = thw.CHUNK_POINTS


def _clustered(rng, n, lo=0.48, width=0.04):
    return (lo + width * rng.rand(n, 3)).astype(np.float32)


def _cases():
    """name -> (x [N, 3], log2 t, page_bounds, dense_box)."""
    rng = np.random.RandomState(0)
    mixed = np.concatenate([_clustered(rng, 1200), rng.rand(900, 3)]
                           ).astype(np.float32)
    mixed[:8] = 1.0
    cal_b = jhg.calibrate_page_bounds(mixed, 13)
    cal_box = jhg.calibrate_dense_box(mixed[:300], RES, 13)
    wide_box = list(jhw.normalize_dense_box(RES, 1 << 15, None))
    wide_box[3] = (12, 12, 12, 20, 20, 20)       # res 45: span 32,768
    return {
        "uniform": (mixed, 13, None, None),
        "calibrated": (mixed, 13, cal_b, None),
        "dense_box_out_of_box": (mixed, 13, cal_b, cal_box),
        # 2,500 points in segment 0: three chunks, the last partial
        "one_segment": (_clustered(rng, 2500, 0.01, 0.02), 13, None, None),
        # a calibration elsewhere leaves most segments without points
        "empty_segments": (_clustered(rng, 1500, 0.2, 0.05), 13,
                           jhg.calibrate_page_bounds(
                               _clustered(rng, 4000, 0.6, 0.3), 13), None),
        # N = 3 C + 77: segments of more than C points under uniform bounds
        "n_not_multiple_of_chunk": (np.concatenate(
            [_clustered(rng, 2 * C, 0.05, 0.05), rng.rand(C + 77, 3)]
        ).astype(np.float32), 13, None, None),
        "wide_span": (mixed, 15, None, tuple(wide_box)),
    }


CASES = _cases()


def emulate_bwd(x, g, res, t, page_bounds, dense_box):
    """The table gradient [L, T, 2] f32 computed in the order and by the
    flushes of `he_win_bwd`. Entries start as NaN, so an entry no kernel
    writes shows."""
    xt = torch.from_numpy(x)
    rows = thw.level_scalars(res, t, dense_box)
    n, n_seg = len(x), thw.n_segments(t)
    plan = thw.bwd_plan(rows, n, t)
    idx, w = thw.corner_indices_weights_win(xt, res, t, page_bounds,
                                            dense_box)
    idx, w = idx.numpy(), w.numpy()
    contrib = w[..., None] * g.reshape(n, -1, 2).transpose(1, 0, 2)[:, None]
    dt = np.full((len(res), t, 2), np.nan, np.float32)

    # 1.-3. counting sort by segment and the chunk table
    seg = thw.point_base(xt, t, page_bounds).numpy() // thw.PAGE_ENTRIES
    counts = np.bincount(seg, minlength=n_seg)
    order = np.argsort(seg, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    chunks = []
    for s in range(n_seg):
        nch = max(1, -(-counts[s] // C))
        chunks += [(s, starts[s] + j * C, min(C, counts[s] - j * C), nch == 1)
                   for j in range(nch)]
    assert len(chunks) <= -(-n // C) + n_seg
    split = [s for s in range(n_seg) if counts[s] > C]
    assert len(split) <= n // (C + 1)

    def add(acc, l, pts, key):
        for c in range(8):
            np.add.at(acc, key[c], contrib[l, c, pts])

    # 4.-5. paged levels: split pages zeroed, then one accumulator a chunk
    for l in plan.paged:
        for s in split:
            dt[l, s * thw.PAGE_ENTRIES:(s + 1) * thw.PAGE_ENTRIES] = 0.0
        for s, p0, ln, sole in chunks:
            acc = np.zeros((thw.PAGE_ENTRIES, 2), np.float32)
            pts = order[p0:p0 + ln]
            key = idx[l][:, pts] - s * thw.PAGE_ENTRIES
            assert ((key >= 0) & (key < thw.PAGE_ENTRIES)).all()
            add(acc, l, pts, key)
            page = slice(s * thw.PAGE_ENTRIES, (s + 1) * thw.PAGE_ENTRIES)
            if sole:
                dt[l, page] = acc
            else:
                dt[l, page] += acc

    # 6.-8. dense levels: partial sums over slices of the sorted points
    # (a cluster's slice for the wide span), then one write of the row
    for l in plan.dense + plan.wide:
        span = plan.spans[l]
        parts = plan.dense_parts if l in plan.dense else plan.wide_parts
        slices = parts if l in plan.dense else parts * thw.CLUSTER_BLOCKS
        partials = np.zeros((parts, span, 2), np.float32)
        for b in range(slices):
            pts = order[n * b // slices:n * (b + 1) // slices]
            assert (idx[l][:, pts] < span).all()
            add(partials[b * parts // slices], l, pts, idx[l][:, pts])
        dt[l] = 0.0
        dt[l, :span] = partials.sum(0)
    return dt, plan, counts


def _int_scale(gv):
    """A block's fixed point for its cotangents gv [P, 2], as the page
    kernel finds it: per feature k with 2^(62 - k) above sum |g|
    (bound_units: each |g| rounded up to a multiple of 2^(e - 32), max |g|
    < 2^e), clamped to [-126, 126]. (The dense kernels sum |g| in double,
    in a fixed order: the same k but where the sum lies within its rounding
    of a power of two.)"""
    ks = []
    for f in range(2):
        a = np.abs(gv[:, f].astype(np.float64))
        m = a.max() if a.size else 0.0
        e = int(np.frexp(np.float32(m))[1]) if m > 0 else 0
        units = np.ceil(a * 2.0 ** (32 - e)).astype(np.int64).sum()
        b = float(units) * 2.0 ** (e - 32)
        eb = int(np.frexp(b)[1]) if b > 0 else 0
        ks.append(min(max(62 - eb, -126), 126))
    return ks


def _block_sum(contrib, key, size, ks):
    """One block's exact sums: each contribution [8, P, 2] (f32) at its key
    [8, P], rounded once to an integer multiple of 2^-k (exact in float64
    up to 2^53, and an integer already above), added as int64 (the sum of
    their magnitudes stays below 2^63), then back to f32 as the kernels
    convert them (one rounding of the integer, then the power of two)."""
    acc = np.zeros((size, 2), np.int64)
    for f in range(2):
        v = np.rint(contrib[..., f].astype(np.float64) * 2.0 ** ks[f])
        assert np.abs(v).sum() < 2.0 ** 63
        np.add.at(acc[:, f], key.reshape(-1), v.astype(np.int64).reshape(-1))
    return np.stack([acc[:, f].astype(np.float32) * np.float32(2.0 ** -ks[f])
                     for f in range(2)], -1)


def emulate_fixed_bwd(x, g, res, t, page_bounds, dense_box, shuffle=None):
    """The table gradient [L, T, 2] f32 as `he_win_bwd_fix` computes it:
    the forward's sort (its order within a segment shuffled by the
    RandomState `shuffle`, as the scatter's atomics may place it), each
    split segment's ids sorted (hb_split_sort_kernel), one block's exact
    sums in its own fixed point a (chunk, paged level) (a sole chunk's page
    written, a split segment's chunk pages added in chunk order), a slice
    of the points in their own order a dense block (a cluster's for the
    wide span, one fixed point over its four quarters), the partials added
    in order. Entries start as NaN."""
    xt = torch.from_numpy(x)
    rows = thw.level_scalars(res, t, dense_box)
    n, n_seg = len(x), thw.n_segments(t)
    plan = thw.bwd_plan(rows, n, t)
    idx, w = thw.corner_indices_weights_win(xt, res, t, page_bounds,
                                            dense_box)
    idx, w = idx.numpy(), w.numpy()
    g3 = g.reshape(n, -1, 2).transpose(1, 0, 2)               # [L, N, 2]
    contrib = w[..., None] * g3[:, None]                      # f32 products
    dt = np.full((len(res), t, 2), np.nan, np.float32)
    seg = thw.point_base(xt, t, page_bounds).numpy() // thw.PAGE_ENTRIES
    counts = np.bincount(seg, minlength=n_seg)
    order = np.argsort(seg, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for s in range(n_seg):
        part = order[starts[s]:starts[s] + counts[s]]
        if shuffle is not None:
            shuffle.shuffle(part)
        if counts[s] > C:
            part.sort()
    P = thw.PAGE_ENTRIES
    for l in plan.paged:
        for s in range(n_seg):
            pages = []
            for j in range(max(1, -(-counts[s] // C))):
                pts = order[starts[s] + j * C:starts[s] + min(
                    (j + 1) * C, counts[s])]
                pages.append(_block_sum(contrib[l][:, pts],
                                        idx[l][:, pts] - s * P, P,
                                        _int_scale(g3[l, pts])))
            page = pages[0]
            for extra in pages[1:]:
                page = page + extra                       # chunk order, f32
            dt[l, s * P:(s + 1) * P] = page
    for l in plan.dense + plan.wide:
        span = plan.spans[l]
        parts = plan.dense_parts if l in plan.dense else plan.wide_parts
        slices = parts if l in plan.dense else parts * thw.CLUSTER_BLOCKS
        per = slices // parts
        total = np.zeros((span, 2), np.float32)
        for b in range(parts):
            pts = np.arange(n * b * per // slices, n * (b + 1) * per // slices)
            total = total + _block_sum(contrib[l][:, pts], idx[l][:, pts],
                                       span, _int_scale(g3[l, pts]))
        dt[l] = 0.0
        dt[l, :span] = total
    return dt, plan, counts


def _graded_cotangent(n, seed):
    """A cotangent [N, 12] whose magnitudes span six orders (1e-4 to 1e2
    times a normal draw), so that blocks mix large and small terms."""
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 2 * len(RES))
            * 10.0 ** rng.uniform(-4, 2, (n, 2 * len(RES)))).astype(np.float32)


def _plain_f32_grad(x, g, res, t, page_bounds, dense_box):
    """The plain version's f32 sums: every (point, corner) contribution added
    to its entry in f32, one at a time in point order."""
    idx, w = thw.corner_indices_weights_win(torch.from_numpy(x), res, t,
                                            page_bounds, dense_box)
    idx, w = idx.numpy(), w.numpy()
    g3 = g.reshape(len(x), -1, 2).transpose(1, 0, 2)
    dt = np.zeros((len(res), t, 2), np.float32)
    for l in range(len(res)):
        contrib = w[l][..., None] * g3[l][None]             # [8, N, 2] f32
        order = np.argsort(np.tile(np.arange(len(x)), 8), kind="stable")
        np.add.at(dt[l], idx[l].reshape(-1)[order],
                  contrib.reshape(-1, 2)[order])
    return dt


def _jax_grad(x, g, res, t, page_bounds, dense_box):
    """JAX hash_encode_exact's table gradient for JAX's f32 corner indices
    and weights, evaluated in float64: the exact sum of the same f32
    products, which any f32 summation order rounds (two orders differ by
    up to 2e-6 of max |grad| on these cases)."""
    idx, w = jhw.corner_indices_weights_win(jnp.asarray(x.T), res, t,
                                            page_bounds, dense_box)
    idx, w = np.asarray(idx), np.asarray(w)
    with jax.enable_x64(True):
        table = jnp.zeros((len(res), t, 2), jnp.float64)
        return np.asarray(jax.grad(lambda tab: jnp.sum(
            jhw.hash_encode_exact(tab, jnp.asarray(idx),
                                  jnp.asarray(w, jnp.float64))
            * jnp.asarray(g, jnp.float64)))(table))


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_schedule_matches_jax_grad(case):
    x, log2_t, page_bounds, dense_box = CASES[case]
    t = 1 << log2_t
    g = np.random.RandomState(5).randn(len(x), 2 * len(RES)).astype(
        np.float32)
    dt, plan, counts = emulate_bwd(x, g, RES, t, page_bounds, dense_box)
    assert not np.isnan(dt).any(), "an entry no kernel writes"
    ref = _jax_grad(x, g, RES, t, page_bounds, dense_box)
    assert ref.dtype == np.float64
    np.testing.assert_allclose(dt, ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())
    # each case exercises what it is named for
    if case == "one_segment":
        assert (counts > 0).sum() == 1 and counts.max() > 2 * C
    if case == "empty_segments":
        assert (counts == 0).sum() >= len(counts) // 2
    if case == "n_not_multiple_of_chunk":
        assert len(x) % C and counts.max() > C
    if case == "wide_span":
        assert plan.wide == (3,) and plan.spans[3] == thw.WIDE_SPAN
    if case == "dense_box_out_of_box":
        assert len(plan.dense) > 2


@pytest.mark.parametrize("case", sorted(CASES))
def test_fixed_order_schedule_matches_jax_grad(case):
    """The schedule (exact sums in each block's own fixed point) writes
    every entry, within 1e-6 of max |grad| of JAX's gradient in float64."""
    x, log2_t, page_bounds, dense_box = CASES[case]
    t = 1 << log2_t
    g = np.random.RandomState(5).randn(len(x), 2 * len(RES)).astype(
        np.float32)
    dt, plan, counts = emulate_fixed_bwd(x, g, RES, t, page_bounds,
                                       dense_box)
    assert not np.isnan(dt).any(), "an entry no kernel writes"
    ref = _jax_grad(x, g, RES, t, page_bounds, dense_box)
    assert ref.dtype == np.float64
    np.testing.assert_allclose(dt, ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())
    # each case exercises what it is named for
    if case == "one_segment":
        assert (counts > 0).sum() == 1 and counts.max() > 2 * C
    if case == "empty_segments":
        assert (counts == 0).sum() >= len(counts) // 2
    if case == "n_not_multiple_of_chunk":
        assert len(x) % C and counts.max() > C
    if case == "wide_span":
        assert plan.wide == (3,) and plan.spans[3] == thw.WIDE_SPAN
    if case == "dense_box_out_of_box":
        assert len(plan.dense) > 2


@pytest.mark.parametrize("case", sorted(CASES))
def test_fixed_order_sums_hold_each_entry(case):
    """Entry by entry, on a cotangent spanning six orders of magnitude: the
    schedule's error against JAX's float64 gradient is within 2^-21 of the
    entry's sum of |contributions| (an f32 sum's own scale), above a floor
    of 2^-45 of the largest such sum, and at most twice the largest error
    of the plain f32 sums on the same scale."""
    x, log2_t, page_bounds, dense_box = CASES[case]
    t = 1 << log2_t
    g = _graded_cotangent(len(x), 7)
    dt, _, _ = emulate_fixed_bwd(x, g, RES, t, page_bounds, dense_box)
    ref = _jax_grad(x, g, RES, t, page_bounds, dense_box)
    # the weights are >= 0: the gradient for |g| is each entry's sum of
    # |contributions|
    mag = _jax_grad(x, np.abs(g), RES, t, page_bounds, dense_box)
    scale = mag + 2.0 ** -45 * mag.max()
    err = np.abs(dt - ref) / scale
    err_p = np.abs(_plain_f32_grad(x, g, RES, t, page_bounds, dense_box)
                   - ref) / scale
    assert err.max() <= 2.0 ** -21, err.max()
    assert err.max() <= 2 * err_p.max(), (err.max(), err_p.max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_schedule_ignores_the_order_within_segments(case):
    """The same bits whatever order the forward's scatter (whose atomics
    place a warp's points) left within the segments: a sole chunk's exact
    sums do not depend on it, and a split segment's ids are sorted before
    they are cut into chunks."""
    x, log2_t, page_bounds, dense_box = CASES[case]
    t = 1 << log2_t
    g = np.random.RandomState(6).randn(len(x), 2 * len(RES)).astype(
        np.float32)
    dt, _, _ = emulate_fixed_bwd(x, g, RES, t, page_bounds, dense_box)
    for seed in (1, 2):
        other, _, _ = emulate_fixed_bwd(x, g, RES, t, page_bounds,
                                        dense_box,
                                  shuffle=np.random.RandomState(seed))
        assert np.array_equal(other, dt)


@pytest.mark.parametrize("log2_t", [13, 15, 19])
def test_plan_matches_jax_boxes(log2_t):
    """The plan's regimes and spans are JAX's: a level is dense iff JAX
    normalizes a box for it, with span box_morton_span(e), and the box
    passes box_dense_ok; each kernel's span share fits a block's shared
    memory."""
    t = 1 << log2_t
    x = CASES["dense_box_out_of_box"][0]
    res = jhg.level_resolutions(16, 16, 2048.0 * 100)
    boxes = jhg.calibrate_dense_box(x[:300], res, log2_t)
    jboxes = jhw.normalize_dense_box(res, t, boxes)
    rows = thw.level_scalars(res, t, boxes)
    n = 262144
    plan = thw.bwd_plan(rows, n, t)
    for l, box in enumerate(jboxes):
        if box is None:
            assert plan.spans[l] == 0 and l in plan.paged
            continue
        assert plan.spans[l] == jhw.box_morton_span(box[3:])
        assert jhw.box_dense_ok(box[3:], t)
        assert l in (plan.dense if plan.spans[l] <= thw.DENSE_SMEM_SPAN
                     else plan.wide)
    assert sorted(plan.paged + plan.dense + plan.wide) == list(range(16))
    # shared memory a block holds: a page, a dense span, a cluster's share
    # (f32 pairs, 8 bytes an entry; the variant's int64 pairs, 16)
    assert max(plan.spans[l] for l in plan.dense) * 8 <= 32768
    assert thw.WIDE_SPAN // thw.CLUSTER_BLOCKS * 8 <= 232448
    assert max(plan.spans[l] for l in plan.dense) * 16 <= 65536
    assert thw.WIDE_SPAN // thw.CLUSTER_BLOCKS * 16 <= 232448
    n_seg = t // 1024
    assert plan.work_ints == (4 * (-(-n // C) + n_seg) + 2 * n_seg + 4
                              + min(n_seg, n // (C + 1)) + n)
    assert plan.partial_entries == (
        plan.dense_parts * sum(plan.spans[l] for l in plan.dense)
        + plan.wide_parts * thw.WIDE_SPAN * len(plan.wide))


def test_plan_wide_span_box():
    """A calibrated box of 20^3 cells spans 32,768 in JAX and goes to the
    cluster kernel; the largest span one block sums is 4,096."""
    t = 1 << 19
    box = (10, 10, 10, 20, 20, 20)
    assert jhw.box_morton_span(box[3:]) == thw.WIDE_SPAN
    assert jhw.box_dense_ok(box[3:], t)
    assert jhw.box_morton_span((14, 14, 14)) == thw.DENSE_SMEM_SPAN
    rows = thw.level_scalars((64, 2048), t, (box, None))
    plan = thw.bwd_plan(rows, 1000, t)
    assert plan.wide == (0,) and plan.paged == (1,) and plan.dense == ()
    assert plan.wide_parts == 1 and plan.partial_entries == thw.WIDE_SPAN
