"""The schedule of the port's windowed hash-encode backward
(`spinnerf_tpu_torch/csrc/hash_encode_win.cu::he_win_bwd`) against the JAX
package (`spinnerf_tpu/ops/hash_encode_win.py`).

`bwd_plan` (per-level regime and span, partial sums and scratch that the
wrapper passes to the CUDA source) is held against JAX `box_morton_span` /
`box_dense_ok` on calibrated boxes. A plain emulation of the kernels'
schedule in f32 (the forward's counting sort by segment, chunks of
`CHUNK_POINTS` points, a page accumulator per (chunk, paged level) flushed by store or by
addition, per-slice partial sums of the dense spans reduced afterwards)
must write every entry and give JAX `hash_encode_exact`'s table gradient
within 1e-6 of its largest entry (the gradient evaluated in float64, as
chip_smoke.py holds the kernel)."""
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
    assert max(plan.spans[l] for l in plan.dense) * 8 <= 32768
    assert thw.WIDE_SPAN // thw.CLUSTER_BLOCKS * 8 <= 232448
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
