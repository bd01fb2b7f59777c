"""The port's windowed hash index and plain encode against the JAX package's
(`spinnerf_tpu/ops/hash_encode_win.py`, `models/hashgrid.py`): corner
indices bit-identical, weights within 1e-7, calibration tuples equal, the
encode and its table gradient within 1e-6."""
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

# dense (res <= 7 under the default boxes), mid and fine levels
RES = (4, 7, 16, 45, 300, 5000)


def _points(seed, n=600, boundary=True):
    """Clustered points (a scene occupying a small part of the cube, as at
    bound=100) plus uniform ones and exact boundary points x == 1.0."""
    rng = np.random.RandomState(seed)
    x = np.concatenate([0.48 + 0.04 * rng.rand(n // 2, 3),
                        rng.rand(n - n // 2, 3)]).astype(np.float32)
    if boundary:
        x[:8] = 1.0
        x[8:16, 0] = 1.0
        x[16:24, 2] = 0.0
    return x


def _calibrated(x, log2_t, res):
    return (jhg.calibrate_page_bounds(x, log2_t),
            jhg.calibrate_dense_box(x[:300], res, log2_t))


def _cases():
    x = _points(0)
    cal_b, cal_box = _calibrated(x, 13, RES)
    n_seg = (1 << 13) // 1024
    repeated = (0, 5000, 5000, 5000, 90000, 90000, 1 << 20, (1 << 27) - 1)
    assert len(repeated) == n_seg
    return {
        "uniform": (None, None),
        "calibrated": (cal_b, None),
        "repeated_bounds": (repeated, None),
        # boxes from the clustered half only: the uniform half queries
        # outside them and clamps to the box faces
        "dense_box_out_of_box": (cal_b, cal_box),
        "dense_box_uniform_bounds": (None, cal_box),
    }


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("log2_t", [13, 14])
def test_corner_indices_bit_identical(case, log2_t):
    page_bounds, dense_box = CASES[case]
    if log2_t != 13 and page_bounds is not None:
        x0 = _points(0)
        page_bounds = jhg.calibrate_page_bounds(x0, log2_t)
    if log2_t != 13 and dense_box is not None:
        dense_box = jhg.calibrate_dense_box(_points(0)[:300], RES, log2_t)
    t = 1 << log2_t
    x = _points(1)
    idx_j, w_j = jhw.corner_indices_weights_win(
        jnp.asarray(x.T), RES, t, page_bounds, dense_box)
    idx_t, w_t = thw.corner_indices_weights_win(
        torch.from_numpy(x), RES, t, page_bounds, dense_box)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0,
                               atol=1e-7)
    assert idx_t.min() >= 0 and idx_t.max() < t


def test_boundary_point_clamped_to_grid():
    """x == 1.0 indexes the grid's last cell with frac 1, so all weight sits
    on the +1 corner, in both packages."""
    x = np.ones((4, 3), np.float32)
    res = (4, 7)
    idx, w = thw.corner_indices_weights_win(torch.from_numpy(x), res, 1 << 12)
    np.testing.assert_allclose(w[:, 7].numpy(), 1.0)
    for li, r in enumerate(res):
        assert int(idx[li].max()) < (1 << int(np.ceil(np.log2(r + 1)))) ** 3
    idx_j, _ = jhw.corner_indices_weights_win(jnp.asarray(x.T), res, 1 << 12)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))


def test_page_lookup_repeated_bounds():
    """searchsorted(right=True) - 1 equals #(bounds <= key) - 1 when bounds
    repeat."""
    bounds = (0, 7, 7, 7, 100, 100, 4096, 4096)
    z = torch.tensor([0, 6, 7, 8, 99, 100, 4095, 4096, 5000])
    base, capm = thw.page_lookup(z, 8 * 1024, bounds)
    jb, jc = jhw.page_lookup(jnp.asarray(z.numpy(), jnp.int32), 8 * 1024,
                             bounds)
    np.testing.assert_array_equal(base.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(capm.numpy(), np.asarray(jc))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_calibration_tuples_equal(seed):
    x = _points(seed, n=2000, boundary=False)
    for log2_t in (11, 13, 14):
        assert (thg.calibrate_page_bounds(x, log2_t)
                == jhg.calibrate_page_bounds(x, log2_t))
    res = thg.level_resolutions(16, 16, 2048.0 * 100)
    assert res == jhg.level_resolutions(16, 16, 2048.0 * 100)
    assert (thg.calibrate_dense_box(x[:500], res, 13)
            == jhg.calibrate_dense_box(x[:500], res, 13))


@pytest.mark.parametrize("case", ["uniform", "calibrated",
                                  "dense_box_out_of_box"])
def test_plain_encode_and_table_grad(case):
    page_bounds, dense_box = CASES[case]
    t = 1 << 13
    rng = np.random.RandomState(3)
    x = _points(4)
    table = rng.randn(len(RES), t, 2).astype(np.float32)
    g = rng.randn(len(x), 2 * len(RES)).astype(np.float32)

    def jax_out(tab):
        idx, w = jhw.corner_indices_weights_win(
            jnp.asarray(x.T), RES, t, page_bounds, dense_box)
        return jhw.hash_encode_exact(tab, idx, w)

    out_j = np.asarray(jax_out(jnp.asarray(table)))
    grad_j = np.asarray(jax.grad(
        lambda tab: jnp.sum(jax_out(tab) * jnp.asarray(g)))(jnp.asarray(table)))

    tab_t = torch.from_numpy(table).requires_grad_()
    out_t = thw.hash_encode_win_fused(tab_t, torch.from_numpy(x), RES,
                                      page_bounds, dense_box)
    (out_t * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), out_j, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tab_t.grad.numpy(), grad_j, rtol=0, atol=1e-6)
    assert thw.launches == {"fwd": 0, "bwd": 0}   # CPU: no kernel launched


def test_unported_impl_raises():
    """`auto` resolves as JAX's `_resolve_impl`: features != 2 (and tables
    under 64 entries) take "xla", the gather summed in `compute_dtype`,
    which runs on any device; at features=4 and 2^13 entries it equals
    JAX's `HashGridEncoding` in bf16 within 2^-8 of the largest output
    (bf16's unit roundoff; measured equal), forward and table gradient. An explicit
    "mxu", "win" or "win_xla" with features != 2 raises ValueError, as
    JAX's kernels do; an unknown impl is refused."""
    kw = dict(n_levels=4, features=4, log2_table_size=13, base_res=4,
              finest_res=64.0)
    enc = thg.HashGridEncoding(**kw, device="cpu")
    assert enc.impl == "xla" and enc.compute_dtype == torch.bfloat16
    rng = np.random.RandomState(3)
    table = rng.uniform(-1, 1, (4, 1 << 13, 4)).astype(np.float32)
    x = _points(3)
    g = rng.randn(len(x), 16).astype(np.float32)
    jenc = jhg.HashGridEncoding(**kw)

    def jax_loss(tab):
        out = jenc.apply({"params": {"table": tab}}, jnp.asarray(x))
        return jnp.sum(out.astype(jnp.float32) * g), out

    (_, out_j), grad_j = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(table))
    out_j = np.asarray(out_j.astype(jnp.float32))
    with torch.no_grad():
        enc.table.copy_(torch.from_numpy(table))
    out_t = enc(torch.from_numpy(x))
    assert out_t.dtype == torch.bfloat16 and out_t.shape == (len(x), 16)
    (out_t.float() * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out_t.detach().float().numpy(), out_j,
                               rtol=0, atol=2.0 ** -8 * np.abs(out_j).max())
    grad_j = np.asarray(grad_j)
    np.testing.assert_allclose(enc.table.grad.numpy(), grad_j, rtol=0,
                               atol=2.0 ** -8 * np.abs(grad_j).max())
    assert thg.HashGridEncoding(log2_table_size=5, device="cpu").impl == "xla"
    for impl in ("mxu", "win", "win_xla"):
        with pytest.raises(ValueError, match="features=2"):
            thg.HashGridEncoding(log2_table_size=13, features=4, impl=impl,
                                 device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        thg.HashGridEncoding(log2_table_size=13, impl="tcnn", device="cpu")
