"""The port's HashGridField against the JAX HashGridField with parameters
carried across by `convert.py`: raw outputs and parameter gradients, in f32
and in bf16 (tolerances stated below), for the windowed index
(impl="win_xla") and the instant-NGP index (impl="xla"), whose corner
indices are bit-identical to JAX's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spinnerf_tpu.models.hashgrid import HashGridEncoding as JEnc
from spinnerf_tpu.models.hashgrid import HashGridField as JField
from spinnerf_tpu.models.hashgrid import (calibrate_dense_box,
                                          calibrate_page_bounds,
                                          level_resolutions)
from spinnerf_tpu_torch.convert import field_state_dict
from spinnerf_tpu_torch.models.hashgrid import HashGridEncoding as TEnc
from spinnerf_tpu_torch.models.hashgrid import HashGridField as TField
from spinnerf_tpu_torch.ops import hash_encode as the

torch.set_num_threads(1)

SMALL = dict(bound=2.0, n_levels=6, log2_table_size=13, base_res=4,
             finest_res_per_unit=64.0, hidden_dim=16, hidden_dim_color=16)


def _inputs(seed, b=24, s=10):
    rng = np.random.RandomState(seed)
    pts = (rng.rand(b, s, 3) * 1.2 - 0.6).astype(np.float32)
    pts[0, 0] = 2.0                                  # on the bound
    vd = rng.randn(b, 3).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    g = rng.randn(b, s, 5).astype(np.float32)
    return pts, vd, g


def _calibration(pts):
    x01 = np.clip((pts.reshape(-1, 3) + SMALL["bound"])
                  / (2 * SMALL["bound"]), 0, 1)
    res = level_resolutions(SMALL["n_levels"], SMALL["base_res"],
                            SMALL["finest_res_per_unit"] * SMALL["bound"])
    return (calibrate_page_bounds(x01, SMALL["log2_table_size"]),
            calibrate_dense_box(x01, res, SMALL["log2_table_size"]))


def _pair(semantic, dtype_name, calibrated, seed=0):
    pts, vd, g = _inputs(seed)
    page_bounds, dense_box = _calibration(pts) if calibrated else (None, None)
    jf = JField(**SMALL, semantic=semantic, impl="win_xla",
                compute_dtype=getattr(jnp, dtype_name),
                page_bounds=page_bounds, dense_box=dense_box)
    params = jf.init(jax.random.PRNGKey(seed), jnp.asarray(pts),
                     jnp.asarray(vd))
    # a trained-looking table: the init's +-1e-4 would hide the encode
    rng = np.random.RandomState(seed + 1)
    tab = params["params"]["encoder"]["table"]
    params["params"]["encoder"]["table"] = jnp.asarray(
        rng.randn(*tab.shape).astype(np.float32) * 0.5)
    tf = TField(**SMALL, semantic=semantic,
                compute_dtype=getattr(torch, dtype_name),
                page_bounds=page_bounds, dense_box=dense_box, device="cpu")
    tf.load_state_dict(field_state_dict(jax.tree.map(np.asarray, params)))
    return jf, params, tf, pts, vd, g


def _compare(semantic, dtype_name, calibrated, tol, grad_tol):
    jf, params, tf, pts, vd, g = _pair(semantic, dtype_name, calibrated)
    c = 5 if semantic else 4
    g = g[..., :c]

    def jloss(p):
        return jnp.sum(jf.apply(p, jnp.asarray(pts), jnp.asarray(vd))
                       * jnp.asarray(g))

    raw_j = np.asarray(jf.apply(params, jnp.asarray(pts), jnp.asarray(vd)))
    grads_j = field_state_dict(jax.tree.map(np.asarray,
                                            jax.grad(jloss)(params)))
    raw_t = tf(torch.from_numpy(pts), torch.from_numpy(vd))
    assert raw_t.shape == raw_j.shape == (24, 10, c)
    assert raw_t.dtype == torch.float32
    (raw_t * torch.from_numpy(g)).sum().backward()

    def rel_err(a, b):
        return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))

    assert rel_err(raw_t.detach().numpy(), raw_j) < tol
    for name, p in tf.named_parameters():
        assert rel_err(p.grad.numpy(), grads_j[name].numpy()) < grad_tol, name


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("semantic", [False, True])
def test_field_f32_matches_jax(semantic, calibrated):
    _compare(semantic, "float32", calibrated, tol=1e-5, grad_tol=1e-5)


@pytest.mark.parametrize("semantic", [False, True])
def test_field_bf16_matches_jax(semantic):
    """bf16 keeps 8 significant bits (a relative step of 2^-8 = 3.9e-3).
    The frameworks round at different points — torch's bf16 linear adds the
    bias before its one rounding, flax rounds the product and then the sum —
    so each of the 4 bf16 layers may differ by about one step and the
    differences compound through the ReLUs: 2^-8 x 4 layers x 2 gives the
    3e-2 relative bound (max-normalized) on the raw output. A weight or bias
    gradient is a bf16 sum over the 240 points, whose partial sums the
    frameworks round differently: a random walk of sqrt(240) ~ 15 steps of
    2^-8 gives the 6e-2 bound on gradients."""
    _compare(semantic, "bfloat16", True, tol=3e-2, grad_tol=6e-2)


def test_field_init_is_seeded_and_device_independent():
    a = TField(**SMALL, compute_dtype=torch.float32, device="cpu")
    b = TField(**SMALL, compute_dtype=torch.float32, device="cpu")
    a.reset_parameters(torch.Generator().manual_seed(3))
    b.reset_parameters(torch.Generator().manual_seed(3))
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    assert float(a.encoder.table.abs().max()) <= 1e-4
    assert all(float(m.bias.abs().max()) == 0 for m in a._linears())


# --- the instant-NGP index ("mxu" / "xla") -----------------------------------


def _unit_points(seed, n=700):
    """Clustered and uniform points plus points exactly on 0.0 and 1.0 (a
    point at 1.0 reaches corner r+1, which `% T` wraps)."""
    rng = np.random.RandomState(seed)
    x = np.concatenate([0.48 + 0.04 * rng.rand(n // 2, 3),
                        rng.rand(n - n // 2, 3)]).astype(np.float32)
    x[:8] = 1.0
    x[8:16] = 0.0
    x[16:24, 0] = 1.0
    x[24:32, 1] = 0.0
    return x


# (log2 T, levels, base, finest): all levels hashed at the reference's 2^12
# and 2^19 widths; dense coarse and hashed fine levels at the small sizes
IDX_SIZES = [(8, 4, 4, 64.0), (12, 16, 16, 2048.0 * 100),
             (14, 6, 4, 64.0), (19, 16, 16, 2048.0 * 100)]


@pytest.mark.parametrize("log2t,levels,base,finest", IDX_SIZES)
def test_corner_indices_bit_identical(log2t, levels, base, finest):
    kw = dict(n_levels=levels, log2_table_size=log2t, base_res=base,
              finest_res=finest)
    x = _unit_points(log2t)
    idx_j, w_j = JEnc(**kw, impl="xla").corner_indices_weights(
        jnp.asarray(x))
    enc = TEnc(**kw, impl="xla", device="cpu")
    idx_t, w_t = enc.corner_indices_weights(torch.from_numpy(x))
    assert idx_t.dtype == torch.int32 and idx_t.shape == (levels, 8, len(x))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0,
                               atol=1e-7)
    dense = [(r + 1) ** 3 <= (1 << log2t) for r in enc.resolutions]
    if log2t in (8, 14):
        assert any(dense) and not all(dense)


# six levels at resolutions 4..63: levels 0-1 dense, the rest hashed at 2^10
SMALL_IDX = dict(SMALL, log2_table_size=10)


def _idx_pair(semantic, dtype_name, seed=0):
    pts, vd, g = _inputs(seed)
    jf = JField(**SMALL_IDX, semantic=semantic, impl="xla",
                compute_dtype=getattr(jnp, dtype_name))
    params = jf.init(jax.random.PRNGKey(seed), jnp.asarray(pts),
                     jnp.asarray(vd))
    rng = np.random.RandomState(seed + 1)
    tab = params["params"]["encoder"]["table"]
    params["params"]["encoder"]["table"] = jnp.asarray(
        rng.randn(*tab.shape).astype(np.float32) * 0.5)
    tf = TField(**SMALL_IDX, semantic=semantic, impl="xla",
                compute_dtype=getattr(torch, dtype_name), device="cpu")
    tf.load_state_dict(field_state_dict(jax.tree.map(np.asarray, params)))
    return jf, params, tf, pts, vd, g


def _idx_outputs(semantic, dtype_name):
    """(port raw, JAX raw, {param: (port grad, JAX grad)}) as numpy."""
    jf, params, tf, pts, vd, g = _idx_pair(semantic, dtype_name)
    g = g[..., :5 if semantic else 4]

    def jloss(p):
        return jnp.sum(jf.apply(p, jnp.asarray(pts), jnp.asarray(vd))
                       * jnp.asarray(g))

    raw_j = np.asarray(jf.apply(params, jnp.asarray(pts), jnp.asarray(vd)))
    grads_j = field_state_dict(jax.tree.map(np.asarray,
                                            jax.grad(jloss)(params)))
    raw_t = tf(torch.from_numpy(pts), torch.from_numpy(vd))
    (raw_t * torch.from_numpy(g)).sum().backward()
    return (raw_t.detach().numpy(), raw_j,
            {n: (p.grad.numpy(), grads_j[n].numpy())
             for n, p in tf.named_parameters()})


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


@pytest.mark.parametrize("semantic", [False, True])
def test_field_xla_f32_matches_jax(semantic):
    """impl="xla" in f32: the same index, gather and blend in both, so raw
    outputs and every parameter gradient agree within 1.5e-6."""
    raw_t, raw_j, grads = _idx_outputs(semantic, "float32")
    assert _rel(raw_t, raw_j) <= 1.5e-6
    for name, (a, b) in grads.items():
        assert _rel(a, b) <= 1.5e-6, name


@pytest.mark.parametrize("semantic", [False, True])
def test_field_xla_bf16_matches_jax(semantic):
    """impl="xla" in bf16. Both packages multiply the 8 corners in bf16, sum
    them with an f32 accumulator rounded to bf16 and scatter-add the table
    gradient in bf16 (JAX's `hashgrid.py:302-310`; the port's encoder casts
    the table to `compute_dtype` before `hash_encode_xla`). The MLPs' bf16
    matmuls round differently in the two libraries, so raw outputs differ
    by a few bf16 steps (bound 1e-2 of max |value|). Gradients are sums over
    240 points of values that differ by bf16 steps and flipped ReLUs, so
    their small entries differ by up to 30 % while each gradient keeps its
    direction and size (bounds: cosine 0.98, norms within 10 %)."""
    raw_t, raw_j, grads = _idx_outputs(semantic, "bfloat16")
    assert _rel(raw_t, raw_j) <= 1e-2
    for name, (a, b) in grads.items():
        a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos >= 0.98, (name, cos)
        assert abs(np.linalg.norm(a) / np.linalg.norm(b) - 1) <= 0.1, name


def test_auto_small_table_takes_the_index_gather_route():
    """auto below 2^13 entries is "mxu" (the JAX package's TPU choice): the
    instant-NGP index through `hash_encode_mxu`; from 2^13 it is "win"."""
    enc = TEnc(n_levels=4, log2_table_size=12, base_res=4, finest_res=64.0,
               compute_dtype=torch.float32, device="cpu")
    assert enc.impl == "mxu"
    enc.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_unit_points(0, 200))
    idx, w = enc.corner_indices_weights(x)
    want = the.hash_encode_xla(enc.table, idx, w).reshape(200, 8)
    assert torch.equal(enc(x), want)
    assert TEnc(log2_table_size=13, device="cpu").impl == "win"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("features", [1, 4, 8])
def test_features_xla_matches_jax(features, dtype):
    """B1d: features 1, 4 and 8 under `auto` take "xla" in both packages
    (JAX's `_resolve_impl`); the port's encode and table gradient equal
    JAX's on the same table and points: f32 within 1e-6 of the largest
    value, bf16 (the same casts and the same f32 accumulation) within
    2^-8 of it (bf16's unit roundoff; measured equal)."""
    kw = dict(n_levels=6, features=features, log2_table_size=10, base_res=4,
              finest_res=64.0)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.RandomState(features)
    table = rng.uniform(-1, 1, (6, 1 << 10, features)).astype(np.float32)
    x = _unit_points(features)
    g = rng.randn(len(x), 6 * features).astype(np.float32)
    jenc = JEnc(**kw, compute_dtype=jdt)

    def jax_loss(tab):
        out = jenc.apply({"params": {"table": tab}}, jnp.asarray(x))
        return jnp.sum(out.astype(jnp.float32) * g), out

    (_, out_j), grad_j = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(table))
    out_j = np.asarray(out_j.astype(jnp.float32))
    grad_j = np.asarray(grad_j)
    enc = TEnc(**kw, compute_dtype=tdt, device="cpu")
    assert enc.impl == "xla"
    with torch.no_grad():
        enc.table.copy_(torch.from_numpy(table))
    out_t = enc(torch.from_numpy(x))
    assert out_t.dtype == tdt and out_t.shape == (len(x), 6 * features)
    (out_t.float() * torch.from_numpy(g)).sum().backward()
    tol = 1e-6 if dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(out_t.detach().float().numpy(), out_j,
                               rtol=0, atol=tol * np.abs(out_j).max())
    np.testing.assert_allclose(enc.table.grad.numpy(), grad_j, rtol=0,
                               atol=tol * np.abs(grad_j).max())
