"""The port's HashGridField against the JAX HashGridField(impl="win_xla")
with parameters carried across by `convert.py`: raw outputs and parameter
gradients, in f32 (1e-5) and in bf16 (tolerance stated below)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spinnerf_tpu.models.hashgrid import HashGridField as JField
from spinnerf_tpu.models.hashgrid import (calibrate_dense_box,
                                          calibrate_page_bounds,
                                          level_resolutions)
from spinnerf_tpu_torch.convert import field_state_dict
from spinnerf_tpu_torch.models.hashgrid import HashGridField as TField

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
