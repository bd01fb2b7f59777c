"""The port's NeRFField against the flax NeRFField, with parameters carried
across by `convert.py`: raw outputs and parameter gradients in f32 (1e-5)
and in bf16 (tolerance stated below), with and without the view branch and
the semantic head, and the field function."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spinnerf_tpu.models.fields import NeRFField as JField
from spinnerf_tpu.models.fields import make_field_fn as jmake_field_fn
from spinnerf_tpu_torch.convert import field_state_dict, nerf_field_tree
from spinnerf_tpu_torch.models.fields import NeRFField as TField
from spinnerf_tpu_torch.models.fields import make_field_fn

torch.set_num_threads(1)

SMALL = dict(depth=6, width=32, multires=6, multires_views=3)


def _inputs(seed, b=6, s=7):
    rng = np.random.RandomState(seed)
    pts = (rng.randn(b, s, 3) * 1.5).astype(np.float32)
    vd = rng.randn(b, 3).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    g = rng.randn(b, s, 5).astype(np.float32)
    return pts, vd, g


def _pair(dtype_name, seed=0, **kw):
    pts, vd, g = _inputs(seed)
    jf = JField(**SMALL, compute_dtype=getattr(jnp, dtype_name), **kw)
    params = jf.init(jax.random.PRNGKey(seed), jnp.asarray(pts),
                     jnp.asarray(vd))
    # non-zero biases, so that the bias paths carry signal
    rng = np.random.RandomState(seed + 1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: (jnp.asarray(rng.randn(*v.shape).astype(np.float32)
                                     * 0.1)
                         if path[-1].key == "bias" else v), params)
    tf = TField(**SMALL, compute_dtype=getattr(torch, dtype_name),
                device="cpu", **kw)
    tf.load_state_dict(field_state_dict(jax.tree.map(np.asarray, params)))
    return jf, params, tf, pts, vd, g


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _compare(dtype_name, tol, grad_tol, **kw):
    jf, params, tf, pts, vd, g = _pair(dtype_name, **kw)
    c = 5 if kw.get("semantic") else 4
    g = g[..., :c]

    def jloss(p):
        return jnp.sum(jf.apply(p, jnp.asarray(pts), jnp.asarray(vd))
                       * jnp.asarray(g))

    raw_j = np.asarray(jf.apply(params, jnp.asarray(pts), jnp.asarray(vd)))
    grads_j = field_state_dict(jax.tree.map(np.asarray,
                                            jax.grad(jloss)(params)))
    raw_t = tf(torch.from_numpy(pts), torch.from_numpy(vd))
    assert raw_t.shape == raw_j.shape == (6, 7, c)
    assert raw_t.dtype == torch.float32
    (raw_t * torch.from_numpy(g)).sum().backward()
    assert _rel(raw_t.detach().numpy(), raw_j) < tol
    assert {n for n, _ in tf.named_parameters()} == set(grads_j)
    for name, p in tf.named_parameters():
        assert _rel(p.grad.numpy(), grads_j[name].numpy()) < grad_tol, name


VARIANTS = {"default": {}, "semantic": dict(semantic=True),
            "no_viewdirs": dict(use_viewdirs=False)}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_field_f32_matches_jax(variant):
    _compare("float32", 1e-5, 1e-5, **VARIANTS[variant])


# bf16: both sides round as flax's Dense(dtype=bfloat16) does: the bf16
# product (f32 accumulation) rounds to bf16, then the bf16 bias add rounds
# again; the forward could then differ only where an f32 sum taken in
# another order lands on the other side of a bf16 rounding boundary. The
# backward runs in bf16 on both sides and the frameworks round its partial
# sums at different points. Measured: raw 0, gradients <= 1.7e-2 (a bias, a
# bf16 sum over the 42 points; max-normalized); bounds 1e-4 and 4e-2. The
# forward bound catches a rounding left out: one rounding of product and
# bias together moves raw by >= 4.1e-3 at these inputs, a bias added in f32
# by >= 1.3e-3 (checked once on the CPU).
BF16_TOL = 1e-4


@pytest.mark.parametrize("variant", ["default", "semantic"])
def test_field_bf16_matches_jax(variant):
    _compare("bfloat16", BF16_TOL, 4e-2, **VARIANTS[variant])


def test_field_fn_matches_jax():
    """`make_field_fn` over the bf16 field without view directions."""
    jf, params, tf, pts, vd, _ = _pair("bfloat16", use_viewdirs=False)
    want = np.asarray(jmake_field_fn(jf, params)(jnp.asarray(pts),
                                                 jnp.asarray(vd)))
    got = make_field_fn(tf)(torch.from_numpy(pts), torch.from_numpy(vd))
    assert got.shape == want.shape == (6, 7, 4)
    assert _rel(got.detach().numpy(), want) < BF16_TOL


def test_tree_round_trip_and_seeded_init():
    a = TField(**SMALL, compute_dtype=torch.float32, device="cpu")
    b = TField(**SMALL, compute_dtype=torch.float32, device="cpu")
    a.reset_parameters(torch.Generator().manual_seed(3))
    b.reset_parameters(torch.Generator().manual_seed(3))
    sd = field_state_dict(nerf_field_tree(a))
    for n, p in a.named_parameters():
        assert torch.equal(p, b.get_parameter(n)), n
        assert torch.equal(p, sd[n]), n
    assert float(a.trunk_0.bias.detach().abs().max()) == 0.0
    # the skip layer's input is [pe, h]: 3 * (1 + 2 * 6) + 32 wide
    assert tuple(a.trunk_5.weight.shape) == (32, 39 + 32)
