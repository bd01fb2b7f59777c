"""The port's v1 fused MLP (`fused_mlp` / `make_fused_field_fn` in
`spinnerf_tpu_torch/ops/fused_mlp.py`: encodings computed outside the
kernels, input gradients returned) against the JAX `make_fused_field_fn`,
whose Pallas kernels (`_fwd_kernel` / `_bwd_kernel`) run in interpret mode
on the CPU. Same numpy-made weights, points, directions and cotangents on
both sides; every tensor compared relative to its largest |value|
(tolerances stated per test)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spinnerf_tpu.models.fields import NeRFField as JNeRFField
from spinnerf_tpu.ops import fused_mlp as jfm
from spinnerf_tpu_torch import convert
from spinnerf_tpu_torch.models.embedding import positional_encoding
from spinnerf_tpu_torch.ops import fused_mlp as tfm

torch.set_num_threads(1)

BLOCK = 64
B, S = 5, 13            # 65 points: not a multiple of the block


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _setup(semantic, dtype_name, seed=0):
    rng = np.random.RandomState(seed)
    pts = (rng.randn(B, S, 3) * 1.5).astype(np.float32)
    vd = rng.randn(B, 3).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    model = JNeRFField(semantic=semantic, compute_dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(seed), jnp.asarray(pts),
                        jnp.asarray(vd))
    dims = jfm.dims_for_field(semantic=semantic)._replace(
        compute_dtype=dtype_name)
    jw = jfm.params_to_fused(params, dims, raw_in_dim=63, raw_dir_dim=27)
    jw = {n: np.asarray(v) for n, v in jw.items()}
    # non-zero biases, so that every bias path carries signal
    for n in jw:
        if n.endswith("_b") or n.startswith("tb"):
            jw[n] = (rng.randn(*jw[n].shape) * 0.1).astype(np.float32)
    g = rng.randn(B, S, 4 + dims.out_extra).astype(np.float32)
    return dims, jw, pts, vd, g


def _run_jax(dims, jw, pts, vd, g):
    field = jfm.make_fused_field_fn(dims, block=BLOCK)
    out, vjp = jax.vjp(field, {n: jnp.asarray(v) for n, v in jw.items()},
                       jnp.asarray(pts), jnp.asarray(vd))
    grads, dpts, dvd = vjp(jnp.asarray(g))
    return (np.asarray(out), {n: np.asarray(v) for n, v in grads.items()},
            np.asarray(dpts), np.asarray(dvd))


def _run_port(dims, jw, pts, vd, g):
    tdims = tfm.MLPDims(**dims._asdict())
    w = {n: v.requires_grad_() for n, v in convert.fused_weights(jw).items()}
    pts_t = torch.from_numpy(pts).requires_grad_()
    vd_t = torch.from_numpy(vd).requires_grad_()
    field = tfm.make_fused_field_fn(tdims, block=BLOCK)
    out = field(w, pts_t, vd_t)
    out.backward(torch.from_numpy(g))
    return (out.detach().numpy(), {n: v.grad.numpy() for n, v in w.items()},
            pts_t.grad.numpy(), vd_t.grad.numpy())


def _compare(got, want, tol, grad_tol):
    out_t, grads_t, dpts_t, dvd_t = got
    out_j, grads_j, dpts_j, dvd_j = want
    assert out_t.shape == out_j.shape
    assert _rel(out_t, out_j) < tol
    assert set(grads_t) == set(grads_j)
    for n in grads_j:
        assert grads_t[n].shape == grads_j[n].shape, n
        assert _rel(grads_t[n], grads_j[n]) < grad_tol, n
    assert dpts_t.shape == dpts_j.shape == (B, S, 3)
    assert dvd_t.shape == dvd_j.shape == (B, 3)
    assert _rel(dpts_t, dpts_j) < grad_tol
    assert _rel(dvd_t, dvd_j) < grad_tol


# f32: both sides compute the same f32 products in another summation order
# (and the encodings' sin/cos in two libraries); the JAX tests' bound of
# 1e-4 of max |value| (tests/test_fused_mlp.py), for the forward, every
# weight gradient and the gradients of the points and the view directions.
# Measured: <= 1.6e-6 (a bias gradient).
@pytest.mark.parametrize("semantic", [False, True])
def test_f32_field_matches_jax(semantic):
    dims, jw, pts, vd, g = _setup(semantic, "float32")
    want = _run_jax(dims, jw, pts, vd, g)
    got = _run_port(dims, jw, pts, vd, g)
    assert got[0].shape == (B, S, 4 + dims.out_extra)
    _compare(got, want, 1e-4, 1e-4)


# bf16: the operands round to bf16 at the same points on both sides and v1's
# bias gradients are sums of f32 gradients on both sides. An f32 sum taken
# in another order can still cross a bf16 rounding boundary and move that
# activation by one bf16 step (2^-8 relative): at seed 1 one does (forward
# 6.3e-4, gradients 8.2e-4). At seed 0 none does: measured forward 1.2e-7,
# gradients (weights, points, directions) <= 2.7e-6; bound 1e-4, so that a
# rounding point moved (v2's bf16 rounding of the gradients before the bias
# sums, 2^-9 of a bias gradient) fails it.
def test_bf16_field_matches_jax():
    dims, jw, pts, vd, g = _setup(False, "bfloat16", seed=0)
    want = _run_jax(dims, jw, pts, vd, g)
    got = _run_port(dims, jw, pts, vd, g)
    _compare(got, want, 1e-4, 1e-4)


def _encodings(dims, rng, p):
    """Encoded inputs as make_fused_field_fn builds them, [p, 128] each."""
    pts = torch.from_numpy((rng.randn(p, 3) * 1.5).astype(np.float32))
    vd = torch.from_numpy(rng.randn(p, 3).astype(np.float32))
    x = positional_encoding(pts, 10)
    d = positional_encoding(vd, 4)
    return (torch.nn.functional.pad(x, (0, dims.in_dim - 63)),
            torch.nn.functional.pad(d, (0, dims.dir_dim - 27)))


def test_fused_mlp_input_gradients_match_jax_and_pad_lanes_are_zero():
    """`fused_mlp` on given encodings: dx and dd against the JAX kernel's
    (same 1e-4 f32 bound), and the padded lanes of dx (63..127), dd
    (27..127) and of W0's gradient (rows 63..127) exactly 0."""
    dims, jw, _, _, _ = _setup(False, "float32")
    rng = np.random.RandomState(2)
    x, d = _encodings(dims, rng, 128)
    g = rng.randn(128, 4).astype(np.float32)
    jweights = {n: jnp.asarray(v) for n, v in jw.items()}
    _, vjp = jax.vjp(lambda w, a, b: jfm.fused_mlp(dims, BLOCK, w, a, b),
                     jweights, jnp.asarray(x.numpy()), jnp.asarray(d.numpy()))
    gw_j, dx_j, dd_j = vjp(jnp.asarray(g))

    tdims = tfm.MLPDims(**dims._asdict())
    w = {n: v.requires_grad_() for n, v in convert.fused_weights(jw).items()}
    xt, dt = x.clone().requires_grad_(), d.clone().requires_grad_()
    tfm.fused_mlp(tdims, BLOCK, w, xt, dt).backward(torch.from_numpy(g))
    assert _rel(xt.grad.numpy(), dx_j) < 1e-4
    assert _rel(dt.grad.numpy(), dd_j) < 1e-4
    assert _rel(w["tw0"].grad.numpy(), gw_j["tw0"]) < 1e-4
    assert float(xt.grad[:, 63:].abs().max()) == 0.0
    assert float(dt.grad[:, 27:].abs().max()) == 0.0
    assert float(w["tw0"].grad[63:].abs().max()) == 0.0
    assert float(w["tw5"].grad[63:128].abs().max()) == 0.0
    assert float(xt.grad[:, :63].abs().max()) > 0.0
    assert float(dt.grad[:, :27].abs().max()) > 0.0


def test_v1_and_v2_plain_share_the_forward_and_differ_in_bias_rounding():
    """On the encodings the v2 kernel computes, the v1 plain forward equals
    the v2 plain forward bit for bit, and so do the weight-gradient products;
    the bias gradients differ only by v2's bf16 rounding of the gradients
    (within 2^-8 relative)."""
    dims = tfm.dims_for_field()
    f = tfm.FusedMLPField(device="cpu")
    f.reset_parameters(torch.Generator().manual_seed(3))
    w = {n: p.detach() for n, p in f.weights.items()}
    rng = np.random.RandomState(4)
    xd = torch.zeros(64, 8)
    xd[:, :6] = torch.from_numpy(rng.randn(64, 6).astype(np.float32))
    g = torch.from_numpy(rng.randn(64, 4).astype(np.float32))
    x, d = tfm.encode(xd, 10, 0, 128), tfm.encode(xd, 4, 3, 128)
    assert torch.equal(tfm.fused_mlp_fwd_plain(w, x, d, dims),
                       tfm.fused_mlp_pe_plain(w, xd, dims))
    d1, _, _ = tfm.fused_mlp_bwd_plain(w, x, d, g, dims)
    d2 = tfm.fused_mlp_pe_bwd_plain(w, xd, g, dims)
    for n in ("rgb_w", "rgb_b", "sigma_w", "sigma_b", "view_w"):
        assert torch.equal(d1[n], d2[n]), n
    for n in ("view_b", "feat_b", "tb7", "tb0"):
        assert _rel(d1[n].numpy(), d2[n].numpy()) < 2 ** -8, n


def test_kernel_wrappers_take_no_cpu_tensors():
    """The v1 kernel wrappers never fall back to the plain version: CPU
    tensors raise on either route; float32 compute and width 128 route to
    the generic kernels; other octave counts are the encoder's business
    and keep the wgmma route; a depth past the generic limits raises."""
    f = tfm.FusedMLPField(device="cpu")
    f.reset_parameters(torch.Generator().manual_seed(0))
    w = {n: p.detach() for n, p in f.weights.items()}
    x, d = torch.zeros(64, 128), torch.zeros(64, 128)
    g = torch.zeros(64, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tfm.fused_mlp_fwd_kernel(w, x, d, f.dims)
    with pytest.raises(ValueError, match="CUDA"):
        tfm.fused_mlp_bwd_kernel(w, x, d, g, f.dims)
    assert tfm.route(f.dims._replace(multires=6), pre=True) == "wgmma"
    with pytest.raises(ValueError, match="CUDA"):
        tfm.fused_mlp_fwd_kernel(w, x, d, f.dims._replace(multires=6))
    f32 = f.dims._replace(compute_dtype="float32")
    assert tfm.route(f32, pre=True) == "gen"
    with pytest.raises(ValueError, match="CUDA"):
        tfm.fused_mlp_fwd_kernel(w, x, d, f32)
    narrow = f.dims._replace(width=128)
    assert tfm.route(narrow, pre=True) == "gen"
    with pytest.raises(ValueError, match="CUDA"):
        tfm.fused_mlp_bwd_kernel(w, x, d, g, narrow)
    with pytest.raises(ValueError, match="depth 1-32"):
        tfm.fused_mlp_bwd_kernel(w, x, d, g, f.dims._replace(depth=40))
    with pytest.raises(ValueError, match="multiple"):
        tfm.fused_mlp(f.dims, 64, w, torch.zeros(65, 128),
                      torch.zeros(65, 128))
    assert tfm.launches_gen_v1 == {"fwd_tc": 0, "fwd_ls": 0, "bwd_tc": 0,
                                   "bwd_ls": 0}
    assert tfm.launches_v1 == {"fwd": 0, "bwd": 0}
