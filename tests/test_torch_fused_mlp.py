"""The port's fused encode+MLP (`spinnerf_tpu_torch/ops/fused_mlp.py`)
against the JAX `fused_mlp_pe`, which runs its Pallas kernels in interpret
mode on the CPU. Same numpy-made weights, points and cotangents on both
sides; forward output and every weight gradient compared relative to the
largest |value| of each tensor (tolerances stated per test)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spinnerf_tpu.models.fields import NeRFField as JNeRFField
from spinnerf_tpu.ops import fused_mlp as jfm
from spinnerf_tpu_torch import convert
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
    return params, dims, jw, pts, vd, g


def _run_jax(dims, jw, pts, vd, g):
    field = jfm.make_fused_pe_field_fn(dims, block=BLOCK)
    out, vjp = jax.vjp(lambda w: field(w, jnp.asarray(pts), jnp.asarray(vd)),
                       {n: jnp.asarray(v) for n, v in jw.items()})
    (grads,) = vjp(jnp.asarray(g))
    return np.asarray(out), {n: np.asarray(v) for n, v in grads.items()}


def _run_port(dims, jw, pts, vd, g):
    tdims = tfm.MLPDims(**dims._asdict())
    w = {n: v.requires_grad_() for n, v in convert.fused_weights(jw).items()}
    field = tfm.make_fused_pe_field_fn(tdims, block=BLOCK)
    out = field(w, torch.from_numpy(pts), torch.from_numpy(vd))
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), {n: v.grad.numpy() for n, v in w.items()}


# f32: both sides compute the same f32 products in another summation order,
# so the forward agrees to 1e-5 relative to max |out| and the weight
# gradients (sums over 65 points) to 1e-5 relative to max |grad|.
# bf16: the operands round to bf16 at the same points on both sides, but an
# f32 sum taken in another order can land on the other side of a bf16
# rounding boundary, which moves that activation by one bf16 step (2^-8
# relative) and, attenuated, everything downstream of it. The JAX kernel
# also rounds each block's bias-gradient sum to bf16 (fused_mlp.py:515),
# which the port does not: up to 2^-9 = 2.0e-3 of a bias gradient.
# Measured at these inputs: forward <= 1.7e-4, weight gradients <= 2.7e-3
# (a bias gradient); bounds 5e-4 on the forward and 5e-3 on gradients.
# Leaving out any one operand rounding of the plain version (the encodings,
# a trunk activation, the feature, the view activation or the weights)
# moves the forward by >= 1.3e-3 at these inputs, and all but the view
# activation's move a weight gradient by >= 1.4e-2 (checked once on the
# CPU), so the bounds catch it.
TOLS = {"float32": (1e-5, 1e-5), "bfloat16": (5e-4, 5e-3)}


@pytest.mark.parametrize("semantic", [False, True])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_plain_matches_jax_fused_mlp_pe(semantic, dtype_name):
    _, dims, jw, pts, vd, g = _setup(semantic, dtype_name)
    out_j, grads_j = _run_jax(dims, jw, pts, vd, g)
    out_t, grads_t = _run_port(dims, jw, pts, vd, g)
    assert out_t.shape == out_j.shape == (B, S, 4 + dims.out_extra)
    tol, grad_tol = TOLS[dtype_name]
    assert _rel(out_t, out_j) < tol
    assert set(grads_t) == set(grads_j)
    for n in grads_j:
        assert grads_t[n].shape == grads_j[n].shape, n
        assert _rel(grads_t[n], grads_j[n]) < grad_tol, n


def test_padded_weight_rows_get_zero_gradient():
    _, dims, jw, pts, vd, g = _setup(False, "bfloat16")
    _, grads = _run_port(dims, jw, pts, vd, g)
    assert np.abs(grads["tw0"][63:]).max() == 0.0
    assert np.abs(grads["tw5"][63:128]).max() == 0.0
    assert np.abs(grads["view_w"][256 + 27:]).max() == 0.0
    assert np.abs(grads["tw0"][:63]).max() > 0.0


def test_params_to_fused_and_convert_match_jax():
    params, dims, _, _, _, _ = _setup(True, "float32")
    want = jfm.params_to_fused(params, dims, raw_in_dim=63, raw_dir_dim=27)
    got = tfm.params_to_fused(jax.tree.map(np.asarray, params),
                              tfm.MLPDims(**dims._asdict()), raw_in_dim=63,
                              raw_dir_dim=27)
    conv = convert.fused_weights({n: np.asarray(v) for n, v in want.items()})
    assert list(got) == jfm._weight_order(dims) == tfm._weight_order(dims)
    for n, v in want.items():
        assert got[n].dtype == conv[n].dtype == torch.float32
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(v), n)
        np.testing.assert_array_equal(conv[n].numpy(), np.asarray(v), n)
    assert tfm.weight_shapes(tfm.MLPDims(**dims._asdict())) == {
        n: tuple(v.shape) for n, v in want.items()}


def test_encoding_matches_jax_pe_constants():
    rng = np.random.RandomState(3)
    xd = np.zeros((64, 8), np.float32)
    xd[:, :6] = rng.randn(64, 6) * 40.0          # large sin arguments
    dims = jfm.dims_for_field()
    pe_x, pe_d = jfm._pe_consts_for(dims)
    for pe, nf, col0 in ((pe_x, 10, 0), (pe_d, 4, 3)):
        want = np.asarray(jfm._encode_block(jnp.asarray(xd), *pe,
                                            jnp.float32))
        got = tfm.encode(torch.from_numpy(xd), nf, col0, 128).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_field_init_is_seeded_padded_and_validated():
    a = tfm.FusedMLPField(device="cpu")
    b = tfm.FusedMLPField(device="cpu")
    a.reset_parameters(torch.Generator().manual_seed(4))
    b.reset_parameters(torch.Generator().manual_seed(4))
    for n, p in a.weights.items():
        assert torch.equal(p, b.weights[n]), n
        if n.endswith("_b") or n.startswith("tb"):
            assert float(p.detach().abs().max()) == 0.0, n
    assert float(a.weights["tw0"][63:].abs().max()) == 0.0
    assert float(a.weights["view_w"][256 + 27:].abs().max()) == 0.0
    # lecun normal: std sqrt(1/fan_in) with fan_in the unpadded 63
    assert abs(float(a.weights["tw0"][:63].std()) - 63 ** -0.5) < 0.02
    assert a.dims.compute_dtype == "bfloat16"
    with pytest.raises(ValueError, match="depth"):
        tfm.FusedMLPField(depth=5, device="cpu")
    pts, vd = torch.zeros(2, 3, 3), torch.zeros(2, 3)
    with pytest.raises(ValueError, match="frozen-sigma"):
        a(pts, vd, frozen_sigma=torch.zeros(2, 3, 1))
    with pytest.raises(ValueError, match="viewdirs"):
        a(pts)


def test_kernel_wrappers_take_no_cpu_tensors():
    """The kernel wrappers never fall back to the plain version: CPU
    tensors raise on either route, float32 compute and depth 6 route to the
    generic kernels (and still refuse CPU tensors), and a geometry past the
    generic kernels' limits raises naming the limit."""
    f = tfm.FusedMLPField(device="cpu")
    f.reset_parameters(torch.Generator().manual_seed(0))
    w = {n: p.detach() for n, p in f.weights.items()}
    xd = torch.zeros(64, 8)
    assert tfm.route(f.dims) == "wgmma"
    with pytest.raises(ValueError, match="CUDA"):
        tfm.fused_mlp_pe_fwd_kernel(w, xd, f.dims)
    with pytest.raises(ValueError, match="CUDA"):
        tfm.fused_mlp_pe_bwd_kernel(w, xd, torch.zeros(64, 4), f.dims)
    f32 = f.dims._replace(compute_dtype="float32")
    assert tfm.route(f32) == "gen"
    with pytest.raises(ValueError, match="CUDA"):
        tfm.fused_mlp_pe_fwd_kernel(w, xd, f32)
    deep = f.dims._replace(depth=6)
    assert tfm.route(deep) == "gen"
    with pytest.raises(ValueError, match="CUDA"):
        tfm.fused_mlp_pe_bwd_kernel(w, xd, torch.zeros(64, 4), deep)
    with pytest.raises(ValueError, match="width 8-2048"):
        tfm.fused_mlp_pe_bwd_kernel(w, xd, torch.zeros(64, 4),
                                    f.dims._replace(width=4096))
    assert tfm.launches == {"fwd": 0, "bwd": 0}
    assert tfm.launches_gen == {"fwd_tc": 0, "fwd_ls": 0, "bwd_tc": 0,
                                "bwd_ls": 0}


def test_pack_weights_layout():
    """The heads' bf16 copies, as they are, each on 16 bytes."""
    f = tfm.FusedMLPField(depth=3, semantic=True, device="cpu")
    f.reset_parameters(torch.Generator().manual_seed(1))
    w = {n: p.detach() for n, p in f.weights.items()}
    buf, offs = tfm.pack_weights(w, f.dims)
    assert buf.dtype == torch.bfloat16
    for n, off in offs.items():
        assert off % 8 == 0
        got = buf[off:off + w[n].numel()].view(w[n].shape)
        assert torch.equal(got, w[n].to(torch.bfloat16)), n
    assert list(offs) == ["rgb_w", "sigma_w", "sem_w"]
    assert buf.numel() == 128 * 3 + 256 + 256


@pytest.mark.parametrize("pre", [False, True])
def test_pack_ring_layout(pre):
    """The backward kernel's weight stages: every product's B^T [N, K] cut
    into K / 64 stages [N, 64], each row's 16-byte chunk c at c ^ (row % 8),
    in the order the kernel takes them (its ring_schedule): the recompute,
    then the gradients of the view, feature and trunk layers from the top,
    with v1 (`pre`) adding dd, the skip layer's encoding rows and layer 0."""
    f = tfm.FusedMLPField(device="cpu")
    f.reset_parameters(torch.Generator().manual_seed(2))
    w = {n: p.detach() for n, p in f.weights.items()}
    d = f.dims
    ring = tfm.pack_ring(w, d, pre)
    assert ring.dtype == torch.bfloat16
    want = [w[f"tw{i}"].t() for i in range(8)]
    want += [w["feat_w"].t(), w["view_w"].t(), w["view_w"][:256]]
    want += [w["view_w"][256:]] if pre else []
    want += [w["feat_w"], w["tw7"], w["tw6"]]
    want += [w["tw5"][:128]] if pre else []
    want += [w["tw5"][128:], w["tw4"], w["tw3"], w["tw2"], w["tw1"]]
    want += [w["tw0"]] if pre else []
    # the stages as ring_schedule in the CUDA source counts them
    n_stages = sum(m.shape[1] // 64 for m in want)
    assert n_stages == (76 if not pre else 86)
    off = 0
    for m in want:
        n, k = m.shape
        stages = ring[off:off + n * k].view(k // 64, n, 8, 8)
        off += n * k
        rows = torch.arange(n)
        for c in range(8):
            got = stages[:, rows, (c ^ (rows % 8)), :]     # [K/64, N, 8]
            ref = m.to(torch.bfloat16).reshape(n, k // 64, 8, 8)[:, :, c]
            assert torch.equal(got, ref.transpose(0, 1))
    assert off == ring.numel()
    # the kernel path packs the same buffer with one gather
    flat = torch.cat([w[n].reshape(-1) for n in tfm._weight_order(d)])
    idx = tfm.ring_index(d, pre, "cpu")
    assert torch.equal(flat.to(torch.bfloat16)[idx], ring)


def _unswizzle_stages(flat, n, k):
    """`swizzle_stages` undone: K / 64 stages [N, 64] -> B^T [N, K]. The
    swizzle is an involution: chunk c of row r sits at c ^ (r % 8)."""
    stages = flat.view(k // 64, n, 8, 8)
    rows = torch.arange(n)
    src = torch.arange(8)[None, :] ^ (rows % 8)[:, None]
    got = stages.gather(2, src[None, :, :, None].expand(stages.shape))
    return got.transpose(0, 1).reshape(n, k)


@pytest.mark.parametrize("pre", [False, True])
def test_forward_reads_the_ring_prefix(pre):
    """What the forward kernel reads: the ring's first depth + 2 matrices
    (the trunk, feature and view layers: 42 stages, 1,248 KB, the count of
    ring_schedule with fwd in the CUDA source, the same with and without
    `pre`) and the packed heads. Un-swizzled, with the f32 biases, they give
    the plain forward bit for bit."""
    f = tfm.FusedMLPField(semantic=True, device="cpu")
    f.reset_parameters(torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    w = {n: (torch.randn(p.shape, generator=gen) * 0.1
             if n.endswith("_b") or n.startswith("tb") else p.detach())
         for n, p in f.weights.items()}
    d = f.dims
    n_elems = tfm.forward_ring_elems(d)
    prefix = tfm.gather_ring(w, d, pre, forward=True)
    assert torch.equal(prefix, tfm.pack_ring(w, d, pre)[:n_elems])
    mats = tfm.ring_matrices(w, d, pre)[:d.depth + 2]
    assert sum(m.shape[1] // 64 for m in mats) == 42
    assert 2 * prefix.numel() == 1248 * 1024

    ring_w = dict(w)
    off = 0
    for name in [f"tw{i}" for i in range(d.depth)] + ["feat_w", "view_w"]:
        k, n = w[name].shape
        ring_w[name] = _unswizzle_stages(prefix[off:off + n * k], n, k
                                         ).t().float().contiguous()
        off += n * k
    assert off == n_elems
    buf, offs = tfm.pack_weights(w, d)
    for name, o in offs.items():
        ring_w[name] = buf[o:o + w[name].numel()].view(w[name].shape).float()

    rng = np.random.RandomState(5)
    xd = torch.from_numpy(np.concatenate(
        [rng.randn(64, 6) * 2.0, np.zeros((64, 2))], 1).astype(np.float32))
    if pre:
        x, dirs = tfm._encodings(xd, d)
        want = tfm.fused_mlp_fwd_plain(w, x, dirs, d)
        got = tfm.fused_mlp_fwd_plain(ring_w, x, dirs, d)
    else:
        want = tfm.fused_mlp_pe_plain(w, xd, d)
        got = tfm.fused_mlp_pe_plain(ring_w, xd, d)
    assert got.shape == (64, 5)
    assert torch.equal(got, want)
