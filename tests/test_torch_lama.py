"""The port's LaMa generator (`spinnerf_tpu_torch/models/lama.py`) against
the JAX package's on the same numpy-made inputs, with JAX's variables
carried across by `convert.lama_state_dict` (and its per-module helpers)
and every BatchNorm's running statistics, scale and bias perturbed from a
seed, so that no BN is the identity:

- the inverse of a non-Hermitian half spectrum equals JAX's C2C detour;
  `FourierUnit`, `SpectralTransform` with the LFU (stride 1 and 2), `FFC`
  and the transpose convolution within 1e-5 of max |value|, at W even and
  odd (64 and 56 columns, 33 and 29 spectrum columns);
- the generator at ngf 8, 2 blocks, 64 features, at 64 x 64 and 40 x 56:
  `front`, `rear` and `forward` within 1e-5 of max |value|, and `rear`'s
  gradient with respect to the latents within 1e-4 of `jax.grad`'s;
- `convert_big_lama(lama_state_dict(v))` gives `v` back leaf for leaf at
  18 blocks, and that state dict loads strictly into the port's module."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spinnerf_tpu.models import lama as jlama
from spinnerf_tpu_torch import convert
from spinnerf_tpu_torch.models import lama as tlama

torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def perturbed(variables, seed):
    """`variables` as numpy, every BN's scale, bias, mean and variance
    drawn from `seed` (scale and variance in [0.5, 1.5])."""
    rng = np.random.RandomState(seed)
    v = jax.tree.map(np.array, variables)

    def walk(tree, keys):
        for k in sorted(tree):
            node = tree[k]
            if not isinstance(node, dict):
                continue
            if keys <= set(node):
                for leaf in sorted(keys):
                    x = node[leaf]
                    node[leaf] = ((rng.rand(*x.shape) + 0.5) if leaf in (
                        "scale", "var") else rng.randn(*x.shape) * 0.1
                    ).astype(np.float32)
            else:
                walk(node, keys)
    walk(v["params"], {"scale", "bias"})
    walk(v.get("batch_stats", {}), {"mean", "var"})
    return v


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _module(jmod, tmod, to_state, x, seed):
    """JAX's module initialised on x (NHWC) and perturbed, the port's
    loaded with the same variables; returns (JAX variables, port module)."""
    v = perturbed(jax.jit(jmod.init)(jax.random.PRNGKey(seed),
                                     jnp.asarray(x)), seed)
    sd = {}
    to_state(sd, v["params"], v.get("batch_stats", {}))
    tmod.load_state_dict(sd, strict=True)
    return v, tmod.eval()


@pytest.mark.parametrize("h,w", [(16, 64), (15, 56)])
def test_inverse_of_a_non_hermitian_half_spectrum_equals_jax(h, w):
    rng = np.random.RandomState(w)
    wf = w // 2 + 1
    spec = (rng.randn(2, 3, h, wf) + 1j * rng.randn(2, 3, h, wf)).astype(
        np.complex64)
    got = tlama.irfft2_half(torch.from_numpy(spec), h, w).numpy()
    want = np.asarray(jlama.irfft2_via_c2c(
        jnp.asarray(spec.transpose(0, 2, 3, 1)), s=(h, w)))
    assert got.shape == (2, 3, h, w)
    assert rel(got, want.transpose(0, 3, 1, 2)) < 1e-5


@pytest.mark.parametrize("w", [64, 56])
def test_fourier_unit_matches_jax(w):
    x = np.random.RandomState(w).randn(2, 24, w, 6).astype(np.float32)

    def to_state(sd, p, s):
        convert.lama_conv_state(sd, "conv_layer", p["conv"])
        convert.lama_bn_state(sd, "bn", p["bn"], s["bn"])
    v, fu = _module(jlama.FourierUnit(6), tlama.FourierUnit(6, 6), to_state,
                    x, 1)
    want = np.asarray(jax.jit(jlama.FourierUnit(6).apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = nhwc(fu(nchw(x)))
    assert rel(got, want) < 1e-5


@pytest.mark.parametrize("w,stride", [(64, 1), (56, 2)])
def test_spectral_transform_with_lfu_matches_jax(w, stride):
    x = np.random.RandomState(w).randn(1, 32, w, 8).astype(np.float32)
    jmod = jlama.SpectralTransform(16, stride=stride, enable_lfu=True)
    v, st = _module(jmod, tlama.SpectralTransform(8, 16, stride, True),
                    lambda sd, p, s: convert.lama_spectral_state(sd, "", p,
                                                                 s), x, 2)
    want = np.asarray(jax.jit(jmod.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = nhwc(st(nchw(x)))
    assert got.shape == want.shape
    assert rel(got, want) < 1e-5


@pytest.mark.parametrize("w,stride,ratio_gin", [(64, 1, 0.75), (56, 1, 0.5),
                                                (56, 2, 0.0)])
def test_ffc_matches_jax(w, stride, ratio_gin):
    """Both branches in and out; the last case is a downsample from a
    local-only input (big-lama's last downsample)."""
    rng = np.random.RandomState(w + stride)
    c_in, c_out = 16, 16
    cg = int(c_in * ratio_gin)
    x_l = rng.randn(1, 32, w, c_in - cg).astype(np.float32)
    x_g = rng.randn(1, 32, w, cg).astype(np.float32) if cg else None
    jmod = jlama.FFC(c_out, 3, ratio_gin, 0.75, stride=stride)
    jx = (jnp.asarray(x_l), None if x_g is None else jnp.asarray(x_g))
    v = perturbed(jax.jit(jmod.init)(jax.random.PRNGKey(3), jx), 3)
    sd = {}
    convert.lama_ffc_state(sd, "", v["params"], v.get("batch_stats", {}))
    ffc = tlama.FFC(c_in, c_out, 3, ratio_gin, 0.75, stride)
    ffc.load_state_dict(sd, strict=True)
    want = jax.jit(jmod.apply)(v, jx)
    with torch.no_grad():
        got = ffc.eval()((nchw(x_l), None if x_g is None else nchw(x_g)))
    for g, w_ in zip(got, want):
        assert rel(nhwc(g), np.asarray(w_)) < 1e-5


def test_conv_transpose_matches_jax():
    """torch's ConvTranspose2d(k 3, s 2, p 1, output_padding 1), which
    JAX's `TorchConvTranspose` emulates."""
    x = np.random.RandomState(4).randn(2, 10, 12, 6).astype(np.float32)
    jmod = jlama.TorchConvTranspose(4)
    v = jax.tree.map(np.array, jmod.init(jax.random.PRNGKey(4),
                                         jnp.asarray(x)))
    v["params"]["bias"] = np.random.RandomState(5).randn(4).astype(
        np.float32)
    sd = {}
    convert.lama_conv_transpose_state(sd, "", v["params"])
    tconv = torch.nn.ConvTranspose2d(6, 4, 3, stride=2, padding=1,
                                     output_padding=1)
    tconv.load_state_dict(sd, strict=True)
    want = np.asarray(jmod.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = nhwc(tconv(nchw(x)))
    assert got.shape == want.shape == (2, 20, 24, 4)
    assert rel(got, want) < 1e-5


TINY = dict(ngf=8, n_blocks=2, max_features=64)


@pytest.fixture(scope="module")
def tiny_pair():
    """JAX's tiny generator with perturbed BN, and the port's carrying its
    variables (loaded strictly)."""
    gen = jlama.FFCResNetGenerator(**TINY)
    v = perturbed(jax.jit(gen.init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 64, 64, 4))), 0)
    tgen = tlama.FFCResNetGenerator(**TINY, device="cpu")
    tgen.load_state_dict(convert.lama_state_dict(v), strict=True)
    return gen, v, tgen


def _apply(gen, method):
    return jax.jit(lambda v, a: gen.apply(v, a, method=method))


@pytest.mark.parametrize("h,w", [(64, 64), (40, 56)])
def test_generator_front_rear_forward_match_jax(tiny_pair, h, w):
    gen, v, tgen = tiny_pair
    x = np.random.RandomState(h).rand(1, h, w, 4).astype(np.float32)
    jz = _apply(gen, lambda m, a: m.front(a))(v, jnp.asarray(x))
    want = np.asarray(_apply(gen, lambda m, z: m.rear(z))(v, jz))
    with torch.no_grad():
        tz = tgen.front(nchw(x))
        for a, b in zip(tz, jz):
            assert rel(nhwc(a), np.asarray(b)) < 1e-5
        rear = nhwc(tgen.rear(tuple(nchw(np.asarray(b)) for b in jz)))
        full = nhwc(tgen(nchw(x)))
    assert rear.shape == (1, h, w, 3)
    assert rel(rear, want) < 1e-5
    assert rel(full, np.asarray(jax.jit(gen.apply)(v, jnp.asarray(x)))) \
        < 1e-5


def test_rear_gradient_matches_jax(tiny_pair):
    """d/dz of sum(rear(z) * c), the refiner's path (cuFFT's R2C / C2R
    adjoints on the card)."""
    gen, v, tgen = tiny_pair
    rng = np.random.RandomState(7)
    x = rng.rand(1, 40, 56, 4).astype(np.float32)
    c = rng.randn(1, 40, 56, 3).astype(np.float32)
    jz = _apply(gen, lambda m, a: m.front(a))(v, jnp.asarray(x))

    def loss(z):
        return jnp.sum(gen.apply(v, z, method=lambda m, z_: m.rear(z_))
                       * jnp.asarray(c))
    want = jax.jit(jax.grad(loss))(jz)
    tz = tuple(nchw(np.asarray(b)).requires_grad_() for b in jz)
    (tgen.rear(tz) * nchw(c)).sum().backward()
    for t, g in zip(tz, want):
        assert rel(nhwc(t.grad), np.asarray(g)) < 1e-4


def test_lama_state_dict_inverts_convert_big_lama():
    """At 18 blocks (what `convert_big_lama` reads), tiny widths: trees
    only."""
    gen = jlama.FFCResNetGenerator(ngf=8, n_blocks=18, max_features=1024)
    shapes = jax.eval_shape(gen.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 4)))
    rng = np.random.RandomState(8)
    v = jax.tree.map(lambda s: rng.randn(*s.shape).astype(np.float32),
                     shapes)
    sd = convert.lama_state_dict(v)
    back = jlama.convert_big_lama(sd)
    flat = jax.tree_util.tree_flatten_with_path
    got, want = flat(back)[0], flat(v)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
    tgen = tlama.FFCResNetGenerator(ngf=8, n_blocks=18, device="cpu")
    tgen.load_state_dict(sd, strict=True)
    assert len(tgen.model) == 5 + 18 + 1 + 9 + 3
