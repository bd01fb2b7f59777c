"""The port's LPIPS (`spinnerf_tpu_torch/models/lpips.py`) against the JAX
package's, with JAX's seeded random VGG16 carried across by
`convert.lpips_state_dict`: the five feature maps and the distance at
16 x 20 and 32 x 40 within 1e-5 relative (max-normalised), the input
gradient against `jax.grad` within 1e-5 relative, torchvision-format files
loaded by both packages to distances within 1e-5 relative, the result key
under `SPINNERF_WEIGHTS_DIR`, and the refusal of a side under 16 pixels,
where the JAX module returns NaN."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spinnerf_tpu.models import lpips as jlpips
from spinnerf_tpu_torch.convert import lpips_state_dict
from spinnerf_tpu_torch.models import lpips as tlpips

torch.set_num_threads(1)

# torchvision's VGG16 `features` index of each of the 13 convolutions
TV_CONV_INDEX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


@pytest.fixture(scope="module")
def pair():
    """(JAX lpips fn, the port's LPIPS with JAX's weights)."""
    jfn = jlpips.load_lpips()
    vgg_params, lin = jfn.consts
    model = tlpips.LPIPS(device="cpu")
    model.load_state_dict(lpips_state_dict(
        jax.tree.map(np.asarray, vgg_params), lin))
    return jfn, model


def _images(seed, *shape):
    rng = np.random.RandomState(seed)
    return (rng.rand(*shape, 3).astype(np.float32),
            rng.rand(*shape, 3).astype(np.float32))


@pytest.mark.parametrize("hw", [(16, 20), (32, 40)])
def test_features_and_distance_match_jax(pair, hw):
    jfn, model = pair
    x, y = _images(1, 2, *hw)
    vgg_params, lin = jfn.consts
    shift = np.asarray(jlpips._SHIFT)
    scale = np.asarray(jlpips._SCALE)
    xn = (x * 2.0 - 1.0 - shift) / scale
    jfeats = jax.jit(jlpips.VGG16Features().apply)(vgg_params, xn)
    with torch.no_grad():
        tfeats = model.vgg(torch.from_numpy(xn).permute(0, 3, 1, 2))
        d = model(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert len(tfeats) == len(jfeats) == 5
    for tf, jf in zip(tfeats, jfeats):
        jf = np.asarray(jf)
        assert tf.shape == (2, jf.shape[3], jf.shape[1], jf.shape[2])
        assert rel(tf.permute(0, 2, 3, 1).numpy(), jf) < 1e-5
    dj = np.asarray(jax.jit(jfn)(jnp.asarray(x), jnp.asarray(y)))
    assert d.shape == (2,) and (d > 0).all()
    assert rel(d, dj) < 1e-5
    # unbatched input gives a scalar
    with torch.no_grad():
        d0 = model(torch.from_numpy(x[0]), torch.from_numpy(y[0]))
    assert d0.ndim == 0 and rel(d0.numpy(), dj[0]) < 1e-5


def test_input_gradient_matches_jax(pair):
    """The gradient reaches the input only; the trunk's backward recomputes
    it (TF32 off) and equals jax.grad's."""
    jfn, model = pair
    x, y = _images(2, 16, 20)
    gj = np.asarray(jax.jit(jax.grad(
        lambda a: jfn(a, jnp.asarray(y))))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    model(xt, torch.from_numpy(y)).backward()
    assert rel(xt.grad.numpy(), gj) < 1e-5
    assert all(p.grad is None and not p.requires_grad
               for p in model.parameters())


def _write_torch_files(d, seed=3):
    """A torchvision-format VGG16 state dict (features.{i}.weight/bias) and
    LPIPS heads (lin{i}.model.1.weight [1, C, 1, 1], some negative)."""
    rng = np.random.RandomState(seed)
    sd, c_in = {}, 3
    for idx, (ch, _, _) in zip(TV_CONV_INDEX, tlpips._VGG_PLAN):
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            (rng.randn(ch, c_in, 3, 3) / np.sqrt(9 * c_in)).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.from_numpy(
            (rng.randn(ch) * 0.01).astype(np.float32))
        c_in = ch
    sd["classifier.0.weight"] = torch.zeros(4, 8)
    heads = {f"lin{i}.model.1.weight": torch.from_numpy(
        rng.randn(1, c, 1, 1).astype(np.float32) * 0.1)
        for i, c in enumerate(tlpips.FEATURE_CHANNELS)}
    torch.save(sd, d / "vgg16.pth")
    torch.save(heads, d / "lpips_vgg_lin.pth")
    return d / "vgg16.pth", d / "lpips_vgg_lin.pth"


def test_torchvision_files_load_in_both_packages(tmp_path):
    vgg_path, lin_path = _write_torch_files(tmp_path)
    jfn = jlpips.load_lpips(str(vgg_path), str(lin_path))
    model = tlpips.load_lpips(str(vgg_path), str(lin_path), device="cpu")
    lin = tlpips.load_lin_weights_from_torch(lin_path)
    assert all((w >= 0).all() for w in lin) and any((w == 0).any()
                                                    for w in lin)
    x, y = _images(4, 2, 16, 20)
    with torch.no_grad():
        d = model(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert rel(d, np.asarray(jax.jit(jfn)(jnp.asarray(x),
                                          jnp.asarray(y)))) < 1e-5


def test_labeled_key_follows_the_weights_dir(tmp_path, monkeypatch):
    """"lpips" only when both files are found; the port's key is JAX's."""
    monkeypatch.setenv("SPINNERF_WEIGHTS_DIR", str(tmp_path))
    keys = []
    _, key = tlpips.load_lpips_labeled(device="cpu")
    keys.append((key, jlpips.load_lpips_labeled()[1]))
    vgg_path, lin_path = _write_torch_files(tmp_path)
    lin_path.rename(tmp_path / "elsewhere.pth")
    _, key = tlpips.load_lpips_labeled(device="cpu")
    keys.append((key, jlpips.load_lpips_labeled()[1]))
    (tmp_path / "elsewhere.pth").rename(tmp_path / "vgg.pth")  # alternate
    model, key = tlpips.load_lpips_labeled(device="cpu")
    keys.append((key, jlpips.load_lpips_labeled()[1]))
    assert keys == [("lpips_random_vgg",) * 2, ("lpips_random_vgg",) * 2,
                    ("lpips",) * 2]
    ref = tlpips.load_lpips(str(vgg_path), str(tmp_path / "vgg.pth"),
                            device="cpu")
    for (k, a), b in zip(model.state_dict().items(),
                         ref.state_dict().values()):
        assert torch.equal(a, b), k


def test_seeded_random_vgg_is_flax_conv_default():
    """No files: truncated lecun-normal kernels (fan_in = 9 x inputs), zero
    biases, uniform 1/C heads, frozen; the same seed, the same weights."""
    a = tlpips.load_lpips(device="cpu", seed=5)
    b = tlpips.load_lpips(device="cpu", seed=5)
    c = tlpips.load_lpips(device="cpu", seed=6)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    for i, conv in enumerate(a.vgg.children()):
        w = conv.weight
        std = np.sqrt(1.0 / w[0].numel())
        assert abs(float(w.std()) / std - 1.0) < 0.05, i
        assert float(w.abs().max()) <= 2 * std / 0.8796256610342398 + 1e-6
        assert not conv.bias.any() and not w.requires_grad
        assert not torch.equal(w, getattr(c.vgg, f"conv_{i}").weight)
    for w, ch in zip(a.lin_weights, tlpips.FEATURE_CHANNELS):
        assert torch.equal(w, torch.full((ch,), 1.0 / ch))


def test_side_under_16_refused_where_jax_gives_nan(pair):
    jfn, model = pair
    x, y = _images(5, 1, 16, 21)
    jit = jax.jit(jfn)
    assert np.isnan(np.asarray(jit(jnp.asarray(x[:, :15]),
                                   jnp.asarray(y[:, :15])))).all()
    dj = np.asarray(jit(jnp.asarray(x), jnp.asarray(y)))
    with pytest.raises(ValueError, match="at least 16 x 16"):
        model(torch.from_numpy(x[:, :15]), torch.from_numpy(y[:, :15]))
    prev = torch.backends.cudnn.allow_tf32
    with torch.no_grad():
        d = model(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert torch.backends.cudnn.allow_tf32 == prev
    assert np.isfinite(dj).all() and rel(d, dj) < 1e-5
