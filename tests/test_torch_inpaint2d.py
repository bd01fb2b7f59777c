"""The port's LaMa stage (`spinnerf_tpu_torch/pipeline/inpaint2d.py`) and
its cv2 replacements (`utils/resize.py`) against cv2 and the JAX package,
on numpy-made inputs, with JAX's tiny generator (ngf 8, 2 blocks, 64
features) carried across by `convert.lama_state_dict`:

- `area_resize` within 1e-6 of cv2's INTER_AREA at fractional shrinks,
  the pyramid's sqrt(budget) shrink and upscales; `nearest_resize`,
  `dilate_mask` and `pad_to_modulo` equal to cv2's / JAX's exactly;
- `_build_pyramid`'s levels equal JAX's in shape, within 1e-6 in value;
- `predict` within 1e-5 of JAX's and equal to the image outside the hole;
  `refine_predict` (2 Adam steps, 2 levels, the 5 x 5 x 5 dilation) within
  1e-4: Adam's first step, lr * g / (|g| + eps), turns f32 noise in a
  near-zero latent gradient into up to lr (2e-3) of that latent;
- `inpaint_directory`'s PNGs within 1 LSB of JAX's;
- both packages' `load_generator` on one checkpoint with a `generator.`
  prefix and stray `discriminator.` keys give the same output; without a
  checkpoint the port's weights are seeded and frozen."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spinnerf_tpu.models import lama as jlama
from spinnerf_tpu.pipeline import inpaint2d as jinp
from spinnerf_tpu_torch import convert
from spinnerf_tpu_torch.eval.render import read_png, write_png
from spinnerf_tpu_torch.models import lama as tlama
from spinnerf_tpu_torch.pipeline import inpaint2d as tinp
from spinnerf_tpu_torch.utils.resize import area_resize, nearest_resize

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(1)

TINY = dict(ngf=8, n_blocks=2, max_features=64)


@pytest.fixture(scope="module")
def tiny():
    """(JAX generator, its variables, the port's generator)."""
    gen = jlama.FFCResNetGenerator(**TINY)
    v = jax.tree.map(np.asarray, jax.jit(gen.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 4))))
    tgen = tlama.FFCResNetGenerator(**TINY, device="cpu")
    tgen.load_state_dict(convert.lama_state_dict(v), strict=True)
    return gen, v, tgen.requires_grad_(False)


@pytest.mark.parametrize("src,dst", [
    ((37, 45), (18, 22)), ((128, 160), (47, 59)),
    # the pyramid's sqrt(budget) shrink at a budget of 5,000 pixels
    ((128, 160), (63, 79)),
    ((504, 672), (252, 336)), ((20, 30), (41, 67)), ((20, 30), (10, 67)),
    ((63, 84), (63, 84))])
def test_area_resize_matches_cv2(src, dst):
    rng = np.random.RandomState(src[0])
    for shape in (src, src + (3,)):
        img = rng.rand(*shape).astype(np.float32)
        want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
        got = area_resize(img, *dst)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_nearest_resize_dilate_and_pad_equal_cv2_and_jax():
    rng = np.random.RandomState(1)
    m = (rng.rand(37, 45) > 0.9).astype(np.float32)
    for h, w in ((40, 48), (18, 22), (37, 45)):
        np.testing.assert_array_equal(
            nearest_resize(m, h, w),
            cv2.resize(m, (w, h), interpolation=cv2.INTER_NEAREST))
    for iters in (1, 5):
        got = tinp.dilate_mask(m, iterations=iters)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jinp.dilate_mask(m,
                                                            iterations=iters))
    img = rng.rand(37, 50, 3).astype(np.float32)
    (a, hw_a), (b, hw_b) = tinp.pad_to_modulo(img), jinp.pad_to_modulo(img)
    assert a.shape == (40, 56, 3) and hw_a == hw_b == (37, 50)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape,kw", [
    ((128, 160), dict(min_side=32, px_budget=1e9, max_scales=3)),
    ((128, 160), dict(min_side=32, px_budget=5000, max_scales=2)),
    ((75, 97), dict(min_side=16, px_budget=1e9, max_scales=3))])
def test_build_pyramid_matches_jax(shape, kw):
    rng = np.random.RandomState(2)
    img = rng.rand(*shape, 3).astype(np.float32)
    mask = (rng.rand(*shape) > 0.8).astype(np.float32)
    got = tinp._build_pyramid(img, mask, **kw)
    want = jinp._build_pyramid(img, mask, **kw)
    assert [g[0].shape for g in got] == [w[0].shape for w in want]
    for (gi, gm), (wi, wm) in zip(got, want):
        np.testing.assert_allclose(gi, wi, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(gm, wm)


def test_predict_matches_jax(tiny):
    gen, v, tgen = tiny
    rng = np.random.RandomState(3)
    img = rng.rand(37, 45, 3).astype(np.float32)
    mask = np.zeros((37, 45), np.float32)
    mask[10:20, 12:30] = 1
    got = tinp.predict(tgen, img, mask)
    want = jinp.predict(gen, v, img, mask)
    assert got.shape == img.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[mask == 0], img[mask == 0])
    assert np.abs(got[mask == 1] - img[mask == 1]).mean() > 1e-3


def test_refine_predict_matches_jax(tiny):
    gen, v, tgen = tiny
    rng = np.random.RandomState(4)
    img = rng.rand(64, 72, 3).astype(np.float32)
    mask = np.zeros((64, 72), np.float32)
    mask[20:36, 24:48] = 1
    kw = dict(n_iters=2, min_side=16, px_budget=1e6, max_scales=2,
              mask_dilate_iters=5)
    got = tinp.refine_predict(tgen, img, mask, **kw)
    want = jinp.refine_predict(gen, v, img, mask, **kw)
    assert got.shape == img.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    known = tinp.dilate_mask(mask) == 0
    np.testing.assert_array_equal(got[known], img[known])


def test_inpaint_directory_matches_jax(tiny, tmp_path):
    """`label/<name>.png` masks (one stored as RGB), a `<name>_mask.png`
    one at another size (nearest-resized), a gray image; the outputs within
    1 LSB."""
    gen, v, tgen = tiny
    rng = np.random.RandomState(5)
    d = tmp_path / "in"
    (d / "label").mkdir(parents=True)
    m = np.zeros((40, 48), np.uint8)
    m[10:20, 10:30] = 255
    for i in range(2):
        write_png(d / f"img{i:03d}.png",
                  (rng.rand(40, 48, 3) * 255).astype(np.uint8))
        # img001's mask is stored as RGB
        write_png(d / "label" / f"img{i:03d}.png",
                  np.repeat(m[..., None], 3, -1) if i else m)
    write_png(d / "gray.png", (rng.rand(40, 48) * 255).astype(np.uint8))
    write_png(d / "gray_mask.png", m[::2, ::2])
    got = tinp.inpaint_directory(d, tmp_path / "port",
                                 inpainter=tinp.Inpainter(tgen))
    want = jinp.inpaint_directory(d, tmp_path / "jax",
                                  inpainter=jinp.Inpainter(gen, v))
    names = sorted(p.name for p in want.glob("*.png"))
    assert names == ["gray.png", "img000.png", "img001.png"]
    assert sorted(p.name for p in got.glob("*.png")) == names
    for n in names:
        a = read_png(got / n).astype(int)
        b = cv2.cvtColor(cv2.imread(str(want / n)), cv2.COLOR_BGR2RGB)
        assert a.shape == b.shape == (40, 48, 3)
        assert np.abs(a - b).max() <= 1, n


def test_load_generator_matches_jax(tmp_path, monkeypatch):
    """A big-lama layout checkpoint (18 blocks, ngf 8: the port's seeded
    weights, BN perturbed) under `state_dict`, with `generator.` keys and
    stray `discriminator.` ones."""
    monkeypatch.delenv("SPINNERF_WEIGHTS_DIR", raising=False)
    src = tinp.load_generator(device="cpu", ngf=8)
    rng = np.random.RandomState(7)
    with torch.no_grad():
        for m in src.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.from_numpy(rng.rand(n) + 0.5))
                m.running_var.copy_(torch.from_numpy(rng.rand(n) + 0.5))
                m.bias.copy_(torch.from_numpy(rng.randn(n) * 0.1))
                m.running_mean.copy_(torch.from_numpy(rng.randn(n) * 0.1))
        # random weights grow the activations through 18 blocks: a smaller
        # head keeps the sigmoid off its saturated ends
        src.model[-2].weight.mul_(1e-3)
    sd = {"generator." + k: t for k, t in src.state_dict().items()}
    sd["discriminator.model.0.weight"] = torch.ones(3)
    path = tmp_path / "big-lama.ckpt"
    torch.save({"state_dict": sd}, path)
    jg, jv = jinp.load_generator(str(path), ngf=8)
    tgen = tinp.load_generator(str(path), device="cpu", ngf=8)
    x = np.random.RandomState(6).rand(1, 32, 32, 4).astype(np.float32)
    with torch.no_grad():
        got = tgen(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    want = np.asarray(jax.jit(jg.apply)(jv, jnp.asarray(x)))
    assert 0.05 < want.min() and want.max() < 0.95
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, rtol=0,
                               atol=1e-5)
    assert not any(p.requires_grad for p in tgen.parameters())

    # no checkpoint anywhere: seeded random weights, the same every time
    a, b = (tinp.load_generator(device="cpu", **TINY) for _ in range(2))
    for (k, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), k
    assert a.model[1].ffc.convl2l.weight.std() > 0
