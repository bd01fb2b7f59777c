"""The port's LaMa mask synthesis, tar shards and COUNTLESS
(`spinnerf_tpu_torch/data/{lama_masks,shards}.py`, `utils/countless.py`)
against the JAX package's, on the same numpy seeds:

- every generator equals JAX's mask for mask from one `RandomState`, and
  leaves the stream where JAX leaves it (the next draw equal);
- the brush strokes are rasterised without cv2; over 300 seeded irregular
  masks at 256 x 256 (and 97 x 131) they equal cv2's pixel for pixel, as
  do thick lines and filled circles whose ends lie on the canvas (the only
  ones the generator draws);
- `make_batch` equals JAX's crops and masks;
- the shards stream the same images in the same order as JAX's (PNG
  decoded without cv2);
- `countless2d` (numpy and torch) equals JAX's on random label maps."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spinnerf_tpu.data import lama_masks as jm
from spinnerf_tpu.data import shards as jshards
from spinnerf_tpu.train.lama_trainer import make_batch as jmake_batch
from spinnerf_tpu.utils import countless as jcl
from spinnerf_tpu_torch.data import lama_masks as tm
from spinnerf_tpu_torch.data import shards as tshards
from spinnerf_tpu_torch.train.lama_trainer import make_batch as tmake_batch
from spinnerf_tpu_torch.utils import countless as tcl

torch.set_num_threads(1)

KINDS = ["irregular_mask", "squares_mask", "superres_mask", "rectangle_mask",
         "outpainting_mask", "dumb_area_mask"]


@pytest.mark.parametrize("kind", KINDS)
def test_generator_equals_jax_stream(kind):
    for seed in range(12):
        rj, rt = np.random.RandomState(seed), np.random.RandomState(seed)
        for h, w in ((64, 80), (256, 256)):
            a = getattr(jm, kind)(h, w, rj)
            b = getattr(tm, kind)(h, w, rt)
            assert b.dtype == np.float32 and b.shape == (h, w)
            np.testing.assert_array_equal(a, b)
        assert rj.randint(1 << 30) == rt.randint(1 << 30)


def test_irregular_circles_and_mixed_equal_jax():
    for seed in range(20):
        rj, rt = np.random.RandomState(seed), np.random.RandomState(seed)
        np.testing.assert_array_equal(
            jm.irregular_mask(96, 128, rj, draw_method="circle"),
            tm.irregular_mask(96, 128, rt, draw_method="circle"))
    jmix = jm.MixedMaskGenerator(invert_proba=0.3)
    tmix = tm.MixedMaskGenerator(invert_proba=0.3)
    rj, rt = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(30):
        np.testing.assert_array_equal(jmix(64, 64, rj), tmix(64, 64, rt))
    # ramped kwargs and the image-taking segmentation generator
    ramp = (jm.LinearRamp(0.2, 1.0, 0, 10), tm.LinearRamp(0.2, 1.0, 0, 10))
    assert [ramp[0](i) for i in range(-1, 12)] == \
        [ramp[1](i) for i in range(-1, 12)]
    jr = jm.RampedGenerator(jm.irregular_mask, ramp[0],
                            {"max_len": 60, "max_width": 20})
    tr = tm.RampedGenerator(tm.irregular_mask, ramp[1],
                            {"max_len": 60, "max_width": 20})
    img = np.random.RandomState(0).rand(64, 64, 3).astype(np.float32)

    def seg(x):
        return (x[..., 0] * 4).astype(np.int64)
    jmix = jm.MixedMaskGenerator(((jr, 1.0),
                                  (jm.SegmentationMaskGenerator(seg), 1.0)))
    tmix = tm.MixedMaskGenerator(((tr, 1.0),
                                  (tm.SegmentationMaskGenerator(seg), 1.0)))
    rj, rt = np.random.RandomState(5), np.random.RandomState(5)
    for i in range(12):
        np.testing.assert_array_equal(jmix(64, 64, rj, iter_i=i, image=img),
                                      tmix(64, 64, rt, iter_i=i, image=img))


def test_strokes_equal_cv2_pixel_for_pixel():
    """The mask-raster finding: over 300 seeded irregular masks at 256 x 256
    and 300 at 97 x 131 (JAX's, drawn by cv2) no pixel differs."""
    differ = stroke = 0
    for seed in range(300):
        for h, w in ((256, 256), (97, 131)):
            a = jm.irregular_mask(h, w, np.random.RandomState(seed))
            b = tm.irregular_mask(h, w, np.random.RandomState(seed))
            differ += int((a != b).sum())
            stroke += int(a.sum())
    assert stroke > 10 ** 6
    assert differ == 0


def test_thick_lines_and_circles_equal_cv2():
    import cv2
    rng = np.random.RandomState(0)
    for _ in range(400):
        h, w = (int(v) for v in rng.randint(8, 90, 2))
        p0 = (int(rng.randint(w)), int(rng.randint(h)))
        p1 = (int(rng.randint(w)), int(rng.randint(h)))
        t = int(rng.randint(2, 40))
        a = np.zeros((h, w), np.float32)
        cv2.line(a, p0, p1, 1.0, t)
        b = np.zeros((h, w), np.float32)
        tm.thick_line(b, p0, p1, t)
        np.testing.assert_array_equal(a, b, err_msg=str((h, w, p0, p1, t)))
        c = (int(rng.randint(-20, w + 20)), int(rng.randint(-20, h + 20)))
        r = int(rng.randint(0, 30))
        a = np.zeros((h, w), np.float32)
        cv2.circle(a, c, r, 1.0, -1)
        b = np.zeros((h, w), np.float32)
        tm.fill_circle(b, c[0], c[1], r)
        np.testing.assert_array_equal(a, b, err_msg=str((h, w, c, r)))


def test_make_batch_equals_jax():
    rng = np.random.RandomState(0)
    images = [rng.rand(40, 48, 3).astype(np.float32),
              rng.rand(24, 30, 3).astype(np.float32)]   # reflect-padded
    gen_j, gen_t = jm.MixedMaskGenerator(), tm.MixedMaskGenerator()
    rj, rt = np.random.RandomState(1), np.random.RandomState(1)
    for _ in range(3):
        cj, mj = jmake_batch(images, gen_j, rj, crop=32)
        ct, mt = tmake_batch(images, gen_t, rt, crop=32)
        np.testing.assert_array_equal(cj, ct)
        np.testing.assert_array_equal(mj, mt)
        assert ct.shape == (2, 32, 32, 3) and mt.shape == (2, 32, 32, 1)


def test_shards_stream_equals_jax(tmp_path):
    import cv2
    rng = np.random.RandomState(0)
    src = tmp_path / "imgs"
    src.mkdir()
    for i in range(7):
        cv2.imwrite(str(src / f"im_{i}.png"),
                    (rng.rand(16, 20, 3) * 255).astype(np.uint8))
    cv2.imwrite(str(src / "im_0_mask.png"), np.zeros((16, 20), np.uint8))
    out_j = jshards.write_tar_shards(src, tmp_path / "j", shard_size=3)
    out_t = tshards.write_tar_shards(src, tmp_path / "t", shard_size=3)
    assert [p.name for p in out_j] == [p.name for p in out_t]
    for kw in ({}, {"shuffle_buffer": 4}):
        a = list(jshards.iter_shard_images(tmp_path / "j",
                                           rng=np.random.RandomState(2),
                                           **kw))
        b = list(tshards.iter_shard_images(tmp_path / "t",
                                           rng=np.random.RandomState(2),
                                           **kw))
        assert len(a) == len(b) == 7
        for x, y in zip(a, b):
            assert y.dtype == np.float32
            np.testing.assert_array_equal(x, y)
    it = tshards.iter_shard_images(out_t, shuffle_buffer=4, loop=True)
    assert len([next(it) for _ in range(20)]) == 20


@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.int64])
def test_countless_equals_jax(dtype):
    rng = np.random.RandomState(0)
    for h, w in ((16, 20), (15, 9), (1, 7)):
        lo = 0 if dtype == np.uint8 else -3
        img = rng.randint(lo, 5 if dtype != np.uint8 else 256,
                          (h, w)).astype(dtype)
        ref = jcl.countless2d(img)
        got = tcl.countless2d(img)
        assert got.dtype == img.dtype
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(
            tcl.countless2d_torch(torch.from_numpy(img)).numpy(), ref)
        np.testing.assert_array_equal(
            np.asarray(jcl.countless2d_jax(jnp.asarray(img))), ref)
    img = rng.randint(0, 4, (32, 32)).astype(np.int32)
    np.testing.assert_array_equal(tcl.downsample_mask(img, 4),
                                  jcl.downsample_mask(img, 4))
    with pytest.raises(ValueError):
        tcl.downsample_mask(img, 3)
