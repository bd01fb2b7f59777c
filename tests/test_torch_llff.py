"""The port's scene loading without cv2 (`spinnerf_tpu_torch/data/llff.py`,
`eval/render.py::read_png`, `data/synthetic.py::make_scene`,
`data/dispatch.py`) against cv2 and the JAX package: decoded pixels, the
area downsample, the mask dilation and the nearest resize bit-equal to cv2;
loaded scenes equal to JAX `llff.load_scene` (images, masks and depths
exact; poses, bounds and render poses within 1e-6). The Blender and DTU
branches are held in `test_torch_loaders.py`."""
import dataclasses
import shutil
import struct
import types
import zlib

import cv2
import numpy as np
import pytest
import torch

from spinnerf_tpu.data import dispatch as jdispatch
from spinnerf_tpu.data import llff as jllff
from spinnerf_tpu.data import synthetic as jsynthetic
from spinnerf_tpu_torch.data import dispatch as tdispatch
from spinnerf_tpu_torch.data import llff as tllff
from spinnerf_tpu_torch.data import synthetic as tsynthetic
from spinnerf_tpu_torch.eval.render import read_png, write_png

torch.set_num_threads(1)


def _image(shape, dtype, seed):
    """A smooth gradient plus noise, so that cv2's adaptive filter choice
    varies from row to row."""
    rng = np.random.RandomState(seed)
    top = np.iinfo(dtype).max
    yy, xx = np.meshgrid(np.linspace(0, 1, shape[0]),
                         np.linspace(0, 1, shape[1]), indexing="ij")
    base = (0.5 * xx + 0.3 * yy)[..., None] if len(shape) == 3 else \
        0.5 * xx + 0.3 * yy
    noise = rng.rand(*shape) * 0.2
    return np.clip((base + noise) * top, 0, top).astype(dtype)


def _cv2_rgb(img):
    if img.ndim == 3:
        return cv2.cvtColor(img, cv2.COLOR_BGRA2RGBA if img.shape[2] == 4
                            else cv2.COLOR_BGR2RGB)
    return img


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [0, 3, 4])
def test_read_png_matches_cv2(tmp_path, dtype, channels):
    """cv2-written 8/16-bit gray, RGB and RGBA files (adaptive filters)."""
    shape = (37, 53) if channels == 0 else (37, 53, channels)
    img = _image(shape, dtype, channels)
    cv2.imwrite(str(tmp_path / "a.png"), img)
    want = _cv2_rgb(cv2.imread(str(tmp_path / "a.png"), cv2.IMREAD_UNCHANGED))
    got = read_png(tmp_path / "a.png")
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)


def _chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _filter_row(kind, row, prev, bpp):
    """PNG filter `kind` applied to one row of bytes (prev: the row above)."""
    x = row.astype(np.int64)
    up = prev.astype(np.int64)
    left = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
    ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
    if kind == 0:
        pred = 0
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = up
    elif kind == 3:
        pred = (left + up) // 2
    else:
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, ul))
    return ((x - pred) % 256).astype(np.uint8)


def _write_png_raw(path, rows, w, h, depth, color, bpp, *, filters=(0,),
                   plte=None, interlace=0):
    """A PNG whose row r is stored with filter filters[r % len(filters)]."""
    prev = np.zeros_like(rows[0])
    body = b""
    for r, row in enumerate(rows):
        kind = filters[r % len(filters)]
        body += bytes([kind]) + _filter_row(kind, row, prev, bpp).tobytes()
        prev = row
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if plte is not None:
        data += _chunk(b"PLTE", plte)
    data += _chunk(b"IDAT", zlib.compress(body)) + _chunk(b"IEND", b"")
    path.write_bytes(data)


@pytest.mark.parametrize("case", ["rgb8", "rgba16", "gray_alpha8",
                                  "palette8", "palette4", "gray1"])
def test_read_png_all_filters_and_color_types(tmp_path, case):
    """Every row filter (rows cycle through 0-4) for the color types cv2
    does not write: the port's decode equals cv2's."""
    rng = np.random.RandomState(7)
    h, w = 9, 14
    pal = rng.randint(0, 256, (6, 3)).astype(np.uint8)
    kw = {}
    if case == "rgb8":
        rows = rng.randint(0, 256, (h, w * 3)).astype(np.uint8)
        depth, color, bpp = 8, 2, 3
    elif case == "rgba16":
        rows = rng.randint(0, 65536, (h, w * 4)).astype(">u2").view(
            np.uint8).reshape(h, -1)
        depth, color, bpp = 16, 6, 8
    elif case == "gray_alpha8":
        rows = rng.randint(0, 256, (h, w * 2)).astype(np.uint8)
        depth, color, bpp = 8, 4, 2
    elif case == "palette8":
        rows = rng.randint(0, 6, (h, w)).astype(np.uint8)
        depth, color, bpp = 8, 3, 1
        kw["plte"] = pal.tobytes()
    elif case == "palette4":
        idx = rng.randint(0, 6, (h, w)).astype(np.uint8)
        rows = (idx[:, 0::2] << 4) | idx[:, 1::2]
        depth, color, bpp = 4, 3, 1
        kw["plte"] = pal.tobytes()
    else:
        rows = np.packbits(rng.randint(0, 2, (h, 16)).astype(np.uint8),
                           axis=1)
        depth, color, bpp, w = 1, 0, 1, 16
    _write_png_raw(tmp_path / "a.png", rows, w, h, depth, color, bpp,
                   filters=(0, 1, 2, 3, 4), **kw)
    want = _cv2_rgb(cv2.imread(str(tmp_path / "a.png"), cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(read_png(tmp_path / "a.png"), want)


def test_read_png_rejects_interlaced(tmp_path):
    """An interlaced PNG (Adam7) is no longer refused: it decodes to cv2's
    pixels (its seven passes written by hand, filters 0-4 in turn)."""
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (9, 11, 3)).astype(np.uint8)
    passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
              (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
    body = b"".join(bytes([0]) + row.tobytes()
                    for x0, y0, dx, dy in passes
                    for row in img[y0::dy, x0::dx].reshape(
                        img[y0::dy, x0::dx].shape[0], -1)
                    if img[y0::dy, x0::dx].size)
    data = (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", 11, 9, 8, 2, 0, 0, 1)) + _chunk(b"IDAT", zlib.compress(
            body)) + _chunk(b"IEND", b""))
    (tmp_path / "i.png").write_bytes(data)
    want = _cv2_rgb(cv2.imread(str(tmp_path / "i.png"), cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(want, img)
    np.testing.assert_array_equal(read_png(tmp_path / "i.png"), want)


def test_write_png_round_trips_16_bit_and_alpha(tmp_path):
    for shape, dtype in (((5, 7, 2), np.uint8), ((5, 7, 4), np.uint16),
                         ((5, 7), np.uint16)):
        img = _image(shape, dtype, 1)
        write_png(tmp_path / "w.png", img)
        back = cv2.imread(str(tmp_path / "w.png"), cv2.IMREAD_UNCHANGED)
        if len(shape) == 3 and shape[2] == 2:
            np.testing.assert_array_equal(back[..., 0], img[..., 0])
            np.testing.assert_array_equal(back[..., 3], img[..., 1])
        else:
            np.testing.assert_array_equal(_cv2_rgb(back), img)


def test_imread_without_cv2_raises_for_jpeg(tmp_path, monkeypatch):
    """PNG, JPEG, BMP and GIF never go through cv2: without it, a JPEG
    decodes to cv2's pixels (`data/jpeg.py`) in the unchanged, colour and
    gray reads, whatever the suffix's letter case, and so do a BMP and a
    GIF (`data/imageio.py`); the formats left to cv2 (here an AVIF) still
    need it and name the file when it is absent."""
    img = _image((6, 8, 3), np.uint8, 2)
    cv2.imwrite(str(tmp_path / "a.jpg"), img)
    cv2.imwrite(str(tmp_path / "a.png"), img)
    cv2.imwrite(str(tmp_path / "a.bmp"), img)
    cv2.imwrite(str(tmp_path / "a.gif"), img)
    cv2.imwrite(str(tmp_path / "a.avif"), img)
    gif = _cv2_rgb(cv2.imread(str(tmp_path / "a.gif"), cv2.IMREAD_UNCHANGED))
    shutil.copy(tmp_path / "a.jpg", tmp_path / "b.JPEG")
    want = {"unchanged": _cv2_rgb(cv2.imread(str(tmp_path / "a.jpg"),
                                             cv2.IMREAD_UNCHANGED)),
            "color": _cv2_rgb(cv2.imread(str(tmp_path / "a.jpg"))),
            "gray": cv2.imread(str(tmp_path / "a.jpg"), cv2.IMREAD_GRAYSCALE)}
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    np.testing.assert_array_equal(tllff.imread(tmp_path / "a.png"),
                                  _cv2_rgb(img))
    for name in ("a.jpg", "b.JPEG"):
        for read, fn in (("unchanged", tllff.imread),
                         ("color", tllff.imread_rgb8),
                         ("gray", tllff.imread_gray8)):
            np.testing.assert_array_equal(fn(tmp_path / name), want[read])
    np.testing.assert_array_equal(tllff.imread(tmp_path / "a.bmp"),
                                  _cv2_rgb(img))
    np.testing.assert_array_equal(tllff.imread(tmp_path / "a.gif"), gif)
    with pytest.raises(RuntimeError, match="a.avif"):
        tllff.imread(tmp_path / "a.avif")


@pytest.mark.parametrize("factor", [2, 3, 4, 8])
def test_area_downsample_matches_cv2(factor):
    for shape, dtype in (((8 * factor, 11 * factor, 3), np.uint8),
                         ((7 * factor, 5 * factor), np.uint8),
                         ((6 * factor, 9 * factor, 4), np.uint16)):
        img = np.random.RandomState(factor).randint(
            0, np.iinfo(dtype).max + 1, shape).astype(dtype)
        want = cv2.resize(img, (shape[1] // factor, shape[0] // factor),
                          interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(tllff.area_downsample(img, factor),
                                      want)
    # a side that is not a multiple of the factor: cv2's fractional weights
    img = np.random.RandomState(factor).randint(0, 256, (9, 8), np.uint8)
    np.testing.assert_array_equal(
        tllff.area_downsample(img, 2),
        cv2.resize(img, (4, 4), interpolation=cv2.INTER_AREA))


@pytest.mark.parametrize("factor", [2, 3, 4, 8])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_area_downsample_fractional_matches_cv2(factor, dtype):
    """Sides that are not multiples of the factor, bit-equal to cv2's
    INTER_AREA: fractional weights in float32 where a scale is not whole,
    block sums where both are (e.g. 10 / (10 // 4) = 5), and 2 x 2 blocks
    rounded as cv2's vector path rounds them (1, 3 or 4 channels) or
    not (2 channels)."""
    top = np.iinfo(dtype).max
    for i, shape in enumerate((
            (8 * factor + 1, 11 * factor + 3, 3), (7 * factor - 1, 5 * factor),
            (6 * factor + 5, 9 * factor + 1, 4), (5 * factor + 3, 4 * factor,
                                                  2),
            (567 * factor // 2 + 1, 41, 3), (10, 10), (8, 10, 3))):
        rng = np.random.RandomState(100 * factor + i)
        for img in (rng.randint(0, top + 1, shape).astype(dtype),
                    np.full(shape, top // 2 + 1, dtype),
                    (rng.rand(*shape) > 0.5).astype(dtype) * top):
            want = cv2.resize(img, (shape[1] // factor, shape[0] // factor),
                              interpolation=cv2.INTER_AREA)
            np.testing.assert_array_equal(tllff.area_downsample(img, factor),
                                          want, err_msg=str(shape))


def test_minify_at_sides_that_are_not_multiples(tmp_path):
    """`minify` at factor 4 of 1134-row-like sides (1134 / 4 = 283.5):
    the PNGs it writes decode to cv2's INTER_AREA of the originals."""
    rng = np.random.RandomState(7)
    (tmp_path / "images").mkdir()
    imgs = {"a": rng.randint(0, 256, (45, 62, 3), np.uint8),
            "b": rng.randint(0, 256, (45, 62, 4), np.uint8)}
    for name, img in imgs.items():
        write_png(tmp_path / "images" / f"{name}.png", img)
    out = tllff.minify(tmp_path, 4)
    for name, img in imgs.items():
        np.testing.assert_array_equal(
            read_png(out / f"{name}.png"),
            cv2.resize(img, (15, 11), interpolation=cv2.INTER_AREA))


def test_dilate_and_nearest_resize_match_cv2():
    rng = np.random.RandomState(3)
    m = (rng.rand(40, 57) > 0.97).astype(np.float32)
    m[0, 0] = m[-1, 30] = 0.5
    np.testing.assert_array_equal(tllff.dilate_mask(m), jllff.dilate_mask(m))
    np.testing.assert_array_equal(tllff.dilate_mask(m, iterations=2),
                                  jllff.dilate_mask(m, iterations=2))
    f = rng.rand(30, 41).astype(np.float32)
    for w, h in ((20, 15), (82, 60), (13, 7), (100, 77)):
        np.testing.assert_array_equal(
            tllff.resize_nearest(f, h, w),
            cv2.resize(f, (w, h), interpolation=cv2.INTER_NEAREST))


@pytest.fixture(scope="module")
def jax_scene(tmp_path_factory):
    """A JAX-written scene at factor 2, its first view an object-removed
    ground-truth view, masks on views 0, 1, 3 and 5 only, and the full
    masks in label_full."""
    return jsynthetic.make_scene(
        tmp_path_factory.mktemp("jscene"), n_views=7, h=36, w=48, factor=2,
        n_points=300, n_gt=1, mask_views=(1, 3, 5), gt_mask_subdir="label_full")


def _assert_scenes_equal(got, want):
    assert ([f.name for f in dataclasses.fields(tllff.Scene)]
            == [f.name for f in dataclasses.fields(jllff.Scene)])
    for name in ("images", "masks", "inpainted_depths", "masks_gt"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("poses", "bounds", "render_poses"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=0, atol=1e-6, err_msg=name)
    assert got.hwf == want.hwf and got.i_holdout == want.i_holdout
    assert got.mask_indices == want.mask_indices
    assert got.scale == want.scale


@pytest.mark.parametrize("mode", ["prepare", "lpips_mode", "fit"])
def test_load_scene_matches_jax(jax_scene, mode):
    kw = dict(factor=2, masks_gt_subdir="label_full",
              prepare=mode == "prepare", lpips_mode=mode == "lpips_mode",
              lpips_reserve=4)
    got = tllff.load_scene(jax_scene, **kw)
    want = jllff.load_scene(jax_scene, **kw)
    _assert_scenes_equal(got, want)
    assert got.masks is not None and got.inpainted_depths is not None
    if mode == "lpips_mode":
        assert (got.masks < 0).any() and (got.masks[3] >= 0).all()


def test_load_scene_minifies_like_jax(tmp_path):
    """A scene with only full-size images: `images_2` is made by each
    loader (cv2's INTER_AREA in JAX, the port's box mean), with the same
    pixels."""
    src = jsynthetic.make_scene(tmp_path / "src", n_views=4, h=40, w=52,
                                factor=1, n_points=100)
    for d in ("label", "depth", "lama_images"):
        shutil.rmtree(src / "images" / d)
    shutil.copytree(src, tmp_path / "t")
    shutil.copytree(src, tmp_path / "j")
    got = tllff.load_scene(tmp_path / "t", factor=2, spherify=True)
    want = jllff.load_scene(tmp_path / "j", factor=2, spherify=True)
    _assert_scenes_equal(got, want)
    assert got.images.shape == (4, 20, 26, 3)


def test_make_scene_matches_jax(tmp_path):
    kw = dict(n_views=5, h=32, w=40, factor=2, n_points=200, n_gt=1,
              mask_views=(2,), gt_mask_subdir="label_full", seed=3)
    t = tsynthetic.make_scene(tmp_path / "t", **kw)
    j = jsynthetic.make_scene(tmp_path / "j", **kw)
    files = sorted(p.relative_to(j) for p in j.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(t) for p in t.rglob("*")
                           if p.is_file())
    n_png = 0
    for rel in files:
        if rel.suffix == ".png":
            want = cv2.imread(str(j / rel), cv2.IMREAD_UNCHANGED)
            np.testing.assert_array_equal(read_png(t / rel), _cv2_rgb(want),
                                          err_msg=str(rel))
            n_png += 1
        elif rel.suffix == ".npy":
            np.testing.assert_array_equal(np.load(t / rel), np.load(j / rel))
        else:   # the COLMAP model: the same writer format, byte for byte
            assert (t / rel).read_bytes() == (j / rel).read_bytes(), rel
    # images, images_2, lama_images, depth, label_full, and label for the
    # ground-truth view 0 and mask view 2
    assert n_png == 5 * 5 + 2


def _cfg(datadir, **kw):
    base = dict(dataset_type="llff", datadir=str(datadir), factor=2,
                prepare=False, spherify=False, lpips=False, mvseg=False,
                mask_subdir="label", masks_gt_subdir=None,
                mask_dilate_iters=5, N_gt=0, train_gt=False, llffhold=3,
                N_train=None, train_scene=[], test_scene=[])
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.mark.parametrize("kw", [dict(), dict(N_gt=1, prepare=True),
                                dict(dataset_type="nerd", llffhold=0)],
                         ids=["llff", "llff_ngt", "nerd"])
def test_dispatch_matches_jax(jax_scene, tmp_path, kw):
    d = jax_scene
    if kw.get("dataset_type") == "nerd":
        d = tmp_path / "nerd"
        shutil.copytree(jax_scene, d)
        shutil.copytree(d / "images_2" / "label", d / "images_2" / "masks")
    cfg = _cfg(d, **kw)
    got_scene, *got = tdispatch.load_scene_for_config(cfg)
    want_scene, *want = jdispatch.load_scene_for_config(cfg)
    _assert_scenes_equal(got_scene, want_scene)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)
    assert got[2:] == want[2:] == [None, None]
    with pytest.raises(ValueError, match="dataset_type"):
        tdispatch.load_scene_for_config(_cfg(d, dataset_type="x"))
